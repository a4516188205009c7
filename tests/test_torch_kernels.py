"""Port kernels K1 (row sort) and K2 (tournament merge): the plain torch
versions against the reference's Pallas/XLA wrappers and numpy, and the
wrappers' guards.

Everything here runs on the CPU, where a wrapper takes its kernel's plain
version because the tensor lies on the CPU; the CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``.
Every comparison is exact: the networks move integers.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.kernels import ops as ref_ops
from repro_torch.kernels import bitonic, build, ops

I32_MAX = np.iinfo(np.int32).max
I64_MAX = np.iinfo(np.int64).max


def _padded_rows(rng, rows, b, dtype, hi):
    """Random rows whose ragged tails hold the dtype max (the hop's pads)."""
    x = rng.integers(0, hi, size=(rows, b)).astype(dtype)
    cut = rng.integers(0, b + 1, size=(rows, 1))
    return np.where(np.arange(b)[None, :] < cut, x, np.iinfo(dtype).max).astype(dtype)


def _sorted_runs(rng, p, b, dtype, hi):
    """A (p, b) tournament input: sorted runs padded with the dtype max."""
    mat = np.full((p, b), np.iinfo(dtype).max, dtype=dtype)
    for i in range(p):
        ln = int(rng.integers(1, b + 1))
        mat[i, :ln] = np.sort(rng.integers(0, hi, size=ln)).astype(dtype)
    return mat


@pytest.mark.parametrize("rows,b", [(16, 64), (5, 8)])
def test_sort_rows_plain_matches_reference_pallas(rows, b):
    """The reference's hop call (Pallas interpret mode) and the port's plain
    network agree on an int32 block matrix with ragged pads."""
    rng = np.random.default_rng(rows * 100 + b)
    x = _padded_rows(rng, rows, b, np.int32, 1 << 20)
    want = np.asarray(ref_ops.sort_rows_padded(x))
    got = ops.sort_rows_padded(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("b", [1, 2, 4, 64, 256, 4096])
@pytest.mark.parametrize("rows", [0, 1, 3])
def test_sort_rows_plain_matches_numpy(dtype, b, rows):
    rng = np.random.default_rng(b + rows)
    x = _padded_rows(rng, rows, b, dtype, 1 << 40 if dtype == np.int64 else 1 << 30)
    got = bitonic.sort_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sort(x, axis=1))


def test_sort_rows_plain_negative_and_extreme_keys():
    x = np.array(
        [[I64_MAX, -5, 0, np.iinfo(np.int64).min + 1, 7, 7, -5, 3]], dtype=np.int64
    )
    got = bitonic.sort_rows_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sort(x, axis=1))


@pytest.mark.parametrize("p,b", [(2, 2), (8, 32), (4, 128), (64, 4), (2, 512)])
@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_tournament_plain_matches_reference(dtype, p, b):
    """``ops.merge_tournament`` of the reference (XLA off the TPU) against
    the port's plain network.  uint16 keys run as int32 in the port (the
    kernels take int32/int64): the uint16 pad 65535 stays above every key,
    so the merged row is the same numbers."""
    rng = np.random.default_rng(p * 1000 + b)
    hi = 65535 if dtype == np.uint16 else 1 << 30
    mat = _sorted_runs(rng, p, b, dtype, hi)
    if dtype == np.int64:
        with jax.enable_x64(True):
            want = np.asarray(ref_ops.merge_tournament(mat))
    else:
        want = np.asarray(ref_ops.merge_tournament(mat))
    port_in = mat.astype(np.int32) if dtype == np.uint16 else mat
    got = ops.merge_tournament(torch.from_numpy(port_in)).numpy()
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    np.testing.assert_array_equal(got, np.sort(port_in.ravel()))


@pytest.mark.parametrize("p,b", [(1, 8), (2, 1), (16, 1), (1024, 4), (4, 1024)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tournament_plain_matches_numpy(dtype, p, b):
    rng = np.random.default_rng(p + b)
    hi = 1 << 40 if dtype == np.int64 else 1 << 30
    mat = _sorted_runs(rng, p, b, dtype, hi)
    got = bitonic.merge_tournament(torch.from_numpy(mat)).numpy()
    np.testing.assert_array_equal(got, np.sort(mat.ravel()))


def test_tournament_plain_all_duplicates():
    mat = np.full((8, 16), 5, dtype=np.int64)
    mat[:, 10:] = I64_MAX
    got = bitonic.tournament_plain(torch.from_numpy(mat)).numpy()
    np.testing.assert_array_equal(got, np.sort(mat.ravel()))


def _stable_merge_counts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For every d in 0..|a|+|b|: how many of the first d keys of the stable
    merge (a's key first on ties) come from a."""
    order = np.argsort(np.concatenate([a, b]), kind="stable")
    return np.concatenate([[0], np.cumsum(order < a.size)])


def _co_rank_cases():
    rng = np.random.default_rng(11)
    w = 64
    pads = np.full(w, I64_MAX, np.int64)
    ramp = np.sort(rng.integers(0, 1000, w)).astype(np.int64)
    dup_a = np.sort(rng.integers(0, 5, w)).astype(np.int64)
    dup_b = np.sort(rng.integers(0, 5, w)).astype(np.int64)
    return {
        "all_pad_rows": (pads, pads.copy()),
        "all_equal_keys": (np.full(w, 7, np.int64), np.full(w, 7, np.int64)),
        "a_below_b": (ramp, ramp + 2000),
        "a_above_b": (ramp + 2000, ramp),
        "duplicates_and_pads": (np.where(np.arange(w) < 40, dup_a, I64_MAX),
                                np.where(np.arange(w) < 9, dup_b, I64_MAX)),
        "uneven_lengths": (dup_a[:13].copy(), dup_b.copy()),
    }


@pytest.mark.parametrize("case", list(_co_rank_cases()))
def test_co_rank_partition_neither_overlaps_nor_gaps(case):
    """K2's search at every diagonal 0..|a|+|b| of one pair: each split
    takes exactly the keys the stable merge puts first, neighbouring
    diagonals differ by one key (no overlap, no gap), and the tie rule
    (a's key first when a[i] <= b[j]) holds at the cut."""
    a, b = _co_rank_cases()[case]
    na, nb = a.size, b.size
    diag = torch.arange(na + nb + 1)[None]
    i = bitonic.co_rank(torch.from_numpy(a)[None], torch.from_numpy(b)[None], diag)[0].numpy()
    j = np.arange(na + nb + 1) - i
    np.testing.assert_array_equal(i, _stable_merge_counts(a, b))
    assert i[0] == 0 and i[-1] == na  # the diagonals at 0 and at |a| + |b|
    assert set(np.diff(i)) <= {0, 1} and set(np.diff(j)) <= {0, 1}
    for ii, jj in zip(i, j):
        if 0 < ii and jj < nb:
            assert a[ii - 1] <= b[jj]
        if 0 < jj and ii < na:
            assert b[jj - 1] < a[ii]
    if na == nb:  # the merge that reads these cuts
        merged = bitonic.merge_pairs(torch.from_numpy(a)[None], torch.from_numpy(b)[None])[0]
        np.testing.assert_array_equal(merged.numpy(), np.sort(np.concatenate([a, b])))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tournament_plain_one_pair_of_wide_rows(dtype):
    """P = 2: the whole round is one pair (the kernel spreads it over many
    blocks); duplicates across the pair and ragged pads."""
    rng = np.random.default_rng(5)
    mat = _sorted_runs(rng, 2, 1 << 12, dtype, 50)
    got = bitonic.tournament_plain(torch.from_numpy(mat)).numpy()
    np.testing.assert_array_equal(got, np.sort(mat.ravel()))


@pytest.mark.parametrize("p,b,want", [
    (1, 8, 0), (2, 1, 1), (2, 2, 1), (4096, 2, 1), (1024, 16, 1),
    (131_072, 64, 10),  # the sort path's largest bucket: 1 + log2(2^23 / 2^14)
    (1 << 16, 128, 10), (2, 1 << 22, 1), (8, 1 << 15, 3), (2, 1 << 13, 1), (4, 1 << 13, 2),
])
def test_tournament_launch_plan(p, b, want):
    """One tile launch while row pairs fit 16,384 keys, then one per round."""
    assert bitonic.tournament_launches(p, b) == want


def test_compare_exchange_matches_reference_stage():
    """One (k, j) stage of the port's network is the reference's stage."""
    from repro.kernels import bitonic as ref_bitonic

    x = np.random.default_rng(3).integers(0, 100, size=(4, 32)).astype(np.int32)
    for k, j in bitonic._stages(32):
        want = np.asarray(ref_bitonic.compare_exchange(x, k, j))
        got = bitonic.compare_exchange(torch.from_numpy(x), k, j).numpy()
        np.testing.assert_array_equal(got, want)
        x = np.array(want)
    assert list(bitonic._stages(64)) == list(ref_bitonic._stages(64))


# -- guards ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float_keys_rejected_like_reference(dtype):
    x = np.zeros((2, 4), dtype=dtype)
    for ref_fn, port_fn in (
        (ref_ops.sort_rows_padded, ops.sort_rows_padded),
        (ref_ops.merge_tournament, ops.merge_tournament),
    ):
        with pytest.raises(TypeError):
            ref_fn(x)
        with pytest.raises(TypeError):
            port_fn(torch.from_numpy(x))


def test_bool_keys_rejected():
    with pytest.raises(TypeError):
        ops.sort_rows_padded(torch.zeros((2, 4), dtype=torch.bool))


def test_non_pow2_widths_rejected_like_reference():
    x = np.zeros((2, 6), dtype=np.int32)
    with pytest.raises(ValueError):
        ref_ops.sort_rows_padded(x)
    with pytest.raises(ValueError):
        ops.sort_rows_padded(torch.from_numpy(x))
    t = np.zeros((3, 4), dtype=np.int32)
    with pytest.raises(ValueError):
        ref_ops.merge_tournament(t)
    with pytest.raises(ValueError):
        ops.merge_tournament(torch.from_numpy(t))
    with pytest.raises(ValueError):
        ops.merge_tournament(torch.zeros((4, 3), dtype=torch.int32))


def test_kernel_wrappers_check_dtype_shape_contiguity():
    with pytest.raises(TypeError, match="int32 or int64"):
        bitonic.sort_rows(torch.zeros((2, 4), dtype=torch.int16))
    with pytest.raises(ValueError, match="2-D"):
        bitonic.sort_rows(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        bitonic.sort_rows(torch.zeros((4, 8), dtype=torch.int32).t())
    with pytest.raises(ValueError, match="power of two"):
        bitonic.sort_rows(torch.zeros((2, 8192), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32 or int64"):
        bitonic.merge_tournament(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="2-D"):
        bitonic.merge_tournament(torch.zeros((2, 2, 2), dtype=torch.int64))


def test_plain_versions_reject_non_pow2():
    with pytest.raises(ValueError):
        bitonic.sort_rows_plain(torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        bitonic.tournament_plain(torch.zeros((3, 2), dtype=torch.int32))


def test_launch_error_code_raises():
    build.check_launch(0, "row_sort")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        build.check_launch(9, "row_sort")


def test_cpu_calls_never_launch_or_build():
    bitonic.reset_launches()
    x = torch.randint(0, 100, (8, 64), dtype=torch.int32)
    ops.sort_rows_padded(x)
    ops.merge_tournament(torch.sort(x, dim=1).values)
    assert bitonic.LAUNCHES is build.LAUNCHES
    assert set(build.LAUNCHES) == {"row_sort", "tournament", "row_sort_kv", "merge_rows",
                                   "flash_attention", "decode_attention", "flash_attention_bwd",
                                   "wkv", "wkv_bwd"}
    assert not any(build.LAUNCHES.values())
    assert build._LIBS == {}


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_kernel_library_path_is_build_dir_keyed_by_source():
    p = build._lib_path("row_sort")
    assert p.parent == build._repo_root() / "build" / "kernels"
    assert p.name.startswith("librow_sort_") and p.suffix == ".so"
    for name, source in (("row_sort", "row_sort.cu"), ("tournament", "tournament.cu"),
                         ("row_sort_kv", "row_sort_kv.cu"), ("merge_rows", "merge_rows.cu"),
                         ("flash_attention", "flash_attention.cu"),
                         ("decode_attention", "decode_attention.cu"),
                         ("flash_attention_bwd", "flash_attention_bwd.cu")):
        assert build._SOURCES[name] == source and (build._CSRC / source).is_file()
        assert build._lib_path(name).name.startswith(f"lib{name}_")


def test_k3_plan_constants_come_from_the_kernel_source(tmp_path, monkeypatch):
    """K3's chunk and group in Python are the ``constexpr`` values of
    ``row_sort_kv.cu``; a name the source does not set raises."""
    items, threads, group = build.source_constants("row_sort_kv.cu", "ITEMS", "THREADS", "GROUP")
    assert bitonic.ROW_SORT_KV_CHUNK == items * threads == 2048
    assert bitonic.ROW_SORT_KV_GROUP == group == 16
    (tmp_path / "k.cu").write_text("constexpr int A = 12;\nconstexpr int B = 3 * A;\n")
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    assert build.source_constants("k.cu", "A") == [12]
    with pytest.raises(ValueError, match="no constexpr int B"):
        build.source_constants("k.cu", "B")


def test_k1_layout_constants_come_from_the_kernel_source(tmp_path, monkeypatch):
    """K1's widest row, keys per thread and block size in Python are the
    ``constexpr`` values of ``row_sort.cu``; a source that does not set one
    raises."""
    max_row, items, threads = build.source_constants("row_sort.cu", "MAX_ROW", "ITEMS", "THREADS")
    assert (bitonic.MAX_ROW, bitonic.ROW_SORT_ITEMS, bitonic.ROW_SORT_THREADS) == (max_row, items, threads)
    assert (max_row, items, threads) == (4096, 8, 256)
    assert threads <= 32 * items  # every stage with j < THREADS is a shuffle inside a warp
    assert [bitonic.row_sort_items(1 << e) for e in range(1, 13)] == [8] * 11 + [16]
    text = (build._CSRC / "row_sort.cu").read_text()
    (tmp_path / "row_sort.cu").write_text(text.replace("constexpr int ITEMS", "constexpr int KEYS"))
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    assert build.source_constants("row_sort.cu", "THREADS") == [threads]
    with pytest.raises(ValueError, match="no constexpr int ITEMS"):
        build.source_constants("row_sort.cu", "ITEMS")


def _k1_tier_model(x: torch.Tensor) -> torch.Tensor:
    """K1 as the kernel cuts the matrix, in torch: tiles of ``n * T`` keys
    (``T`` threads of ``n = row_sort_items(B)`` keys), each thread's keys in
    layout A (thread t holds tile positions n t .. n t + n - 1) or, for the
    shared tier, layout B (register r of thread t holds r T + t), and each
    stage of ``row_sort_tiers(B)`` in its tier.  Positions past the matrix
    hold the dtype max, as in the kernel's last block.  The asserts pin
    what the kernel relies on: a shuffle partner lies in the warp and holds
    position p ^ j for every register, a shuffle stage's direction is the
    thread's, and a register pair is (p, p + j)."""
    rows, B = x.shape
    n, T = bitonic.row_sort_items(B), bitonic.ROW_SORT_THREADS
    tile = n * T
    assert tile % B == 0
    blocks = -(-rows * B // tile)
    flat = torch.full((blocks * tile,), torch.iinfo(x.dtype).max, dtype=x.dtype)
    flat[: rows * B] = x.reshape(-1)
    t = torch.arange(T)[:, None]
    r = torch.arange(n)[None, :]
    layouts = {False: n * t + r, True: r * T + t}  # (T, n) tile positions
    regs = flat.reshape(blocks, T, n)
    wide = False
    tiers = bitonic.row_sort_tiers(B)
    assert [(k, j) for _, k, j in tiers] == list(bitonic._stages(B))
    for tier, k, j in tiers:
        assert tier == ("register" if j < n else "shuffle" if j < T else "shared")
        if (tier == "shared") != wide:  # a transpose through shared memory
            keys = torch.empty(blocks, tile, dtype=x.dtype)
            keys[:, layouts[wide].reshape(-1)] = regs.reshape(blocks, -1)
            wide = not wide
            regs = keys[:, layouts[wide]]
        pos = layouts[wide]
        asc = (pos & (B - 1) & k) == 0
        if tier == "shuffle":
            assert j // n < 32
            partner = torch.arange(T) ^ (j // n)
            assert torch.equal(pos[partner], pos ^ j)
            keep_min = asc == ((pos & j) == 0)
            assert torch.equal(keep_min, keep_min[:, :1].expand(T, n))
            other = regs[:, partner]
            regs = torch.where(keep_min, torch.minimum(regs, other), torch.maximum(regs, other))
        else:
            m = j if tier == "register" else j // T
            lo = [q for q in range(n) if not q & m]
            hi = [q | m for q in lo]
            assert torch.equal(pos[:, hi], pos[:, lo] + j)
            a, b = regs[..., lo], regs[..., hi]
            mn, mx, up = torch.minimum(a, b), torch.maximum(a, b), asc[:, lo]
            regs = regs.clone()
            regs[..., lo] = torch.where(up, mn, mx)
            regs[..., hi] = torch.where(up, mx, mn)
    assert not wide
    return regs.reshape(-1)[: rows * B].reshape(rows, B)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("b", [1 << e for e in range(1, 13)])
def test_k1_tier_model_equals_plain(dtype, b):
    """The kernel's partition -- ``ITEMS``-key lanes, register, shuffle and
    shared-memory tiers, a part-filled last block -- sorts every row as the
    plain network and ``torch.sort`` do: keys with many ties, and the
    dtype's extremes."""
    rng = np.random.default_rng(b)
    tile = bitonic.row_sort_items(b) * bitonic.ROW_SORT_THREADS
    rows = (tile + tile // 2) // b + 1
    info = np.iinfo(dtype)
    x = rng.integers(-3, 4, size=(rows, b)).astype(dtype)
    pick = rng.integers(0, 8, size=(rows, b))
    x = np.where(pick == 0, info.min, np.where(pick == 1, info.max, x)).astype(dtype)
    xt = torch.from_numpy(x)
    got = _k1_tier_model(xt)
    assert torch.equal(got, bitonic.sort_rows_plain(xt))
    assert torch.equal(got, torch.sort(xt, dim=1).values)


def test_kernel_modules_import_without_nvcc_or_card(tmp_path):
    """Importing the kernel modules builds nothing and needs no toolchain."""
    code = (
        "import sys; from repro_torch.kernels import bitonic, build, ops; "
        "from repro_torch.kernels import decode_attention, flash_attention; "
        "assert build._LIBS == {}; assert 'triton' not in sys.modules"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME=str(tmp_path))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
