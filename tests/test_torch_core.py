"""Port ``repro_torch.core`` against the reference ``repro.core``: range
partitioning, runs and the run arena, MergeMarathon's fused emission, and
the server merges (the ladder and the arena tournament).

Inputs come from numpy seeds and go through both packages on the CPU; every
comparison is exact.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core import marathon as ref_marathon
from repro.core import mergesort as ref_ms
from repro.core import partition as ref_part
from repro.core import runs as ref_runs
from repro_torch.core import marathon, mergesort, partition, runs
from repro_torch.net.engine import row_sort_device


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


@pytest.fixture
def x64_shim(monkeypatch):
    """The reference imports ``jax.experimental.enable_x64``, which jax 0.9
    dropped; point it at ``jax.enable_x64(True)`` for this test only."""
    monkeypatch.setattr(
        jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
    )
    yield
    assert not jax.config.jax_enable_x64


# -- partition -----------------------------------------------------------------


@pytest.mark.parametrize("max_value,S", [(100, 7), (32767, 16), (15, 16), (10**12, 5)])
def test_set_ranges_matches_reference(max_value, S):
    np.testing.assert_array_equal(
        N(partition.set_ranges(max_value, S, device="cpu")),
        ref_part.set_ranges(max_value, S),
    )


def test_set_ranges_guards():
    with pytest.raises(ValueError):
        partition.set_ranges(10, 0, device="cpu")
    with pytest.raises(ValueError):
        partition.set_ranges(3, 5, device="cpu")


def test_segment_of_at_range_bounds():
    ranges = ref_part.set_ranges(1000, 7)
    edges = np.unique(np.concatenate([ranges[:, 0], ranges[:, 1] - 1, ranges[:, 0] + 1]))
    edges = edges[(edges >= 0) & (edges <= 1000)]
    got = N(partition.segment_of(T(edges), T(ranges)))
    np.testing.assert_array_equal(got, ref_part.segment_of(edges, ranges))
    # every lo maps to its own row, every hi - 1 too
    np.testing.assert_array_equal(N(partition.segment_of(T(ranges[:, 0]), T(ranges))), np.arange(7))
    np.testing.assert_array_equal(N(partition.segment_of(T(ranges[:, 1] - 1), T(ranges))), np.arange(7))


@pytest.mark.parametrize("bad", [-1, 1001])
def test_segment_of_outside_domain_raises(bad):
    ranges = ref_part.set_ranges(1000, 4)
    with pytest.raises(ValueError, match="outside the switch domain"):
        ref_part.segment_of(np.array([5, bad]), ranges)
    with pytest.raises(ValueError, match="outside the switch domain"):
        partition.segment_of(T(np.array([5, bad])), T(ranges))


def test_segment_of_empty():
    ranges = T(ref_part.set_ranges(100, 4))
    assert partition.segment_of(torch.zeros(0, dtype=torch.int64), ranges).numel() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_imbalance_matches_reference(seed):
    rng = np.random.default_rng(seed)
    v = rng.zipf(1.5, size=3000) % 5000
    r = ref_part.set_ranges(4999, 9)
    assert partition.load_imbalance(T(v), T(r)) == ref_part.load_imbalance(v, r)
    assert partition.load_imbalance(torch.zeros(0, dtype=torch.int64), T(r)) == 1.0


@pytest.mark.parametrize(
    "kind,n,S,max_value",
    [
        ("uniform", 5000, 16, 32767),
        ("uniform", 7, 4, 100),
        ("skew", 4000, 16, 10_000),
        ("dups", 1000, 8, 50),
        ("single", 1, 4, 1000),
        ("constant", 500, 16, 100),
        ("wide", 999, 5, 10**15),
    ],
)
def test_quantile_ranges_matches_reference(kind, n, S, max_value):
    rng = np.random.default_rng(n + S)
    if kind == "uniform":
        v = rng.integers(0, max_value + 1, size=n)
    elif kind == "skew":
        v = np.minimum(rng.zipf(1.3, size=n), max_value)
    elif kind == "dups":
        v = rng.integers(0, 4, size=n) * 10
    elif kind == "constant":
        v = np.full(n, 37)
    elif kind == "wide":
        v = rng.integers(0, max_value, size=n)
    else:
        v = np.array([500])
    v = v.astype(np.int64)
    np.testing.assert_array_equal(
        N(partition.quantile_ranges(T(v), S, max_value)),
        ref_part.quantile_ranges(v, S, max_value),
    )


@pytest.mark.parametrize("n", [1, 2, 5, 1000, 4097])
def test_sorted_quantiles_is_numpy_linear(n):
    rng = np.random.default_rng(n)
    v = rng.integers(-(10**9), 10**9, size=n)
    qs = np.linspace(0, 1, 33)
    got = partition.sorted_quantiles(torch.sort(T(v)).values, qs)
    np.testing.assert_array_equal(got, np.quantile(v, qs))


def test_sorted_quantiles_above_torch_quantile_limit():
    """``torch.quantile`` refuses more than 2^24 elements; the port does not."""
    n = (1 << 24) + 3
    v = np.random.default_rng(5).integers(0, 32768, size=n)
    qs = np.linspace(0, 1, 17)[1:-1]
    got = partition.sorted_quantiles(torch.sort(T(v)).values, qs)
    np.testing.assert_array_equal(got, np.quantile(v, qs))


# -- runs and the arena --------------------------------------------------------


@pytest.mark.parametrize("v", [[], [3], [1, 1, 1], [3, 2, 1], [1, 2, 0, 5, 5, 4, 9]])
def test_run_starts_and_lengths(v):
    a = np.asarray(v, dtype=np.int64)
    np.testing.assert_array_equal(N(runs.run_starts(T(a))), ref_runs.run_starts(a))
    np.testing.assert_array_equal(N(runs.run_lengths(T(a))), ref_runs.run_lengths(a))


@pytest.mark.parametrize("num_runs,k", [(0, 10), (1, 10), (2, 2), (11, 10), (101, 10), (1000, 3)])
def test_merge_passes(num_runs, k):
    assert runs.merge_passes(num_runs, k) == ref_runs.merge_passes(num_runs, k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_run_arena_feed_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref = ref_runs.RunArena(capacity=4)
    port = runs.RunArena(capacity=4, device="cpu")
    assert port.tail is None and ref.tail is None
    for _ in range(30):
        m = int(rng.integers(0, 40))
        arr = np.sort(rng.integers(0, 50, size=m)) if rng.random() < 0.5 else rng.integers(0, 50, size=m)
        arr = arr.astype(np.int64)
        ref.feed(arr)
        port.feed(T(arr))
        assert len(port) == len(ref)
        assert port.num_runs == ref.num_runs
        assert port.tail == ref.tail
    np.testing.assert_array_equal(N(port.keys), ref.keys)
    rs, rl = ref.run_offsets()
    ps, pl = port.run_offsets()
    np.testing.assert_array_equal(N(ps), rs)
    np.testing.assert_array_equal(N(pl), rl)


def test_run_arena_feed_runs_equals_feed():
    rng = np.random.default_rng(7)
    a = runs.RunArena(device="cpu")
    b = runs.RunArena(device="cpu")
    ref = ref_runs.RunArena()
    for _ in range(20):
        arr = rng.integers(0, 20, size=int(rng.integers(1, 30))).astype(np.int64)
        a.feed(T(arr))
        b.feed_runs(T(arr), T(ref_runs.run_starts(arr)))
        ref.feed_runs(arr, ref_runs.run_starts(arr))
    np.testing.assert_array_equal(N(a.keys), N(b.keys))
    np.testing.assert_array_equal(N(b.keys), ref.keys)
    for x, y in zip(a.run_offsets(), b.run_offsets()):
        np.testing.assert_array_equal(N(x), N(y))
    np.testing.assert_array_equal(N(b.run_offsets()[0]), ref.run_offsets()[0])
    with pytest.raises(ValueError):
        b.feed_runs(T(np.array([1, 2])), T(np.array([1])))


# -- MergeMarathon -------------------------------------------------------------


@pytest.mark.parametrize("block", [1, 4, 5, 64])
def test_blockwise_sort(block):
    v = np.random.default_rng(block).integers(0, 100, size=203).astype(np.int64)
    np.testing.assert_array_equal(
        N(marathon.blockwise_sort(T(v), block)), ref_marathon.blockwise_sort(v, block)
    )


@pytest.mark.parametrize("S", [1, 5, 16])
def test_rank_within_segment(S):
    seg = np.random.default_rng(S).integers(0, S, size=500).astype(np.int64)
    for got, want in zip(marathon.rank_within_segment(T(seg), S), ref_marathon.rank_within_segment(seg, S)):
        np.testing.assert_array_equal(N(got), want)


@pytest.mark.parametrize("block", [3, 8])
def test_block_matrix(block):
    rng = np.random.default_rng(block)
    counts = np.array([0, 5, 8, 1, 0, 17], dtype=np.int64)
    grouped = rng.integers(0, 100, size=int(counts.sum())).astype(np.int64)
    mat, row_len = marathon.block_matrix(T(grouped), T(counts), block)
    rmat, rrow = ref_marathon.block_matrix(grouped, counts, block)
    np.testing.assert_array_equal(N(mat), rmat)
    np.testing.assert_array_equal(N(row_len), rrow)


@pytest.mark.parametrize("row_sort", ["default", "device"])
@pytest.mark.parametrize(
    "n,S,L,maxv",
    [(0, 4, 8, 100), (1, 4, 8, 100), (37, 3, 64, 50), (2000, 16, 64, 32767),
     (2000, 7, 5, 999), (1500, 4, 48, 10), (600, 8, 16, 2**40)],
)
def test_marathon_emission_matches_reference(n, S, L, maxv, row_sort):
    """Streams, slots, counts, starts and ranks of the fused pass, with the
    plain torch row sort and with the hop's K1 row sorter (its plain version
    here), including a non-pow2 L and keys beyond int32."""
    v = np.random.default_rng(n + L).integers(0, maxv + 1, size=n).astype(np.int64)
    ranges = ref_part.set_ranges(maxv, S)
    ref = ref_marathon.marathon_emission(v, S, L, maxv, ranges=ranges)
    sorter = row_sort_device if row_sort == "device" else None
    em = marathon.marathon_emission(T(v), S, L, maxv, ranges=T(ranges), row_sort=sorter)
    for f in ("streams", "slots", "order", "counts", "starts", "ranks",
              "values", "segment_ids", "positions"):
        np.testing.assert_array_equal(N(getattr(em, f)), getattr(ref, f), err_msg=f)


def test_marathon_flat_and_default_ranges():
    v = np.random.default_rng(9).integers(0, 1000, size=700).astype(np.int64)
    got = marathon.marathon_flat(T(v), 8, 16, 999)
    want = ref_marathon.marathon_flat(v, 8, 16, 999)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), w)
    # the per-segment block_sort= path, once refused, is the reference's
    got = marathon.marathon_flat(T(v), 8, 16, 999, block_sort=marathon.blockwise_sort)
    want = ref_marathon.marathon_flat(v, 8, 16, 999, block_sort=ref_marathon.blockwise_sort)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), w)


def test_all_duplicate_keys_through_marathon():
    v = np.full(300, 42, dtype=np.int64)
    ref = ref_marathon.marathon_emission(v, 4, 16, 100)
    em = marathon.marathon_emission(T(v), 4, 16, 100, row_sort=row_sort_device)
    np.testing.assert_array_equal(N(em.values), ref.values)
    np.testing.assert_array_equal(N(em.segment_ids), ref.segment_ids)


# -- merges --------------------------------------------------------------------


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 5), (5, 0), (1, 1), (10, 37)])
def test_merge_two(na, nb):
    rng = np.random.default_rng(na * 100 + nb)
    a = np.sort(rng.integers(0, 20, size=na)).astype(np.int64)
    b = np.sort(rng.integers(0, 20, size=nb)).astype(np.int64)
    np.testing.assert_array_equal(N(mergesort.merge_two(T(a), T(b))), ref_ms.merge_two(a, b))


@pytest.mark.parametrize("r", [1, 2, 3, 10, 33])
def test_merge_runs(r):
    rng = np.random.default_rng(r)
    rs = [np.sort(rng.integers(0, 50, size=int(rng.integers(0, 20)))).astype(np.int64) for _ in range(r)]
    np.testing.assert_array_equal(N(mergesort.merge_runs([T(x) for x in rs])), ref_ms.merge_runs(rs))


def _arena_case(kind, rng):
    if kind == "empty":
        return np.zeros(0, dtype=np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    if kind == "single":
        buf = np.array([5], dtype=np.int64)
        return buf, np.array([0]), np.array([1])
    lens = rng.integers(0, 90, size=60)
    lens[3] = 0  # an empty run in the table
    lo, hi = {
        "u16": (0, 60000),
        "i32": (-(10**6), 10**9),
        "i64": (0, 1 << 50),
        "dups": (7, 8),
        "sentinel": (0, 10),
    }[kind]
    parts = [np.sort(rng.integers(lo, hi, size=int(m))).astype(np.int64) for m in lens]
    if kind == "sentinel":
        parts[5] = np.concatenate([parts[5], [np.iinfo(np.int64).max]])
        lens[5] += 1
    buf = np.concatenate(parts)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return buf, starts, lens.astype(np.int64)


@pytest.mark.parametrize("min_keys", [16, 4096])
@pytest.mark.parametrize("kind", ["empty", "single", "u16", "i32", "i64", "dups", "sentinel"])
def test_merge_runs_flat_matches_reference(kind, min_keys, x64_shim):
    """The arena merge with ``min_device_keys`` lowered so that the
    tournament branch (K2's plain version) runs; the same branch as the
    reference on the same input, and the same bytes."""
    rng = np.random.default_rng(len(kind) + min_keys)
    buf, starts, lens = _arena_case(kind, rng)
    want = ref_ms.merge_runs_flat(buf, starts, lens, min_device_keys=min_keys)
    mergesort.reset_branches()
    got = mergesort.merge_runs_flat(T(buf), T(starts), T(lens), min_device_keys=min_keys)
    np.testing.assert_array_equal(N(got), want)
    assert got.dtype == torch.int64
    br = mergesort.MERGE_BRANCHES
    assert sum(br.values()) == 1
    total = int(lens.sum())
    if kind == "empty":
        assert br["empty"] == 1
    elif kind == "single":
        assert br["single"] == 1
    elif kind == "sentinel" or total < min_keys:
        assert br["ladder"] == 1
    else:
        assert br["tournament"] == 1


@pytest.mark.parametrize("lo,hi,want", [
    (0, 65534, torch.int32), (0, 65535, torch.int32), (-5, 10, torch.int32),
    (0, 2**31 - 2, torch.int32), (0, 2**31 - 1, torch.int64),
    (-(2**63) + 1, 2**63 - 2, torch.int64), (0, 2**63 - 1, None),
])
def test_device_dtype_branch_rule(lo, hi, want):
    """The reference's rule decides the branch (device or ladder); uint16
    ranges run as int32 in the port."""
    ref = ref_ms._device_dtype(lo, hi)
    assert (ref is None) == (want is None)
    assert mergesort._device_dtype(lo, hi) == want


def test_merge_runs_batched_and_sort(x64_shim):
    rng = np.random.default_rng(11)
    rs = [np.sort(rng.integers(0, 1 << 40, size=int(m))).astype(np.int64) for m in (0, 300, 1, 77, 4000)]
    np.testing.assert_array_equal(
        N(mergesort.merge_runs_batched([T(x) for x in rs], min_device_keys=64)),
        ref_ms.merge_runs_batched(rs, min_device_keys=64),
    )
    assert mergesort.merge_runs_batched([torch.zeros(0, dtype=torch.int64)]).numel() == 0
    v = rng.integers(0, 1000, size=3000).astype(np.int64)
    got, passes = mergesort.merge_sort(T(v), k=4)
    want, wpasses = ref_ms.merge_sort(v, k=4)
    np.testing.assert_array_equal(N(got), want)
    assert passes == wpasses
    streams = [rng.integers(0, 100, size=int(m)).astype(np.int64) for m in (0, 10, 500)]
    got, passes = mergesort.server_sort([T(s) for s in streams], k=3)
    want, wpasses = ref_ms.server_sort(streams, k=3)
    np.testing.assert_array_equal(N(got), want)
    assert passes == wpasses
