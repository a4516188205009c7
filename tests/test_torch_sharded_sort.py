"""The sharded fabric's sort side (M19), held against the JAX package: the
all_to_all range sort with the K1 presort, the pool's collective concat and
``run_pipeline(pool_backend="shard_map")``.

The reference runs on 8 fake CPU devices in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``); the port runs as
8 gloo ranks, one process each (``torch.multiprocessing.spawn``), both once
for the whole file (``tests/_torch_dist_workers.py``).  Every rank's
``sort_sharded`` result -- padded chunk, valid count, overflow -- is
byte-identical to the reference's row for that device, R6 included (a real
key equal to the dtype's max is counted as padding, as the reference counts
it).  The pool's gather runs at 4 ranks: each 4-rank half of the world is
one pool.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)
import _torch_dist_workers as workers
from repro.core import distributed as ref_dist
from repro_torch.core import distributed as dist_mod
from repro_torch.net import egress
from repro_torch.net.pipeline import run_pipeline

CASES = list(workers.sort_cases())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, every port rank's npz): the JAX subprocess and
    the gloo ranks run side by side."""
    return workers.run_both("ref_sort", workers.sort_rank, tmp_path_factory.mktemp("sharded_sort"))


@pytest.mark.parametrize("case", CASES)
def test_sort_sharded_matches_reference(runs, case):
    ref, ranks = runs
    np.testing.assert_array_equal(ranks[0][f"{case}/splitters"], ref[f"{case}/splitters"])
    padded = np.stack([r[f"{case}/padded"] for r in ranks])
    valid = np.concatenate([r[f"{case}/valid"] for r in ranks])
    overflow = np.concatenate([r[f"{case}/overflow"] for r in ranks])
    assert padded.dtype == ref[f"{case}/padded"].dtype
    np.testing.assert_array_equal(padded, ref[f"{case}/padded"])
    np.testing.assert_array_equal(valid, ref[f"{case}/valid"])
    np.testing.assert_array_equal(overflow, ref[f"{case}/overflow"])
    x = workers.sort_cases()[case][0]
    out = dist_mod.gather_sorted(padded, valid)
    if case == "overflow":  # the tight capacity drops keys and says so
        assert overflow.sum() > 0 and out.size == x.size - overflow.sum()
    elif case == "dtype_max":  # R6: keys equal to the sentinel are counted as padding
        keep = x != np.iinfo(x.dtype).max
        assert overflow.sum() == 0
        np.testing.assert_array_equal(out, np.sort(x[keep]))
    else:
        assert overflow.sum() == 0
        np.testing.assert_array_equal(out, np.sort(x))


def test_presort_keeps_the_received_stream_in_runs(runs):
    """With the presort, each receiver's stream (before its local sort) is a
    concatenation of sorted blocks: after the sort the valid prefix is one
    run, as ``dist_sort_driver.py`` checks."""
    _, ranks = runs
    for case in ("presort256", "presort96"):
        padded = np.stack([r[f"{case}/padded"] for r in ranks])
        valid = np.concatenate([r[f"{case}/valid"] for r in ranks])
        out = dist_mod.gather_sorted(padded, valid)
        assert np.all(np.diff(out) >= 0)


def test_pool_concat_sharded_matches_reference(runs):
    ref, ranks = runs
    want = np.concatenate(workers.POOL_SHARDS)
    np.testing.assert_array_equal(ref["pool_concat_sharded"], want)
    for r in ranks:
        assert int(r["pool_mesh_size"]) == 4
        np.testing.assert_array_equal(r["pool_concat_sharded"], want)
        # three shards for a four-rank axis, a mesh that is not the world
        shards, mesh = r["errors"]
        assert "3 shards for a 4-device 'server' axis" in shards
        assert "needs 3 ranks" in mesh


def test_pipeline_shard_map_backend_matches_numpy_and_reference(runs):
    ref, ranks = runs
    for r in ranks:
        assert int(r["pipe/sharded_calls"]) == 1  # the gather ran, not the concatenation
        for backend in ("numpy", "shard_map"):
            np.testing.assert_array_equal(r[f"pipe/{backend}/output"], ref["pipe/output"])
            np.testing.assert_array_equal(r[f"pipe/{backend}/passes"], ref["pipe/passes"])
    np.testing.assert_array_equal(ref["pipe/output"], np.sort(workers.pipe_values()))


# -- in this process: no process group ------------------------------------------------


@pytest.mark.parametrize("num_devices", [1, 2, 8, 5])
def test_make_splitters_matches_reference(num_devices):
    rng = np.random.default_rng(num_devices)
    for sample in (rng.integers(0, 1 << 20, 1000).astype(np.int32), rng.normal(size=777),
                   np.repeat(np.arange(3), 50)):
        np.testing.assert_array_equal(dist_mod.make_splitters(sample, num_devices),
                                      ref_dist.make_splitters(sample, num_devices))


def test_gather_sorted_matches_reference():
    padded = np.arange(24, dtype=np.int64).reshape(4, 6)
    valid = np.array([6, 0, 2, 5])
    want = ref_dist.gather_sorted(padded, valid)
    np.testing.assert_array_equal(dist_mod.gather_sorted(padded, valid), want)
    got = dist_mod.gather_sorted(torch.from_numpy(padded), torch.from_numpy(valid))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


POOL_INPUTS = {
    "disjoint": ([[1, 3, 5], [7, 8], [], [20]], True),
    "overlapping": ([[1, 3, 5], [2, 4], [], [0, 9]], False),
    "single": ([[4, 5, 6]], True),
    "all_empty": ([[], []], False),
    "none": ([], True),
}


@pytest.mark.parametrize("backend", ["numpy", "shard_map"])
@pytest.mark.parametrize("name", list(POOL_INPUTS))
def test_pool_concat_matches_reference(name, backend):
    """On the host, and with ``backend="shard_map"`` and no process group
    (``pool_mesh`` is None: the reference's fallback), the reference's
    ``pool_concat``; no outputs give an empty int64 tensor."""
    outs, disjoint = POOL_INPUTS[name]
    want = ref_dist.pool_concat([np.asarray(o, dtype=np.int64) for o in outs], disjoint=disjoint)
    got = dist_mod.pool_concat([torch.tensor(o, dtype=torch.int64) for o in outs],
                               disjoint=disjoint, backend=backend)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert egress.pool_concat is dist_mod.pool_concat


@pytest.mark.parametrize("block", [1, 8, 96, 256, 4096, 8192])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
def test_blockwise_sort_on_k1(monkeypatch, block, dtype):
    """Integer blocks up to ``MAX_ROW`` go through K1's wrapper (padded to a
    power of two), wider ones and float keys to ``torch.sort``; every result
    equals the reference's ``blockwise_sort_jax``."""
    calls = []
    inner = dist_mod.ops.sort_rows_padded
    monkeypatch.setattr(dist_mod.ops, "sort_rows_padded", lambda m: calls.append(m.shape) or inner(m))
    rng = np.random.default_rng(block)
    x = (rng.integers(-1000, 1000, size=(3, 2 * block)) if dtype != torch.float32
         else rng.normal(size=(3, 2 * block)))
    x = torch.from_numpy(x).to(dtype)
    got = dist_mod.blockwise_sort(x, block)
    want = np.asarray(ref_dist.blockwise_sort_jax(jnp.asarray(x.numpy()), block))
    np.testing.assert_array_equal(got.numpy(), want)
    on_k1 = dtype != torch.float32 and block <= dist_mod.MAX_ROW
    assert calls == ([(6, 1 << (block - 1).bit_length())] if on_k1 else [])
    with pytest.raises(ValueError, match="not divisible"):
        dist_mod.blockwise_sort(x[:, 1:], block + 1 if block == 1 else block)


def test_shard_map_pool_without_a_process_group_concatenates():
    """``ServerPool(pool_backend="shard_map")`` no longer raises: with no
    process group (one process) ``pool_mesh`` is None and the pool
    concatenates, byte-identical to the numpy backend."""
    vals = torch.from_numpy(workers.pipe_values())
    a = run_pipeline(vals, pool_backend="shard_map", device="cpu", **workers.PIPE)
    b = run_pipeline(vals, pool_backend="numpy", device="cpu", **workers.PIPE)
    assert torch.equal(a.output, b.output) and a.passes == b.passes
    egress.ServerPool(8, 4, pool_backend="shard_map", device="cpu")
    with pytest.raises(ValueError, match="unknown pool_backend"):
        egress.ServerPool(8, 4, pool_backend="mpi", device="cpu")
