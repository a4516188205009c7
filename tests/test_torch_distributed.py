"""The sharded fabric's training side (M19), held against the JAX package:
``fsdp_gather``, ``gpipe`` and the all_to_all MoE layer, forward and
backward, and the compressor's sharding context.

The reference runs on 8 fake CPU devices in one subprocess, the port as 8
gloo ranks (``tests/_torch_dist_workers.py``), once for the file; every
mesh is (2, 4).  Every rank calls ``backward`` on its own loss; a gradient
of a parameter replicated over ranks is the sum of the ranks' (what a
data-parallel all-reduce gives), a sharded one is compared shard by shard.
Tolerances are those of ``tests/drivers``: ``gpipe`` forward 1e-5 and gradients
1e-4 (``pp_driver.py``), the MoE output atol 2e-4 / rtol 2e-3 and every
gradient leaf atol 5e-4 / rtol 5e-3 (``moe_a2a_driver.py``), aux within
1e-5 relative (the same estimator here).
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)
import _torch_dist_workers as workers
from repro.distributed import collectives as ref_coll
from repro.distributed.sharding import local_ctx as ref_local_ctx
from repro_torch import configs
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.compat import make_mesh
from repro_torch.models import moe
from repro_torch.models.convert import params_from_reference

MESH = (2, 4)  # rank = 4 * row + column, row-major


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, every port rank's npz), both bounded in time."""
    return workers.run_both("ref_dist", workers.dist_rank, tmp_path_factory.mktemp("distributed"))


def _rank(row: int, col: int) -> int:
    return row * MESH[1] + col


# -- fsdp_gather --------------------------------------------------------------------


def test_fsdp_gather_forward(runs):
    """Every rank gathers the whole ``w``; the losses of a replica's four
    ranks (each its quarter of the batch) sum to the reference's loss."""
    ref, ranks = runs
    f = workers.fsdp_inputs()
    for r in ranks:
        np.testing.assert_array_equal(r["fsdp/gathered_w"], f["w"])
    for row in range(MESH[0]):
        total = sum(float(ranks[_rank(row, c)]["fsdp/loss"]) for c in range(MESH[1]))
        np.testing.assert_allclose(total, float(ref["fsdp/loss"]), rtol=1e-5)


@pytest.mark.parametrize("leaf,dim", [("w", 0), ("v", 1), ("b", None)])
def test_fsdp_gather_gradient(runs, leaf, dim):
    """The backward is the reduce-scatter: each rank's gradient of its shard
    is the reference's gradient of the whole leaf cut to that shard; the
    replicated ``b`` sums over the axis."""
    ref, ranks = runs
    want = ref[f"fsdp/grad/{leaf}"]
    for row in range(MESH[0]):
        grads = [ranks[_rank(row, c)][f"fsdp/grad/{leaf}"] for c in range(MESH[1])]
        got = sum(grads) if dim is None else np.concatenate(grads, axis=dim)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- gpipe --------------------------------------------------------------------------


def test_gpipe_forward(runs):
    """Every rank of every replica ends up with the last stage's outputs,
    equal to the reference's and to ``sequential_reference``."""
    ref, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["pp/out"], ref["pp/out"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["pp/out"], r["pp/sequential"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("leaf", ["w", "b"])
def test_gpipe_gradients(runs, leaf):
    """Each rank's backward gives its own stage's gradient: the stage shards
    stacked in pipe order are the reference's gradient of the stack."""
    ref, ranks = runs
    for row in range(MESH[0]):
        got = np.concatenate([ranks[_rank(row, c)][f"pp/grad/{leaf}"] for c in range(MESH[1])])
        np.testing.assert_allclose(got, ref[f"pp/grad/{leaf}"], atol=1e-4, rtol=1e-4)


# -- moe_layer_a2a ------------------------------------------------------------------


def _moe_slice(a, row, col):
    t = workers.MOE_T // MESH[1]
    return a[row : row + 1, col * t : (col + 1) * t]


def test_moe_a2a_forward(runs):
    """Each rank's tokens (its dp row of the batch, its tp chunk of T) come
    out as the reference's; aux and dropped are replicated."""
    ref, ranks = runs
    for row in range(MESH[0]):
        for col in range(MESH[1]):
            r = ranks[_rank(row, col)]
            np.testing.assert_allclose(r["moe/y"], _moe_slice(ref["moe/y"], row, col), atol=2e-4, rtol=2e-3)
            np.testing.assert_allclose(float(r["moe/aux"]), float(ref["moe/aux"]), rtol=1e-5)
            assert int(r["moe/dropped"]) == int(ref["moe/dropped"])


MOE_LEAVES = ["x", "router", "w_in", "w_gate", "w_out", "shared.w_in", "shared.w_gate", "shared.w_out"]


@pytest.mark.parametrize("loss", ["y", "aux"])
@pytest.mark.parametrize("leaf", MOE_LEAVES)
def test_moe_a2a_gradients(runs, leaf, loss):
    """The gradient of sum(y^2) (the loss of ``moe_a2a_driver.py``) and of aux:
    ``x`` per rank, the expert slabs and the tp-parallel shared MLP's shards
    per tp rank summed over dp, the router summed over every rank."""
    ref, ranks = runs
    key = f"moe/grad_{loss}/{leaf}"
    want = ref[key]
    if leaf == "x":
        for row in range(MESH[0]):
            for col in range(MESH[1]):
                np.testing.assert_allclose(ranks[_rank(row, col)][key], _moe_slice(want, row, col),
                                           atol=5e-4, rtol=5e-3)
        return
    if leaf.startswith("shared.") or leaf in ("w_in", "w_gate", "w_out"):
        axis = 1 if leaf in ("shared.w_in", "shared.w_gate") else 0  # the shared MLP's tp dim
        got = np.concatenate([sum(ranks[_rank(row, col)][key] for row in range(MESH[0]))
                              for col in range(MESH[1])], axis=axis)
    else:
        got = sum(r[key] for r in ranks)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)
    if loss == "y" or leaf == "router":
        assert np.abs(want).max() > 0  # the leaf takes part in this loss


# -- in this process ----------------------------------------------------------------


def test_int8_compressor_with_a_ctx_equals_without():
    """The compressor does no cross-replica reduce (as the reference's), so
    a sharding context leaves its values as they were, and both equal the
    reference's over three error-feedback rounds."""
    rng = np.random.default_rng(0)
    grads = [{"a": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
             for _ in range(3)]
    outs = []
    for compress, init in (collectives.make_int8_compressor(sharding.ShardCtx()),
                           collectives.make_int8_compressor()):
        res = init({k: torch.from_numpy(v) for k, v in grads[0].items()})
        seq = []
        for g in grads:
            out, res = compress({k: torch.from_numpy(v) for k, v in g.items()}, res)
            seq.append({k: v.numpy() for k, v in out.items()})
        outs.append(seq)
    rcompress, rinit = ref_coll.make_int8_compressor(ref_local_ctx())
    rres = rinit(grads[0])
    for i, g in enumerate(grads):
        rout, rres = rcompress(g, rres)
        for k in g:
            np.testing.assert_array_equal(outs[0][i][k], outs[1][i][k])
            np.testing.assert_array_equal(outs[0][i][k], np.asarray(rout[k]))


def test_shard_ctx_without_a_mesh_and_the_helpers_need_a_group():
    """Off a mesh every axis has size 1 (the reference's ``ShardCtx`` with
    ``mesh=None``); ``make_mesh``, ``local_ctx`` need a process group,
    ``pool_mesh`` falls back to None without one."""
    ctx = sharding.ShardCtx()
    assert (ctx.tp_size, ctx.axis_size("data"), ctx.dp_axis, ctx.axis_index("model")) == (1, 1, "data", 0)
    assert sharding.ShardCtx(dp=("pod", "data")).dp_axis == ("pod", "data")
    assert sharding.ShardCtx(dp=()).dp_axis is None
    assert not moe.use_a2a(configs.get_smoke_config(workers.MOE_ARCH), sharding.ShardCtx(sp=True))
    assert sharding.fsdp_gather(ctx, {"w": torch.ones(2)}, {"w": 0})["w"].shape == (2,)
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh((1,), ("x",), device_type="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        sharding.local_ctx("cpu")
    for s in (1, 4):
        assert sharding.pool_mesh(s, device_type="cpu") is None


def test_convert_gives_each_rank_its_shard():
    """``params_from_reference`` cuts the MoE's 3-D expert slabs per tp rank
    and its shared MLP by its tp-parallel layout (``w_in``'s columns), and a
    stacked stage tree per pipeline stage; an MoE built for that tp width
    loads them."""
    cfg = workers.moe_cfg(configs.get_smoke_config(workers.MOE_ARCH))
    tree = workers.moe_params(cfg)
    for r in range(4):
        state = params_from_reference(tree, sharding.ShardCtx.grid(model=(r, 4)))
        np.testing.assert_array_equal(state["w_gate"].numpy(), tree["w_gate"][4 * r : 4 * r + 4])
        f = tree["shared"]["w_in"].shape[1] // 4
        np.testing.assert_array_equal(state["shared.w_in"].numpy(), tree["shared"]["w_in"][:, f * r : f * r + f])
        moe.MoE(cfg, torch.float32, "cpu", tp_size=4).load_state_dict(state)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        moe.MoE(cfg, torch.float32, "cpu", tp_size=3)
    pp = workers.pp_inputs()
    st = params_from_reference({"w": pp["w"], "b": pp["b"]}, stage=2)
    assert st["w"].shape == (1, 32, 32)
    np.testing.assert_array_equal(st["b"].numpy(), pp["b"][2:3])


def test_moe_a2a_refuses_full_slabs_at_tp_above_one(runs):
    """A module holding every slab on a tp rank is a layout error, not a
    silent mis-dispatch (raised on the ranks, recorded here)."""
    _, ranks = runs
    for r in ranks:
        assert "expert slabs on a rank of tp=4" in str(r["moe/full_slabs_error"])
