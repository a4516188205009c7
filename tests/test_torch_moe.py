"""The port's MoE layer and the kernels K3 (key-value sort) and K4 (row
merge), held against the JAX package on the CPU.

On the CPU a kernel wrapper runs its plain torch version, which runs the
reference's network stage for stage: K3's keys *and* values equal the
reference's Pallas kernel (interpret mode) exactly, ties included, and so do
K4's merged rows.  The MoE layer is held against ``repro.models.moe.
moe_layer`` with ``local_ctx()`` at both MoE smoke configs in float32: the
outputs within atol/rtol 1e-4 (the expert outputs are summed in another
order), the load-balance aux within 1e-6, the dropped count equal.  Inputs
are drawn with numpy from a seed and handed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed.sharding import local_ctx
from repro.kernels import ops as ref_ops
from repro.models import moe as ref_moe
from repro_torch import configs
from repro_torch.kernels import bitonic, build, ops
from repro_torch.models import moe
from repro_torch.models.lm import init_params
from repro_torch.models.convert import params_from_reference

MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]


# -- K3: the key-value sort --------------------------------------------------------


@pytest.mark.parametrize("n", [8, 128, 512])
def test_sort_rows_kv_plain_matches_reference_unique_keys(n):
    perm = np.random.default_rng(n).permutation(n).astype(np.int32)
    keys, vals = perm[None, :], (perm * 7 + 1)[None, :]
    wk, wv = ref_ops.sort_rows_kv(jnp.asarray(keys), jnp.asarray(vals))
    gk, gv = ops.sort_rows_kv(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gk.numpy()[0], np.arange(n))


@pytest.mark.parametrize("n", [16, 256])
def test_sort_rows_kv_plain_matches_reference_duplicate_keys(n):
    """Unstable, but the same network: equal keys come out in the same order
    on both sides, so the values agree exactly too."""
    rng = np.random.default_rng(n + 1)
    keys = rng.integers(0, 7, size=(4, n)).astype(np.int32)
    vals = np.arange(4 * n, dtype=np.int32).reshape(4, n)
    wk, wv = ref_ops.sort_rows_kv(jnp.asarray(keys), jnp.asarray(vals))
    gk, gv = bitonic.sort_rows_kv_plain(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gk.numpy(), np.sort(keys, axis=1))
    for r in range(4):  # every (key, value) pair survives
        assert sorted(zip(gk[r].tolist(), gv[r].tolist())) == sorted(zip(keys[r], vals[r]))


def test_sort_rows_kv_int64_keys():
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 40), 1 << 40, size=(3, 64)).astype(np.int64)
    keys[:, ::5] = 11  # ties
    vals = np.arange(3 * 64, dtype=np.int32).reshape(3, 64)
    gk, gv = ops.sort_rows_kv(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(gk.numpy(), np.sort(keys, axis=1))
    np.testing.assert_array_equal(np.take_along_axis(keys, gv.numpy() % 64, axis=1), gk.numpy())


# -- K3's launch plan: which stages each launch of the kernel runs ---------------


@pytest.mark.parametrize("n", [1 << e for e in range(1, 21)])
def test_k3_plan_runs_the_network_in_order(n):
    """Concatenated, the launches' stages are the network's, in order; every
    chunk stage pairs two positions of one chunk, every strided stage two of
    one group {i + m C}, and only stages at least C * GROUP apart are
    device-memory passes."""
    C, GROUP = bitonic.ROW_SORT_KV_CHUNK, bitonic.ROW_SORT_KV_GROUP
    plan = bitonic.row_sort_kv_plan(n)
    assert [st for _, stages in plan for st in stages] == list(bitonic._stages(n))
    c = min(n, C)
    assert plan[0] == ("chunk", list(bitonic._stages(c)))
    lower = np.arange(n)
    for kind, stages in plan:
        assert stages
        if kind == "global":
            assert len(stages) == 1 and stages[0][1] >= C * GROUP
            continue
        span = c if kind == "chunk" else 2 * stages[0][1]
        assert kind == "chunk" or 2 <= span // C <= GROUP
        for _, j in stages:
            i = lower[(lower & j) == 0]
            assert np.array_equal(i // span, (i + j) // span)  # one chunk / one group
            if kind == "strided":
                assert j % C == 0 and np.array_equal(i % C, (i + j) % C)


@pytest.mark.parametrize("n,launches", [(2, 1), (32, 1), (2048, 1), (4096, 3), (16_384, 7),
                                        (1 << 15, 9), (1 << 16, 12), (1 << 20, 34)])
def test_k3_plan_launch_counts(n, launches):
    """1 x 16,384 (the MoE prefill's row): 1 + 2 * 3 launches; the stages
    split 66 + (1 + 11) + (2 + 11) + (3 + 11)."""
    plan = bitonic.row_sort_kv_plan(n)
    assert len(plan) == launches
    if n == 16_384:
        assert [len(stages) for _, stages in plan] == [66, 1, 11, 2, 11, 3, 11]
    assert bitonic.row_sort_kv_plan(1) == []


def _k3_plan_model(keys: torch.Tensor, vals: torch.Tensor):
    """K3's launches in torch, launch by launch as the kernel cuts the row: a
    chunk launch works on (rows, n/c, c) chunks, a strided launch on the
    groups {i + m C} laid out as (rows, n/span, C, span/C), a device-memory
    pass on the whole row; each stage through ``compare_exchange_kv`` on the
    local axis.  A chunk or group whose position has bit k set runs
    descending: on ``~keys`` (order-reversing), which is the kernel's
    ``asc ? a > b : a < b`` with ties kept."""
    rows, n = keys.shape
    C = bitonic.ROW_SORT_KV_CHUNK
    for kind, stages in bitonic.row_sort_kv_plan(n):
        if kind == "global":
            ((k, j),) = stages
            keys, vals = bitonic.compare_exchange_kv(keys, vals, k, j)
            continue
        if kind == "chunk":
            span, dist = min(n, C), 1
            view = lambda x: x.reshape(rows, n // span, span)
            unview = lambda x: x.reshape(rows, n)
            offs = (torch.arange(n // span) * span)[None, :, None]
        else:
            span, dist = 2 * stages[0][1], C
            view = lambda x: x.reshape(rows, n // span, span // C, C).transpose(-1, -2)
            unview = lambda x: x.transpose(-1, -2).reshape(rows, n)
            offs = (torch.arange(n // span) * span)[None, :, None, None]
        kk, vv = view(keys), view(vals)
        width = kk.shape[-1]
        for k, j in stages:
            if k >= span:  # one direction for the whole chunk or group
                desc = (offs & k) != 0
                kk = torch.where(desc, ~kk, kk)
                kk, vv = bitonic.compare_exchange_kv(kk, vv, width, j // dist)
                kk = torch.where(desc, ~kk, kk)
            else:
                kk, vv = bitonic.compare_exchange_kv(kk, vv, k, j)
        keys, vals = unview(kk).contiguous(), unview(vv).contiguous()
    return keys, vals


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("rows,n,hi", [(3, 8, 3), (2, 512, 7), (1, 4096, 5), (2, 16_384, 40),
                                       (1, 1 << 16, 9), (2, 1 << 17, 1 << 20)])
def test_k3_plan_model_equals_plain(rows, n, hi, dtype):
    """Duplicate keys: launch by launch, the kernel's cut of the row gives
    the plain network's keys and values exactly."""
    rng = np.random.default_rng(n + rows)
    keys = torch.from_numpy(rng.integers(0, hi, size=(rows, n)).astype(dtype))
    vals = torch.from_numpy(rng.permutation(rows * n).astype(np.int32).reshape(rows, n))
    gk, gv = _k3_plan_model(keys, vals)
    wk, wv = bitonic.sort_rows_kv_plain(keys, vals)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(gk, torch.sort(keys, dim=1).values)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("rows,n", [(4, 256), (1, 4096), (1, 1 << 16)])
def test_k3_plan_model_equals_reference_kernel(rows, n, dtype):
    """Duplicate keys: the plan's model against the reference's Pallas
    ``sort_tiles_kv`` (interpret mode), keys and values."""
    rng = np.random.default_rng(7 * n + rows)
    keys = rng.integers(0, 40, size=(rows, n)).astype(dtype)
    if dtype == np.int64:
        keys = keys * (1 << 33) - (1 << 35)
    vals = np.arange(rows * n, dtype=np.int32).reshape(rows, n)
    with jax.enable_x64(dtype == np.int64):
        wk, wv = ref_ops.sort_rows_kv(jnp.asarray(keys), jnp.asarray(vals))
        wk, wv = np.asarray(wk), np.asarray(wv)
    assert wk.dtype == dtype
    gk, gv = _k3_plan_model(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gv.numpy(), wv)


@pytest.mark.parametrize("n", [1, 5, 32, 100, 1000])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_argsort_padded_matches_reference(n, dtype):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(n // 3, 2), size=n).astype(dtype)
    if dtype == np.int64:
        with jax.enable_x64(True):
            wk, wv = ref_ops.argsort_padded(jnp.asarray(keys))
            wk, wv = np.asarray(wk), np.asarray(wv)
    else:
        wk, wv = ref_ops.argsort_padded(jnp.asarray(keys))
    gk, gv = ops.argsort_padded(torch.from_numpy(keys))
    assert gv.dtype == torch.int32 and gk.shape == (n,)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(keys[gv.numpy()], np.sort(keys))


@pytest.mark.parametrize("nk,key_max", [(32, 48), (15_704, 48), (1_000, 3), (640, 1 << 30)])
def test_dispatch_order_is_the_stable_argsort(nk, key_max):
    """Many duplicate keys (or, at key_max 2^30, the int64 composite): K3's
    network on the composite key gives ``argsort(kind="stable")`` exactly."""
    rng = np.random.default_rng(nk)
    key = rng.integers(0, min(key_max, 40) + 1, size=nk)
    order = moe.stable_argsort(torch.from_numpy(key), key_max)
    np.testing.assert_array_equal(order.numpy(), np.argsort(key, kind="stable"))


def test_wrappers_check_types_and_never_launch_on_cpu():
    build.reset_launches()
    k = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 or int64 keys"):
        bitonic.sort_rows_kv(k.float(), k)
    with pytest.raises(TypeError, match="int32 values"):
        bitonic.sort_rows_kv(k, k.long())
    with pytest.raises(ValueError, match="differ"):
        bitonic.sort_rows_kv(k, k[:, :4].contiguous())
    with pytest.raises(ValueError, match="power of two"):
        bitonic.sort_rows_kv(k[:, :6].contiguous(), k[:, :6].contiguous())
    with pytest.raises(TypeError, match="integer keys"):
        ops.argsort_padded(torch.zeros(4))
    with pytest.raises(TypeError, match="int32, int64 or float32"):
        bitonic.merge_rows(k.double(), k.double())
    with pytest.raises(TypeError, match="one type"):
        bitonic.merge_rows(k, k.long())
    with pytest.raises(ValueError, match="power of two"):
        bitonic.merge_rows(k[:, :6].contiguous(), k[:, :6].contiguous())
    ops.sort_rows_kv(k, k)
    ops.merge_rows(k, k)
    assert build.LAUNCHES["row_sort_kv"] == 0 and build.LAUNCHES["merge_rows"] == 0
    assert "row_sort_kv" not in build._LIBS and "merge_rows" not in build._LIBS


# -- K4: the row merge --------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 128, 1024])
@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int64])
def test_merge_rows_plain_matches_reference(n, dtype):
    rng = np.random.default_rng(n)
    if dtype == np.float32:
        a, b = (np.sort(rng.standard_normal((8, n)).astype(dtype), axis=-1) for _ in range(2))
    else:
        hi = 1 << 40 if dtype == np.int64 else 1000
        a, b = (np.sort(rng.integers(0, hi, size=(8, n)).astype(dtype), axis=-1) for _ in range(2))
    if dtype == np.int64:
        with jax.enable_x64(True):
            want = np.asarray(ref_ops.merge_rows(jnp.asarray(a), jnp.asarray(b)))
    else:
        want = np.asarray(ref_ops.merge_rows(jnp.asarray(a), jnp.asarray(b)))
    got = ops.merge_rows(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([a, b], axis=1), axis=1))


# -- the MoE layer ---------------------------------------------------------------------


def _moe_pair(arch, capacity_factor=None, seed=0):
    cfg = ref_get_smoke(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))
    params = ref_moe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    port = moe.MoE(cfg, torch.float32, "cpu")
    port.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params)))
    return cfg, params, port


@pytest.mark.parametrize("capacity_factor", [None, 0.05])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_reference(arch, capacity_factor):
    """At the smoke configs (nothing dropped) and with the capacity binding
    (capacity factor 0.05, as ``test_moe_capacity_drops_are_counted``)."""
    cfg, params, port = _moe_pair(arch, capacity_factor)
    x = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    y, aux, dropped = ref_moe.moe_layer(params, cfg, local_ctx(), jnp.asarray(x))
    py, paux, pdropped = moe.moe_layer(port, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(py.numpy(), np.asarray(y), atol=1e-4, rtol=1e-4)
    assert abs(paux.item() - float(aux)) < 1e-6
    assert pdropped.item() == int(dropped)
    if capacity_factor is not None:
        assert pdropped.item() > 0
    else:
        assert pdropped.item() == 0


def test_moe_params_and_init():
    """Padded experts at both ends: the router has ``num_experts`` outputs,
    the slabs the padded count; the port's init draws the reference's
    distributions."""
    cfg = configs.get_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, d_model=256, moe=dataclasses.replace(cfg.moe, num_experts=40))
    assert moe.padded_experts(40) == ref_moe.padded_experts(40) == 48
    p = init_params(moe.MoE(cfg, torch.float32, "cpu"), torch.Generator().manual_seed(0))
    D, Fe = cfg.d_model, cfg.moe.d_expert
    assert p.router.shape == (D, 40) and p.router.dtype == torch.float32
    assert p.w_in.shape == (48, D, Fe) and p.w_out.shape == (48, Fe, D) and p.w_gate.shape == (48, D, Fe)
    for w, std in ((p.router, D**-0.5), (p.w_in, D**-0.5), (p.w_gate, D**-0.5), (p.w_out, Fe**-0.5)):
        assert abs(w.std().item() / std - 1) < 0.05
    ds = configs.get_smoke_config("deepseek-moe-16b")
    shared = moe.MoE(ds, torch.float32, "cpu").shared
    assert shared.w_in.shape == (ds.d_model, ds.moe.num_shared * ds.moe.d_expert)


def test_moe_layer_routes_through_k3_and_counts_drops():
    """The dispatch sorts on ``argsort_padded`` (K3's wrapper); every
    assignment over its expert's capacity is counted, none under it."""
    cfg, _, port = _moe_pair("granite-moe-3b-a800m", 0.05)
    calls = []
    orig = ops.argsort_padded

    def spy(keys):
        calls.append(keys.shape)
        return orig(keys)

    ops.argsort_padded = spy
    try:
        x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 16, cfg.d_model)).astype(np.float32))
        _, _, dropped = moe.moe_layer(port, cfg, x)
    finally:
        ops.argsort_padded = orig
    assert calls == [(16 * cfg.moe.top_k,)]
    cap = max(int(16 * cfg.moe.top_k / cfg.moe.num_experts * 0.05), 1)
    logits = x.reshape(16, -1) @ port.router
    eid = torch.topk(torch.softmax(logits, -1), cfg.moe.top_k).indices.reshape(-1)
    want = sum(max(int(c) - cap, 0) for c in torch.bincount(eid, minlength=cfg.moe.num_experts))
    assert dropped.item() == want


def test_moe_a2a_is_not_ported():
    """The all_to_all dispatch is ported (M19; held to the reference at 8
    gloo ranks by ``tests/test_torch_distributed.py``): it runs on a mesh
    and refuses a context without one."""
    from repro_torch.distributed.sharding import ShardCtx

    cfg = configs.get_smoke_config("granite-moe-3b-a800m")
    port = moe.MoE(cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_layer_a2a(port, cfg, ShardCtx(sp=True), torch.zeros(1, 4, cfg.d_model))


def test_router_refuses_tf32_on_the_card(monkeypatch):
    """The router's product must run in full float32 on the card: building an
    MoE for CUDA with TF32 on raises; the CPU has no TF32 and never raises."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="allow_tf32"):
        moe.require_full_f32("cuda")
    moe.require_full_f32("cpu")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    moe.require_full_f32("cuda")
