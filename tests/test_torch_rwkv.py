"""The port's RWKV6 LM (rwkv6-1.6b) against the JAX package's, on the CPU:
the time mix (its WKV through K7's and K7b's plain versions), the chunked
form, the channel mix, the LM's logits, loss and gradients with and without
``rwkv_chunked``, prefill and decode caches, the serve CLI and the mesh's
refusal, at rwkv6-1.6b's smoke config in float32 on perturbed weights
(``_torch_rwkv_ref.py``: ``bonus`` and ``mb_*`` nonzero, decays down to
2e-9).  Serving against the reference's engine, training and the
checkpoints are in ``test_torch_rwkv_train.py``.

Tolerances (float32 on both sides, other summation orders): the time mix's
output and states, and the WKV's gradients, ``SSD_TOL`` (atol/rtol 1e-5);
logits and caches ``LOGIT_TOL`` (1e-4); the loss rtol 1e-5.  Every gradient
leaf of the LM is held to ``GRAD_TOL`` (atol 1e-5, rtol 1e-4) plus 3e-5 of
the leaf's largest magnitude: the embedding's gradient reaches 9 (16 with
the chunked form), the first norm's 1 / rms (about 50 at the table's 0.02
scale) times the summed gradient of each token's rows, and carries float32
rounding relative to that (2.2e-5 of it measured), where the hybrid's stays
below 1.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.models import rwkv6 as ref_rwkv6
from repro_torch import configs, models
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import wkv as wkv_mod
from repro_torch.launch import serve as serve_cli
from repro_torch.models import rwkv6
from repro_torch.models.convert import params_from_reference
from repro_torch.models.lm import init_params

from _torch_host_reads import NoHostReads
from _torch_rwkv_ref import ARCH, block_params, close, jitted, jnp_batch, pair, trainable

SSD_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
#: Added to ``GRAD_TOL``'s atol, per leaf, times the leaf's largest |gradient|.
GRAD_SCALE_TOL = 3e-5


def _tokens(cfg, seed: int, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _normal(seed: int, shape, scale: float = 1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _port_block(layer: int = 0):
    return pair()[3].layers[layer].rwkv


@functools.lru_cache(maxsize=None)
def _ref_mix(name: str, **kw):
    cfg = pair()[0]
    fn = getattr(ref_rwkv6, name)
    return jax.jit(lambda p, *a: fn(p, cfg, *a, **kw))


def _states(cfg, seed: int, B: int):
    hs, H = rwkv6.dims(cfg)
    return _normal(seed, (B, cfg.d_model), 0.5), _normal(seed + 1, (B, H, hs, hs), 0.5)


# -- the WKV and the time mix ----------------------------------------------------------------


@pytest.mark.parametrize("given", [False, True], ids=["zero_states", "given_states"])
@pytest.mark.parametrize("T", [1, 16, 37])
def test_time_mix_matches_reference(T, given):
    """Output, shift and state of one time mix at T 1 (a decode step), 16
    and 37, from a zero shift and state and from given ones."""
    cfg = pair()[0]
    x = _normal(T, (2, T, cfg.d_model))
    shift, state = _states(cfg, T + 1, 2) if given else (np.zeros((2, cfg.d_model), np.float32),
                                                          np.zeros((2, *_states(cfg, 0, 2)[1].shape[1:]), np.float32))
    want = _ref_mix("rwkv_time_mix")(block_params(), *(jnp.asarray(a) for a in (x, shift, state)))
    with torch.no_grad():
        got = rwkv6.rwkv_time_mix(_port_block(), cfg, *(torch.from_numpy(a) for a in (x, shift, state)))
    for g, w, name in zip(got, want, ("y", "shift", "state")):
        assert tuple(g.shape) == w.shape, name
        close(g, w, err_msg=name, **SSD_TOL)


def test_time_mix_in_place_writes_the_given_state():
    """``in_place`` writes the final state over the given tensor, a slice of a
    stacked cache, and touches no other slice."""
    cfg = pair()[0]
    _, state = _states(cfg, 3, 2)
    x, shift = _normal(4, (2, 5, cfg.d_model)), _states(cfg, 5, 2)[0]
    want = _ref_mix("rwkv_time_mix")(block_params(), *(jnp.asarray(a) for a in (x, shift, state)))
    cache = torch.zeros(3, *state.shape)
    cache[1] = torch.from_numpy(state)
    with torch.no_grad():
        y, _, new = rwkv6.rwkv_time_mix(_port_block(), cfg, torch.from_numpy(x), torch.from_numpy(shift), cache[1],
                                        in_place=True)
    assert new.data_ptr() == cache[1].data_ptr()
    close(y, want[0], **SSD_TOL)
    close(cache[1], want[2], **SSD_TOL)
    assert not cache[0].any() and not cache[2].any()


@functools.lru_cache(maxsize=None)
def _ref_mix_vjp(T: int):
    """``jax.vjp`` of the reference's time mix at T: the gradients of every
    block leaf, x and the shift for a cotangent on y (none on the shift or
    the final state, which the port's Function does not differentiate)."""
    cfg = pair()[0]
    x, shift = _normal(T, (2, T, cfg.d_model)), _states(cfg, T, 2)[0]
    _, state = _states(cfg, T + 7, 2)
    dy = _normal(T + 3, (2, T, cfg.d_model))
    fn = lambda p, a, s: ref_rwkv6.rwkv_time_mix(p, cfg, a, s, jnp.asarray(state))  # noqa: E731
    out, vjp = jax.vjp(fn, block_params(), jnp.asarray(x), jnp.asarray(shift))
    grads = vjp((jnp.asarray(dy), jnp.zeros_like(out[1]), jnp.zeros_like(out[2])))
    return (x, shift, state, dy), grads


@pytest.mark.parametrize("T", [1, 16, 37])
def test_wkv_gradients_match_reference_vjp(T):
    """The time mix under autograd (K7's plain version forward, K7b's
    backward through ``WKVFn``): every leaf's, x's and the shift's gradient
    against ``jax.vjp`` of the reference's time mix, from a given state."""
    cfg = pair()[0]
    (x, shift, state, dy), (gp, gx, gs) = _ref_mix_vjp(T)
    blk = rwkv6.RWKV(cfg, torch.float32, "cpu")
    blk.load_state_dict(_port_block().state_dict())
    blk.requires_grad_(True)
    xt, st = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(shift).requires_grad_(True)
    y, _, new_state = rwkv6.rwkv_time_mix(blk, cfg, xt, st, torch.from_numpy(state))
    assert not new_state.requires_grad
    y.backward(torch.from_numpy(dy))
    close(xt.grad, gx, err_msg="x", **SSD_TOL)
    close(st.grad, gs, err_msg="shift", **SSD_TOL)
    for name, p in blk.named_parameters():
        if name.startswith("cm_"):  # the channel mix's leaves
            assert p.grad is None and not np.asarray(gp[name]).any()
            continue
        close(p.grad, gp[name], err_msg=name, **SSD_TOL)
    assert blk.bonus.grad.abs().sum() > 0
    # at T 1 the decay reaches only the final state, which has no gradient
    assert (blk.w0.grad.abs().sum() > 0) == (T > 1)


@pytest.mark.parametrize("T", [1, 9, 40])
def test_wkv_bwd_plain_is_the_gradient_of_wkv_plain(T):
    """The closed-form backward against autograd through the plain loop, with
    decays down to exp(-e^3) = 2e-9 and nonzero u and s0 (at T 1 the decay
    reaches only the final state: dw is 0).  ``du`` sums B x T terms of up to
    some 200 and is held at rtol 1e-4."""
    B, H, N = 3, 2, 64
    r, k, v, dy = (torch.from_numpy(_normal(T + i, (B, T, H, N))) for i in range(4))
    w = torch.exp(-torch.exp(torch.from_numpy(np.random.default_rng(T).uniform(-8, 3, (B, T, H, N)).astype(np.float32))))
    u, s0 = torch.from_numpy(_normal(5, (H, N))), torch.from_numpy(_normal(6, (B, H, N, N)))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, _ = wkv_mod.wkv_plain(*leaves, s0)
    want = torch.autograd.grad(y, leaves, dy, allow_unused=True)
    got = wkv_mod.wkv_bwd_plain(r, k, v, w, u, s0, dy)
    for g, w_, name in zip(got, want, ("dr", "dk", "dv", "dw", "du")):
        w_ = torch.zeros_like(g) if w_ is None else w_
        close(g, w_.numpy(), err_msg=name, **(dict(SSD_TOL, rtol=1e-4) if name == "du" else SSD_TOL))


def test_wkv_function_rules():
    """The initial state gets no gradient (one that requires it raises), the
    final state is not differentiable, and the WKV is not written in place
    under autograd."""
    B, T, H, N = 1, 3, 2, 64
    r, k, v, w = (torch.rand(B, T, H, N, requires_grad=True) for _ in range(4))
    u, s0 = torch.rand(H, N, requires_grad=True), torch.zeros(B, H, N, N)
    y, s = rwkv6.WKVFn.apply(r, k, v, w, u, s0)
    assert y.requires_grad and not s.requires_grad
    with pytest.raises(ValueError, match="initial state gets no gradient"):
        rwkv6.WKVFn.apply(r, k, v, w, u, s0.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="in place under autograd"):
        rwkv6._wkv(r, k, v, w, u, s0, True)


def test_wkv_wrapper_checks_and_never_copies():
    """Wrong strides, shapes or types raise (no silent copy); the plain
    version runs for CPU tensors and launches nothing; in place returns the
    given state, written."""
    B, T, H, N = 2, 4, 2, 64
    r, k, v, w = (torch.rand(B, T, H, N) for _ in range(4))
    u, s0 = torch.rand(H, N), torch.rand(B, H, N, N)
    with pytest.raises(ValueError, match="last axis contiguous"):
        wkv_mod.wkv(r.transpose(-1, -2).contiguous().transpose(-1, -2), k, v, w, u, s0)
    with pytest.raises(ValueError, match="inner"):
        wkv_mod.wkv(r, k, v, w, u, s0.transpose(-1, -2))
    with pytest.raises(ValueError, match="share one shape"):
        wkv_mod.wkv(r, k[:, :3], v, w, u, s0)
    with pytest.raises(TypeError, match="float32"):
        wkv_mod.wkv(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="share one shape"):
        wkv_mod.wkv_bwd(r, k, v, w, u, s0, r[:, :2])
    kbuild.reset_launches()
    strided = torch.rand(B, T, 2 * H, N)[:, :, ::2]  # a view: only the last axis contiguous
    want_y, want_s = wkv_mod.wkv_plain(strided, k, v, w, u, s0)
    state = s0.clone()
    y, s = wkv_mod.wkv(strided, k, v, w, u, state, in_place=True)
    assert s is state and torch.equal(y, want_y) and torch.equal(state, want_s)
    assert kbuild.LAUNCHES["wkv"] == 0 and kbuild.LAUNCHES["wkv_bwd"] == 0
    y0, s_0 = wkv_mod.wkv(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    assert y0.shape == (B, 0, H, N) and torch.equal(s_0, s0) and s_0.data_ptr() != s0.data_ptr()


@pytest.mark.parametrize("B,T,H", [(1, 1963, 32), (4, 2048, 32)])
def test_launch_plan_fills_the_card(B, T, H):
    """A B 1 prefill of 32 heads and the training shape launch K7 on at
    least 256 blocks (about two on each SM of an H100); the blocks split
    each (b, h)'s columns, and each block's tiles cover its columns."""
    plan = wkv_mod.launch_plan(B, T, H)
    fwd = plan.forward
    assert fwd.grid >= 256 and fwd.grid == B * H * fwd.column_groups and fwd.row_groups == 1
    (rows, cols) = fwd.tile
    assert (64 // rows) * (64 // fwd.column_groups // cols) == fwd.threads
    r_pass, kvw_pass = plan.backward
    assert r_pass.grid == B * H * r_pass.row_groups and kvw_pass.grid == B * H
    assert (64 // r_pass.row_groups // r_pass.tile[0]) * (64 // r_pass.tile[1]) == r_pass.threads
    assert (64 // kvw_pass.tile[0]) * (64 // kvw_pass.tile[1]) == kvw_pass.threads


@pytest.mark.parametrize("B,T,H,checkpoints", [(4, 2048, 32, 4 * 32 * 63), (3, 65, 25, 3 * 25 * 2),
                                               (2, 32, 3, 0), (1, 1, 1, 0)])
def test_launch_plan_checkpoints(B, T, H, checkpoints):
    """K7b keeps one 64 x 64 state a (b, h) every ``CHECKPOINT_STEPS`` steps
    after the first segment (which starts from s0): at the training shape
    126 MiB, within 128 MiB."""
    plan = wkv_mod.launch_plan(B, T, H)
    assert plan.checkpoints == checkpoints and plan.scratch_bytes == checkpoints * 64 * 64 * 4
    assert plan.scratch_bytes <= 128 * 2**20


def test_launch_plan_constants_equal_the_sources():
    """The plan's configurations, threads, tiles and checkpoint steps are
    the ``constexpr`` values of ``wkv.cu`` and ``wkv_bwd.cu`` (every B H
    takes one of K7's two chunked configurations, a single step the wide
    one's); K7b launches its two passes."""
    fwd_src = dict(zip(("CH", "THREADS"), kbuild.source_constants("wkv.cu", "CH", "THREADS")))
    configs_src = [tuple(kbuild.source_constants("wkv.cu", f"{n}_COLS", f"{n}_TILE_R", f"{n}_TILE_C"))
                   for n in ("WIDE", "NARROW")]
    ck, sk, tile, r_threads, r_rows, kvw_threads = kbuild.source_constants(
        "wkv_bwd.cu", "CK", "SK", "TILE", "FWD_THREADS", "FWD_ROWS", "BWD_THREADS")
    seen = set()
    for bh in range(1, 257):
        plan = wkv_mod.launch_plan(1, 100, bh)
        cols = 64 // plan.forward.column_groups
        seen.add((cols, *plan.forward.tile))
        assert plan.forward.threads == fwd_src["THREADS"]
        assert plan.checkpoint_steps == (ck, sk) == (wkv_mod.CHECKPOINT_STEPS, wkv_mod.SUBCHECKPOINT_STEPS)
        r_pass, kvw_pass = plan.backward
        assert (r_pass.threads, 64 // r_pass.row_groups, kvw_pass.threads) == (r_threads, r_rows, kvw_threads)
        assert r_pass.tile == kvw_pass.tile == (tile, tile)
    assert seen == set(configs_src)
    for B in (1, 4):  # a single step takes the wide configuration's blocks and tiles
        step = wkv_mod.launch_plan(B, 1, 32).forward
        assert (64 // step.column_groups, *step.tile) == configs_src[0] and step.grid == B * 32 * step.column_groups
    assert [p.kernel for p in plan.backward] == ["wkv_grad_r", "wkv_grad_kvw"]
    assert len(plan.backward) == wkv_mod.KERNELS_PER_CALL == 2
    assert ck % fwd_src["CH"] == 0 and ck % sk == 0


def test_chunked_time_mix_matches_reference():
    """The chunked form at T 64, chunk 16: output, shift and state against
    the reference's ``rwkv_time_mix_chunked`` (its floor ``-20 / Q`` binds
    for the decays below e^-1.25); T not a multiple of the chunk raises."""
    cfg = pair()[0]
    x, (shift, state) = _normal(64, (2, 64, cfg.d_model)), _states(cfg, 65, 2)
    want = _ref_mix("rwkv_time_mix_chunked", chunk=16)(block_params(), *(jnp.asarray(a) for a in (x, shift, state)))
    with torch.no_grad():
        got = rwkv6.rwkv_time_mix_chunked(_port_block(), cfg, *(torch.from_numpy(a) for a in (x, shift, state)),
                                          chunk=16)
    for g, w, name in zip(got, want, ("y", "shift", "state")):
        close(g, w, err_msg=name, **SSD_TOL)
    with pytest.raises(ValueError, match="T=40 % chunk=16"):
        rwkv6.rwkv_time_mix_chunked(_port_block(), cfg, torch.zeros(1, 40, cfg.d_model),
                                    torch.zeros(1, cfg.d_model), torch.from_numpy(state[:1]), chunk=16)


@pytest.mark.parametrize("given", [False, True], ids=["zero_shift", "given_shift"])
def test_channel_mix_matches_reference(given):
    cfg = pair()[0]
    x = _normal(11, (2, 13, cfg.d_model))
    shift = _states(cfg, 12, 2)[0] if given else np.zeros((2, cfg.d_model), np.float32)
    want = _ref_mix("rwkv_channel_mix")(block_params(1), jnp.asarray(x), jnp.asarray(shift))
    with torch.no_grad():
        got = rwkv6.rwkv_channel_mix(_port_block(1), cfg, torch.from_numpy(x), torch.from_numpy(shift))
    for g, w, name in zip(got, want, ("y", "shift")):
        close(g, w, err_msg=name, **SSD_TOL)


def test_init_draws_the_reference_distributions():
    """``ln_scale`` ones, the ``mu_*`` 0.5, ``w0`` -6, ``bonus`` and ``mb_*``
    zeros, ``wa``/``wb``/``ma_*`` N(0,1) x 0.01, the other matrices N(0,1) x
    d_in^-1/2 (``wo``'s D^-1/2, ``cm_wv``'s F^-1/2); a Mamba block's ``wb``
    (another leaf of that name) keeps its d_in^-1/2."""
    cfg = dataclasses.replace(configs.get_config(ARCH), d_model=512, d_ff=1792, num_heads=8, num_kv_heads=8)
    p = init_params(rwkv6.RWKV(cfg, torch.float32, "cpu"), torch.Generator().manual_seed(0))
    assert (p.ln_scale == 1).all() and (p.w0 == -6).all() and not p.bonus.any()
    for c in rwkv6.MIX:
        assert (getattr(p, f"mu_{c}") == 0.5).all() and not getattr(p, f"mb_{c}").any()
        assert abs(getattr(p, f"ma_{c}").std().item() / 0.01 - 1) < 0.05
    assert (p.mu_x == 0.5).all() and (p.cm_mu_k == 0.5).all() and (p.cm_mu_r == 0.5).all()
    assert abs(p.wa.std().item() / 0.01 - 1) < 0.05 and abs(p.wb.std().item() / 0.01 - 1) < 0.05
    D, F = cfg.d_model, cfg.d_ff
    for name, d_in in (("wr", D), ("wo", D), ("cm_wk", D), ("cm_wv", F), ("cm_wr", D)):
        assert abs(getattr(p, name).std().item() * d_in**0.5 - 1) < 0.05, name
    lm = models.build(configs.get_smoke_config("zamba2-1.2b"), device="cpu").init(torch.Generator().manual_seed(0))
    wb = lm.layers[0].mamba.wb
    assert abs(wb.std().item() * wb.shape[0] ** 0.5 - 1) < 0.1
    port = models.build(configs.get_smoke_config(ARCH), device="cpu").init(torch.Generator().manual_seed(1))
    assert (port.layers[2].rwkv.w0 == -6).all() and (port.layers[0].ln1.scale == 1).all()


# -- the LM ---------------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["scan", "chunked"])
def test_logits_match_reference(variant):
    """The training forward at T 32 (the chunked form's Q = 32)."""
    cfg, _, params, port = pair(variant)
    toks = _tokens(cfg, 1, (2, 32))
    want, _ = jitted(variant, "forward")(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = port(torch.from_numpy(toks))
    close(got, want, **LOGIT_TOL)
    assert aux.item() == 0.0


def _close_grads(port: dict, ref_tree) -> None:
    want = params_from_reference(jax.tree.map(np.asarray, ref_tree))
    assert set(port) == set(want)
    for k, g in port.items():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] + GRAD_SCALE_TOL * scale, err_msg=k)


@pytest.mark.parametrize("variant", ["scan", "chunked"])
def test_loss_and_every_gradient_match_reference(variant):
    """``jax.value_and_grad`` of the reference's loss at T 32: the scan (K7's
    and K7b's plain versions) and the chunked form (no WKV kernel)."""
    cfg, ref, params, _ = pair(variant)
    model = trainable(variant)
    b = TokenPipeline(cfg.vocab_size, 2, 32, seed=0).next_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, jnp_batch(b))
    got, _ = model.loss({k: torch.from_numpy(v) for k, v in b.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    grads_port = {k: p.grad for k, p in model.named_parameters()}
    _close_grads(grads_port, grads)
    assert grads_port["layers.2.rwkv.bonus"].abs().sum() > 0 and grads_port["layers.0.rwkv.mb_w"].abs().sum() > 0


def test_training_forward_runs_the_wkv_through_its_function(monkeypatch):
    """Without ``rwkv_chunked`` each block's time mix runs the WKV forward
    twice (the forward and the checkpoint's recompute) and its backward once;
    with it, never."""
    calls = {"wkv": 0, "wkv_bwd": 0}
    for name in calls:
        orig = getattr(rwkv6, name)
        monkeypatch.setattr(rwkv6, name, lambda *a, _o=orig, _n=name, **kw: calls.__setitem__(_n, calls[_n] + 1)
                            or _o(*a, **kw))
    for variant, want in (("scan", (6, 3)), ("chunked", (0, 0))):
        calls.update(wkv=0, wkv_bwd=0)
        model = trainable(variant)
        b = TokenPipeline(model.cfg.vocab_size, 1, 16, seed=2).next_batch()
        model.loss({k: torch.from_numpy(v) for k, v in b.items()})[0].backward()
        assert (calls["wkv"], calls["wkv_bwd"]) == want, variant


def test_prefill_and_decode_match_reference_caches():
    """Prefill of a 21-token prompt into a cache of 64, then four greedy
    steps: logits each call, and every cache leaf, leaf by leaf."""
    cfg, ref, params, port = pair()
    toks = _tokens(cfg, 3, (2, 21))
    rc, pc = ref.init_cache(2, 64), port.init_cache(2, 64)
    assert set(pc) == set(rc) and all(tuple(pc[k].shape) == rc[k].shape for k in rc)
    want, rc = jitted("scan", "prefill")(params, {"tokens": jnp.asarray(toks)}, rc)
    got, pc = port.prefill(torch.from_numpy(toks), pc)
    close(got, want, **LOGIT_TOL)
    for step in range(4):
        for k in rc:
            close(pc[k], rc[k], err_msg=f"{k} at step {step}", **LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
        want, rc = jitted("scan", "decode_step")(params, rc, jnp.asarray(nxt))
        got, pc = port.decode_step(pc, torch.from_numpy(nxt))
        close(got, want, **LOGIT_TOL)


def test_prefill_starts_from_zero_states_whatever_the_cache_holds():
    cfg, _, _, port = pair()
    toks = torch.from_numpy(_tokens(cfg, 8, (1, 9)))
    clean = port.init_cache(1, 16)
    dirty = port.init_cache(1, 16)
    for k in ("tm_shift", "cm_shift", "wkv"):
        dirty[k].fill_(3.0)
    a, clean = port.prefill(toks, clean)
    b, dirty = port.prefill(toks, dirty)
    assert torch.equal(a, b) and all(torch.equal(clean[k], dirty[k]) for k in clean)


def test_decode_matches_forward():
    """The reference's ``test_rwkv_decode_matches_forward`` on the port:
    eight decode steps from an empty cache give the training forward's
    logits (float32, so within ``LOGIT_TOL`` where the reference's bf16
    test allows 3e-2)."""
    cfg, _, _, port = pair()
    toks = _tokens(cfg, 1, (2, 8))
    with torch.no_grad():
        fwd, _ = port(torch.from_numpy(toks))
    cache = port.init_cache(2, 8)
    outs = []
    for t in range(8):
        lg, cache = port.decode_step(cache, torch.from_numpy(toks[:, t]))
        outs.append(lg)
    close(torch.stack(outs, 1), fwd.numpy(), **LOGIT_TOL)


def test_bf16_cache_dtypes():
    """The shifts are cached in the model's dtype, the WKV state in f32."""
    port = models.build(configs.get_smoke_config(ARCH), device="cpu")
    cache = port.init_cache(2, 16)
    assert set(cache) == {"pos", "tm_shift", "cm_shift", "wkv"}
    assert cache["tm_shift"].dtype == cache["cm_shift"].dtype == torch.bfloat16
    assert cache["wkv"].dtype == torch.float32 and cache["wkv"].shape == (3, 2, 2, 64, 64)


def test_decode_step_reads_nothing_back():
    """The decode step is capturable: no op reads the device on the host."""
    port = pair()[3]
    cache = port.init_cache(3, 16)
    with NoHostReads() as guard:
        port.decode_step(cache, torch.tensor([1, 2, 3]))
    assert guard.seen.get("mm", 0) + guard.seen.get("bmm", 0) > 0


def test_serve_cli_runs_rwkv_on_cpu(capsys):
    """``launch.serve --arch rwkv6-1.6b --smoke --device cpu``: the WKV runs
    K7's plain version, so no launches."""
    kbuild.reset_launches()
    finished = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                               "--slots", "2", "--max-tokens", "4", "--max-len", "32"])
    assert sorted(r.rid for r in finished) == [0, 1, 2] and all(len(r.out) == 4 for r in finished)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    assert not any(kbuild.LAUNCHES.values())


# -- the mesh ------------------------------------------------------------------------------


def _sizes_ctx(data: int, model: int, **kw):
    """A ShardCtx whose mesh answers only its axes' sizes, every rank
    coordinate 0 (no process group)."""
    sizes = {"data": data, "model": model}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), size=lambda i: list(sizes.values())[i],
                                 get_local_rank=lambda name: 0)
    return ShardCtx(mesh=mesh, tp="model", **kw)


@pytest.mark.parametrize("ctx", [
    _sizes_ctx(2, 2), _sizes_ctx(1, 2, fsdp=None), _sizes_ctx(2, 1), _sizes_ctx(1, 1, sp=True),
    ShardCtx.grid(model=(0, 1), data=(1, 2)),
], ids=["2x2", "tp2", "fsdp2", "sp", "grid_fsdp2"])
def test_mesh_builds_each_block_shard(ctx):
    """On a mesh the RWKV6 kind builds, each block this rank's shard of the
    reference's ``spec_rwkv`` (D over tp and fsdp, ``bonus`` and the cache's
    ``wkv`` by heads), from token or embedding inputs alike (the embeddings
    model's leaves are the token model's)."""
    tp, fsdp = ctx.tp_size, ctx.axis_size(ctx.fsdp)
    cfg = pair()[3].cfg
    embeds = models.build(dataclasses.replace(cfg, input_kind="embeds"), ctx=ctx, device="cpu")
    assert {n: p.shape for n, p in embeds.named_parameters()} == {
        n: p.shape for n, p in models.build(cfg, ctx=ctx, device="cpu").named_parameters()}
    port = models.build(cfg, ctx=ctx, device="cpu")
    D, H = cfg.d_model, cfg.d_model // cfg.rwkv.head_size
    blk = port.layers[0].rwkv
    assert blk.wr.shape == (D // fsdp, D // tp) and blk.mb_w.shape == (cfg.rwkv.mix_lora, D // tp)
    assert blk.bonus.shape == (H // tp, 64) and blk.mu_x.shape == (D,)
    assert port.init_cache(1, 8)["wkv"].shape == (3, 1, H // tp, 64, 64)


def test_one_by_one_mesh_builds():
    port = models.build(pair()[3].cfg, ctx=_sizes_ctx(1, 1), device="cpu")
    assert port.init_cache(1, 8)["wkv"].shape == (3, 1, 2, 64, 64)
