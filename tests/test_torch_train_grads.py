"""The port's training forward against the JAX package's, on the CPU: the
loss and every gradient leaf of the float32 smoke LMs (``mistral-nemo-12b``,
``granite-moe-3b-a800m`` and ``deepseek-moe-16b`` with its leading dense
layer) against ``jax.value_and_grad`` of the reference's ``LM.loss``; the
trainable switch; the per-block recompute; microbatching and the 30-step
convergence run of the reference's tests.

Tolerances (float32 on both sides, other summation orders): loss rtol 1e-5,
the MoE aux rtol 1e-5, every gradient leaf atol 1e-5 + rtol 1e-4;
microbatched against full batch: loss rtol 1e-5, parameters atol 1e-5 +
rtol 1e-4 (the gradients are summed in another grouping); the microbatched
step against the reference's: the train tests' tolerances (loss and
gradient norm rtol 1e-4, parameters atol 1e-4), moments atol 1e-6 and,
where the gradients accumulate in bfloat16, the bound of each element's
bf16 rounding besides (a partial sum may round to its neighbouring bf16
value in one framework and not in the other, or cancel to 0 in one of them;
the test states the bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.train import optimizer as ref_opt
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch import configs, models
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn_mod
from repro_torch.models.convert import params_from_reference
from repro_torch.models import moe as moe_mod
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step

from _torch_train_ref import _batch_np, _close, _close_tree, _jb, _port, _port_steps, _ref, _tb

ARCHS = ["mistral-nemo-12b", "granite-moe-3b-a800m", "deepseek-moe-16b"]
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# The reference test's convergence bar (tests/test_train.py).
MIN_LOSS_DROP = 0.45


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    cfg, ref, params, _ = _ref(arch)
    model = _port(arch)
    b = _batch_np(cfg.vocab_size, 0)
    (loss, met), grads = jax.value_and_grad(lambda p: ref.loss(p, _jb(b)), has_aux=True)(params)
    got, gm = model.loss(_tb(b))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(gm["aux"].item(), float(met["aux"]), rtol=1e-5, atol=1e-7)
    _close_tree({k: p.grad for k, p in model.named_parameters()}, grads, **GRAD_TOL)


def test_model_is_frozen_until_switched_and_serve_is_unchanged():
    model = models.build(configs.get_smoke_config("mistral-nemo-12b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="frozen"):
        build_train_step(model, opt.AdamWConfig())
    toks = torch.randint(0, 512, (2, 5), generator=torch.Generator().manual_seed(1))
    want, _ = model.prefill(toks, model.init_cache(2, 8))
    model.requires_grad_(True)
    assert all(p.requires_grad for p in model.parameters())
    got, _ = model.prefill(toks, model.init_cache(2, 8))
    assert not got.requires_grad and torch.equal(got, want)


def test_recompute_repeats_the_dispatch_and_attention():
    """Each block is recomputed in the backward: the MoE dispatch (K3's
    sort) runs twice a layer and gives the forward's permutation and drops
    again; K5 runs twice a layer, K5b once."""
    cfg, _, _, _ = _ref("granite-moe-3b-a800m")
    model = _port("granite-moe-3b-a800m")
    seen, calls = [], {"fwd": 0, "bwd": 0}
    orig = moe_mod.dispatch, attn_mod.flash_attention, attn_mod.flash_attention_bwd

    def dispatch(*a):
        seen.append(orig[0](*a))
        return seen[-1]

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return orig[1](*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return orig[2](*a, **kw)

    moe_mod.dispatch, attn_mod.flash_attention, attn_mod.flash_attention_bwd = dispatch, fwd, bwd
    try:
        loss, _ = model.loss(_tb(_batch_np(cfg.vocab_size, 4, batch=4, seq=32)))
        assert len(seen) == cfg.num_layers and calls == {"fwd": cfg.num_layers, "bwd": 0}
        loss.backward()
    finally:
        moe_mod.dispatch, attn_mod.flash_attention, attn_mod.flash_attention_bwd = orig
    L = cfg.num_layers
    assert len(seen) == 2 * L and calls == {"fwd": 2 * L, "bwd": L}
    for i in range(L):
        f, r = seen[i], seen[2 * L - 1 - i]
        assert torch.equal(f.order, r.order) and torch.equal(f.slot, r.slot) and torch.equal(f.dropped, r.dropped)
    assert int(sum(d.dropped for d in seen[:L])) > 0  # the capacity binds somewhere


# -- train steps ------------------------------------------------------------------------


def test_microbatched_equals_full_batch():
    """Four microbatches of one row against the full batch: the mean CE is
    the mean of the microbatches' (equal-size) means, so loss and the update
    agree within float32 reassociation."""
    m1, m4 = _port("mistral-nemo-12b"), _port("mistral-nemo-12b")
    _, o1 = _port_steps(m1, 1, 1)
    s4, o4 = _port_steps(m4, 1, 1, microbatches=4)
    np.testing.assert_allclose(o4[0], o1[0], rtol=1e-5)
    for (k, a), b in zip(m1.named_parameters(), m4.parameters()):
        _close(a, b.detach(), atol=1e-5, rtol=1e-4, err_msg=k)
    assert s4["m"]["embed.table"].dtype == torch.float32


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatched_step_matches_reference(microbatches, accum):
    """One step of the port's microbatched train step against the
    reference's with the same split and accumulation type, from the same
    weights on the same batch of 4 rows (no warmup, so the step moves every
    parameter).  In bfloat16 each framework rounds each partial sum of the
    microbatches' f32 gradients g_j within 2^-9 of it, so the averaged
    gradients differ by at most dg = 2^-7 sum_j |g_j| (the final division
    included; times the clip's scale), the moments by b1's and b2's share of
    that, and an update only where dg reaches the gradient's size."""
    cfg, ref, params, _ = _ref("mistral-nemo-12b")
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    rcfg = ref_opt.AdamWConfig(**ocfg)
    rstep = jax.jit(ref_build_train_step(ref, rcfg, microbatches=microbatches, accum_dtype=getattr(jnp, accum)))
    b = _batch_np(cfg.vocab_size, 5, batch=4, seq=32)
    params, rstate, rmet = rstep(params, ref_opt.init_opt_state(params, rcfg), _jb(b))
    model = _port("mistral-nemo-12b")
    pcfg = opt.AdamWConfig(**ocfg)
    names, leaves = zip(*model.named_parameters())
    size = 4 // microbatches
    spread = [sum(g.abs() for g in gs) for gs in zip(*(
        torch.autograd.grad(model.loss({k: x[i:i + size] for k, x in _tb(b).items()})[0], leaves)
        for i in range(0, 4, size)))]
    state, met = build_train_step(model, pcfg, microbatches=microbatches, accum_dtype=getattr(torch, accum))(
        opt.init_opt_state(dict(model.named_parameters()), pcfg), _tb(b))
    np.testing.assert_allclose([float(met["loss"]), float(met["grad_norm"])],
                               [float(rmet["loss"]), float(rmet["grad_norm"])], rtol=1e-4)
    rp, rm, rv = (params_from_reference(jax.tree.map(np.asarray, t)) for t in (params, rstate["m"], rstate["v"]))
    clip = min(1.0, pcfg.grad_clip / float(met["grad_norm"]))
    for name, leaf, sp in zip(names, leaves, spread):
        dg = 2**-7 * clip * sp.numpy() if accum == "bfloat16" else 0.0
        g = np.abs(rm[name].numpy()) / (1 - pcfg.b1)
        # The first update is lr g / (|g| + eps): it may only flip where the
        # gradient's bound reaches its size.
        for got, want, tol in ((leaf, rp[name], 1e-4 + 2 * pcfg.lr * (dg >= g)),
                               (state["m"][name], rm[name], 1e-6 + (1 - pcfg.b1) * dg),
                               (state["v"][name], rv[name], 1e-6 + (1 - pcfg.b2) * 2 * (g + dg) * dg)):
            diff = np.abs(got.detach().numpy() - want.numpy())
            assert (diff <= tol).all(), (name, float((diff - tol).max()))
    assert int(state["step"]) == int(rstate["step"]) == 1


def test_microbatches_must_divide_the_batch():
    """B = 8 in 3 microbatches: the port raises, and the reference's reshape
    refuses it too."""
    cfg, ref, params, _ = _ref("mistral-nemo-12b")
    b = _batch_np(cfg.vocab_size, 0, batch=8, seq=8)
    rcfg = ref_opt.AdamWConfig()
    with pytest.raises((TypeError, ValueError)):
        ref_build_train_step(ref, rcfg, microbatches=3)(params, ref_opt.init_opt_state(params, rcfg), _jb(b))
    model = _port("mistral-nemo-12b")
    step = build_train_step(model, opt.AdamWConfig(), microbatches=3)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    with pytest.raises(ValueError, match=r"microbatches=3 .* B=8"):
        step(opt.init_opt_state(dict(model.named_parameters()), opt.AdamWConfig()), _tb(b))
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())


def test_thirty_step_smoke_loss_drops():
    """The reference test's run (mistral smoke, batch 4 x 32, lr 1e-3) drops
    its loss by at least the reference's bar, plain and int8-compressed."""
    for compressed in (False, True):
        model = _port("mistral-nemo-12b")
        cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
        hook = None
        if compressed:
            compress, init = coll.make_int8_compressor()
            res = {}

            def hook(g):
                res.setdefault("r", init(g))
                out, res["r"] = compress(g, res["r"])
                return out

        step = build_train_step(model, cfg, grad_compressor=hook)
        state = opt.init_opt_state(dict(model.named_parameters()), cfg)
        pipe, losses = TokenPipeline(model.cfg.vocab_size, 4, 32, seed=0), []
        for _ in range(30):
            state, met = step(state, _tb(pipe.next_batch()))
            losses.append(float(met["loss"]))
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] - MIN_LOSS_DROP, (compressed, losses[::6])
