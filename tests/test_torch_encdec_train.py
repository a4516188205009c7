"""The port's encoder-decoder LM (whisper-small) trained against the JAX
package's, on the CPU, at its float32 smoke config on the perturbed weights
of ``_torch_encdec_ref.py``: the loss and every gradient leaf against
``jax.value_and_grad`` of the reference's loss, the per-block recompute (K5
twice and K5b once an attention, the cross-attention's dk/dv over the
encoder's length), one and two AdamW steps against the reference's jitted
train step with the decay of the stacked norm scales and biases, the
microbatched step, and the decay set leaf by leaf.

Tolerances (float32 on both sides): the loss rtol 1e-5; every gradient leaf
atol 1e-5 + rtol 1e-4 plus 3e-5 of the leaf's largest magnitude (as
``test_torch_rwkv.py`` holds them); the train steps' loss and gradient norm
rtol 1e-4, parameters atol 1e-4 and first moments atol 1e-5 + rtol 1e-4 (the
training tests' tolerances).
"""

import functools

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.train import optimizer as ref_opt
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.models import attention as attn_mod
from repro_torch.models.convert import opt_state_to_reference, params_from_reference
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step

from _torch_encdec_ref import S, T, batch_np, close, jb, pair, tb, trainable
from _torch_train_ref import _close_tree

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
#: Added to ``GRAD_TOL``'s atol, per leaf, times the leaf's largest |gradient|.
GRAD_SCALE_TOL = 3e-5
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
#: Rows of the train steps' batches (two microbatches of two).
ROWS = 4


def test_loss_and_every_gradient_match_reference():
    cfg, ref, params, _ = pair()
    b = batch_np(11)
    (loss, met), grads = jax.jit(jax.value_and_grad(lambda p: ref.loss(p, jb(b)), has_aux=True))(params)
    model = trainable()
    got, gm = model.loss(tb(b))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert float(gm["aux"]) == float(met["aux"]) == 0.0
    want = params_from_reference(jax.tree.map(np.asarray, grads))
    port = {k: p.grad for k, p in model.named_parameters()}
    assert set(port) == set(want)
    for k, g in port.items():
        w = want[k].float()
        close(g, w, err_msg=k, atol=GRAD_TOL["atol"] + GRAD_SCALE_TOL * float(w.abs().max()), rtol=GRAD_TOL["rtol"])
    assert float(port["decoder.1.xattn.bv"].abs().max()) > 0 and float(port["encoder.0.ln1.scale"].abs().max()) > 0


def test_recompute_runs_k5_twice_and_k5b_once_an_attention():
    """The forward runs K5 once an attention (L_enc encoder, 2 L_dec decoder:
    self and cross), the backward's recompute once more, and K5b once; the
    cross-attention's K5b gets K/V over the S encoder rows and returns dk/dv
    of that length."""
    cfg = pair()[0]
    model = trainable()
    calls = {"fwd": 0, "bwd": 0}
    cross = []
    orig = attn_mod.flash_attention, attn_mod.flash_attention_bwd

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return orig[0](*a, **kw)

    def bwd(q, k, *a, **kw):
        calls["bwd"] += 1
        out = orig[1](q, k, *a, **kw)
        if k.shape[1] != q.shape[1]:
            cross.append((tuple(q.shape), tuple(out[1].shape), tuple(out[2].shape)))
        return out

    attn_mod.flash_attention, attn_mod.flash_attention_bwd = fwd, bwd
    try:
        loss, _ = model.loss(tb(batch_np(12)))
        n = cfg.encoder_layers + 2 * cfg.num_layers
        assert calls == {"fwd": n, "bwd": 0}
        loss.backward()
    finally:
        attn_mod.flash_attention, attn_mod.flash_attention_bwd = orig
    assert calls == {"fwd": 2 * n, "bwd": n}
    kv = (2, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cross == [((2, T, cfg.num_heads, cfg.resolved_head_dim), kv, kv)] * cfg.num_layers


@functools.lru_cache(maxsize=None)
def _ref_train(n: int, microbatches: int = 1):
    _, ref, params, _ = pair()
    rcfg = ref_opt.AdamWConfig(**OPT)
    step = jax.jit(ref_build_train_step(ref, rcfg, microbatches=microbatches))
    ostate = ref_opt.init_opt_state(params, rcfg)
    out = []
    for i in range(n):
        params, ostate, met = step(params, ostate, jb(batch_np(20 + i, b=ROWS)))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return params, ostate, out


def _port_train(n: int, microbatches: int = 1):
    model = trainable()
    cfg = opt.AdamWConfig(**OPT)
    step = build_train_step(model, cfg, microbatches=microbatches)
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    out = []
    for i in range(n):
        state, met = step(state, tb(batch_np(20 + i, b=ROWS)))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return model, state, out


@pytest.mark.parametrize("n,microbatches", [(1, 1), (2, 1), (1, 2)], ids=["1_step", "2_steps", "microbatches_2"])
def test_adamw_steps_match_reference(n, microbatches):
    """Train steps (AdamW, lr 1e-3, warmup 2, weight decay 0.1, f32
    accumulation over microbatches) against the reference's jitted step:
    loss, norm, every parameter (the stacked norm scales and biases decayed
    as the reference decays its (L, n) leaves) and first moment."""
    rparams, rstate, rout = _ref_train(n, microbatches)
    model, state, out = _port_train(n, microbatches)
    np.testing.assert_allclose(np.array(out), np.array(rout), rtol=1e-4)
    # A key bias's gradient is 0 in exact arithmetic (it adds q.bk to every
    # logit of a row, which the softmax ignores): both sides hold rounding
    # noise, which AdamW scales to a step of up to lr (|m^/sqrt(v^)| <= 1 at
    # b1 0.9, b2 0.95 over these steps) of either sign.  Those leaves are held
    # to the two steps' gap, the others to 1e-4.
    params = dict(model.named_parameters())
    key_bias = {k for k in params if k.endswith("attn.bk")}
    want = params_from_reference(jax.tree.map(np.asarray, rparams))
    gap = 2 * sum(float(opt.lr_schedule(opt.AdamWConfig(**OPT), t)) for t in range(1, n + 1))
    assert set(params) == set(want) and len(key_bias) == 2 * pair()[0].num_layers + pair()[0].encoder_layers
    for k, p in params.items():
        close(p, want[k], err_msg=k, atol=1e-4 + (gap if k in key_bias else 0.0), rtol=0)
    _close_tree(state["m"], rstate["m"], atol=1e-5, rtol=1e-4)
    assert int(state["step"]) == int(rstate["step"]) == n
    ref_tree = opt_state_to_reference(state)
    assert jax.tree.structure(jax.tree.map(np.asarray, ref_tree["m"])) == jax.tree.structure(rstate["m"])


def test_decay_set_is_the_reference_leaf_rank():
    """AdamW decays a leaf iff its rank in the reference's tree is at least 2:
    every ``encoder.<i>`` and ``decoder.<i>`` leaf (norm scales and biases
    included, (L, n) there), the table and the head; not ``ln_enc`` or
    ``ln_f``."""
    _, _, params, port = pair()
    ranks = {k: v.dim() for k, v in params_from_reference(jax.tree.map(np.asarray, params)).items()}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = {}
    for path, leaf in flat:
        keys = [getattr(p, "key", None) for p in path]
        if keys[0] in ("encoder", "decoder"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i), *keys[1:]])] = leaf.ndim
        else:
            want[".".join(keys)] = leaf.ndim
    assert set(want) == set(ranks)
    for name, p in port.named_parameters():
        assert (opt.reference_rank(name, p) >= 2) == (want[name] >= 2), name
    decayed = {n for n, p in port.named_parameters() if opt.reference_rank(n, p) >= 2}
    assert {"decoder.0.ln_x.scale", "encoder.1.mlp.b_out", "decoder.1.xattn.bk"} <= decayed
    assert not {"ln_enc.scale", "ln_f.scale"} & decayed


def test_train_step_updates_every_leaf_from_one_batch():
    """One microbatched step of the frozen-by-default model once made
    trainable: every leaf moves (the cross K/V projections through K5b's dk
    and dv), and a batch the microbatches do not divide raises."""
    model = trainable()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = build_train_step(model, cfg, microbatches=2)
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    state, met = step(state, tb(batch_np(30, b=ROWS)))
    assert np.isfinite(float(met["loss"]))
    for k, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[k]), k
    with pytest.raises(ValueError, match="microbatches=2"):
        step(state, tb(batch_np(31, b=3)))
