"""K5b's plain twin, K5's logsumexp and the differentiable attention of the
port against the JAX package, on the CPU.

The reference's backward is its custom-VJP chunked flash attention
(``repro.models.attention._sdpa_flash``, backward ``_flash_bwd``), which its
``_sdpa`` takes once T * S >= 2048^2; below that ``_sdpa`` is plain XLA
attention differentiated by ``jax.grad``.  The port's
``flash_attention_bwd_plain`` must give the gradients of both.  The inputs
are numpy draws from a seed, float32; q and k at 1.5 x a unit normal, so the
softmax is peaked.

Tolerance: float32 on both sides, in other summation orders (XLA's dots
against torch's einsums, over chunks of 1024 keys): gradients within
atol 2e-5 + rtol 1e-4 of the reference's, outputs and logsumexp within
atol 1e-5 + rtol 1e-5.  The reference's ``_sdpa_flash`` reshapes S into
chunks of 1024 and cannot take S > 1024 that 1024 does not divide (R5 in
ROADMAP.md), so those parity shapes stay on what it runs; the port takes any
S (the ragged-chunk case is held to autograd of the plain forward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.models import attention as ref_attn
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import (
    CHUNK,
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models.lm import init_params

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, B, T, S, H, KV, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, H, d)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, d)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    do = rng.standard_normal((B, T, H, d)).astype(np.float32)
    return q, k, v, do


def _port_grads(q, k, v, do, causal):
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    return out, lse, flash_attention_bwd(qt, kt, vt, out, torch.from_numpy(do), lse, causal=causal)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,d", [(1, 1024, 4, 2, 32), (2, 2048, 3, 1, 32), (1, 2048, 4, 4, 64)])
def test_plain_bwd_matches_reference_flash_vjp(B, S, H, KV, d, causal):
    """T = S at 1024 and 2048 keys (one and two reference chunks)."""
    q, k, v, do = _inputs(S + H + d, B, S, S, H, KV, d)
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    ref_out, vjp = jax.vjp(lambda a, b, c: ref_attn._sdpa_flash(a, b, c, causal), qj, kj, vj)
    want = vjp(jnp.asarray(do))
    out, lse, got = _port_grads(q, k, v, do, causal)
    _close(out, ref_out, FWD_TOL)
    _, (_, _, _, _, ref_lse) = ref_attn._flash_fwd(qj, kj, vj, causal)
    _close(lse, np.asarray(ref_lse).reshape(B, H, S), FWD_TOL)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("B,T,S,H,KV,d,causal", [
    (2, 37, 37, 6, 2, 32, True), (1, 130, 130, 4, 4, 64, True), (2, 64, 64, 8, 2, 128, True),
    (2, 37, 100, 6, 2, 32, False), (1, 130, 7, 4, 1, 64, False), (3, 1, 300, 3, 3, 32, False),
])
def test_plain_bwd_matches_reference_sdpa_grad(B, T, S, H, KV, d, causal):
    """Short sequences: ``_sdpa``'s plain XLA path differentiated by
    ``jax.grad`` (causal shapes have T = S, where the two packages' masks
    agree)."""
    q, k, v, do = _inputs(T * 7 + S, B, T, S, H, KV, d)

    def f(a, b, c):
        return jnp.sum(ref_attn._sdpa(a, b, c, causal) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    _, _, got = _port_grads(q, k, v, do, causal)
    for g, w in zip(got, want):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_takes_a_ragged_last_chunk(causal):
    """S = CHUNK + 76 (the reference cannot reshape it): the chunked twin
    against autograd of K5's plain forward."""
    S = CHUNK + 76
    q, k, v, do = _inputs(5, 1, S, S, 4, 2, 32)
    qt, kt, vt = (torch.from_numpy(x).double().requires_grad_() for x in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, causal=causal)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do).double())
    _, _, got = _port_grads(q, k, v, do, causal)
    for g, w in zip(got, want):
        _close(g, w.numpy(), GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fn_grads_match_reference(causal):
    """The training attention's autograd Function on the CPU (plain K5 and
    K5b) against ``jax.grad`` of the reference's ``_sdpa``; the upstream
    gradient reaches K5b contiguous although autograd hands over a
    transposed view."""
    B, T, H, KV, d = 2, 48, 6, 3, 32
    q, k, v, do = _inputs(11, B, T, T, H, KV, d)
    seen = []
    orig = attn_mod.flash_attention_bwd

    def spy(*args, **kw):
        seen.append(args[4].is_contiguous())
        return orig(*args, **kw)

    attn_mod.flash_attention_bwd = spy
    try:
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = attn_mod.FlashAttentionFn.apply(qt, kt, vt, causal)
        # the loss reads a transposed view: autograd's gradient is strided
        (out.transpose(1, 2) * torch.from_numpy(do).transpose(1, 2)).sum().backward()
    finally:
        attn_mod.flash_attention_bwd = orig
    assert seen == [True]
    want = jax.grad(lambda a, b, c: jnp.sum(ref_attn._sdpa(a, b, c, causal) * do), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for t, w in zip((qt, kt, vt), want):
        _close(t.grad, w, GRAD_TOL)


def test_k5_lse_plain_is_the_rows_logsumexp():
    """K5's plain version with ``return_lse``: the output is unchanged and
    the logsumexp is that of the scaled, masked scores, causal and not."""
    q, k, v, _ = _inputs(3, 2, 20, 33, 4, 2, 32)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    for causal in (True, False):
        out, lse = flash_attention_plain(qt, kt, vt, causal=causal, return_lse=True)
        assert torch.equal(out, flash_attention_plain(qt, kt, vt, causal=causal))
        s = np.einsum("btkgd,bskd->bkgts", q.reshape(2, 20, 2, 2, 32).astype(np.float64) * 32**-0.5,
                      k.astype(np.float64))
        if causal:
            s = np.where(np.arange(20)[:, None] >= np.arange(33)[None, :], s, -np.inf)
        m = s.max(-1, keepdims=True)
        want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(2, 4, 20)
        _close(lse, want, FWD_TOL)
        assert lse.dtype == torch.float32 and lse.shape == (2, 4, 20)


def test_attention_takes_the_autograd_path_only_under_grad():
    """Serve (frozen weights, no_grad) calls K5 without the logsumexp; a
    trainable projection sends the attention through the Function."""
    cfg = dataclasses.replace(configs.get_smoke_config("mistral-nemo-12b"), dtype="float32")
    p = init_params(attn_mod.Attention(cfg, torch.float32, "cpu"), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 9, cfg.d_model)).astype(np.float32))
    pos = torch.arange(9)[None, :]
    calls = []
    orig = attn_mod.flash_attention

    def spy(*args, **kw):
        calls.append(kw.get("return_lse", False))
        return orig(*args, **kw)

    attn_mod.flash_attention = spy
    try:
        with torch.no_grad():
            want = attn_mod.attention(p, cfg, x, pos)
        assert calls == [False]
        p.requires_grad_(True)
        got = attn_mod.attention(p, cfg, x, pos)
        assert calls == [False, True] and got.requires_grad
        assert torch.equal(got.detach(), want)
    finally:
        attn_mod.flash_attention = orig


def test_bwd_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 1, 8, 8, 2, 1, 32))
    out, lse = flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, do, lse[:, :, :4])
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out[:, :4], do, lse)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, v, out.double(), do, lse)
    assert "flash_attention_bwd" in build.LAUNCHES
    before = build.LAUNCHES["flash_attention_bwd"]
    flash_attention_bwd(q, k, v, out, do, lse)
    assert build.LAUNCHES["flash_attention_bwd"] == before  # the CPU runs the plain version
