"""GQA attention of the LM: training and prefill on K5 (backward on K5b),
decode on K6.

Counterpart of :mod:`repro.models.attention` on one device: the full-sequence
attention (``attention``) runs the FlashAttention kernel K5
(:mod:`repro_torch.kernels.flash_attention`) and one decode step
(``decode_attention``) the decode kernel K6
(:mod:`repro_torch.kernels.decode_attention`).  Where gradients are wanted
(training), ``attention`` goes through :class:`FlashAttentionFn`, the
reference's custom-VJP ``_sdpa_flash``: its forward is K5 with the rows'
logsumexp, its backward the kernel K5b
(:mod:`repro_torch.kernels.flash_attention_bwd`); on the CPU both run their
plain versions.  Serve runs under ``no_grad`` and calls K5 without the
logsumexp.  The reference's sharding (context parallelism, the
sequence-sharded decode's psum merge) has no counterpart here: K6 does that
LSE merge inside the kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.decode_attention import decode_attention as decode_attention_kernel
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention_bwd import flash_attention_bwd
from .layers import apply_rope, dense_init


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable K5: the forward keeps q, k, v, the output and the rows'
    logsumexp; the backward is K5b.  Autograd may hand the backward a
    gradient that is expanded (stride 0) or transposed, where K5b reads rows
    whose last axis is contiguous: it is made contiguous here, not in the
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=ctx.causal)
        return dq, dk, dv, None


class Attention(nn.Module):
    """Projections in the reference's (d_in, d_out) layout."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        D = cfg.d_model
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        self.wq = param(D, H * hd)
        self.wk = param(D, KV * hd)
        self.wv = param(D, KV * hd)
        self.wo = param(H * hd, D)
        if cfg.use_bias:
            self.bq = param(H * hd)
            self.bk = param(KV * hd)
            self.bv = param(KV * hd)
            self.bo = param(D)


@torch.no_grad()
def init_attn(p: Attention, cfg: ModelConfig, generator: torch.Generator) -> Attention:
    """The reference's distributions: N(0,1) * d_in^-1/2, ``wo`` * (H*hd)^-1/2."""
    dense_init(p.wq, generator)
    dense_init(p.wk, generator)
    dense_init(p.wv, generator)
    dense_init(p.wo, generator, scale=p.wo.shape[0] ** -0.5)
    if cfg.use_bias:
        for b in (p.bq, p.bk, p.bv, p.bo):
            b.zero_()
    return p


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.use_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, kv=None, return_kv: bool = False):
    """Full-sequence attention (training, prefill) on K5; under autograd
    through :class:`FlashAttentionFn` (backward on K5b).  ``kv`` overrides
    K/V (already projected, (B,S,KV,hd)); ``return_kv`` also returns the
    projected K/V for the cache."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if kv is not None:
        k, v = kv
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttentionFn.apply(q, k, v, causal)
    else:
        out = flash_attention(q, k, v, causal=causal)
    out = out.reshape(B, T, -1) @ p.wo
    if cfg.use_bias:
        out = out + p.bo
    if return_kv:
        return out, (k, v)
    return out


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, pos: torch.Tensor):
    """One decode step on K6.  x: (B, 1, D); caches (B, S, KV, hd); pos (B,)
    int32, the new token's position.

    Writes the new token's k/v at ``pos`` *in place* (the reference returns
    new caches; a position past the cache is dropped, as its one-hot scatter
    drops it), then attends over positions ``<= pos``: K6 with ``lengths =
    pos + 1``.  Returns ``(out (B, 1, D), kcache, vcache)``.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S = kcache.shape[1]
    x0 = x[:, 0]
    q, knew, vnew = x0 @ p.wq, x0 @ p.wk, x0 @ p.wv
    if cfg.use_bias:
        q, knew, vnew = q + p.bq, knew + p.bk, vnew + p.bv
    q = q.reshape(B, H, hd)
    knew = knew.reshape(B, KV, hd)
    vnew = vnew.reshape(B, KV, hd)
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        knew = apply_rope(knew[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    rows = torch.arange(B, device=x.device)
    slot = pos.clamp(max=S - 1).long()
    keep = (pos < S)[:, None, None]
    kcache[rows, slot] = torch.where(keep, knew.to(kcache.dtype), kcache[rows, slot])
    vcache[rows, slot] = torch.where(keep, vnew.to(vcache.dtype), vcache[rows, slot])
    lengths = (pos + 1).clamp(max=S).to(torch.int32)
    out = decode_attention_kernel(q, kcache, vcache, lengths)
    y = out.reshape(B, H * hd).to(x.dtype) @ p.wo
    if cfg.use_bias:
        y = y + p.bo
    return y.to(x.dtype)[:, None, :], kcache, vcache
