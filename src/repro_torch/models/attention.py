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
logsumexp.

On a tp mesh (``spec_attn``) ``wq``/``wk``/``wv`` are column-parallel by
heads (H/tp query and KV/tp kv heads a rank) and ``wo`` row-parallel: K5
and K5b run on the rank's own heads, and the partial output is summed over
tp, or reduce-scattered over T under sequence parallelism.  Decode at tp > 1
is the reference's segment pattern: the KV cache is sequence-sharded (each
rank one contiguous chunk of S/tp positions, every kv head), every rank runs
K6 with its logsumexp over its chunk for all heads, and the chunks merge by
their LSE weights (:func:`repro_torch.kernels.decode_attention.merge_partials`).
Context parallelism (the reference's ``use_context_parallel``: kv heads that
tp does not divide) is the next slice of the port and raises here.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, all_reduce_sum, gather_stack, scatter_seq
from ..kernels.decode_attention import decode_attention as decode_attention_kernel
from ..kernels.decode_attention import merge_partials
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention_bwd import flash_attention_bwd
from .layers import apply_rope


def spec_attn(ctx: ShardCtx, use_bias: bool = True) -> dict:
    """The head-sharded layout (the reference's ``spec_attn`` without
    context parallelism)."""
    s = {"wq": ctx.spec_w2(False), "wk": ctx.spec_w2(False), "wv": ctx.spec_w2(False),
         "wo": ctx.spec_w2(True)}
    if use_bias:
        s |= {"bq": (ctx.tp,), "bk": (ctx.tp,), "bv": (ctx.tp,), "bo": (None,)}
    return s


def check_heads(cfg: ModelConfig, tp: int) -> None:
    """Head-sharded attention needs tp to divide the query and kv heads;
    where it does not the reference runs attention context-parallel
    (``use_context_parallel``), the next slice of the port."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_kv_heads} kv heads ({cfg.num_heads} query heads) do not split over "
            f"tp={tp}; the reference shards attention over the sequence there (context parallelism, "
            "use_context_parallel), which is the next slice of the port")


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
    """Projections in the reference's (d_in, d_out) layout; with ``tp`` /
    ``fsdp`` > 1 this rank's shard of each (``spec_attn``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, tp: int = 1, fsdp: int = 1):
        super().__init__()
        check_heads(cfg, tp)
        D = cfg.d_model
        if D % fsdp:
            raise ValueError(f"d_model {D} does not split over fsdp={fsdp}")
        H, KV, hd = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.resolved_head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        self.wq = param(D // fsdp, H * hd)
        self.wk = param(D // fsdp, KV * hd)
        self.wv = param(D // fsdp, KV * hd)
        self.wo = param(H * hd, D // fsdp)
        if cfg.use_bias:
            self.bq = param(H * hd)
            self.bk = param(KV * hd)
            self.bv = param(KV * hd)
            self.bo = param(D)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """q (B, T, H, hd), k and v (B, T, KV, hd) of the heads ``p`` holds."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.use_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, T, -1, hd)
    k = k.reshape(B, T, -1, hd)
    v = v.reshape(B, T, -1, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, kv=None, return_kv: bool = False, ctx: ShardCtx | None = None,
              seq_sharded: bool = False):
    """Full-sequence attention (training, prefill) on K5; under autograd
    through :class:`FlashAttentionFn` (backward on K5b).  ``kv`` overrides
    K/V (already projected, (B,S,KV,hd)); ``return_kv`` also returns the
    projected K/V of the rank's heads for the cache.  At tp > 1 ``x`` is
    whole on every rank and ``p`` holds the rank's heads: the partial output
    is summed over tp, or with ``seq_sharded`` reduce-scattered over T."""
    B, T, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    if kv is not None:
        k, v = kv
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttentionFn.apply(q, k, v, causal)
    else:
        out = flash_attention(q, k, v, causal=causal)
    out = out.reshape(B, T, -1) @ p.wo
    if ctx is not None and ctx.tp_size > 1:
        out = scatter_seq(out, ctx) if seq_sharded else all_reduce_sum(out, ctx.group(ctx.tp))
    if cfg.use_bias:
        out = out + p.bo
    if return_kv:
        return out, (k, v)
    return out


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, pos: torch.Tensor, ctx: ShardCtx | None = None):
    """One decode step on K6.  x: (B, 1, D); caches (B, S, KV, hd); pos (B,)
    int32, the new token's position.

    Writes the new token's k/v at ``pos`` *in place* (the reference returns
    new caches; a position past the cache is dropped, as its one-hot scatter
    drops it), then attends over positions ``<= pos``: K6 with ``lengths =
    pos + 1``.  Returns ``(out (B, 1, D), kcache, vcache)``.  At tp > 1 the
    caches are this rank's chunk of the sequence (:func:`_decode_sharded`).
    """
    if ctx is not None and ctx.tp_size > 1:
        return _decode_sharded(p, cfg, x, kcache, vcache, pos, ctx)
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


def _gather_heads(t: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """(B, n) column shards over tp -> (B, tp * n), rank-major: every head."""
    st = gather_stack(t, ctx.group(ctx.tp))
    return st.permute(1, 0, 2).reshape(t.shape[0], -1)


def _decode_sharded(p: Attention, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                    vcache: torch.Tensor, pos: torch.Tensor, ctx: ShardCtx):
    """One decode step at tp > 1 on a sequence-sharded cache (the
    reference's ``decode_attention`` with ``_decode_body``).  ``kcache`` /
    ``vcache`` (B, S/tp, KV, hd) hold global positions ``[r * S/tp, (r + 1)
    * S/tp)`` of rank ``r``, every kv head.  q, k_new and v_new come from the
    rank's column shards and are all-gathered to every head (small); the rank
    owning ``pos`` writes the new token; every rank runs K6 over its chunk
    with chunk-local lengths ``clip(pos + 1 - start, 0, S/tp)`` and its lse;
    the partials are all-gathered and merged; the rank's heads of the merged
    output go through its ``wo`` rows and the ranks sum."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    chunk = kcache.shape[1]
    r = ctx.axis_index(ctx.tp)
    group = ctx.group(ctx.tp)
    x0 = x[:, 0]
    q, knew, vnew = (x0 @ p.wq, x0 @ p.wk, x0 @ p.wv)
    if cfg.use_bias:
        q, knew, vnew = q + p.bq, knew + p.bk, vnew + p.bv
    q = _gather_heads(q, ctx).reshape(B, H, hd)
    knew = _gather_heads(knew, ctx).reshape(B, KV, hd)
    vnew = _gather_heads(vnew, ctx).reshape(B, KV, hd)
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        knew = apply_rope(knew[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    start = r * chunk
    local = pos - start
    rows = torch.arange(B, device=x.device)
    slot = local.clamp(0, chunk - 1).long()
    owns = ((local >= 0) & (local < chunk))[:, None, None]
    kcache[rows, slot] = torch.where(owns, knew.to(kcache.dtype), kcache[rows, slot])
    vcache[rows, slot] = torch.where(owns, vnew.to(vcache.dtype), vcache[rows, slot])
    lengths = (pos + 1 - start).clamp(0, chunk).to(torch.int32)
    o, lse = decode_attention_kernel(q, kcache, vcache, lengths, return_lse=True)
    out = merge_partials(gather_stack(o, group), gather_stack(lse, group)).to(x.dtype)
    hl = H // ctx.tp_size
    y = all_reduce_sum(out[:, r * hl : (r + 1) * hl].reshape(B, hl * hd) @ p.wo, group)
    if cfg.use_bias:
        y = y + p.bo
    return y.to(x.dtype)[:, None, :], kcache, vcache
