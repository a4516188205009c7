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
logsumexp.  Cross-attention (the encoder-decoder, :mod:`.encdec`):
:func:`project_cross_kv` projects the encoder's K/V once, and
``attention(kv=...)`` and ``decode_attention(cross=True)`` project q alone
against them, K5 non-causal over every encoder position and K6 with every
position visible.

On a tp mesh the reference's three layouts (``attn_layout``):

* ``"heads"`` (tp divides the kv heads): ``wq``/``wk``/``wv`` column-parallel
  by whole heads (H/tp query and KV/tp kv heads a rank), ``wo`` row-parallel;
  K5 and K5b run on the rank's own heads and the partial output is summed
  over tp, or reduce-scattered over T under sequence parallelism.
* ``"columns"`` (tp does not divide the kv heads, no SP: serving, training
  with ``sp=False``): the same spec, whose ``H*hd`` and ``KV*hd`` columns are
  cut into tp equal parts that split heads.  The rank's q/k/v columns are
  all-gathered over tp (:func:`gather_seq` on the last axis, whose backward
  is the reduce-scatter), K5 runs on the q heads that hold the rank's
  ``H*hd/tp`` output columns against their kv head (:func:`column_rank`),
  and those columns go through the rank's rows of ``wo``; the ranks sum.
* ``"context"`` (tp does not divide the kv heads, under SP: the reference's
  ``use_context_parallel``): ``wq``/``wk``/``wv``/``wo`` tp-replicated (only
  fsdp cuts them), attention T-sharded.  Each rank projects its own T rows
  (RoPE at their global positions), all-gathers K and V over tp along T
  (backward: the reduce-scatter that sums the ranks' dk/dv), runs K5/K5b
  with ``q_offset = r * T/tp`` and puts its rows through the whole ``wo``
  with no tp collective (:func:`context_rank`).  Serving a
  context-parallel model (prefill, x whole on every rank) runs the whole
  attention on every rank.

Decode at tp > 1 is the reference's segment pattern: the KV cache is
sequence-sharded (each rank one contiguous chunk of S/tp positions, every kv
head), every rank runs K6 with its logsumexp over its chunk for all heads,
and the chunks merge by their LSE weights
(:func:`repro_torch.kernels.decode_attention.merge_partials`).  The
encoder-decoder's cross cache is cut and merged the same way, with nothing
written.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, all_reduce_sum, gather_seq, gather_stack, tp_sum
from ..kernels.decode_attention import decode_attention as decode_attention_kernel
from ..kernels.decode_attention import merge_partials
from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention_bwd import flash_attention_bwd
from .layers import apply_rope


def use_context_parallel(cfg: ModelConfig | None, ctx: ShardCtx) -> bool:
    """The reference's test: kv heads that tp does not divide, under
    sequence parallelism, shard attention over the sequence (tp-replicated
    weights, a K/V all-gather) instead of splitting heads.  ``cfg`` is read
    only under SP at tp > 1, where ``None`` raises."""
    if not (ctx.sp and ctx.tp_size > 1):
        return False
    if cfg is None:
        raise ValueError("the attention's layout under sequence parallelism needs the model's config")
    return cfg.num_kv_heads % ctx.tp_size != 0


def attn_layout(cfg: ModelConfig, ctx: ShardCtx | None) -> str:
    """``"heads"``, ``"columns"`` or ``"context"`` (the module docstring)."""
    tp = ctx.tp_size if ctx is not None else 1
    if tp == 1 or cfg.num_kv_heads % tp == 0:
        return "heads"
    return "context" if use_context_parallel(cfg, ctx) else "columns"


def spec_attn(cfg: ModelConfig | None, ctx: ShardCtx) -> dict:
    """The reference's ``spec_attn``: column-parallel ``wq``/``wk``/``wv`` and
    row-parallel ``wo``, or under context parallelism tp-replicated weights
    cut over fsdp alone; the biases' entries too (a model without biases has
    no such leaf)."""
    if use_context_parallel(cfg, ctx):
        return {"wq": (ctx.fsdp, None), "wk": (ctx.fsdp, None), "wv": (ctx.fsdp, None), "wo": (None, ctx.fsdp),
                "bq": (None,), "bk": (None,), "bv": (None,), "bo": (None,)}
    return {"wq": ctx.spec_w2(False), "wk": ctx.spec_w2(False), "wv": ctx.spec_w2(False), "wo": ctx.spec_w2(True),
            "bq": (ctx.tp,), "bk": (ctx.tp,), "bv": (ctx.tp,), "bo": (None,)}


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable K5: the forward keeps q, k, v, the output and the rows'
    logsumexp; the backward is K5b, both with the query offset.  Autograd
    may hand the backward a gradient that is expanded (stride 0) or
    transposed, where K5b reads rows whose last axis is contiguous: it is
    made contiguous here, not in the kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int = 0):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


class Attention(nn.Module):
    """Projections in the reference's (d_in, d_out) layout; on a mesh
    (``ctx``) this rank's shard of each (:func:`spec_attn`): ``tp`` equal
    column parts of ``H*hd`` and ``KV*hd`` (which raises where tp does not
    divide them), or under context parallelism every column; ``D`` cut over
    fsdp."""

    def __init__(self, cfg: ModelConfig, dtype, device, ctx: ShardCtx | None = None):
        super().__init__()
        ctx = ctx if ctx is not None else ShardCtx()
        tp, fsdp = ctx.tp_size, ctx.axis_size(ctx.fsdp)
        D = cfg.d_model
        if D % fsdp:
            raise ValueError(f"d_model {D} does not split over fsdp={fsdp}")
        nq, nkv = cfg.num_heads * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
        if not use_context_parallel(cfg, ctx):
            if nq % tp or nkv % tp:
                raise ValueError(f"{cfg.name}: the attention columns ({nq} q, {nkv} kv) do not split over tp={tp}")
            nq, nkv = nq // tp, nkv // tp

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        self.wq = param(D // fsdp, nq)
        self.wk = param(D // fsdp, nkv)
        self.wv = param(D // fsdp, nkv)
        self.wo = param(nq, D // fsdp)
        if cfg.use_bias:
            self.bq = param(nq)
            self.bk = param(nkv)
            self.bv = param(nkv)
            self.bo = param(D)


def project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                ctx: ShardCtx | None = None, q_only: bool = False):
    """q (B, T, H, hd), k and v (B, T, KV, hd) of the heads ``p`` holds, at
    ``positions`` (B, T); with a ``ctx`` (the ``"columns"`` layout) the
    rank's columns are gathered over tp first, every head.  ``q_only``
    projects q alone (K/V given: cross-attention) and returns ``(q, None,
    None)``."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    names = ("q",) if q_only else ("q", "k", "v")
    out = []
    for n in names:
        t = x @ getattr(p, f"w{n}")
        if cfg.use_bias:
            t = t + getattr(p, f"b{n}")
        if ctx is not None:
            t = gather_seq(t, ctx, dim=-1)
        t = t.reshape(B, T, -1, hd)
        if cfg.use_rope and n != "v":
            t = apply_rope(t, positions, cfg.rope_theta)
        out.append(t)
    return (out[0], None, None) if q_only else tuple(out)


def project_cross_kv(p: Attention, cfg: ModelConfig, enc: torch.Tensor, ctx: ShardCtx | None = None):
    """Encoder-side K/V (B, S, heads, hd) for cross-attention (the
    reference's ``project_cross_kv``): no positions.  ``enc`` is the
    encoder's whole output on every rank; the heads are those the layout
    attends with (:func:`attention`'s ``kv``): the rank's KV/tp under
    ``"heads"``, every head under ``"columns"`` (the rank's columns gathered
    over tp) and ``"context"`` (the weights whole)."""
    B, S, _ = enc.shape
    gather = attn_layout(cfg, ctx) == "columns"
    out = []
    for n in ("k", "v"):
        t = enc @ getattr(p, f"w{n}")
        if cfg.use_bias:
            t = t + getattr(p, f"b{n}")
        if gather:
            t = gather_seq(t, ctx, dim=-1)
        out.append(t.reshape(B, S, -1, cfg.resolved_head_dim))
    return tuple(out)


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """K5 (under autograd through :class:`FlashAttentionFn`, K5b backward)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def context_project(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, rank: int,
                    q_only: bool = False):
    """Rank ``rank``'s rows of the ``"context"`` layout projected: ``x``
    (B, T_loc, D) holds global rows ``[rank * T_loc, (rank + 1) * T_loc)``,
    at those of the whole sequence's ``positions``; every head."""
    T = x.shape[1]
    return project_qkv(p, cfg, x, positions[..., rank * T:(rank + 1) * T], q_only=q_only)


def context_rank(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wo: torch.Tensor,
                 rank: int, causal: bool = True) -> torch.Tensor:
    """Rank ``rank``'s output of the ``"context"`` layout, before ``bo``:
    its q rows (B, T_loc, H, hd, :func:`context_project`) against the whole
    sequence's K and V (the all-gather over tp), K5 (K5b) at ``q_offset =
    rank * T_loc``, through the whole ``wo``: (B, T_loc, D)."""
    B, T = q.shape[:2]
    return _sdpa(q, k, v, causal, rank * T).reshape(B, T, -1) @ wo


def _column_heads(cfg: ModelConfig, rank: int, tp: int):
    """The q heads ``[h0, h1)`` and kv heads ``[g0, g1)`` that K5 runs for
    rank ``rank``'s output columns ``[c0, c0 + n)`` of the (H*hd) attention
    output, ``n = H*hd/tp``: the heads holding those columns against their
    one kv head where they lie in one group (every full config), else the
    whole groups that cover them.  Returns (h0, h1, g0, g1, the columns'
    start within those heads' output, n)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G, n = H // KV, H * hd // tp
    c0 = rank * n
    h0, h1 = c0 // hd, -(-(c0 + n) // hd)
    g0, g1 = h0 // G, -(-h1 // G)
    if g1 - g0 > 1:
        h0, h1 = g0 * G, g1 * G
    return h0, h1, g0, g1, c0 - h0 * hd, n


def column_rank(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wo: torch.Tensor,
                rank: int, tp: int, causal: bool = True) -> torch.Tensor:
    """Rank ``rank``'s partial output of the ``"columns"`` layout, before the
    tp sum and ``bo``: K5 (K5b) on the heads of :func:`_column_heads` (q
    (B, T, H, hd), k and v every head), the rank's ``H*hd/tp`` columns of it
    through its rows of ``wo``: (B, T, D)."""
    B, T = q.shape[:2]
    h0, h1, g0, g1, c0, n = _column_heads(cfg, rank, tp)
    o = _sdpa(q[:, :, h0:h1], k[:, :, g0:g1], v[:, :, g0:g1], causal)
    return o.reshape(B, T, -1)[..., c0:c0 + n] @ wo


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, kv=None, return_kv: bool = False, ctx: ShardCtx | None = None,
              seq_sharded: bool = False):
    """Full-sequence attention (training, prefill) on K5; under autograd
    through :class:`FlashAttentionFn` (backward on K5b).  ``positions`` are
    the global positions of the whole sequence.  ``kv`` overrides K/V
    (already projected, (B,S,KV,hd), the heads the layout attends with:
    cross-attention), and then only q is projected;
    ``return_kv`` also returns the projected K/V for the cache: the rank's
    heads in the ``"heads"`` layout, every head in the others.

    At tp > 1, by :func:`attn_layout`: ``"heads"`` and ``"columns"`` take
    ``x`` whole on every rank and sum the partial output over tp (with
    ``seq_sharded``, reduce-scatter it over T); ``"context"`` with
    ``seq_sharded`` takes the rank's T rows and returns them, with no tp
    collective but the K/V gather (:func:`context_project`,
    :func:`context_rank`), and without it (serving) runs whole."""
    B, T, _ = x.shape
    tp = ctx.tp_size if ctx is not None else 1
    layout = attn_layout(cfg, ctx)
    q_only = kv is not None
    if layout == "context" and seq_sharded:
        r = ctx.axis_index(ctx.tp)
        q, k, v = context_project(p, cfg, x, positions, r, q_only)
        k, v = (gather_seq(k, ctx), gather_seq(v, ctx)) if kv is None else kv
        out = context_rank(cfg, q, k, v, p.wo, r, causal)
    elif layout == "columns":
        q, k, v = project_qkv(p, cfg, x, positions, ctx, q_only)
        if kv is not None:
            k, v = kv
        out = tp_sum(column_rank(cfg, q, k, v, p.wo, ctx.axis_index(ctx.tp), tp, causal), ctx, seq_sharded)
    else:
        q, k, v = project_qkv(p, cfg, x, positions, q_only=q_only)
        if kv is not None:
            k, v = kv
        out = _sdpa(q, k, v, causal).reshape(B, T, -1) @ p.wo
        if layout == "heads":
            out = tp_sum(out, ctx, seq_sharded)
    if cfg.use_bias:
        out = out + p.bo
    if return_kv:
        return out, (k, v)
    return out


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, pos: torch.Tensor, ctx: ShardCtx | None = None, *,
                     cross: bool = False):
    """One decode step on K6.  x: (B, 1, D); caches (B, S, KV, hd); pos (B,)
    int32, the new token's position.

    Writes the new token's k/v at ``pos`` *in place* (the reference returns
    new caches; a position past the cache is dropped, as its one-hot scatter
    drops it), then attends over positions ``<= pos``: K6 with ``lengths =
    pos + 1``.  Returns ``(out (B, 1, D), kcache, vcache)``.  At tp > 1 the
    caches are this rank's chunk of the sequence (:func:`_decode_sharded`).

    ``cross`` (cross-attention against the encoder's K/V): q alone is
    projected and nothing is written; the caller passes ``pos`` = S - 1, as
    the reference does, so every position is visible (lengths S, a device
    tensor: no host read).  At tp > 1 the cross cache is sequence-sharded as
    the self cache is, and its chunks merge the same way."""
    if ctx is not None and ctx.tp_size > 1:
        return _decode_sharded(p, cfg, x, kcache, vcache, pos, ctx, cross=cross)
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    S = kcache.shape[1]
    x0 = x[:, 0]
    q = x0 @ p.wq
    if cfg.use_bias:
        q = q + p.bq
    q = q.reshape(B, H, hd)
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    if not cross:
        knew, vnew = x0 @ p.wk, x0 @ p.wv
        if cfg.use_bias:
            knew, vnew = knew + p.bk, vnew + p.bv
        knew = knew.reshape(B, KV, hd)
        vnew = vnew.reshape(B, KV, hd)
        if cfg.use_rope:
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
    """(B, n) column shards over tp -> (B, tp * n), rank-major: every column."""
    st = gather_stack(t, ctx.group(ctx.tp))
    return st.permute(1, 0, 2).reshape(t.shape[0], -1)


def _decode_sharded(p: Attention, cfg: ModelConfig, x: torch.Tensor, kcache: torch.Tensor,
                    vcache: torch.Tensor, pos: torch.Tensor, ctx: ShardCtx, cross: bool = False):
    """One decode step at tp > 1 on a sequence-sharded cache (the
    reference's ``decode_attention`` with ``_decode_body``).  ``kcache`` /
    ``vcache`` (B, S/tp, KV, hd) hold global positions ``[r * S/tp, (r + 1)
    * S/tp)`` of rank ``r``, every kv head.  q, k_new and v_new come from the
    rank's column shards and are all-gathered to every column (small), or
    under the ``"context"`` layout from the whole weights; the rank owning
    ``pos`` writes the new token (``cross``: q alone, no write); every rank
    runs K6 over its chunk with chunk-local lengths ``clip(pos + 1 - start,
    0, S/tp)`` (a cross step's ``pos`` = S - 1: the whole chunk) and its
    lse; the partials are all-gathered and merged; the rank's columns of the
    merged output go through its ``wo`` rows and the ranks sum (under
    ``"context"`` every column goes through the whole ``wo``)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    chunk = kcache.shape[1]
    r = ctx.axis_index(ctx.tp)
    group = ctx.group(ctx.tp)
    whole = attn_layout(cfg, ctx) == "context"
    x0 = x[:, 0]
    names = ("q",) if cross else ("q", "k", "v")
    proj = []
    for n in names:
        t = x0 @ getattr(p, f"w{n}")
        if cfg.use_bias:
            t = t + getattr(p, f"b{n}")
        proj.append(t if whole else _gather_heads(t, ctx))
    q = proj[0].reshape(B, H, hd)
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    start = r * chunk
    if not cross:
        knew, vnew = (t.reshape(B, KV, hd) for t in proj[1:])
        if cfg.use_rope:
            knew = apply_rope(knew[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        local = pos - start
        rows = torch.arange(B, device=x.device)
        slot = local.clamp(0, chunk - 1).long()
        owns = ((local >= 0) & (local < chunk))[:, None, None]
        kcache[rows, slot] = torch.where(owns, knew.to(kcache.dtype), kcache[rows, slot])
        vcache[rows, slot] = torch.where(owns, vnew.to(vcache.dtype), vcache[rows, slot])
    lengths = (pos + 1 - start).clamp(0, chunk).to(torch.int32)
    o, lse = decode_attention_kernel(q, kcache, vcache, lengths, return_lse=True)
    out = merge_partials(gather_stack(o, group), gather_stack(lse, group)).to(x.dtype).reshape(B, H * hd)
    if whole:
        y = out @ p.wo
    else:
        n = H * hd // ctx.tp_size
        y = all_reduce_sum(out[:, r * n:(r + 1) * n] @ p.wo, group)
    if cfg.use_bias:
        y = y + p.bo
    return y.to(x.dtype)[:, None, :], kcache, vcache
