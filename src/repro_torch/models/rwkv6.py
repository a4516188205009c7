"""RWKV6 ("Finch") block: the time mix, with its data-dependent decay and
token shift, and the channel mix.

Counterpart of :mod:`repro.models.rwkv6`, op for op in the reference's
dtypes: the projections and the low-rank mixers in the model's dtype, r, k,
v cast to float32 and the decay ``exp(-exp(w))`` in float32, the WKV
recurrence in float32, its output cast back to the model's dtype before the
per-head group norm (float32 inside, population variance, eps 64e-5), gated
by ``silu(g)`` before ``wo``.  The WKV runs on K7 (:mod:`..kernels.wkv`);
under autograd through :class:`WKVFn`, whose backward is K7b.  The final
state it returns is not differentiable (the training forward discards it,
as the reference's does) and the initial state gets no gradient.

:func:`rwkv_time_mix_chunked` is the reference's chunked parallel form
(``LM.rwkv_chunked``), in torch ops as the reference's is plain ``jnp``: the
log decay floored at ``-20 / Q`` and T a multiple of the chunk.  It runs no
kernel.

On a tp mesh (``ctx``) the block is the reference's ``spec_rwkv``
(:func:`spec_rwkv`): ``wr wk wv wg`` and ``cm_wk``/``cm_wr`` column-parallel,
``wo`` and ``cm_wv`` row-parallel, ``w0``, ``wb`` and the ``mb_*`` cut over D
by tp, ``bonus`` by heads where tp divides them, the ``mu_*`` and
``ln_scale`` whole.  Every projection contracts the whole D, so the five
small ``mb_*`` (mix LoRA x D) are all-gathered over tp and each token-shift
mix is computed whole on every rank; r, k, v, g and the decay are then the
rank's D columns, its heads, and K7/K7b run those heads with their state
(the group norm is per head: no collective).  The channel mix's gate
``sigmoid(xr @ cm_wr)`` is the rank's D columns: the ranks' partial
``k @ cm_wv`` is reduce-scattered to those columns, multiplied, and the
product all-gathered (under sequence parallelism exchanged to the rank's T
chunk by one all_to_all), the bytes of one all-reduce.  Where tp does not
divide the heads, a rank's columns cut through a head: it all-gathers its r,
k, v and w columns, runs every head (its state holds every head), and keeps
its columns after the group norm.

On the card the float32 products must run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False, torch's default): the
module refuses to be built on a card with TF32 on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import (ShardCtx, cols_to_seq, gather_cols, rank_cols, rank_heads, scatter_cols,
                                    tp_sum)
from ..kernels.wkv import wkv, wkv_bwd
from .moe import require_full_f32

MIX = ("w", "k", "v", "r", "g")

#: The group norm's epsilon (the reference's ``ln_x``).
GROUP_NORM_EPS = 64e-5

#: Constant leaves drawn by :func:`repro_torch.models.lm.init_params` (the
#: reference's ``init_rwkv``), by value; ``SMALL_LEAVES`` are N(0, 1) x
#: ``SMALL_SCALE``; the other matrices N(0, 1) x d_in^-1/2.
FILL_LEAVES = {"ln_scale": 1.0, "w0": -6.0, "bonus": 0.0, "mu_x": 0.5, "cm_mu_k": 0.5, "cm_mu_r": 0.5,
               **{f"mu_{c}": 0.5 for c in MIX}, **{f"mb_{c}": 0.0 for c in MIX}}
SMALL_LEAVES = ("wa", "wb", *(f"ma_{c}" for c in MIX))
SMALL_SCALE = 0.01


def dims(cfg: ModelConfig):
    """(head size, heads) of ``cfg``'s RWKV block."""
    hs = cfg.rwkv.head_size
    return hs, cfg.d_model // hs


def spec_rwkv(cfg: ModelConfig | None, ctx: ShardCtx) -> dict:
    """The reference's ``spec_rwkv``, ``bonus`` cut by heads only where tp
    divides them (``h_tp``).  ``cfg`` is read at tp > 1, where ``None``
    raises."""
    tp = ctx.tp_size
    if tp > 1 and cfg is None:
        raise ValueError("the RWKV6 block's layout at tp > 1 needs the model's config")
    h_tp = ctx.tp if tp == 1 or dims(cfg)[1] % tp == 0 else None
    col, row = (ctx.fsdp, ctx.tp), (ctx.tp, ctx.fsdp)
    s = {"mu_x": (None,), "wr": col, "wk": col, "wv": col, "wg": col, "wo": row, "w0": (ctx.tp,),
         "wa": (ctx.fsdp, None), "wb": (None, ctx.tp), "bonus": (h_tp, None), "ln_scale": (None,),
         "cm_mu_k": (None,), "cm_mu_r": (None,), "cm_wk": col, "cm_wv": row, "cm_wr": col}
    for c in MIX:
        s[f"mu_{c}"] = (None,)
        s[f"ma_{c}"] = (ctx.fsdp, None)
        s[f"mb_{c}"] = (None, ctx.tp)
    return s


class RWKV(nn.Module):
    """The block's parameters under the reference's leaf names, in its
    (d_in, d_out) layout: ``mu_*``, ``cm_mu_*``, ``w0``, ``ln_scale`` (D,) and
    ``bonus`` (H, 64) in float32; ``wr wk wv wg wo`` (D x D), ``wa`` (D x
    decay_lora), ``wb``, ``ma_*`` (D x mix_lora), ``mb_*``, ``cm_wk`` (D x F),
    ``cm_wv`` (F x D) and ``cm_wr`` in the model's dtype; on a mesh (``ctx``)
    this rank's shard of each (:func:`spec_rwkv`), D cut over fsdp."""

    def __init__(self, cfg: ModelConfig, dtype, device, ctx: ShardCtx | None = None):
        super().__init__()
        require_full_f32(device)
        tp = ctx.tp_size if ctx is not None else 1
        fsdp = ctx.axis_size(ctx.fsdp) if ctx is not None else 1
        D, Fd = cfg.d_model, cfg.d_ff
        if D % fsdp:
            raise ValueError(f"d_model {D} does not split over fsdp={fsdp}")
        if D % tp or Fd % tp:
            raise ValueError(f"{cfg.name}: d_model {D} or d_ff {Fd} does not split over tp={tp}")
        hs, H = dims(cfg)
        h0, h1, _ = rank_heads(H, ctx)
        Hl = h1 - h0
        Din, Dt, Ft = D // fsdp, D // tp, Fd // tp
        r = cfg.rwkv

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        f32 = torch.float32
        self.mu_x = param(D, dt=f32)
        self.wr, self.wk, self.wv, self.wg = (param(Din, Dt) for _ in range(4))
        self.wo = param(Dt, Din)
        self.w0 = param(Dt, dt=f32)
        self.wa = param(Din, r.decay_lora)
        self.wb = param(r.decay_lora, Dt)
        self.bonus = param(Hl, hs, dt=f32)
        self.ln_scale = param(D, dt=f32)
        self.cm_mu_k = param(D, dt=f32)
        self.cm_mu_r = param(D, dt=f32)
        self.cm_wk = param(Din, Ft)
        self.cm_wv = param(Ft, Din)
        self.cm_wr = param(Din, Dt)
        for c in MIX:
            setattr(self, f"mu_{c}", param(D, dt=f32))
            setattr(self, f"ma_{c}", param(Din, r.mix_lora))
            setattr(self, f"mb_{c}", param(r.mix_lora, Dt))


class WKVFn(torch.autograd.Function):
    """Differentiable K7: the forward keeps r, k, v, w, u and the initial
    state; the backward is K7b.  The final state is marked non-differentiable;
    an initial state that requires a gradient raises (it gets none)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        if s0.requires_grad:
            raise ValueError("the WKV's initial state gets no gradient: pass one that does not require it")
        y, state = wkv(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dr, dk, dv, dw, du = wkv_bwd(r, k, v, w, u, s0, dy.contiguous())
        return dr, dk, dv, dw, du, None


def _wkv(r, k, v, w, u, state, in_place: bool):
    """K7 on the time mix's f32 inputs: through :class:`WKVFn` where autograd
    records, else the wrapper itself (in place over ``state`` if asked)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        if in_place:
            raise ValueError("the WKV cannot write its state in place under autograd")
        return WKVFn.apply(r, k, v, w, u, state)
    return wkv(r, k, v, w, u, state, in_place=in_place)


def _shifted(x: torch.Tensor, x_prev_last: torch.Tensor) -> torch.Tensor:
    """The token shift: row t holds x[t - 1], row 0 the carried ``x_prev_last``."""
    return torch.cat([x_prev_last[:, None], x[:, :-1]], dim=1)


def _ddlerp(p: RWKV, x: torch.Tensor, x_prev: torch.Tensor, ctx: ShardCtx | None = None) -> dict:
    """Data-dependent token shift: one lerp per r/k/v/g/w channel set, each
    whole (the ``mb_*`` gathered over tp)."""
    dx = x_prev - x
    xx = x + dx * p.mu_x.to(x.dtype)
    out = {}
    for c in MIX:
        adj = torch.tanh(xx @ getattr(p, f"ma_{c}")) @ gather_cols(getattr(p, f"mb_{c}"), ctx)
        out[c] = x + dx * (getattr(p, f"mu_{c}").to(x.dtype) + adj)
    return out


def _decay(p: RWKV, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay in (0, 1), float32: exp(-exp(w))."""
    w = p.w0 + (torch.tanh(xw @ p.wa) @ p.wb).float()
    return torch.exp(-torch.exp(w))


def _group_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, H: int) -> torch.Tensor:
    """Per-head layer norm over the head size, in float32 ("ln_x")."""
    B, T, D = x.shape
    xh = x.reshape(B, T, H, D // H).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(B, T, D) * scale).to(x.dtype)


def _project(p: RWKV, cfg: ModelConfig, x: torch.Tensor, x_prev_last: torch.Tensor, ctx: ShardCtx | None):
    """r, k, v (B, T, H, hs) float32 of the heads the rank runs, g in
    ``x``'s dtype (the rank's D columns), the decay w (B, T, H, hs)
    float32."""
    hs, H = dims(cfg)
    h0, h1, cut = rank_heads(H, ctx)
    B, T, _ = x.shape
    m = _ddlerp(p, x, _shifted(x, x_prev_last), ctx)
    r, k, v = (m[c] @ getattr(p, f"w{c}") for c in "rkv")
    w = _decay(p, m["w"])
    if cut:  # K7 reads rows whose last axis is contiguous
        r, k, v, w = (gather_cols(t, ctx).contiguous() for t in (r, k, v, w))
    r, k, v, w = (t.reshape(B, T, h1 - h0, hs).float() for t in (r, k, v, w))
    return r, k, v, m["g"] @ p.wg, w


def _output(p: RWKV, cfg: ModelConfig, y: torch.Tensor, g: torch.Tensor, x: torch.Tensor, ctx: ShardCtx | None,
            seq_sharded: bool) -> torch.Tensor:
    """The WKV's f32 output (B, T, H * hs) cast to ``x``'s dtype,
    group-normed, gated by silu(g), through ``wo``; at tp > 1 (the rank's
    heads, or every head of which it keeps its columns) summed over tp,
    reduce-scattered over T with ``seq_sharded``."""
    hs, H = dims(cfg)
    h0, h1, cut = rank_heads(H, ctx)
    y = _group_norm(y.to(x.dtype), p.ln_scale[h0 * hs:h1 * hs], GROUP_NORM_EPS, h1 - h0)
    if cut:
        y = rank_cols(y, ctx)
    return tp_sum((y * F.silu(g)) @ p.wo, ctx, seq_sharded).to(x.dtype)


def rwkv_time_mix(p: RWKV, cfg: ModelConfig, x: torch.Tensor, x_prev_last: torch.Tensor, state: torch.Tensor,
                  *, in_place: bool = False, ctx: ShardCtx | None = None, seq_sharded: bool = False):
    """x (B, T, D); ``x_prev_last`` (B, D) the carried shift; ``state`` (B, H,
    hs, hs) float32 (on a mesh the rank's heads).  Returns (out, new shift
    ``x[:, -1]``, new state); with ``in_place`` the new state is ``state``,
    overwritten by K7.  ``out`` is whole, or the rank's T chunk with
    ``seq_sharded``."""
    B, T, _ = x.shape
    r, k, v, g, w = _project(p, cfg, x, x_prev_last, ctx)
    y, new_state = _wkv(r, k, v, w, p.bonus, state, in_place)
    return _output(p, cfg, y.reshape(B, T, -1), g, x, ctx, seq_sharded), x[:, -1], new_state


def rwkv_channel_mix(p: RWKV, cfg: ModelConfig, x: torch.Tensor, x_prev_last: torch.Tensor, *,
                     ctx: ShardCtx | None = None, seq_sharded: bool = False):
    """Returns (out, new shift ``x[:, -1]``); at tp > 1 the ranks' partial
    ``k @ cm_wv`` reduce-scattered to the gate's columns, the product
    all-gathered (exchanged to the rank's T chunk with ``seq_sharded``)."""
    dx = _shifted(x, x_prev_last) - x
    xk = x + dx * p.cm_mu_k.to(x.dtype)
    xr = x + dx * p.cm_mu_r.to(x.dtype)
    kv = scatter_cols(torch.square(F.relu(xk @ p.cm_wk)) @ p.cm_wv, ctx)
    out = torch.sigmoid(xr @ p.cm_wr) * kv
    out = cols_to_seq(out, ctx) if seq_sharded else gather_cols(out, ctx)
    return out.to(x.dtype), x[:, -1]


def rwkv_time_mix_chunked(p: RWKV, cfg: ModelConfig, x: torch.Tensor, x_prev_last: torch.Tensor,
                          state: torch.Tensor, chunk: int = 128, *, ctx: ShardCtx | None = None,
                          seq_sharded: bool = False):
    """The reference's parallel form: within a chunk of Q steps the WKV is a
    masked product with cumulative-decay weights, the state carried once a
    chunk.  T must be a multiple of Q = min(chunk, T)."""
    B, T, _ = x.shape
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"T={T} % chunk={Q}")
    nc = T // Q
    r, k, v, g, w = _project(p, cfg, x, x_prev_last, ctx)
    H, hs = r.shape[2:]
    u = p.bonus
    # log decay, floored so that the factorized exp(+-cum) stays in f32 range
    lw = torch.clamp(torch.log(torch.clamp(w, min=1e-38)), min=-20.0 / Q)
    rc, kc, vc, lwc = (t.reshape(B, nc, Q, H, hs) for t in (r, k, v, lw))
    cum = torch.cumsum(lwc, dim=2)
    total = cum[:, :, -1]  # (B, nc, H, hs)
    cshift = F.pad(cum[:, :, :-1], (0, 0, 0, 0, 1, 0))
    a = rc * torch.exp(cshift)
    b = kc * torch.exp(-cum)
    scores = torch.einsum("bnqhs,bnkhs->bnhqk", a, b)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device), diagonal=-1)
    scores = torch.where(mask, scores, torch.zeros((), dtype=scores.dtype, device=x.device))
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", scores, vc)
    y_intra = y_intra + (rc * u * kc).sum(-1, keepdim=True) * vc
    s_chunk = torch.einsum("bnqhs,bnqhp->bnhsp", kc * torch.exp(total[:, :, None] - cum), vc)
    s = state.float()
    y_inter = []
    for n in range(nc):
        y_inter.append(torch.einsum("bqhs,bhsp->bqhp", a[:, n], s))
        s = torch.exp(total[:, n])[..., None] * s + s_chunk[:, n]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(B, T, H * hs)
    return _output(p, cfg, y, g, x, ctx, seq_sharded), x[:, -1], s
