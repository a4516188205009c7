"""Mamba2 (SSD) block: the chunked state-space duality form on tensors.

Counterpart of :mod:`repro.models.mamba2`.  Training and prefill run the
chunked SSD: the intra-chunk terms are batched products (``einsum``), and
only the inter-chunk state propagation is a loop, over the T / Q chunks (the
reference's ``lax.scan``).  Decode is the O(1) recurrence on the carried
state.  The reference is plain ``jnp`` with no Pallas kernel, so torch ops
stand in for it here, op for op, in the same dtypes: the projections in the
model's dtype, the SSD in float32, the gated norm on a float32 ``y`` with the
scale cast to the model's dtype, the result cast back before ``wo``.

One departure: the intra-chunk decay ``exp(cum[t] - cum[s])`` is masked
to the causal triangle before the exponential, where the reference masks
after it.  The values are the same; the reference's gradient is NaN once a
chunk's decay passes e^88 above the diagonal (float32's overflow), as
zamba2-1.2b's chunk of 256 does at its initial weights (some 0.7 nats a
token: R8 in ROADMAP.md).

The chunk length is the reference's: the configured ``chunk``, shrunk to the
largest divisor of T (``Q = min(Q, T); while T % Q: Q -= 1``), so a prompt of
prime length runs with Q = 1 and the inter-chunk loop takes T steps
(:func:`chunk_len`).  Head ``h`` reads B/C group ``h // (H / G)`` (the
reference's ``jnp.repeat`` along the group axis).

On a tp mesh (``ctx``) the block is the reference's ``spec_mamba``
(:func:`spec_mamba`, :func:`rank_groups`,
:func:`~repro_torch.distributed.sharding.rank_heads`): ``wz``/``wx`` column-parallel over
``d_inner``, ``wb``/``wc`` by groups where tp divides them (else whole on
every rank), ``wdt`` and the per-head vectors by heads where tp divides
them, ``conv_k`` whole, ``norm_scale`` and ``wo``'s rows over ``d_inner``.
A rank convolves its own channels (the matching columns of ``conv_k``; its
conv state holds those channels alone), runs the SSD on its heads (reading
their groups of a whole B/C), normalises its ``d_inner`` columns by the sum
of squares over tp (:func:`~repro_torch.distributed.sharding.all_reduce_sum`,
whose backward sums the ranks' cotangents) and puts them through its rows of
``wo``; the ranks' partial outputs are summed, or reduce-scattered over T
under sequence parallelism.  Where tp does not divide the heads, a rank's
``d_inner`` columns cut through a head: it all-gathers the convolved x over
tp (backward: the reduce-scatter), runs every head with the whole ``wdt``,
keeps its own columns of the result, and its SSM state holds every head.

On the card the float32 products must run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False, torch's default): the
module refuses to be built on a card with TF32 on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, all_reduce_sum, gather_cols, rank_cols, rank_heads, tp_sum
from .layers import rms_norm
from .moe import require_full_f32


def dims(cfg: ModelConfig):
    """(ssm config, d_inner, heads) of ``cfg``'s Mamba2 block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


def spec_mamba(cfg: ModelConfig | None, ctx: ShardCtx) -> dict:
    """The reference's ``spec_mamba``: ``bc_tp`` only where tp divides the
    groups, ``h_tp`` only where it divides the heads.  ``cfg`` is read at tp
    > 1, where ``None`` raises."""
    tp = ctx.tp_size
    if tp > 1 and cfg is None:
        raise ValueError("the Mamba2 block's layout at tp > 1 needs the model's config")
    bc_tp = h_tp = ctx.tp
    if tp > 1:
        s, _, nheads = dims(cfg)
        bc_tp = ctx.tp if s.num_groups % tp == 0 else None
        h_tp = ctx.tp if nheads % tp == 0 else None
    return {"wz": (ctx.fsdp, ctx.tp), "wx": (ctx.fsdp, ctx.tp), "wb": (ctx.fsdp, bc_tp), "wc": (ctx.fsdp, bc_tp),
            "wdt": (ctx.fsdp, h_tp), "dt_bias": (h_tp,), "a_log": (h_tp,), "d_skip": (h_tp,),
            "conv_k": (None, None), "norm_scale": (ctx.tp,), "wo": (ctx.tp, ctx.fsdp)}


def rank_groups(cfg: ModelConfig, ctx: ShardCtx | None) -> tuple[int, int]:
    """(first group, groups) of B and C this rank holds: its G / tp where tp
    divides the groups (``bc_tp``), else every group."""
    G = cfg.ssm.num_groups
    tp = ctx.tp_size if ctx is not None else 1
    if tp == 1 or G % tp:
        return 0, G
    return ctx.axis_index(ctx.tp) * (G // tp), G // tp


def conv_channels(cfg: ModelConfig, ctx: ShardCtx | None = None) -> int:
    """The conv's channels on this rank: its x columns and B/C channels."""
    _, d_inner, _ = dims(cfg)
    tp = ctx.tp_size if ctx is not None else 1
    return d_inner // tp + 2 * rank_groups(cfg, ctx)[1] * cfg.ssm.state_dim


class Mamba(nn.Module):
    """The block's parameters under the reference's leaf names, in its
    (d_in, d_out) layout: ``wz wx wb wc wdt`` (D x ...), ``dt_bias a_log
    d_skip`` (H,) and ``norm_scale`` (d_inner,) in float32, ``conv_k`` (W, C)
    and ``wo`` (d_inner, D) in the model's dtype; on a mesh (``ctx``) this
    rank's shard of each (:func:`spec_mamba`), D cut over fsdp."""

    def __init__(self, cfg: ModelConfig, dtype, device, ctx: ShardCtx | None = None):
        super().__init__()
        require_full_f32(device)
        s, d_inner, nheads = dims(cfg)
        D = cfg.d_model
        tp = ctx.tp_size if ctx is not None else 1
        fsdp = ctx.axis_size(ctx.fsdp) if ctx is not None else 1
        if D % fsdp:
            raise ValueError(f"d_model {D} does not split over fsdp={fsdp}")
        if d_inner % tp:
            raise ValueError(f"{cfg.name}: d_inner {d_inner} does not split over tp={tp}")
        h0, h1, _ = rank_heads(nheads, ctx)
        Dl, Hl, di, gn = D // fsdp, h1 - h0, d_inner // tp, rank_groups(cfg, ctx)[1] * s.state_dim

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        self.wz = param(Dl, di)
        self.wx = param(Dl, di)
        self.wb = param(Dl, gn)
        self.wc = param(Dl, gn)
        self.wdt = param(Dl, Hl)
        self.dt_bias = param(Hl, dt=torch.float32)
        self.a_log = param(Hl, dt=torch.float32)
        self.d_skip = param(Hl, dt=torch.float32)
        self.conv_k = param(s.conv_width, conv_channels(cfg))
        self.norm_scale = param(di, dt=torch.float32)
        self.wo = param(di, Dl)


#: Leaves drawn as zeros and as ones by :func:`repro_torch.models.lm.init_params`
#: (the reference's ``init_mamba``); the others are normal draws.
ZERO_LEAVES = ("dt_bias", "a_log")
ONE_LEAVES = ("d_skip", "norm_scale")


def chunk_len(cfg: ModelConfig, T: int) -> int:
    """The SSD chunk length for T tokens: the configured chunk shrunk to the
    largest divisor of T (1 for a prime T above the chunk)."""
    Q = min(cfg.ssm.chunk, T)
    while T % Q:
        Q -= 1
    return Q


def causal_conv(x: torch.Tensor, kernel: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv by shifted adds.  x: (B, T, C); kernel (W, C);
    state: (B, W-1, C) carried context, zeros when None.  Returns
    (silu(conv), the last W-1 rows of the padded input: the next state)."""
    W = kernel.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[0], W - 1, x.shape[2], dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, w : w + T, :] * kernel[w][None, None, :] for w in range(W))
    new_state = xp[:, -(W - 1) :, :] if W > 1 else pad
    return F.silu(out), new_state


def project(p: Mamba, u: torch.Tensor):
    """z, x, b, c in ``u``'s dtype; dt = softplus(u wdt + dt_bias) in f32."""
    dt = F.softplus((u @ p.wdt).float() + p.dt_bias)
    return u @ p.wz, u @ p.wx, u @ p.wb, u @ p.wc, dt


def _heads(t: torch.Tensor, hpg: int, dim: int) -> torch.Tensor:
    """Repeat each group ``hpg`` times along ``dim`` (head h reads group
    h // hpg), as ``jnp.repeat``; a view and a copy, no host read."""
    shape = list(t.shape)
    out = t.unsqueeze(dim + 1).expand(*shape[: dim + 1], hpg, *shape[dim + 1 :])
    return out.reshape(*shape[:dim], shape[dim] * hpg, *shape[dim + 1 :])


def _rank_heads(t: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx | None) -> torch.Tensor:
    """The rank's heads ``[h0, h1)`` of ``t`` (..., groups, N), the groups
    the rank holds (:func:`rank_groups`): each head its group's row."""
    s, _, nheads = dims(cfg)
    hpg = nheads // s.num_groups
    h0, h1, _ = rank_heads(nheads, ctx)
    g0, g1 = h0 // hpg, -(-h1 // hpg)
    dim = t.dim() - 2
    sub = t.narrow(dim, g0 - rank_groups(cfg, ctx)[0], g1 - g0)
    return _heads(sub, hpg, dim).narrow(dim, h0 - g0 * hpg, h1 - h0)


def _conv_k(p: Mamba, cfg: ModelConfig, ctx: ShardCtx | None) -> torch.Tensor:
    """The columns of the whole ``conv_k`` that match the rank's channels:
    its x columns, then its B and its C channels."""
    if ctx is None or ctx.tp_size == 1:
        return p.conv_k
    s, d_inner, _ = dims(cfg)
    N, GN = s.state_dim, s.num_groups * s.state_dim
    g0, g = rank_groups(cfg, ctx)
    k, b0 = p.conv_k, d_inner + g0 * N
    return torch.cat([rank_cols(k[:, :d_inner], ctx), k[:, b0:b0 + g * N], k[:, b0 + GN:b0 + GN + g * N]], dim=1)


def _conv_split(xbc: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx | None):
    """The conv's output split into x (the heads the rank runs: gathered
    over tp where tp cuts a head), b and c."""
    gn = rank_groups(cfg, ctx)[1] * cfg.ssm.state_dim
    x, b, c = torch.split(xbc, [xbc.shape[-1] - 2 * gn, gn, gn], dim=-1)
    if rank_heads(dims(cfg)[2], ctx)[2]:
        x = gather_cols(x, ctx)
    return x, b, c


def _gate_out(p: Mamba, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
              ctx: ShardCtx | None, seq_sharded: bool) -> torch.Tensor:
    """The gated norm on the f32 ``y`` (scale cast to ``u``'s dtype), the
    gate ``silu(z)``, cast to ``u``'s dtype, then ``wo``.  At tp > 1 ``y``
    holds the rank's heads (every head where tp cuts one, of which the rank
    keeps its columns), the norm's sum of squares is summed over tp, and the
    partial output is summed over tp (reduce-scattered over T with
    ``seq_sharded``)."""
    scale = p.norm_scale.to(u.dtype)
    if ctx is None or ctx.tp_size == 1:
        y = rms_norm(y, scale, cfg.norm_eps)
    else:
        if rank_heads(dims(cfg)[2], ctx)[2]:
            y = rank_cols(y, ctx)
        ss = all_reduce_sum((y * y).sum(dim=-1, keepdim=True), ctx.group(ctx.tp))
        y = (y * torch.rsqrt(ss / dims(cfg)[1] + cfg.norm_eps)).to(y.dtype) * scale.to(y.dtype)
    y = (y * F.silu(z.float()).to(y.dtype)).to(u.dtype)
    return tp_sum((y @ p.wo).to(u.dtype), ctx, seq_sharded)


def mamba_block(p: Mamba, cfg: ModelConfig, u: torch.Tensor, conv_state: torch.Tensor | None = None,
                ssm_state: torch.Tensor | None = None, *, ctx: ShardCtx | None = None, seq_sharded: bool = False):
    """Full-sequence SSD.  u: (B, T, D) -> (y (B, T, D), the conv state
    (B, W-1, C) in ``u``'s dtype, the ssm state (B, H, N, P) f32).  Given
    states are consumed (a prefill continuation); None starts from zeros.
    On a mesh the states are the rank's (its channels, its heads) and ``y``
    the whole output (the rank's T chunk with ``seq_sharded``)."""
    s = cfg.ssm
    N, Pd = s.state_dim, s.head_dim
    h0, h1, _ = rank_heads(dims(cfg)[2], ctx)
    nheads = h1 - h0
    B_, T, _ = u.shape

    z, x, b, c, dt = project(p, u)
    xbc, new_conv = causal_conv(torch.cat([x, b, c], dim=-1), _conv_k(p, cfg, ctx), conv_state)
    x, b, c = _conv_split(xbc, cfg, ctx)

    a = -torch.exp(p.a_log)  # (H,) negative decay rates
    xh = x.reshape(B_, T, nheads, Pd).float()
    bh = _rank_heads(b.reshape(B_, T, -1, N).float(), cfg, ctx)  # (B, T, H, N)
    ch = _rank_heads(c.reshape(B_, T, -1, N).float(), cfg, ctx)
    da = dt * a[None, None, :]  # (B, T, H) log-decay per step

    Q = chunk_len(cfg, T)
    nc = T // Q
    xc = xh.reshape(B_, nc, Q, nheads, Pd)
    dtc = dt.reshape(B_, nc, Q, nheads)
    cum = torch.cumsum(da.reshape(B_, nc, Q, nheads), dim=2)  # (B,nc,Q,H) within-chunk decay
    total = cum[:, :, -1, :]  # (B,nc,H)

    # intra-chunk: ((C B^T) * L) (x dt), L[t,s] = exp(cum[t]-cum[s]) for s<=t
    bh_heads = bh.reshape(B_, nc, Q, nheads, N)
    ch_heads = ch.reshape(B_, nc, Q, nheads, N)
    scores = torch.einsum("bnqhs,bnkhs->bnhqk", ch_heads, bh_heads)
    cum_t = cum.permute(0, 1, 3, 2)  # (B,nc,H,Q)
    ldec = cum_t[..., :, None] - cum_t[..., None, :]  # (B,nc,H,Q(t),Q(s))
    mask = torch.ones(Q, Q, dtype=torch.bool, device=u.device).tril()
    # masked before the exponential: the same values as the reference's
    # where(mask, exp(ldec), 0), but no exp(+large) = inf above the diagonal,
    # whose gradient through the where is 0 * inf = NaN (R8)
    L = torch.exp(torch.where(mask, ldec, torch.full((), -torch.inf, device=u.device)))
    xdt = xc * dtc[..., None]  # (B,nc,Q,H,P)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", scores * L, xdt)

    # chunk boundary states: S_n = sum_s exp(total - cum[s]) dt_s B_s x_s
    w_end = torch.exp(total[:, :, None, :] - cum)  # (B,nc,Q,H)
    s_chunk = torch.einsum("bnqhs,bnqhp->bnhsp", bh_heads * (w_end * dtc)[..., None], xc)

    # inter-chunk scan: h carries across chunks
    h = ssm_state.float() if ssm_state is not None else torch.zeros(
        B_, nheads, N, Pd, dtype=torch.float32, device=u.device)
    c_dec = ch_heads * torch.exp(cum)[..., None]  # (B,nc,Q,H,N)
    decay = torch.exp(total)[:, :, :, None, None]  # (B,nc,H,1,1)
    y_inter = []
    for n in range(nc):
        y_inter.append(torch.einsum("bqhs,bhsp->bqhp", c_dec[:, n], h))
        h = decay[:, n] * h + s_chunk[:, n]
    y = y_intra.reshape(B_, T, nheads, Pd) + torch.stack(y_inter, dim=1).reshape(B_, T, nheads, Pd)
    y = y + p.d_skip[None, None, :, None] * xh
    return _gate_out(p, cfg, y.reshape(B_, T, nheads * Pd), z, u, ctx, seq_sharded), new_conv, h


def mamba_decode(p: Mamba, cfg: ModelConfig, u: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 *, ctx: ShardCtx | None = None):
    """One-token decode.  u: (B, 1, D); conv_state (B, W-1, C); ssm_state
    (B, H, N, P), the rank's on a mesh.  Returns (y (B, 1, D), new conv
    state, new ssm state f32): new tensors, never views of the given states,
    so a caller may copy them back into the states' storage."""
    s = cfg.ssm
    N, Pd = s.state_dim, s.head_dim
    h0, h1, _ = rank_heads(dims(cfg)[2], ctx)
    nheads = h1 - h0
    B_ = u.shape[0]

    z, x, b, c, dt = project(p, u)
    xbc = torch.cat([x, b, c], dim=-1)  # (B,1,C)
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window, _conv_k(p, cfg, ctx))
    new_conv = window[:, 1:, :]
    x, b, c = _conv_split(F.silu(out), cfg, ctx)

    a = -torch.exp(p.a_log)
    xh = x.reshape(B_, nheads, Pd).float()
    bh = _rank_heads(b.reshape(B_, -1, N), cfg, ctx).float()
    ch = _rank_heads(c.reshape(B_, -1, N), cfg, ctx).float()
    dt1 = dt[:, 0]  # (B, H)
    decay = torch.exp(dt1 * a[None, :])  # (B, H)
    h = decay[:, :, None, None] * ssm_state.float() + torch.einsum("bhs,bhp->bhsp", bh * dt1[..., None], xh)
    y = torch.einsum("bhs,bhsp->bhp", ch, h)
    y = y + p.d_skip[None, :, None] * xh
    return _gate_out(p, cfg, y.reshape(B_, 1, nheads * Pd), z, u, ctx, False), new_conv, h
