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

On the card the float32 products must run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False, torch's default): the
module refuses to be built on a card with TF32 on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .layers import rms_norm
from .moe import require_full_f32


def dims(cfg: ModelConfig):
    """(ssm config, d_inner, heads) of ``cfg``'s Mamba2 block."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


def conv_channels(cfg: ModelConfig) -> int:
    s, d_inner, _ = dims(cfg)
    return d_inner + 2 * s.num_groups * s.state_dim


class Mamba(nn.Module):
    """The block's parameters under the reference's leaf names, in its
    (d_in, d_out) layout: ``wz wx wb wc wdt`` (D x ...), ``dt_bias a_log
    d_skip`` (H,) and ``norm_scale`` (d_inner,) in float32, ``conv_k`` (W, C)
    and ``wo`` (d_inner, D) in the model's dtype."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        require_full_f32(device)
        s, d_inner, nheads = dims(cfg)
        D, GN = cfg.d_model, s.num_groups * s.state_dim

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        self.wz = param(D, d_inner)
        self.wx = param(D, d_inner)
        self.wb = param(D, GN)
        self.wc = param(D, GN)
        self.wdt = param(D, nheads)
        self.dt_bias = param(nheads, dt=torch.float32)
        self.a_log = param(nheads, dt=torch.float32)
        self.d_skip = param(nheads, dt=torch.float32)
        self.conv_k = param(s.conv_width, conv_channels(cfg))
        self.norm_scale = param(d_inner, dt=torch.float32)
        self.wo = param(d_inner, D)


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


def _gate_out(p: Mamba, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The gated norm on the f32 ``y`` (scale cast to ``u``'s dtype), the
    gate ``silu(z)``, cast to ``u``'s dtype, then ``wo``."""
    y = rms_norm(y, p.norm_scale.to(u.dtype), cfg.norm_eps)
    y = (y * F.silu(z.float()).to(y.dtype)).to(u.dtype)
    return (y @ p.wo).to(u.dtype)


def mamba_block(p: Mamba, cfg: ModelConfig, u: torch.Tensor, conv_state: torch.Tensor | None = None,
                ssm_state: torch.Tensor | None = None):
    """Full-sequence SSD.  u: (B, T, D) -> (y (B, T, D), the conv state
    (B, W-1, C) in ``u``'s dtype, the ssm state (B, H, N, P) f32).  Given
    states are consumed (a prefill continuation); None starts from zeros."""
    s, d_inner, nheads = dims(cfg)
    G, N, Pd = s.num_groups, s.state_dim, s.head_dim
    B_, T, _ = u.shape
    hpg = nheads // G

    z, x, b, c, dt = project(p, u)
    xbc, new_conv = causal_conv(torch.cat([x, b, c], dim=-1), p.conv_k, conv_state)
    x, b, c = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)

    a = -torch.exp(p.a_log)  # (H,) negative decay rates
    xh = x.reshape(B_, T, nheads, Pd).float()
    bh = b.reshape(B_, T, G, N).float()
    ch = c.reshape(B_, T, G, N).float()
    da = dt * a[None, None, :]  # (B, T, H) log-decay per step

    Q = chunk_len(cfg, T)
    nc = T // Q
    xc = xh.reshape(B_, nc, Q, nheads, Pd)
    dtc = dt.reshape(B_, nc, Q, nheads)
    cum = torch.cumsum(da.reshape(B_, nc, Q, nheads), dim=2)  # (B,nc,Q,H) within-chunk decay
    total = cum[:, :, -1, :]  # (B,nc,H)

    # intra-chunk: ((C B^T) * L) (x dt), L[t,s] = exp(cum[t]-cum[s]) for s<=t
    bh_heads = _heads(bh.reshape(B_, nc, Q, G, N), hpg, 3)  # (B,nc,Q,H,N)
    ch_heads = _heads(ch.reshape(B_, nc, Q, G, N), hpg, 3)
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
    return _gate_out(p, cfg, y.reshape(B_, T, d_inner), z, u), new_conv, h


def mamba_decode(p: Mamba, cfg: ModelConfig, u: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token decode.  u: (B, 1, D); conv_state (B, W-1, C); ssm_state
    (B, H, N, P).  Returns (y (B, 1, D), new conv state, new ssm state f32):
    new tensors, never views of the given states, so a caller may copy them
    back into the states' storage."""
    s, d_inner, nheads = dims(cfg)
    G, N, Pd = s.num_groups, s.state_dim, s.head_dim
    B_ = u.shape[0]
    hpg = nheads // G

    z, x, b, c, dt = project(p, u)
    xbc = torch.cat([x, b, c], dim=-1)  # (B,1,C)
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (B,W,C)
    out = torch.einsum("bwc,wc->bc", window, p.conv_k)
    new_conv = window[:, 1:, :]
    x, b, c = torch.split(F.silu(out), [d_inner, G * N, G * N], dim=-1)

    a = -torch.exp(p.a_log)
    xh = x.reshape(B_, nheads, Pd).float()
    bh = _heads(b.reshape(B_, G, N), hpg, 1).float()
    ch = _heads(c.reshape(B_, G, N), hpg, 1).float()
    dt1 = dt[:, 0]  # (B, H)
    decay = torch.exp(dt1 * a[None, :])  # (B, H)
    h = decay[:, :, None, None] * ssm_state.float() + torch.einsum("bhs,bhp->bhsp", bh * dt1[..., None], xh)
    y = torch.einsum("bhs,bhsp->bhp", ch, h)
    y = y + p.d_skip[None, :, None] * xh
    return _gate_out(p, cfg, y.reshape(B_, 1, d_inner), z, u), new_conv, h
