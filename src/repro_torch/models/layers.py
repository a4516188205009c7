"""Shared layers of the LM: norms, RoPE, embeddings, initializers.

Counterpart of :mod:`repro.models.layers` as plain tensor functions; the
parameters they read live in the modules of :mod:`.lm`.  Random draws take
an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(w: torch.Tensor, generator: torch.Generator, scale: float | None = None) -> torch.Tensor:
    """Fill ``w`` (d_in, d_out) in place with N(0, 1) * ``scale`` (default
    d_in^-1/2), drawn in f32 and cast to ``w``'s type, as the reference does."""
    scale = w.shape[0] ** -0.5 if scale is None else scale
    draw = torch.randn(w.shape, generator=generator, device=w.device, dtype=torch.float32)
    with torch.no_grad():
        w.copy_(draw.mul_(scale))
    return w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in f32, cast back to ``x``'s type *before* the multiply by the
    scale (itself cast to ``x``'s type), as the reference orders it."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


# -- rotary ------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions broadcastable to (..., T).  Split halves
    (not interleaved pairs), computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- embedding and head --------------------------------------------------------


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """Mean over every position of ``logsumexp - gold``, in float32; with
    ``z_loss`` also ``z_loss * mean(logsumexp^2)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * (lse**2).mean()
    return loss


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron squared-ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")
