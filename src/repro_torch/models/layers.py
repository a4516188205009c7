"""Shared layers of the LM: norms, RoPE, embeddings, and the
layouts (``spec_*``) of their parameters.

Counterpart of :mod:`repro.models.layers` as plain tensor functions; the
parameters they read live in the modules of :mod:`.lm`.  On a tp mesh the embedding table and the
head are vocab-sharded (``spec_embed``, ``spec_lm_head``): the lookup masks
the ids another rank holds and sums over tp, and the cross entropy merges
each shard's statistics (:func:`vocab_stats`, :func:`merge_vocab_stats`)
rather than gathering the logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import ShardCtx, all_reduce_sum, gather_stack, scatter_seq


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


# -- layouts ---------------------------------------------------------------------


def spec_norm() -> dict:
    return {"scale": (None,)}


def spec_embed(ctx: ShardCtx) -> dict:
    return {"table": (ctx.tp, None)}


def spec_lm_head(ctx: ShardCtx) -> dict:
    # vocab-sharded over tp only, as the reference's (no fsdp on D)
    return {"w": (None, ctx.tp)}


# -- embedding and head --------------------------------------------------------


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, ctx: ShardCtx | None = None,
                 seq_sharded: bool = False) -> torch.Tensor:
    """Token lookup.  At tp > 1 ``table`` is this rank's vocab shard (the
    reference's ``embed_tokens``): each rank looks up the ids in its rows,
    zeroes the others and the ranks sum, with :func:`all_reduce_sum`, or,
    with ``seq_sharded`` (``tokens`` (B, T), T sharded over tp after the
    sum: sequence parallelism), with a reduce-scatter over T."""
    if ctx is None or ctx.tp_size == 1:
        return table[tokens]
    vshard = table.shape[0]
    local = tokens - ctx.axis_index(ctx.tp) * vshard
    ok = (local >= 0) & (local < vshard)
    rows = table[local.clamp(0, vshard - 1)] * ok[..., None].to(table.dtype)
    if seq_sharded:
        return scatter_seq(rows, ctx)
    return all_reduce_sum(rows, ctx.group(ctx.tp))


def lm_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w


def vocab_stats(logits: torch.Tensor, labels: torch.Tensor, start: int = 0) -> torch.Tensor:
    """One vocab shard's statistics for the cross entropy, float32 (3, ...):
    per position the max of the shard's logits (no gradient: the logsumexp
    does not depend on it), the sum of ``exp(logit - max)``, and the gold
    logit where the label lies in the shard's columns ``[start, start +
    V_shard)``, else 0."""
    logits = logits.float()
    m = logits.detach().amax(dim=-1)
    s = torch.exp(logits - m[..., None]).sum(dim=-1)
    local = labels.long() - start
    ok = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return torch.stack([m, s, torch.where(ok, gold, torch.zeros_like(gold))])


def merge_vocab_stats(stats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(logsumexp, gold logit) per position from every shard's
    :func:`vocab_stats`, stacked (P, 3, ...): the one function the one-rank
    and the vocab-parallel cross entropy both call."""
    m, s, g = stats[:, 0], stats[:, 1], stats[:, 2]
    top = m.amax(dim=0)
    return top + torch.log((s * torch.exp(m - top)).sum(dim=0)), g.sum(dim=0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0,
                  ctx: ShardCtx | None = None) -> torch.Tensor:
    """Mean over every position of ``logsumexp - gold``, in float32; with
    ``z_loss`` also ``z_loss * mean(logsumexp^2)``.  With a ``ctx`` of tp >
    1, ``logits`` are this rank's vocab shard: the shards' statistics (three
    floats a position) are all-gathered over tp and merged, so the logits
    are never gathered; the result is replicated over tp."""
    if ctx is None or ctx.tp_size == 1:
        stats = vocab_stats(logits, labels)[None]
    else:
        start = ctx.axis_index(ctx.tp) * logits.shape[-1]
        stats = gather_stack(vocab_stats(logits, labels, start), ctx.group(ctx.tp))
    lse, gold = merge_vocab_stats(stats)
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
