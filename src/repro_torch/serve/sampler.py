"""Batched token sampler: greedy / temperature / top-k / top-p.

Counterpart of :mod:`repro.serve.sampler`.  Top-k and top-p look only at the
head of the distribution (``torch.topk``, sorted), as the reference does with
``lax.top_k``; random draws come from an explicit ``torch.Generator`` (they
cannot repeat jax's bits).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 1.0
    top_k: int = 0          # 0 = off
    top_p: float = 1.0      # 1.0 = off
    head: int = 64          # partial-sort head size for top-p


def _categorical(logits: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One draw per row from softmax(logits); -inf entries are never drawn."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample(logits: torch.Tensor, generator: torch.Generator | None, cfg: SampleConfig) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 samples."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / cfg.temperature

    if cfg.top_k or cfg.top_p < 1.0:
        k = cfg.top_k if cfg.top_k else cfg.head
        k = min(k, logits.shape[-1])  # tiny vocabs
        head_logits, head_idx = torch.topk(logits, k, dim=-1)  # partial sort
        if cfg.top_p < 1.0:
            probs = torch.softmax(head_logits, dim=-1)
            csum = torch.cumsum(probs, dim=-1)
            # keep the smallest prefix with mass >= top_p (always >= 1 token)
            cut = csum - probs >= cfg.top_p
            head_logits = head_logits.masked_fill(cut, float("-inf"))
        choice = _categorical(head_logits, generator)
        return head_idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)

    return _categorical(logits, generator).to(torch.int32)
