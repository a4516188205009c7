"""Synthetic batches per architecture family.

Counterpart of :mod:`repro.data.synthetic`: :func:`batch_shapes` gives the
shapes and types of one training batch, :func:`make_batch` materializes
them from an explicit ``torch.Generator`` (the reference draws from a
``jax.random`` key; the two give other numbers from one seed), and
:func:`input_specs` gives them as meta tensors, the dry run's stand-ins with
no data (the reference's ``jax.ShapeDtypeStruct``).  [vlm]/[audio] archs get
precomputed embeddings (the modality frontend is a stub).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Shapes/dtypes of one training batch."""
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encdec:
        return {
            "enc_embeds": ((batch, seq, cfg.d_model), dt),
            "tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32),
        }
    if cfg.input_kind == "embeds":
        return {
            "embeds": ((batch, seq, cfg.d_model), dt),
            "labels": ((batch, seq), torch.int32),
        }
    return {
        "tokens": ((batch, seq), torch.int32),
        "labels": ((batch, seq), torch.int32),
    }


def input_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """:func:`batch_shapes` as empty tensors on the meta device."""
    return {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in batch_shapes(cfg, batch, seq).items()}


def make_batch(cfg: ModelConfig, batch: int, seq: int, generator: torch.Generator) -> dict:
    """One batch on ``generator``'s device: token ids uniform in the vocab,
    embeddings N(0, 1) * 0.02 cast to the model's type."""
    dev = generator.device
    out = {}
    for name, (shape, dt) in batch_shapes(cfg, batch, seq).items():
        if dt == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=generator, device=dev, dtype=dt)
        else:
            out[name] = (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dt)
    return out
