"""The LM stack of the port (counterpart of ``repro.models``): the dense,
MoE, Mamba2 and hybrid (zamba2) decoders, served (prefill on K5, decode on
K6, the MoE dispatch on K3; the SSD in torch ops, as the reference's is plain
``jnp``) and trained (attention backward on K5b)."""

from .lm import LM

__all__ = ["LM", "build"]


def build(cfg, ctx=None, device="cuda"):
    """Model factory: the decoder-only LM on ``device`` (default ``"cuda"``;
    raises without a card unless asked for ``"cpu"``), this rank's shard of
    it with a ``ShardCtx``."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder model is a later slice of the port")
    return LM(cfg, ctx, device=device)
