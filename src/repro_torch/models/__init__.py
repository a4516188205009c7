"""The LM stack of the port (counterpart of ``repro.models``): the dense,
MoE, Mamba2, hybrid (zamba2) and RWKV6 decoders, served (prefill on K5,
decode on K6, the MoE dispatch on K3, RWKV6's WKV recurrence on K7; the SSD
in torch ops, as the reference's is plain ``jnp``) and trained (attention
backward on K5b, the WKV's on K7b)."""

from .lm import LM

__all__ = ["LM", "build"]


def build(cfg, ctx=None, device="cuda", **kw):
    """Model factory: the decoder-only LM on ``device`` (default ``"cuda"``;
    raises without a card unless asked for ``"cpu"``), this rank's shard of
    it with a ``ShardCtx``; ``kw`` are the LM's options (``rwkv_chunked``),
    as the reference's ``build`` passes them."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder model is a later slice of the port")
    return LM(cfg, ctx, device=device, **kw)
