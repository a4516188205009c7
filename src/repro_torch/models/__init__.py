"""The LM stack of the port (counterpart of ``repro.models``): the dense,
MoE, Mamba2, hybrid (zamba2) and RWKV6 decoders and the encoder-decoder
(whisper), served (prefill on K5, decode on K6, the MoE dispatch on K3,
RWKV6's WKV recurrence on K7; the SSD in torch ops, as the reference's is
plain ``jnp``) and trained (attention backward on K5b, the WKV's on K7b)."""

from .encdec import EncDecLM
from .lm import LM

__all__ = ["EncDecLM", "LM", "build"]


def build(cfg, ctx=None, device="cuda", **kw):
    """Model factory: the encoder-decoder for ``cfg.is_encdec``, else the
    decoder-only LM, on ``device`` (default ``"cuda"``; raises without a
    card unless asked for ``"cpu"``), this rank's shard of it with a
    ``ShardCtx``; ``kw`` are the LM's options (``rwkv_chunked``), as the reference's
    ``build`` passes them."""
    if cfg.is_encdec:
        return EncDecLM(cfg, ctx, device=device, **kw)
    return LM(cfg, ctx, device=device, **kw)
