"""Encoder-decoder LM (whisper-small backbone) for training and serving.

Counterpart of :mod:`repro.models.encdec`.  The conv/mel frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
``enc_embeds`` (B, S, D).  Both stacks add fixed sinusoidal positions
(:func:`sinusoid`: computed in float32, cast to the model's type, then
added).  The encoder is a stack of non-causal attention + MLP blocks
(``encoder.<i>.{ln1, attn, ln2, mlp}``) and a final norm ``ln_enc``; the
decoder a stack of causal self-attention, cross-attention over K/V projected
from the encoder's output, and MLP blocks (``decoder.<i>.{ln1, attn, ln_x,
xattn, ln2, mlp}``), then ``ln_f`` and the vocab ``head``.  These are the
reference's leaf names with its stacked ``(L, ...)`` parameters cut into one
module a layer, as :class:`~repro_torch.models.lm.LM` cuts ``layers``
(:func:`repro_torch.models.convert.params_from_reference` unstacks both
stacks).  The model computes the reference's function, not the published
Whisper's: ``rms_norm``, sinusoidal positions on both stacks, a GELU MLP
with biases.

Every attention runs K5 (training: through ``FlashAttentionFn``, K5b
backward) and the decode step K6: the encoder's self-attention and the
cross-attention non-causal, the cross-attention with q alone projected
(:func:`.attention.project_cross_kv` gives K/V).  Training checkpoints each
encoder and each decoder block (non-reentrant, the reference's
``jax.checkpoint``); the cross K/V are projected inside the decoder block, so
its recompute projects them again and K5b returns their dk/dv over the
encoder's length.  The parameters are built frozen, as :class:`LM`'s are.

The cache holds ``pos`` (B,) int32, the decoder's self-attention ``k``/``v``
(L, B, max_len, KV, hd) and the cross K/V ``xk``/``xv`` (L, B, S, KV, hd),
written once by :meth:`EncDecLM.prefill`; prefill and the decode step update
it in place (the reference returns a new one).  The decode step reads nothing
back to the host and has no shape that depends on data, so
:func:`repro_torch.kernels.build.capture` captures it.  The model runs on one
device: on a mesh with an axis above 1 it raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx
from . import attention as attn_mod
from . import mlp as mlp_mod
from .layers import cross_entropy, embed_tokens, lm_logits, rms_norm
from .lm import Embed, Head, Norm, init_params, on_mesh


def _positions(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encodings (N, d) of float32 positions ``pos`` (N,): the
    sines then the cosines of ``pos / 10000^(2i/d)``, cut to ``d``."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos[:, None] / (10_000.0 ** (dim / d))[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


def sinusoid(T: int, D: int, dtype, device=None) -> torch.Tensor:
    """The reference's ``sinusoid``: positions 0..T-1, (T, D) in ``dtype``."""
    return _positions(torch.arange(T, dtype=torch.float32, device=device), D).to(dtype)


def _run(fn, *args):
    """``fn(*args)``, as one non-reentrant activation checkpoint when
    gradients are recorded."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class EncDecBlock(nn.Module):
    """An encoder block (attention, MLP) or, with ``cross``, a decoder block
    (self-attention, cross-attention, MLP), each after its norm."""

    def __init__(self, cfg: ModelConfig, dtype, device, cross: bool):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, dtype, device)
        if cross:
            self.ln_x = Norm(cfg.d_model, device)
            self.xattn = attn_mod.Attention(cfg, dtype, device)
        self.ln2 = Norm(cfg.d_model, device)
        self.mlp = mlp_mod.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, cfg.use_bias, dtype, device)


class EncDecLM(nn.Module):
    """The encoder-decoder on ``device`` (default ``"cuda"``; raises without a
    card unless asked for ``"cpu"``).  Parameters are allocated, not drawn:
    call :meth:`init` or load a state.  A ``ctx`` with an axis above 1
    raises; a 1x1 one runs as one device."""

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx | None = None, device="cuda"):
        super().__init__()
        if on_mesh(ctx):
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder model on a mesh (the cross-attention's layout in "
                "leaf_spec, the cross cache's tp layout) is a later slice of the port")
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.ctx = cfg, None
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, dt, dev)
        self.encoder = nn.ModuleList(EncDecBlock(cfg, dt, dev, cross=False) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(EncDecBlock(cfg, dt, dev, cross=True) for _ in range(cfg.num_layers))
        self.ln_enc = Norm(cfg.d_model, dev)
        self.ln_f = Norm(cfg.d_model, dev)
        self.head = Head(cfg.d_model, cfg.padded_vocab, dt, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Draw every weight from ``generator`` (:func:`.lm.init_params`)."""
        return init_params(self, generator)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return lm_logits(self.head.w, x)[..., : self.cfg.vocab_size]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token rows plus the positions 0..T-1."""
        x = embed_tokens(self.embed.table, tokens.long())
        return x + sinusoid(x.shape[1], self.cfg.d_model, x.dtype, x.device)[None]

    # --------------------------------------------------------------- forward
    def _enc_block(self, blk: EncDecBlock, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = x + attn_mod.attention(blk.attn, c, rms_norm(x, blk.ln1.scale, c.norm_eps), positions, causal=False)
        return x + mlp_mod.mlp(blk.mlp, c, rms_norm(x, blk.ln2.scale, c.norm_eps))

    def _dec_block(self, blk: EncDecBlock, x: torch.Tensor, enc: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = x + attn_mod.attention(blk.attn, c, rms_norm(x, blk.ln1.scale, c.norm_eps), positions, causal=True)
        h = rms_norm(x, blk.ln_x.scale, c.norm_eps)
        kv = attn_mod.project_cross_kv(blk.xattn, c, enc)
        x = x + attn_mod.attention(blk.xattn, c, h, positions, causal=False, kv=kv)
        return x + mlp_mod.mlp(blk.mlp, c, rms_norm(x, blk.ln2.scale, c.norm_eps))

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder over ``enc_embeds`` (B, S, D): (B, S, D) after
        ``ln_enc``."""
        S, D = enc_embeds.shape[1:]
        x = enc_embeds.to(self.dtype) + sinusoid(S, D, self.dtype, self.device)[None]
        positions = torch.arange(S, device=x.device)[None, :]
        for blk in self.encoder:
            x = _run(self._enc_block, blk, x, positions)
        return rms_norm(x, self.ln_enc.scale, self.cfg.norm_eps)

    def decode_train(self, enc_out: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The decoder over ``tokens`` (B, T) against the encoder's output:
        logits (B, T, V)."""
        x = self._embed(tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for blk in self.decoder:
            x = _run(self._dec_block, blk, x, enc_out, positions)
        return self._logits(rms_norm(x, self.ln_f.scale, self.cfg.norm_eps))

    def forward(self, batch: dict):
        """Training/scoring forward over ``batch`` ({"enc_embeds", "tokens"}):
        (logits (B, T, V), aux 0)."""
        enc = self.encode(batch["enc_embeds"])
        logits = self.decode_train(enc, batch["tokens"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, batch: dict, aux_weight: float = 0.0):
        """The cross entropy over ``batch["labels"]``: (ce, {"ce", "aux"}),
        aux zero as in the reference."""
        logits, aux = self(batch)
        ce = cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int, enc_len: int) -> dict:
        """Zeros: ``pos`` (B,) int32, ``k``/``v`` (L, B, max_len, KV, hd) and
        ``xk``/``xv`` (L, B, enc_len, KV, hd)."""
        c = self.cfg
        kw = dict(dtype=self.dtype, device=self.device)
        self_shape = (c.num_layers, batch, max_len, c.num_kv_heads, c.resolved_head_dim)
        cross_shape = (c.num_layers, batch, enc_len, c.num_kv_heads, c.resolved_head_dim)
        return {"pos": torch.zeros(batch, dtype=torch.int32, device=self.device),
                "k": torch.zeros(self_shape, **kw), "v": torch.zeros(self_shape, **kw),
                "xk": torch.zeros(cross_shape, **kw), "xv": torch.zeros(cross_shape, **kw)}

    @torch.no_grad()
    def build_cross_cache(self, enc_out: torch.Tensor, out=None):
        """Every decoder layer's cross K/V from the encoder's output (B, S, D),
        one layer at a time (the reference's ``lax.map``): ``(xk, xv)`` (L, B,
        S, KV, hd), or written into ``out``'s two tensors in place."""
        c = self.cfg
        B, S, _ = enc_out.shape
        shape = (c.num_layers, B, S, c.num_kv_heads, c.resolved_head_dim)
        if out is None:
            out = tuple(torch.empty(shape, dtype=self.dtype, device=self.device) for _ in range(2))
        xk, xv = out
        if tuple(xk.shape) != shape or tuple(xv.shape) != shape:
            raise ValueError(f"the cross cache is {tuple(xk.shape)}, the encoder's output needs {shape}")
        for i, blk in enumerate(self.decoder):
            k, v = attn_mod.project_cross_kv(blk.xattn, c, enc_out)
            xk[i].copy_(k)
            xv[i].copy_(v)
        return xk, xv

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """The encoder over ``batch["enc_embeds"]``, its cross K/V into
        ``xk``/``xv``, then the decoder over the prompt ``batch["tokens"]``
        (B, T): k/v of positions [0, T) written, ``pos`` advanced by T.
        Returns (last-position logits (B, V), cache)."""
        c = self.cfg
        enc = self.encode(batch["enc_embeds"])
        self.build_cross_cache(enc, (cache["xk"], cache["xv"]))
        x = self._embed(batch["tokens"])
        T = x.shape[1]
        positions = torch.arange(T, device=x.device)[None, :]
        for i, blk in enumerate(self.decoder):
            y, (k, v) = attn_mod.attention(blk.attn, c, rms_norm(x, blk.ln1.scale, c.norm_eps), positions,
                                           causal=True, return_kv=True)
            cache["k"][i][:, :T] = k
            cache["v"][i][:, :T] = v
            x = x + y
            x = x + attn_mod.attention(blk.xattn, c, rms_norm(x, blk.ln_x.scale, c.norm_eps), positions,
                                       causal=False, kv=(cache["xk"][i], cache["xv"][i]))
            x = x + mlp_mod.mlp(blk.mlp, c, rms_norm(x, blk.ln2.scale, c.norm_eps))
        # the norm is per row: normalizing the last position alone is the same
        x = rms_norm(x[:, -1], self.ln_f.scale, c.norm_eps)
        cache["pos"] += T
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step.  tokens: (B,) ints.  The new token's position
        comes from the device-side ``pos``; the cross-attention sees every
        encoder position.  Returns (logits (B, V), cache)."""
        c = self.cfg
        pos = cache["pos"]
        x = embed_tokens(self.embed.table, tokens.long())[:, None, :]
        x = x + _positions(pos.float(), c.d_model)[:, None, :].to(x.dtype)
        full = torch.full_like(pos, cache["xk"].shape[2] - 1)
        for i, blk in enumerate(self.decoder):
            y, _, _ = attn_mod.decode_attention(blk.attn, c, rms_norm(x, blk.ln1.scale, c.norm_eps),
                                                cache["k"][i], cache["v"][i], pos)
            x = x + y
            y, _, _ = attn_mod.decode_attention(blk.xattn, c, rms_norm(x, blk.ln_x.scale, c.norm_eps),
                                                cache["xk"][i], cache["xv"][i], full, cross=True)
            x = x + y
            x = x + mlp_mod.mlp(blk.mlp, c, rms_norm(x, blk.ln2.scale, c.norm_eps))
        x = rms_norm(x, self.ln_f.scale, c.norm_eps)
        cache["pos"] += 1
        return self._logits(x)[:, 0, :], cache
