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
:func:`repro_torch.kernels.build.capture` captures it.

On a mesh (``EncDecLM(cfg, ctx)``) the model is SPMD as :class:`LM` is
(:class:`~repro_torch.models.lm.MeshModel`): each block's attention,
cross-attention and MLP the rank's shard by the reference's ``spec_attn``
and ``spec_mlp`` (the attention layouts of :func:`.attention.attn_layout`),
the embedding and head vocab-parallel, each block's fsdp-cut weights
gathered inside its checkpoint, every entry point on the rank's rows of the
batch.  Under sequence parallelism each stack's residual stays T-sharded
(each rank adds its own rows of the sinusoid) and is gathered before each
norm, row-parallel outputs reduce-scattered back; the encoder's output is
gathered over T once, before the decoder, since every cross K/V needs the
whole S.  A stack whose length tp does not divide runs without sequence
parallelism (the same function; the reference cuts such a length unevenly).
The cache is sequence-sharded over tp, ``k``/``v`` and ``xk``/``xv`` alike
(the reference's ``cache_specs``): ``(L, B, len / tp, KV, hd)`` a rank, a
length tp does not divide refused (the reference's decode step cannot shard
it).  The cross K/V are projected in the layout's heads and written as the
rank's S chunk of every head; the decode step merges the cross chunks by
their lse as the self-attention's.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, gather_seq
from . import attention as attn_mod
from . import mlp as mlp_mod
from .layers import embed_tokens, rms_norm
from .lm import Embed, Head, MeshModel, Norm, model_device, vocab_shard


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
    (self-attention, cross-attention, MLP), each after its norm; on a mesh
    (``ctx``) this rank's shard of each."""

    def __init__(self, cfg: ModelConfig, dtype, device, cross: bool, ctx: ShardCtx | None = None):
        super().__init__()
        tp = ctx.tp_size if ctx is not None else 1
        fsdp = ctx.axis_size(ctx.fsdp) if ctx is not None else 1
        self.ln1 = Norm(cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, dtype, device, ctx)
        if cross:
            self.ln_x = Norm(cfg.d_model, device)
            self.xattn = attn_mod.Attention(cfg, dtype, device, ctx)
        self.ln2 = Norm(cfg.d_model, device)
        self.mlp = mlp_mod.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_gated, cfg.use_bias, dtype, device, tp=tp, fsdp=fsdp)


class EncDecLM(MeshModel):
    """The encoder-decoder on ``device`` (default ``"cuda"``; raises without a
    card unless asked for ``"cpu"``; ``"meta"``: :func:`.lm.model_device`),
    on one device or, with ``ctx``, this rank's shard of it.  Parameters are allocated, not drawn: call
    :meth:`init` or load a state."""

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx | None = None, device="cuda"):
        super().__init__()
        dev = model_device(device)
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.ctx = cfg, ctx
        vocab = vocab_shard(cfg, ctx)
        self.embed = Embed(vocab, cfg.d_model, dt, dev)
        self.encoder = nn.ModuleList(EncDecBlock(cfg, dt, dev, False, ctx) for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(EncDecBlock(cfg, dt, dev, True, ctx) for _ in range(cfg.num_layers))
        self.ln_enc = Norm(cfg.d_model, dev)
        self.ln_f = Norm(cfg.d_model, dev)
        self.head = Head(cfg.d_model, vocab, dt, dev)

    def _with_positions(self, x: torch.Tensor, T: int, seq_sharded: bool) -> torch.Tensor:
        """``x`` (B, T or this rank's T / tp rows, D) plus the sinusoid rows
        of its global positions."""
        pe = sinusoid(T, self.cfg.d_model, x.dtype, x.device)[None]
        return x + (self._rank_rows(pe) if seq_sharded else pe)

    # --------------------------------------------------------------- forward
    def _enc_block(self, blk: EncDecBlock, x: torch.Tensor, positions: torch.Tensor, sp: bool) -> torch.Tensor:
        """One encoder block (the reference's ``encode`` body); with ``sp``
        ``x`` is this rank's T chunk, gathered before each norm (a
        context-parallel attention takes the chunk itself)."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(blk)
        xg = gather_seq(x, ctx) if sp and not attn_mod.use_context_parallel(c, ctx) else x
        x = x + attn_mod.attention(p.attn, c, rms_norm(xg, p.ln1.scale, c.norm_eps), positions, causal=False,
                                   ctx=ctx, seq_sharded=sp)
        xg = gather_seq(x, ctx) if sp else x
        return x + mlp_mod.mlp(p.mlp, c, rms_norm(xg, p.ln2.scale, c.norm_eps), ctx, seq_sharded=sp)

    def _dec_block(self, blk: EncDecBlock, x: torch.Tensor, enc: torch.Tensor, positions: torch.Tensor,
                   sp: bool) -> torch.Tensor:
        """One decoder block (the reference's ``decode_train`` body): the
        cross K/V projected from the encoder's whole output ``enc`` in the
        layout's heads, inside the checkpoint."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(blk)
        cp = sp and attn_mod.use_context_parallel(c, ctx)
        xg = gather_seq(x, ctx) if sp and not cp else x
        x = x + attn_mod.attention(p.attn, c, rms_norm(xg, p.ln1.scale, c.norm_eps), positions, causal=True,
                                   ctx=ctx, seq_sharded=sp)
        xg = gather_seq(x, ctx) if sp and not cp else x
        kv = attn_mod.project_cross_kv(p.xattn, c, enc, ctx)
        x = x + attn_mod.attention(p.xattn, c, rms_norm(xg, p.ln_x.scale, c.norm_eps), positions, causal=False,
                                   kv=kv, ctx=ctx, seq_sharded=sp)
        xg = gather_seq(x, ctx) if sp else x
        return x + mlp_mod.mlp(p.mlp, c, rms_norm(xg, p.ln2.scale, c.norm_eps), ctx, seq_sharded=sp)

    def encode(self, enc_embeds: torch.Tensor, seq_sharded: bool = False) -> torch.Tensor:
        """The encoder over ``enc_embeds`` (B, S, D, this rank's rows): (B, S,
        D) after ``ln_enc``, or with ``seq_sharded`` this rank's S / tp rows
        of it."""
        S = enc_embeds.shape[1]
        x = enc_embeds.to(self.dtype)
        x = self._with_positions(self._rank_rows(x) if seq_sharded else x, S, seq_sharded)
        positions = torch.arange(S, device=x.device)[None, :]
        for blk in self.encoder:
            x = _run(self._enc_block, blk, x, positions, seq_sharded)
        return rms_norm(x, self.ln_enc.scale, self.cfg.norm_eps)

    def decode_train(self, enc_out: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """The decoder over ``tokens`` (B, T) against the encoder's whole
        output: logits (B, T, V), at tp > 1 this rank's vocab shard with the
        padded columns at -1e30 (:meth:`_logits`)."""
        T = tokens.shape[1]
        sp = self._seq_sharded(T)
        x = self._with_positions(embed_tokens(self.embed.table, tokens.long(), self.ctx, seq_sharded=sp), T, sp)
        positions = torch.arange(T, device=x.device)[None, :]
        for blk in self.decoder:
            x = _run(self._dec_block, blk, x, enc_out, positions, sp)
        if sp:
            x = gather_seq(x, self.ctx)
        return self._logits(rms_norm(x, self.ln_f.scale, self.cfg.norm_eps))

    def forward(self, batch: dict):
        """Training/scoring forward over ``batch`` ({"enc_embeds", "tokens"},
        this rank's rows): (logits (B, T, V), aux 0).  Under sequence
        parallelism the encoder's T-sharded output is all-gathered once for
        the decoder (its backward: the reduce-scatter)."""
        sp = self._seq_sharded(batch["enc_embeds"].shape[1])
        enc = self.encode(batch["enc_embeds"], seq_sharded=sp)
        logits = self.decode_train(gather_seq(enc, self.ctx) if sp else enc, batch["tokens"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, batch: dict, aux_weight: float = 0.0):
        """The cross entropy over ``batch["labels"]`` (vocab-parallel at tp >
        1; on a mesh the global batch's mean): (ce, {"ce", "aux",
        "seq_parallel_encoder", "seq_parallel_decoder"}), aux zero as in the
        reference; the last two (host bools) say which stacks ran
        sequence-parallel (:meth:`_seq_sharded`)."""
        logits, aux = self(batch)
        ce = self._mean_ce(logits, batch["labels"])
        sp = {f"seq_parallel_{stack}": torch.tensor(self._seq_sharded(batch[key].shape[1]))
              for stack, key in (("encoder", "enc_embeds"), ("decoder", "tokens"))}
        return ce, {"ce": ce, "aux": aux, **sp}

    # ---------------------------------------------------------------- decode
    def _cache_rows(self, n: int, what: str) -> int:
        if n % self._tp:
            raise ValueError(f"{what}={n} does not split over tp={self._tp}: the cache is sequence-sharded, and "
                             "the reference's decode step cannot shard such a length either")
        return n // self._tp

    def init_cache(self, batch: int, max_len: int, enc_len: int) -> dict:
        """Zeros: ``pos`` (B,) int32, ``k``/``v`` (L, B, max_len, KV, hd) and
        ``xk``/``xv`` (L, B, enc_len, KV, hd); at tp > 1 this rank's chunk of
        each sequence (``len / tp`` positions, every head)."""
        c = self.cfg
        kw = dict(dtype=self.dtype, device=self.device)
        tail = (c.num_kv_heads, c.resolved_head_dim)
        self_shape = (c.num_layers, batch, self._cache_rows(max_len, "max_len"), *tail)
        cross_shape = (c.num_layers, batch, self._cache_rows(enc_len, "enc_len"), *tail)
        return {"pos": torch.zeros(batch, dtype=torch.int32, device=self.device),
                "k": torch.zeros(self_shape, **kw), "v": torch.zeros(self_shape, **kw),
                "xk": torch.zeros(cross_shape, **kw), "xv": torch.zeros(cross_shape, **kw)}

    def _cross_kv(self, p, enc_out: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor):
        """One layer's cross K/V from the encoder's whole output, in the
        layout's heads, written into its cache slices ``xk``/``xv`` (at tp >
        1 the rank's S chunk of every head: :meth:`_write_prefill`)."""
        k, v = attn_mod.project_cross_kv(p.xattn, self.cfg, enc_out, self.ctx)
        self._write_prefill(xk, k)
        self._write_prefill(xv, v)
        return k, v

    def _check_cross(self, xk: torch.Tensor, xv: torch.Tensor, B: int, S: int) -> None:
        c = self.cfg
        shape = (c.num_layers, B, self._cache_rows(S, "enc_len"), c.num_kv_heads, c.resolved_head_dim)
        if tuple(xk.shape) != shape or tuple(xv.shape) != shape:
            raise ValueError(f"the cross cache is {tuple(xk.shape)}, the encoder's output needs {shape}")

    @torch.no_grad()
    def build_cross_cache(self, enc_out: torch.Tensor, out=None):
        """Every decoder layer's cross K/V from the encoder's output (B, S, D),
        one layer at a time (the reference's ``lax.map``): ``(xk, xv)`` (L, B,
        S, KV, hd), at tp > 1 this rank's S / tp positions, or written into
        ``out``'s two tensors in place."""
        c = self.cfg
        B, S, _ = enc_out.shape
        if out is None:
            shape = (c.num_layers, B, self._cache_rows(S, "enc_len"), c.num_kv_heads, c.resolved_head_dim)
            out = tuple(torch.empty(shape, dtype=self.dtype, device=self.device) for _ in range(2))
        xk, xv = out
        self._check_cross(xk, xv, B, S)
        for i, blk in enumerate(self.decoder):
            self._cross_kv(self._gathered(blk), enc_out, xk[i], xv[i])
        return xk, xv

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict):
        """The encoder over ``batch["enc_embeds"]``, its cross K/V into
        ``xk``/``xv``, then the decoder over the prompt ``batch["tokens"]``
        (B, T): k/v of positions [0, T) written, ``pos`` advanced by T.  Each
        layer's cross-attention attends with the K/V it has just projected.
        Returns (last-position logits (B, V), cache): at tp > 1 every vocab
        shard's, the padded width with the pads at -1e30, as :class:`LM`'s."""
        c, ctx = self.cfg, self.ctx
        enc = self.encode(batch["enc_embeds"])
        B, S, _ = enc.shape
        self._check_cross(cache["xk"], cache["xv"], B, S)
        tokens = batch["tokens"]
        T = tokens.shape[1]
        x = self._with_positions(embed_tokens(self.embed.table, tokens.long(), ctx), T, False)
        positions = torch.arange(T, device=x.device)[None, :]
        for i, blk in enumerate(self.decoder):
            p = self._gathered(blk)
            y, (k, v) = attn_mod.attention(p.attn, c, rms_norm(x, p.ln1.scale, c.norm_eps), positions,
                                           causal=True, return_kv=True, ctx=ctx)
            self._write_prefill(cache["k"][i], k)
            self._write_prefill(cache["v"][i], v)
            x = x + y
            kv = self._cross_kv(p, enc, cache["xk"][i], cache["xv"][i])
            x = x + attn_mod.attention(p.xattn, c, rms_norm(x, p.ln_x.scale, c.norm_eps), positions,
                                       causal=False, kv=kv, ctx=ctx)
            x = x + mlp_mod.mlp(p.mlp, c, rms_norm(x, p.ln2.scale, c.norm_eps), ctx)
        # the norm is per row: normalizing the last position alone is the same
        x = rms_norm(x[:, -1], self.ln_f.scale, c.norm_eps)
        cache["pos"] += T
        return self._whole_logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step.  tokens: (B,) ints.  The new token's position
        comes from the device-side ``pos``; the cross-attention sees every
        encoder position.  Returns (logits (B, V), cache)."""
        c, ctx = self.cfg, self.ctx
        pos = cache["pos"]
        x = embed_tokens(self.embed.table, tokens.long(), ctx)[:, None, :]
        x = x + _positions(pos.float(), c.d_model)[:, None, :].to(x.dtype)
        full = torch.full_like(pos, cache["xk"].shape[2] * self._tp - 1)
        for i, blk in enumerate(self.decoder):
            p = self._gathered(blk)
            y, _, _ = attn_mod.decode_attention(p.attn, c, rms_norm(x, p.ln1.scale, c.norm_eps),
                                                cache["k"][i], cache["v"][i], pos, ctx)
            x = x + y
            y, _, _ = attn_mod.decode_attention(p.xattn, c, rms_norm(x, p.ln_x.scale, c.norm_eps),
                                                cache["xk"][i], cache["xv"][i], full, ctx, cross=True)
            x = x + y
            x = x + mlp_mod.mlp(p.mlp, c, rms_norm(x, p.ln2.scale, c.norm_eps), ctx)
        x = rms_norm(x, self.ln_f.scale, c.norm_eps)
        cache["pos"] += 1
        return self._whole_logits(x)[:, 0, :], cache
