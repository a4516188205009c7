"""Decoder-only LM for training and serving: the dense and MoE families.

Counterpart of :mod:`repro.models.lm` for ``kind == "dense"`` and ``"moe"``:
a stack of (attention + MLP) or (attention + MoE) blocks; the training
``forward``/``loss`` with one activation checkpoint per block (the
reference's per-layer ``jax.checkpoint``), prefill and one-token decode
against a KV cache of layout ``(L, B, S, KV, hd)``.  An MoE
model may lead with dense layers (deepseek-moe: ``dense_layers.<i>``, an MLP
of width ``d_ff_dense``, their own ``k_dense``/``v_dense`` cache), which run
before the MoE stack.  Where the reference scans stacked ``(L, ...)``
parameters, the port keeps one module per layer (``layers.<i>``) and loops;
:func:`repro_torch.models.convert.params_from_reference` unstacks the
reference's tree into this module's state.  Prefill attention runs K5,
decode attention K6 (see :mod:`.attention`) and the MoE dispatch K3 (see
:mod:`.moe`).

The parameters are built frozen (``requires_grad=False``), as serving wants
them; ``model.requires_grad_(True)`` is the one switch that makes a model
trainable.  ``prefill`` and ``decode_step`` run under ``no_grad`` either way.
Under autograd the attention runs K5 forward and K5b backward, and each
block's recompute runs K5 and the MoE dispatch (K3) a second time.

The cache is a dict of tensors updated *in place* by ``prefill`` and
``decode_step`` (the reference returns a new one); both also return it.
The other families (SSM, RWKV, hybrid) and precomputed-embedding inputs raise
``NotImplementedError`` naming the slice that ports them.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import moe as moe_mod
from .layers import cross_entropy, dense_init, embed_tokens, lm_logits, rms_norm


def block_kind(cfg: ModelConfig) -> str:
    if cfg.rwkv is not None:
        return "rwkv"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.ssm is not None:
        return "mamba"
    if cfg.moe is not None:
        return "moe"
    return "dense"


_LATER = {
    "rwkv": "the RWKV6 stack is a later slice of the port",
    "mamba": "the Mamba2 stack is a later slice of the port",
    "hybrid": "the hybrid Mamba2 + shared-attention stack is a later slice of the port",
}


class Norm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device), requires_grad=False)


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, dtype=dtype, device=device), requires_grad=False)


class Head(nn.Module):
    def __init__(self, d: int, vocab: int, dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d, vocab, dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """Attention, then an MoE (``moe``) or an MLP of width ``d_ff``."""

    def __init__(self, cfg: ModelConfig, dtype, device, *, moe: bool = False, d_ff: int = 0):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, device)
        self.ln2 = Norm(cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, dtype, device)
        if moe:
            self.moe = moe_mod.MoE(cfg, dtype, device)
        else:
            self.mlp = mlp_mod.MLP(cfg.d_model, d_ff or cfg.d_ff, cfg.mlp_gated, cfg.use_bias, dtype, device)

    def ffn(self, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "moe"):
            return moe_mod.moe_layer(self.moe, cfg, h)[0]
        return mlp_mod.mlp(self.mlp, cfg, h)


class LM(nn.Module):
    """The dense or MoE decoder on ``device`` (default ``"cuda"``; raises without a
    card unless asked for ``"cpu"``).  Parameters are allocated, not drawn:
    call :meth:`init` or load a state."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        kind = block_kind(cfg)
        if kind not in ("dense", "moe"):
            raise NotImplementedError(f"{cfg.name}: {_LATER[kind]}")
        if cfg.input_kind != "tokens":
            raise NotImplementedError(
                f"{cfg.name}: precomputed-embedding inputs (the vlm/audio stub "
                "frontends) are a later slice of the port"
            )
        dev = resolve_device(device)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, dt, dev)
        n_dense = cfg.moe.first_dense_layers if cfg.moe else 0
        if n_dense:
            d_ff = cfg.moe.d_ff_dense or cfg.d_ff
            self.dense_layers = nn.ModuleList(Block(cfg, dt, dev, d_ff=d_ff) for _ in range(n_dense))
        self.layers = nn.ModuleList(
            Block(cfg, dt, dev, moe=kind == "moe") for _ in range(cfg.num_layers - n_dense)
        )
        self.ln_f = Norm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.head = Head(cfg.d_model, cfg.padded_vocab, dt, dev)

    def _stacks(self):
        """(blocks, k cache name, v cache name), in the order they run."""
        if hasattr(self, "dense_layers"):
            yield self.dense_layers, "k_dense", "v_dense"
        yield self.layers, "k", "v"

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Draw every weight from ``generator`` with the reference's
        distributions: embedding N(0,1)*0.02, dense N(0,1)*d_in^-1/2 (``wo``
        (H*hd)^-1/2, ``w_out`` d_ff^-1/2), experts as :func:`.moe.init_moe`,
        norms ones, biases zeros."""
        draw = torch.randn(self.embed.table.shape, generator=generator,
                           device=self.device, dtype=torch.float32)
        self.embed.table.copy_(draw.mul_(0.02))
        del draw
        for blocks, _, _ in self._stacks():
            for blk in blocks:
                blk.ln1.scale.fill_(1.0)
                blk.ln2.scale.fill_(1.0)
                attn_mod.init_attn(blk.attn, self.cfg, generator)
                if hasattr(blk, "moe"):
                    moe_mod.init_moe(blk.moe, generator)
                else:
                    mlp_mod.init_mlp(blk.mlp, generator)
        self.ln_f.scale.fill_(1.0)
        if not self.cfg.tie_embeddings:
            dense_init(self.head.w, generator)
        return self

    # --------------------------------------------------------------- forward
    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor):
        """One block, as the reference's ``_attn_mlp_body``: (x, aux)."""
        c = self.cfg
        x = x + attn_mod.attention(blk.attn, c, rms_norm(x, blk.ln1.scale, c.norm_eps), positions)
        h = rms_norm(x, blk.ln2.scale, c.norm_eps)
        if hasattr(blk, "moe"):
            y, aux, _ = moe_mod.moe_layer(blk.moe, c, h)
            return x + y, aux
        return x + mlp_mod.mlp(blk.mlp, c, h), torch.zeros((), dtype=torch.float32, device=x.device)

    def forward(self, tokens: torch.Tensor):
        """Training/scoring forward over ``tokens`` (B, T): (logits (B, T, V)
        with the padded vocab sliced off, the MoE stack's summed load-balance
        aux).  The leading dense layers run first; each block is one
        activation checkpoint (non-reentrant), recomputed in the backward."""
        c = self.cfg
        x = embed_tokens(self.embed.table, tokens.long())
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blocks, _, _ in self._stacks():
            for blk in blocks:
                x, aux = checkpoint(self._block, blk, x, positions, use_reentrant=False)
                aux_total = aux_total + aux
        x = rms_norm(x, self.ln_f.scale, c.norm_eps)
        return self._logits(x), aux_total

    def loss(self, batch: dict, aux_weight: float = 0.01):
        """``ce + aux_weight * aux`` over ``batch`` ({"tokens", "labels"},
        (B, T) each): (loss, {"ce", "aux"})."""
        logits, aux = self(batch["tokens"])
        ce = cross_entropy(logits, batch["labels"])
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeros: ``pos`` (B,) int32 and ``k``/``v`` (L, B, S, KV, hd) of each
        stack (``k_dense``/``v_dense`` for the leading dense layers)."""
        c = self.cfg
        cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=self.device)}
        for blocks, kn, vn in self._stacks():
            shape = (len(blocks), batch, max_len, c.num_kv_heads, c.resolved_head_dim)
            cache[kn] = torch.zeros(shape, dtype=self.dtype, device=self.device)
            cache[vn] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return cache

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab head; the padded columns are sliced off (one device)."""
        c = self.cfg
        if c.tie_embeddings:
            logits = x @ self.embed.table.T
        else:
            logits = lm_logits(self.head.w, x)
        return logits[..., : c.vocab_size]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict):
        """Process a whole prompt ``tokens`` (B, T) into an empty ``cache``:
        k/v of positions [0, T) are written and ``pos`` advances by T.
        Returns (last-position logits (B, V), cache)."""
        c = self.cfg
        x = embed_tokens(self.embed.table, tokens.long())
        T = x.shape[1]
        positions = torch.arange(T, device=x.device)[None, :]
        for blocks, kn, vn in self._stacks():
            for i, blk in enumerate(blocks):
                h = rms_norm(x, blk.ln1.scale, c.norm_eps)
                y, (k, v) = attn_mod.attention(blk.attn, c, h, positions, return_kv=True)
                cache[kn][i, :, :T] = k
                cache[vn][i, :, :T] = v
                x = x + y
                x = x + blk.ffn(c, rms_norm(x, blk.ln2.scale, c.norm_eps))
        # the norm is per row: normalizing the last position alone is the same
        x = rms_norm(x[:, -1], self.ln_f.scale, c.norm_eps)
        cache["pos"] += T
        return self._logits(x), cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step.  tokens: (B,) ints.  Returns (logits (B, V), cache)."""
        c = self.cfg
        pos = cache["pos"]
        x = embed_tokens(self.embed.table, tokens.long())[:, None, :]
        for blocks, kn, vn in self._stacks():
            for i, blk in enumerate(blocks):
                h = rms_norm(x, blk.ln1.scale, c.norm_eps)
                y, _, _ = attn_mod.decode_attention(blk.attn, c, h, cache[kn][i], cache[vn][i], pos)
                x = x + y
                x = x + blk.ffn(c, rms_norm(x, blk.ln2.scale, c.norm_eps))
        x = rms_norm(x, self.ln_f.scale, c.norm_eps)
        cache["pos"] += 1
        return self._logits(x)[:, 0, :], cache
