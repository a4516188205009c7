"""Decoder-only LM for training and serving: the dense, MoE, Mamba2,
hybrid and RWKV6 families.

Counterpart of :mod:`repro.models.lm` for ``kind == "dense"``, ``"moe"``,
``"mamba"``, ``"hybrid"`` and ``"rwkv"``.  Dense and MoE:
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

The Mamba2 kinds (``family="ssm"`` with an ``ssm`` config: ``"mamba"``;
``family="hybrid"``: zamba2) stack ``layers.<i>.{ln1, mamba}`` blocks
(:mod:`.mamba2`); the hybrid adds one ``shared`` attention + MLP block (a
:class:`Block`), run after every full segment of ``shared_attn_every``
layers and after a short last segment only when ``L % every == 0``, its
parameters reused by every invocation (their gradient is the sum over the
invocations).  Training checkpoints each Mamba block and each shared
invocation.  Their cache holds ``conv`` (L, B, W-1, C) in the model's dtype,
``ssm`` (L, B, H, N, P) float32 and, for the hybrid, one k/v cache a shared
invocation, ``shared_k``/``shared_v`` (L // every, B, max_len, KV, hd).
Prefill starts every Mamba block from zero states, as the reference's does,
whatever the cache holds.

The RWKV6 kind (``rwkv``) stacks ``layers.<i>.{ln1, ln2, rwkv}`` blocks
(:mod:`.rwkv6`): a time mix and a channel mix, each after its norm.
Training checkpoints each block and starts every time mix from a zero
shift and state (``rwkv_chunked=True`` runs the reference's chunked form
there instead of K7).  Its cache holds ``tm_shift`` and ``cm_shift`` (L, B,
D) in the model's dtype and ``wkv`` (L, B, H, 64, 64) float32.  Prefill
starts every block from zero states, whatever the cache holds, and K7 writes
each layer's final state straight into its slice of ``wkv``; the decode step
runs K7 at T = 1 on that slice in place.

A model of any kind with ``input_kind == "embeds"`` (llava-next: the
vision tiling is a stub) takes precomputed (B, T, D) embeddings in
``forward``, ``loss`` (``batch["embeds"]``) and ``prefill``, cast to the
model's type (:meth:`LM.embed_inputs`; on a mesh every rank's rows of the
batch, under sequence parallelism cut to the rank's T rows); its decode step
embeds tokens.

On a mesh (``LM(cfg, ctx)``, a :class:`~repro_torch.distributed.sharding.ShardCtx`
of a ``(data, model)`` or ``(pod, data, model)`` DeviceMesh) the model is
SPMD, one rank a device, and allocates only the rank's shard of every leaf
(:func:`leaf_spec`, the reference's ``spec_*``): heads, FFN hidden, experts
and vocabulary over tp; with an ``fsdp`` axis the non-contracting D of each
block matrix, all-gathered inside the layer loop one block at a time under
the block's checkpoint (the recompute gathers again, as the reference's
``jax.checkpoint`` does).  Every entry point takes this rank's rows of the
batch (its dp shard).  With ``ctx.sp`` the training forward keeps the
residual T-sharded over tp (Megatron-SP: :func:`gather_seq` before each
norm, :func:`scatter_seq` after each row-parallel output) and an MoE
dispatches over all_to_all (``moe_layer_a2a``); training an MoE at tp > 1
without it raises, as the reference does.  A T that tp does not divide runs
without sequence parallelism (the same function as the reference's uneven
cut), but for an MoE, whose a2a dispatch needs the even cut.  Where tp does not divide the kv
heads, the attention's layout (:func:`.attention.attn_layout`) cuts its
columns through heads, or under ``ctx.sp`` runs context-parallel: the
attention weights tp-replicated, the block's input kept T-sharded through
the first norm and the attention (each rank its own query rows against the
gathered K/V), gathered only before the second norm.  Prefill and decode run the layout
without sequence parallelism, as a serving context has it.  The cache is
sequence-sharded over tp (``(L, B, max_len / tp, KV, hd)`` a rank, the
reference's ``cache_specs``).  ``ctx=None`` is the one-device model.

The recurrent kinds run on a mesh too, by the reference's ``spec_mamba``
and ``spec_rwkv`` (:func:`.mamba2.spec_mamba`, :func:`.rwkv6.spec_rwkv`):
each block's heads and inner columns over tp, its projections' D over fsdp;
under sequence parallelism the residual stays T-sharded between blocks and
is gathered before each mixer (the recurrence needs the whole T), whose
row-parallel output is reduce-scattered back.  The hybrid's shared block
runs the attention layouts above.  Their caches are cut as the reference's
``cache_specs``: ``ssm`` and ``wkv`` by heads over tp (whole where tp does
not divide the heads), ``tm_shift``/``cm_shift`` whole, ``shared_k``/
``shared_v`` sequence-sharded; ``conv`` holds the rank's channels (the
reference keeps it whole on every rank).
"""

from __future__ import annotations

import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ModelConfig
from ..distributed.sharding import (ShardCtx, fsdp_gather, gather_seq, gather_stack, psum, rank_heads,
                                    shard_leaf)
from . import attention as attn_mod
from . import mamba2
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import rwkv6
from .layers import cross_entropy, embed_tokens, lm_logits, rms_norm, spec_embed, spec_lm_head, spec_norm


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


#: The kinds whose layers are Mamba2 blocks (:mod:`.mamba2`).
SSM_KINDS = ("mamba", "hybrid")
#: The recurrent kinds (no attention stack).
RECURRENT_KINDS = (*SSM_KINDS, "rwkv")


#: The reference's scanned stacks (per-layer leaves with a leading layer
#: axis), cut into one module a layer here: ``layers.<i>``, and the
#: encoder-decoder's ``encoder.<i>`` and ``decoder.<i>``.
STACKS = ("layers", "encoder", "decoder")


def on_mesh(ctx: ShardCtx | None) -> bool:
    """Whether ``ctx`` cuts anything: an axis above 1, or sequence
    parallelism."""
    return ctx is not None and (ctx.sp or any(ctx.axis_size(a) > 1 for a in (ctx.tp, ctx.fsdp, *ctx.dp)))


def leaf_spec(name: str, ndim: int, ctx: ShardCtx, cfg: ModelConfig | None) -> tuple:
    """The layout of the parameter ``name`` (a state-dict name of
    :class:`LM`, or of one of its modules) with ``ndim`` dimensions: the
    reference's ``spec_*`` entry for it, in ``ctx``'s axis names (keyed on
    the leaf's parent: ``wb`` and ``wo`` are Mamba's, RWKV6's and the
    attention's own; the encoder-decoder's cross-attention ``xattn`` is cut
    as ``attn``).  A leaf none of them names (a norm's scale, a test's
    own tree) is replicated.  An attention leaf's layout reads ``cfg`` under
    sequence parallelism at tp > 1 (:func:`.attention.spec_attn`), a Mamba2
    or RWKV6 leaf's at any tp > 1; there ``None`` raises."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if parent == "embed":
        table = spec_embed(ctx)
    elif parent == "head":
        table = spec_lm_head(ctx)
    elif parent in ("attn", "xattn"):
        table = attn_mod.spec_attn(cfg, ctx)
    elif parent == "mamba":
        table = mamba2.spec_mamba(cfg, ctx)
    elif parent == "rwkv":
        table = rwkv6.spec_rwkv(cfg, ctx)
    elif leaf in ("w_in", "w_gate", "w_out") and ndim == 3 or leaf == "router":
        table = moe_mod.spec_moe(ctx)
    elif leaf in ("w_in", "w_gate", "w_out", "b_in", "b_out"):
        table = mlp_mod.spec_mlp(ctx)
    else:
        table = spec_norm()
    spec = table.get(leaf, (None,) * ndim)
    return spec if len(spec) == ndim else (None,) * ndim


def _whole_shape(shape, spec: tuple, ctx: ShardCtx) -> tuple:
    return tuple(n * ctx.axis_size(a) for n, a in zip(shape, spec))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator, ctx: ShardCtx | None = None) -> nn.Module:
    """Draw every weight of ``module`` (an :class:`LM`, or one of its
    attention, MLP or MoE modules) from ``generator`` with the reference's
    distributions, leaf by leaf in the module's order: embedding
    N(0,1)*0.02, a matrix N(0,1)*d_in^-1/2 (``wo`` (H*hd)^-1/2, ``w_out``
    d_ff^-1/2; an expert slab's d_in is its middle axis; a Mamba block's
    ``conv_k`` W^-1/2), norms ones, biases zeros; a Mamba block's
    ``dt_bias``/``a_log`` zeros, ``d_skip``/``norm_scale`` ones; an RWKV
    block's constants (``rwkv6.FILL_LEAVES``: ``ln_scale`` ones, the ``mu_*``
    0.5, ``w0`` -6, ``bonus`` and ``mb_*`` zeros) and its low-rank ``wa``,
    ``wb``, ``ma_*`` N(0,1)*0.01.  Each leaf is drawn whole, in f32, and cut
    to the rank's shard (:func:`leaf_spec`), so every mesh holds the same
    model as one device."""
    ctx = ctx if ctx is not None else ShardCtx()
    coords = ctx.coords()
    cfg = getattr(module, "cfg", None)
    for prefix, owner in module.named_modules():
        rwkv = isinstance(owner, rwkv6.RWKV)
        for leaf, p in owner.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            if rwkv and leaf in rwkv6.FILL_LEAVES:
                p.fill_(rwkv6.FILL_LEAVES[leaf])
            elif leaf == "scale" or leaf in mamba2.ONE_LEAVES:
                p.fill_(1.0)
            elif leaf.startswith("b") or leaf in mamba2.ZERO_LEAVES:
                p.zero_()
            else:
                spec = leaf_spec(name, p.dim(), ctx, cfg)
                whole = _whole_shape(p.shape, spec, ctx)
                if leaf == "table":
                    scale = 0.02
                elif rwkv and leaf in rwkv6.SMALL_LEAVES:
                    scale = rwkv6.SMALL_SCALE
                else:
                    scale = whole[p.dim() - 2] ** -0.5
                draw = torch.randn(whole, generator=generator, device=p.device, dtype=torch.float32)
                p.copy_(shard_leaf(draw.mul_(scale), spec, coords))
                del draw
    return module


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
    """Attention, then an MoE (``moe``) or an MLP of width ``d_ff``; on a
    mesh (``ctx``) this rank's shard of each."""

    def __init__(self, cfg: ModelConfig, dtype, device, *, moe: bool = False, d_ff: int = 0,
                 ctx: ShardCtx | None = None):
        super().__init__()
        tp = ctx.tp_size if ctx is not None else 1
        fsdp = ctx.axis_size(ctx.fsdp) if ctx is not None else 1
        self.ln1 = Norm(cfg.d_model, device)
        self.ln2 = Norm(cfg.d_model, device)
        self.attn = attn_mod.Attention(cfg, dtype, device, ctx)
        if moe:
            self.moe = moe_mod.MoE(cfg, dtype, device, tp_size=tp, fsdp=fsdp)
        else:
            self.mlp = mlp_mod.MLP(cfg.d_model, d_ff or cfg.d_ff, cfg.mlp_gated, cfg.use_bias, dtype, device,
                                   tp=tp, fsdp=fsdp)


class RWKVLayer(nn.Module):
    """One layer of the RWKV6 stack: a norm and the time mix, a norm and the
    channel mix (one :class:`.rwkv6.RWKV` holds both mixes' leaves); on a
    mesh this rank's shard."""

    def __init__(self, cfg: ModelConfig, dtype, device, ctx: ShardCtx | None = None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, device)
        self.ln2 = Norm(cfg.d_model, device)
        self.rwkv = rwkv6.RWKV(cfg, dtype, device, ctx)


class MambaLayer(nn.Module):
    """One layer of the Mamba2 stacks: a norm, then the SSD block; on a
    mesh this rank's shard."""

    def __init__(self, cfg: ModelConfig, dtype, device, ctx: ShardCtx | None = None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, device)
        self.mamba = mamba2.Mamba(cfg, dtype, device, ctx)


def ffn(p, cfg: ModelConfig, h: torch.Tensor, ctx: ShardCtx | None = None) -> torch.Tensor:
    """A block's MoE (the psum dispatch) or MLP on ``h``, whole over tp."""
    if hasattr(p, "moe"):
        return moe_mod.moe_layer(p.moe, cfg, h, ctx)[0]
    return mlp_mod.mlp(p.mlp, cfg, h, ctx)


def model_device(device) -> torch.device:
    """A model's device: :func:`repro_torch.resolve_device`'s, or the meta
    device, a skeleton that allocates nothing and whose parameters a state
    dict then assigns (``load_state_dict(state, assign=True)``: another
    model's tensors, shared, not copied)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def vocab_shard(cfg: ModelConfig, ctx: ShardCtx | None) -> int:
    """The rows of the padded vocabulary a rank holds: ``padded_vocab / tp``
    (the reference's even ``spec_embed`` / ``spec_lm_head``)."""
    tp = ctx.tp_size if ctx is not None else 1
    if cfg.padded_vocab % tp:
        raise ValueError(f"the padded vocabulary {cfg.padded_vocab} does not split over tp={tp}")
    return cfg.padded_vocab // tp


class MeshModel(nn.Module):
    """What the decoder-only :class:`LM` and the encoder-decoder
    (:class:`~repro_torch.models.encdec.EncDecLM`) share on one device or,
    with ``self.ctx``, as one rank of a mesh: the layouts of their leaves,
    the per-block FSDP gather, the vocab-parallel head and loss, and the
    write of a prompt's K/V into a sequence-sharded cache.  A subclass sets
    ``cfg``, ``ctx``, ``embed`` and (untied) ``head``."""

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    @property
    def _tp(self) -> int:
        return self.ctx.tp_size if self.ctx is not None else 1

    @property
    def _sp(self) -> bool:
        """Sequence parallelism in the training forward."""
        return self.ctx is not None and self.ctx.sp and self._tp > 1

    def param_specs(self) -> dict[str, tuple]:
        """State-dict name -> layout (:func:`leaf_spec`) of every parameter."""
        ctx = self.ctx if self.ctx is not None else ShardCtx()
        return {name: leaf_spec(name, p.dim(), ctx, self.cfg) for name, p in self.named_parameters()}

    def _gathered(self, blk: nn.Module):
        """``blk`` with its fsdp-sharded weights all-gathered (the
        reference's ``fsdp_gather`` of one layer), as a namespace of the
        module's structure; ``blk`` itself without an fsdp axis."""
        ctx = self.ctx
        if ctx is None or ctx.fsdp is None or ctx.axis_size(ctx.fsdp) == 1:
            return blk

        def tree(mod, prefix):
            out = {n: p for n, p in mod.named_parameters(recurse=False)}
            dims = {n: _fsdp_dim(leaf_spec(prefix + n, p.dim(), ctx, self.cfg), ctx) for n, p in out.items()}
            for n, child in mod.named_children():
                out[n], dims[n] = tree(child, f"{prefix}{n}.")
            return out, dims

        def ns(t):
            return types.SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in t.items()})

        return ns(fsdp_gather(ctx, *tree(blk, "")))

    def init(self, generator: torch.Generator):
        """Draw every weight from ``generator`` (:func:`init_params`), this
        rank's shard of each."""
        return init_params(self, generator, self.ctx)

    def _seq_sharded(self, n: int) -> bool:
        """Whether a stack over a sequence of ``n`` runs sequence-parallel:
        under SP at tp > 1 where tp divides ``n``.  Elsewhere every rank
        holds the stack's whole T of activations (the reference cuts such a
        T unevenly, near 1/tp a rank: ROADMAP §3); ``loss`` reports which
        stacks ran sequence-parallel in its metrics."""
        return self._sp and n % self._tp == 0

    def _rank_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's T rows of ``x`` (B, T, ...) under sequence
        parallelism (``spec_resid``'s cut of an input every rank holds whole:
        no collective)."""
        n = x.shape[1] // self._tp
        return x.narrow(1, self.ctx.axis_index(self.ctx.tp) * n, n)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Vocab head.  At tp = 1 the padded columns are sliced off; at tp > 1
        the rank's shard keeps them, masked to -1e30 (the reference's even
        sharding)."""
        c = self.cfg
        if c.tie_embeddings:
            logits = x @ self.embed.table.T
        else:
            logits = lm_logits(self.head.w, x)
        if self._tp == 1:
            return logits[..., : c.vocab_size]
        vl = logits.shape[-1]
        cols = self.ctx.axis_index(self.ctx.tp) * vl + torch.arange(vl, device=logits.device)
        return torch.where(cols < c.vocab_size, logits, torch.full_like(logits, -1e30))

    def _whole_logits(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`_logits` with every vocab shard (all-gathered over tp at tp
        > 1: the padded width, pads at -1e30, as the reference returns)."""
        logits = self._logits(x)
        if self._tp == 1:
            return logits
        st = gather_stack(logits, self.ctx.group(self.ctx.tp))
        return st.movedim(0, -2).reshape(*logits.shape[:-1], -1)

    def _write_prefill(self, cache: torch.Tensor, kv: torch.Tensor) -> None:
        """Write a prompt's k or v (B, T, heads, hd) at positions [0, T) of a
        layer's cache.  At tp > 1 the cache holds the rank's chunk of the
        sequence, every head, and ``kv`` the rank's heads (gathered over tp
        here) or, in the column-split and context-parallel layouts, every
        head already; the rank keeps its positions."""
        T = kv.shape[1]
        if self._tp == 1:
            cache[:, :T] = kv
            return
        B, _, kvl, hd = kv.shape
        whole = kv
        if kvl < self.cfg.num_kv_heads:
            whole = gather_stack(kv, self.ctx.group(self.ctx.tp)).permute(1, 2, 0, 3, 4).reshape(B, T, -1, hd)
        chunk = cache.shape[1]
        start = self.ctx.axis_index(self.ctx.tp) * chunk
        n = max(0, min(chunk, T - start))
        cache[:, :n] = whole[:, start : start + n]

    def _mean_ce(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The cross entropy of this rank's rows (vocab-parallel at tp > 1);
        on a mesh the mean over the global batch (the dp shards' means
        summed, equal shards), replicated."""
        ce = cross_entropy(logits, labels, ctx=self.ctx)
        if self.ctx is not None and self.ctx.groups(self.ctx.dp):
            ce = psum(ce, self.ctx.groups(self.ctx.dp)) / self.ctx.dp_size
        return ce


class LM(MeshModel):
    """The dense, MoE, Mamba2, hybrid or RWKV6 decoder on ``device`` (default
    ``"cuda"``; raises without a card unless asked for ``"cpu"``; ``"meta"``:
    :func:`model_device`), on one device or, with ``ctx``, this rank's shard
    of it.
    Parameters are allocated, not drawn: call :meth:`init` or load a state
    (``convert.params_from_reference``).  ``rwkv_chunked`` is the
    reference's option of the same name (the RWKV6 training forward's
    chunked form)."""

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx | None = None, device="cuda", rwkv_chunked: bool = False):
        super().__init__()
        kind = block_kind(cfg)
        dev = model_device(device)
        dt = getattr(torch, cfg.dtype)
        self.cfg, self.ctx = cfg, ctx
        vocab = vocab_shard(cfg, ctx)
        self.embed = Embed(vocab, cfg.d_model, dt, dev)
        self.kind = kind
        self.rwkv_chunked = rwkv_chunked
        if kind == "rwkv":
            self.layers = nn.ModuleList(RWKVLayer(cfg, dt, dev, ctx) for _ in range(cfg.num_layers))
        elif kind in SSM_KINDS:
            self.layers = nn.ModuleList(MambaLayer(cfg, dt, dev, ctx) for _ in range(cfg.num_layers))
            if self._every:
                self.shared = Block(cfg, dt, dev, ctx=ctx)
        else:
            n_dense = cfg.moe.first_dense_layers if cfg.moe else 0
            if n_dense:
                d_ff = cfg.moe.d_ff_dense or cfg.d_ff
                self.dense_layers = nn.ModuleList(
                    Block(cfg, dt, dev, d_ff=d_ff, ctx=ctx) for _ in range(n_dense))
            self.layers = nn.ModuleList(
                Block(cfg, dt, dev, moe=kind == "moe", ctx=ctx) for _ in range(cfg.num_layers - n_dense)
            )
        self.ln_f = Norm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.head = Head(cfg.d_model, vocab, dt, dev)

    @property
    def _every(self) -> int:
        """The hybrid's shared-block period (0: no shared block)."""
        c = self.cfg
        return c.shared_attn_every if c.family == "hybrid" else 0

    def _shared_after(self, i: int) -> bool:
        """Whether the shared block runs after Mamba layer ``i``: at the end
        of each full segment of ``every`` layers (a short last segment has
        none after it)."""
        return bool(self._every) and (i + 1) % self._every == 0

    def _stacks(self):
        """(blocks, k cache name, v cache name) of the attention stacks, in
        the order they run (none for the recurrent kinds)."""
        if self.kind in RECURRENT_KINDS:
            return
        if hasattr(self, "dense_layers"):
            yield self.dense_layers, "k_dense", "v_dense"
        yield self.layers, "k", "v"

    @property
    def loss_unreached(self) -> tuple[str, ...]:
        """The parameters :meth:`loss` does not reach: an untied
        ``input_kind == "embeds"`` model's token table (its batches are
        embeddings; only :meth:`decode_step` looks tokens up)."""
        return ("embed.table",) if self.cfg.input_kind == "embeds" and not self.cfg.tie_embeddings else ()

    # --------------------------------------------------------------- forward
    def _block(self, blk: Block, x: torch.Tensor, positions: torch.Tensor, sp: bool):
        """One block, as the reference's ``_attn_mlp_body``: (x, aux).  With
        ``sp`` (sequence parallelism) ``x`` is this rank's T chunk, gathered
        before each norm (a context-parallel attention takes the chunk
        itself); the block's fsdp-sharded weights are gathered here."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(blk)
        xg = gather_seq(x, ctx) if sp and not attn_mod.use_context_parallel(c, ctx) else x
        x = x + attn_mod.attention(p.attn, c, rms_norm(xg, p.ln1.scale, c.norm_eps), positions,
                                   ctx=ctx, seq_sharded=sp)
        xg = gather_seq(x, ctx) if sp else x
        h = rms_norm(xg, p.ln2.scale, c.norm_eps)
        if hasattr(p, "moe"):
            if ctx is not None and moe_mod.use_a2a(c, ctx):
                # the a2a dispatch routes the rank's own T chunk
                h_loc = rms_norm(x, p.ln2.scale, c.norm_eps)
                y, aux, _ = moe_mod.moe_layer_a2a(p.moe, c, ctx, h_loc, x_full=h)
            else:
                y, aux, _ = moe_mod.moe_layer(p.moe, c, h, ctx)
            return x + y, aux
        return x + mlp_mod.mlp(p.mlp, c, h, ctx, seq_sharded=sp), self._zero_aux(x)

    def embed_inputs(self, inputs: torch.Tensor, seq_sharded: bool = False) -> torch.Tensor:
        """The residual stream's input (the reference's ``embed_inputs``, of
        any kind): token ids (B, T) looked up in the table
        (:func:`embed_tokens`), or an ``input_kind == "embeds"`` model's
        precomputed embeddings (B, T, D) cast to the model's type; with
        ``seq_sharded`` this rank's T rows of either (``spec_resid``)."""
        if self.cfg.input_kind == "tokens":
            return embed_tokens(self.embed.table, inputs.long(), self.ctx, seq_sharded=seq_sharded)
        x = inputs.to(self.dtype)
        return self._rank_rows(x) if seq_sharded else x

    def forward(self, tokens: torch.Tensor):
        """Training/scoring forward over ``tokens`` (B, T), this rank's rows
        (an embeddings model's (B, T, D) embeddings):
        (logits (B, T, V) -- with the padded vocab sliced off on one device,
        this rank's vocab shard with the padded columns at -1e30 at tp > 1,
        as the reference keeps them -- and the MoE stack's summed load-balance
        aux).  The leading dense layers run first; each block is one
        activation checkpoint (non-reentrant), recomputed in the backward:
        the Mamba2 kinds' one a Mamba block and one a shared invocation, the
        RWKV6 kind's one a block (the reference's per-layer and
        per-invocation ``jax.checkpoint``).  Under sequence parallelism a
        length T that tp does not divide runs without it (the same function;
        the reference cuts such a T unevenly), but for an MoE model, whose
        a2a dispatch needs the even cut, as the reference's does."""
        c, ctx = self.cfg, self.ctx
        T = tokens.shape[1]
        if self.cfg.moe is not None and self._tp > 1:
            if not moe_mod.use_a2a(c, ctx):
                raise ValueError(
                    "training MoE with tp>1 requires the a2a dispatch "
                    "(T % tp == 0 / SP); the psum fallback's gradient path is "
                    "only validated for tp=1"
                )
            if T % self._tp:
                raise ValueError(f"the a2a MoE dispatch needs T={T} divisible by tp={self._tp}")
        sp = self._seq_sharded(T)
        x = self.embed_inputs(tokens, seq_sharded=sp)
        positions = torch.arange(T, device=x.device)[None, :]
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for body, blk in self._train_blocks():
            x, aux = checkpoint(body, blk, x, positions, sp, use_reentrant=False)
            aux_total = aux_total + aux
        if sp:
            x = gather_seq(x, ctx)
        x = rms_norm(x, self.ln_f.scale, c.norm_eps)
        return self._logits(x), aux_total

    def _train_blocks(self):
        """(body, module) of each block of the training forward, in order;
        a body is ``(module, x, positions, sp) -> (x, aux)``."""
        if self.kind in SSM_KINDS:
            for i, layer in enumerate(self.layers):
                yield self._mamba_layer, layer
                if self._shared_after(i):
                    yield self._block, self.shared
        elif self.kind == "rwkv":
            for layer in self.layers:
                yield self._rwkv_layer, layer
        else:
            for blocks, _, _ in self._stacks():
                for blk in blocks:
                    yield self._block, blk

    def _zero_aux(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=x.device)

    def _mamba_layer(self, layer: MambaLayer, x: torch.Tensor, positions: torch.Tensor, sp: bool):
        """One Mamba2 block of the training forward (the reference's
        ``body``): with ``sp`` ``x`` is this rank's T chunk, gathered before
        the norm, and the block's output reduce-scattered back."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(layer)
        xg = gather_seq(x, ctx) if sp else x
        y, _, _ = mamba2.mamba_block(p.mamba, c, rms_norm(xg, p.ln1.scale, c.norm_eps), ctx=ctx, seq_sharded=sp)
        return x + y, self._zero_aux(x)

    def _rwkv_layer(self, layer: RWKVLayer, x: torch.Tensor, positions: torch.Tensor, sp: bool):
        """One RWKV6 block of the training forward, from a zero shift and a
        zero state (the reference's ``body``), each mix's input gathered
        over T and its output reduce-scattered back with ``sp``."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(layer)
        hs, _ = rwkv6.dims(c)
        h0, h1, _ = rank_heads(rwkv6.dims(c)[1], ctx)
        B = x.shape[0]
        z_shift = torch.zeros(B, c.d_model, dtype=x.dtype, device=x.device)
        z_state = torch.zeros(B, h1 - h0, hs, hs, dtype=torch.float32, device=x.device)
        mix = rwkv6.rwkv_time_mix_chunked if self.rwkv_chunked else rwkv6.rwkv_time_mix
        xg = gather_seq(x, ctx) if sp else x
        y, _, _ = mix(p.rwkv, c, rms_norm(xg, p.ln1.scale, c.norm_eps), z_shift, z_state, ctx=ctx, seq_sharded=sp)
        x = x + y
        xg = gather_seq(x, ctx) if sp else x
        y, _ = rwkv6.rwkv_channel_mix(p.rwkv, c, rms_norm(xg, p.ln2.scale, c.norm_eps), z_shift, ctx=ctx,
                                      seq_sharded=sp)
        return x + y, self._zero_aux(x)

    def loss(self, batch: dict, aux_weight: float = 0.01):
        """``ce + aux_weight * aux`` over ``batch`` ({"tokens", "labels"},
        (B, T) each, this rank's rows; an embeddings model's {"embeds",
        "labels"}): (loss, {"ce", "aux", "seq_parallel"}).  On a mesh ``ce``
        is the mean over the global batch (the dp shards' means summed, equal
        shards), replicated, as are ``aux`` and the loss.  ``seq_parallel``
        (a host bool) says whether the stack ran sequence-parallel: not under
        SP where tp does not divide T (:meth:`_seq_sharded`)."""
        logits, aux = self(batch["embeds"] if self.cfg.input_kind == "embeds" else batch["tokens"])
        ce = self._mean_ce(logits, batch["labels"])
        sp = torch.tensor(self._seq_sharded(batch["labels"].shape[1]))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux, "seq_parallel": sp}

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zeros: ``pos`` (B,) int32 and ``k``/``v`` (L, B, S, KV, hd) of each
        stack (``k_dense``/``v_dense`` for the leading dense layers).  At tp
        > 1 this rank's chunk of the sequence, S = ``max_len / tp``.  The
        Mamba2 kinds: ``conv``, ``ssm`` and the hybrid's ``shared_k``/``shared_v``;
        RWKV6: ``tm_shift``, ``cm_shift`` and ``wkv`` (see the module's
        docstring; on a mesh the rank's heads and channels)."""
        c = self.cfg
        if (self._every or self.kind not in RECURRENT_KINDS) and max_len % self._tp:
            raise ValueError(f"max_len={max_len} does not split over tp={self._tp} (the sequence-sharded cache)")
        cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=self.device)}
        if self.kind == "rwkv":
            hs, _ = rwkv6.dims(c)
            h0, h1, _ = rank_heads(rwkv6.dims(c)[1], self.ctx)
            L = c.num_layers
            cache["tm_shift"] = torch.zeros(L, batch, c.d_model, dtype=self.dtype, device=self.device)
            cache["cm_shift"] = torch.zeros(L, batch, c.d_model, dtype=self.dtype, device=self.device)
            cache["wkv"] = torch.zeros(L, batch, h1 - h0, hs, hs, dtype=torch.float32, device=self.device)
            return cache
        if self.kind in SSM_KINDS:
            s = c.ssm
            h0, h1, _ = rank_heads(mamba2.dims(c)[2], self.ctx)
            L = c.num_layers
            cache["conv"] = torch.zeros(L, batch, s.conv_width - 1, mamba2.conv_channels(c, self.ctx),
                                        dtype=self.dtype, device=self.device)
            cache["ssm"] = torch.zeros(L, batch, h1 - h0, s.state_dim, s.head_dim, dtype=torch.float32,
                                       device=self.device)
            if self._every:
                shape = (L // self._every, batch, max_len // self._tp, c.num_kv_heads, c.resolved_head_dim)
                cache["shared_k"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
                cache["shared_v"] = torch.zeros(shape, dtype=self.dtype, device=self.device)
            return cache
        for blocks, kn, vn in self._stacks():
            shape = (len(blocks), batch, max_len // self._tp, c.num_kv_heads, c.resolved_head_dim)
            cache[kn] = torch.zeros(shape, dtype=self.dtype, device=self.device)
            cache[vn] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: dict):
        """Process a whole prompt ``tokens`` (B, T) (an embeddings model's
        (B, T, D) embeddings) into an empty ``cache``: k/v of positions [0,
        T) are written and ``pos`` advances by T.  Returns (last-position
        logits (B, V), cache)."""
        c = self.cfg
        x = self.embed_inputs(tokens)
        T = x.shape[1]
        positions = torch.arange(T, device=x.device)[None, :]
        if self.kind in SSM_KINDS:
            x = self._ssm_cached(x, cache, positions)
        if self.kind == "rwkv":
            x = self._rwkv_cached(x, cache, fresh=True)
        for blocks, kn, vn in self._stacks():
            for i, blk in enumerate(blocks):
                x = self._attn_prefill(blk, x, positions, cache[kn][i], cache[vn][i])
        # the norm is per row: normalizing the last position alone is the same
        x = rms_norm(x[:, -1], self.ln_f.scale, c.norm_eps)
        cache["pos"] += T
        return self._whole_logits(x), cache

    def _attn_prefill(self, blk: Block, x: torch.Tensor, positions: torch.Tensor, kcache: torch.Tensor,
                      vcache: torch.Tensor) -> torch.Tensor:
        """One attention block over a prompt, its k/v written at positions
        [0, T) of its layer's caches."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(blk)
        h = rms_norm(x, p.ln1.scale, c.norm_eps)
        y, (k, v) = attn_mod.attention(p.attn, c, h, positions, return_kv=True, ctx=ctx)
        self._write_prefill(kcache, k)
        self._write_prefill(vcache, v)
        x = x + y
        return x + ffn(p, c, rms_norm(x, p.ln2.scale, c.norm_eps), ctx)

    def _attn_decode(self, blk: Block, x: torch.Tensor, kcache: torch.Tensor, vcache: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        """One attention block's decode step on its layer's caches."""
        c, ctx = self.cfg, self.ctx
        p = self._gathered(blk)
        y, _, _ = attn_mod.decode_attention(p.attn, c, rms_norm(x, p.ln1.scale, c.norm_eps), kcache, vcache, pos, ctx)
        x = x + y
        return x + ffn(p, c, rms_norm(x, p.ln2.scale, c.norm_eps), ctx)

    def _ssm_cached(self, x: torch.Tensor, cache: dict, positions: torch.Tensor | None = None) -> torch.Tensor:
        """The Mamba2 stacks against the cache: a prompt's prefill (given
        ``positions``: every block from zero states, its final conv and ssm
        states written to the cache, the hybrid's shared block writing its
        k/v at positions [0, T) of its invocation's cache) or a decode step
        (every state written back in place: new tensors copied into the
        cache's storage)."""
        c, ctx, inv = self.cfg, self.ctx, 0
        for i, layer in enumerate(self.layers):
            p = self._gathered(layer)
            h = rms_norm(x, p.ln1.scale, c.norm_eps)
            if positions is None:
                y, conv, ssm = mamba2.mamba_decode(p.mamba, c, h, cache["conv"][i], cache["ssm"][i], ctx=ctx)
            else:
                y, conv, ssm = mamba2.mamba_block(p.mamba, c, h, ctx=ctx)
            cache["conv"][i].copy_(conv)
            cache["ssm"][i].copy_(ssm)
            x = x + y
            if self._shared_after(i):
                kc, vc = cache["shared_k"][inv], cache["shared_v"][inv]
                if positions is None:
                    x = self._attn_decode(self.shared, x, kc, vc, cache["pos"])
                else:
                    x = self._attn_prefill(self.shared, x, positions, kc, vc)
                inv += 1
        return x

    def _rwkv_cached(self, x: torch.Tensor, cache: dict, fresh: bool) -> torch.Tensor:
        """The RWKV6 stack against the cache: a prompt's prefill (``fresh``:
        every layer's shifts and ``wkv`` slice zeroed first, whatever the
        cache held) or a decode step.  K7 writes each layer's final state
        over its ``wkv`` slice; the new shifts are copied in after the old
        ones are read."""
        c, ctx = self.cfg, self.ctx
        for i, layer in enumerate(self.layers):
            p = self._gathered(layer)
            tm_shift, cm_shift, state = cache["tm_shift"][i], cache["cm_shift"][i], cache["wkv"][i]
            if fresh:
                for t in (tm_shift, cm_shift, state):
                    t.zero_()
            y, tms, _ = rwkv6.rwkv_time_mix(p.rwkv, c, rms_norm(x, p.ln1.scale, c.norm_eps), tm_shift, state,
                                            in_place=True, ctx=ctx)
            tm_shift.copy_(tms)
            x = x + y
            y, cms = rwkv6.rwkv_channel_mix(p.rwkv, c, rms_norm(x, p.ln2.scale, c.norm_eps), cm_shift, ctx=ctx)
            cm_shift.copy_(cms)
            x = x + y
        return x

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step.  tokens: (B,) ints (an embeddings model decodes
        tokens too).  Returns (logits (B, V), cache)."""
        c = self.cfg
        x = embed_tokens(self.embed.table, tokens.long(), self.ctx)[:, None, :]
        if self.kind in SSM_KINDS:
            x = self._ssm_cached(x, cache)
        if self.kind == "rwkv":
            x = self._rwkv_cached(x, cache, fresh=False)
        for blocks, kn, vn in self._stacks():
            for i, blk in enumerate(blocks):
                x = self._attn_decode(blk, x, cache[kn][i], cache[vn][i], cache["pos"])
        x = rms_norm(x, self.ln_f.scale, c.norm_eps)
        cache["pos"] += 1
        return self._whole_logits(x)[:, 0, :], cache


def _fsdp_dim(spec: tuple, ctx: ShardCtx):
    """The dimension ``ctx.fsdp`` shards in ``spec``, or None."""
    return spec.index(ctx.fsdp) if ctx.fsdp in spec else None
