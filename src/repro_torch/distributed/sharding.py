"""Sharding vocabulary on ``torch.distributed``: axis roles, the layouts,
the per-layer FSDP gather, the egress pool's mesh, and the collectives the
sharded paths differentiate through.

Counterpart of :mod:`repro.distributed.sharding`.  Axis roles are the
reference's: ``tp`` (tensor parallel, "model": heads, FFN hidden, experts),
``fsdp`` (the ZeRO-3 parameter shard, "data") and ``dp`` (the batch axes).
The port is SPMD, one rank per device (:mod:`.compat`): a
:class:`ShardCtx` names the axes of a
:class:`~torch.distributed.device_mesh.DeviceMesh`, and a collective over an
axis is a ``torch.distributed`` call on that axis's process group
(:meth:`ShardCtx.group`).

Layouts.  A spec is a tuple with one entry per dimension: an axis name, a
tuple of axis names (their product, row-major), or None (whole), as the
reference's ``PartitionSpec``; ``spec_batch``, ``spec_resid``, ``spec_full``
and ``spec_w2`` are the reference's, and :func:`shard_leaf` cuts a whole
tensor to one rank's block of it.  The reference's ``constraint``, which asks
XLA's partitioner for a layout, has no counterpart in SPMD: the layout
changes it implies are explicit collectives here.  Under sequence
parallelism (``sp``) the residual is T-sharded over tp (``spec_resid``):
:func:`gather_seq` all-gathers T before a block's norm (``spec_full``) and
:func:`scatter_seq` reduce-scatters a row-parallel output back (Megatron-SP);
without it a row-parallel output is summed with :func:`all_reduce_sum`.

Gradients.  Every rank calls ``backward`` on its own loss.  A sharded output
enters each rank's loss with that rank's part, a replicated one (a
:func:`psum`, gpipe's outputs, the MoE's aux, the LM's loss) with the whole
value, which the backward then counts once; a parameter replicated over ranks
gets the sum of the ranks' gradients.  That is what the reference's
``jax.grad`` of the whole program gives, and each collective's backward below
is the transpose that makes it so.  It follows that the cotangent of an
activation every tp rank holds whole (a block's normed input, which each rank
multiplies by its column shard) is held as the ranks' partial sums: the
column-parallel entry needs no collective either way, the sum is taken where
a row-parallel output's all-reduce or :func:`gather_seq`'s reduce-scatter
transposes it, and a replicated parameter's partial gradients are summed
over tp as over dp (:func:`replicated_axes`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..obs import costs
from .compat import make_mesh


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: DeviceMesh | None = None
    tp: str | None = "model"
    fsdp: str | None = "data"
    dp: tuple[str, ...] = ("data",)
    sp: bool = False  # sequence parallelism: residuals T-sharded over tp
    #: Without a mesh, ``(axis, index, size)`` of each axis the context
    #: stands at (:meth:`grid`); no collective runs on such a context.
    at: tuple = ()

    @classmethod
    def grid(cls, *, sp: bool = False, **coords) -> "ShardCtx":
        """A context without a mesh at ``axis=(index, size)`` of each named
        axis (the default roles: tp ``model``, fsdp ``data``): the layouts
        and one rank's block of them, to cut or join whole trees in one
        process."""
        return cls(sp=sp, at=tuple((a, i, n) for a, (i, n) in coords.items()))

    def axis_size(self, name) -> int:
        """The size of axis ``name``: 1 for None or an axis the mesh lacks;
        a tuple of axes (the multi-pod ``fsdp``, ``("pod", "data")``) their
        product."""
        if isinstance(name, tuple):
            return math.prod(self.axis_size(a) for a in name)
        if self.mesh is None:
            return next((n for a, _, n in self.at if a == name), 1)
        if name is None or name not in (self.mesh.mesh_dim_names or ()):
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp)

    @property
    def dp_axis(self):
        """The batch-dim entry: None (replicated), one axis name, or a tuple
        of axis names."""
        if not self.dp:
            return None
        return self.dp if len(self.dp) > 1 else self.dp[0]

    def group(self, name) -> dist.ProcessGroup:
        """The process group of the mesh axis ``name`` (this rank's row); of
        a tuple of axes, their flattened group (rows ordered row-major)."""
        if isinstance(name, tuple):
            axes = tuple(a for a in name if self.axis_size(a) > 1)
            if len(axes) > 1:
                return self.mesh[axes]._flatten().get_group()
            name = axes[0] if axes else name[-1]
        return self.mesh.get_group(name)

    def axis_index(self, name) -> int:
        """This rank's coordinate along ``name`` (``jax.lax.axis_index``),
        row-major over a tuple of axes; 0 off the mesh."""
        if self.axis_size(name) == 1:
            return 0
        if isinstance(name, tuple):
            idx = 0
            for a in name:
                idx = idx * self.axis_size(a) + self.axis_index(a)
            return idx
        if self.mesh is None:
            return next(i for a, i, _ in self.at if a == name)
        return self.mesh.get_local_rank(name)

    @property
    def dp_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.dp)

    def groups(self, axes) -> list:
        """The process groups of the axes in ``axes`` of size > 1."""
        return [self.group(a) for a in axes if a is not None and self.axis_size(a) > 1]

    # -- layouts (the reference's spec helpers) ---------------------------------
    def spec_batch(self, *rest) -> tuple:
        return (self.dp_axis, *rest)

    def spec_resid(self) -> tuple:
        """(B, T, D) residual stream: T sharded over tp under SP."""
        return (self.dp_axis, self.tp if self.sp else None, None)

    def spec_full(self) -> tuple:
        """(B, T, D) with the whole T: a block's internal activations."""
        return (self.dp_axis, None, None)

    def spec_w2(self, contract_tp: bool) -> tuple:
        """(in, out) weight: tp on out, or on in for a row-parallel one."""
        return (self.tp, self.fsdp) if contract_tp else (self.fsdp, self.tp)

    def coords(self) -> dict:
        """Axis name -> (this rank's index, axis size), for :func:`shard_leaf`."""
        names = (self.mesh.mesh_dim_names or ()) if self.mesh is not None else [a for a, _, _ in self.at]
        return {a: (self.axis_index(a), self.axis_size(a)) for a in names}


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def _block(entry, coords: dict) -> tuple[int, int]:
    """(index, count) of one spec entry: its axes' product, row-major."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    idx, n = 0, 1
    for a in axes:
        i, size = coords.get(a, (0, 1))
        idx, n = idx * size + i, n * size
    return idx, n


def shard_leaf(x: torch.Tensor, spec: tuple, coords: dict) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``; ``coords``
    maps an axis name to (index, size) (:meth:`ShardCtx.coords`, or given
    by hand).  A dimension that its axes' product does not divide raises."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = _block(entry, coords)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by {n} ({entry})")
        size = x.shape[dim] // n
        x = x.narrow(dim, i * size, size)
    return x.contiguous()


def gather_leaf(ctx: ShardCtx, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (no
    gradient): :func:`shard_leaf`'s inverse, an all-gather per sharded
    axis.  Every rank of the mesh takes part and gets the whole tensor."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in reversed(entry if isinstance(entry, tuple) else (entry,)):
            if ctx.axis_size(a) > 1:
                x = _all_gather_dim0(x.movedim(dim, 0), ctx.group(a)).movedim(0, dim)
    return x


def replicated_axes(ctx: ShardCtx, spec: tuple) -> list[str]:
    """The dp and tp axes a leaf of layout ``spec`` is replicated over: the
    ones its gradient is summed over after ``backward``.  An fsdp axis in the
    spec is not among them (:func:`fsdp_gather`'s reduce-scatter sums it)."""
    used = {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}
    return [a for a in (*ctx.dp, ctx.tp) if a is not None and a not in used and ctx.axis_size(a) > 1]


# ---------------------------------------------------------------------------
# Collectives with their transposes
# ---------------------------------------------------------------------------


def _reduce(x: torch.Tensor, groups) -> torch.Tensor:
    x = x.contiguous().clone()
    for g in groups:
        costs.collective("all-reduce", x)
        dist.all_reduce(x, group=g)
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.groups), None


def _groups(groups) -> tuple:
    return tuple(groups) if isinstance(groups, (list, tuple)) else (groups,)


def psum(x: torch.Tensor, groups) -> torch.Tensor:
    """Sum ``x`` over the ranks of each process group in ``groups`` (one, or
    a sequence: their product): every rank returns the whole, replicated
    sum.  The backward passes each rank's cotangent through, since every
    rank holds the whole cotangent of a replicated value (the reference's
    ``psum``, whose transpose is a broadcast)."""
    return _Psum.apply(x, _groups(groups))


def all_reduce_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """The same sum, for a result that each rank goes on to use in its own
    part of the loss (the reference's ``pmean`` of ``me`` feeding each
    shard's aux): the backward sums the ranks' cotangents."""
    return _AllReduce.apply(x, _groups(groups))


def _all_gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    out = torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    costs.collective("all-gather", x, out)
    gather(out, x.contiguous(), group=group)
    return out


def _reduce_scatter_dim0(x: torch.Tensor, group) -> torch.Tensor:
    world = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // world, *x.shape[1:]), dtype=x.dtype, device=x.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    costs.collective("reduce-scatter", x, out)
    scatter(out, x.contiguous(), group=group)
    return out


class _GatherDim(torch.autograd.Function):
    """Tiled all_gather along ``dim``; backward the reduce-scatter (sum)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_dim0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim0(g.movedim(ctx.dim, 0), ctx.group).movedim(0, ctx.dim), None, None


class _ScatterDim(torch.autograd.Function):
    """Tiled reduce-scatter (sum) along ``dim``; backward the all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_dim0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim0(g.movedim(ctx.dim, 0), ctx.group).movedim(0, ctx.dim), None, None


class _GatherStack(torch.autograd.Function):
    """All-gather into a new leading axis of the group's size; backward the
    rank's own slice (each rank holds the whole cotangent of a replicated
    result, as :func:`psum`'s backward assumes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        return _all_gather_dim0(x[None], group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def gather_seq(x: torch.Tensor, ctx: ShardCtx, dim: int = 1) -> torch.Tensor:
    """Megatron-SP's ``spec_resid`` -> ``spec_full``: all-gather the
    T-sharded ``x`` over tp along ``dim``; the backward reduce-scatters the
    ranks' partial cotangents.  The identity at tp = 1."""
    if ctx.tp_size == 1:
        return x
    return _GatherDim.apply(x, ctx.group(ctx.tp), dim)


def scatter_seq(x: torch.Tensor, ctx: ShardCtx, dim: int = 1) -> torch.Tensor:
    """A row-parallel partial output back to ``spec_resid``: reduce-scatter
    (sum) over tp along ``dim``; the backward all-gathers the cotangent.
    The identity at tp = 1."""
    if ctx.tp_size == 1:
        return x
    return _ScatterDim.apply(x, ctx.group(ctx.tp), dim)


def tp_sum(x: torch.Tensor, ctx: ShardCtx | None, seq_sharded: bool = False) -> torch.Tensor:
    """A row-parallel layer's partial output summed over tp: an
    :func:`all_reduce_sum`, or with ``seq_sharded`` (sequence parallelism)
    a :func:`scatter_seq` over T.  The identity off a mesh or at tp = 1."""
    if ctx is None or ctx.tp_size == 1:
        return x
    return scatter_seq(x, ctx) if seq_sharded else all_reduce_sum(x, ctx.group(ctx.tp))


def _tp_on(ctx: ShardCtx | None) -> bool:
    return ctx is not None and ctx.tp_size > 1


def gather_cols(x: torch.Tensor, ctx: ShardCtx | None) -> torch.Tensor:
    """``x``'s last axis, cut over tp, all-gathered (backward: the
    reduce-scatter).  The identity off a mesh or at tp = 1."""
    return gather_seq(x, ctx, dim=-1) if _tp_on(ctx) else x


def scatter_cols(x: torch.Tensor, ctx: ShardCtx | None) -> torch.Tensor:
    """A row-parallel partial output summed over tp into this rank's
    ``1 / tp`` of its last axis (a reduce-scatter; backward: the
    all-gather).  The identity off a mesh or at tp = 1."""
    return scatter_seq(x, ctx, dim=-1) if _tp_on(ctx) else x


def rank_cols(x: torch.Tensor, ctx: ShardCtx | None) -> torch.Tensor:
    """This rank's ``1 / tp`` of ``x``'s last axis, a view; ``x`` off a mesh
    or at tp = 1."""
    if not _tp_on(ctx):
        return x
    n = x.shape[-1] // ctx.tp_size
    return x.narrow(-1, ctx.axis_index(ctx.tp) * n, n)


def _cols_to_seq(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    B, T, n = x.shape
    send = x.reshape(B, tp, T // tp, n).movedim(1, 0).contiguous()
    recv = torch.empty_like(send)
    costs.collective("all-to-all", send, recv)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3).reshape(B, T // tp, tp * n)


def _seq_to_cols(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    B, t, D = x.shape
    send = x.reshape(B, t, tp, D // tp).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    costs.collective("all-to-all", send, recv)
    dist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, 1).reshape(B, tp * t, D // tp)


class _ColsToSeq(torch.autograd.Function):
    """(B, T, D / tp) on each rank -> its T chunk (B, T / tp, D), one
    all_to_all; backward the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, tp):
        ctx.group, ctx.tp = group, tp
        return _cols_to_seq(x, group, tp)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_cols(g, ctx.group, ctx.tp), None, None


def cols_to_seq(x: torch.Tensor, ctx: ShardCtx | None) -> torch.Tensor:
    """A (B, T, D / tp) activation whose columns are cut over tp to the
    rank's T chunk of the whole (B, T / tp, D), ``spec_resid`` under
    sequence parallelism: an all_to_all of ``1 / tp`` of the bytes.  The
    identity off a mesh or at tp = 1."""
    return _ColsToSeq.apply(x, ctx.group(ctx.tp), ctx.tp_size) if _tp_on(ctx) else x


def rank_heads(nheads: int, ctx: ShardCtx | None) -> tuple[int, int, bool]:
    """The heads ``[h0, h1)`` a block cut over tp by heads runs on this rank,
    and whether tp cuts through a head (``cut``): its ``nheads / tp`` heads,
    or where tp does not divide them every head (its columns then cut
    through a head: it gathers them, :func:`gather_cols`, runs every head
    and keeps its own columns, :func:`rank_cols`).  ``(0, nheads, False)``
    off a mesh and at tp = 1."""
    if not _tp_on(ctx):
        return 0, nheads, False
    tp = ctx.tp_size
    if nheads % tp:
        return 0, nheads, True
    h0 = ctx.axis_index(ctx.tp) * (nheads // tp)
    return h0, h0 + nheads // tp, False


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis (the group's size),
    replicated; the backward keeps this rank's slice of the cotangent.  For
    small statistics (the vocab-parallel cross entropy's, K6's partials)."""
    return _GatherStack.apply(x, group)


def _map(fn, tree, dims):
    if isinstance(tree, dict):
        return {k: _map(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, d) for v, d in zip(tree, dims))
    return fn(tree, dims)


def fsdp_gather(ctx: ShardCtx, tree, dims):
    """Explicit per-layer ZeRO-3 all-gather (the reference's
    ``fsdp_gather``, which ``shard_map`` keeps inside the layer scan so that
    gathered weights stay bounded to one layer).

    ``dims`` has ``tree``'s structure, each leaf's fsdp dimension or None
    (the reference's PartitionSpec with ``ctx.fsdp`` at that position, or
    without it).  Each sharded leaf is all-gathered, tiled, over the fsdp
    axis; the backward is the reduce-scatter (sum), which is ZeRO's gradient
    sharding.  Returns ``tree`` unchanged off a mesh or without an fsdp
    axis."""
    if ctx.mesh is None or ctx.fsdp is None:
        return tree
    group = ctx.group(ctx.fsdp)
    return _map(lambda x, d: x if d is None else _GatherDim.apply(x, group, d), tree, dims)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def pool_mesh(num_servers: int, axis_name: str = "server", device_type: str = "cuda"):
    """The egress pool's one-axis mesh for its distributed merge
    (:func:`repro_torch.core.distributed.pool_concat_sharded`): rank ``s`` of
    the axis plays compute server ``s``.

    Returns None, and the caller concatenates, when the pool is trivial
    (``num_servers < 2``), no process group is initialized, or the world
    does not split into pools of ``num_servers`` ranks (fewer ranks than
    servers, as on one card, or a world it does not divide).  A world of
    ``R * num_servers`` ranks holds ``R`` pools, each gathering among its own
    ranks.  A world of exactly ``num_servers`` ranks uses the default
    process group; a larger one creates its pools' groups on each call,
    which every rank makes (each runs the same pool).  The mesh is not kept
    past the caller: a process group that outlives
    ``destroy_process_group`` aborts the process at exit."""
    if num_servers < 2 or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world < num_servers or world % num_servers:
        return None
    if world == num_servers:
        return make_mesh((num_servers,), (axis_name,), device_type)
    return make_mesh((world // num_servers, num_servers), ("pool_replica", axis_name), device_type)[axis_name]


def local_ctx(device_type: str = "cuda") -> ShardCtx:
    """A (1, 1) mesh for one-rank runs: the same code paths (the
    collectives, the all_to_all) as a production mesh, trivially sized.
    Needs an initialized one-rank process group."""
    mesh = make_mesh((1, 1), ("data", "model"), device_type)
    return ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",))


def pod_ctx(mesh: DeviceMesh) -> ShardCtx:
    """The production context of a mesh (a ``pod`` axis optional)."""
    dp = ("pod", "data") if "pod" in (mesh.mesh_dim_names or ()) else ("data",)
    return ShardCtx(mesh=mesh, tp="model", fsdp="data", dp=dp)
