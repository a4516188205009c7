"""Distributed range sort -- the paper's switch fabric mapped onto ranks.

Counterpart of :mod:`repro.core.distributed`.  Ranks along one mesh axis
play the switch's range segments, each owning one key range; the
``all_to_all`` over the axis's process group is the fabric (NVLink between
cards); the per-rank local sort is the segment's compare-exchange pipeline;
concatenation in rank order is the server's final concatenation.  The
control plane (host) computes the range splitters.

The reference runs the per-device body under ``shard_map`` from one
controller.  The port is SPMD (:mod:`repro_torch.distributed.compat`):
:func:`sort_sharded` is called on every rank with that rank's keys and
returns that rank's results.  The on-path presort (MergeMarathon) sorts its
blocks on kernel K1 (:func:`blockwise_sort`), where the reference calls
``jnp.sort``; the local sort after the exchange is ``torch.sort``, as the
reference's is ``jnp.sort``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import pool_mesh
from ..kernels import ops
from ..kernels.bitonic import MAX_ROW
from .mergesort import merge_runs


def _sentinel(dtype: torch.dtype):
    """The padding key: the dtype's max for integers, +inf for floats."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def blockwise_sort(x: torch.Tensor, block: int) -> torch.Tensor:
    """MergeMarathon segment emission: sort consecutive ``block`` chunks of
    the last axis.  Raises when ``block`` does not divide its length (pad
    with sentinels first).

    Integer keys sort on K1, the chunks as the rows of one matrix; a
    ``block`` that is not a power of two is padded per row with the dtype's
    max to the next one, and the pads are cut off after the sort.  A block
    wider than K1's ``MAX_ROW`` (4096), or float keys (K1 compares integers
    and pads with an integer max), go to ``torch.sort``, as the reference's
    ``jnp.sort`` takes any: a dispatch by shape and dtype, not a fallback."""
    n = x.shape[-1]
    if n % block:
        raise ValueError(f"length {n} not divisible by block {block}")
    rows = x.reshape(-1, block)
    if x.dtype.is_floating_point or block > MAX_ROW:
        return torch.sort(rows, dim=-1, stable=True).values.reshape(x.shape)
    width = 1 << (block - 1).bit_length()
    if width != block:
        mat = torch.full((rows.shape[0], width), _sentinel(x.dtype), dtype=x.dtype, device=x.device)
        mat[:, :block] = rows
        return ops.sort_rows_padded(mat)[:, :block].reshape(x.shape)
    return ops.sort_rows_padded(rows.contiguous()).reshape(x.shape)


def make_splitters(sample, num_devices: int) -> np.ndarray:
    """Control plane: balanced splitters from a host-side sample (float64
    quantiles, as the reference's)."""
    qs = np.quantile(np.asarray(sample), np.linspace(0, 1, num_devices + 1)[1:-1])
    return np.asarray(qs)


def _sort_body(xl, splits, *, group, num_devices: int, capacity: int, presort_block):
    """Per-rank body: route -> exchange -> local sort (the reference's
    ``_sort_body`` step for step)."""
    (n,) = xl.shape
    sent = _sentinel(xl.dtype)
    # -- route: which range segment (rank) owns each local value ----------
    bucket = torch.searchsorted(splits, xl, right=True)  # (n,) in [0, D)
    order = torch.argsort(bucket, stable=True)
    sb = bucket[order]
    # rank of each element within its bucket
    first_of_group = torch.searchsorted(sb, sb, right=False)
    rank = torch.arange(n, device=xl.device) - first_of_group
    # ranks at or over capacity are dropped: written to one junk slot past
    # the (D, capacity) send matrix, which is cut off
    slot = torch.where(rank < capacity, sb * capacity + rank, num_devices * capacity)
    send = torch.full((num_devices * capacity + 1,), sent, dtype=xl.dtype, device=xl.device)
    send[slot] = xl[order]
    send = send[:-1].view(num_devices, capacity)
    counts = torch.bincount(bucket, minlength=num_devices)
    overflow = (counts - capacity).clamp_min(0).sum()
    # -- on-path partial sort (MergeMarathon): pre-sort each send chunk ---
    if presort_block is not None:
        send = blockwise_sort(send, presort_block)
    # -- the fabric: all_to_all over the axis ------------------------------
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # -- segment-local sort; sentinels sort to the end ---------------------
    out = torch.sort(recv.reshape(-1)).values
    valid = (out != sent).sum()  # a real key equal to the sentinel is not counted (R6)
    return out, valid[None], overflow[None]


def sort_sharded(
    x_local: torch.Tensor,
    mesh,
    axis_name: str,
    splitters,
    capacity_factor: float = 2.0,
    presort_block: int | None = None,
):
    """Globally sort keys sharded over ``axis_name`` of ``mesh``: called on
    every rank with that rank's ``n / D`` keys.

    Returns this rank's ``(padded, valid, overflow)``: its sorted chunk of
    ``D * capacity`` keys padded with the sentinel, its valid count (1,) and
    the keys it dropped for capacity (1,), 0 in healthy runs.  Concatenating
    every rank's ``padded[:valid]`` in rank order (:func:`gather_sorted` of
    the stacked results) is the sorted stream.  ``capacity`` is the
    reference's, ``ceil(n_local / D * capacity_factor)`` rounded up to a
    multiple of ``presort_block``; the splitters are cast to the keys' dtype
    as numpy casts (float quantiles truncate for integer keys)."""
    group = mesh.get_group(axis_name)
    num_devices = dist.get_world_size(group)
    n_local = x_local.shape[0]
    capacity = int(np.ceil(n_local / num_devices * capacity_factor))
    if presort_block is not None:
        # pad capacity to a multiple of the presort block
        capacity = -(-capacity // presort_block) * presort_block
    numpy_dtype = torch.empty(0, dtype=x_local.dtype).numpy().dtype
    splits = torch.from_numpy(np.asarray(splitters).astype(numpy_dtype)).to(x_local.device)
    return _sort_body(x_local.contiguous(), splits, group=group, num_devices=num_devices,
                      capacity=capacity, presort_block=presort_block)


def gather_sorted(padded, valid):
    """Host-side concatenation by device (segment) order of ``padded`` (D,
    C) cut to ``valid`` (D,); numpy arrays give a numpy array, tensors a
    tensor on their device."""
    if isinstance(padded, torch.Tensor):
        return torch.cat([padded[d, : int(valid[d])] for d in range(padded.shape[0])])
    return np.concatenate([np.asarray(padded[d, : int(valid[d])]) for d in range(padded.shape[0])])


# ---------------------------------------------------------------------------
# Egress server-pool merge (repro_torch.net.egress.ServerPool)
# ---------------------------------------------------------------------------


def pool_concat_sharded(outs: list[torch.Tensor], mesh, axis_name: str = "server") -> torch.Tensor:
    """Distributed concatenation of per-server sorted range shards.

    Called on every rank of the ``axis_name`` axis with the pool's ``S``
    shards: rank ``s`` pads shard ``s`` to the pool-wide capacity with the
    int64 max and one tiled ``all_gather`` over the axis moves every shard to
    every rank -- the paper's "concatenate" executed as the collective a
    multi-card fabric would use.  The result is compacted by the true shard
    lengths (:func:`gather_sorted`), so a real key equal to the pad is kept."""
    group = mesh.get_group(axis_name)
    num_servers = dist.get_world_size(group)
    if len(outs) != num_servers:
        raise ValueError(f"{len(outs)} shards for a {num_servers}-device {axis_name!r} axis")
    valid = [int(o.numel()) for o in outs]
    cap = max(valid)
    device = outs[0].device
    if cap == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    me = mesh.get_local_rank(axis_name)
    row = torch.full((1, cap), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)
    row[0, : valid[me]] = outs[me]
    gathered = torch.empty((num_servers, cap), dtype=torch.int64, device=device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(gathered, row, group=group)
    return gather_sorted(gathered, valid)


def pool_concat(
    outs: list[torch.Tensor],
    *,
    disjoint: bool,
    backend: str = "numpy",
    mesh=None,
    axis_name: str = "server",
) -> torch.Tensor:
    """Merge per-server egress-pool outputs into the global sorted stream.

    ``disjoint=True`` (one control-plane epoch: server order is key-range
    order) concatenates -- on the device, or with ``backend="shard_map"`` by
    :func:`pool_concat_sharded` over ``mesh`` (built from
    :func:`repro_torch.distributed.sharding.pool_mesh` when not given; a
    plain concatenation when that is None).  The option keeps the
    reference's name; the mechanism is a ``torch.distributed`` all_gather.
    ``disjoint=False`` (epoched re-partitioning: server ranges overlap)
    k-way merges the sorted server streams.  No outputs give an empty int64
    tensor (on the CPU)."""
    outs = [torch.as_tensor(o).to(torch.int64) for o in outs]
    if not outs:
        return torch.zeros(0, dtype=torch.int64)
    if len(outs) == 1:
        return outs[0]
    if not disjoint:
        nonempty = [o for o in outs if o.numel()]
        return merge_runs(nonempty) if nonempty else outs[0][:0]
    if backend == "shard_map":
        if mesh is None:
            mesh = pool_mesh(len(outs), axis_name, outs[0].device.type)
        if mesh is not None:
            return pool_concat_sharded(outs, mesh, axis_name)
    return torch.cat(outs)
