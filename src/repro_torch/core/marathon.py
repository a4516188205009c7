"""MergeMarathon as one fused pass over tensors (Alg. 3, vectorized).

Counterpart of :mod:`repro.core.marathon`.  The stream a segment of length
``L`` emits is ``sorted(c_0) ++ sorted(c_1) ++ ...`` over its consecutive
``L``-blocks of arrivals, so a whole switch hop is: route every arrival,
rank it within its segment (one stable sort), lay every segment's blocks out
as the rows of one padded matrix, sort the rows (``row_sort`` -- the hop
engine passes kernel K1), and rebuild the exact emission interleave with
gathers.  Every step is a tensor op on the keys' device.  The pre-fusion
per-segment path (:func:`marathon_streams`, ``marathon_flat(block_sort=)``)
is kept as the baseline engine's, one ``block_sort`` call per segment.
"""

from __future__ import annotations

import torch

from ..obs.trace import NULL_TRACER
from .partition import segment_of, set_ranges

#: Padding key for the ragged tail rows of the block matrix (int64 max).
PAD = torch.iinfo(torch.int64).max


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    if x.numel() > 1:
        out[1:] = torch.cumsum(x[:-1], 0)
    return out


def _repeat(values: torch.Tensor, counts: torch.Tensor, total: int | None = None) -> torch.Tensor:
    """``np.repeat(values, counts)`` with a known output size when given."""
    if total is None:
        total = int(counts.sum()) if counts.numel() else 0
    return torch.repeat_interleave(values, counts, output_size=total)


def blockwise_sort(values: torch.Tensor, block: int) -> torch.Tensor:
    """Sort each consecutive ``block``-sized chunk of ``values`` (the
    per-segment MergeMarathon emission)."""
    n = values.numel()
    if n == 0 or block <= 1:
        return values.clone()
    nfull = (n // block) * block
    head = torch.sort(values[:nfull].reshape(-1, block), dim=1).values.reshape(-1)
    tail = torch.sort(values[nfull:]).values
    return torch.cat([head, tail])


def default_row_sort(mat: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """Sort each row of the block matrix with ``torch.sort`` (the plain
    reference; the hop engine passes its kernel-backed sorter instead)."""
    del row_len
    return torch.sort(mat, dim=1).values


def rank_within_segment(
    seg: torch.Tensor, num_segments: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group arrivals by segment, keeping arrival order within each.

    Returns ``(order, counts, starts, ranks)`` as the reference does:
    ``order`` is the stable grouping permutation, ``counts``/``starts`` the
    per-segment sizes and offsets, ``ranks[t]`` arrival ``t``'s 0-based rank
    within its segment.
    """
    n = seg.numel()
    key = seg.to(torch.int32) if num_segments <= torch.iinfo(torch.int32).max else seg
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(seg, minlength=num_segments).to(torch.int64)
    starts = _exclusive_cumsum(counts)
    ranks = torch.empty(n, dtype=torch.int64, device=seg.device)
    ranks[order] = torch.arange(n, dtype=torch.int64, device=seg.device) - _repeat(
        starts, counts, n
    )
    return order, counts, starts, ranks


def _block_layout(counts: torch.Tensor, block: int):
    """Row bookkeeping of the block matrix: per-row segment, length, and
    each grouped key's flat cell index."""
    nblk = (counts + block - 1) // block
    total = int(nblk.sum())
    dev = counts.device
    n = int(counts.sum())
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return 0, z, z
    row_seg = _repeat(torch.arange(counts.numel(), dtype=torch.int64, device=dev), nblk, total)
    blk_starts = _exclusive_cumsum(nblk)
    row_blk = torch.arange(total, dtype=torch.int64, device=dev) - _repeat(blk_starts, nblk, total)
    row_len = torch.clamp(counts[row_seg] - row_blk * block, max=block)
    # grouped key i of segment s at position p sits in row blk_starts[s] +
    # p // block, column p % block
    seg_of = _repeat(torch.arange(counts.numel(), dtype=torch.int64, device=dev), counts, n)
    pos = torch.arange(n, dtype=torch.int64, device=dev) - _exclusive_cumsum(counts)[seg_of]
    cell = (blk_starts[seg_of] + pos // block) * block + pos % block
    return total, row_len, cell


def block_matrix(
    grouped: torch.Tensor, counts: torch.Tensor, block: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every segment's consecutive ``block``-chunks as matrix rows, short
    tail rows padded with int64 max; returns ``(mat, row_len)``."""
    total, row_len, cell = _block_layout(counts, block)
    mat = torch.full((total, block), PAD, dtype=grouped.dtype, device=grouped.device)
    mat.view(-1)[cell] = grouped
    return mat, row_len


class MarathonEmission:
    """The fused pass over one hop's arrival stream, with its internals.

    ``streams`` holds every segment's emitted stream contiguously (grouped
    by segment), ``slots`` the index into ``streams`` of every emission
    event in wire order; ``order``/``counts``/``starts``/``ranks`` are the
    grouping arrays.  ``values``/``segment_ids``/``positions`` are derived.
    """

    def __init__(self, streams, slots, emit_seg, flush_sids, order, counts, starts, ranks) -> None:
        self.streams = streams
        self.slots = slots
        self._emit_seg = emit_seg
        self._flush_sids = flush_sids
        self.order = order
        self.counts = counts
        self.starts = starts
        self.ranks = ranks

    @property
    def values(self) -> torch.Tensor:
        """Emission-ordered keys (the faithful simulator's wire stream)."""
        return self.streams[self.slots]

    @property
    def segment_ids(self) -> torch.Tensor:
        """Emission-ordered port numbers."""
        return torch.cat([self._emit_seg, self._flush_sids])

    @property
    def positions(self) -> torch.Tensor:
        """Per-emission position within its segment's emitted stream."""
        return self.slots - self.starts[self.segment_ids]


def marathon_emission(
    values: torch.Tensor,
    num_segments: int,
    segment_length: int,
    max_value: int,
    ranges: torch.Tensor | None = None,
    row_sort=None,
    tracer=None,
) -> MarathonEmission:
    """One fused, loop-free pass of the whole switch over ``values``.

    Route -> rank within segment -> sort all segments' blocks as the rows of
    one padded matrix (``row_sort(mat, row_len)``, default ``torch.sort``)
    -> emission interleave: the arrival with per-segment rank ``r >= L``
    emits element ``r - L`` of its segment's stream, then the flush appends
    each segment's last ``min(n_s, L)`` stream elements.
    """
    tr = tracer or NULL_TRACER
    values = values.to(torch.int64)
    dev = values.device
    if ranges is None:
        ranges = set_ranges(max_value, num_segments, device=dev)
    if row_sort is None:
        row_sort = default_row_sort
    L = segment_length
    with tr.span("route", cat="stage"):
        seg = segment_of(values, ranges)
    with tr.span("rank", cat="stage"):
        order, counts, starts, ranks = rank_within_segment(seg, num_segments)
    with tr.span("sort", cat="stage") as sp:
        total, row_len, cell = _block_layout(counts, L)
        sp.set(blocks=total, block_len=L)
        if total:
            mat = torch.full((total, L), PAD, dtype=torch.int64, device=dev)
            mat.view(-1)[cell] = values[order]
            streams = row_sort(mat, row_len).reshape(-1)[cell]
            del mat
        else:
            streams = torch.zeros(0, dtype=torch.int64, device=dev)
    with tr.span("emit", cat="stage"):
        emit_mask = ranks >= L
        emit_slot = (starts[seg] + ranks - L)[emit_mask]
        n_emitted = torch.clamp(counts - L, min=0)
        tail_len = counts - n_emitted
        n_tail = int(tail_len.sum())
        sids = torch.arange(num_segments, dtype=torch.int64, device=dev)
        flush_sids = _repeat(sids, tail_len, n_tail)
        tail_off = torch.arange(n_tail, dtype=torch.int64, device=dev) - _repeat(
            _exclusive_cumsum(tail_len), tail_len, n_tail
        )
        flush_slot = starts[flush_sids] + n_emitted[flush_sids] + tail_off
    return MarathonEmission(
        streams=streams,
        slots=torch.cat([emit_slot, flush_slot]),
        emit_seg=seg[emit_mask],
        flush_sids=flush_sids,
        order=order,
        counts=counts,
        starts=starts,
        ranks=ranks,
    )


def marathon_streams(
    values: torch.Tensor,
    num_segments: int,
    segment_length: int,
    max_value: int,
    ranges: torch.Tensor | None = None,
    block_sort=None,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Per-segment emitted streams, one segment at a time: ``(streams,
    ranges)`` with ``streams[s]`` segment ``s``'s emission-order stream
    (``block_sort(values, L)``, default :func:`blockwise_sort`)."""
    values = values.to(torch.int64)
    if ranges is None:
        ranges = set_ranges(max_value, num_segments, device=values.device)
    if block_sort is None:
        block_sort = blockwise_sort
    seg = segment_of(values, ranges)
    streams = [block_sort(values[seg == s], segment_length) for s in range(num_segments)]
    return streams, ranges


def marathon_flat(
    values: torch.Tensor,
    num_segments: int,
    segment_length: int,
    max_value: int,
    ranges: torch.Tensor | None = None,
    block_sort=None,
    row_sort=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Emission-ordered ``(value, segment_id)`` stream.  The fused pass by
    default; an explicit per-segment ``block_sort`` takes the pre-fusion
    path (:func:`_marathon_flat_persegment`)."""
    if block_sort is not None:
        return _marathon_flat_persegment(
            values, num_segments, segment_length, max_value, ranges, block_sort
        )
    em = marathon_emission(
        values, num_segments, segment_length, max_value,
        ranges=ranges, row_sort=row_sort,
    )
    return em.values, em.segment_ids


def _marathon_flat_persegment(
    values: torch.Tensor,
    num_segments: int,
    segment_length: int,
    max_value: int,
    ranges: torch.Tensor | None,
    block_sort,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-fusion reference: one Python iteration per segment, each
    segment's stream from its own ``block_sort`` call."""
    values = values.to(torch.int64)
    dev = values.device
    if ranges is None:
        ranges = set_ranges(max_value, num_segments, device=dev)
    seg = segment_of(values, ranges)
    L = segment_length
    streams = [block_sort(values[seg == s], L) for s in range(num_segments)]
    _order, counts, _starts, ranks = rank_within_segment(seg, num_segments)
    emit_mask = ranks >= L
    emit_sids = seg[emit_mask]
    emit_idx = ranks[emit_mask] - L
    out_v = torch.empty(emit_sids.numel(), dtype=torch.int64, device=dev)
    for s in range(num_segments):
        m = emit_sids == s
        out_v[m] = streams[s][emit_idx[m]]
    flush_v, flush_s = [], []
    for s, c in enumerate(counts.tolist()):
        tail = streams[s][max(c - L, 0):]
        flush_v.append(tail)
        flush_s.append(torch.full((tail.numel(),), s, dtype=torch.int64, device=dev))
    return torch.cat([out_v, *flush_v]), torch.cat([emit_sids, *flush_s])
