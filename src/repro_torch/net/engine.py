"""Fused batched hop engine: one pass of tensor ops per switch hop.

Counterpart of :mod:`repro.net.engine` for ``engine="fused"``.  A hop takes a
:class:`~repro_torch.net.wire.WireBatch` and produces the next hop's batch:

1. **route** -- ``segment_of`` over the value column;
2. **rank** -- each arrival's per-segment rank, one stable sort;
3. **row sort** -- every segment's L-blocks as the rows of one padded matrix,
   sorted by kernel K1 in one launch per hop (:func:`row_sort_device`);
4. **emit** -- the exact wire interleave rebuilt with gathers
   (:func:`repro_torch.core.marathon.marathon_emission`);
5. **packetize** -- ship-ordered output packets as column arithmetic.

The reference's ``backend="numpy"|"pallas"`` switch has no counterpart: the
tensors' device decides (a CUDA tensor launches K1, a CPU tensor takes its
plain version).  With ``int_telemetry`` a hop stamps the INT columns
(:mod:`repro_torch.obs.telemetry`) onto its output by each key's exact
provenance.  ``engine="device"`` is the whole-epoch program of
:mod:`repro_torch.net.device_epoch`; the ``segment``/``faithful`` engines
are a later slice (M18) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.marathon import MarathonEmission, marathon_emission
from ..kernels import ops
from ..obs.telemetry import IntColumns
from ..obs.trace import NULL_TRACER
from .packet import DEFAULT_PAYLOAD
from .wire import WireBatch, empty_batch, ragged_arange, ragged_gather

#: Engine names of the reference; "segment" and "faithful" are not ported yet.
ENGINES = ("fused", "segment", "faithful", "device")

_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass(frozen=True)
class HopSpec:
    """Everything a hop needs besides its arrival stream."""

    num_segments: int
    segment_length: int
    max_value: int
    ranges: torch.Tensor = dataclasses.field(compare=False, default=None)
    payload_size: int = DEFAULT_PAYLOAD


def _to_numpy(x):
    return None if x is None else x.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class HopStats:
    """Per-hop observability (paper §6.3 run statistics, per hop)."""

    name: str
    arrivals: int
    segment_loads: torch.Tensor = dataclasses.field(compare=False)
    load_imbalance: float
    emitted_runs: int
    mean_run_len: float
    recirculations: int
    emitted_run_lengths: torch.Tensor | None = dataclasses.field(
        default=None, compare=False, repr=False
    )
    ship_emission: torch.Tensor | None = dataclasses.field(
        default=None, compare=False, repr=False
    )

    @classmethod
    def _from_grouped(cls, name, grouped, counts, segment_length) -> "HopStats":
        """Stats when the emitted stream is already grouped by segment."""
        counts = counts.to(torch.int64)
        dev = counts.device
        S = counts.numel()
        total = int(counts.sum())
        imbalance = int(counts.max()) / (total / S) if total else 1.0
        if total:
            seg_of_pos = torch.repeat_interleave(
                torch.arange(S, device=dev), counts, output_size=total
            )
            brk = torch.empty(total, dtype=torch.bool, device=dev)
            brk[0] = True
            brk[1:] = (grouped[1:] < grouped[:-1]) | (seg_of_pos[1:] != seg_of_pos[:-1])
            starts = torch.nonzero(brk).reshape(-1)
            run_lens = torch.diff(starts, append=torch.tensor([total], device=dev))
        else:
            run_lens = torch.zeros(0, dtype=torch.int64, device=dev)
        runs = int(run_lens.numel())
        L = segment_length
        recirc = int(
            torch.where(
                counts == 0, 0, torch.where((counts <= L) | (counts % L == 0), 1, 2)
            ).sum()
        )
        return cls(
            name=name,
            arrivals=total,
            segment_loads=counts,
            load_imbalance=imbalance,
            emitted_runs=runs,
            mean_run_len=(total / runs) if runs else 0.0,
            recirculations=recirc,
            emitted_run_lengths=run_lens,
        )

    def to_numpy(self) -> dict:
        """The stats with numpy arrays, under the reference's field names."""
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for key in ("segment_loads", "emitted_run_lengths", "ship_emission"):
            out[key] = _to_numpy(out[key])
        return out


# ---------------------------------------------------------------------------
# The row sorter: kernel K1, one launch per hop
# ---------------------------------------------------------------------------


def row_sort_device(mat: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """Sort the hop's block matrix in one K1 launch.

    The reference's key-type rule is kept: when every real key lies in
    ``[0, int32 max)`` the matrix sorts as int32 with the padding turned
    into int32 max; other keys sort as int64 (where the reference fell back
    to ``np.sort`` on the host).  A width that is not a power of two is
    padded up to the next one with the sentinel.  ``row_len`` tells real
    keys from padding by position, so a real key equal to the sentinel is
    still range-checked.  Only the valid prefix of each row is meaningful.
    """
    rows, block = mat.shape
    if rows == 0 or block <= 1:
        return mat.clone()
    real = torch.arange(block, device=mat.device)[None, :] < row_len[:, None]
    lo = int(torch.where(real, mat, torch.iinfo(torch.int64).max).min())
    hi = int(torch.where(real, mat, torch.iinfo(torch.int64).min).max())
    if 0 <= lo and hi < _I32_MAX:
        x = torch.where(real, mat, _I32_MAX).to(torch.int32)
    else:
        x = mat
    del real
    width = 1 << (block - 1).bit_length()
    if width != block:
        pad = torch.full((rows, width - block), torch.iinfo(x.dtype).max,
                         dtype=x.dtype, device=x.device)
        x = torch.cat([x, pad], dim=1)
    out = ops.sort_rows_padded(x.contiguous())
    if width != block:
        out = out[:, :block]
    return out.to(torch.int64)


# ---------------------------------------------------------------------------
# Emission -> wire
# ---------------------------------------------------------------------------


def _wire_from_grouped(grouped, eidx, counts, payload_size, epoch):
    """Ship-order packetization over the segment-grouped emitted stream.

    Each segment's keys fill ``payload_size`` packets tagged with the
    segment id and a per-segment ``seq``; a packet ships at the emission
    index of its last key.  Only the packets are sorted by ship index; the
    keys move in one ragged gather.  Returns ``(batch, idx, ship)`` with
    ``idx[j]`` the position in ``grouped`` of wire row ``j`` and ``ship``
    the (ascending) ship indices of the wire's packets.
    """
    n = int(grouped.numel())
    dev = grouped.device
    counts = counts.to(torch.int64)
    starts = torch.zeros_like(counts)
    starts[1:] = torch.cumsum(counts[:-1], 0)
    P = payload_size
    npk = (counts + P - 1) // P
    n_pk = int(npk.sum())
    pkt_sid = torch.repeat_interleave(
        torch.arange(counts.numel(), dtype=torch.int64, device=dev), npk, output_size=n_pk
    )
    pkt_j = ragged_arange(npk, n_pk)
    pkt_off = pkt_j * P
    pkt_sz = torch.clamp(counts[pkt_sid] - pkt_off, max=P)
    ship = eidx[starts[pkt_sid] + pkt_off + pkt_sz - 1]
    ship, porder = torch.sort(ship)
    sz = pkt_sz[porder]
    idx = ragged_gather((starts[pkt_sid] + pkt_off)[porder], sz, n)
    batch = WireBatch(
        grouped[idx],
        torch.zeros(n, dtype=torch.int64, device=dev),
        torch.repeat_interleave(pkt_j[porder], sz, output_size=n),
        torch.repeat_interleave(pkt_sid[porder], sz, output_size=n),
        epoch=epoch,
    )
    return batch, idx, ship


def _emission_wire(values, sids, num_segments, payload_size, epoch=0):
    """:func:`emission_to_wire` plus the per-packet ship-emission indices."""
    n = int(values.numel())
    if n == 0:
        return (
            empty_batch(epoch, device=values.device),
            torch.zeros(0, dtype=torch.int64, device=values.device),
        )
    counts = torch.bincount(sids, minlength=num_segments)
    eidx = torch.sort(sids, stable=True).indices
    batch, _, ship = _wire_from_grouped(values[eidx], eidx, counts, payload_size, epoch)
    return batch, ship


def emission_to_wire(values, sids, num_segments, payload_size, epoch=0) -> WireBatch:
    """Packetize an emission-ordered ``(values, sids)`` stream into
    ship-ordered wire columns."""
    return _emission_wire(values, sids, num_segments, payload_size, epoch)[0]


# ---------------------------------------------------------------------------
# The fused engine
# ---------------------------------------------------------------------------


def fused_hop(
    batch: WireBatch,
    spec: HopSpec,
    name: str,
    *,
    tracer=None,
    hop_id: int = 0,
    int_telemetry: bool = False,
) -> tuple[WireBatch, HopStats]:
    """The batched engine: route -> rank -> row sort (K1) -> emit ->
    packetize, every stage over all segments at once.  A ``row_index``
    column follows its keys through the hop by their exact provenance.

    With ``int_telemetry`` (or an arrival batch already carrying telemetry)
    the hop stamps INT columns onto the output: for every emitted key this
    hop's id, the count of its segment-mates still resident at emission
    (capped at the 2·L pipeline size) and its insertion rank within its
    segment, carried by the same provenance rows as the payload column."""
    tr = tracer or NULL_TRACER
    dev = batch.device
    em: MarathonEmission = marathon_emission(
        batch.values,
        spec.num_segments,
        spec.segment_length,
        spec.max_value,
        ranges=spec.ranges,
        row_sort=row_sort_device,
        tracer=tracer,
    )
    with tr.span("stats", cat="stage"):
        stats = HopStats._from_grouped(name, em.streams, em.counts, spec.segment_length)
    want_int = int_telemetry or batch.int_meta is not None
    if len(batch) == 0:
        out = empty_batch(batch.epoch, device=dev)
        if want_int:
            depth = 0 if batch.int_meta is None else batch.int_meta.depth
            out = out.with_int_meta(IntColumns.empty(0, depth + 1, device=dev))
        if batch.row_index is not None:
            out = out.with_row_index(torch.zeros(0, dtype=torch.int64, device=dev))
        stats = dataclasses.replace(
            stats, ship_emission=torch.zeros(0, dtype=torch.int64, device=dev)
        )
        return out, stats
    with tr.span("packetize", cat="stage"):
        n = len(batch)
        eidx = torch.empty(n, dtype=torch.int64, device=dev)
        eidx[em.slots] = torch.arange(n, dtype=torch.int64, device=dev)
        out, idx, ship = _wire_from_grouped(
            em.streams, eidx, em.counts, spec.payload_size, batch.epoch
        )
        del eidx
    stats = dataclasses.replace(stats, ship_emission=ship)
    if want_int or batch.row_index is not None:
        in_rows = _provenance_rows(batch, em, idx, spec.segment_length)
        if batch.row_index is not None:
            out = out.with_row_index(batch.row_index[in_rows])
        if want_int:
            with tr.span("int_stamp", cat="stage"):
                out = _stamp_int(batch, em, out, idx, spec, hop_id, in_rows)
    return out, stats


def _stamp_int(batch, em, out, idx, spec: HopSpec, hop_id: int, in_rows) -> WireBatch:
    """Append this hop's INT column, carrying the arrival stack forward.

    ``out.segment_id`` is each wire row's segment, so the occupancy at
    emission -- the segment's keys not yet emitted, capped at 2·L -- is
    column arithmetic over the grouped positions ``idx``."""
    L = spec.segment_length
    sid_out = out.segment_id
    queue_depth = torch.clamp(em.counts[sid_out] - (idx - em.starts[sid_out]), max=2 * L)
    prev = batch.int_meta
    if prev is None:
        prev = IntColumns.empty(len(batch), device=batch.device)
    stack = prev.take(in_rows).stamp(hop_id, queue_depth, em.ranks[in_rows])
    return out.with_int_meta(stack)


def _provenance_rows(batch, em, idx, L) -> torch.Tensor:
    """``in_rows[j]``: the input batch row whose key landed on output wire
    row ``j``.

    The reference lexsorts grouped positions by (segment, block, value,
    position).  Grouped positions already ascend in (segment, position), so
    that order is a stable sort by value followed by a stable sort by block
    (row of the block matrix): two stable device sorts, no packing.
    """
    counts = em.counts
    n = len(batch)
    dev = batch.device
    S = counts.numel()
    seg_of_pos = torch.repeat_interleave(
        torch.arange(S, dtype=torch.int64, device=dev), counts, output_size=n
    )
    pos = torch.arange(n, dtype=torch.int64, device=dev) - em.starts[seg_of_pos]
    nblk = (counts + L - 1) // L
    blk_starts = torch.zeros_like(nblk)
    blk_starts[1:] = torch.cumsum(nblk[:-1], 0)
    block_id = blk_starts[seg_of_pos] + pos // L
    del seg_of_pos, pos
    by_value = torch.sort(batch.values[em.order], stable=True).indices
    src = by_value[torch.sort(block_id[by_value], stable=True).indices]
    del by_value, block_id
    return em.order[src[idx]]


def run_hop(
    batch: WireBatch,
    spec: HopSpec,
    name: str,
    engine: str = "fused",
    *,
    tracer=None,
    hop_id: int = 0,
    int_telemetry: bool = False,
) -> tuple[WireBatch, HopStats]:
    """Dispatch one hop through the named engine (``"fused"`` or
    ``"device"``)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown hop engine {engine!r}; options: {sorted(ENGINES)}")
    if engine == "device":
        from .device_epoch import device_hop

        return device_hop(
            batch, spec, name, tracer=tracer, hop_id=hop_id, int_telemetry=int_telemetry
        )
    if engine != "fused":
        raise NotImplementedError(
            f"hop engine {engine!r} is not ported yet (later slice: M18, the "
            "baseline engines); use 'fused' or 'device'"
        )
    return fused_hop(
        batch, spec, name, tracer=tracer, hop_id=hop_id, int_telemetry=int_telemetry
    )

