"""Columnar wire format: the dataplane's struct-of-tensors packet stream.

Counterpart of :mod:`repro.net.wire`.  A :class:`WireBatch` holds one row per
key -- ``values``, ``flow_id``, ``seq``, ``segment_id``, the optional
payload provenance ``row_index``, the optional INT telemetry stack
``int_meta`` (:class:`~repro_torch.obs.telemetry.IntColumns`) and the
optional owning job ``tenant`` -- as int64 tensors on one device, plus an
``epoch`` tag.  Every row gather applies to the optional columns too, so
they never detach from their keys.  Packet boundaries are the runs of
consecutive rows sharing one ``(flow_id, seq, segment_id)`` header (and one
tenant, where the column is there), exactly as in the reference.

:func:`from_reference` and :meth:`WireBatch.to_numpy` carry a batch across
from the reference's numpy columns and back (duck-typed: nothing of the
reference is imported), which is how the tests hand the same wire to both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..obs.telemetry import INT_FIELDS, IntColumns
from .packet import DEFAULT_PAYLOAD, UNTAGGED, Packet

_COLUMNS = ("values", "flow_id", "seq", "segment_id")


def _total(sizes: torch.Tensor) -> int:
    return int(sizes.sum()) if sizes.numel() else 0


def ragged_arange(sizes: torch.Tensor, total: int | None = None) -> torch.Tensor:
    """``cat([arange(s) for s in sizes])`` without the Python loop."""
    if total is None:
        total = _total(sizes)
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=sizes.device)
    starts = torch.zeros_like(sizes)
    starts[1:] = torch.cumsum(sizes[:-1], 0)
    return torch.arange(total, dtype=torch.int64, device=sizes.device) - torch.repeat_interleave(
        starts, sizes, output_size=total
    )


def ragged_gather(starts: torch.Tensor, sizes: torch.Tensor, total: int | None = None) -> torch.Tensor:
    """Indices of the slices ``[starts[i], starts[i] + sizes[i])``, in order."""
    if total is None:
        total = _total(sizes)
    return torch.repeat_interleave(starts, sizes, output_size=total) + ragged_arange(sizes, total)


@dataclasses.dataclass(frozen=True, eq=False)
class WireBatch:
    """A packet stream as columns; one row per key, wire (arrival) order."""

    values: torch.Tensor  # (n,) int64 keys
    flow_id: torch.Tensor  # (n,) originating storage server / emitting hop
    seq: torch.Tensor  # (n,) per-(flow, segment) packet sequence number
    segment_id: torch.Tensor  # (n,) the paper's port number (UNTAGGED pre-switch)
    epoch: int = 0
    # Payload provenance: the input row of each key; the payload table is
    # gathered once at egress with it.
    row_index: torch.Tensor | None = None
    # Host-side ``(flow_id, keys)`` pairs of the flows that built the batch
    # (set by ``interleave_batch``; any row gather drops them): the device
    # epoch sizes its ingress groups from them without reading the card.
    flow_sizes: tuple[tuple[int, int], ...] | None = None
    # INT per-hop telemetry stack (opt-in; stamped by the fused engine).
    int_meta: IntColumns | None = None
    # Owning job of each key (the multi-tenant plane's demux key), carried
    # at ingress and egress; the hop engines drop it inside the fabric,
    # where tenancy lives in per-tenant segment-id blocks.
    tenant: torch.Tensor | None = None

    def __post_init__(self) -> None:
        for name in _COLUMNS:
            object.__setattr__(self, name, getattr(self, name).to(torch.int64))
        n = self.values.numel()
        dev = self.values.device
        for name in _COLUMNS[1:]:
            col = getattr(self, name)
            if col.numel() != n:
                raise ValueError(f"column {name} length != values length {n}")
            if col.device != dev:
                raise ValueError(f"column {name} is on {col.device}, values on {dev}")
        if self.row_index is not None:
            object.__setattr__(self, "row_index", self.row_index.to(torch.int64))
            if self.row_index.numel() != n:
                raise ValueError(
                    f"row_index length {self.row_index.numel()} != values length {n}"
                )
        if self.int_meta is not None and len(self.int_meta) != n:
            raise ValueError(f"int_meta rows {len(self.int_meta)} != values length {n}")
        if self.tenant is not None:
            object.__setattr__(self, "tenant", self.tenant.to(torch.int64))
            if self.tenant.numel() != n:
                raise ValueError(f"tenant length {self.tenant.numel()} != values length {n}")

    def __len__(self) -> int:
        return int(self.values.numel())

    @property
    def device(self) -> torch.device:
        return self.values.device

    # -- packet-boundary view ------------------------------------------
    def packet_starts(self) -> torch.Tensor:
        """Start index of every packet (a maximal run of one header)."""
        n = len(self)
        if n == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        change = (
            (self.flow_id[1:] != self.flow_id[:-1])
            | (self.seq[1:] != self.seq[:-1])
            | (self.segment_id[1:] != self.segment_id[:-1])
        )
        if self.tenant is not None:
            # Adjacent packets of different jobs may share a header tuple
            # (raw storage traffic is all UNTAGGED) and would fuse.
            change = change | (self.tenant[1:] != self.tenant[:-1])
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        return torch.cat([zero, torch.nonzero(change).reshape(-1) + 1])

    def packet_ordinal(self) -> torch.Tensor:
        """Per-key 0-based index of the packet the key rides in."""
        n = len(self)
        if n == 0:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        starts = self.packet_starts()
        sizes = torch.diff(starts, append=torch.tensor([n], device=self.device))
        ids = torch.arange(starts.numel(), dtype=torch.int64, device=self.device)
        return torch.repeat_interleave(ids, sizes, output_size=n)

    @property
    def num_packets(self) -> int:
        return int(self.packet_starts().numel())

    # -- reshaping ------------------------------------------------------
    def take(self, idx: torch.Tensor) -> "WireBatch":
        """Row gather (boolean mask or index tensor), order-preserving; the
        row column and the INT stack follow their keys."""
        return WireBatch(
            self.values[idx],
            self.flow_id[idx],
            self.seq[idx],
            self.segment_id[idx],
            epoch=self.epoch,
            row_index=None if self.row_index is None else self.row_index[idx],
            int_meta=None if self.int_meta is None else self.int_meta.take(idx),
            tenant=None if self.tenant is None else self.tenant[idx],
        )

    def slice_keys(self, lo: int, hi: int) -> "WireBatch":
        return WireBatch(
            self.values[lo:hi],
            self.flow_id[lo:hi],
            self.seq[lo:hi],
            self.segment_id[lo:hi],
            epoch=self.epoch,
            row_index=None if self.row_index is None else self.row_index[lo:hi],
            int_meta=None if self.int_meta is None else self.int_meta.slice(lo, hi),
            tenant=None if self.tenant is None else self.tenant[lo:hi],
        )

    def with_epoch(self, epoch: int, num_segments: int) -> "WireBatch":
        """Epoch handoff: shift ports into the epoch's virtual id block."""
        return WireBatch(
            self.values,
            self.flow_id,
            self.seq,
            self.segment_id + epoch * num_segments,
            epoch=epoch,
            row_index=self.row_index,
            int_meta=self.int_meta,
            tenant=self.tenant,
        )

    def with_row_index(self, row_index: torch.Tensor | None) -> "WireBatch":
        """The same wire rows carrying a (different) payload row column."""
        return dataclasses.replace(self, row_index=row_index)

    def with_int_meta(self, int_meta: IntColumns | None) -> "WireBatch":
        """The same wire rows carrying a different telemetry stack."""
        return dataclasses.replace(self, int_meta=int_meta)

    def with_tenant(self, tenant) -> "WireBatch":
        """The same wire rows stamped with a tenant column: a scalar job id
        (broadcast down the rows), a per-row tensor, or ``None`` to strip
        it."""
        if tenant is not None and (not isinstance(tenant, torch.Tensor) or tenant.dim() == 0):
            tenant = torch.full((len(self),), int(tenant), dtype=torch.int64, device=self.device)
        return dataclasses.replace(self, tenant=tenant)

    # -- Packet interop -------------------------------------------------
    @classmethod
    def from_packets(cls, packets: list[Packet], epoch: int = 0, device="cuda") -> "WireBatch":
        if not packets:
            return empty_batch(epoch, device=device)
        dev = packets[0].payload.device
        sizes = torch.tensor([p.size for p in packets], dtype=torch.int64, device=dev)

        def _rep(vals):
            return torch.repeat_interleave(
                torch.tensor(vals, dtype=torch.int64, device=dev), sizes
            )

        tenant = None
        if any(p.tenant_id for p in packets):
            tenant = _rep([p.tenant_id for p in packets])
        return cls(
            torch.cat([p.payload for p in packets]),
            _rep([p.flow_id for p in packets]),
            _rep([p.seq for p in packets]),
            _rep([p.segment_id for p in packets]),
            epoch=epoch,
            tenant=tenant,
        )

    def to_packets(self) -> list[Packet]:
        n = len(self)
        bounds = torch.cat(
            [self.packet_starts(), torch.tensor([n], device=self.device)]
        ).tolist()
        heads = torch.tensor(bounds[:-1], dtype=torch.int64, device=self.device)
        flows = self.flow_id[heads].tolist()
        seqs = self.seq[heads].tolist()
        segs = self.segment_id[heads].tolist()
        tens = [0] * len(segs) if self.tenant is None else self.tenant[heads].tolist()
        return [
            Packet(self.values[a:b], f, q, s, tenant_id=t)
            for a, b, f, q, s, t in zip(bounds[:-1], bounds[1:], flows, seqs, segs, tens)
        ]

    # -- crossing from/to the reference's numpy columns -----------------
    def to_numpy(self) -> dict:
        """The batch as numpy columns, under the reference's names."""
        out = {name: getattr(self, name).cpu().numpy() for name in _COLUMNS}
        out["epoch"] = self.epoch
        out["row_index"] = None if self.row_index is None else self.row_index.cpu().numpy()
        out["int_meta"] = (
            None if self.int_meta is None
            else {name: getattr(self.int_meta, name).cpu().numpy() for name in INT_FIELDS}
        )
        out["tenant"] = None if self.tenant is None else self.tenant.cpu().numpy()
        return out


def from_reference(batch, device="cuda") -> WireBatch:
    """The port's :class:`WireBatch` for a reference batch (any object with
    the reference's numpy columns), on ``device``."""
    dev = resolve_device(device)

    def _t(a):  # a copy: the reference freezes some of its arrays
        return torch.from_numpy(np.array(a, dtype=np.int64, order="C")).to(dev)

    row_index = getattr(batch, "row_index", None)
    meta = getattr(batch, "int_meta", None)
    tenant = getattr(batch, "tenant", None)
    return WireBatch(
        *(_t(getattr(batch, name)) for name in _COLUMNS),
        epoch=int(batch.epoch),
        row_index=None if row_index is None else _t(row_index),
        int_meta=None if meta is None else IntColumns(
            **{name: _t(getattr(meta, name)) for name in INT_FIELDS}
        ),
        tenant=None if tenant is None else _t(tenant),
    )


def empty_batch(epoch: int = 0, device="cuda") -> WireBatch:
    z = torch.zeros(0, dtype=torch.int64, device=resolve_device(device))
    return WireBatch(z, z, z, z, epoch=epoch)


def packetize_batch(
    values: torch.Tensor,
    payload_size: int = DEFAULT_PAYLOAD,
    *,
    flow_id: int = 0,
    segment_id: int = UNTAGGED,
    start_seq: int = 0,
) -> WireBatch:
    """Chop a key stream into fixed-size packets as columns."""
    if payload_size <= 0:
        raise ValueError("payload_size must be positive")
    values = values.to(torch.int64)
    n = values.numel()
    dev = values.device
    seq = start_seq + torch.arange(n, dtype=torch.int64, device=dev) // payload_size
    return WireBatch(
        values,
        torch.full((n,), flow_id, dtype=torch.int64, device=dev),
        seq,
        torch.full((n,), segment_id, dtype=torch.int64, device=dev),
    )


def concat_batches(batches: list[WireBatch], device="cuda") -> WireBatch:
    """Concatenate in list order.  The epoch tag survives only if uniform;
    the row column, the INT stack and the tenant column only if every
    key-carrying part has them.  ``device`` is used only for an empty
    list."""
    if not batches:
        return empty_batch(device=device)
    epochs = {b.epoch for b in batches}
    carrying = [b for b in batches if len(b)]
    row_index = None
    if carrying and all(b.row_index is not None for b in carrying):
        row_index = torch.cat([b.row_index for b in carrying])
    int_meta = None
    if carrying and all(b.int_meta is not None for b in carrying):
        int_meta = IntColumns.concat([b.int_meta for b in carrying])
    tenant = None
    if carrying and all(b.tenant is not None for b in carrying):
        tenant = torch.cat([b.tenant for b in carrying])
    return WireBatch(
        *(torch.cat([getattr(b, name) for b in batches]) for name in _COLUMNS),
        epoch=epochs.pop() if len(epochs) == 1 else 0,
        row_index=row_index,
        int_meta=int_meta,
        tenant=tenant,
    )


def merge_round_robin_batches(streams: list[WireBatch], device="cuda") -> WireBatch:
    """One packet per stream per turn: the concatenation of the streams,
    stably sorted by each key's packet ordinal within its stream (the
    reference's ``lexsort((pos, src, turn))``, since the concatenation is
    already in ``(src, pos)`` order)."""
    streams = [s for s in streams if len(s)]
    if not streams:
        return empty_batch(device=device)
    if len(streams) == 1:
        return streams[0]
    turn = torch.cat([s.packet_ordinal() for s in streams])
    order = torch.sort(turn, stable=True).indices
    del turn
    return concat_batches(streams).take(order)


def split_by_flow(batch: WireBatch, num_groups: int) -> list[WireBatch]:
    """Ingress cabling: storage flow ``f`` feeds group ``f % num_groups``."""
    if num_groups <= 0:
        raise ValueError("num_groups must be positive")
    group = batch.flow_id % num_groups
    return [batch.take(group == g) for g in range(num_groups)]


def segment_streams_batch(batch: WireBatch, num_segments: int) -> list[torch.Tensor]:
    """Demux keys by port number into per-segment streams, arrival order."""
    sids = batch.segment_id
    if sids.numel():
        lo, hi = int(sids.min()), int(sids.max())
        if lo < 0 or hi >= num_segments:
            raise ValueError(
                f"packet with untagged/invalid segment {lo if lo < 0 else hi}"
            )
    order = torch.sort(sids, stable=True).indices
    counts = torch.bincount(sids, minlength=num_segments)
    return list(torch.split(batch.values[order], counts.tolist()))
