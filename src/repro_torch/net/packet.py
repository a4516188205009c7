"""Packetized key streams -- the paper's wire format (§4.1, Fig. 2).

Counterpart of :mod:`repro.net.packet`: a ``Packet`` is (payload, flow_id,
seq, segment_id, tenant_id), its payload an int64 tensor.  The dataplane proper moves
columnar :class:`repro_torch.net.wire.WireBatch` tensors; packets are the
boundary view.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device

# segment_id of a packet that has not traversed a switch yet.
UNTAGGED = -1

DEFAULT_PAYLOAD = 64


@dataclasses.dataclass(frozen=True)
class Packet:
    """One wire packet: ``payload_size`` (or fewer, for the tail) keys."""

    payload: torch.Tensor = dataclasses.field(compare=False)
    flow_id: int  # originating storage server / emitting hop
    seq: int  # per-(flow, segment) emission sequence number
    segment_id: int = UNTAGGED  # the paper's port number; set by the switch
    tenant_id: int = 0  # owning job; the per-tenant demux key at egress

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "payload", torch.as_tensor(self.payload).to(torch.int64)
        )

    @property
    def size(self) -> int:
        return int(self.payload.numel())


def packetize(
    values: torch.Tensor,
    payload_size: int = DEFAULT_PAYLOAD,
    *,
    flow_id: int = 0,
    segment_id: int = UNTAGGED,
    start_seq: int = 0,
) -> list[Packet]:
    """Chop a key stream into fixed-size packets (ragged tail allowed)."""
    if payload_size <= 0:
        raise ValueError("payload_size must be positive")
    values = values.to(torch.int64)
    return [
        Packet(values[i : i + payload_size], flow_id, start_seq + j, segment_id)
        for j, i in enumerate(range(0, values.numel(), payload_size))
    ]


def depacketize(packets: list[Packet], device="cuda") -> torch.Tensor:
    """Concatenate payloads in list (arrival) order."""
    if not packets:
        return torch.zeros(0, dtype=torch.int64, device=resolve_device(device))
    return torch.cat([p.payload for p in packets])


def merge_round_robin(streams: list[list[Packet]]) -> list[Packet]:
    """Interleave packet streams one packet per stream per turn -- the fair
    link-scheduling order used both for storage flows sharing an ingress
    link and for switch uplinks feeding the next hop."""
    out: list[Packet] = []
    heads = [0] * len(streams)
    while True:
        progressed = False
        for i, q in enumerate(streams):
            if heads[i] < len(q):
                out.append(q[heads[i]])
                heads[i] += 1
                progressed = True
        if not progressed:
            return out


def segment_streams(
    packets: list[Packet], num_segments: int, device="cuda"
) -> list[torch.Tensor]:
    """Demultiplex by port number: per-segment streams in arrival order."""
    buckets: list[list[torch.Tensor]] = [[] for _ in range(num_segments)]
    for p in packets:
        if not 0 <= p.segment_id < num_segments:
            raise ValueError(f"packet with untagged/invalid segment {p.segment_id}")
        buckets[p.segment_id].append(p.payload)
    device = packets[0].payload.device if packets else resolve_device(device)
    return [
        torch.cat(b) if b else torch.zeros(0, dtype=torch.int64, device=device)
        for b in buckets
    ]
