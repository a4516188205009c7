"""Flows: storage servers feeding one switch, with seeded arrival models.

Counterpart of :mod:`repro.net.flow`.  Every arrival model is a *packet
schedule* -- the sequence of ``(flow index, packet index)`` link grants --
computed on the host with numpy's ``default_rng`` exactly as the reference
computes it (a torch generator would give other bits), over the packet
counts only.  :func:`interleave_batch` then moves the schedule to the keys'
device and materializes the wire with one ragged gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .packet import DEFAULT_PAYLOAD, UNTAGGED, Packet, packetize
from .wire import WireBatch, ragged_gather


@dataclasses.dataclass(frozen=True)
class Flow:
    """One storage server's outbound stream."""

    flow_id: int
    values: torch.Tensor = dataclasses.field(compare=False)
    payload_size: int = DEFAULT_PAYLOAD

    def __post_init__(self) -> None:
        object.__setattr__(self, "values", self.values.to(torch.int64))
        if self.payload_size <= 0:
            raise ValueError("payload_size must be positive")

    @property
    def num_packets(self) -> int:
        return -(-int(self.values.numel()) // self.payload_size)

    def packets(self) -> list[Packet]:
        return packetize(self.values, self.payload_size, flow_id=self.flow_id)


def split_flows(
    values: torch.Tensor,
    num_flows: int,
    payload_size: int = DEFAULT_PAYLOAD,
) -> list[Flow]:
    """Shard one dataset across ``num_flows`` storage servers: contiguous
    shards, the first ``n % num_flows`` one key longer (``np.array_split``)."""
    if num_flows <= 0:
        raise ValueError("num_flows must be positive")
    shards = torch.tensor_split(values.to(torch.int64), num_flows)
    return [Flow(f, shard, payload_size) for f, shard in enumerate(shards)]


# ---------------------------------------------------------------------------
# Packet schedules (host numpy, byte-identical to the reference's)
# ---------------------------------------------------------------------------


def _np_ragged_arange(sizes: np.ndarray) -> np.ndarray:
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)


def _schedule_round_robin(
    counts: np.ndarray, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Turn-major fair order: packet ``t`` of every live flow, flows in
    index order."""
    del seed
    flows = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    pkts = _np_ragged_arange(counts)
    order = np.lexsort((flows, pkts))
    return flows[order], pkts[order]


def _schedule_bursty(
    counts: np.ndarray, seed: int = 0, mean_burst: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """Geometric bursts: a flow holds the link for ~``mean_burst`` packets."""
    rng = np.random.default_rng(seed)
    heads = [0] * counts.size
    live = [i for i, c in enumerate(counts) if c]
    grants: list[tuple[int, int, int]] = []
    while live:
        i = live[int(rng.integers(len(live)))]
        burst = 1 + int(rng.geometric(1.0 / max(mean_burst, 1)))
        take = min(burst, int(counts[i]) - heads[i])
        grants.append((i, heads[i], take))
        heads[i] += take
        if heads[i] >= counts[i]:
            live.remove(i)
    if not grants:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    takes = np.asarray([g[2] for g in grants], dtype=np.int64)
    flows = np.repeat([g[0] for g in grants], takes)
    pkts = np.repeat([g[1] for g in grants], takes) + _np_ragged_arange(takes)
    return flows, pkts


def _schedule_weighted_fair(
    counts: np.ndarray, seed: int = 0, weights: list[float] | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Weighted fair queueing: draw the next transmitting flow by weight."""
    rng = np.random.default_rng(seed)
    if weights is None:
        weights = [2.0 ** (-i) for i in range(counts.size)]
    w = np.asarray(weights, dtype=np.float64)
    heads = [0] * counts.size
    live = [i for i, c in enumerate(counts) if c]
    flows: list[int] = []
    pkts: list[int] = []
    while live:
        wl = w[live] / w[live].sum()
        i = live[int(rng.choice(len(live), p=wl))]
        flows.append(i)
        pkts.append(heads[i])
        heads[i] += 1
        if heads[i] >= counts[i]:
            live.remove(i)
    return np.asarray(flows, dtype=np.int64), np.asarray(pkts, dtype=np.int64)


_SCHEDULES = {
    "round_robin": _schedule_round_robin,
    "bursty": _schedule_bursty,
    "weighted_fair": _schedule_weighted_fair,
}


def interleave_batch(
    flows: list[Flow], mode: str = "round_robin", seed: int = 0, **kw
) -> WireBatch:
    """Merge all flows into one arrival-ordered wire batch: the schedule's
    packet grants expand to per-key source indices into the concatenation
    of the flows' shards, one gather on the keys' device."""
    try:
        schedule = _SCHEDULES[mode]
    except KeyError:
        raise ValueError(
            f"unknown interleave {mode!r}; options: {sorted(_SCHEDULES)}"
        ) from None
    if not flows:
        raise ValueError("interleave_batch needs at least one flow")
    dev = flows[0].values.device
    counts = np.asarray([f.num_packets for f in flows], dtype=np.int64)
    F, J = schedule(counts, seed=seed, **kw)
    sizes = np.asarray([f.values.numel() for f in flows], dtype=np.int64)
    payloads = np.asarray([f.payload_size for f in flows], dtype=np.int64)
    ids = np.asarray([f.flow_id for f in flows], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pkt_sizes = np.minimum(payloads[F], sizes[F] - J * payloads[F])
    n = int(pkt_sizes.sum())

    def _t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    pkt_sizes_t = _t(pkt_sizes)
    src = ragged_gather(_t(offsets[F] + J * payloads[F]), pkt_sizes_t, n)
    all_values = torch.cat([f.values for f in flows])
    return WireBatch(
        all_values[src],
        torch.repeat_interleave(_t(ids[F]), pkt_sizes_t, output_size=n),
        torch.repeat_interleave(_t(J), pkt_sizes_t, output_size=n),
        torch.full((n,), UNTAGGED, dtype=torch.int64, device=dev),
        flow_sizes=tuple(zip(ids.tolist(), sizes.tolist())),
    )


# ---------------------------------------------------------------------------
# Packet-list views (the reference's list forms, over the same schedules)
# ---------------------------------------------------------------------------


def interleave(
    flows: list[Flow], mode: str = "round_robin", seed: int = 0, **kw
) -> list[Packet]:
    """Merge all flows into one arrival-ordered packet stream (list view of
    :func:`interleave_batch`: the same schedule, one :class:`Packet` a grant)."""
    try:
        schedule = _SCHEDULES[mode]
    except KeyError:
        raise ValueError(
            f"unknown interleave {mode!r}; options: {sorted(_SCHEDULES)}"
        ) from None
    counts = np.asarray([f.num_packets for f in flows], dtype=np.int64)
    F, J = schedule(counts, seed=seed, **kw)
    per_flow = [f.packets() for f in flows]
    return [per_flow[f][j] for f, j in zip(F.tolist(), J.tolist())]


def round_robin(flows: list[Flow], seed: int = 0) -> list[Packet]:
    """One packet per flow per turn until all flows drain."""
    return interleave(flows, "round_robin", seed=seed)


def bursty(flows: list[Flow], seed: int = 0, mean_burst: int = 4) -> list[Packet]:
    """Geometric bursts: a flow holds the link for ~``mean_burst`` packets."""
    return interleave(flows, "bursty", seed=seed, mean_burst=mean_burst)


def weighted_fair(
    flows: list[Flow], seed: int = 0, weights: list[float] | None = None
) -> list[Packet]:
    """Weighted fair queueing: draw the next transmitting flow by weight."""
    return interleave(flows, "weighted_fair", seed=seed, weights=weights)


INTERLEAVES = {
    "round_robin": round_robin,
    "bursty": bursty,
    "weighted_fair": weighted_fair,
}
