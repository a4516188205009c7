"""Per-link network timing: latency, bandwidth tokens, bounded buffers, loss.

Counterpart of :mod:`repro.net.timing` (M15).  The clock ticks once per key
at storage line rate; every link has a :class:`LinkSpec` -- propagation
``latency``, a bandwidth budget of ``rate_numer`` keys per ``rate_denom``
ticks, a bounded output buffer of ``buffer_packets`` slots with a ``"drop"``
(NACK and replay after an exponential backoff) or ``"backpressure"`` (stall)
overflow policy, wire ``loss_rate`` and ``dup_rate`` -- and a hop emits its
output packets paced by its arrivals (cut-through: output packet ``p`` ships
once its ship-emission index's arrival has landed, plus ``switch_latency``).

The model is a host event simulation (a heap, one numpy ``default_rng``
draw per packet decision) and stays on numpy, draw for draw the reference's,
so the same seed gives the same ticks, order and counters.  Interior links
run a per-link ARQ (:func:`resequence`): loss and reordering there cost time,
never content.  The egress link delivers the raw wire -- duplicates and late
retransmits included -- which the servers' recovery mode heals.

:class:`GraphTimer` is the overlay :func:`repro_torch.net.topology.run_graph`
(and the device epoch's observed replay) drives beside the hops.  It reads
each hop's packet sizes and ship indices to the host once per hop, keeps
them itself (the fabric frees a hop's output once its consumer merged it),
and applies the egress link's order to the egress batch with one device
gather.  It returns the delivered batch and a :class:`NetworkReport`.  Under
the fault plane it applies the epoch's link flaps (``link_override``), takes
the rehashed ingress groups of a dead ingress hop (``ingress_group``) and
follows the effective parents of a rerouted hop (``after_hop(parents=)``).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ..obs.trace import NULL_TRACER
from .wire import WireBatch, ragged_gather

#: Buffer-overflow policies a link can run.
POLICIES = ("drop", "backpressure")


# ---------------------------------------------------------------------------
# Link and network configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One link's budget.  The default is the ideal link: zero latency,
    infinite bandwidth, unbounded buffer, lossless — byte- and
    tick-transparent, so ``NetworkConfig()`` reproduces the timeless
    pipeline exactly."""

    latency: int = 0  # propagation delay, ticks (firesim LINKLATENCY)
    rate_numer: int | None = None  # keys per rate_denom ticks; None = infinite
    rate_denom: int = 1
    buffer_packets: int | None = None  # output-buffer slots; None = unbounded
    policy: str = "drop"  # overflow policy: "drop" (NACK+replay) | "backpressure"
    loss_rate: float = 0.0  # per-attempt wire loss probability
    dup_rate: float = 0.0  # spurious-retransmit (lost-ACK) duplicate probability
    rto: int | None = None  # retransmit timeout, ticks; None = 2*latency + 4
    max_attempts: int = 8  # replay budget: the last attempt always lands

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; options: {POLICIES}"
            )
        if self.latency < 0:
            raise ValueError("latency must be >= 0")
        if self.rate_numer is not None and self.rate_numer <= 0:
            raise ValueError("rate_numer must be positive (None = infinite)")
        if self.rate_denom <= 0:
            raise ValueError("rate_denom must be positive")
        if self.buffer_packets is not None and self.buffer_packets < 1:
            raise ValueError("buffer_packets must be >= 1 (None = unbounded)")
        for name in ("loss_rate", "dup_rate"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]")
        if self.rto is not None and self.rto < 1:
            raise ValueError("rto must be >= 1 tick")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    @property
    def is_ideal(self) -> bool:
        """Tick- and byte-transparent: the link adds nothing at all."""
        return (
            self.latency == 0
            and self.rate_numer is None
            and self.buffer_packets is None
            and self.loss_rate == 0.0
            and self.dup_rate == 0.0
        )

    @property
    def effective_rto(self) -> int:
        """NACK/timeout before a replay re-offer: one round trip plus slack."""
        return self.rto if self.rto is not None else 2 * self.latency + 4

    def backoff(self, attempt: int) -> int:
        """Retransmit delay before re-offer number ``attempt + 1``:
        exponential, ``rto * 2**attempt``, capped at ``8 * rto`` (a NACK
        storm stretches, a single loss still retries after one timeout —
        attempt 0 backs off exactly ``rto``, same as the old fixed delay)."""
        rto = self.effective_rto
        return min(rto << min(attempt, 3), 8 * rto)

    def transmission_ticks(self, sizes: np.ndarray) -> np.ndarray:
        """Serializer occupancy per packet: ``ceil(keys * denom / numer)``,
        clamped to ≥1 tick — an empty packet (heartbeat/epoch marker) still
        occupies the serializer for a slot, so it cannot bypass the
        bandwidth token or slip through a full bounded buffer for free.
        The infinite-rate branch stays at zero (the ideal-network anchor)."""
        sizes = np.asarray(sizes, dtype=np.int64)
        if self.rate_numer is None:
            return np.zeros(sizes.size, dtype=np.int64)
        return np.maximum(-(-(sizes * self.rate_denom) // self.rate_numer), 1)


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """The fabric-wide timing model: one default :class:`LinkSpec` with
    optional ingress/egress overrides, a per-hop processing delay, and the
    tick→wall-clock conversion.  The all-defaults config is the ideal
    network — the regression anchor."""

    link: LinkSpec = LinkSpec()  # hop-to-hop uplinks (and the fallback)
    ingress: LinkSpec | None = None  # storage → ingress-hop links
    egress: LinkSpec | None = None  # last hop → compute server link (raw wire)
    switch_latency: int = 0  # per-hop processing delay, ticks
    seed: int = 0  # loss/duplication RNG (one stream, link order)
    tick_ns: float = 10.0  # wall-clock per tick (1 key/tick ≈ 100M keys/s)

    def __post_init__(self) -> None:
        if self.switch_latency < 0:
            raise ValueError("switch_latency must be >= 0")
        if self.tick_ns <= 0:
            raise ValueError("tick_ns must be positive")

    def link_for(self, kind: str) -> LinkSpec:
        """The spec governing a link class: ``ingress``/``egress`` override
        the fabric default when set."""
        if kind == "ingress" and self.ingress is not None:
            return self.ingress
        if kind == "egress" and self.egress is not None:
            return self.egress
        return self.link

    @property
    def is_ideal(self) -> bool:
        return (
            self.switch_latency == 0
            and all(
                self.link_for(kind).is_ideal
                for kind in ("ingress", "fabric", "egress")
            )
        )


# ---------------------------------------------------------------------------
# One link
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinkStats:
    """Per-link counters (the loss/retransmit/stall observability plane)."""

    name: str
    packets: int = 0  # distinct packets offered to the link
    keys: int = 0
    delivered: int = 0  # deliveries, including wire duplicates
    drops_overflow: int = 0  # output-buffer overflows (drop policy)
    drops_wire: int = 0  # packets lost on the wire
    retransmits: int = 0  # replay-buffer re-offers (NACK or timeout)
    duplicates: int = 0  # spurious duplicates delivered
    coalesced: int = 0  # duplicates fused with their original at delivery
    forced: int = 0  # replay budget exhausted: admitted by stalling instead
    stall_ticks: int = 0  # backpressure (and forced-admission) wait, summed
    buffer_high_water: int = 0  # peak output-buffer occupancy, packets
    first_arrival: int = 0
    last_arrival: int = 0  # the link's contribution to the makespan


@dataclasses.dataclass
class LinkResult:
    """What a link delivered: ``order[j]`` is the offered packet index of
    the ``j``-th arrival (arrival-tick order; indices repeat under
    ``dup_rate``), ``ticks[j]`` its arrival tick."""

    order: np.ndarray
    ticks: np.ndarray
    stats: LinkStats


def simulate_link(
    sizes: np.ndarray,
    ready: np.ndarray,
    spec: LinkSpec,
    *,
    rng: np.random.Generator | None = None,
    name: str = "link",
) -> LinkResult:
    """Run one link's token schedule over packets of ``sizes`` keys that
    become ready at ``ready`` ticks.

    The serializer sends one packet at a time (``transmission_ticks``
    each); a packet occupies an output-buffer slot from admission until it
    fully departs, and arrives ``latency`` ticks after departing.  Overflow
    follows ``spec.policy``; wire loss and duplication draw from ``rng``.
    A packet's last replay attempt always lands (the budget caps NACK
    storms), so every offered packet is delivered at least once — loss
    costs time, never keys.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    ready = np.asarray(ready, dtype=np.int64)
    n = int(sizes.size)
    stats = LinkStats(name=name, packets=n, keys=int(sizes.sum()))
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return LinkResult(z, z, stats)
    lossless_passthrough = (
        spec.rate_numer is None
        and spec.buffer_packets is None
        and spec.loss_rate == 0.0
        and spec.dup_rate == 0.0
    )
    if lossless_passthrough:
        ticks = ready + spec.latency
        order = (
            np.arange(n, dtype=np.int64)
            if np.all(ticks[1:] >= ticks[:-1])
            else np.argsort(ticks, kind="stable").astype(np.int64)
        )
        ticks = ticks[order]
        stats.delivered = n
        stats.buffer_high_water = 1
        stats.first_arrival = int(ticks[0])
        stats.last_arrival = int(ticks[-1])
        return LinkResult(order, ticks, stats)

    rng = rng or np.random.default_rng(0)
    trans = spec.transmission_ticks(sizes)
    rto = spec.effective_rto
    # (offer tick, FIFO tiebreak, packet, attempt); initial offers keep the
    # caller's order among equal ticks, replays queue behind them.
    heap: list[tuple[int, int, int, int]] = [
        (int(ready[i]), i, i, 0) for i in range(n)
    ]
    heapq.heapify(heap)
    counter = n
    clock = 0  # the port's monotone admission clock
    free_at = 0  # serializer busy until
    occupants: list[int] = []  # departure ticks of buffered packets
    deliveries: list[tuple[int, int, int]] = []
    seq = 0
    while heap:
        t, _, i, attempt = heapq.heappop(heap)
        if t < clock:
            t = clock
        while occupants and occupants[0] <= t:
            heapq.heappop(occupants)
        if (
            spec.buffer_packets is not None
            and len(occupants) >= spec.buffer_packets
        ):
            if spec.policy == "drop" and attempt + 1 < spec.max_attempts:
                stats.drops_overflow += 1
                stats.retransmits += 1
                heapq.heappush(
                    heap, (t + spec.backoff(attempt), counter, i, attempt + 1)
                )
                counter += 1
                continue
            # Backpressure — or a drop link whose replay budget ran out
            # (keys must never vanish): wait for the head-of-line departure.
            t2 = heapq.heappop(occupants)
            if t2 > t:
                stats.stall_ticks += t2 - t
                t = t2
            if spec.policy == "drop":
                stats.forced += 1
        clock = t
        start = t if t > free_at else free_at
        depart = start + int(trans[i])
        free_at = depart
        heapq.heappush(occupants, depart)
        if len(occupants) > stats.buffer_high_water:
            stats.buffer_high_water = len(occupants)
        if (
            spec.loss_rate > 0.0
            and attempt + 1 < spec.max_attempts
            and rng.random() < spec.loss_rate
        ):
            stats.drops_wire += 1
            stats.retransmits += 1
            heapq.heappush(
                heap, (depart + spec.backoff(attempt), counter, i, attempt + 1)
            )
            counter += 1
            continue
        arrival = depart + spec.latency
        deliveries.append((arrival, seq, i))
        seq += 1
        if spec.dup_rate > 0.0 and rng.random() < spec.dup_rate:
            stats.duplicates += 1
            deliveries.append((arrival + max(rto, 1), seq, i))
            seq += 1
    deliveries.sort()
    order = np.fromiter((d[2] for d in deliveries), np.int64, len(deliveries))
    ticks = np.fromiter((d[0] for d in deliveries), np.int64, len(deliveries))
    stats.delivered = len(deliveries)
    stats.first_arrival = int(ticks[0])
    stats.last_arrival = int(ticks[-1])
    return LinkResult(order, ticks, stats)


def resequence(n: int, result: LinkResult) -> np.ndarray:
    """Per-link ARQ at the receiving hop: in-order release ticks.

    The receiver discards duplicates (only a packet's first arrival counts)
    and holds early packets until every predecessor has landed, so packet
    ``i`` is released at ``max(arrival[j] for j <= i)`` — reordering and
    loss cost time, never content.
    """
    first = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(first, result.order, result.ticks)
    return np.maximum.accumulate(first)


# ---------------------------------------------------------------------------
# Whole-fabric report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NetworkReport:
    """Every link's stats plus the network makespan (last egress arrival)."""

    links: list[LinkStats]
    makespan_ticks: int
    config: NetworkConfig

    def _total(self, field: str) -> int:
        return sum(getattr(s, field) for s in self.links)

    @property
    def drops(self) -> int:
        return self._total("drops_overflow") + self._total("drops_wire")

    @property
    def retransmits(self) -> int:
        return self._total("retransmits")

    @property
    def duplicates(self) -> int:
        return self._total("duplicates")

    @property
    def stall_ticks(self) -> int:
        return self._total("stall_ticks")

    @property
    def seconds(self) -> float:
        """The network makespan on the wall clock (via ``tick_ns``) — what
        the crossover sweep compares against the server makespan."""
        return self.makespan_ticks * self.config.tick_ns * 1e-9


def merge_reports(reports: list[NetworkReport]) -> NetworkReport:
    """Combine per-epoch reports: epochs drain the wire sequentially, so
    makespans add; link stats concatenate (callers prefix names)."""
    if not reports:
        raise ValueError("no reports to merge")
    return NetworkReport(
        links=[st for r in reports for st in r.links],
        makespan_ticks=sum(r.makespan_ticks for r in reports),
        config=reports[0].config,
    )


# ---------------------------------------------------------------------------
# The run_graph overlay
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def packets(batch: WireBatch) -> tuple[np.ndarray, np.ndarray]:
    """Packet starts and sizes of a batch, on the host (one read)."""
    starts = _host(batch.packet_starts()).astype(np.int64)
    return starts, np.diff(np.concatenate([starts, [len(batch)]])).astype(np.int64)


class GraphTimer:
    """Timing overlay driven by :func:`repro_torch.net.topology.run_graph`.

    One instance per graph execution: :meth:`after_hop` is called per node
    in topological order, after the hop ran, to carry per-packet ticks
    through the node's input links and emission pacing;
    :meth:`egress_deliver` then runs the last link raw.  The timer keeps
    every hop's output packet sizes, so the round-robin interleave of a
    node's parents is rebuilt at packet granularity without their batches.
    """

    def __init__(self, graph, batch: WireBatch, network: NetworkConfig, *,
                 tracer=None, metrics=None, link_override=None, ingress_group=None) -> None:
        self._graph = graph
        self._net = network
        self._rng = np.random.default_rng(network.seed)
        self._tr = tracer or NULL_TRACER
        self._metrics = metrics
        # The fault plane's hook: ``link_override(name, spec) -> LinkSpec``
        # applies the epoch's live link flaps to the named link.
        self._override = link_override
        self.links: list[LinkStats] = []
        H = len(graph.nodes)
        self._out_ticks: list[np.ndarray | None] = [None] * H
        self._out_sizes: list[np.ndarray | None] = [None] * H
        self._egress_ready: np.ndarray | None = None
        # Storage clock: the aggregated arrival stream injects one key per
        # tick, so a packet is ready when its last key has left storage.
        starts_d = batch.packet_starts()
        starts = _host(starts_d).astype(np.int64)
        sizes = np.diff(np.concatenate([starts, [len(batch)]])).astype(np.int64)
        self._arr_sizes = sizes
        if not starts.size:
            grp = np.zeros(0, dtype=np.int64)
        elif ingress_group is not None:
            # A fault reroute: the rehashed group of each row (constant
            # within a packet: the rehash keys on the flow).
            grp = _host(ingress_group[starts_d]).astype(np.int64)
        else:
            grp = _host(batch.flow_id[starts_d]) % graph.num_groups
        self._arr_ready = np.cumsum(sizes) - 1 if sizes.size else sizes
        self._arr_group = grp

    def _link(self, kind: str, name: str) -> LinkSpec:
        """The spec of one named link: the class default with any link
        flap of the fault plane applied on top."""
        spec = self._net.link_for(kind)
        if self._override is not None:
            spec = self._override(name, spec)
        return spec

    def _record(self, res: LinkResult) -> None:
        st = res.stats
        self.links.append(st)
        if self._metrics is not None:
            m = self._metrics
            m.counter("link_drops_overflow", st.name).inc(st.drops_overflow)
            m.counter("link_drops_wire", st.name).inc(st.drops_wire)
            m.counter("link_retransmits", st.name).inc(st.retransmits)
            m.counter("link_duplicates", st.name).inc(st.duplicates)
            m.counter("link_stall_ticks", st.name).inc(st.stall_ticks)
            m.gauge("link_buffer_high_water", st.name).high_water(st.buffer_high_water)
        if self._tr.enabled:
            self._tr.instant(
                f"link:{st.name}", cat="net",
                packets=st.packets, delivered=st.delivered,
                drops=st.drops_overflow + st.drops_wire,
                retransmits=st.retransmits, duplicates=st.duplicates,
                stall_ticks=st.stall_ticks, last_arrival=st.last_arrival,
            )

    def after_hop(self, i: int, node, out_sizes: np.ndarray, ship, *, parents=None) -> None:
        """Carry ticks through node ``i``: input-link delivery, emission
        pacing, and (for every node but the egress) the uplink to its
        consumer.  ``out_sizes`` are the hop's output packet sizes in wire
        order (host), ``ship`` their ship-emission indices
        (``HopStats.ship_emission``, read to the host here if it is not
        there).  ``parents`` replaces the node's declared parents with the
        effective ones when the fault plane rerouted around a dead hop: the
        tick interleave follows the dataflow the merge followed."""
        out_sizes = np.asarray(out_sizes, dtype=np.int64)
        if node.parents:
            # The round-robin merge interleaves parents one packet per turn:
            # rebuild it at packet granularity to carry each parent packet's
            # delivery tick (and size) to its merged position.
            plist = node.parents if parents is None else parents
            par = [p for p in plist if self._out_sizes[p].size]
            if not par:
                in_ticks = in_sizes = np.zeros(0, dtype=np.int64)
            elif len(par) == 1:
                in_ticks, in_sizes = self._out_ticks[par[0]], self._out_sizes[par[0]]
            else:
                counts = [int(self._out_sizes[p].size) for p in par]
                turn = np.concatenate([np.arange(c, dtype=np.int64) for c in counts])
                src = np.repeat(np.arange(len(par), dtype=np.int64), counts)
                order = np.lexsort((src, turn))
                in_ticks = np.concatenate([self._out_ticks[p] for p in par])[order]
                in_sizes = np.concatenate([self._out_sizes[p] for p in par])[order]
        else:
            pmask = self._arr_group == node.group
            res = simulate_link(
                self._arr_sizes[pmask], self._arr_ready[pmask],
                self._link("ingress", f"ingress:{node.name}"), rng=self._rng,
                name=f"ingress:{node.name}",
            )
            self._record(res)
            in_ticks = resequence(int(pmask.sum()), res)
            in_sizes = self._arr_sizes[pmask]
        # Emission pacing (cut-through): output packet p ships once its
        # ship-emission-index'th arrival has landed, plus processing delay.
        key_ticks = np.repeat(in_ticks, in_sizes)
        key_ticks.sort()
        n = int(key_ticks.size)
        ship = _host(ship).astype(np.int64)
        if ship.size != out_sizes.size:
            raise AssertionError(
                f"hop {node.name!r}: {ship.size} ship indices for "
                f"{out_sizes.size} output packets"
            )
        if n:
            ready_out = key_ticks[np.minimum(ship, n - 1)] + self._net.switch_latency
        else:
            ready_out = np.zeros(len(ship), dtype=np.int64)
        self._out_sizes[i] = out_sizes
        if i < len(self._graph.nodes) - 1:
            res = simulate_link(
                out_sizes, ready_out, self._link("fabric", f"uplink:{node.name}"),
                rng=self._rng, name=f"uplink:{node.name}",
            )
            self._record(res)
            self._out_ticks[i] = resequence(int(ready_out.size), res)
        else:
            self._egress_ready = ready_out

    def egress_deliver(self, egress: WireBatch) -> tuple[WireBatch, "NetworkReport"]:
        """Run the last-hop->server link raw: the delivered batch carries the
        wire's actual packet order, duplicates included (one device gather
        applies it); the servers' recovery mode makes it sortable again."""
        starts, sizes = packets(egress)
        ready = (
            self._egress_ready
            if self._egress_ready is not None
            else np.zeros(0, dtype=np.int64)
        )
        res = simulate_link(sizes, ready, self._link("egress", "egress"),
                            rng=self._rng, name="egress")
        order, ticks = res.order, res.ticks
        if order.size:
            # Two adjacent copies of one packet would fuse into one
            # double-length packet in the columnar wire (boundaries are
            # header runs): deliver only the first copy.
            keep = np.ones(order.size, dtype=bool)
            keep[1:] = order[1:] != order[:-1]
            fused = int(order.size - int(keep.sum()))
            if fused:
                res.stats.coalesced += fused
                res.stats.delivered -= fused
                order, ticks = order[keep], ticks[keep]
        self._record(res)
        dev = egress.device
        sel_sizes = sizes[order]
        delivered = egress.take(
            ragged_gather(
                torch.from_numpy(starts[order]).to(dev),
                torch.from_numpy(sel_sizes).to(dev),
                int(sel_sizes.sum()),
            )
        )
        makespan = int(ticks.max(initial=0))
        return delivered, NetworkReport(
            links=self.links, makespan_ticks=makespan, config=self._net
        )
