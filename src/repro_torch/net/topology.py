"""Switch fabrics as declarative hop-graphs run by a tiny scheduler.

Counterpart of :mod:`repro.net.topology`.  A :class:`HopGraph` lists
:class:`HopNode` entries in topological order -- ingress nodes fed by a
group of storage flows (``flow_id % num_groups``), interior nodes fed by the
round-robin merge of their parents' uplinks -- and :func:`run_graph` runs
each node through the fused hop engine on device-resident wire batches.
Each hop's output is dropped as soon as its one consumer has merged it, so a
fabric holds at most one level of uplinks at a time.  ``engine="device"``
runs the whole graph as one program
(:func:`repro_torch.net.device_epoch.run_graph_device`).

Observability is opt-in and output-transparent: ``tracer`` wraps every node
in a ``hop:<name>`` span, ``metrics`` accumulates per-hop key counters,
segment-load gauges and the emitted run-length histogram, and
``int_telemetry`` has each hop stamp INT columns.  ``network`` (a
:class:`~repro_torch.net.timing.NetworkConfig`) runs the per-link timing
overlay beside the hops.  ``faults`` (a
:class:`~repro_torch.net.faults.EpochFaults`) runs the fail-open state
machine: dead hops are rerouted around, degraded hops forward in arrival
order (:func:`~repro_torch.net.engine.passthrough_hop`), flapped links take
the fault's loss and latency.
"""

from __future__ import annotations

import dataclasses

import torch

from ..obs.trace import NULL_TRACER
from .engine import HopSpec, HopStats, passthrough_hop, run_hop
from .packet import DEFAULT_PAYLOAD, Packet
from .wire import WireBatch, merge_round_robin_batches, split_by_flow


@dataclasses.dataclass(frozen=True)
class SwitchHop:
    """One programmable switch addressed on its own (the reference's
    ``SwitchHop``): :meth:`process_batch` runs an arrival batch through a
    hop engine; :meth:`process` is the reference's packet-list boundary
    view of it.  The reference's ``backend`` (its block sort's "numpy" or
    "pallas") has no counterpart: the port's block sort is K1 on the card
    and its plain version on the CPU, by the tensors' device."""

    name: str
    num_segments: int
    segment_length: int
    max_value: int
    ranges: torch.Tensor = dataclasses.field(compare=False)
    faithful: bool = False
    payload_size: int = DEFAULT_PAYLOAD
    engine: str | None = None  # None -> "faithful" if faithful else "fused"

    def process_batch(self, batch: WireBatch) -> tuple[WireBatch, HopStats]:
        """Run the arrival batch through MergeMarathon; re-packetize."""
        spec = HopSpec(self.num_segments, self.segment_length, self.max_value, self.ranges,
                       payload_size=self.payload_size)
        return run_hop(batch, spec, self.name, self.engine or ("faithful" if self.faithful else "fused"))

    def process(self, packets: list[Packet]) -> tuple[list[Packet], HopStats]:
        """Packet-list boundary view of :meth:`process_batch`: the packets
        become one wire batch on the hop's own device (``ranges.device``),
        and the hop's output becomes packets again."""
        out, stats = self.process_batch(WireBatch.from_packets(packets, device=self.ranges.device))
        return out.to_packets(), stats


@dataclasses.dataclass(frozen=True)
class HopNode:
    """One switch in a fabric: an ingress group XOR a tuple of parents."""

    name: str
    parents: tuple[int, ...] = ()
    group: int = 0


@dataclasses.dataclass(frozen=True)
class HopGraph:
    """A fabric: nodes in topological order; the last node is the egress."""

    nodes: tuple[HopNode, ...]
    num_groups: int = 1

    def __post_init__(self) -> None:
        if not self.nodes:
            raise ValueError("a fabric needs at least one hop")
        consumed: set[int] = set()
        for i, node in enumerate(self.nodes):
            if any(p >= i or p < 0 for p in node.parents):
                raise ValueError(f"node {node.name!r} has a non-topological parent")
            if not node.parents:
                if not 0 <= node.group < self.num_groups:
                    raise ValueError(f"node {node.name!r} ingress group out of range")
                if node.group in consumed:
                    raise ValueError(
                        f"ingress group {node.group} consumed by more than one hop"
                    )
                consumed.add(node.group)
        missing = set(range(self.num_groups)) - consumed
        if missing:
            raise ValueError(
                f"ingress groups {sorted(missing)} feed no hop; every group "
                f"in [0, {self.num_groups}) needs an ingress node"
            )
        all_parents = [p for node in self.nodes for p in node.parents]
        wired = set(all_parents)
        if len(all_parents) != len(wired):
            dupes = sorted(
                {self.nodes[p].name for p in wired if all_parents.count(p) > 1}
            )
            raise ValueError(
                f"hops {dupes} feed more than one downstream hop; an uplink "
                f"has exactly one consumer"
            )
        orphans = [
            node.name for i, node in enumerate(self.nodes[:-1]) if i not in wired
        ]
        if orphans:
            raise ValueError(
                f"hops {orphans} feed no downstream hop; every node but the "
                f"egress (the last) needs a consumer"
            )


def run_graph(
    graph: HopGraph,
    batch: WireBatch,
    spec: HopSpec,
    engine: str = "fused",
    *,
    tracer=None,
    metrics=None,
    int_telemetry: bool = False,
    network=None,
    faults=None,
):
    """Execute a fabric over an arrival batch; return the egress node's wire
    batch and the per-hop stats in node order.

    With ``network`` the return is ``(delivered, stats, NetworkReport)``:
    the delivered batch is the egress link's raw wire (reordered, with
    retransmit duplicates), which a pool in recovery mode heals.

    ``faults`` (an :class:`~repro_torch.net.faults.EpochFaults`): a dead
    ingress hop's flows rehash onto the alive ingress hops (``flow_id %
    alive``), a dead interior hop's parents hoist into its consumer's
    parent list (round-robin turn order kept), a degraded hop forwards in
    arrival order, and the timing overlay follows the rerouted dataflow.
    Every hop permutes keys only within a segment, so the sorted output is
    byte-identical to the fault-free run.  A dead egress hop, or a plan
    that kills every ingress hop, raises.  ``engine="device"`` under a
    dataplane fault runs the fused engine on the batch's device (the
    program has no health states), traced as ``fault:device_fallback``
    and counted as ``fault_device_fallbacks``."""
    if faults is not None and not faults.any_dataplane:
        faults = None
    tr = tracer or NULL_TRACER
    dev = batch.device
    if engine == "device" and faults is not None:
        engine = "fused"
        # The device engine's table lives on the host; the fused hops route
        # on the batch's device.
        spec = dataclasses.replace(spec, ranges=spec.ranges.to(dev))
        tr.instant("fault:device_fallback", cat="fault", epoch=faults.epoch)
        if metrics is not None:
            metrics.counter("fault_device_fallbacks").inc()
    if engine == "device":
        from .device_epoch import run_graph_device

        return run_graph_device(
            graph, batch, spec,
            tracer=tracer, metrics=metrics, int_telemetry=int_telemetry, network=network,
        )
    states = [
        "healthy" if faults is None else faults.hop_state(node.name) for node in graph.nodes
    ]
    if states[-1] == "dead":
        raise ValueError(
            f"fault plan kills the egress hop {graph.nodes[-1].name!r}; the "
            "delivered stream has no sibling to reroute to — a key-destroying plan"
        )
    parents_of = [node.parents for node in graph.nodes]
    if faults is not None:
        parents_of = _reroute(graph, states, faults, tr, metrics)
    ingress, arr_group = _ingress(graph, batch, states, tr, metrics)
    timer = None
    if network is not None:
        from .timing import GraphTimer, packets

        timer = GraphTimer(
            graph, batch, network, tracer=tracer, metrics=metrics,
            link_override=faults.link_spec if faults is not None and faults.link_faults else None,
            ingress_group=arr_group,
        )
    outs: list[WireBatch | None] = []
    stats: list[HopStats] = []
    for i, node in enumerate(graph.nodes):
        if states[i] == "dead":
            # Its flows entered elsewhere or its parents hoisted to its
            # consumer: it sees nothing, and the overlay never visits it.
            outs.append(None)
            stats.append(_dead_hop_stats(node.name, spec, dev))
            continue
        if node.parents:
            parents = parents_of[i]
            inp = merge_round_robin_batches([outs[p] for p in parents], device=dev)
            for p in parents:
                outs[p] = None  # one consumer per (effective) uplink: free it
        else:
            inp = ingress[node.group]
            ingress[node.group] = None
        degraded = states[i] == "degraded"
        with tr.span(
            f"hop:{node.name}", cat="hop", keys=len(inp),
            **({"degraded": True} if degraded else {}),
        ) as hop_sp:
            if degraded:
                out, st = passthrough_hop(
                    inp, spec, node.name,
                    tracer=tracer, hop_id=i, int_telemetry=int_telemetry,
                )
            else:
                out, st = run_hop(
                    inp, spec, node.name, engine,
                    tracer=tracer, hop_id=i, int_telemetry=int_telemetry,
                )
            hop_sp.set(keys_out=len(out))
        if metrics is not None:
            runs = st.emitted_run_lengths
            if runs is None:  # the segment engine only counts
                runs = _emitted_run_lengths(out)
            record_hop(metrics, node.name, len(inp), len(out), out.num_packets, st, runs)
        del inp
        # Stamp the emitting hop into flow_id so sibling uplinks keep unique
        # packet headers when they interleave at the next hop.
        out = WireBatch(
            out.values,
            torch.full((len(out),), i, dtype=torch.int64, device=dev),
            out.seq,
            out.segment_id,
            epoch=out.epoch,
            row_index=out.row_index,
            int_meta=out.int_meta,
        )
        if timer is not None:
            # Restamping the flow ids moves no packet boundary, so the
            # overlay sees the packets the next hop will; its tick
            # interleave follows the effective parents.
            timer.after_hop(i, node, packets(out)[1], st.ship_emission,
                            parents=parents_of[i] if node.parents else None)
        outs.append(out)
        stats.append(st)
    if timer is not None:
        delivered, report = timer.egress_deliver(outs[-1])
        return delivered, stats, report
    return outs[-1], stats


def _reroute(graph: HopGraph, states: list[str], faults, tr, metrics) -> list[tuple[int, ...]]:
    """Trace and count the epoch's sick hops; return each node's effective
    parents (a dead parent's own effective parents hoisted in its place)."""
    for node, state in zip(graph.nodes, states):
        if state != "healthy":
            tr.instant(f"fault:{node.name}", cat="fault", state=state, epoch=faults.epoch)
            if metrics is not None:
                kind = "fault_hops_dead" if state == "dead" else "fault_hops_degraded"
                metrics.counter(kind, node.name).inc()
    eff: list[tuple[int, ...]] = []
    for node in graph.nodes:
        mine: list[int] = []
        for p in node.parents:
            if states[p] == "dead":
                mine.extend(eff[p])
                tr.instant(f"reroute:{graph.nodes[p].name}->{node.name}", cat="fault",
                           epoch=faults.epoch)
                if metrics is not None:
                    metrics.counter("fault_reroutes", graph.nodes[p].name).inc()
            else:
                mine.append(p)
        eff.append(tuple(mine))
    return eff


def _ingress(graph: HopGraph, batch: WireBatch, states: list[str], tr, metrics):
    """Each ingress group's arrivals, and the per-row group under a reroute
    (``None`` without one): a dead ingress hop's flows rehash onto the
    alive ingress groups, ``alive[flow_id % len(alive)]``."""
    ingress_nodes = [(node.group, state) for node, state in zip(graph.nodes, states)
                     if not node.parents]
    dead = sorted(g for g, state in ingress_nodes if state == "dead")
    if not dead:
        return list(split_by_flow(batch, graph.num_groups)), None
    alive = sorted(g for g, state in ingress_nodes if state != "dead")
    if not alive:
        raise ValueError(
            "fault plan kills every ingress hop; the arrival flows have "
            "nowhere to enter the fabric — a key-destroying plan"
        )
    dev = batch.device
    grp = batch.flow_id % graph.num_groups
    dead_mask = torch.isin(grp, torch.tensor(dead, dtype=torch.int64, device=dev))
    alive_t = torch.tensor(alive, dtype=torch.int64, device=dev)
    grp = torch.where(dead_mask, alive_t[batch.flow_id % len(alive)], grp)
    ingress = [batch.take(grp == g) for g in range(graph.num_groups)]
    tr.instant("reroute:ingress", cat="fault", dead=dead, alive=alive)
    if metrics is not None:
        metrics.counter("fault_reroutes", "ingress").inc(len(dead))
    return ingress, grp


def _dead_hop_stats(name: str, spec: HopSpec, dev) -> HopStats:
    """Zero stats of a crashed hop: it saw nothing and emitted nothing."""
    zero = torch.zeros(0, dtype=torch.int64, device=dev)
    stats = HopStats._from_grouped(
        name, zero, torch.zeros(spec.num_segments, dtype=torch.int64, device=dev),
        spec.segment_length,
    )
    return dataclasses.replace(stats, ship_emission=zero)


def _emitted_run_lengths(out: WireBatch) -> torch.Tensor:
    """Lengths of the maximal ascending runs of each segment's emitted
    sub-stream (for engines whose stats carry none)."""
    n = len(out)
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=out.device)
    order = torch.sort(out.segment_id, stable=True).indices
    vals, segs = out.values[order], out.segment_id[order]
    brk = torch.ones(n, dtype=torch.bool, device=out.device)
    brk[1:] = (vals[1:] < vals[:-1]) | (segs[1:] != segs[:-1])
    starts = torch.nonzero(brk).reshape(-1)
    return torch.diff(starts, append=torch.tensor([n], device=out.device))


def record_hop(metrics, name: str, keys_in: int, keys_out: int, packets_out: int,
               st: HopStats, run_lengths) -> None:
    """One hop's counters, gauges and emitted run-length histogram, as the
    reference's ``run_graph`` records them."""
    metrics.counter("hop_keys_in", name).inc(keys_in)
    metrics.counter("hop_keys_out", name).inc(keys_out)
    metrics.counter("hop_packets_out", name).inc(packets_out)
    metrics.counter("hop_recirculations", name).inc(st.recirculations)
    metrics.gauge("hop_segment_loads", name).set(st.segment_loads)
    metrics.gauge("hop_load_imbalance", name).set(st.load_imbalance)
    metrics.histogram("hop_emitted_run_length", name).observe_many(run_lengths)


def single_graph() -> HopGraph:
    """Fig. 1: storage -> one switch -> compute."""
    return HopGraph((HopNode("switch"),), num_groups=1)


def leaf_spine_graph(num_leaves: int) -> HopGraph:
    """Leaves partially sort their shard; the spine merges the uplinks."""
    if num_leaves < 1:
        raise ValueError("num_leaves must be >= 1")
    leaves = tuple(HopNode(f"leaf{i}", group=i) for i in range(num_leaves))
    spine = HopNode("spine", parents=tuple(range(num_leaves)))
    return HopGraph(leaves + (spine,), num_groups=num_leaves)


def tree_graph(branching: int, height: int) -> HopGraph:
    """k-ary reduction tree, ``height`` levels deep
    (``branching ** (height - 1)`` leaves)."""
    if branching < 1 or height < 1:
        raise ValueError("branching and height must be >= 1")
    num_leaves = branching ** (height - 1)
    nodes: list[HopNode] = []
    prev: list[int] = []
    for level in range(height):
        width = branching ** (height - 1 - level)
        cur: list[int] = []
        for nd in range(width):
            if level == 0:
                nodes.append(HopNode(f"l0n{nd}", group=nd))
            else:
                nodes.append(
                    HopNode(
                        f"l{level}n{nd}",
                        parents=tuple(prev[nd * branching : (nd + 1) * branching]),
                    )
                )
            cur.append(len(nodes) - 1)
        prev = cur
    return HopGraph(tuple(nodes), num_groups=num_leaves)


@dataclasses.dataclass
class _TopoBase:
    num_segments: int
    segment_length: int
    max_value: int
    ranges: torch.Tensor = dataclasses.field(compare=False)
    faithful: bool = False
    payload_size: int = DEFAULT_PAYLOAD
    engine: str | None = None  # None -> "faithful" if faithful else "fused"

    def graph(self) -> HopGraph:
        raise NotImplementedError

    def _spec(self) -> HopSpec:
        return HopSpec(
            self.num_segments,
            self.segment_length,
            self.max_value,
            self.ranges,
            payload_size=self.payload_size,
        )

    def _engine(self) -> str:
        return self.engine or ("faithful" if self.faithful else "fused")

    def run_batch(self, batch: WireBatch, *, tracer=None, metrics=None,
                  int_telemetry: bool = False, network=None, faults=None):
        return run_graph(
            self.graph(), batch, self._spec(), self._engine(),
            tracer=tracer, metrics=metrics, int_telemetry=int_telemetry,
            network=network, faults=faults,
        )


@dataclasses.dataclass
class SingleSwitch(_TopoBase):
    """Fig. 1: storage -> one switch -> compute."""

    def graph(self) -> HopGraph:
        return single_graph()


@dataclasses.dataclass
class LeafSpine(_TopoBase):
    """Leaves partially sort their shard; the spine merges the uplinks."""

    num_leaves: int = 2

    def graph(self) -> HopGraph:
        return leaf_spine_graph(self.num_leaves)


@dataclasses.dataclass
class AggregationTree(_TopoBase):
    """k-ary reduction tree of switches, ``height`` levels deep."""

    branching: int = 2
    height: int = 2

    def graph(self) -> HopGraph:
        return tree_graph(self.branching, self.height)


TOPOLOGIES = {
    "single": SingleSwitch,
    "leaf_spine": LeafSpine,
    "tree": AggregationTree,
}


def make_topology(kind: str, **kw) -> _TopoBase:
    try:
        cls = TOPOLOGIES[kind]
    except KeyError:
        raise ValueError(
            f"unknown topology {kind!r}; options: {sorted(TOPOLOGIES)}"
        ) from None
    return cls(**kw)
