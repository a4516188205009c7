"""Switch fabrics as declarative hop-graphs run by a tiny scheduler.

Counterpart of :mod:`repro.net.topology`.  A :class:`HopGraph` lists
:class:`HopNode` entries in topological order -- ingress nodes fed by a
group of storage flows (``flow_id % num_groups``), interior nodes fed by the
round-robin merge of their parents' uplinks -- and :func:`run_graph` runs
each node through the fused hop engine on device-resident wire batches.
Each hop's output is dropped as soon as its one consumer has merged it, so a
fabric holds at most one level of uplinks at a time.  ``engine="device"``
runs the whole graph as one program
(:func:`repro_torch.net.device_epoch.run_graph_device`).  The timing
overlay and fault reroutes are later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..obs.trace import NULL_TRACER
from .engine import HopSpec, HopStats, run_hop
from .packet import DEFAULT_PAYLOAD
from .wire import WireBatch, merge_round_robin_batches, split_by_flow


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
    batch and the per-hop stats in node order."""
    if faults is not None:
        raise NotImplementedError("run_graph(faults=...) is not ported yet (later slice: net/faults)")
    if engine == "device":
        from .device_epoch import run_graph_device

        return run_graph_device(
            graph, batch, spec,
            tracer=tracer, metrics=metrics, int_telemetry=int_telemetry, network=network,
        )
    for opt, val, later in (
        ("metrics", metrics, "obs/metrics"),
        ("network", network, "net/timing"),
    ):
        if val is not None:
            raise NotImplementedError(
                f"run_graph({opt}=...) is not ported yet (later slice: {later})"
            )
    tr = tracer or NULL_TRACER
    dev = batch.device
    ingress: list[WireBatch | None] = list(split_by_flow(batch, graph.num_groups))
    outs: list[WireBatch | None] = []
    stats: list[HopStats] = []
    for i, node in enumerate(graph.nodes):
        if node.parents:
            inp = merge_round_robin_batches([outs[p] for p in node.parents], device=dev)
            for p in node.parents:
                outs[p] = None  # one consumer per uplink: free it
        else:
            inp = ingress[node.group]
            ingress[node.group] = None
        with tr.span(f"hop:{node.name}", cat="hop", keys=len(inp)) as hop_sp:
            out, st = run_hop(
                inp, spec, node.name, engine,
                tracer=tracer, hop_id=i, int_telemetry=int_telemetry,
            )
            hop_sp.set(keys_out=len(out))
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
        )
        outs.append(out)
        stats.append(st)
    return outs[-1], stats


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
