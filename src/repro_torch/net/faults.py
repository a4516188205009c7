"""Deterministic chaos plane: scheduled component faults, fail-open recovery.

Counterpart of :mod:`repro.net.faults`.  The in-network sort is an
accelerator, not a correctness dependency: the servers can always fall back
to a plain merge sort of the raw stream (the paper's baseline).  A
:class:`FaultPlan` schedules component faults at (epoch, hop/link/server)
granularity, and the dataplane's recovery paths
(:func:`repro_torch.net.topology.run_graph`,
:class:`repro_torch.net.egress.ServerPool`,
:func:`repro_torch.net.pipeline.run_pipeline`) keep every survivable plan's
output byte-identical to the fault-free run.  Losing a component costs
speed, never bytes.

Fault kinds and who recovers:

* ``hop_crash`` -- the hop is gone for the epoch (``until=`` models a
  restart).  A dead ingress hop's flows rehash onto the alive ingress hops
  (``flow_id % alive``); a dead interior hop's parents hoist to its
  consumer; killing the egress hop raises.
* ``hop_degrade`` -- the hop routes and packetizes but never sorts
  (:func:`repro_torch.net.engine.passthrough_hop`); ``target="all"``
  degrades every hop: the paper's plain-sort baseline through the fabric.
* ``link_flap`` -- the named link (``ingress:<hop>``, ``uplink:<hop>``,
  ``egress``, or a class ``ingress``/``fabric``/``egress``) runs with
  ``loss_rate``/``extra_latency`` added for the epoch; a no-op without a
  :class:`~repro_torch.net.timing.NetworkConfig`.
* ``server_crash`` -- pool shard ``target`` dies after ``at_fraction`` of
  the delivered packets; the nearest alive shard adopts its segments and
  re-ingests its history from the pool's replay buffer.  Ignored on a
  single-server pool.
* ``range_corrupt`` -- the control plane's table is garbage for the epoch;
  the pipeline detects it (:func:`repro_torch.net.control.ranges_valid`)
  and falls back to the static Alg. 2 table.

This is host bookkeeping: plain Python and numpy, seeded draw for draw as
the reference draws.  CLI form (:func:`parse_fault_plan`), entries separated
by ``;``: ``degrade:spine@0``, ``degrade:all``, ``crash:l1n0@1-3``,
``flap:uplink:leaf0@0-1``, ``server_crash:1@0.5``, ``corrupt_ranges@0``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .timing import LinkSpec

#: Component-fault kinds a plan can schedule.
FAULT_KINDS = (
    "hop_crash",
    "hop_degrade",
    "link_flap",
    "server_crash",
    "range_corrupt",
)

#: Hop health states: healthy -> degraded (pass-through) -> dead (rerouted).
HOP_STATES = ("healthy", "degraded", "dead")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled component fault.

    ``epoch`` is the first epoch affected, ``until`` (exclusive) the restart
    (``None``: permanent).  ``server_crash`` ignores the epoch window: it
    fires at ``at_fraction`` of the delivered packet stream.
    """

    kind: str
    target: str = ""
    epoch: int = 0
    until: int | None = None
    loss_rate: float = 0.25  # link_flap: added wire-loss probability
    extra_latency: int = 8  # link_flap: added propagation ticks
    at_fraction: float = 0.5  # server_crash: delivered-packet fraction

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; options: {FAULT_KINDS}")
        if self.epoch < 0:
            raise ValueError("fault epoch must be >= 0")
        if self.until is not None and self.until <= self.epoch:
            raise ValueError("until must be > epoch (exclusive restart)")
        if not 0.0 <= self.loss_rate <= 1.0:
            raise ValueError("loss_rate must be in [0, 1]")
        if self.extra_latency < 0:
            raise ValueError("extra_latency must be >= 0")
        if not 0.0 <= self.at_fraction <= 1.0:
            raise ValueError("at_fraction must be in [0, 1]")
        if self.kind in ("hop_crash", "hop_degrade", "link_flap"):
            if not self.target:
                raise ValueError(f"{self.kind} needs a target name")
        elif self.kind == "server_crash":
            try:
                int(self.target)
            except ValueError:
                raise ValueError(
                    f"server_crash target must be a server index, got {self.target!r}"
                ) from None
        elif self.target:
            raise ValueError("range_corrupt takes no target")

    def active_at(self, epoch: int) -> bool:
        """Whether this fault is live during ``epoch``."""
        return epoch >= self.epoch and (self.until is None or epoch < self.until)


@dataclasses.dataclass(frozen=True)
class EpochFaults:
    """One epoch's resolved fault state, as the dataplane consumes it.

    ``hop_faults`` maps a hop name (or the wildcard ``"all"``) to
    ``"degraded"``/``"dead"``; ``link_faults`` holds the live flaps;
    ``range_corrupt`` marks the control plane's table as garbage.
    """

    epoch: int
    seed: int
    hop_faults: dict
    link_faults: tuple
    range_corrupt: bool = False

    def hop_state(self, name: str) -> str:
        """Health of hop ``name`` this epoch."""
        if name in self.hop_faults:
            return self.hop_faults[name]
        return self.hop_faults.get("all", "healthy")

    @property
    def any_dataplane(self) -> bool:
        """Whether the hop graph or its links are affected at all (server
        and range faults alone leave the fabric as it is)."""
        return bool(self.hop_faults or self.link_faults)

    def link_spec(self, name: str, base: LinkSpec) -> LinkSpec:
        """``base`` with every live flap matching link ``name`` (exactly,
        or by its class; ``fabric`` names the uplinks) applied."""
        cls = name.split(":", 1)[0]
        for f in self.link_faults:
            t = f.target
            if t == name or t == cls or (t == "fabric" and cls == "uplink"):
                base = dataclasses.replace(
                    base,
                    latency=base.latency + f.extra_latency,
                    loss_rate=min(1.0, base.loss_rate + f.loss_rate),
                )
        return base

    def corrupt_ranges(self, ranges) -> np.ndarray:
        """What the corrupted control plane would install this epoch: one
        row, drawn per (seed, epoch), collapses to an empty ``[lo, lo)``,
        which :func:`~repro_torch.net.control.ranges_valid` detects.
        Takes and returns a host table."""
        ranges = np.asarray(ranges, dtype=np.int64)
        if not self.range_corrupt:
            return ranges
        bad = ranges.copy()
        rng = np.random.default_rng([self.seed, self.epoch, 0xFA17])
        row = int(rng.integers(0, bad.shape[0]))
        bad[row, 1] = bad[row, 0]
        return bad


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded schedule of component faults, resolved per
    epoch (:meth:`at_epoch`) and per pool (:meth:`server_crashes`)."""

    faults: tuple = ()
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "faults", tuple(self.faults))
        for f in self.faults:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultPlan entries must be Fault, got {f!r}")

    def __bool__(self) -> bool:
        return bool(self.faults)

    def at_epoch(self, epoch: int) -> EpochFaults:
        """Resolve the plan for one epoch; a crash beats a degrade."""
        hop: dict = {}
        links: list = []
        corrupt = False
        for f in self.faults:
            if f.kind == "server_crash" or not f.active_at(epoch):
                continue
            if f.kind == "hop_crash":
                hop[f.target] = "dead"
            elif f.kind == "hop_degrade":
                if hop.get(f.target) != "dead":
                    hop[f.target] = "degraded"
            elif f.kind == "link_flap":
                links.append(f)
            else:
                corrupt = True
        return EpochFaults(
            epoch=epoch, seed=self.seed, hop_faults=hop,
            link_faults=tuple(links), range_corrupt=corrupt,
        )

    def server_crashes(self, num_servers: int) -> list:
        """``[(server, at_fraction), ...]`` for a pool of ``num_servers``:
        out-of-range shards are dropped, and a single-server pool ignores
        every crash (no failover target)."""
        if num_servers <= 1:
            return []
        out: list = []
        seen: set = set()
        for f in self.faults:
            if f.kind != "server_crash":
                continue
            s = int(f.target)
            if 0 <= s < num_servers and s not in seen:
                seen.add(s)
                out.append((s, f.at_fraction))
        return out

    def describe(self) -> str:
        """The CLI string form back (round-trips through
        :func:`parse_fault_plan` for the default knobs)."""
        parts = []
        for f in self.faults:
            if f.kind == "server_crash":
                parts.append(f"server_crash:{f.target}@{f.at_fraction:g}")
                continue
            when = f"@{f.epoch}" + (f"-{f.until}" if f.until is not None else "")
            short = {
                "hop_crash": "crash",
                "hop_degrade": "degrade",
                "link_flap": "flap",
                "range_corrupt": "corrupt_ranges",
            }[f.kind]
            head = f"{short}:{f.target}" if f.target else short
            parts.append(head + when)
        return ";".join(parts)


_CLI_KINDS = {
    "crash": "hop_crash",
    "degrade": "hop_degrade",
    "flap": "link_flap",
    "server_crash": "server_crash",
    "corrupt_ranges": "range_corrupt",
}
_CLI_KINDS.update({k: k for k in FAULT_KINDS})


def parse_fault_plan(spec: str, seed: int = 0) -> FaultPlan:
    """Parse the ``;``-separated CLI form into a :class:`FaultPlan`."""
    faults: list[Fault] = []
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        head, sep, suffix = entry.rpartition("@")
        if not sep:
            head, suffix = entry, ""
        kind_word, _, target = head.partition(":")
        kind = _CLI_KINDS.get(kind_word)
        if kind is None:
            raise ValueError(
                f"unknown fault {kind_word!r} in {entry!r}; "
                f"options: {sorted(set(_CLI_KINDS))}"
            )
        kw: dict = {}
        if kind == "server_crash":
            if suffix:
                kw["at_fraction"] = float(suffix)
        elif suffix:
            first, sep2, rest = suffix.partition("-")
            kw["epoch"] = int(first)
            if sep2:
                kw["until"] = int(rest)
        faults.append(Fault(kind, target, **kw))
    return FaultPlan(tuple(faults), seed=seed)
