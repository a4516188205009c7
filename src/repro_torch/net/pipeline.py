"""End-to-end datapath: flows -> switch fabric -> streaming server pool.

Counterpart of :mod:`repro.net.pipeline` (the paper's Fig. 1).  Storage
servers packetize their shards, an arrival model interleaves the flows, a
switch fabric runs MergeMarathon at every hop (kernel K1 sorts each hop's
block matrix), an optional delivery model jitters the packet order, and a
segment-affinity :class:`~repro_torch.net.egress.ServerPool` recovers the
global sort (kernel K2 merges each arena segment).

Keys, row indices and the payload table live on ``device`` from the first
flow to :attr:`PipelineResult.output`.  Seeded randomness (trace, arrival
schedule, jitter) is drawn on the host with numpy's ``default_rng`` exactly
as the reference draws it, and only the resulting index arrays move to the
device, so the port is byte-identical to the reference for every seed.

``engine="device"`` runs each epoch as one program
(:mod:`repro_torch.net.device_epoch`, captured into a CUDA graph on the
card); its delivery carries each segment's emission stream and run breaks,
which feed the server arenas directly (:meth:`ServerPool.ingest_grouped`).

``range_mode="sampled"`` runs the adaptive control plane
(:class:`~repro_torch.net.control.AdaptiveControlPlane`): the arrivals split
into epochs on the host, each epoch runs the fabric under its own ranges,
and the pool k-way merges the per-(epoch, segment) outputs.  ``tracer``,
``metrics`` and ``int_telemetry`` observe a run without changing a byte of
it; ``network`` (a :class:`~repro_torch.net.timing.NetworkConfig`) runs the
per-link timing model, whose raw egress wire the pool heals in recovery
mode.

Not ported yet (each raises ``NotImplementedError`` naming its slice):
``fault_plan`` and ``replay_packets`` (M16), the ``"segment"`` and
``"faithful"`` engines (M18) and ``pool_backend="shard_map"`` (M19).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core.partition import quantile_ranges, set_ranges
from ..obs.metrics import MetricsRegistry
from ..obs.telemetry import int_summary
from ..obs.trace import NULL_TRACER
from .control import RANGE_MODES, AdaptiveControlPlane, ControlPlane
from .egress import ServerPool
from .engine import HopStats
from .flow import interleave_batch, split_flows
from .packet import DEFAULT_PAYLOAD
from .server import StreamingServer
from .topology import make_topology
from .wire import (
    WireBatch,
    concat_batches,
    packetize_batch,
    ragged_gather,
    segment_streams_batch,
)


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


@dataclasses.dataclass(eq=False)
class PipelineResult:
    """Everything one :func:`run_pipeline` run produced.  Tensor fields lie
    on the run's device; :meth:`to_numpy` brings them to the host."""

    output: torch.Tensor
    passes: list[int]  # per-(epoch, segment) merge passes
    hop_stats: list[HopStats]
    segment_multisets: list[torch.Tensor]  # delivered per-segment streams
    max_reorder_depth: int
    server_seconds: float  # egress wall-clock: slowest server + pool merge
    n: int
    range_mode: str = "width"
    num_epochs: int = 1
    ranges_history: list[torch.Tensor] = dataclasses.field(default_factory=list)
    engine: str = "fused"
    delivered: WireBatch | None = None  # the wire as the server pool saw it
    num_servers: int = 1
    merge_backend: str = "numpy"
    per_server_seconds: list[float] = dataclasses.field(default_factory=list)
    pool_merge_seconds: float = 0.0
    server_keys: list[int] = dataclasses.field(default_factory=list)
    server_imbalance: float = 1.0
    # Record mode: the payload rows in key order, and the stable sort
    # permutation that produced them (sorted_payload = payload[row_order]).
    sorted_payload: torch.Tensor | None = None
    payload_row_order: torch.Tensor | None = None
    # Metrics snapshot (and the INT summary under "int") when the run was
    # observed; None on an unobserved run.
    telemetry: dict | None = None
    # The timing model's NetworkReport when a NetworkConfig drove the run.
    network: object | None = None
    # Server recovery counters (non-zero only in recovery mode).
    dup_packets_dropped: int = 0
    spilled_packets: int = 0
    spilled_keys: int = 0

    def to_numpy(self) -> dict:
        """The result as plain Python and numpy values, under the
        reference's field names (``delivered`` and ``hop_stats`` as dicts;
        ``telemetry`` and ``network`` as they are: host values already)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "hop_stats":
                v = [st.to_numpy() for st in v]
            elif f.name == "delivered":
                v = None if v is None else v.to_numpy()
            elif f.name in ("telemetry", "network"):
                pass
            elif isinstance(v, list):
                v = [_to_numpy(x) for x in v]
            else:
                v = _to_numpy(v)
            out[f.name] = v
        return out


def _not_ported(option: str, later: str) -> NotImplementedError:
    return NotImplementedError(
        f"run_pipeline({option}) is not ported yet (later slice: {later})"
    )


def jitter_delivery_batch(batch: WireBatch, window: int, seed: int = 0) -> WireBatch:
    """Bounded-displacement packet reorder: packet ``i`` departs at priority
    ``i + U[0, window)`` (numpy ``default_rng``), stable ties; one
    packet-granular device gather applies it."""
    if window <= 0:
        return batch
    starts_d = batch.packet_starts()
    starts = starts_d.cpu().numpy()
    rng = np.random.default_rng(seed)
    pri = np.arange(starts.size, dtype=np.int64) + rng.integers(0, window, starts.size)
    order = np.argsort(pri, kind="stable")
    sizes = np.diff(np.concatenate([starts, [len(batch)]]))
    dev = batch.device
    return batch.take(
        ragged_gather(
            torch.from_numpy(starts[order]).to(dev),
            torch.from_numpy(sizes[order]).to(dev),
            len(batch),
        )
    )


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def run_pipeline(
    values,
    *,
    topology: str = "single",
    num_flows: int = 4,
    payload_size: int = DEFAULT_PAYLOAD,
    num_segments: int = 16,
    segment_length: int = 32,
    max_value: int | None = None,
    control: ControlPlane | None = None,
    range_mode: str | None = None,
    adaptive: AdaptiveControlPlane | None = None,
    interleave_mode: str = "round_robin",
    seed: int = 0,
    faithful: bool = False,
    engine: str | None = None,
    k: int = 10,
    jitter_window: int = 0,
    reorder_capacity: int | None = None,
    network=None,
    recovery: bool | None = None,
    num_servers: int = 1,
    merge_backend: str = "numpy",
    pool_backend: str = "numpy",
    fault_plan=None,
    replay_packets: int | None = None,
    payload=None,
    verify: bool = False,
    tracer=None,
    metrics=None,
    int_telemetry: bool = False,
    device="cuda",
    **topo_kw,
) -> PipelineResult:
    """Drive the storage -> switch -> server datapath over ``values``.

    The arguments are the reference's (:func:`repro.net.pipeline.run_pipeline`)
    plus ``device``: ``"cuda"`` (the default) runs every hop's row sort
    through kernel K1 and every arena tournament through kernel K2;
    ``"cpu"`` runs their plain torch versions.  With no card present and no
    ``device="cpu"`` the call raises.

    ``range_mode="sampled"`` estimates the ranges online (``adaptive``
    optionally supplies a configured plane; it is consumed by the run).
    Observability is opt-in and output-transparent: a recording ``tracer``
    records the span hierarchy (and brings a :class:`MetricsRegistry` when
    no ``metrics`` is given), ``metrics`` accumulates the dataplane's
    counters, and ``int_telemetry`` stamps INT columns on the wire (fused
    engine only); the snapshot and the INT summary land in
    :attr:`PipelineResult.telemetry`.  ``network`` runs the fabric under
    the per-link timing model; its egress link delivers the raw wire, so
    ``recovery`` defaults to on under a network, and the output stays
    byte-identical to the timeless run.

    ``payload`` attaches a record table (one row per key): each key carries
    its input row through the fabric, the servers sort ``(key << rowbits) |
    row`` (a stable sort of the records), and the table is gathered once at
    egress into :attr:`PipelineResult.sorted_payload`.  The key domain must
    leave room for the row bits: ``max_value < 2**(63 - ceil(log2(n)))``.
    """
    dev = resolve_device(device)
    if fault_plan is not None:
        raise _not_ported("fault_plan=", "M16, net/faults")
    if replay_packets is not None:
        raise _not_ported("replay_packets=", "M16, net/faults")
    values = _as_tensor(values, dev).to(torch.int64).reshape(-1)
    n = int(values.numel())
    if max_value is None:
        max_value = max(int(values.max()), 0) if n else 0
    if range_mode is not None:
        if range_mode not in RANGE_MODES:
            raise ValueError(f"unknown range_mode {range_mode!r}; options: {RANGE_MODES}")
        if control is not None:
            raise ValueError("pass either control= or range_mode=, not both")
    if adaptive is not None and range_mode != "sampled":
        raise ValueError('adaptive= requires range_mode="sampled"')
    if faithful and engine is not None and engine != "faithful":
        raise ValueError(f"faithful=True conflicts with engine={engine!r}; pass one")
    engine = engine or ("faithful" if faithful else "fused")
    if engine in ("segment", "faithful"):
        raise _not_ported(f"engine={engine!r}", "M18, the baseline hop engines")
    if recovery is None:
        # A timed network's egress link is raw (duplicates, late
        # retransmits): the pool must heal it by default.
        recovery = network is not None

    tr = tracer or NULL_TRACER
    if metrics is None and tr.enabled:
        # A recording tracer implies an observed run: build a registry so
        # that the snapshot always lands in PipelineResult.telemetry.
        metrics = MetricsRegistry()

    with tr.span("pipeline", cat="pipeline", n=n):
        arrivals = interleave_batch(
            split_flows(values, num_flows, payload_size), interleave_mode, seed=seed
        )
        nbits = 0
        if payload is not None:
            payload = _as_tensor(payload, dev)
            if payload.shape[0] != n:
                raise ValueError(f"payload rows {payload.shape[0]} != {n} keys")
            nbits = max(1, int(n - 1).bit_length())
            if int(max_value) >= 1 << (63 - nbits):
                raise ValueError(
                    f"cannot pack {n} payload rows next to keys "
                    f"up to {max_value} in 63 bits"
                )
            # Each key's input row takes the same shard split and
            # interleave schedule its key took, so the row column lands
            # on the key's arrival row.
            rows = interleave_batch(
                split_flows(
                    torch.arange(n, dtype=torch.int64, device=dev),
                    num_flows,
                    payload_size,
                ),
                interleave_mode,
                seed=seed,
            )
            arrivals = arrivals.with_row_index(rows.values)
            del rows

        def _install(ranges: torch.Tensor) -> torch.Tensor:
            # The device engine builds its program from a host range table
            # without reading the card; the fused hops route on the card.
            return ranges.cpu() if engine == "device" else ranges.to(dev)

        def _run_topology(ranges: torch.Tensor, batch: WireBatch):
            topo = make_topology(
                topology,
                num_segments=num_segments,
                segment_length=segment_length,
                max_value=max_value,
                ranges=ranges,
                faithful=faithful,
                engine=engine,
                payload_size=payload_size,
                **topo_kw,
            )
            res = topo.run_batch(
                batch, tracer=tracer, metrics=metrics,
                int_telemetry=int_telemetry, network=network,
            )
            if network is None:
                out, stats = res
                return out, stats, None
            return res  # (delivered, stats, NetworkReport)

        if range_mode == "sampled":
            plane = adaptive or AdaptiveControlPlane(
                num_segments, max_value, seed=seed, tracer=tracer, metrics=metrics,
            )
            with tr.span("control:split_epochs", cat="control"):
                epochs = plane.split_epochs(arrivals)
            del arrivals
            delivered_epochs: list[WireBatch] = []
            hop_stats: list[HopStats] = []
            ranges_history: list[torch.Tensor] = []
            net_reports = []
            for e, (ranges_e, sub) in enumerate(epochs):
                ranges_e = _install(ranges_e)
                with tr.span(f"epoch:{e}", cat="pipeline", keys=len(sub)):
                    out, stats, rep = _run_topology(ranges_e, sub)
                del sub
                delivered_epochs.append(out.with_epoch(e, num_segments))
                hop_stats.extend(
                    dataclasses.replace(st, name=f"e{e}:{st.name}") for st in stats
                )
                if rep is not None:
                    for lst in rep.links:
                        lst.name = f"e{e}:{lst.name}"
                    net_reports.append(rep)
                ranges_history.append(ranges_e)
            del epochs
            net_report = None
            if net_reports:
                from .timing import merge_reports

                net_report = merge_reports(net_reports)
            delivered = concat_batches(delivered_epochs, device=dev)
            del delivered_epochs
            eff_segments = num_segments * len(ranges_history)
            # Epoch handoff re-shards the virtual ids across the pool (empty
            # epochs were dropped, so the map is cut to the ids on the wire).
            affinity = plane.pool_affinity(num_servers)[:eff_segments]
            mode_str = "sampled"
        else:
            if range_mode == "oracle":
                ranges = quantile_ranges(values, num_segments, max_value)
                mode_str = "oracle"
            elif range_mode == "static":
                ranges = set_ranges(max_value, num_segments, device=dev)
                mode_str = "static"
            else:
                plane = control or ControlPlane()
                ranges = plane.ranges(values, num_segments, max_value)
                mode_str = plane.mode
            ranges = _install(ranges)
            with tr.span("epoch:0", cat="pipeline", keys=len(arrivals)):
                delivered, hop_stats, net_report = _run_topology(ranges, arrivals)
            del arrivals
            ranges_history = [ranges]
            eff_segments = num_segments
            affinity = None

        if jitter_window:
            delivered = jitter_delivery_batch(delivered, jitter_window, seed=seed + 1)

        pool = ServerPool(
            num_segments,
            num_servers,
            num_epochs=eff_segments // num_segments,
            k=k,
            reorder_capacity=reorder_capacity,
            affinity=affinity,
            merge_backend=merge_backend,
            pool_backend=pool_backend,
            recovery=recovery,
            tracer=tracer,
            metrics=metrics,
            device=dev,
        )
        if payload is not None and delivered.row_index is None:
            raise ValueError(f"engine {engine!r} dropped the payload row column")
        grouped = getattr(delivered, "grouped_values", None)
        if (
            grouped is not None
            and not recovery
            and (reorder_capacity is None or reorder_capacity >= 1)
            and eff_segments == num_segments
        ):
            # Device-epoch fast path: the delivery already carries each
            # segment's emission stream and its run breaks -- feed the
            # arenas directly instead of re-deriving packet boundaries.
            flags = delivered.run_flags
            if payload is not None:
                grouped = (grouped << nbits) | delivered.grouped_rows
                # Row tie-breaks can split runs the key-only flags did
                # not see; one vectorized compare re-detects them.
                counts = delivered.seg_counts.numpy()
                heads = np.concatenate([[0], np.cumsum(counts)[:-1]])[counts > 0]
                flags = torch.zeros(grouped.numel(), dtype=torch.bool, device=dev)
                flags[torch.from_numpy(heads).to(dev)] = True
                flags[1:] |= grouped[1:] < grouped[:-1]
            pool.ingest_grouped(grouped, delivered.seg_counts, flags)
        elif payload is not None:
            # (key << rowbits) | row: key order is kept and ties resolve
            # by input row, so the servers' merge is a stable record sort.
            pool.ingest_batch(
                WireBatch(
                    (delivered.values << nbits) | delivered.row_index,
                    delivered.flow_id,
                    delivered.seq,
                    delivered.segment_id,
                    epoch=delivered.epoch,
                )
            )
        else:
            pool.ingest_batch(delivered)
        out, passes = pool.finish()
        row_order = None
        sorted_payload = None
        if payload is not None:
            row_order = out & ((1 << nbits) - 1)
            out = out >> nbits
            sorted_payload = payload[row_order]

    if verify:
        ref = torch.sort(values, stable=True)
        if not torch.equal(out, ref.values):
            raise AssertionError("pipeline output differs from the sorted input")
        if payload is not None and not torch.equal(row_order, ref.indices):
            raise AssertionError("payload row order differs from the stable argsort")

    telemetry = None
    if metrics is not None or delivered.int_meta is not None:
        telemetry = metrics.snapshot() if metrics is not None else {}
        if delivered.int_meta is not None:
            telemetry["int"] = int_summary(delivered.int_meta)

    return PipelineResult(
        output=out,
        passes=passes,
        hop_stats=hop_stats,
        segment_multisets=segment_streams_batch(delivered, eff_segments),
        max_reorder_depth=pool.max_reorder_depth,
        server_seconds=pool.makespan_seconds,
        n=n,
        range_mode=mode_str,
        num_epochs=len(ranges_history),
        ranges_history=ranges_history,
        engine=engine,
        delivered=delivered,
        num_servers=num_servers,
        merge_backend=merge_backend,
        per_server_seconds=list(pool.per_server_seconds),
        pool_merge_seconds=pool.merge_seconds,
        server_keys=pool.server_keys,
        server_imbalance=pool.server_imbalance,
        sorted_payload=sorted_payload,
        payload_row_order=row_order,
        telemetry=telemetry,
        network=net_report,
        dup_packets_dropped=pool.dup_packets_dropped,
        spilled_packets=pool.spilled_packets,
        spilled_keys=pool.spilled_keys,
    )


def plain_stream_sort(
    values,
    payload_size: int = DEFAULT_PAYLOAD,
    k: int = 10,
    *,
    tracer=None,
    device="cuda",
) -> tuple[torch.Tensor, list[int], float]:
    """Switchless baseline: raw packets straight into one streaming server.
    Returns ``(sorted, passes, server_seconds)``."""
    dev = resolve_device(device)
    values = _as_tensor(values, dev).to(torch.int64).reshape(-1)
    batch = packetize_batch(values, payload_size, segment_id=0)
    server = StreamingServer(1, k=k, tracer=tracer, name="baseline", device=dev)
    with (tracer or NULL_TRACER).timed("baseline:server", cat="server") as t:
        server.ingest_batch(batch)
        out, passes = server.finish()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, passes, t.seconds
