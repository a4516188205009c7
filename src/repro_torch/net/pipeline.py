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

Not ported yet (each raises ``NotImplementedError``): the timing model
(``network``), ``fault_plan``, a recording ``tracer`` or ``metrics``,
``int_telemetry``, the ``"segment"``/``"faithful"`` engines, and the
adaptive ``range_mode="sampled"`` plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core.partition import quantile_ranges, set_ranges
from ..obs.trace import NULL_TRACER, check_tracer
from .control import RANGE_MODES, ControlPlane
from .egress import ServerPool
from .engine import HopStats
from .flow import interleave_batch, split_flows
from .packet import DEFAULT_PAYLOAD
from .server import StreamingServer
from .topology import make_topology
from .wire import WireBatch, packetize_batch, ragged_gather, segment_streams_batch


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

    def to_numpy(self) -> dict:
        """The result as plain Python and numpy values, under the
        reference's field names (``delivered`` and ``hop_stats`` as dicts)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "hop_stats":
                v = [st.to_numpy() for st in v]
            elif f.name == "delivered":
                v = None if v is None else v.to_numpy()
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
    adaptive=None,
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

    ``payload`` attaches a record table (one row per key): each key carries
    its input row through the fabric, the servers sort ``(key << rowbits) |
    row`` (a stable sort of the records), and the table is gathered once at
    egress into :attr:`PipelineResult.sorted_payload`.  The key domain must
    leave room for the row bits: ``max_value < 2**(63 - ceil(log2(n)))``.
    """
    dev = resolve_device(device)
    if network is not None:
        raise _not_ported("network=", "net/timing")
    if fault_plan is not None:
        raise _not_ported("fault_plan=", "net/faults")
    if int_telemetry:
        raise _not_ported("int_telemetry=True", "obs/telemetry")
    if metrics is not None:
        raise _not_ported("metrics=", "obs/metrics")
    check_tracer(tracer)
    if replay_packets is not None:
        raise _not_ported("replay_packets=", "net/faults")
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
    if range_mode == "sampled":
        raise _not_ported('range_mode="sampled"', "net/control AdaptiveControlPlane")
    if faithful and engine is not None and engine != "faithful":
        raise ValueError(f"faithful=True conflicts with engine={engine!r}; pass one")
    engine = engine or ("faithful" if faithful else "fused")
    if engine in ("segment", "faithful"):
        raise _not_ported(f"engine={engine!r}", "M18, the baseline hop engines")
    if recovery:
        raise _not_ported("recovery=True", "net/server recovery")
    recovery = False

    tr = tracer or NULL_TRACER
    with tr.span("pipeline", cat="pipeline", n=n):
        with tr.span("flows", cat="pipeline"):
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
        if engine == "device":
            # The host programs the range table; the device epoch builds
            # its program from it without reading the card.
            ranges = ranges.cpu()
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
        with tr.span("epoch:0", cat="pipeline", keys=len(arrivals)):
            delivered, hop_stats = topo.run_batch(arrivals, tracer=tracer)
        del arrivals

        if jitter_window:
            delivered = jitter_delivery_batch(delivered, jitter_window, seed=seed + 1)

        with tr.span("egress", cat="pipeline"):
            pool = ServerPool(
                num_segments,
                num_servers,
                num_epochs=1,
                k=k,
                reorder_capacity=reorder_capacity,
                merge_backend=merge_backend,
                pool_backend=pool_backend,
                recovery=recovery,
                tracer=tracer,
                device=dev,
            )
            if payload is not None and delivered.row_index is None:
                raise ValueError(f"engine {engine!r} dropped the payload row column")
            grouped = getattr(delivered, "grouped_values", None)
            if grouped is not None and (reorder_capacity is None or reorder_capacity >= 1):
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

    return PipelineResult(
        output=out,
        passes=passes,
        hop_stats=hop_stats,
        segment_multisets=segment_streams_batch(delivered, num_segments),
        max_reorder_depth=pool.max_reorder_depth,
        server_seconds=pool.makespan_seconds,
        n=n,
        range_mode=mode_str,
        num_epochs=1,
        ranges_history=[ranges],
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
    check_tracer(tracer)
    values = _as_tensor(values, dev).to(torch.int64).reshape(-1)
    batch = packetize_batch(values, payload_size, segment_id=0)
    server = StreamingServer(1, k=k, tracer=tracer, name="baseline", device=dev)
    with (tracer or NULL_TRACER).timed("baseline:server", cat="server") as t:
        server.ingest_batch(batch)
        out, passes = server.finish()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out, passes, t.seconds
