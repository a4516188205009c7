"""Multi-tenant serving plane: concurrent sort jobs over one shared fabric.

Counterpart of :mod:`repro.net.scheduler`.

* :class:`Job` -- one tenant's sort request (its keys, flow layout, range
  mode).  The tenant id rides the wire as a column next to flow, seq and
  segment (:attr:`~repro_torch.net.wire.WireBatch.tenant`).
* :class:`AdmissionController` -- a FIFO queue with a bounded in-flight
  budget (the switch's finite per-query state table).
* :func:`run_jobs` -- the fair epoch scheduler: every round grants each
  in-flight job one epoch of fabric time, so epochs of different jobs
  interleave on the shared fabric instead of whole jobs queueing.

**Cross-job packing.**  On the single switch with a batched engine
(``fused``/``device``), a round's grants share ONE fabric call: tenant slot
``i`` shifts its keys by ``i * D`` (``D`` the round's common domain stride)
into a private key block, the per-tenant range tables concatenate into one
ascending ``(m*S, 2)`` table, and the hop's block matrix routes every
tenant's keys into its own ``S``-segment block, so ``m`` jobs cost one K1
launch, not ``m``.  The shifted keys may pass int32: K1's dtype comes from
the packed matrix (and the device program's from the packed table), so such
a round sorts on K1's int64 path.  Segments are tenant-disjoint, so the
egress demux (``segment_id // S``) gives back per-tenant wires whose
per-segment streams equal the tenant's solo run.  Multi-hop fabrics and the
baseline engines run each grant alone (the calls of the solo pipeline),
still interleaved by epoch.

Each job keeps its own control plane (labelled telemetry) and its own
egress :class:`~repro_torch.net.egress.ServerPool`: the fabric is shared,
the serving state is per tenant.  Job latencies are host clock reads taken
after the job's output is complete on the device (a synchronise at
finalize), so they measure the work, not its launches.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.partition import quantile_ranges, set_ranges
from ..obs.trace import NULL_TRACER
from .control import RANGE_MODES, AdaptiveControlPlane
from .egress import ServerPool
from .flow import interleave_batch, split_flows
from .packet import DEFAULT_PAYLOAD
from .topology import make_topology
from .wire import WireBatch, concat_batches, merge_round_robin_batches, ragged_gather

#: Engines whose grants can share one fabric call (one batched pass over
#: one hop); multi-hop graphs and the element-wise engines run per unit.
PACKABLE_ENGINES = ("fused", "device")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Job:
    """One tenant's sort request against the shared fabric.  The fabric's
    knobs (topology, segment geometry, payload size, engine) belong to
    :func:`run_jobs`; a job owns its keys, flow layout and range mode.
    ``values`` is a tensor or a host array of int64 keys."""

    tenant_id: int
    values: torch.Tensor
    num_flows: int = 4
    interleave_mode: str = "round_robin"
    seed: int = 0
    range_mode: str = "static"
    k: int = 10
    max_value: int | None = None

    def __post_init__(self) -> None:
        v = self.values
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.int64)))
        self.values = v.to(torch.int64).reshape(-1)
        if self.tenant_id < 0:
            raise ValueError("tenant_id must be non-negative")
        if self.range_mode not in RANGE_MODES:
            raise ValueError(f"unknown range_mode {self.range_mode!r}; options: {RANGE_MODES}")
        if self.max_value is None:
            self.max_value = max(int(self.values.max()), 0) if self.values.numel() else 0


class AdmissionController:
    """A bounded in-flight budget over a FIFO queue: at most
    ``max_inflight`` jobs hold fabric state at once, the rest wait in
    admission order."""

    def __init__(self, max_inflight: int) -> None:
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self._queue: list = []
        self._inflight: list = []

    def submit(self, item) -> None:
        self._queue.append(item)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def inflight(self) -> list:
        return list(self._inflight)

    @property
    def active(self) -> bool:
        return bool(self._queue or self._inflight)

    def admit(self) -> list:
        """Admit queued jobs while the budget allows; return them in
        admission order."""
        admitted = []
        while self._queue and len(self._inflight) < self.max_inflight:
            item = self._queue.pop(0)
            self._inflight.append(item)
            admitted.append(item)
        return admitted

    def release(self, item) -> None:
        self._inflight.remove(item)


@dataclasses.dataclass(eq=False)
class JobResult:
    """One tenant's completed sort."""

    tenant_id: int
    output: torch.Tensor
    passes: list[int]
    n: int
    range_mode: str
    num_epochs: int  # epoch units of the job's plan
    epochs_granted: int  # fabric grants consumed (== num_epochs)
    rounds_active: int  # scheduler rounds in flight
    packed_epochs: int  # grants served by a shared (packed) call
    latency_seconds: float  # admission -> output complete on the device
    server_keys: list[int] = dataclasses.field(default_factory=list)
    server_imbalance: float = 1.0

    @property
    def epoch_share(self) -> float:
        """Grants per active round; 1.0 is the fair round-robin share."""
        return self.epochs_granted / max(self.rounds_active, 1)


@dataclasses.dataclass(eq=False)
class MultiTenantResult:
    """Everything one :func:`run_jobs` sweep produced."""

    jobs: list[JobResult]
    rounds: int
    fabric_calls: int  # topology executions (packed or solo)
    packed_calls: int  # fabric calls that carried more than one tenant
    elapsed_seconds: float
    network_reports: list = dataclasses.field(default_factory=list)

    def by_tenant(self, tenant_id: int) -> JobResult:
        for jr in self.jobs:
            if jr.tenant_id == tenant_id:
                return jr
        raise KeyError(f"no job with tenant_id {tenant_id}")

    @property
    def jobs_per_sec(self) -> float:
        return len(self.jobs) / max(self.elapsed_seconds, 1e-12)

    @property
    def latencies(self) -> np.ndarray:
        return np.array([jr.latency_seconds for jr in self.jobs])

    @property
    def p50_latency_s(self) -> float:
        return float(np.percentile(self.latencies, 50)) if self.jobs else 0.0

    @property
    def p99_latency_s(self) -> float:
        return float(np.percentile(self.latencies, 99)) if self.jobs else 0.0

    @property
    def fairness(self) -> float:
        """The slowest tenant's epoch share of the fair rate (one grant a
        round); round-robin granting makes it 1.0."""
        if not self.jobs:
            return 1.0
        return min(jr.epoch_share for jr in self.jobs)


class _JobRun:
    """Scheduler-internal state of one admitted job."""

    def __init__(self, job: Job, fabric: dict, tracer, metrics, num_servers: int) -> None:
        self.job = job
        self.label = f"tenant{job.tenant_id}"
        self.device = fabric["device"]
        self.t_admit = time.perf_counter()
        self.rounds_active = 0
        self.epochs_granted = 0
        self.packed_epochs = 0
        self.delivered: list[WireBatch] = []
        self.result: JobResult | None = None

        values = job.values.to(self.device)
        arrivals = interleave_batch(
            split_flows(values, job.num_flows, fabric["payload_size"]),
            job.interleave_mode, seed=job.seed,
        ).with_tenant(job.tenant_id)
        S = fabric["num_segments"]
        affinity = None
        if job.range_mode == "sampled":
            plane = AdaptiveControlPlane(
                S, job.max_value, seed=job.seed, tracer=tracer, metrics=metrics, label=self.label,
            )
            self.units = plane.split_epochs(arrivals)
            affinity = plane.pool_affinity(num_servers)[: S * len(self.units)]
        elif job.range_mode == "oracle":
            self.units = [(quantile_ranges(values, S, job.max_value).cpu(), arrivals)]
        else:  # static
            self.units = [(set_ranges(job.max_value, S, device="cpu"), arrivals)]
        self.next_unit = 0
        self.pool = ServerPool(
            S, num_servers, num_epochs=len(self.units), k=job.k, affinity=affinity,
            merge_backend=fabric["merge_backend"], recovery=fabric["recovery"],
            tracer=tracer, metrics=metrics, device=self.device,
        )

    @property
    def done(self) -> bool:
        return self.next_unit >= len(self.units)

    def deliver(self, epoch_index: int, out: WireBatch, S: int) -> None:
        """Bank one epoch's delivered wire under its virtual-segment block,
        restamped with the owning tenant."""
        self.delivered.append(out.with_epoch(epoch_index, S).with_tenant(self.job.tenant_id))

    def finalize(self, tracer) -> JobResult:
        with tracer.span(f"egress:{self.label}", cat="egress", tenant=self.job.tenant_id):
            self.pool.ingest_batch(concat_batches(self.delivered, device=self.device))
            out, passes = self.pool.finish()
            _sync(self.device)
        self.delivered = []
        self.result = JobResult(
            tenant_id=self.job.tenant_id,
            output=out,
            passes=passes,
            n=int(self.job.values.numel()),
            range_mode=self.job.range_mode,
            num_epochs=len(self.units),
            epochs_granted=self.epochs_granted,
            rounds_active=self.rounds_active,
            packed_epochs=self.packed_epochs,
            latency_seconds=time.perf_counter() - self.t_admit,
            server_keys=self.pool.server_keys,
            server_imbalance=self.pool.server_imbalance,
        )
        return self.result


def _install(ranges: torch.Tensor, fabric: dict) -> torch.Tensor:
    """The range table where the engine reads it: the device program
    builds from a host table, the other engines route on the device."""
    ranges = ranges.to(torch.int64)
    return ranges.cpu() if fabric["engine"] == "device" else ranges.to(fabric["device"])


def _run_packed(grants, fabric: dict, tracer, metrics):
    """One fused/device fabric call serving every granted epoch at once.

    Tenant slot ``i`` gets the key block ``[i*D, i*D + max_value_i]`` and
    the virtual segments ``[i*S, (i+1)*S)``.  Returns the per-slot delivered
    wires (unshifted, local segment ids) and the optional network report."""
    S = fabric["num_segments"]
    stride = max(run.job.max_value for run, _, _ in grants) + 1
    shifted = []
    ranges_parts = []
    for i, (_run, ranges, sub) in enumerate(grants):
        shifted.append(dataclasses.replace(sub, values=sub.values + i * stride))
        ranges_parts.append(ranges.cpu().to(torch.int64) + i * stride)
    combined = torch.cat(ranges_parts, dim=0)
    batch = merge_round_robin_batches(shifted, device=fabric["device"])
    del shifted
    topo = make_topology(
        fabric["topology"],
        num_segments=S * len(grants),
        segment_length=fabric["segment_length"],
        max_value=int(combined[-1, 1]) - 1,
        ranges=_install(combined, fabric),
        engine=fabric["engine"],
        payload_size=fabric["payload_size"],
        **fabric["topo_kw"],
    )
    res = topo.run_batch(batch, tracer=tracer, metrics=metrics, network=fabric["network"])
    del batch
    if fabric["network"] is None:
        out, _stats = res
        report = None
    else:
        out, _stats, report = res
    starts_d = out.packet_starts()
    starts = starts_d.cpu().numpy()
    sizes = np.diff(np.concatenate([starts, [len(out)]]))
    pf = out.flow_id[starts_d].cpu().numpy()
    ps = out.seq[starts_d].cpu().numpy()
    pg = out.segment_id[starts_d].cpu().numpy()
    dev = out.device
    outs = []
    for i in range(len(grants)):
        sel = np.nonzero(pg // S == i)[0]
        if fabric["recovery"] and sel.size > 1:
            # A raw (timed) egress wire can hold a retransmit copy between
            # two tenants' packets; stripping the other tenants would sit
            # the copy next to its original and fuse them (boundaries are
            # header runs): deliver the first of adjacent identical copies.
            dup = (
                (pf[sel][1:] == pf[sel][:-1])
                & (ps[sel][1:] == ps[sel][:-1])
                & (pg[sel][1:] == pg[sel][:-1])
            )
            keep = np.ones(sel.size, dtype=bool)
            keep[1:] = ~dup
            sel = sel[keep]
        sel_sizes = sizes[sel]
        sub = out.take(ragged_gather(
            torch.from_numpy(starts[sel]).to(dev), torch.from_numpy(sel_sizes).to(dev),
            int(sel_sizes.sum()),
        ))
        outs.append(dataclasses.replace(
            sub, values=sub.values - i * stride, segment_id=sub.segment_id - i * S,
        ))
    return outs, report


def _run_solo_unit(run: _JobRun, ranges, sub, fabric: dict, tracer, metrics):
    """One tenant's epoch on the fabric, as the single-job pipeline runs it."""
    topo = make_topology(
        fabric["topology"],
        num_segments=fabric["num_segments"],
        segment_length=fabric["segment_length"],
        max_value=run.job.max_value,
        ranges=_install(ranges, fabric),
        engine=fabric["engine"],
        payload_size=fabric["payload_size"],
        **fabric["topo_kw"],
    )
    res = topo.run_batch(sub, tracer=tracer, metrics=metrics, network=fabric["network"])
    if fabric["network"] is None:
        out, _stats = res
        return out, None
    out, _stats, report = res
    return out, report


def run_jobs(
    jobs: list[Job],
    *,
    topology: str = "single",
    num_segments: int = 16,
    segment_length: int = 32,
    engine: str = "fused",
    payload_size: int = DEFAULT_PAYLOAD,
    max_inflight: int = 4,
    num_servers: int = 1,
    merge_backend: str = "numpy",
    network=None,
    recovery: bool | None = None,
    pack: bool = True,
    verify: bool = False,
    tracer=None,
    metrics=None,
    device="cuda",
    **topo_kw,
) -> MultiTenantResult:
    """Serve ``jobs`` concurrently over one shared fabric on ``device``.

    Every round each in-flight job is granted one epoch of its plan, and
    freed slots admit queued jobs FIFO.  On ``topology="single"`` with a
    batched engine a round's grants fuse into one fabric call
    (``pack=False`` runs each grant alone: the packing tests' twin).
    ``network``/``recovery`` behave as in
    :func:`~repro_torch.net.pipeline.run_pipeline`.  Every job's output
    equals its solo ``run_pipeline`` run with the same fabric parameters:
    concurrency and packing change makespans, never bytes."""
    if len({j.tenant_id for j in jobs}) != len(jobs):
        raise ValueError("tenant_id must be unique per job")
    dev = resolve_device(device)
    if recovery is None:
        recovery = network is not None
    tr = tracer or NULL_TRACER
    fabric = dict(
        topology=topology,
        num_segments=num_segments,
        segment_length=segment_length,
        engine=engine,
        payload_size=payload_size,
        network=network,
        recovery=recovery,
        merge_backend=merge_backend,
        device=dev,
        topo_kw=topo_kw,
    )
    packable = topology == "single" and engine in PACKABLE_ENGINES and pack

    admission = AdmissionController(max_inflight)
    for job in jobs:
        admission.submit(job)
    runs: dict[int, _JobRun] = {}
    results: list[JobResult] = []
    reports: list = []
    rounds = 0
    fabric_calls = 0
    packed_calls = 0
    _sync(dev)
    t0 = time.perf_counter()
    with tr.span("mt:serve", cat="scheduler", jobs=len(jobs)):
        while admission.active:
            for job in admission.admit():
                runs[job.tenant_id] = _JobRun(job, fabric, tr, metrics, num_servers)
            rounds += 1
            grants = []  # (run, ranges, sub) in admission order
            for job in admission.inflight:
                run = runs[job.tenant_id]
                run.rounds_active += 1
                ranges, sub = run.units[run.next_unit]
                grants.append((run, ranges, sub))
            with tr.span("mt:round", cat="scheduler", round=rounds, tenants=len(grants)):
                if packable and len(grants) > 1:
                    outs, report = _run_packed(grants, fabric, tr, metrics)
                    fabric_calls += 1
                    packed_calls += 1
                    for (run, _r, _s), out in zip(grants, outs):
                        run.deliver(run.next_unit, out, num_segments)
                        run.packed_epochs += 1
                else:
                    for run, ranges, sub in grants:
                        out, report = _run_solo_unit(run, ranges, sub, fabric, tr, metrics)
                        fabric_calls += 1
                        if report is not None:
                            reports.append(report)
                        run.deliver(run.next_unit, out, num_segments)
                    report = None
            if report is not None:
                reports.append(report)
            for run, _r, _s in grants:
                run.units[run.next_unit] = None  # its fabric pass is done
                run.next_unit += 1
                run.epochs_granted += 1
                if metrics is not None:
                    metrics.counter("mt_epochs_granted", run.label).inc()
                if run.done:
                    results.append(run.finalize(tr))
                    admission.release(run.job)
        if metrics is not None:
            metrics.counter("mt_rounds").inc(rounds)
            metrics.counter("mt_fabric_calls").inc(fabric_calls)
            metrics.counter("mt_packed_calls").inc(packed_calls)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    if verify:
        for jr in results:
            want = torch.sort(runs[jr.tenant_id].job.values.to(dev)).values
            if not torch.equal(jr.output, want):
                raise AssertionError(f"tenant {jr.tenant_id}: output differs from its sorted keys")
    return MultiTenantResult(
        jobs=results,
        rounds=rounds,
        fabric_calls=fabric_calls,
        packed_calls=packed_calls,
        elapsed_seconds=elapsed,
        network_reports=reports,
    )


def run_job_solo(job: Job, **fabric_kw):
    """The J = 1 twin: the same job through the single-tenant
    :func:`~repro_torch.net.pipeline.run_pipeline` with matching fabric
    parameters (the keywords of :func:`run_jobs`, ``device`` included)."""
    from .pipeline import run_pipeline

    fabric_kw.pop("max_inflight", None)
    fabric_kw.pop("pack", None)
    return run_pipeline(
        job.values,
        num_flows=job.num_flows,
        interleave_mode=job.interleave_mode,
        seed=job.seed,
        range_mode=job.range_mode,
        k=job.k,
        max_value=job.max_value,
        **fabric_kw,
    )
