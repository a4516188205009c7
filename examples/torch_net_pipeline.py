"""The paper's Fig. 1 as a network on the PyTorch port: flows -> switch
fabric -> streaming server.  The twin of ``examples/net_pipeline.py`` on
``repro_torch``, with the same flags plus ``--device`` (default ``cuda``:
every hop's row sort on K1, the arena servers' merges on K2; ``cpu`` runs
their plain versions).

Four storage servers stream packets through a switch topology that runs
MergeMarathon at every hop; the compute server overlaps its k-way merge with
packet arrival and never holds the unsorted stream in memory.

    python examples/torch_net_pipeline.py [--n 400000] [--trace drifting]
        [--topology single|leaf_spine|tree] [--interleave bursty]
        [--engine fused|segment|faithful|device] [--payload-bytes 16]
        [--jitter 8] [--ranges static|oracle|sampled] [--servers 4]
        [--merge-backend numpy|arena] [--trace-out out.json] [--metrics]
        [--link-latency 2] [--link-rate 4/1] [--buffer 4]
        [--loss-rate 0.02] [--loss-policy drop|backpressure]
        [--jobs 4] [--max-inflight 2] [--device cuda|cpu]

``--engine`` picks the hop implementation at every switch: the production
``fused`` batched engine, the per-segment ``segment`` loops, the
element-at-a-time ``faithful`` Alg. 3 (slow — small ``--n``), or the
whole-epoch compiled ``device`` program (one program for the whole
fabric, captured as a CUDA graph on the card, keys device-resident from ingest to the run-arena tournament,
exactly one host↔device transfer each way).  ``--payload-bytes N``
attaches an N-byte payload to every key — carried as packed key+row-index
records through the fabric (``fused``/``device`` only) and gathered
exactly once at egress — and the summary line reports keys/sec and
records/sec through the full pipeline.

``--servers S`` shards the egress across a segment-affinity pool of S
independent streaming servers (the paper's "sort each range separately and
then concatenate") — byte-identical output, per-server load and makespan
printed per server.  ``--merge-backend arena`` swaps every server's eager
numpy merge ladder for the device-resident run-arena tournament (same
output and pass counts, different wall-clock — sweep both to see the
``server_throughput`` bench section live).

``--trace-out out.json`` records the run with a :class:`repro_torch.obs.Tracer`
and writes a Chrome-trace-event JSON — open it at https://ui.perfetto.dev
to see the hop/stage/server span timeline.  ``--metrics`` prints the
metrics-registry snapshot (per-hop key counters, run-length histograms,
reorder-depth series); ``--int`` stamps in-band per-hop metadata columns
onto the wire and prints their per-hop summary at egress.  All three are
byte-transparent: the sorted output is identical with or without them.

Any of ``--link-latency/--link-rate/--buffer/--loss-rate/--loss-policy``
turns on the per-link network timing model (:mod:`repro_torch.net.timing`):
every link gets the given latency (ticks), bandwidth (``NUMER[/DENOM]``
keys per tick), and bounded output buffer (packets; 0 = unbounded) with
the chosen overflow policy, and the wire loses packets at ``--loss-rate``
(NACK + replay from an ingress replay buffer).  The raw egress wire —
retransmit duplicates and all — is healed by the server pool's recovery
mode; the run prints the network makespan, loss/retransmit/stall
counters, and whether the network or the compute server bottlenecks.
The delivered sorted output stays byte-identical: loss costs time,
never keys.

``--jobs J`` switches to the multi-tenant serving plane
(:mod:`repro_torch.net.scheduler`): J concurrent sort jobs — ``--trace`` for
tenant 0, then mixed workloads — share one fabric through the fair
round-robin epoch scheduler with an ``--max-inflight`` admission budget;
on the single topology with a batched engine, a round's grants pack into
ONE fused/device call.  The run prints per-tenant latency, epoch share,
and scheduler totals (rounds, packed vs fabric calls, jobs/sec), and
verifies every tenant's output against ``np.sort`` of its own input.
Single-job-only flags (``--jitter``, ``--payload-bytes``, ``--int``) are
ignored in this mode.

``--fault-plan SPEC`` injects deterministic faults through the fail-open
recovery plane (:mod:`repro_torch.net.faults`): ``;``-separated entries like
``degrade:spine@0`` (pass-through forwarding — the paper's plain-sort
baseline), ``crash:l1n0@1-3`` (dead hop, flows reroute), ``flap:uplink:
leaf0@0`` (link latency/loss, healed by ARQ), ``server_crash:1@0.5``
(mid-stream shard failover to the nearest neighbor), and
``corrupt_ranges@0`` (control-plane table corruption, caught and replaced
by the static fallback).  The run prints the recovery counters; the
sorted output stays byte-identical to the fault-free run — faults cost
throughput, never keys.
"""

import argparse
import json
import time

import numpy as np
import torch

import _bootstrap  # noqa: F401

from repro_torch import resolve_device
from repro_torch.data import SCENARIOS, TRACES, scenario_max_value, trace_max_value
from repro_torch.net import (
    MERGE_BACKENDS,
    POLICIES,
    RANGE_MODES,
    Job,
    LinkSpec,
    NetworkConfig,
    plain_stream_sort,
    run_jobs,
    run_pipeline,
)
from repro_torch.obs import MetricsRegistry, Tracer

WORKLOADS = {**TRACES, **SCENARIOS}

# co-tenant workloads cycled after --trace in --jobs mode (adversarial
# first: the isolation claim is most interesting under a hostile neighbour)
JOB_CYCLE = ("adversarial_skew", "drifting", "sorted50", "duplicate_heavy")


def _workload_max(name: str) -> int:
    return (
        trace_max_value(name) if name in TRACES else scenario_max_value(name)
    )


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_jobs_mode(args, network, topo_kw, dev) -> None:
    """Serve ``--jobs`` concurrent tenants over one shared fabric."""
    names = [args.trace] + [w for w in JOB_CYCLE if w != args.trace]
    jobs = []
    for t in range(args.jobs):
        name = names[t % len(names)]
        vals = WORKLOADS[name](args.n, seed=t)
        jobs.append(
            Job(
                t, vals, seed=t, range_mode=args.ranges,
                max_value=_workload_max(name),
            )
        )
        print(f"tenant {t}: {name}, {vals.size:,} keys, {args.ranges} ranges")
    tracer = Tracer() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics else None
    res = run_jobs(
        jobs,
        topology=args.topology,
        engine=args.engine,
        num_segments=args.segments,
        segment_length=args.length,
        payload_size=args.payload,
        max_inflight=args.max_inflight,
        num_servers=args.servers,
        merge_backend=args.merge_backend,
        network=network,
        tracer=tracer,
        metrics=metrics,
        verify=True,
        device=dev,
        **topo_kw,
    )
    print(
        f"{args.topology} fabric ({args.engine} engine, admission budget "
        f"{args.max_inflight}): {res.rounds} rounds, "
        f"{res.packed_calls}/{res.fabric_calls} rounds packed into shared "
        f"calls, {res.elapsed_seconds:.3f}s wall"
    )
    for jr in sorted(res.jobs, key=lambda j: j.tenant_id):
        print(
            f"  tenant {jr.tenant_id}: {jr.n:>8,} keys, "
            f"{jr.num_epochs} epoch(s), share {jr.epoch_share:.2f}, "
            f"latency {jr.latency_seconds:.3f}s, "
            f"max {max(jr.passes)} passes"
        )
    print(
        f"{res.jobs_per_sec:.2f} jobs/sec, p50 {res.p50_latency_s:.3f}s, "
        f"p99 {res.p99_latency_s:.3f}s, fairness {res.fairness:.2f}"
    )
    if metrics is not None:
        print("metrics snapshot:")
        print(json.dumps(metrics.snapshot(), indent=2, sort_keys=True))
    if tracer is not None:
        tracer.dump(args.trace_out)
        print(
            f"wrote {args.trace_out} ({len(tracer.spans)} spans) — open at "
            f"ui.perfetto.dev"
        )
    print("every tenant's output == np.sort(its input) ✓")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400_000)
    ap.add_argument("--trace", choices=sorted(WORKLOADS), default="network",
                    help="a paper trace or a scenario workload")
    ap.add_argument("--topology", default="leaf_spine",
                    choices=["single", "leaf_spine", "tree"])
    ap.add_argument("--interleave", default="bursty",
                    choices=["round_robin", "bursty", "weighted_fair"])
    ap.add_argument("--engine", default="fused",
                    choices=["fused", "segment", "faithful", "device"],
                    help="hop implementation: fused batched (default), "
                    "per-segment loops, element-at-a-time faithful Alg. 3, "
                    "or the whole-epoch compiled device program (one "
                    "program per fabric, one host<->device transfer each way)")
    ap.add_argument("--payload-bytes", type=int, default=0, metavar="N",
                    help="attach an N-byte payload to every key (rounded up "
                    "to whole int64 columns); rides as packed key+row-index "
                    "records and is gathered once at egress "
                    "(fused/device engines only)")
    ap.add_argument("--segments", type=int, default=16)
    ap.add_argument("--length", type=int, default=64)
    ap.add_argument("--payload", type=int, default=256)
    ap.add_argument("--jitter", type=int, default=8,
                    help="bounded packet-reorder window at delivery")
    ap.add_argument("--ranges", default="static", choices=list(RANGE_MODES),
                    help="control plane: paper equal-width (static), "
                    "full-data quantiles (oracle), or adaptive online "
                    "estimation with mid-stream re-partitioning (sampled)")
    ap.add_argument("--servers", type=int, default=1,
                    help="egress pool size: shard the delivered stream by "
                    "segment affinity across this many independent "
                    "streaming servers (1 = the classic single server)")
    ap.add_argument("--merge-backend", default="numpy",
                    choices=list(MERGE_BACKENDS),
                    help="run-merge engine per server: the eager numpy "
                    "ladder or the device-resident run-arena tournament "
                    "(byte-identical output, different wall-clock)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record the run with a tracer and write a "
                    "Chrome-trace-event JSON (view at ui.perfetto.dev)")
    ap.add_argument("--metrics", action="store_true",
                    help="collect and print the metrics-registry snapshot")
    ap.add_argument("--link-latency", type=int, default=None, metavar="TICKS",
                    help="per-link propagation delay in ticks (1 tick = one "
                    "key at storage line rate); enables the network timing "
                    "model")
    ap.add_argument("--link-rate", default=None, metavar="NUMER[/DENOM]",
                    help="per-link bandwidth: NUMER keys per DENOM ticks "
                    "(e.g. 4/1, 1/2); omit for an unthrottled link")
    ap.add_argument("--buffer", type=int, default=None, metavar="PACKETS",
                    help="per-link output-buffer slots (0 = unbounded); "
                    "overflow follows --loss-policy")
    ap.add_argument("--loss-rate", type=float, default=None, metavar="P",
                    help="per-attempt wire loss probability (lost packets "
                    "are NACKed and replayed; loss costs time, never keys)")
    ap.add_argument("--loss-policy", default=None, choices=list(POLICIES),
                    help="buffer-overflow policy: drop (NACK + retransmit "
                    "from the replay buffer) or backpressure (the upstream "
                    "hop stalls)")
    ap.add_argument("--jobs", type=int, default=1, metavar="J",
                    help="serve J concurrent sort jobs over one shared "
                    "fabric via the fair round-robin scheduler (tenant 0 "
                    "runs --trace, co-tenants cycle mixed workloads); "
                    "1 = the classic single-job pipeline")
    ap.add_argument("--max-inflight", type=int, default=4, metavar="B",
                    help="admission budget in --jobs mode: at most B jobs "
                    "in flight; the rest queue FIFO")
    ap.add_argument("--int", dest="int_telemetry", action="store_true",
                    help="stamp in-band per-hop metadata columns (hop id, "
                    "queue depth, rank ticks) onto the wire and print the "
                    "per-hop summary observed at egress")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject faults (';'-separated): 'degrade:spine@0' "
                    "pass-through hop, 'crash:l1n0@1-3' dead hop + reroute, "
                    "'flap:uplink:leaf0@0' link flap, 'server_crash:1@0.5' "
                    "mid-stream shard failover, 'corrupt_ranges@0' range "
                    "table corruption — output stays byte-identical "
                    "(single-job mode only)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.merge_backend == "arena":
        print(
            "note: the arena backend builds its merge kernel on first use "
            "(one-time, ~seconds); the first run's timings include it"
        )

    network = None
    if any(
        v is not None
        for v in (args.link_latency, args.link_rate, args.buffer,
                  args.loss_rate, args.loss_policy)
    ):
        numer, denom = None, 1
        if args.link_rate is not None:
            parts = args.link_rate.split("/")
            numer = int(parts[0])
            denom = int(parts[1]) if len(parts) > 1 else 1
        network = NetworkConfig(
            link=LinkSpec(
                latency=args.link_latency or 0,
                rate_numer=numer,
                rate_denom=denom,
                buffer_packets=args.buffer or None,
                policy=args.loss_policy or "drop",
                loss_rate=args.loss_rate or 0.0,
            ),
        )

    topo_kw = (
        {"num_leaves": 4} if args.topology == "leaf_spine"
        else {"branching": 2, "height": 3} if args.topology == "tree"
        else {}
    )
    if args.jobs > 1:
        _run_jobs_mode(args, network, topo_kw, dev)
        return

    trace = WORKLOADS[args.trace](args.n)
    maxv = _workload_max(args.trace)

    payload = None
    if args.payload_bytes > 0:
        cols = -(-args.payload_bytes // 8)  # whole int64 columns
        payload = np.empty((trace.size, cols), dtype=np.int64)
        payload[:, 0] = trace * 7 + 3
        for c in range(1, cols):
            payload[:, c] = np.arange(trace.size) + c
        print(
            f"payload: {args.payload_bytes} bytes/key "
            f"({cols} int64 column(s)), gathered once at egress"
        )

    out, passes, t_plain = plain_stream_sort(trace, args.payload, device=dev)
    np.testing.assert_array_equal(out.cpu().numpy(), np.sort(trace))
    print(f"no switch: server {t_plain:.3f}s, {passes[0]} merge passes")

    tracer = Tracer() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics else None
    t_wall = time.perf_counter()
    res = run_pipeline(
        trace,
        topology=args.topology,
        engine=args.engine,
        payload=payload,
        interleave_mode=args.interleave,
        num_segments=args.segments,
        segment_length=args.length,
        max_value=maxv,
        payload_size=args.payload,
        num_flows=4,
        jitter_window=args.jitter,
        reorder_capacity=max(64, 4 * args.jitter),
        range_mode=args.ranges,
        network=network,
        num_servers=args.servers,
        merge_backend=args.merge_backend,
        fault_plan=args.fault_plan,
        tracer=tracer,
        metrics=metrics,
        int_telemetry=args.int_telemetry,
        verify=True,
        device=dev,
        **topo_kw,
    )
    _sync(dev)
    t_wall = time.perf_counter() - t_wall
    egress = (
        "server" if args.servers == 1
        else f"{args.servers}-server pool makespan"
    )
    print(
        f"{args.topology} fabric ({args.engine} engine, "
        f"{len(res.hop_stats)} hops, "
        f"{args.interleave} arrivals, jitter {args.jitter}, "
        f"{res.range_mode} ranges, {res.num_epochs} epoch(s), "
        f"{args.merge_backend} merge): "
        f"{egress} {res.server_seconds:.3f}s, max {max(res.passes)} passes "
        f"-> {100 * (1 - res.server_seconds / t_plain):.1f}% faster"
    )
    rate = trace.size / t_wall
    summary = f"pipeline wall {t_wall:.3f}s, {rate:,.0f} keys/sec"
    if payload is not None:
        summary += f", {rate:,.0f} records/sec ({args.payload_bytes} B payload)"
    print(summary)
    if args.servers > 1:
        for s, (secs, keys) in enumerate(
            zip(res.per_server_seconds, res.server_keys)
        ):
            print(f"  egress server {s}: {keys:>8} keys, {secs:.3f}s")
        print(
            f"  distributed merge: {res.pool_merge_seconds:.4f}s, "
            f"key imbalance {res.server_imbalance:.2f}"
        )
    for st in res.hop_stats:
        print(
            f"  hop {st.name:>6}: {st.arrivals:>8} keys, "
            f"{st.emitted_runs:>5} runs out (mean len {st.mean_run_len:.1f}), "
            f"imbalance {st.load_imbalance:.2f}, "
            f"{st.recirculations} recirculation passes"
        )
    print(f"reorder buffer high-water mark: {res.max_reorder_depth} packets")
    if args.fault_plan:
        print(
            f"fail-open recovery ({args.fault_plan}): "
            f"{res.fault_hops_dead} hop(s) dead (rerouted), "
            f"{res.fault_hops_degraded} hop(s) degraded (pass-through), "
            f"{res.servers_failed_over} shard failover(s), "
            f"{res.range_fallbacks} range-table fallback(s) — output still "
            f"byte-identical"
        )
    if res.network is not None:
        rep = res.network
        bound = "network" if rep.seconds >= res.server_seconds else "compute"
        print(
            f"network: makespan {rep.makespan_ticks} ticks "
            f"({rep.seconds:.4f}s @ {rep.config.tick_ns:.0f}ns/tick), "
            f"{rep.drops} drops, {rep.retransmits} retransmits, "
            f"{rep.duplicates} duplicates, {rep.stall_ticks} stall ticks "
            f"-> {bound}-bound"
        )
        if res.dup_packets_dropped or res.spilled_packets:
            print(
                f"  server recovery: {res.dup_packets_dropped} duplicate "
                f"packet(s) deduped, {res.spilled_packets} packet(s) "
                f"spilled ({res.spilled_keys} keys)"
            )
    if args.int_telemetry and res.telemetry and res.telemetry.get("int"):
        print("in-band telemetry (per hop, observed at egress):")
        for row in res.telemetry["int"]:
            print(
                f"  depth {row['depth']} hop {row['hop_id']}: "
                f"{row['keys']:>8} keys, queue depth "
                f"mean {row['mean_queue_depth']:.1f} / "
                f"max {row['max_queue_depth']}, rank ticks "
                f"mean {row['mean_rank_ticks']:.1f}"
            )
    if args.metrics:
        print("metrics snapshot:")
        print(json.dumps(res.telemetry and {
            k: v for k, v in res.telemetry.items() if k != "int"
        }, indent=2, sort_keys=True))
    if tracer is not None:
        tracer.dump(args.trace_out)
        print(
            f"wrote {args.trace_out} ({len(tracer.spans)} spans, "
            f"{len(tracer.instants)} instants) — open at ui.perfetto.dev"
        )
    if payload is not None:
        np.testing.assert_array_equal(
            res.sorted_payload[:, 0].cpu().numpy(), res.output.cpu().numpy() * 7 + 3
        )
        print("payload row gathered with its key at egress ✓")
    print("output == np.sort(input) ✓")


if __name__ == "__main__":
    main()
