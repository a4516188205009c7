"""Sort jobs through the paper's datapath on one card.

A job is one call of ``repro_torch.net.pipeline.run_pipeline`` with the
configuration's ``pipeline`` arguments, on keys and a payload made on the
card from ``(seed, job)``; the client waits for the sorted relation (a
synchronise) before it makes and submits the next job.  Set-up builds the
kernels the configuration lists and runs ``warmup_jobs`` jobs of their own
inputs (the device engine captures its epoch program in the first).

Two jobs of the window are judged once it has closed: one drawn from the
seed among the first ``harness.JUDGED_FROM``, whose outputs are copied to pinned
host memory as soon as it completes, and the last.
"""

from __future__ import annotations

import sys
import time

from sortbench import devtrace, generate, harness, work
from sortbench.clock import StageClock

_OUTPUTS = ("output", "row_order", "payload")


def _keep(outs: dict, host: dict, dev) -> dict:
    """Copy a job's outputs into the host buffers: ``name -> (rows, length)``."""
    kept = {}
    for k in _OUTPUTS:
        t = outs[k]
        if t is None:
            kept[k] = (None, 0)
            continue
        m = min(t.shape[0], host[k].shape[0])
        host[k][:m].copy_(t[:m], non_blocking=True)
        kept[k] = (host[k][:m], t.shape[0])
    harness.sync(dev)
    return kept


def run(ctx: harness.Context) -> int:
    import torch

    cell, cfg, mix = ctx.cell, ctx.cell.config, ctx.cell.mix
    dev = torch.device(ctx.device)
    n = int(ctx.keys or cfg["keys_per_job"])
    cols = int(cfg["payload_columns"])
    domain = int(mix["domain"])
    ref = harness.load_module(cell.root, "reference", cfg["reference"])

    from repro_torch.kernels import build
    from repro_torch.net import device_epoch
    from repro_torch.net import pipeline as pl

    harness.apply_patch(ctx.patch)
    if dev.type == "cuda":
        build.build_kernels(cfg["kernels"])
    kw = dict(cfg["pipeline"])
    clock = StageClock(dev) if ctx.trace else None

    def make(job: int):
        return (generate.job_keys(mix, n, ctx.seed, job, device=dev),
                generate.job_payload(cols, n, ctx.seed, job, device=dev))

    def submit(keys, payload, job: int) -> dict:
        if ctx.control:
            return dict(ref.control(keys, payload), server_s=None, runs=0)
        res = pl.run_pipeline(keys, payload=payload, max_value=domain - 1,
                              seed=generate.mix_seed(ctx.seed, job) % (1 << 32), tracer=clock, device=dev,
                              **kw)
        return {"output": res.output, "row_order": res.payload_row_order, "payload": res.sorted_payload,
                "server_s": res.server_seconds, "runs": res.hop_stats[-1].emitted_runs}

    for w in range(int(cfg["warmup_jobs"])):
        keys, payload = make(-1 - w)
        submit(keys, payload, -1 - w)
        del keys, payload
        harness.sync(dev)
    if clock is not None:
        clock.seconds, clock.jobs = {}, 0
    pin = dev.type == "cuda"
    host = {"output": torch.empty(n, dtype=torch.int64, pin_memory=pin),
            "row_order": torch.empty(n, dtype=torch.int64, pin_memory=pin),
            "payload": torch.empty((n, max(cols, 1)), dtype=torch.int64, pin_memory=pin)}
    sample = generate.sample_index(ctx.seed, harness.JUDGED_FROM)
    harness.sync(dev)
    setup_s = time.time() - ctx.t0_wall

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prof = devtrace.profiler() if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    label = torch.profiler.record_function(devtrace.WINDOW)
    label.__enter__()
    jobs, cpu_s, server_s, runs, kept = [], [], [], [], None
    keys = payload = outs = None
    t_start = time.perf_counter()
    j = 0
    while True:
        keys = payload = outs = None
        t_job, c_job = time.perf_counter(), time.process_time()
        keys, payload = make(j)
        outs = submit(keys, payload, j)
        harness.sync(dev)
        t_end = time.perf_counter()
        jobs.append(t_end - t_job)
        cpu_s.append(time.process_time() - c_job)
        server_s.append(outs["server_s"])
        runs.append(outs["runs"])
        if j == sample:
            kept = _keep(outs, host, dev)
        j += 1
        if t_end - t_start >= ctx.seconds:
            break
    label.__exit__(None, None, None)
    window_s = t_end - t_start
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = devtrace.read_trace(prof)
        del prof

    # The window has closed: free the program's state, then judge.
    last = {k: (outs[k], outs[k].shape[0] if outs[k] is not None else 0) for k in _OUTPUTS}
    del keys, payload, outs
    device_epoch.clear_program_cache()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    judged = {j - 1: last}
    if kept is not None and sample != j - 1:
        judged[sample] = kept
    compared = {k: 0 for k in ref.LIMITS}
    failed = 0
    for job, got in sorted(judged.items()):
        keys, payload = make(job)
        found = ref.judge(got, keys, payload)
        failed += any(v > ref.LIMITS[k] for k, v in found.items())
        for k, v in found.items():
            compared[k] += v
        del keys, payload
    n_judged = len(judged)
    judged_ids = sorted(judged)
    del last, judged, kept, host

    levels = work.fabric_levels(kw)
    block = int(kw["segment_length"])
    k1_cell = work.cell_bytes(work.bits(domain) + work.log2(block))
    k2_cell = work.cell_bytes(work.bits(domain) + (work.bits(n) if cols else 0))
    segs = int(kw["num_segments"])
    r = harness.Readings(
        cell=cell, jobs=len(jobs), keys=len(jobs) * n, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        stages=dict(clock.seconds, jobs=clock.jobs) if clock is not None else None,
        server_s=server_s, traces=[trace] if trace is not None else None,
        work={"k1_least_s": len(jobs) * work.block_sort_seconds(n * levels, block, k1_cell),
              "k2_least_s": sum(work.merge_seconds(n, rn / segs, k2_cell) for rn in runs)})
    print(f"sortbench: {harness.job_summary(jobs)}; the process on a CPU {sum(cpu_s) / sum(jobs):.3f} of "
          f"their time; set-up {setup_s:.3f} s; judged jobs {judged_ids}", file=sys.stderr)
    name = torch.cuda.get_device_name() if dev.type == "cuda" else "cpu"
    return harness.report(ctx, r, compared, ref.LIMITS, judged=n_judged, device_name=name, count=1,
                          attempted=len(jobs), failed=failed)
