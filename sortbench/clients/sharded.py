"""Range sort jobs over a host's cards: ``repro_torch.core.distributed.sort_sharded``.

The process that runs the command starts one process a rank (``spawn``),
each on its own card in one NCCL group (gloo on the CPU in the tests), and
waits for them.  A job: every rank makes its ``keys_per_job`` keys on its
card from ``(seed, job, rank)``, takes its strided sample, the samples are
all-gathered and the program's control plane (``make_splitters``, on the
host) turns them into splitters, and ``sort_sharded`` routes, presorts on K1,
exchanges and sorts.  The client waits for every rank (the all-reduce of
rank 0's stop flag) before the next job.

Two jobs are judged on every rank once the window has closed, as in the
one-card client: one drawn from the seed among the first few (its valid
keys copied to pinned host memory at once) and the last.  Each rank's
output is judged against its slice of the whole job sorted, placed by the
valid counts of the ranks below it.  Rank 0 prints.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

from sortbench import devtrace, generate, harness, work

#: Seconds the ranks may take past the window before they are stopped.
GRACE_S = 300


def run(ctx: harness.Context) -> int:
    import multiprocessing as mp

    world = int(ctx.cell.config["ranks"])
    if ctx.device == "cuda":
        # One build for every rank, before any of them starts.
        from repro_torch.kernels import bitonic  # noqa: F401 (registers the kernels)
        from repro_torch.kernels import build

        build.build_kernels(ctx.cell.config["kernels"])
    tmp = tempfile.mkdtemp(prefix="sortbench-rdv-")
    procs = []
    try:
        spawn = mp.get_context("spawn")
        procs = [spawn.Process(target=_rank, args=(ctx, r, world, os.path.join(tmp, "rdv")))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + ctx.seconds + GRACE_S
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        codes = []
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
                print(f"sortbench: rank {procs.index(p)} did not end and was stopped", file=sys.stderr)
                codes.append(1)
            else:
                codes.append(p.exitcode)
        return next((c for c in codes if c), 0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank(ctx: harness.Context, rank: int, world: int, rdv: str) -> None:
    harness.prepare_paths(ctx.cell.root)
    sys.exit(_rank_body(ctx, rank, world, rdv))


def _rank_body(ctx: harness.Context, rank: int, world: int, rdv: str) -> int:
    import torch
    import torch.distributed as dist

    cfg, mix = ctx.cell.config, ctx.cell.mix
    n = int(ctx.keys or cfg["keys_per_job"])
    per_rank = int(cfg["sample_per_rank"])
    cuda = ctx.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{rdv}", world_size=world,
                            rank=rank)
    try:
        return _window(ctx, rank, world, dev, n, per_rank, cfg, mix)
    finally:
        dist.destroy_process_group()


def _window(ctx, rank, world, dev, n, per_rank, cfg, mix) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as cd
    from repro_torch.distributed.compat import make_mesh

    ref = harness.load_module(ctx.cell.root, "reference", cfg["reference"])
    harness.apply_patch(ctx.patch)
    cuda = dev.type == "cuda"
    mesh = make_mesh((world,), ("segment",), dev.type)
    kw = dict(capacity_factor=float(cfg["capacity_factor"]), presort_block=int(cfg["presort_block"]))

    def make(job: int, r: int = rank):
        return generate.job_keys(mix, n, ctx.seed, job, r, device=dev)

    def submit(x, job: int):
        if ctx.control:
            return ref.control(rank, world, [make(job, r) for r in range(world)])
        smp = generate.strided_sample(x, per_rank)
        parts = [torch.empty_like(smp) for _ in range(world)]
        dist.all_gather(parts, smp)
        splitters = cd.make_splitters(torch.cat(parts).cpu().numpy(), world)
        return cd.sort_sharded(x, mesh, "segment", splitters, **kw)

    def agree(flag: bool) -> bool:
        t = torch.tensor([int(flag)], device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    for w in range(int(cfg["warmup_jobs"])):
        x = make(-1 - w)
        submit(x, -1 - w)
        del x
        harness.sync(dev)
        agree(False)
    sample = generate.sample_index(ctx.seed, harness.JUDGED_FROM)
    host = torch.empty(int(n * kw["capacity_factor"]), dtype=torch.int64, pin_memory=cuda)
    harness.sync(dev)
    agree(False)
    setup_s = time.time() - ctx.t0_wall

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = devtrace.profiler() if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    label = torch.profiler.record_function(devtrace.WINDOW)
    label.__enter__()
    jobs, kept = [], None
    x = out = None
    overflow = torch.zeros(1, dtype=torch.int64, device=dev)
    t_start = time.perf_counter()
    j = 0
    while True:
        x = out = None
        t_job = time.perf_counter()
        x = make(j)
        out = submit(x, j)
        overflow += out[2].to(dev)
        harness.sync(dev)
        stop = agree(rank == 0 and time.perf_counter() - t_start >= ctx.seconds)
        t_end = time.perf_counter()
        jobs.append(t_end - t_job)
        if j == sample:
            valid = int(out[1][0])
            m = min(valid, host.numel())
            host[:m].copy_(out[0][:m], non_blocking=True)
            harness.sync(dev)
            kept = (host[:m], valid, int(out[2][0]))
        j += 1
        if stop:
            break
    label.__exit__(None, None, None)
    window_s = t_end - t_start
    peak = torch.tensor([torch.cuda.max_memory_allocated() if cuda else 0], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = devtrace.read_trace(prof)
        del prof

    # The window has closed: free the program's state, then judge.
    valid = int(out[1][0])
    last = (out[0][:valid], valid, int(out[2][0]))
    del x, out
    if cuda:
        torch.cuda.empty_cache()
    judged = {j - 1: last}
    if kept is not None and sample != j - 1:
        judged[sample] = kept
    found = torch.zeros(len(judged), len(ref.LIMITS), dtype=torch.int64, device=dev)
    for i, (job, (got, nvalid, over)) in enumerate(sorted(judged.items())):
        valids = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
        dist.all_gather(valids, torch.tensor([nvalid], dtype=torch.int64, device=dev))
        nums = ref.judge(rank, got, [int(v) for v in valids], over, [make(job, r) for r in range(world)])
        found[i] = torch.tensor([nums[k] for k in ref.LIMITS])
    dist.all_reduce(found)
    dist.all_reduce(overflow)
    del last, judged, kept, host
    if trace is not None and rank != 0:
        trace.host = []  # the breakdown names rank 0's idle gaps alone
    traces = [None] * world
    dist.all_gather_object(traces, trace)
    if rank != 0:
        return 0

    limits = list(ref.LIMITS.values())
    compared = {k: int(found[:, i].sum()) for i, k in enumerate(ref.LIMITS)}
    # Keys dropped for capacity count over every job of the window, not the
    # judged ones alone.
    compared["overflow"] = int(overflow.item())
    failed = sum(any(int(v) > lim for v, lim in zip(row.tolist(), limits)) for row in found)
    cell = work.cell_bytes(work.bits(int(mix["domain"])))
    r = harness.Readings(
        cell=ctx.cell, jobs=len(jobs), keys=len(jobs) * n * world, window_s=window_s, setup_s=setup_s,
        peak_bytes=int(peak.item()), traces=[t for t in traces if t is not None] or None,
        work={"k1_least_s": world * len(jobs) * work.block_sort_seconds(n, kw["presort_block"], cell)})
    print(f"sortbench: {harness.job_summary(jobs)}; set-up {setup_s:.3f} s; judged jobs "
          f"{sorted(set([j - 1, sample]) & set(range(j)))}", file=sys.stderr)
    name = torch.cuda.get_device_name() if cuda else "cpu"
    return harness.report(ctx, r, compared, ref.LIMITS, judged=found.shape[0], device_name=name, count=world,
                          attempted=len(jobs), failed=failed)
