#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--n KEYS] [--seed S] [--profile]

Phases, one JSON line each:

1. ``device``   -- the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the seconds the hand-written kernels took to build from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel);
2. ``k1``       -- kernel K1 (row sort) against its plain torch version, for
   exact equality, int32 and int64, widths 2..4096, ragged pads;
3. ``k2``       -- kernel K2 (tournament merge) the same way, up to shapes
   above 2^22 keys;
4. ``pipeline`` -- ``repro_torch.net.pipeline.run_pipeline`` on the card: first
   byte-identical to the same call on the CPU (plain versions) at small n,
   then once at the full size (default 100M keys, the paper's §6 trace size)
   with the ``end_to_end`` configuration of ``benchmarks/net_bench.py``
   (7-hop binary tree, 16 segments of length 64, 256-key packets, 8 flows,
   oracle ranges, 4 arena servers, a 2-column int64 payload).  The launch
   counters are zeroed just before that run and read just after it;
5. ``kernels``  -- every ported kernel on fresh random rows at the largest
   shape and dtype the main path gave it: launches, exact agreement with the
   plain version, and kernel, plain and ``torch.sort`` times (CUDA events,
   median of 10 after a warm-up) beside the bound.

Then the card's name and power limit, then ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before that line.  Without a CUDA device, or
without the port beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks the bound is computed against.  Bytes: HBM3 at 3.35 TB/s
#: (NVIDIA's data sheet).  Operations: a compare-exchange runs on the integer
#: ALUs, not on the float32 pipes: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
#: (the Hopper architecture whitepaper) is 16.7e12 32-bit integer operations
#: per second.  A compare-exchange costs 2 of them on int32 keys (min and
#: max) and 6 on int64 keys (a 64-bit compare is two 32-bit compares, and
#: min and max each select two 32-bit halves).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COMPARE_EXCHANGE = {4: 2, 8: 6}

E2E = dict(
    topology="tree", branching=2, height=3, num_segments=16,
    segment_length=64, payload_size=256, num_flows=8, k=10,
    range_mode="oracle", num_servers=4, merge_backend="arena",
)
E2E_HOPS = 7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def exact(a, b) -> int:
    """Max absolute difference of two integer tensors (0 when equal)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/{b.dtype}")
    if torch.equal(a, b):
        return 0
    return int((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def log2(n: int) -> int:
    return n.bit_length() - 1


def k1_work(rows: int, b: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of sorting ``rows`` rows of width ``b``."""
    s = log2(b)
    return 2.0 * rows * b * itemsize, rows * (b // 2) * s * (s + 1) / 2


def k2_work(p: int, b: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of the tournament over a (p, b) matrix:
    round w merges row pairs with log2(2w) stages of n/2 pairs."""
    n = p * b
    ce, w = 0, b
    while w < n:
        ce += (n // 2) * log2(2 * w)
        w *= 2
    return 2.0 * n * itemsize, float(ce)


def bound(bytes_: float, ce: float, itemsize: int) -> tuple[float, str]:
    """Least milliseconds on the card, and which of bytes and operations
    sets it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_COMPARE_EXCHANGE[itemsize] * ce / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class StageClock:
    """Duck-typed null tracer that times the pipeline's top-level stages.

    It records nothing into the run (``enabled`` is False, as for the null
    tracer); spans of the ``pipeline`` and ``hop`` categories synchronise the
    card on entry and exit so that their wall seconds are device time.
    """

    enabled = False

    def __init__(self) -> None:
        import torch

        from repro_torch.obs.trace import NULL_TRACER

        self._null = NULL_TRACER
        self._torch = torch
        self.seconds: dict[str, float] = {}

    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        if cat not in ("pipeline", "hop"):
            return self._null.span(name, cat, tid, **args)
        clock = self

        class _Span:
            def __enter__(self):
                clock._torch.cuda.synchronize()
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                clock._torch.cuda.synchronize()
                clock.seconds[name] = time.perf_counter() - self.t0
                return False

            def set(self, **kw):
                pass

        return _Span()

    def timed(self, name: str, cat: str = "", tid: int = 0, **args):
        return self._null.timed(name, cat, tid, **args)

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        pass


class LargestShape:
    """Records the shape and dtype of the largest input a kernel wrapper was
    called with on the main path (what the kernel phase times); it copies no
    data, and launches are counted by the wrapper itself, unchanged."""

    def __init__(self, module, attr: str) -> None:
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.shape: tuple[int, ...] = ()
        self.dtype = None
        self.numel = -1

    def __call__(self, x):
        if x.numel() > self.numel:
            self.shape, self.dtype, self.numel = tuple(x.shape), x.dtype, x.numel()
        return self.orig(x)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False


def main_path_input(torch, gen, shape, dtype, *, sorted_rows: bool):
    """Fresh random rows at a main-path kernel shape: keys in the range the
    100M-key run gives the kernel (15-bit trace keys for K1; packed
    ``(key << 27) | row`` records, below 2^42, for K2), each row's ragged
    tail padded with the dtype max, rows sorted for K2.  Both networks are
    data-oblivious: their time depends on the shape alone."""
    rows, b = shape
    hi = (1 << 42) if dtype == torch.int64 and sorted_rows else 1 << 15
    x = torch.randint(0, hi, shape, dtype=dtype, device="cuda", generator=gen)
    # a bucket of width b holds runs longer than b/2 (K2); K1 rows end anywhere
    lo = b // 2 + 1 if sorted_rows else 1
    cut = torch.randint(lo, b + 1, (rows, 1), device="cuda", generator=gen)
    x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, torch.iinfo(dtype).max)
    if sorted_rows:
        x = torch.sort(x, dim=1).values
    return x.contiguous()


def phase_k1(bt, torch, gen) -> None:
    checked = 0
    worst = 0
    for dtype in (torch.int32, torch.int64):
        hi = torch.iinfo(dtype).max
        for b in (2, 64, 128, 1024, 4096):
            for rows in (1, 7, 1000):
                x = torch.randint(-1000, 1000, (rows, b), dtype=dtype, device="cuda", generator=gen)
                # ragged pads: a random tail of each row is the sentinel
                cut = torch.randint(0, b + 1, (rows, 1), device="cuda", generator=gen)
                x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi).contiguous()
                got = bt.sort_rows(x)
                want = bt.sort_rows_plain(x)
                worst = max(worst, exact(got, want))
                if not torch.equal(got, torch.sort(x, dim=1).values):
                    fail(f"K1 disagrees with torch.sort at {dtype} {rows}x{b}")
                checked += 1
    torch.cuda.synchronize()
    if worst:
        fail(f"K1 differs from sort_rows_plain by {worst}")
    emit({"phase": "k1", "cases": checked, "max_abs_err": worst})


def phase_k2(bt, torch, gen) -> None:
    checked = 0
    worst = 0
    shapes = [(2, 2), (2, 4096), (1024, 64), (64, 1024), (4096, 2),
              (1 << 17, 64), (1 << 16, 128), (2, 1 << 22)]
    for dtype in (torch.int32, torch.int64):
        hi = torch.iinfo(dtype).max
        for p, b in shapes:
            x = torch.randint(0, 1 << 30, (p, b), dtype=dtype, device="cuda", generator=gen)
            cut = torch.randint(1, b + 1, (p, 1), device="cuda", generator=gen)
            x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi)
            x = torch.sort(x, dim=1).values.contiguous()
            got = bt.merge_tournament(x)
            want = bt.tournament_plain(x)
            worst = max(worst, exact(got, want))
            if not torch.equal(got, torch.sort(x.reshape(-1)).values):
                fail(f"K2 disagrees with torch.sort at {dtype} {p}x{b}")
            checked += 1
            del x, got, want
    torch.cuda.synchronize()
    if worst:
        fail(f"K2 differs from tournament_plain by {worst}")
    emit({"phase": "k2", "cases": checked, "max_abs_err": worst,
          "largest_keys": max(p * b for p, b in shapes)})


def parity_small(torch, np, run_pipeline, random_trace) -> list[int]:
    """The card's run against the plain versions on the CPU, column by column."""
    sizes = [20_000, 300_000]
    for n in sizes:
        vals = random_trace(n, seed=1)
        payload = np.stack([vals * 7 + 3, np.arange(n)], axis=1).astype(np.int64)
        cols = []
        for dev in ("cuda", "cpu"):
            r = run_pipeline(vals, payload=payload, seed=1, device=dev, **E2E)
            d = r.to_numpy()
            cols.append(d)
        a, b = cols
        for key in ("output", "payload_row_order", "sorted_payload"):
            if not np.array_equal(a[key], b[key]):
                fail(f"card and CPU disagree on {key} at n={n}")
        if a["passes"] != b["passes"]:
            fail(f"card and CPU disagree on passes at n={n}")
        for c in ("values", "flow_id", "seq", "segment_id", "row_index"):
            if not np.array_equal(a["delivered"][c], b["delivered"][c]):
                fail(f"card and CPU disagree on delivered {c} at n={n}")
        for sa, sb in zip(a["hop_stats"], b["hop_stats"]):
            for f, v in sa.items():
                same = np.array_equal(v, sb[f]) if isinstance(v, np.ndarray) else v == sb[f]
                if not same:
                    fail(f"card and CPU disagree on hop stat {f} at n={n}")
        if not np.array_equal(a["output"], np.sort(vals)):
            fail(f"output is not the sorted input at n={n}")
    return sizes


def phase_profile(torch, run_pipeline, values_d, payload_d, seed: int) -> None:
    """A second main-path run under ``torch.profiler``: device busy share
    (kernel and copy time over wall time) and the device time by kernel."""
    from repro_torch.data.traces import trace_max_value

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_pipeline(values_d, payload=payload_d, max_value=trace_max_value("random"),
                     seed=seed, device="cuda", **E2E)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    emit({"phase": "profile", "wall_s": wall, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / 1e3 / wall,
          "top_device_ms": [{"name": k[:90], "ms": v[0], "calls": v[1]} for k, v in top]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000_000, help="keys in the main run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile a second main-path run (device busy share, time by kernel)")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: the port (src/repro_torch) is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.core import mergesort
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.kernels import bitonic as bt
    from repro_torch.net.pipeline import run_pipeline

    smi = smi_line()
    t0 = time.perf_counter()
    build_s = bt.build_kernels()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s, "build_wall_s": time.perf_counter() - t0})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_k1(bt, torch, gen)
    phase_k2(bt, torch, gen)

    # -- pipeline -----------------------------------------------------------
    parity = parity_small(torch, np, run_pipeline, random_trace)
    n = args.n
    t_prep = time.perf_counter()
    trace = random_trace(n, seed=args.seed)
    payload = np.empty((n, 2), dtype=np.int64)
    payload[:, 0] = trace * 7 + 3
    payload[:, 1] = np.arange(n)
    values_d = torch.from_numpy(trace).cuda()
    payload_d = torch.from_numpy(payload).cuda()
    del payload
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t_prep
    clock = StageClock()
    torch.cuda.reset_peak_memory_stats()
    with LargestShape(bt, "sort_rows") as k1_in, LargestShape(bt, "merge_tournament") as k2_in:
        bt.reset_launches()
        mergesort.reset_branches()
        t_run = time.perf_counter()
        res = run_pipeline(
            values_d, payload=payload_d, max_value=trace_max_value("random"),
            seed=args.seed, tracer=clock, device="cuda", **E2E,
        )
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = dict(bt.LAUNCHES)
        branches = dict(mergesort.MERGE_BRANCHES)
    peak = torch.cuda.max_memory_allocated()
    want = torch.sort(values_d, stable=True)
    if not torch.equal(res.output, want.values):
        fail("pipeline output differs from torch.sort of the input")
    if not torch.equal(res.payload_row_order, want.indices):
        fail("payload_row_order differs from the stable argsort")
    if not torch.equal(res.sorted_payload, payload_d[want.indices]):
        fail("sorted_payload differs from payload[order]")
    if launches["row_sort"] != E2E_HOPS:
        fail(f"K1 launched {launches['row_sort']} times, want one per hop ({E2E_HOPS})")
    if launches["tournament"] < 1:
        fail("K2 never launched on the main path")
    if branches["ladder"] != 0:
        fail(f"merge_runs_flat took the host ladder {branches['ladder']} times")
    del want
    stages = {k: v for k, v in clock.seconds.items()}
    emit({"phase": "pipeline", "n": n, "config": E2E, "parity_with_cpu_at": parity,
          "prep_s": prep_s, "run_s": run_s, "keys_per_s": n / run_s,
          "stage_s": stages, "server_makespan_s": res.server_seconds,
          "per_server_s": res.per_server_seconds, "pool_merge_s": res.pool_merge_seconds,
          "server_keys": res.server_keys, "passes": res.passes,
          "peak_device_bytes": peak, "launches": launches, "merge_branches": branches})
    del res
    if args.profile:
        phase_profile(torch, run_pipeline, values_d, payload_d, args.seed)
    del values_d, payload_d
    torch.cuda.empty_cache()

    # -- kernels at the main path's largest inputs ----------------------------
    rows = []
    x1 = main_path_input(torch, gen, k1_in.shape, k1_in.dtype, sorted_rows=False)
    x2 = main_path_input(torch, gen, k2_in.shape, k2_in.dtype, sorted_rows=True)
    for name, x, kern, plain, lib, work, src, replaces in (
        ("row_sort", x1, bt.sort_rows, bt.sort_rows_plain,
         lambda x: torch.sort(x, dim=1).values, k1_work,
         "src/repro_torch/kernels/csrc/row_sort.cu", "src/repro/kernels/bitonic.py:174"),
        ("tournament", x2, bt.merge_tournament, bt.tournament_plain,
         lambda x: torch.sort(x.reshape(-1)).values, k2_work,
         "src/repro_torch/kernels/csrc/tournament.cu", "src/repro/kernels/bitonic.py:261"),
    ):
        err = exact(kern(x), plain(x))
        if err:
            fail(f"{name} differs from its plain version at the main-path shape")
        b_bytes, ce = work(x.shape[0], x.shape[1], x.element_size())
        b_ms, b_by = bound(b_bytes, ce, x.element_size())
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
            "ms": cuda_ms(lambda: kern(x)), "plain_ms": cuda_ms(lambda: plain(x)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lambda: lib(x)),
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
