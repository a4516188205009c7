#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--n KEYS] [--seed S] [--profile]

Three main paths: the sort dataplane (``run_pipeline``), the dense LM serve
path (``Engine`` over Mistral-Nemo-12B) and the MoE serve path (``Engine``
over granite-moe-3b-a800m).  Phases, one JSON line each:

1. ``device``   -- the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, and the seconds the six hand-written kernels took to build
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel);
2. ``k1``, ``k2`` -- kernels K1 (row sort) and K2 (tournament merge) against
   their plain torch versions, for exact equality, int32 and int64; K1 at
   every width 2..4096, row counts that leave a warp or a block part-filled,
   ragged pads, all-equal rows, the dtype's extreme keys and a view that is
   not 16-byte aligned; K2 up to 2^23 keys, all-pad rows, all-equal keys,
   one pair of 2^22-wide rows, rows wider than its tile, with its kernel
   launches per call (1 + log2(P*B / tile));
3. ``pipeline`` -- ``repro_torch.net.pipeline.run_pipeline`` on the card: first
   byte-identical to the same call on the CPU (plain versions) at small n,
   then once at the full size (default 100M keys, the paper's §6 trace size)
   with the ``end_to_end`` configuration of ``benchmarks/net_bench.py``
   (7-hop binary tree, 16 segments of length 64, 256-key packets, 8 flows,
   oracle ranges, 4 arena servers, a 2-column int64 payload).  The launch
   counters are zeroed just before that run and read just after it;
4. ``pipeline_device`` -- ``run_pipeline(engine="device")``: the whole
   epoch as one program, captured into a CUDA graph on the card.  At small
   n, on the single, leaf-spine and tree graphs, with and without a
   payload, byte-identical to ``engine="fused"`` on the card and to
   ``engine="device"`` on the CPU; then the ``end_to_end`` configuration at
   the full size: the first call (warm-up and capture included) and at
   least three replays timed apart, keys/s from the replays' median, the
   output equal to the ``pipeline`` phase's and to ``torch.sort``'s with
   the payload following, one device-to-host read and no host-to-device
   copy per epoch, and K1 counted as the kernel nodes of the captured
   graph (one per hop).  The program cache is emptied after it;
5. ``k3``, ``k4`` -- kernels K3 (key-value row sort, the MoE dispatch) and K4
   (row merge) against their plain versions, for exact equality (K3's
   values too, duplicate keys included): the MoE path's shapes, the
   reference tests' shapes, and rows wide enough for every kind of launch
   (K3 up to 2^20 pairs, with its launches per call at each width, counted
   as the kernel nodes of a CUDA graph of one call, held to
   ``row_sort_kv_plan``; K4 at 2^14 and 2^17 elements);
6. ``k5``, ``k6`` -- the attention kernels K5 (flash attention) and K6
   (decode attention) against their plain torch versions: head dims 32, 64,
   128, GQA groups 1, 3 and 4, causal or not, ragged T, S != T, strided
   q/k/v views, Mistral's 1963-token prefill, lengths 1..S (K6 also G 7
   and 12, and slots of length 0), float32 and bfloat16, on inputs whose
   softmax is peaked (limits: ``attn_limit``);
   the bf16 K5 wrapper must raise on rows that are not 16-byte aligned;
7. ``serve``, ``serve_moe`` -- for Mistral-Nemo-12B and for
   granite-moe-3b-a800m: first the smoke config(s) in float32 on the card
   against the same weights on the CPU (greedy tokens identical, logits
   within 1e-4; for the MoE path both MoE models' smoke configs), then the
   full model (every layer at full width, bf16, weights drawn on the card
   from ``--seed``) behind an ``Engine`` of 4 slots and ``max_len`` 4096: 8
   requests, prompt lengths from ``numpy.random.default_rng(seed)`` in
   512..2048, 32 greedy tokens each.  The engine replays its decode step as
   one CUDA graph (and the smoke configs' engines too: their tokens must
   equal an eager engine's on the card and the CPU's); the same requests
   then run on an eager engine, whose tokens must equal the graph's.  The
   launch counters are zeroed just before the graph run and read just after
   it; the decode step's launches are the captured graph's kernel nodes
   times its replays: K5 must launch once per layer per prefill, K6 once
   per layer per decode step, K3 once per MoE layer per prefill and per
   decode step, in the graph run and in the eager one.  Prefill and decode
   tokens/s and ms per decode step of both runs, peak device memory, the
   dropped assignments; the full model's
   logits on a short prompt through the kernels against the plain versions
   (Mistral: K5 and K6 plain, every argmax equal; granite: K3 plain, every
   dispatch and every logit identical).  After the MoE run,
   ``serve_moe_attention`` holds K5 and K6 to their plain versions at the
   shapes that run gave them (head_dim 64, 3 query heads per kv head);
8. ``kernels``  -- every ported kernel on fresh random inputs at the largest
   shape and dtype its main path gave it (K4, on no path, at the shape of
   one K2 round on the sort path's largest bucket): launches, agreement with
   the plain version, and kernel, plain and library (``torch.sort``, or
   ``scaled_dot_product_attention`` with ``enable_gqa``) times of one eager
   call (CUDA events, median of 10 after a warm-up) beside the bound; then
   the kernel's and the library call's device time per call of 24 calls
   replayed as one CUDA graph (``graph_ms``, ``library_graph_ms``), which
   leaves the host's cost of each call out.  K3's row adds the decode step's
   1 x 32 and its measured launches per call;
9. ``ptxas`` -- every kernel entry's registers, static shared memory and
   spills, as the compiler reported them when it built the kernels; a
   spill in any entry fails the run.

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
#: (NVIDIA's data sheet).  Attention flops: the dense bf16 tensor-core rate,
#: 989e12 flop/s (the same sheet), the peak for the main path's type.
#: Operations of the sort networks: a compare-exchange runs on the integer
#: ALUs, not on the float32 pipes: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
#: (the Hopper architecture whitepaper) is 16.7e12 32-bit integer operations
#: per second.  A compare-exchange costs 2 of them on int32 keys (min and
#: max) and 6 on int64 keys (a 64-bit compare is two 32-bit compares, and
#: min and max each select two 32-bit halves); K3's key-value one costs 2
#: more, the two selects of the int32 values.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COMPARE_EXCHANGE = {4: 2, 8: 6}
OPS_PER_KV_COMPARE_EXCHANGE = {4: 4, 8: 8}
OPS_PER_MERGE_STEP = {4: 2, 8: 4}

E2E = dict(
    topology="tree", branching=2, height=3, num_segments=16,
    segment_length=64, payload_size=256, num_flows=8, k=10,
    range_mode="oracle", num_servers=4, merge_backend="arena",
)
E2E_HOPS = 7

#: The serve runs: Mistral-Nemo-12B (dense) and granite-moe-3b-a800m (MoE,
#: 40 experts top-8) at full width, as their users serve them.
SERVE_ARCH = "mistral-nemo-12b"
MOE_ARCH = "granite-moe-3b-a800m"
SERVE = dict(slots=4, max_len=4096, requests=8, prompt_min=512, prompt_max=2048, new_tokens=32)

#: Inputs of the attention kernels' checks: q and k at 1.5 x a unit normal,
#: so the scores have a standard deviation of 2.25 at any head dim and the
#: softmax is peaked (about a dozen cache rows carry most of a 2000-row
#: row's weight); v a unit normal.  A cache block dropped from the merge or
#: a missing online-softmax rescale then moves the outputs by far more than
#: ``attn_limit``.
QK_SCALE = 1.5


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


def graph_ms(fn, calls: int = 24, reps: int = 10) -> float:
    """Median device milliseconds per call of ``fn()``: ``calls`` calls
    captured in one CUDA graph, replayed ``reps`` times after a warm-up,
    CUDA events around each replay.  The host's Python and launch calls are
    out of the window, the launches' gaps on the card are in it: the time
    of a function of a few microseconds, which ``cuda_ms`` cannot see under
    its host cost."""
    import torch

    from repro_torch.kernels import build

    graph, _ = build.capture(lambda: [fn() for _ in range(calls)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    times.sort()
    return times[len(times) // 2]


def timings(kern, plain, lib) -> dict:
    """A kernels-line row's times: one eager call of the kernel, its plain
    version and the library call, and the kernel's and the library call's
    time per call of a CUDA graph."""
    return {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(lib),
            "graph_ms": graph_ms(kern), "library_graph_ms": graph_ms(lib)}


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
    """(bytes, merge steps) of the tournament over a (p, b) matrix: the n
    keys read once and written once; log2(p) rounds of one comparison per
    output key, n log2(p) in all -- the least a merge of p sorted rows
    needs, whatever the kernel's design."""
    n = p * b
    return 2.0 * n * itemsize, float(n * log2(p))


def k3_work(rows: int, n: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of K3 over ``rows`` rows of ``n`` pairs:
    keys and int32 values read and written once; the full network."""
    s = log2(n)
    return 2.0 * rows * n * (itemsize + 4), rows * (n // 2) * s * (s + 1) / 2


def k4_work(rows: int, b: int, itemsize: int) -> tuple[float, float]:
    """(bytes, compare-exchanges) of K4 merging two (rows, b) halves: both
    read once, the (rows, 2b) output written once; log2(2b) stages of b
    pairs per row."""
    return 4.0 * rows * b * itemsize, float(rows * b * log2(2 * b))


def bound(bytes_: float, ce: float, itemsize: int, ops_per=OPS_PER_COMPARE_EXCHANGE) -> tuple[float, str]:
    """Least milliseconds on the card, and which of bytes and operations
    sets it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per[itemsize] * ce / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class StageClock:
    """Duck-typed null tracer that times the pipeline's top-level stages.

    It records nothing into the run (``enabled`` is False, as for the null
    tracer); spans of the ``pipeline``, ``hop`` and ``control`` categories
    synchronise the card on entry and exit so that their wall seconds are
    device time.  Two stages have no span of their own (the reference has
    none): ``pre_epoch``, from the start of the pipeline to its first epoch
    (flows, interleave, payload rows, the range table), and ``egress``, from
    the end of its last epoch to its end (the server pool).
    """

    enabled = False

    def __init__(self) -> None:
        import torch

        from repro_torch.obs.trace import NULL_TRACER

        self._null = NULL_TRACER
        self._torch = torch
        self.seconds: dict[str, float] = {}
        self._marks: dict[str, float] = {}

    def _now(self) -> float:
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        return time.perf_counter()

    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        if cat not in ("pipeline", "hop", "control"):
            return self._null.span(name, cat, tid, **args)
        clock = self

        class _Span:
            def __enter__(self):
                self.t0 = clock._now()
                if name == "pipeline":
                    clock._marks = {"start": self.t0}
                elif name.startswith("epoch:") and "pre_epoch" not in clock.seconds:
                    clock.seconds["pre_epoch"] = self.t0 - clock._marks.get("start", self.t0)
                return self

            def __exit__(self, *exc):
                t1 = clock._now()
                clock.seconds[name] = t1 - self.t0
                if name.startswith("epoch:"):
                    clock._marks["epoch_end"] = t1
                elif name == "pipeline":
                    clock.seconds["egress"] = t1 - clock._marks.get("epoch_end", t1)
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

    def __call__(self, x, *rest):
        if x.numel() > self.numel:
            self.shape, self.dtype, self.numel = tuple(x.shape), x.dtype, x.numel()
        return self.orig(x, *rest)

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
    tail padded with the dtype max, rows sorted for K2.  K1's network is
    data-oblivious; K2's merge moves the same bytes whatever the keys, and
    only its searches depend on them."""
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


def k1_rows(torch, gen, rows: int, b: int, dtype, kind: str):
    """A K1 input: ``ragged`` keys with many ties and a random tail of each
    row padded with the dtype max, ``all_equal`` rows, or ``extremes``
    (a quarter each of the dtype's min and max among the ties)."""
    info = torch.iinfo(dtype)
    if kind == "all_equal":
        return torch.full((rows, b), -7, dtype=dtype, device="cuda")
    x = torch.randint(-3, 4, (rows, b), dtype=dtype, device="cuda", generator=gen)
    if kind == "extremes":
        pick = torch.randint(0, 4, (rows, b), device="cuda", generator=gen)
        return torch.where(pick == 0, info.min, torch.where(pick == 1, info.max, x))
    cut = torch.randint(0, b + 1, (rows, 1), device="cuda", generator=gen)
    return torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, info.max)


def phase_k1(bt, torch, gen) -> None:
    """K1 at every width 2..4096, int32 and int64: row counts that leave a
    warp or a block part-filled (1, 3, 5, 1000, and one that ends inside the
    third block where a block holds more than a row), the three key kinds of
    ``k1_rows``, and a contiguous view one key past a 16-byte boundary (the
    kernel's key-by-key path); each against the plain network and
    ``torch.sort``."""
    checked = 0
    worst = 0
    for dtype in (torch.int32, torch.int64):
        for b in (1 << e for e in range(1, 13)):
            tile = bt.row_sort_items(b) * bt.ROW_SORT_THREADS
            cases = [(rows, kind, False) for rows in (1, 3, 5, 1000, (2 * tile + tile // 2) // b + 1)
                     for kind in ("ragged", "all_equal", "extremes")]
            for rows, kind, shifted in cases + [(37, "ragged", True)]:
                x = k1_rows(torch, gen, rows, b, dtype, kind).contiguous()
                if shifted:
                    x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, b)
                    if x.data_ptr() % 16 == 0 or not x.is_contiguous():
                        fail("K1's shifted view is 16-byte aligned")
                got = bt.sort_rows(x)
                want = bt.sort_rows_plain(x)
                worst = max(worst, exact(got, want))
                if not torch.equal(got, torch.sort(x, dim=1).values):
                    fail(f"K1 disagrees with torch.sort at {dtype} {rows}x{b} {kind} shifted={shifted}")
                checked += 1
    torch.cuda.synchronize()
    if worst:
        fail(f"K1 differs from sort_rows_plain by {worst}")
    emit({"phase": "k1", "cases": checked, "max_abs_err": worst})


def phase_k2(bt, torch, gen) -> None:
    """Random sorted rows with ragged pads (duplicate keys and pad runs in
    every row), all-pad rows and all-equal keys; one pair of 2^22-wide rows;
    rows at least a tile wide (the first round starts in device memory); the
    sort path's largest bucket.  Exact against ``tournament_plain`` and
    ``torch.sort``; each shape's kernel launches per call (1 + log2(P*B /
    tile) for B under the 16,384-key tile, log2(P) from it), the kernel's
    own count held to the Python plan."""
    from repro_torch.kernels import build

    checked = 0
    worst = 0
    plan = {}
    count_fn = build.function("tournament", "tournament_launches")
    cases = [(p, b, "random") for p, b in ((2, 2), (2, 4096), (1024, 64), (64, 1024), (4096, 2),
                                           (1 << 17, 64), (1 << 16, 128), (2, 1 << 22),
                                           (8, 1 << 15), (4, 1 << 16))]
    cases += [(64, 256, "all_pad"), (64, 256, "all_equal"), (1 << 15, 64, "all_equal"), (4, 1 << 16, "all_pad")]
    for dtype in (torch.int32, torch.int64):
        hi = torch.iinfo(dtype).max
        for p, b, kind in cases:
            if kind == "all_pad":
                x = torch.full((p, b), hi, dtype=dtype, device="cuda")
            elif kind == "all_equal":
                x = torch.full((p, b), 5, dtype=dtype, device="cuda")
            else:
                x = torch.randint(0, 1 << 30, (p, b), dtype=dtype, device="cuda", generator=gen)
                cut = torch.randint(1, b + 1, (p, 1), device="cuda", generator=gen)
                x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi)
                x = torch.sort(x, dim=1).values.contiguous()
            got = bt.merge_tournament(x)
            want = bt.tournament_plain(x)
            worst = max(worst, exact(got, want))
            if not torch.equal(got, torch.sort(x.reshape(-1)).values):
                fail(f"K2 disagrees with torch.sort at {dtype} {p}x{b} ({kind})")
            launches = count_fn(p, b)
            if launches != bt.tournament_launches(p, b):
                fail(f"K2 plans {launches} launches at {p}x{b}, the Python plan {bt.tournament_launches(p, b)}")
            plan[f"{p}x{b}"] = launches
            checked += 1
            del x, got, want
    torch.cuda.synchronize()
    if worst:
        fail(f"K2 differs from tournament_plain by {worst}")
    emit({"phase": "k2", "cases": checked, "max_abs_err": worst,
          "largest_keys": max(p * b for p, b, _ in cases), "tile": bt.TOURNAMENT_TILE,
          "launches_per_call": plan})


def dispatch_keys(torch, gen, rows: int, n: int, real: int, dtype, experts: int = 40):
    """K3's input as the MoE dispatch builds it: the composite keys
    ``expert * real + index`` of ``real`` assignments, padded to ``n`` with
    the dtype max; values ``arange(n)``."""
    eid = torch.randint(0, experts, (rows, real), device="cuda", generator=gen, dtype=dtype)
    keys = torch.full((rows, n), torch.iinfo(dtype).max, dtype=dtype, device="cuda")
    keys[:, :real] = eid * real + torch.arange(real, device="cuda", dtype=dtype)
    vals = torch.arange(n, dtype=torch.int32, device="cuda").repeat(rows, 1)
    return keys, vals.contiguous()


def check_k3(bt, torch, keys, vals) -> int:
    """K3 against its plain version, keys and values: exact, or fail."""
    gk, gv = bt.sort_rows_kv(keys, vals)
    wk, wv = bt.sort_rows_kv_plain(keys, vals)
    err = max(exact(gk, wk), exact(gv, wv))
    if err or not torch.equal(gk, torch.sort(keys, dim=1).values):
        fail(f"K3 differs from its plain version at {keys.dtype} {tuple(keys.shape)}")
    return err


def k3_launches(bt, keys, vals) -> int:
    """K3's kernel launches in one call on ``keys``/``vals``: the kernel nodes
    of a CUDA graph of that call; fails unless they are the Python plan's."""
    from repro_torch.kernels import build

    n = keys.shape[1]
    launches = build.graph_kernel_launches(lambda: bt.sort_rows_kv(keys, vals))
    if launches != len(bt.row_sort_kv_plan(n)):
        fail(f"K3 launched {launches} kernels at n={n}, the Python plan {len(bt.row_sort_kv_plan(n))}")
    return launches


def phase_k3(bt, torch, gen) -> None:
    """The MoE path's shapes (the 1,963-token prefill's 15,704 assignments
    padded to 16,384; the decode step's 32), the reference tests' shapes
    (unique keys; duplicate keys in four rows), int64 keys, and duplicate
    keys at every kind of launch: one chunk (64 .. 2,048 pairs), strided
    launches (4,096 .. 2^15), device-memory passes (2^16 .. 2^20).  Each
    width's launches per call, measured on its first case and held to
    ``row_sort_kv_plan``."""
    cases = []
    for dtype in (torch.int32, torch.int64):
        cases += [dispatch_keys(torch, gen, 1, 16_384, 15_704, dtype),
                  dispatch_keys(torch, gen, 1, 32, 32, dtype),
                  dispatch_keys(torch, gen, 2, 1 << 16, 60_000, dtype)]
        for n in (8, 128, 512):
            perm = torch.randperm(n, device="cuda", generator=gen).to(dtype)[None, :]
            cases.append((perm, (perm * 7 + 1).to(torch.int32)))
        for rows, n in ((4, 16), (4, 256), (4, 1 << 16), (3, 64), (2, 2048), (4, 4096), (1, 1 << 15),
                        (2, 1 << 17), (1, 1 << 20)):
            keys = torch.randint(0, 7 if n < 4096 else 1000, (rows, n), dtype=dtype, device="cuda",
                                 generator=gen)
            cases.append((keys, torch.arange(rows * n, dtype=torch.int32, device="cuda").reshape(rows, n)))
    worst = max(check_k3(bt, torch, k, v) for k, v in cases)
    torch.cuda.synchronize()
    by_width = {}
    for k, v in cases:
        by_width.setdefault(k.shape[1], (k, v))
    emit({"phase": "k3", "cases": len(cases), "max_abs_err": worst, "widest": max(by_width),
          "chunk": bt.ROW_SORT_KV_CHUNK,
          "launches_per_call": {str(n): k3_launches(bt, *by_width[n]) for n in sorted(by_width)}})


def sorted_halves(torch, gen, rows: int, b: int, dtype):
    """Two (rows, b) matrices of sorted rows: packed int64 records below 2^42
    (the K2 bucket's keys), int32 keys, or float32 normals."""
    def one():
        if dtype == torch.float32:
            x = torch.randn((rows, b), device="cuda", generator=gen)
        else:
            hi = (1 << 42) if dtype == torch.int64 else (1 << 30)
            x = torch.randint(0, hi, (rows, b), dtype=dtype, device="cuda", generator=gen)
        return torch.sort(x, dim=1).values.contiguous()
    return one(), one()


def check_k4(bt, torch, a, b) -> float:
    """K4 against its plain version: exact, or fail."""
    got = bt.merge_rows(a, b)
    want = bt.merge_rows_plain(a, b)
    err = 0 if torch.equal(got, want) else (got.double() - want.double()).abs().max().item()
    if err or not torch.equal(got, torch.sort(torch.cat([a, b], dim=1), dim=1).values):
        fail(f"K4 differs from its plain version at {a.dtype} {tuple(a.shape)}")
    return err


def phase_k4(bt, torch, gen) -> None:
    """The reference tests' (8, n) shapes, n in 8, 128, 1024; the timed shape
    (two 65,536 x 64 halves); rows of 2^14 and 2^17 elements, whose stages
    with j >= 4096 run in device memory."""
    cases = 0
    worst = 0
    for dtype in (torch.int32, torch.int64, torch.float32):
        for rows, b in ((8, 8), (8, 128), (8, 1024), (3, 16), (65_536, 64), (4, 1 << 13), (2, 1 << 16)):
            worst = max(worst, check_k4(bt, torch, *sorted_halves(torch, gen, rows, b, dtype)))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "k4", "cases": cases, "max_abs_err": worst})


def bitonic_rows(torch, bt, gen, k3_shape, k3_dtype, k3_real: int, launches) -> list[dict]:
    """The kernels-line rows of K3 (at the MoE path's largest row) and K4 (on
    no path: at the shape of one K2 round on the sort path's largest bucket,
    two 65,536 x 64 int64 halves)."""
    rows = []
    keys, vals = dispatch_keys(torch, gen, k3_shape[0], k3_shape[1], k3_real, k3_dtype)
    err = check_k3(bt, torch, keys, vals)
    b_bytes, ce = k3_work(keys.shape[0], keys.shape[1], keys.element_size())
    b_ms, b_by = bound(b_bytes, ce, keys.element_size(), OPS_PER_KV_COMPARE_EXCHANGE)
    # the decode step's row (1 x 32): 2,048 of the run's 2,304 launches
    dk, dv = dispatch_keys(torch, gen, 1, 32, 32, k3_dtype)
    err = max(err, check_k3(bt, torch, dk, dv))
    d_bytes, d_ce = k3_work(1, 32, dk.element_size())
    d_ms, d_by = bound(d_bytes, d_ce, dk.element_size(), OPS_PER_KV_COMPARE_EXCHANGE)
    def timed(k, v) -> dict:
        return timings(lambda: bt.sort_rows_kv(k, v), lambda: bt.sort_rows_kv_plain(k, v),
                       lambda: torch.sort(k, dim=1, stable=True))

    rows.append({
        "name": "row_sort_kv", "route": "cuda", "source": "src/repro_torch/kernels/csrc/row_sort_kv.cu",
        "replaces": "src/repro/kernels/bitonic.py:201", "launches": launches["row_sort_kv"],
        "max_abs_err": err, "shape": list(keys.shape), "dtype": str(keys.dtype).replace("torch.", ""),
        "launches_per_call": k3_launches(bt, keys, vals),
        **timed(keys, vals), "bound_ms": b_ms, "bound_by": b_by,
        "decode": {"shape": list(dk.shape), "launches_per_call": k3_launches(bt, dk, dv),
                   **timed(dk, dv), "bound_ms": d_ms, "bound_by": d_by},
    })
    a, b = sorted_halves(torch, gen, 65_536, 64, torch.int64)
    err = check_k4(bt, torch, a, b)
    b_bytes, ce = k4_work(a.shape[0], a.shape[1], a.element_size())
    b_ms, b_by = bound(b_bytes, ce, a.element_size())
    rows.append({
        "name": "merge_rows", "route": "cuda", "source": "src/repro_torch/kernels/csrc/merge_rows.cu",
        "replaces": "src/repro/kernels/bitonic.py:230", "launches": launches["merge_rows"],
        "max_abs_err": err, "shape": [list(a.shape), list(b.shape)], "dtype": "int64",
        **timings(lambda: bt.merge_rows(a, b), lambda: bt.merge_rows_plain(a, b),
                  lambda: torch.sort(torch.cat([a, b], dim=-1), dim=-1)),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    del keys, vals, dk, dv, a, b
    torch.cuda.empty_cache()
    return rows


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


GRAPHS = {"single": {}, "leaf_spine": {"num_leaves": 4}, "tree": {"branching": 2, "height": 3}}


def same_run(np, a: dict, b: dict) -> str | None:
    """The first field in which two ``PipelineResult.to_numpy()`` differ:
    output, passes, payload, the delivered wire and every hop stat's
    scalars and segment loads (the device engine, like the reference's,
    leaves the per-run arrays of ``HopStats`` out)."""
    for key in ("output", "payload_row_order", "sorted_payload"):
        if (a[key] is None) != (b[key] is None) or (a[key] is not None and not np.array_equal(a[key], b[key])):
            return key
    if a["passes"] != b["passes"] or a["server_keys"] != b["server_keys"]:
        return "passes"
    for c in ("values", "flow_id", "seq", "segment_id", "row_index"):
        x, y = a["delivered"][c], b["delivered"][c]
        if (x is None) != (y is None) or (x is not None and not np.array_equal(x, y)):
            return f"delivered {c}"
    if len(a["hop_stats"]) != len(b["hop_stats"]):
        return "hop count"
    for sa, sb in zip(a["hop_stats"], b["hop_stats"]):
        for f in ("name", "arrivals", "load_imbalance", "emitted_runs", "mean_run_len", "recirculations"):
            if sa[f] != sb[f]:
                return f"hop stat {f}"
        if not np.array_equal(sa["segment_loads"], sb["segment_loads"]):
            return "hop stat segment_loads"
    return None


def parity_device_small(torch, np, run_pipeline, random_trace) -> list[dict]:
    """``engine="device"`` on the card against ``engine="fused"`` on the card
    and ``engine="device"`` on the CPU, on every graph kind, with and
    without a payload."""
    n = 20_000
    vals = random_trace(n, seed=2)
    payload = np.stack([vals * 7 + 3, np.arange(n)], axis=1).astype(np.int64)
    cells = []
    for graph, kw in GRAPHS.items():
        for with_payload in (False, True):
            cfg = dict(E2E, topology=graph, **kw)
            if graph != "tree":
                cfg.pop("branching"), cfg.pop("height")
            runs = {}
            for engine, dev in (("device", "cuda"), ("fused", "cuda"), ("device", "cpu")):
                r = run_pipeline(vals, payload=payload if with_payload else None, seed=2,
                                 engine=engine, device=dev, **cfg)
                runs[(engine, dev)] = r.to_numpy()
            card = runs[("device", "cuda")]
            for other in (("fused", "cuda"), ("device", "cpu")):
                diff = same_run(np, card, runs[other])
                if diff:
                    fail(f"device engine on the card and {other} disagree on {diff} ({graph}, payload {with_payload})")
            if not np.array_equal(card["output"], np.sort(vals)):
                fail(f"device engine output is not the sorted input ({graph})")
            cells.append({"graph": graph, "payload": with_payload, "n": n, "hops": len(card["hop_stats"])})
    return cells


def phase_pipeline_device(torch, np, args, run_pipeline, random_trace, values_d, payload_d,
                          fused_out, fused_payload) -> dict:
    """The device epoch at the full size: first call, then replays."""
    from repro_torch.data.traces import trace_max_value
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import build
    from repro_torch.net import device_epoch as de

    parity = parity_device_small(torch, np, run_pipeline, random_trace)
    de.clear_program_cache()
    torch.cuda.empty_cache()
    n = int(values_d.numel())
    want = torch.sort(values_d, stable=True)

    def run():
        clock = StageClock()
        de.reset_transfer_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_pipeline(values_d, payload=payload_d, max_value=trace_max_value("random"),
                           seed=args.seed, tracer=clock, engine="device", device="cuda", **E2E)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not torch.equal(res.output, want.values) or not torch.equal(res.output, fused_out):
            fail("device engine output differs from torch.sort / the fused run")
        if not torch.equal(res.payload_row_order, want.indices) or not torch.equal(res.sorted_payload, fused_payload):
            fail("device engine payload does not follow its keys")
        transfers = dict(de.TRANSFER_COUNTS)
        if transfers != {"to_device": 0, "to_host": 1}:
            fail(f"device epoch transfers {transfers}, want no copy in and one read back")
        stages = dict(clock.seconds, server_makespan=res.server_seconds, per_server=res.per_server_seconds,
                      pool_merge=res.pool_merge_seconds)
        return sec, stages, res

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    with LargestShape(bt, "sort_rows") as k1_in:
        first_s, first_stages, res = run()
    first_launches = dict(build.LAUNCHES)
    reserved = torch.cuda.memory_reserved()
    peak_first = torch.cuda.max_memory_allocated()
    passes = res.passes
    del res
    (prog,) = de._PROGRAM_CACHE.values()
    nodes = build.graph_kernel_nodes(prog.graph, ["row_sort_kernel", "tile_merge", "merge_round"])
    if nodes["row_sort_kernel"] != E2E_HOPS:
        fail(f"the captured epoch holds {nodes['row_sort_kernel']} K1 nodes, want one per hop ({E2E_HOPS})")
    if nodes["tile_merge"] or nodes["merge_round"]:
        fail("the captured epoch holds K2 nodes")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    replays = []
    for _ in range(3):
        sec, stages, res = run()
        replays.append({"s": sec, "stages": stages})
        del res
    replay_launches = dict(build.LAUNCHES)
    if replay_launches["row_sort"]:
        fail("a replay launched K1 outside the graph")
    if replay_launches["tournament"] < 1:
        fail("K2 never launched at the device run's egress")
    peak = torch.cuda.max_memory_allocated()
    med = sorted(r["s"] for r in replays)[len(replays) // 2]
    if args.profile:
        emit({"phase": "pipeline_device_profile", **profiled(torch, lambda: run()[2])[0]})
    emit({"phase": "pipeline_device", "n": n, "config": E2E, "parity_small": parity,
          "first_call_s": first_s, "first_call_stage_s": first_stages,
          "replay_s": [r["s"] for r in replays], "replay_stage_s": [r["stages"] for r in replays],
          "keys_per_s": n / med, "passes": passes,
          "peak_device_bytes_first_call": peak_first, "peak_device_bytes_replays": peak,
          "memory_reserved_after_capture": reserved,
          "transfers_per_epoch": {"to_device": 0, "to_host": 1},
          "k1_graph_nodes_per_epoch": nodes["row_sort_kernel"], "graph_kernel_nodes": nodes["all"],
          "k1_input": {"shape": list(k1_in.shape), "dtype": str(k1_in.dtype).replace("torch.", "")},
          "launches_first_call": {k: first_launches[k] for k in ("row_sort", "tournament")},
          "launches_replays": {k: replay_launches[k] for k in ("row_sort", "tournament")},
          "epochs_replayed": len(replays)})
    del want, prog
    de.clear_program_cache()
    torch.cuda.empty_cache()
    return {"k1_shape": k1_in.shape, "k1_dtype": k1_in.dtype, "k1_nodes": nodes["row_sort_kernel"],
            "epochs": 1 + len(replays)}


#: The reference's ``--scenarios`` rows (``net_bench.py`` ``BENCH_SCENARIOS``)
#: on the ``E2E`` fabric with sampled ranges, as ``(scenario, keys, flows)``:
#: ``drifting`` at the paper's trace size, ``adversarial_skew`` at the
#: reference's end-to-end size (a cut for the control plane's per-packet
#: host loop).  Eight flows are eight contiguous shards of the trace, so the
#: wire carries every drift phase at once; one more row feeds ``drifting``
#: through a single flow, whose wire does drift, at the end-to-end size.
#: Then ``drifting`` on the device engine at that size, whose sampled epochs
#: each build and capture a program of their own.
SCENARIO_ROWS = (("drifting", 100_000_000, 8), ("adversarial_skew", 10_000_000, 8),
                 ("drifting", 10_000_000, 1))
SCENARIO_DEVICE_N = 10_000_000

#: The reference's network sweep (``net_bench.py`` ``NETWORK_BENCH``,
#: ``NETWORK_RATES`` x ``NETWORK_BUFFERS``): one switch, 16 x 64, 256-key
#: packets, 8 flows, oracle ranges, 2% wire loss under the drop policy, at
#: its ``--network-n`` default of 1M keys (a cut: the timing model is a
#: per-packet host event loop).  Rate (0, 1) is unthrottled, buffer 0
#: unbounded.  One more cell runs the backpressure policy on a lossless,
#: slow, one-slot link.
NETWORK_N = 1_000_000
NETWORK = dict(topology="single", num_segments=16, segment_length=64, payload_size=256,
               num_flows=8, k=10, range_mode="oracle")
NETWORK_RATES = ((0, 1), (8, 1), (2, 1), (1, 1), (1, 4), (1, 16), (1, 64))
NETWORK_BUFFERS = (0, 4, 1)
NETWORK_LOSS = 0.02


def _sync(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _reset_peak(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def _peak(torch):
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None


def _reserved(torch):
    return torch.cuda.memory_reserved() if torch.cuda.is_available() else None


def timed_run(torch, run_pipeline, values, **kw):
    """One ``run_pipeline`` call between two synchronisations: the result
    and its wall seconds."""
    _sync(torch)
    t0 = time.perf_counter()
    res = run_pipeline(values, **kw)
    _sync(torch)
    return res, time.perf_counter() - t0


def phase_pipeline_sampled(torch, np, run_pipeline, dev: str, rows_in, device_n: int,
                           seed: int) -> None:
    """The adaptive control plane on the card: each scenario row with
    sampled, static and oracle ranges on the same keys (fused engine), then
    ``drifting`` with sampled ranges on the device engine against the fused
    run at that size."""
    from repro_torch.data.scenarios import SCENARIOS, scenario_max_value
    from repro_torch.kernels import build
    from repro_torch.net import device_epoch as de

    cfg = {k: v for k, v in E2E.items() if k != "range_mode"}
    rows = []
    for name, n, flows in rows_in:
        values = torch.from_numpy(SCENARIOS[name](n, seed=seed)).to(dev)
        maxv = scenario_max_value(name)
        want = torch.sort(values).values
        row = {"scenario": name, "n": n, "num_flows": flows}
        for mode in ("sampled", "static", "oracle"):
            clock = StageClock()
            build.reset_launches()
            _reset_peak(torch)
            res, sec = timed_run(torch, run_pipeline, values, max_value=maxv, seed=seed,
                                 tracer=clock, range_mode=mode, device=dev,
                                 **dict(cfg, num_flows=flows))
            launches = dict(build.LAUNCHES)
            if not torch.equal(res.output, want):
                fail(f"{name} with {mode} ranges: output differs from torch.sort")
            # K1 once per hop of every epoch that received keys (through one
            # flow, the leaves of the other three ingress groups get none).
            fed = sum(1 for st in res.hop_stats if st.arrivals)
            if dev == "cuda" and (launches["row_sort"] != fed or launches["tournament"] < 1):
                fail(f"{name} with {mode} ranges: launches {launches}, want K1 once per "
                     f"hop with keys ({fed} over {res.num_epochs} epochs) and K2 at least once")
            entry = {"run_pipeline_s": sec, "keys_per_s": n / sec, "num_epochs": res.num_epochs,
                     "peak_device_bytes": _peak(torch), "server_imbalance": res.server_imbalance,
                     "server_keys": res.server_keys, "server_makespan_s": res.server_seconds,
                     "passes_total": sum(res.passes), "stage_s": dict(clock.seconds),
                     "hops_with_keys": fed,
                     "launches": {k: launches[k] for k in ("row_sort", "tournament")}}
            if mode == "sampled":
                entry["split_epochs_s"] = clock.seconds["control:split_epochs"]
                entry["ranges_history"] = [r.cpu().tolist() for r in res.ranges_history]
                if name == "drifting" and res.num_epochs < (2 if flows > 1 else 3):
                    fail(f"drifting keys through {flows} flow(s) gave {res.num_epochs} epochs")
            row[mode] = entry
            del res
        rows.append(row)
        del values, want

    # drifting on the device engine, through 8 flows and through one: each
    # epoch's range table is a new program key, so each epoch warms up and
    # captures a program of its own.
    values = torch.from_numpy(SCENARIOS["drifting"](device_n, seed=seed)).to(dev)
    maxv = scenario_max_value("drifting")
    device_rows = []
    for flows in (8, 1):
        kw = dict(cfg, num_flows=flows, range_mode="sampled", max_value=maxv, seed=seed, device=dev)
        fused, fused_s = timed_run(torch, run_pipeline, values, engine="fused", **kw)
        fused_np = fused.to_numpy()
        del fused
        de.clear_program_cache()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        reserved = []
        orig = de.run_graph_device

        def per_epoch(*a, **k):
            out = orig(*a, **k)
            reserved.append(_reserved(torch))
            return out

        de.run_graph_device = per_epoch
        try:
            first, first_s = timed_run(torch, run_pipeline, values, engine="device", **kw)
            first_np = first.to_numpy()
            del first
            again, again_s = timed_run(torch, run_pipeline, values, engine="device", **kw)
            again_np = again.to_numpy()
            del again
        finally:
            de.run_graph_device = orig
        programs = len(de._PROGRAM_CACHE)
        for what, got in (("first call", first_np), ("replay", again_np)):
            diff = same_run(np, got, fused_np)
            if diff:
                fail(f"sampled device engine ({what}, {flows} flows) and fused engine disagree on {diff}")
            if got["num_epochs"] != fused_np["num_epochs"] or any(
                    not np.array_equal(a, b) for a, b in zip(got["ranges_history"], fused_np["ranges_history"])):
                fail(f"sampled device engine ({what}, {flows} flows) epochs differ from the fused run's")
        epochs = first_np["num_epochs"]
        device_rows.append({"scenario": "drifting", "n": device_n, "num_flows": flows,
                            "num_epochs": epochs, "epoch_keys": [int(c) for c in np.bincount(
                                first_np["delivered"]["segment_id"] // cfg["num_segments"])],
                            "programs_cached": programs, "fused_s": fused_s,
                            "first_call_s": first_s, "replay_s": again_s,
                            "memory_reserved_after_each_epoch": reserved[:epochs],
                            "memory_reserved_after_replays": reserved[epochs:]})
        del first_np, again_np, fused_np
        de.clear_program_cache()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    del values
    emit({"phase": "pipeline_sampled", "config": cfg, "scenarios": rows, "device_engine": device_rows})


def phase_pipeline_observed(torch, np, run_pipeline, dev: str, values_d, payload_d, fused_out,
                            fused_payload, seed: int, rounds: int = 2) -> None:
    """The reference's telemetry modes (off, a recording Tracer with a
    MetricsRegistry, and INT stamps on top) on the E2E cell, interleaved:
    every mode's output, passes, hop stat scalars and delivered wire must
    equal the unobserved run's.  Then the device engine traced."""
    import os
    import tempfile

    from repro_torch.data.traces import trace_max_value
    from repro_torch.kernels import build
    from repro_torch.net import device_epoch as de
    from repro_torch.obs import MetricsRegistry, Tracer

    n = int(values_d.numel())
    kw = dict(payload=payload_d, max_value=trace_max_value("random"), seed=seed, device=dev, **E2E)
    cols = ("values", "flow_id", "seq", "segment_id", "row_index")
    base = None
    times: dict[str, list[float]] = {"off": [], "traced": [], "int": []}
    info: dict[str, dict] = {}
    for _ in range(rounds):
        for mode in times:
            tracer = None if mode == "off" else Tracer()
            metrics = None if mode == "off" else MetricsRegistry()
            build.reset_launches()
            _reset_peak(torch)
            res, sec = timed_run(torch, run_pipeline, values_d, tracer=tracer, metrics=metrics,
                                 int_telemetry=mode == "int", **kw)
            launches = dict(build.LAUNCHES)
            times[mode].append(sec)
            if dev == "cuda" and (launches["row_sort"] != E2E_HOPS or launches["tournament"] < 1):
                fail(f"observed mode {mode}: launches {launches}")
            if not torch.equal(res.output, fused_out) or not torch.equal(res.sorted_payload, fused_payload):
                fail(f"observed mode {mode}: output differs from the pipeline phase's")
            stats = [(st.name, st.arrivals, st.load_imbalance, st.emitted_runs, st.mean_run_len,
                      st.recirculations) for st in res.hop_stats]
            if base is None:
                base = {"passes": res.passes, "stats": stats,
                        "delivered": {c: getattr(res.delivered, c) for c in cols}}
            else:
                if res.passes != base["passes"] or stats != base["stats"]:
                    fail(f"observed mode {mode}: passes or hop stats differ from the unobserved run")
                for c in cols:
                    if not torch.equal(getattr(res.delivered, c), base["delivered"][c]):
                        fail(f"observed mode {mode}: delivered {c} differs from the unobserved run")
            if mode != "off" and mode not in info:
                with tempfile.TemporaryDirectory() as tmp:
                    path = os.path.join(tmp, "trace.json")
                    t0 = time.perf_counter()
                    tracer.dump(path)
                    dump_s = time.perf_counter() - t0
                    size = os.path.getsize(path)
                entry = {"spans": len(tracer.spans), "instants": len(tracer.instants),
                         "chrome_trace_bytes": size, "chrome_trace_dump_s": dump_s,
                         "metrics": sum(len(v) for kind in res.telemetry.values()
                                        if isinstance(kind, dict) for v in kind.values())}
                if mode == "int":
                    meta = res.delivered.int_meta
                    if meta is None or meta.depth != 3:
                        fail("INT run: the delivered wire lacks its 3-deep INT stack")
                    entry["int_depth"] = meta.depth
                    entry["int_summary_rows"] = len(res.telemetry["int"])
                    entry["peak_device_bytes"] = _peak(torch)
                    entry["int_stack_bytes"] = 3 * n * meta.depth * 8
                info[mode] = entry
            del res, tracer, metrics
    del base
    best = {m: min(v) for m, v in times.items()}

    # The device engine, traced: the program with taps (its own key).
    de.clear_program_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    tracer = Tracer()
    de.reset_transfer_counts()
    _reset_peak(torch)
    res, dev_s = timed_run(torch, run_pipeline, values_d, tracer=tracer, engine="device", **kw)
    transfers = dict(de.TRANSFER_COUNTS)
    if not torch.equal(res.output, fused_out) or not torch.equal(res.sorted_payload, fused_payload):
        fail("traced device engine: output differs from the unobserved runs")
    if len(tracer.find(cat="hop")) != E2E_HOPS or any(st.ship_emission is None for st in res.hop_stats):
        fail("traced device engine: the taps did not replay every hop")
    device = {"s": dev_s, "transfers": transfers, "spans": len(tracer.spans),
              "peak_device_bytes": _peak(torch), "memory_reserved": _reserved(torch),
              "metrics": sum(len(v) for kind in res.telemetry.values() for v in kind.values())}
    del res, tracer
    de.clear_program_cache()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    emit({"phase": "pipeline_observed", "n": n, "config": E2E, "payload_cols": 2, "rounds": rounds,
          "seconds": times, "best_s": best,
          "traced_over_off": best["traced"] / best["off"], "int_over_off": best["int"] / best["off"],
          "traced": info["traced"], "int": info["int"], "device_traced": device})


def phase_pipeline_network(torch, np, run_pipeline, dev: str, n: int, seed: int) -> None:
    """The reference's network sweep: every (rate, buffer) cell under 2%
    wire loss (drop policy) and one backpressure cell, each byte-identical
    to the timeless lossless run; the timing model's host seconds beside
    the pipeline's."""
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.net import timing
    from repro_torch.net.timing import LinkSpec, NetworkConfig

    values = torch.from_numpy(random_trace(n, seed=seed)).to(dev)
    kw = dict(NETWORK, max_value=trace_max_value("random"), seed=seed, device=dev)
    ref, ref_s = timed_run(torch, run_pipeline, values, **kw)
    if not torch.equal(ref.output, torch.sort(values).values):
        fail("network phase: the timeless run is not sorted")
    model_s = [0.0]
    orig = timing.simulate_link

    def clocked(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        model_s[0] += time.perf_counter() - t0
        return out

    cells = [(numer, denom, buf, "drop", NETWORK_LOSS) for numer, denom in NETWORK_RATES
             for buf in NETWORK_BUFFERS] + [(1, 4, 1, "backpressure", 0.0)]
    rows = []
    timing.simulate_link = clocked
    try:
        for numer, denom, buf, policy, loss in cells:
            net = NetworkConfig(
                link=LinkSpec(latency=2, rate_numer=numer or None, rate_denom=denom,
                              buffer_packets=buf or None, policy=policy, loss_rate=loss),
                switch_latency=1, seed=seed)
            model_s[0] = 0.0
            res, sec = timed_run(torch, run_pipeline, values, network=net, **kw)
            rep = res.network
            if not torch.equal(res.output, ref.output) or res.passes != ref.passes:
                fail(f"network cell rate {numer}/{denom} buffer {buf} {policy}: output differs "
                     "from the lossless run")
            if policy == "drop" and rep.drops != rep.retransmits:
                fail(f"network cell rate {numer}/{denom} buffer {buf}: drops {rep.drops} != "
                     f"retransmits {rep.retransmits}")
            if policy == "backpressure" and (rep.drops or not rep.stall_ticks):
                fail(f"backpressure cell: {rep.drops} drops, {rep.stall_ticks} stall ticks")
            rows.append({
                "rate_numer": numer, "rate_denom": denom, "buffer_packets": buf, "policy": policy,
                "loss_rate": loss, "makespan_ticks": rep.makespan_ticks,
                "network_seconds": rep.seconds, "server_seconds": res.server_seconds,
                "bottleneck": "network" if rep.seconds >= res.server_seconds else "compute",
                "drops": rep.drops, "retransmits": rep.retransmits, "duplicates": rep.duplicates,
                "stall_ticks": rep.stall_ticks,
                "coalesced": sum(s.coalesced for s in rep.links),
                "forced": sum(s.forced for s in rep.links),
                "buffer_high_water": max(s.buffer_high_water for s in rep.links),
                "server_dup_packets": res.dup_packets_dropped, "spilled_packets": res.spilled_packets,
                "spilled_keys": res.spilled_keys, "pipeline_s": sec, "timing_model_s": model_s[0],
                "lossless_identical": True})
            del res
    finally:
        timing.simulate_link = orig
    emit({"phase": "pipeline_network", "n": n, "config": dict(NETWORK, loss_rate=NETWORK_LOSS),
          "timeless_s": ref_s, "cells": rows, "all_lossless_identical": True})


class CallClock:
    """Times every call of ``module.attr`` during a run: the wall
    milliseconds between a synchronisation before the call and one after it
    (``sync``), or the device milliseconds between CUDA events recorded
    around it (read by :meth:`ms` after the run)."""

    def __init__(self, torch, module, attr: str, sync: bool) -> None:
        self.torch, self.module, self.attr, self.sync = torch, module, attr, sync
        self.orig = getattr(module, attr)
        self.wall_ms = 0.0
        self.events = []

    def __call__(self, *args, **kwargs):
        cuda = self.torch.cuda
        if self.sync:
            cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            cuda.synchronize()
            self.wall_ms += (time.perf_counter() - t0) * 1e3
            return out
        a, b = cuda.Event(enable_timing=True), cuda.Event(enable_timing=True)
        a.record()
        out = self.orig(*args, **kwargs)
        b.record()
        self.events.append((a, b))
        return out

    def ms(self) -> float:
        return self.wall_ms if self.sync else sum(a.elapsed_time(b) for a, b in self.events)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False


def profiled(torch, fn) -> tuple[dict, dict]:
    """One call of ``fn`` under ``torch.profiler``: the wall time, the device
    busy share (kernel and copy time over wall time) and the top 15 kernels
    by device time, as line fields; and the device time and calls by
    kernel name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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
    return ({"wall_s": wall, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / wall,
             "top_device_ms": [{"name": k[:90], "ms": v[0], "calls": v[1]} for k, v in top]}, by_name)


def phase_profile(torch, run_pipeline, values_d, payload_d, seed: int) -> None:
    """Two more main-path runs.  The first times the hop's row sort:
    ``row_sort_device`` between two synchronisations, and inside it K1's
    call between CUDA events; the difference is the glue around K1 (the two
    host reads of the key range, the mask, narrowing, widening).  The
    second runs under ``torch.profiler``: device busy share (kernel and copy
    time over wall time), the device time by kernel, and K1's."""
    from repro_torch.data.traces import trace_max_value
    from repro_torch.kernels import ops
    from repro_torch.net import engine

    with CallClock(torch, engine, "row_sort_device", sync=True) as hop_sort, \
            CallClock(torch, ops, "sort_rows_padded", sync=False) as k1:
        run_pipeline(values_d, payload=payload_d, max_value=trace_max_value("random"),
                     seed=seed, device="cuda", **E2E)
        torch.cuda.synchronize()
    row_sort = {"calls": len(k1.events), "row_sort_device_ms": hop_sort.ms(), "k1_ms": k1.ms(),
                "glue_ms": hop_sort.ms() - k1.ms()}
    fields, by_name = profiled(torch, lambda: run_pipeline(
        values_d, payload=payload_d, max_value=trace_max_value("random"), seed=seed, device="cuda", **E2E))
    k1_prof = [v for k, v in by_name.items() if "row_sort_kernel" in k]
    emit({"phase": "profile", **fields, "k1_device_ms": sum(v[0] for v in k1_prof),
          "k1_launches": sum(v[1] for v in k1_prof), "row_sort": row_sort})


def attn_bound(flops: float, bytes_: float) -> tuple[float, str]:
    """Least milliseconds of an attention call: its flops at the bf16
    tensor-core peak or its bytes at the HBM rate, whichever is larger."""
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_work(b: int, t: int, h: int, kv: int, d: int, itemsize: int, causal: bool) -> tuple[float, float]:
    """(flops, bytes) of one K5 call: 2 flops per multiply-add of q.k and
    of p.v over the visible (row, col) pairs; q, k, v read once, o written."""
    pairs = t * (t + 1) / 2 if causal else t * t
    return 4.0 * b * h * d * pairs, (2.0 * b * t * h * d + 2.0 * b * t * kv * d) * itemsize


def k6_work(lengths: list[int], h: int, kv: int, d: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) of one K6 call: the visible cache rows of k and v read
    once, q read, the output written, the lengths read."""
    vis = float(sum(lengths))
    return 4.0 * h * d * vis, (2.0 * vis * kv * d + 2.0 * len(lengths) * h * d) * itemsize + 4 * len(lengths)


def attn_limit(want):
    """Elementwise limit on |kernel - plain| for an attention output.

    Both sides sum in float32, in other orders, and round the output once.
    float32: 2e-5 + 1e-3 |want|.  bfloat16: the two may round one value to
    neighbouring bf16 numbers, one ulp apart, at most 2^-7 of it: 1e-2
    |want|, plus 4e-3 of the largest |want| (half to one ulp at the top of
    the output's range) for the values near zero.
    """
    import torch

    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return 4e-3 * w.max() + 1e-2 * w
    return 2e-5 + 1e-3 * w


def allclose_err(got, want, what: str) -> float:
    """Max absolute difference; fails beyond ``attn_limit(want)``."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype mismatch {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: an output is not finite")
    diff = (g - w).abs()
    if (diff > attn_limit(want)).any():
        fail(f"{what} differs from its plain version by {diff.max().item()} "
             f"({want.dtype}, shape {tuple(want.shape)}, largest output {w.abs().max().item()})")
    return diff.max().item()


def randn(torch, gen, shape, dt, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)


def check_k5(fa, torch, gen, q_shape, kv_shape, dt, causal: bool):
    """K5 against its plain version on fresh inputs: (max error, (q, k, v))."""
    q = randn(torch, gen, q_shape, dt, QK_SCALE)
    k = randn(torch, gen, kv_shape, dt, QK_SCALE)
    v = randn(torch, gen, kv_shape, dt)
    err = allclose_err(fa.flash_attention(q, k, v, causal=causal),
                       fa.flash_attention_plain(q, k, v, causal=causal), "K5")
    return err, (q, k, v)


def check_k6(da, torch, gen, q_shape, cache_shape, dt, lengths, layers: int = 2):
    """K6 against its plain version on fresh inputs, reading the last layer's
    slice of stacked ``(layers, *cache_shape)`` caches in place, as the model
    does: (max error, (q, kc, vc))."""
    q = randn(torch, gen, q_shape, dt, QK_SCALE)
    kc = randn(torch, gen, (layers, *cache_shape), dt, QK_SCALE)
    vc = randn(torch, gen, (layers, *cache_shape), dt)
    err = allclose_err(da.decode_attention(q, kc[-1], vc[-1], lengths),
                       da.decode_attention_plain(q, kc[-1], vc[-1], lengths), "K6")
    return err, (q, kc, vc)


def phase_k5(fa, torch, gen) -> None:
    """Head dims 32, 64, 128 x G 1, 3, 4 x T 1, 7, 64, 130, 1000, causal or
    not; then Mistral-Nemo-12B's largest prefill (q 1 x 1963 x 32 x 128),
    S != T non-causal, q/k/v as strided views of one fused projection, and
    the bf16 wrapper raising on a row stride its 16-byte copies cannot
    take.  float32 and bfloat16, limits ``attn_limit``."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for name in worst:
        dt = getattr(torch, name)
        for d in (32, 64, 128):
            for g in (1, 3, 4):
                for t in (1, 7, 64, 130, 1000):
                    for causal in (True, False):
                        kv = 2
                        err, _ = check_k5(fa, torch, gen, (2, t, kv * g, d), (2, t, kv, d), dt, causal)
                        worst[name] = max(worst[name], err)
                        cases += 1
        for b, t, s, h, kv, d, causal in ((1, 1963, 1963, 32, 8, 128, True), (1, 1, 300, 4, 1, 32, False),
                                          (2, 7, 130, 6, 2, 64, False), (1, 130, 1000, 8, 2, 128, False),
                                          (1, 130, 7, 8, 2, 32, False), (3, 23, 23, 12, 4, 64, True)):
            err, _ = check_k5(fa, torch, gen, (b, t, h, d), (b, s, kv, d), dt, causal)
            worst[name] = max(worst[name], err)
            cases += 1
        for d in (32, 64, 128):
            qkv = randn(torch, gen, (2, 150, 12, d), dt, QK_SCALE)  # 8 q heads, 2 + 2 kv heads
            q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
            for causal in (True, False):
                worst[name] = max(worst[name], allclose_err(
                    fa.flash_attention(q, k, v, causal=causal),
                    fa.flash_attention_plain(q, k, v, causal=causal), "K5 on strided views"))
                cases += 1
    bad = randn(torch, gen, (1, 64, 4, 33), torch.bfloat16)[..., :32]
    try:
        fa.flash_attention(bad, bad, bad)
        fail("K5 (bfloat16) took rows that are not 16-byte aligned")
    except ValueError:
        pass
    torch.cuda.synchronize()
    emit({"phase": "k5", "cases": cases, "max_abs_err": worst, "misaligned_bf16_raises": True})


def phase_k6(da, torch, gen) -> None:
    """Head dims 32, 64, 128 x G 1, 3, 4, 7, 12 x caches of 1, 300 and 4096
    positions: lengths 1, S and random between; then slots of length 0
    (every position masked: the mean of v over the cache) beside a length
    past S.  float32 and bfloat16, limits ``attn_limit``; the last layer's
    slice of stacked caches, read in place."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for name in worst:
        dt = getattr(torch, name)
        for d in (32, 64, 128):
            for g in (1, 3, 4, 7, 12):
                for b, s in ((1, 1), (3, 300), (4, 4096)):
                    kv = 8 if s == 4096 else 2
                    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda", dtype=torch.int32)
                    lengths[0] = 1
                    lengths[-1] = s
                    err, _ = check_k6(da, torch, gen, (b, kv * g, d), (b, s, kv, d), dt, lengths)
                    worst[name] = max(worst[name], err)
                    cases += 1
                lengths = torch.tensor([0, 7, 1000, 0], dtype=torch.int32, device="cuda")
                err, _ = check_k6(da, torch, gen, (4, 2 * g, d), (4, 777, 2, d), dt, lengths)
                worst[name] = max(worst[name], err)
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": "k6", "cases": cases, "max_abs_err": worst, "block_s": da.BLOCK_S,
          "length_zero_slots": True})


class AttnRecorder:
    """Pass-through for an attention wrapper as the model calls it: keeps the
    largest q shape (K5), or the lengths tensor of the latest call (K6: the
    model makes a fresh one per call and never writes it again), and copies
    no data: no device work and no host sync inside the timed run."""

    def __init__(self, module, attr: str) -> None:
        self.module, self.attr = module, attr
        self.orig = getattr(module, attr)
        self.q_shape: tuple[int, ...] = ()
        self.kv_shape: tuple[int, ...] = ()
        self.dtype = None
        self.causal = True
        self.lengths = None
        self.numel = -1

    def __call__(self, q, k, v, *args, **kwargs):
        if q.numel() > self.numel:
            self.q_shape, self.kv_shape, self.dtype = tuple(q.shape), tuple(k.shape), q.dtype
            self.numel = q.numel()
        if args:
            self.lengths = args[0]
        self.causal = kwargs.get("causal", True)
        return self.orig(q, k, v, *args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
        return False


class SyncTimer:
    """Wraps a model method: synchronises the card on entry and exit and adds
    the wall seconds to ``seconds``; ``after`` sees each call's result."""

    def __init__(self, torch, fn, after=None) -> None:
        self.torch, self.fn, self.after = torch, fn, after
        self.seconds = 0.0
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        if self.after is not None:
            self.after(out)
        return out


def serve_parity_small(torch, np, arch: str) -> dict:
    """The smoke config of ``arch`` in float32: the card against the CPU,
    same weights."""
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.serve.engine import Engine, Request

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 9)))
    errs = []
    hc, cc = host.init_cache(2, 32), card.init_cache(2, 32)
    want, hc = host.prefill(toks, hc)
    got, cc = card.prefill(toks.cuda(), cc)
    errs.append((got.cpu() - want).abs().max().item())
    tok = want.argmax(-1)
    for _ in range(6):
        want, hc = host.decode_step(hc, tok)
        got, cc = card.decode_step(cc, tok.cuda())
        errs.append((got.cpu() - want).abs().max().item())
        tok = want.argmax(-1)
    if max(errs) > 1e-4:
        fail(f"{arch} smoke LM on the card differs from the CPU by {max(errs)}")
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (3, 5, 2, 7, 4)]
    outs = []
    for model, dev, eager in ((host, "cpu", False), (card, "cuda", False), (card, "cuda", True)):
        eng = Engine(model, slots=2, max_len=64, device=dev, _eager=eager)
        if (eng.decode_graph is None) != (dev == "cpu" or eager):
            fail(f"{arch} smoke Engine on {dev} (eager {eager}) has the wrong decode path")
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_tokens=6))
        outs.append(sorted((r.rid, r.out) for r in eng.run()))
    if outs[1] != outs[2]:
        fail(f"{arch} smoke Engine's decode graph gives other greedy tokens than its eager step")
    if outs[0] != outs[1]:
        fail(f"{arch} smoke Engine on the card gives other greedy tokens than on the CPU")
    return {"arch": arch, "logits_max_abs_err": max(errs), "requests": len(outs[0]),
            "tokens": sum(len(o[1]) for o in outs[0]), "graph_tokens_equal_eager": True}


class MoERecorder:
    """Pass-through for ``moe.moe_layer`` and ``moe.dispatch`` as the model
    calls them: keeps each call's dropped count (a 0-d device tensor, summed
    only after the run, so no host sync and no device launch of its own)
    and, when ``keep`` is set, each call's dispatch."""

    def __init__(self, moe_mod, keep: bool = False) -> None:
        self.moe_mod, self.keep = moe_mod, keep
        self.orig = moe_mod.moe_layer, moe_mod.dispatch
        self.dropped: list = []
        self.dispatches: list = []

    def _layer(self, *args):
        y, aux, dropped = self.orig[0](*args)
        self.dropped.append(dropped)
        return y, aux, dropped

    def _dispatch(self, *args):
        d = self.orig[1](*args)
        if self.keep:
            self.dispatches.append(d)
        return d

    def __enter__(self):
        self.moe_mod.moe_layer, self.moe_mod.dispatch = self._layer, self._dispatch
        return self

    def __exit__(self, *exc):
        self.moe_mod.moe_layer, self.moe_mod.dispatch = self.orig
        return False


def same_dispatch(torch, a, b) -> bool:
    return (len(a) == len(b) and all(torch.equal(x.order, y.order) and torch.equal(x.slot, y.slot)
                                     and torch.equal(x.dropped, y.dropped) for x, y in zip(a, b)))


def full_width_parity(torch, model, gen) -> dict:
    """The full-width model on a short prompt (1 x 64 tokens, 4 decode
    steps) through the kernels and through their plain versions.

    Dense: K5 and K6 plain; the logits within 5% of their scale, every
    argmax equal.  MoE: K3 plain; every dispatch (order, slots, dropped)
    and every logit identical.  K5 and K6 stay on their kernels there: the
    router's strict top-k flips near-ties on a bf16 rounding one place
    apart, so a plain attention path routes some tokens elsewhere (PERF.md
    §7).  They are held to their plain versions at the MoE run's own shapes
    instead (:func:`check_attention_at`)."""
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod

    is_moe = model.cfg.moe is not None
    toks = torch.randint(0, model.cfg.vocab_size, (1, 64), generator=gen, device="cuda")

    def run(plain: bool):
        saved = (attn_mod.flash_attention, attn_mod.decode_attention_kernel, bt.sort_rows_kv)
        if plain and is_moe:
            bt.sort_rows_kv = bt.sort_rows_kv_plain
        elif plain:
            attn_mod.flash_attention = fa_mod.flash_attention_plain
            attn_mod.decode_attention_kernel = decode_attention_plain
        try:
            with MoERecorder(moe_mod, keep=True) as rec:
                cache = model.init_cache(1, 128)
                logits, cache = model.prefill(toks, cache)
                seq = [logits.float()]
                tok = toks[:, -1]
                for _ in range(4):
                    logits, cache = model.decode_step(cache, tok)
                    seq.append(logits.float())
                    tok = logits.argmax(-1)
        finally:
            attn_mod.flash_attention, attn_mod.decode_attention_kernel, bt.sort_rows_kv = saved
        out = torch.stack(seq)
        if not torch.isfinite(out).all():
            fail("full-width logits are not finite")
        return out, rec

    kern, krec = run(False)
    plain, prec = run(True)
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    if is_moe:
        if not same_dispatch(torch, krec.dispatches, prec.dispatches):
            fail("with K3 plain, the dispatch differs from the kernel run")
        if err:
            fail(f"with K3 plain, the logits differ from the kernel run by {err}")
        return {"plain": "k3", "dispatch_calls": len(krec.dispatches), "dispatch_identical": True,
                "dropped": int(sum(d.dropped for d in krec.dispatches)),
                "assignments": int(sum(d.order.numel() for d in krec.dispatches)),
                "logits_max_abs_err": err, "logits_max_abs": scale, "argmax_equal": True}
    # bf16 attention outputs round at one more place on one side; the layers
    # carry that: hold the kernels' logits within 5% of the logits' scale
    if err > 0.05 * scale:
        fail(f"full-width logits through the kernels differ from the plain path by {err} (scale {scale})")
    if not torch.equal(kern.argmax(-1), plain.argmax(-1)):
        fail("full-width greedy tokens through the kernels differ from the plain path")
    return {"plain": "k5+k6", "logits_max_abs_err": err, "logits_max_abs": scale, "argmax_equal": True}


def phase_serve(torch, np, args, arch: str, phase: str, smoke_archs) -> dict:
    """One LM serve path at full width; returns what the kernels phase needs."""
    from repro_torch import configs, models
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import Engine, Request

    parity = [serve_parity_small(torch, np, a) for a in smoke_archs]

    cfg = configs.get_config(arch)
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    t0 = time.perf_counter()
    model = models.build(cfg, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    width = full_width_parity(torch, model, gen)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(args.seed)
    prompts = []
    for rid in range(SERVE["requests"]):
        plen = int(rng.integers(SERVE["prompt_min"], SERVE["prompt_max"] + 1))
        prompts.append(rng.integers(0, cfg.vocab_size, size=plen).tolist())
    want = {"flash_attention": cfg.num_layers, "decode_attention": cfg.num_layers,
            "row_sort_kv": moe_layers, "row_sort": 0, "tournament": 0, "merge_rows": 0}

    def engine_run(eager: bool, after_step=None):
        """One Engine over the 8 requests; the counters zeroed just before
        ``run`` and read just after; ``after_step`` runs after each decode
        step.  Returns the engine, its timers, the finished requests, the
        run's seconds, launches and peak memory."""
        eng = Engine(model, slots=SERVE["slots"], max_len=SERVE["max_len"], device="cuda", _eager=eager)
        for rid, p in enumerate(prompts):
            eng.add(Request(rid=rid, prompt=p, max_tokens=SERVE["new_tokens"]))
        finite = []
        prefill = SyncTimer(torch, model.prefill, lambda out: finite.append(torch.isfinite(out[0]).all()))
        decode = SyncTimer(torch, eng._decode, lambda out: (
            finite.append(torch.isfinite(out).all()), after_step and after_step()))
        model.prefill, eng._decode = prefill, decode
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            t_run = time.perf_counter()
            finished = eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t_run
            launches = dict(build.LAUNCHES)
        finally:
            del model.prefill, eng._decode
        if not torch.stack(finite).all():
            fail(f"the {arch} serve run produced non-finite logits")
        if len(finished) != SERVE["requests"]:
            fail(f"{len(finished)} of {SERVE['requests']} requests finished")
        for r in finished:
            if len(r.out) != SERVE["new_tokens"] or not all(0 <= t < cfg.vocab_size for t in r.out):
                fail(f"request {r.rid} came back with {len(r.out)} tokens or a token out of the vocabulary")
        return eng, prefill, decode, finished, run_s, launches, torch.cuda.max_memory_allocated()

    def rates(prefill, decode, finished, run_s) -> dict:
        new_tokens = sum(len(r.out) for r in finished)
        return {"run_s": run_s, "prefills": prefill.calls, "prefill_s": prefill.seconds,
                "prefill_tokens_per_s": sum(len(p) - 1 for p in prompts) / prefill.seconds,
                "decode_steps": decode.calls, "decode_tokens": new_tokens, "decode_s": decode.seconds,
                "decode_tokens_per_s": new_tokens / decode.seconds,
                "ms_per_decode_step": decode.seconds / decode.calls * 1e3,
                "host_s_outside_model": run_s - prefill.seconds - decode.seconds}

    def hold(launches: dict, prefills: int, steps: int, what: str) -> None:
        for name, per in want.items():
            n = per * (prefills + steps) if name == "row_sort_kv" else (
                per * prefills if name == "flash_attention" else per * steps)
            if launches[name] != n:
                fail(f"{arch} {what}: {name} launched {launches[name]} times, want {n} "
                     f"({prefills} prefills, {steps} decode steps)")

    # -- the main path: the decode step replayed as one CUDA graph -------------
    eng, prefill, decode, finished, run_s, g_launches, peak = engine_run(False)
    entries = ["flash_fwd", "flash_fwd_bf16", "decode_partial", "decode_merge", "chunk_stages",
               "strided_stages", "global_stage", "row_sort_kernel", "tile_merge", "merge_round",
               "merge_tile", "global_first", "global_cleaner"]
    nodes = build.graph_kernel_nodes(eng.decode_graph, entries)
    per_replay = {"flash_attention": nodes["flash_fwd"] + nodes["flash_fwd_bf16"],
                  "decode_attention": nodes["decode_partial"],
                  "row_sort_kv": nodes["chunk_stages"] + nodes["strided_stages"] + nodes["global_stage"],
                  "row_sort": nodes["row_sort_kernel"], "tournament": nodes["tile_merge"] + nodes["merge_round"],
                  "merge_rows": nodes["merge_tile"] + nodes["global_first"] + nodes["global_cleaner"]}
    if eng.decode_steps != decode.calls:
        fail(f"{arch}: the engine counted {eng.decode_steps} replays, the timer {decode.calls}")
    if g_launches["decode_attention"] or (moe_layers and g_launches["row_sort_kv"] != moe_layers * prefill.calls):
        fail(f"{arch}: a decode-step kernel launched outside the graph")
    launches = {k: g_launches[k] + per_replay[k] * decode.calls for k in want}
    hold(launches, prefill.calls, decode.calls, "graph run")
    if launches["flash_attention"] < 1 or launches["decode_attention"] < 1 or (moe_layers and launches["row_sort_kv"] < 1):
        fail(f"a kernel of the {arch} serve path never launched")
    graph_line = rates(prefill, decode, finished, run_s)
    graph_tokens = sorted((r.rid, r.out) for r in finished)
    first_tokens = [r.out[:4] for r in sorted(finished, key=lambda r: r.rid)]
    if args.profile:
        phase_serve_profile(torch, eng, rng, cfg)
    del eng, finished
    torch.cuda.empty_cache()

    # -- the same requests on the eager step: tokens, times, kernel shapes -----
    step_lengths = []
    with AttnRecorder(attn_mod, "flash_attention") as k5_in, \
            AttnRecorder(attn_mod, "decode_attention_kernel") as k6_in, \
            LargestShape(bt, "sort_rows_kv") as k3_in, MoERecorder(moe_mod) as moe_rec:
        eng, eprefill, edecode, efinished, erun_s, e_launches, epeak = engine_run(
            True, lambda: step_lengths.append(k6_in.lengths))
    if sorted((r.rid, r.out) for r in efinished) != graph_tokens:
        fail(f"{arch}: the decode graph's tokens differ from the eager step's")
    hold(e_launches, eprefill.calls, edecode.calls, "eager run")
    lens = torch.stack(step_lengths).sum(dim=1)
    k6_lengths = step_lengths[int(lens.argmax())].tolist()
    names = ["flash_attention", "decode_attention"] + (["row_sort_kv"] if moe_layers else [])
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "config": SERVE, "parity_smoke_f32_vs_cpu": parity,
            "parity_full_width_kernels_vs_plain": width, "init_s": init_s,
            "weight_bytes": weight_bytes, "prompt_lengths": [len(p) for p in prompts],
            "decode": "cuda_graph", **graph_line, "prefill_tokens": sum(len(p) - 1 for p in prompts),
            "peak_device_bytes": peak, "launches": {k: launches[k] for k in names},
            "decode_graph": {"kernel_nodes": nodes["all"], "per_replay": {k: per_replay[k] for k in names},
                             "decode_merge_nodes": nodes["decode_merge"], "replays": decode.calls},
            "eager": {**rates(eprefill, edecode, efinished, erun_s), "peak_device_bytes": epeak,
                      "launches": {k: e_launches[k] for k in names}},
            "graph_tokens_equal_eager": True, "first_tokens": first_tokens}
    if moe_layers:
        line["dropped_assignments_eager_run"] = int(torch.stack(moe_rec.dropped).sum())
    emit(line)
    del eng, efinished, model
    torch.cuda.empty_cache()
    return {"launches": launches, "k5": k5_in, "k6": k6_in, "k6_lengths": k6_lengths,
            "k3_shape": k3_in.shape, "k3_dtype": k3_in.dtype,
            "k3_real": (max(len(p) for p in prompts) - 1) * (cfg.moe.top_k if cfg.moe else 0)}


def phase_serve_profile(torch, eng, rng, cfg) -> None:
    """One prefill of up to 1024 tokens and eight decode steps of the serve
    path under ``torch.profiler``: device busy share and time by kernel."""
    from repro_torch.serve.engine import Request

    plen = min(1024, eng.max_len - 8)
    eng.add(Request(rid=99, prompt=rng.integers(0, cfg.vocab_size, size=plen).tolist(), max_tokens=8))
    emit({"phase": "serve_profile", "arch": cfg.name, "prompt": plen, "decode_steps": 8,
          **profiled(torch, eng.run)[0]})


def check_attention_at(torch, serve: dict, gen, phase: str) -> None:
    """K5 and K6 against their plain versions (fresh peaked inputs,
    ``attn_limit``) at the largest inputs a serve run gave them: the
    prefill's q and k/v shapes, the decode step with the most cache rows."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    k5, k6 = serve["k5"], serve["k6"]
    lengths = torch.tensor(serve["k6_lengths"], dtype=torch.int32, device="cuda")
    e5, _ = check_k5(fa, torch, gen, k5.q_shape, k5.kv_shape, k5.dtype, k5.causal)
    e6, _ = check_k6(da, torch, gen, k6.q_shape, k6.kv_shape, k6.dtype, lengths)
    torch.cuda.synchronize()
    emit({"phase": phase, "dtype": str(k5.dtype).replace("torch.", ""),
          "flash_attention": {"q": list(k5.q_shape), "kv": list(k5.kv_shape), "causal": k5.causal,
                              "max_abs_err": e5},
          "decode_attention": {"q": list(k6.q_shape), "cache": list(k6.kv_shape),
                               "lengths": serve["k6_lengths"], "max_abs_err": e6}})
    torch.cuda.empty_cache()


def attention_rows(torch, serve: dict, gen) -> list[dict]:
    """The kernels-line rows of K5 and K6 at the serve run's largest inputs."""
    import itertools

    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    rows = []
    k5 = serve["k5"]
    b, t, h, d = k5.q_shape
    kv = k5.kv_shape[2]
    dt = k5.dtype
    err, (q, k, v) = check_k5(fa, torch, gen, k5.q_shape, k5.kv_shape, dt, k5.causal)
    name = str(dt).replace("torch.", "")
    flops, bytes_ = k5_work(b, t, h, kv, d, q.element_size(), k5.causal)
    b_ms, b_by = attn_bound(flops, bytes_)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "launches": serve["launches"]["flash_attention"], "max_abs_err": err,
        "shape": {"q": list(k5.q_shape), "kv": list(k5.kv_shape), "causal": k5.causal}, "dtype": name,
        **timings(lambda: fa.flash_attention(q, k, v, causal=k5.causal),
                  lambda: fa.flash_attention_plain(q, k, v, causal=k5.causal),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=k5.causal, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": bytes_,
    })
    del q, k, v, qt, kt, vt

    k6 = serve["k6"]
    b, h, d = k6.q_shape
    _, s, kv, _ = k6.kv_shape
    dt = k6.dtype
    name = str(dt).replace("torch.", "")
    layers = 8  # cycle over 8 layers' caches so that no launch finds its cache in L2
    lengths = torch.tensor(serve["k6_lengths"], dtype=torch.int32, device="cuda")
    err, (q, kc, vc) = check_k6(da, torch, gen, k6.q_shape, k6.kv_shape, dt, lengths, layers)
    flops, bytes_ = k6_work(serve["k6_lengths"], h, kv, d, q.element_size())
    b_ms, b_by = attn_bound(flops, bytes_)
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    qs = q[:, :, None, :]

    def cycling(fn):
        it = itertools.cycle(range(layers))

        def run():
            i = next(it)
            return fn(kc[i], vc[i])
        return run

    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:74",
        "launches": serve["launches"]["decode_attention"], "max_abs_err": err,
        "shape": {"q": list(k6.q_shape), "cache": list(k6.kv_shape), "lengths": serve["k6_lengths"]},
        "dtype": name, "block_s": da.BLOCK_S,
        **timings(cycling(lambda kk, vv: da.decode_attention(q, kk, vv, lengths)),
                  cycling(lambda kk, vv: da.decode_attention_plain(q, kk, vv, lengths)),
                  cycling(lambda kk, vv: F.scaled_dot_product_attention(
                      qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask, enable_gqa=True))),
        "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": bytes_,
    })
    del q, kc, vc
    torch.cuda.empty_cache()
    return rows


def k1_device_epoch(torch, bt, gen, dev: dict) -> dict:
    """K1 at the device epoch's largest input (the root hop's packed int64
    record cells), for the K1 row of the kernels line: its kernel nodes per
    captured epoch, and an eager and a graph call's time at that shape."""
    x = main_path_input(torch, gen, dev["k1_shape"], dev["k1_dtype"], sorted_rows=False)
    err = exact(bt.sort_rows(x), bt.sort_rows_plain(x))
    if err:
        fail("K1 differs from its plain version at the device epoch's shape")
    b_bytes, ce = k1_work(x.shape[0], x.shape[1], x.element_size())
    b_ms, b_by = bound(b_bytes, ce, x.element_size())
    out = {"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
           "graph_nodes_per_epoch": dev["k1_nodes"], "epochs": dev["epochs"], "max_abs_err": err,
           **timings(lambda: bt.sort_rows(x), lambda: bt.sort_rows_plain(x),
                     lambda: torch.sort(x, dim=1).values),
           "bound_ms": b_ms, "bound_by": b_by}
    del x
    torch.cuda.empty_cache()
    return out


def sort_rows_of(torch, bt, gen, launches, k1_in, k2_in) -> list[dict]:
    """The kernels-line rows of K1 and K2 at the pipeline's largest inputs."""
    rows = []
    x1 = main_path_input(torch, gen, k1_in.shape, k1_in.dtype, sorted_rows=False)
    x2 = main_path_input(torch, gen, k2_in.shape, k2_in.dtype, sorted_rows=True)
    for name, x, kern, plain, lib, work, ops_per, src, replaces in (
        ("row_sort", x1, bt.sort_rows, bt.sort_rows_plain,
         lambda x: torch.sort(x, dim=1).values, k1_work, OPS_PER_COMPARE_EXCHANGE,
         "src/repro_torch/kernels/csrc/row_sort.cu", "src/repro/kernels/bitonic.py:174"),
        ("tournament", x2, bt.merge_tournament, bt.tournament_plain,
         lambda x: torch.sort(x.reshape(-1)).values, k2_work, OPS_PER_MERGE_STEP,
         "src/repro_torch/kernels/csrc/tournament.cu", "src/repro/kernels/bitonic.py:261"),
    ):
        err = exact(kern(x), plain(x))
        if err:
            fail(f"{name} differs from its plain version at the main-path shape")
        b_bytes, ce = work(x.shape[0], x.shape[1], x.element_size())
        b_ms, b_by = bound(b_bytes, ce, x.element_size(), ops_per)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", ""),
            **timings(lambda: kern(x), lambda: plain(x), lambda: lib(x)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    del x1, x2
    torch.cuda.empty_cache()
    return rows


def ptxas_line(build) -> dict:
    """Registers, static shared memory, stack and spills of every kernel entry
    built in this process, from the compiler's ``-Xptxas -v`` output
    (``build.BUILD_LOGS``); names demangled with ``c++filt`` where present.
    Dynamic shared memory is set at launch and is not in these numbers."""
    import re
    import shutil

    rows = []
    for lib, log in sorted(build.BUILD_LOGS.items()):
        cur = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"library": lib, "kernel": m.group(1)}
                rows.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                cur.update(registers=int(m.group(1)), smem_static_bytes=int(smem.group(1)) if smem else 0)
    spilled = [r for r in rows if r.get("spill_stores") or r.get("spill_loads")]
    if spilled:
        fail(f"ptxas reports spills in {[(r['library'], r['kernel']) for r in spilled]}")
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and rows:
        names = subprocess.run([cxxfilt], input="\n".join(r["kernel"] for r in rows), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                r["kernel"] = name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
    return {"ptxas": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000_000, help="keys in the sort run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time the hop's row sort and the glue around K1 in a "
                         "second sort run, profile a third and a short serve run "
                         "(device busy share, time by kernel)")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import mergesort
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.kernels import bitonic as bt
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.net.pipeline import run_pipeline

    smi = smi_line()
    t0 = time.perf_counter()
    build_s = build.build_kernels()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          "kernels_built": sorted(build.BUILD_LOGS), "kernel_build_s": build_s,
          "build_wall_s": time.perf_counter() - t0})

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_k1(bt, torch, gen)
    phase_k2(bt, torch, gen)

    # -- the sort path ---------------------------------------------------------
    parity = parity_small(torch, np, run_pipeline, random_trace)
    n = args.n
    t_prep = time.perf_counter()
    trace = random_trace(n, seed=args.seed)
    payload = np.empty((n, 2), dtype=np.int64)
    payload[:, 0] = trace * 7 + 3
    payload[:, 1] = np.arange(n)
    values_d = torch.from_numpy(trace).cuda()
    payload_d = torch.from_numpy(payload).cuda()
    del payload, trace
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t_prep
    clock = StageClock()
    torch.cuda.reset_peak_memory_stats()
    with LargestShape(bt, "sort_rows") as k1_in, LargestShape(bt, "merge_tournament") as k2_in:
        build.reset_launches()
        mergesort.reset_branches()
        t_run = time.perf_counter()
        res = run_pipeline(
            values_d, payload=payload_d, max_value=trace_max_value("random"),
            seed=args.seed, tracer=clock, device="cuda", **E2E,
        )
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = dict(build.LAUNCHES)
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
    if any(launches[k] for k in ("flash_attention", "decode_attention", "row_sort_kv", "merge_rows")):
        fail("the sort path launched a kernel of another path")
    if branches["ladder"] != 0:
        fail(f"merge_runs_flat took the host ladder {branches['ladder']} times")
    fused_out, fused_payload = res.output, res.sorted_payload
    del want
    emit({"phase": "pipeline", "n": n, "config": E2E, "parity_with_cpu_at": parity,
          "prep_s": prep_s, "run_s": run_s, "keys_per_s": n / run_s,
          "stage_s": dict(clock.seconds), "server_makespan_s": res.server_seconds,
          "per_server_s": res.per_server_seconds, "pool_merge_s": res.pool_merge_seconds,
          "server_keys": res.server_keys, "passes": res.passes,
          "peak_device_bytes": peak, "launches": {k: launches[k] for k in ("row_sort", "tournament")},
          "merge_branches": branches})
    del res
    if args.profile:
        phase_profile(torch, run_pipeline, values_d, payload_d, args.seed)
    dev_epoch = phase_pipeline_device(torch, np, args, run_pipeline, random_trace, values_d, payload_d,
                                      fused_out, fused_payload)
    phase_pipeline_observed(torch, np, run_pipeline, "cuda", values_d, payload_d, fused_out,
                            fused_payload, args.seed)
    del values_d, payload_d, fused_out, fused_payload
    torch.cuda.empty_cache()
    phase_pipeline_sampled(torch, np, run_pipeline, "cuda",
                           [(name, min(n, args.n), flows) for name, n, flows in SCENARIO_ROWS],
                           min(SCENARIO_DEVICE_N, args.n), args.seed)
    phase_pipeline_network(torch, np, run_pipeline, "cuda", min(NETWORK_N, args.n), args.seed)
    rows = sort_rows_of(torch, bt, gen, launches, k1_in, k2_in)
    rows[0]["device_epoch"] = k1_device_epoch(torch, bt, gen, dev_epoch)

    # -- the serve paths -------------------------------------------------------
    phase_k3(bt, torch, gen)
    phase_k4(bt, torch, gen)
    phase_k5(fa, torch, gen)
    phase_k6(da, torch, gen)
    serve = phase_serve(torch, np, args, SERVE_ARCH, "serve", [SERVE_ARCH])
    attn = attention_rows(torch, serve, gen)
    moe = phase_serve(torch, np, args, MOE_ARCH, "serve_moe", [MOE_ARCH, "deepseek-moe-16b"])
    check_attention_at(torch, moe, gen, "serve_moe_attention")
    rows += bitonic_rows(torch, bt, gen, moe["k3_shape"], moe["k3_dtype"], moe["k3_real"], moe["launches"])
    rows += attn

    emit({"kernels": rows})
    emit(ptxas_line(build))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
