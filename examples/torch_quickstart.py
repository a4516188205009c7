"""Quickstart on the PyTorch port: the paper's pipeline end-to-end on one card.

Stream -> programmable switch (MergeMarathon partial sort, simulated)
-> computation server (k-way natural merge sort per segment + concat).
The twin of ``examples/quickstart.py`` on ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py [--n 1000000] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np
import torch

import _bootstrap  # noqa: F401

from repro_torch import resolve_device
from repro_torch.core import RunStats, Switch, marathon_streams, merge_sort, server_sort
from repro_torch.data import random_trace


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--segments", type=int, default=16)
    ap.add_argument("--length", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    trace = torch.from_numpy(random_trace(args.n)).to(dev)
    maxv = 32_767
    print(f"input: {args.n} values, "
          f"{RunStats.of(trace).num_runs} initial runs")

    # -- no switch: the server sorts the raw stream -----------------------
    t0 = time.perf_counter()
    _, passes = merge_sort(trace, k=10)
    _sync(dev)
    t_plain = time.perf_counter() - t0
    print(f"plain merge sort: {t_plain:.3f}s ({passes} merge passes)")

    # -- with MergeMarathon on the switch ----------------------------------
    # (vectorized switch model; the faithful per-packet simulator in
    # repro_torch.core.switchsim computes the identical stream)
    streams, ranges = marathon_streams(trace, args.segments, args.length, maxv)
    stats = [RunStats.of(s) for s in streams if s.numel()]
    print(
        f"switch {args.segments}x{args.length}: "
        f"{int(np.sum([s.num_runs for s in stats]))} runs, "
        f"mean len {np.mean([s.mean_len for s in stats]):.1f}"
    )
    t0 = time.perf_counter()
    out, passes = server_sort(streams, k=10)
    _sync(dev)
    t_mm = time.perf_counter() - t0
    if not torch.equal(out, torch.sort(trace).values):
        raise AssertionError("server sort differs from torch.sort")
    print(
        f"MergeMarathon server sort: {t_mm:.3f}s "
        f"(max {max(passes)} passes/segment)  "
        f"-> {100 * (1 - t_mm / t_plain):.1f}% faster"
    )

    # -- the faithful per-packet switch on a small slice -------------------
    small = trace[:5000]
    sw = Switch(args.segments, args.length, maxv)
    vals, sids = sw.apply(small)
    v2, _ = marathon_streams(small, args.segments, args.length, maxv)
    for s in range(args.segments):
        np.testing.assert_array_equal(vals[sids == s], v2[s].cpu().numpy())
    print("faithful per-packet switch == vectorized model on 5k slice ✓")


if __name__ == "__main__":
    main()
