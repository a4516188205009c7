#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 sortbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the run sets up and warms up the program
(``repro_torch``) on the card, runs sort jobs in a closed loop with one
client for ``--seconds`` seconds, judges the jobs it kept against the plain
reference once the window has closed, and prints the result as the last
line of standard output: the end-to-end metrics with ``--trace 0``, the
per-layer metrics and the device trace's breakdown with ``--trace 1``.
Without the cards the cell asks for, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device: str = "cuda", keys: int | None = None,
         patch: str | None = None, control: bool = False) -> int:
    """The command; the CPU tests call it with ``device="cpu"`` and a small
    ``keys``, which skips the look for a card."""
    args = parse(argv)
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from sortbench import harness

    harness.prepare_paths(root)
    try:
        cell = harness.load_cell(root, args.workload)
        if device == "cuda":
            harness.check_card(cell.chips)
    except (harness.Refused, OSError, KeyError) as e:
        print(f"sortbench: refused: {e}", file=sys.stderr)
        return 3
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          t0_wall=T0_WALL, device=device, keys=keys,
                          patch=patch, control=control)
    return harness.run(ctx)


if __name__ == "__main__":
    sys.exit(main())
