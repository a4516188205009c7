#!/usr/bin/env python3
"""Run a cell's control: the plain reference, computed in the precision below
the configuration's (int32 records for int64), in the program's place.

    python3 sortbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed is one run of the cell at its own size and load (a short window),
judged as a run is judged; every line it prints has to read
``"correct": false``.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from sortbench import run

    worst = 0
    for seed in args.seeds:
        rc = run.main(["--workload", args.workload, "--seed", str(seed), "--seconds", str(args.seconds),
                       "--trace", "0"], control=True)
        worst = worst or rc
    return worst


if __name__ == "__main__":
    sys.exit(main())
