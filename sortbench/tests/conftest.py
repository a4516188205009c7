"""Shared helpers of the benchmark's CPU tests: a cell run in process on the
CPU at a small size, its last line parsed."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def run_cell(capfd):
    """``run_cell(workload, keys, trace=0, **main_kw)`` -> (exit code, last
    stdout line as a dict or None, stderr)."""
    import torch.distributed as dist

    from repro_torch.core import distributed as cd
    from repro_torch.net import pipeline
    from sortbench import run

    # A planted fault replaces these in the process: each run puts them back.
    saved = [(pipeline, "run_pipeline"), (cd, "sort_sharded"), (dist, "all_to_all_single")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]

    def _run(workload: str, keys: int, trace: int = 0, seconds: float = 0.3, seed: int = 2147483659, **kw):
        argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
        kw.setdefault("device", "cpu")
        try:
            rc = run.main(argv, keys=keys, **kw)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        out, err = capfd.readouterr()
        lines = [ln for ln in out.splitlines() if ln.strip()]
        line = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
        return rc, line, err

    return _run
