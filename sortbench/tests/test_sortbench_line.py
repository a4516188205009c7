"""A run's last line has the result's shape; a run without its cards or without
the program prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from sortbench.harness import load_cell
from sortbench.tests.conftest import ROOT

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("workload,keys", [("single-s1.random", 20_000), ("sharded4.uniform64", 20_000)])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_results_shape(run_cell, workload, keys, trace):
    cell = load_cell(ROOT, workload)
    rc, line, err = run_cell(workload, keys, trace=trace)
    assert rc == 0 and line is not None
    assert set(KEYS) <= set(line) and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in cell.metrics if m["kind"] == kind}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert isinstance(m["value"], (int, float))
    if not trace:
        assert {"keys_per_s", "setup_s"} <= set(line["metrics"])
    dev = line["device"]
    assert dev["count"] == cell.chips and dev["kind"] == "cpu" and "memory_peak_bytes" in dev
    # The numbers compared end standard error, each beside its limit.
    tail = err.strip().splitlines()[-len(line["compared"]):]
    for (name, c), text in zip(line["compared"].items(), tail):
        assert text == f"{name} {c['value']} limit {c['limit']}"


def test_no_card_no_result(run_cell):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the look for one succeeds")
    rc, line, err = run_cell("single-s1.random", 20_000, device="cuda")
    assert rc == 3 and line is None and "no CUDA device" in err


def test_directory_without_the_program_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "sortbench", tmp_path / "sortbench", ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    cmd = [sys.executable if c == "python3" else c for c in cmd]
    proc = subprocess.run(cmd + ["--workload", "single-s1.random", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_a_loaded_jax_module_refuses_the_result(run_cell, monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_cell("single-s1.random", 20_000)
    assert rc != 0 and line is None and "jax" in err
