"""A cell defined by new files alone -- a traffic mix and an entry of
``BENCHMARK.json`` -- is found and run without an edit of the harness."""

from __future__ import annotations

import json
import shutil

from sortbench.tests.conftest import ROOT


def test_a_new_cell_from_data_files_alone(run_cell, tmp_path):
    shutil.copytree(ROOT / "sortbench", tmp_path / "sortbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "single-s1.narrow", "config": "single-s1", "traffic": "narrow", "chips": 1,
                               "why": "a test's mix: 1,000 values, half the positions shuffled"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "sortbench" / "traffic" / "narrow.json").write_text(json.dumps(
        {"name": "narrow", "domain": 1000, "shuffled_fraction": 0.5}))
    rc, line, err = run_cell("single-s1.narrow", 20_000, root=tmp_path)
    assert rc == 0 and line["correct"] is True, err
    assert {"keys_per_s", "setup_s"} <= set(line["metrics"])
