"""A run with the timed path broken underneath, or with the control in the
program's place, reads ``correct: false``; a sound run reads true."""

from __future__ import annotations

import pytest

PIPELINE_FAULTS = ["pipeline_unchanged", "pipeline_half", "pipeline_altered"]
SHARDED_FAULTS = ["sharded_unchanged", "sharded_half", "sharded_altered", "sharded_no_exchange"]


@pytest.mark.parametrize("workload,fault", [("single-s1.random", f) for f in PIPELINE_FAULTS]
                         + [("single-s1.sorted90", "pipeline_altered")]
                         + [("sharded4.uniform64", f) for f in SHARDED_FAULTS])
def test_a_broken_timed_path_is_not_correct(run_cell, workload, fault):
    rc, line, _ = run_cell(workload, 20_000, patch=f"sortbench.tests.faults:{fault}")
    assert rc == 0 and line is not None
    assert line["correct"] is False and line["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in line["compared"].values())


@pytest.mark.parametrize("workload", ["single-s1.random", "single-s1.sorted90", "sharded4.uniform64"])
def test_the_control_is_not_correct(run_cell, workload):
    rc, line, _ = run_cell(workload, 20_000, control=True)
    assert rc == 0 and line["correct"] is False


@pytest.mark.parametrize("workload", ["single-s1.random", "single-s1.sorted90"])
def test_a_sound_run_is_correct(run_cell, workload):
    rc, line, _ = run_cell(workload, 20_000)
    assert rc == 0 and line["correct"] is True
    assert all(c["value"] == 0 for c in line["compared"].values())
