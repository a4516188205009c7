"""On the card: one short run of each one-card cell at a reduced job size,
correct.  Skips without a card (the look is made inside the test)."""

from __future__ import annotations

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["single-s1.random", "single-s1.sorted90"])
def test_a_short_run_on_the_card_is_correct(run_cell, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rc, line, err = run_cell(workload, 2_000_000, seconds=2.0, device="cuda")
    assert rc == 0 and line["correct"] is True, err
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
