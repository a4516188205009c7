"""The plain references agree with the program on the CPU, and their
controls (the reference in int32) do not."""

from __future__ import annotations

import pytest
import torch
import torch.distributed as dist

from sortbench import generate
from sortbench.harness import load_cell, load_module
from sortbench.tests.conftest import ROOT


def _pipeline_case(workload: str, n: int):
    cell = load_cell(ROOT, workload)
    keys = generate.job_keys(cell.mix, n, 2147483659, 0, device="cpu")
    payload = generate.job_payload(cell.config["payload_columns"], n, 2147483659, 0, device="cpu")
    return cell, keys, payload, load_module(ROOT, "reference", cell.config["reference"])


def _got(res) -> dict:
    return {"output": (res.output, res.output.shape[0]),
            "row_order": (res.payload_row_order, res.payload_row_order.shape[0]),
            "payload": (res.sorted_payload, res.sorted_payload.shape[0])}


@pytest.mark.parametrize("workload", ["single-s1.random", "single-s1.sorted90"])
def test_reference_agrees_with_run_pipeline_on_the_cpu(workload):
    from repro_torch.net.pipeline import run_pipeline

    cell, keys, payload, ref = _pipeline_case(workload, 30_000)
    res = run_pipeline(keys, payload=payload, max_value=cell.mix["domain"] - 1, seed=1, device="cpu",
                       **cell.config["pipeline"])
    assert ref.judge(_got(res), keys, payload) == {k: 0 for k in ref.LIMITS}


@pytest.mark.parametrize("workload", ["single-s1.random", "single-s1.sorted90"])
def test_stable_sort_control_fails(workload):
    cell, keys, payload, ref = _pipeline_case(workload, 30_000)
    got = {k: (v, v.shape[0]) for k, v in ref.control(keys, payload).items()}
    found = ref.judge(got, keys, payload)
    assert found["payload_mismatches"] > 0.9 * keys.numel()


def test_judge_counts_missing_extra_and_altered_rows():
    cell, keys, payload, ref = _pipeline_case("single-s1.random", 1000)
    want = ref.sort_records(keys, payload)
    half = {k: (v[:500], 500) for k, v in want.items()}
    assert ref.judge(half, keys, payload) == {k: 500 for k in ref.LIMITS}
    altered = {k: (v.clone(), v.shape[0]) for k, v in want.items()}
    altered["payload"][0][7, 1] += 1
    assert ref.judge(altered, keys, payload)["payload_mismatches"] == 1


def test_range_reference_agrees_with_one_rank_sort_sharded(tmp_path):
    from repro_torch.core import distributed as cd
    from repro_torch.distributed.compat import make_mesh

    cell = load_cell(ROOT, "sharded4.uniform64")
    cfg = cell.config
    ref = load_module(ROOT, "reference", cfg["reference"])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", world_size=1, rank=0)
    try:
        mesh = make_mesh((1,), ("segment",), "cpu")
        for job in range(2):
            x = generate.job_keys(cell.mix, 20_000, 5, job, device="cpu")
            sp = cd.make_splitters(generate.strided_sample(x, cfg["sample_per_rank"]).numpy(), 1)
            padded, valid, overflow = cd.sort_sharded(x, mesh, "segment", sp, capacity_factor=cfg["capacity_factor"],
                                                      presort_block=cfg["presort_block"])
            nums = ref.judge(0, padded[: int(valid[0])], [int(valid[0])], int(overflow[0]), [x])
            assert nums == {k: 0 for k in ref.LIMITS}
    finally:
        dist.destroy_process_group()


def test_range_reference_judges_the_guarantee_and_its_control_fails():
    cell = load_cell(ROOT, "sharded4.uniform64")
    ref = load_module(ROOT, "reference", cell.config["reference"])
    keys = [generate.job_keys(cell.mix, 8000, 3, 0, r, device="cpu") for r in range(4)]
    want = ref.sorted_keys(keys)
    # Any split of the sorted keys in rank order keeps the guarantee.
    for valids in ([8000] * 4, [5000, 11000, 0, 16000]):
        cuts = torch.tensor([0] + valids).cumsum(0).tolist()
        for r in range(4):
            nums = ref.judge(r, want[cuts[r]:cuts[r + 1]], valids, 0, keys)
            assert nums == {k: 0 for k in ref.LIMITS}
    # A key left out, two keys swapped across ranks, a rank's keys out of order.
    assert ref.judge(0, want[:7999], [7999] * 4, 0, keys)["count_mismatches"] == 4
    swapped = want[:8000].clone()
    swapped[-1] = want[8000]
    assert ref.judge(0, swapped, [8000] * 4, 0, keys)["key_mismatches"] == 1
    assert ref.judge(2, want[16000:24000].flip(0), [8000] * 4, 0, keys)["key_mismatches"] > 7000
    got, valid, over = ref.control(1, 4, keys)
    assert ref.judge(1, got, [int(valid[0])] * 4, int(over[0]), keys)["key_mismatches"] > 0.9 * 8000
