"""The port's CUDA kernels on the card: K1 and K2 against their plain torch
versions, the launch counters, and a small pipeline against its CPU run.

Marked ``cuda``; every test skips with a reason where no card is present.
Run them on a machine with an NVIDIA card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mergesort
from repro_torch.data.traces import random_trace
from repro_torch.kernels import bitonic, ops
from repro_torch.net.pipeline import run_pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    bitonic.build_kernels()
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,b", [(1, 2), (3, 64), (1000, 64), (17, 128), (5, 1024), (2, 4096)])
def test_row_sort_kernel_equals_plain(gen, dtype, rows, b):
    x = torch.randint(-(1 << 20), 1 << 20, (rows, b), dtype=dtype, device="cuda", generator=gen)
    got = bitonic.sort_rows(x)
    assert torch.equal(got, bitonic.sort_rows_plain(x))
    assert torch.equal(got, torch.sort(x, dim=1).values)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("p,b", [(2, 1), (2, 2), (8, 512), (1024, 64), (4096, 2), (2, 1 << 14), (1 << 15, 128)])
def test_tournament_kernel_equals_plain(gen, dtype, p, b):
    hi = torch.iinfo(dtype).max
    x = torch.randint(0, 1 << 30, (p, b), dtype=dtype, device="cuda", generator=gen)
    cut = torch.randint(1, b + 1, (p, 1), device="cuda", generator=gen)
    x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi)
    x = torch.sort(x, dim=1).values.contiguous()
    got = ops.merge_tournament(x)
    assert torch.equal(got, bitonic.tournament_plain(x))
    assert torch.equal(got, torch.sort(x.reshape(-1)).values)


def test_wrappers_count_launches_and_check_inputs(gen):
    bitonic.reset_launches()
    x = torch.randint(0, 100, (8, 64), dtype=torch.int32, device="cuda", generator=gen)
    bitonic.sort_rows(x)
    bitonic.merge_tournament(torch.sort(x, dim=1).values)
    bitonic.sort_rows(x[:, :1].contiguous())  # one-key rows: nothing to launch
    assert bitonic.LAUNCHES == {"row_sort": 1, "tournament": 1}
    with pytest.raises(ValueError, match="contiguous"):
        bitonic.sort_rows(x.t())
    with pytest.raises(TypeError):
        bitonic.sort_rows(x.to(torch.int16))


@pytest.mark.parametrize("backend,jitter", [("arena", 0), ("arena", 8), ("numpy", 8)])
def test_pipeline_on_card_equals_cpu_run(gen, backend, jitter):
    """The card's run (kernels, the slow reorder path under jitter, the
    ladder) is byte-identical to the plain versions' run on the CPU."""
    vals = random_trace(60_000, seed=3)
    payload = np.stack([vals * 7 + 3, np.arange(vals.size)], axis=1)
    kw = dict(topology="tree", branching=2, height=3, num_segments=4, segment_length=64,
              payload_size=256, num_flows=8, range_mode="oracle", num_servers=2,
              merge_backend=backend, jitter_window=jitter, payload=payload)
    bitonic.reset_launches()
    mergesort.reset_branches()
    card = run_pipeline(vals, device="cuda", **kw).to_numpy()
    assert bitonic.LAUNCHES["row_sort"] == 7
    if backend == "arena":
        assert bitonic.LAUNCHES["tournament"] >= 1
        assert mergesort.MERGE_BRANCHES["ladder"] == 0
    host = run_pipeline(vals, device="cpu", **kw).to_numpy()
    for key in ("output", "payload_row_order", "sorted_payload"):
        np.testing.assert_array_equal(card[key], host[key])
    for c in ("values", "flow_id", "seq", "segment_id", "row_index"):
        np.testing.assert_array_equal(card["delivered"][c], host["delivered"][c])
    assert card["passes"] == host["passes"]
    assert card["max_reorder_depth"] == host["max_reorder_depth"]
    np.testing.assert_array_equal(card["output"], np.sort(vals))
