"""M20's remnants in the port, against the JAX package: ``repro_torch.net``
exports every name ``repro.net`` does (the packet-list forms ``interleave``,
``INTERLEAVES`` and ``jitter_delivery`` held to the reference's on the same
flows; ``SwitchHop`` on a wire batch; ``pallas_row_sort`` the hop's row
sort), ``repro_torch.kernels`` exports ``ops``, ``configs.paper_sort``'s
grid is the reference's, and each example twin (``examples/torch_*.py``)
prints the reference example's lines at the same arguments on the CPU.

The reference examples run unedited (in this process with their
``sys.argv`` set, ``distributed_sort.py`` in a subprocess of its own because
it sets ``XLA_FLAGS`` for 8 fake devices).  Lines are compared after
``chip_smoke.masked_lines`` (the masks the card run uses) hides what a run
cannot repeat: times and the rates and percentages made from them; the serve
twin's tokens and the training twin's losses, which come from weights drawn
from a ``torch.Generator`` where the reference draws from ``PRNGKey(0)``;
the arena backend's note (it names the reference's compiler); a checkpoint
directory.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

import jax.numpy as jnp

import repro.kernels
import repro.kernels.ops
import repro.net
from repro.configs import paper_sort as ref_paper_sort
from repro.core.partition import set_ranges as ref_set_ranges
from repro.net import flow as ref_flow
from repro.net import packet as ref_packet
from repro.net import pipeline as ref_pipeline
from repro.net import server as ref_server
from repro_torch import kernels, net
from repro_torch.configs import paper_sort
from repro_torch.core.partition import set_ranges
from repro_torch.net import engine, flow, packet, pipeline, server, wire

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


# -- exports ---------------------------------------------------------------------------------


def test_net_exports_every_reference_name():
    ref_names = set(repro.net.__all__) | {n for n in dir(repro.net) if not n.startswith("_")
                                          and not isinstance(getattr(repro.net, n), type(repro))}
    missing = sorted(n for n in ref_names if not hasattr(net, n))
    assert not missing
    assert list(net.__all__) == list(repro.net.__all__)
    assert net.pallas_row_sort is engine.row_sort_device


def test_kernels_export_ops_as_the_reference_does():
    assert hasattr(repro.kernels, "ops") and kernels.ops.__name__ == "repro_torch.kernels.ops"


def test_paper_grid_equals_reference():
    for trace in ("random", "network"):
        got = [vars(c) for c in paper_sort.paper_grid(trace, n=1000)]
        want = [vars(c) for c in ref_paper_sort.paper_grid(trace, n=1000)]
        assert got == want and len(got) == 42
    assert vars(paper_sort.SortJobConfig()) == vars(ref_paper_sort.SortJobConfig())
    assert (paper_sort.PAPER_SEGMENTS, paper_sort.PAPER_LENGTHS) == (ref_paper_sort.PAPER_SEGMENTS,
                                                                   ref_paper_sort.PAPER_LENGTHS)


def _flows(n: int = 1000, seed: int = 0):
    vals = np.random.default_rng(seed).integers(0, 1 << 20, n).astype(np.int64)
    return (ref_flow.split_flows(vals, 3, payload_size=64),
            flow.split_flows(torch.from_numpy(vals), 3, payload_size=64))


def _same_packets(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.flow_id, g.seq, g.segment_id) == (w.flow_id, w.seq, w.segment_id)
        assert np.array_equal(g.payload.numpy(), np.asarray(w.payload))


@pytest.mark.parametrize("mode", ["round_robin", "bursty", "weighted_fair"])
def test_interleave_list_forms_match_reference(mode):
    ref_flows, flows = _flows()
    _same_packets(flow.interleave(flows, mode, seed=3), ref_flow.interleave(ref_flows, mode, seed=3))
    _same_packets(net.INTERLEAVES[mode](flows, seed=4), repro.net.INTERLEAVES[mode](ref_flows, seed=4))
    batch = flow.interleave_batch(flows, mode, seed=3)
    assert np.array_equal(batch.values.numpy(),
                          torch.cat([p.payload for p in flow.interleave(flows, mode, seed=3)]).numpy())


@pytest.mark.parametrize("window", [0, 1, 5])
def test_jitter_delivery_matches_reference(window):
    ref_flows, flows = _flows(seed=1)
    want = ref_pipeline.jitter_delivery(ref_flow.interleave(ref_flows, seed=0), window, seed=7)
    _same_packets(pipeline.jitter_delivery(flow.interleave(flows, seed=0), window, seed=7), want)


def test_switch_hop_runs_a_batch_and_refuses_the_list_view():
    """The name is older than the list view: ``SwitchHop.process_batch`` is
    ``run_hop`` on the batch, and ``process`` (the reference's two calls,
    ``WireBatch.from_packets`` on the hop's device and ``to_packets``) gives
    the reference's ``process`` packet for packet, stats too, on interleaved
    flows; an empty list gives an empty list."""
    vals = torch.from_numpy(np.random.default_rng(2).integers(0, 4096, 2000).astype(np.int64))
    batch = wire.packetize_batch(vals, 64)
    ranges = set_ranges(4096, 8, device="cpu")
    hop = net.SwitchHop("s0", 8, 16, 4096, ranges)
    spec = net.HopSpec(8, 16, 4096, ranges)
    got, stats = hop.process_batch(batch)
    want, want_stats = net.run_hop(batch, spec, "s0", "fused")
    assert torch.equal(got.values, want.values) and stats == want_stats
    ref_flows, flows = _flows(n=3000, seed=5)
    ref_hop = repro.net.SwitchHop("s0", 8, 16, 1 << 20, ref_set_ranges(1 << 20, 8))
    hop = net.SwitchHop("s0", 8, 16, 1 << 20, set_ranges(1 << 20, 8, device="cpu"))
    want, want_stats = ref_hop.process(ref_flow.interleave(ref_flows, seed=2))
    got, stats = hop.process(flow.interleave(flows, seed=2))
    _same_packets(got, want)
    for field in ("arrivals", "load_imbalance", "emitted_runs", "mean_run_len", "recirculations"):
        assert getattr(stats, field) == getattr(want_stats, field), field
    assert np.array_equal(stats.segment_loads.numpy(), want_stats.segment_loads)
    assert hop.process([])[0] == [] and ref_hop.process([])[0] == []


def test_merge_round_robin_matches_reference():
    """``net.packet.merge_round_robin`` on streams of unequal lengths (one
    empty) gives the reference's order."""
    rng = np.random.default_rng(3)
    vals = [rng.integers(0, 1 << 20, n).astype(np.int64) for n in (700, 0, 100, 333)]
    ref_streams = [ref_packet.packetize(v, 64, flow_id=i) for i, v in enumerate(vals)]
    streams = [packet.packetize(torch.from_numpy(v), 64, flow_id=i) for i, v in enumerate(vals)]
    _same_packets(packet.merge_round_robin(streams), ref_packet.merge_round_robin(ref_streams))
    assert packet.merge_round_robin([]) == ref_packet.merge_round_robin([]) == []


@pytest.mark.parametrize("n,k", [(0, 10), (1, 10), (5000, 2), (5000, 10), (20000, 64)])
def test_plain_runs_upper_bound_matches_reference(n, k):
    vals = np.random.default_rng(n).integers(0, 50, n).astype(np.int64)
    vals[: n // 3] = np.sort(vals[: n // 3])  # long runs as well as short ones
    assert server.plain_runs_upper_bound(torch.from_numpy(vals), k) == ref_server.plain_runs_upper_bound(vals, k)


def test_ops_sorts_match_reference():
    """``ops.blockwise_sort`` and ``ops.sort_rows`` (K1's plain version on the
    CPU) against the reference's (Pallas in interpret mode), int32 keys;
    a block that does not divide the stream raises as the reference's does."""
    x = np.random.default_rng(9).integers(-1000, 1000, 4096).astype(np.int32)
    for block in (8, 64, 512):
        want = np.asarray(repro.kernels.ops.blockwise_sort(jnp.asarray(x), block))
        assert np.array_equal(kernels.ops.blockwise_sort(torch.from_numpy(x), block).numpy(), want)
    rows = x.reshape(16, 256)
    assert np.array_equal(kernels.ops.sort_rows(torch.from_numpy(rows)).numpy(),
                          np.asarray(repro.kernels.ops.sort_rows(jnp.asarray(rows))))
    for bad in (48, 8192):
        with pytest.raises(ValueError, match="pow2 block dividing n"):
            kernels.ops.blockwise_sort(torch.from_numpy(x), bad)
        with pytest.raises(ValueError, match="pow2 block dividing n"):
            repro.kernels.ops.blockwise_sort(jnp.asarray(x), bad)


@pytest.mark.parametrize("causal", [True, False])
def test_ops_flash_attention_matches_reference(causal):
    """``ops.flash_attention`` (K5's plain version on the CPU) against the
    reference's Pallas kernel in interpret mode: f32, GQA 2 q heads a kv
    head, T = S = 128 at blocks of 64; within 1e-5."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 128, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 128, 2, 64)).astype(np.float32) for _ in range(2))
    want = repro.kernels.ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                             block_q=64, block_k=64)
    got = kernels.ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- the example twins ---------------------------------------------------------------------

def _smoke():
    """``chip_smoke.py``'s module: its ``masked_lines`` masks the lines the card
    run compares too."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_lines = _smoke().masked_lines


def _load(path: Path):
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(path: Path, argv: list[str], monkeypatch, call_with_argv: bool) -> str:
    mod = _load(path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), monkeypatch.context() as m:
        m.setattr(sys, "argv", [str(path), *argv])
        mod.main(argv) if call_with_argv else mod.main()
    return buf.getvalue()


CASES = {
    "quickstart": ["--n", "20000"],
    "net_pipeline": ["--n", "20000"],
    "net_pipeline_tree": ["--n", "20000", "--topology", "tree", "--servers", "4", "--merge-backend", "arena",
                          "--payload-bytes", "16", "--ranges", "sampled", "--trace", "drifting", "--int"],
    "net_pipeline_faults": ["--n", "20000", "--fault-plan", "degrade:spine@0;server_crash:1@0.5", "--servers", "2",
                            "--link-latency", "2", "--link-rate", "4/1", "--loss-rate", "0.02"],
    "net_pipeline_jobs": ["--n", "10000", "--jobs", "3", "--topology", "single", "--interleave", "round_robin"],
    "serve_lm": ["--requests", "5", "--max-tokens", "4"],
    "train_moe": ["--steps", "3", "--batch", "2", "--seq", "32"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_prints_the_reference_lines(case, monkeypatch, tmp_path):
    example = case.split("_tree")[0].split("_faults")[0].split("_jobs")[0]
    argv = CASES[case] + (["--ckpt-dir", str(tmp_path / "ref")] if example == "train_moe" else [])
    want = _run(EXAMPLES / f"{example}.py", argv, monkeypatch, call_with_argv=False)
    if example == "train_moe":
        argv = CASES[case] + ["--ckpt-dir", str(tmp_path / "port")]
    got = _run(EXAMPLES / f"torch_{example}.py", argv + ["--device", "cpu"], monkeypatch, call_with_argv=True)
    assert _lines(got) == _lines(want)
    assert len(got.splitlines()) >= 3


def test_distributed_sort_twin_prints_the_reference_lines():
    """8 ranks: the reference on 8 fake devices, the twin on 8 gloo ranks,
    both in subprocesses, run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, str(EXAMPLES / "distributed_sort.py")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = subprocess.run([sys.executable, str(EXAMPLES / "torch_distributed_sort.py"), "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=300)
    want, err = ref.communicate(timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    assert ref.returncode == 0, err[-2000:]
    assert _lines(got.stdout) == _lines(want)
    assert "across 8 devices" in got.stdout and "1 run == fully sorted" in got.stdout
