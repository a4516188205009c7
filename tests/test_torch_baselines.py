"""Port the paper's baselines against the reference, on the CPU: the
faithful switch (``repro_torch.core.switchsim``, Alg. 2 and 3 element at a
time), the pre-fusion per-segment MergeMarathon (``marathon_streams``,
``marathon_flat(block_sort=)``), the ``segment`` and ``faithful`` hop
engines, ``run_pipeline(engine="segment"|"faithful")``, ``RunStats`` and
the pure-Python Alg. 1 ``merge_sort_reference``.

Hypothesis drives the switch over streams and geometries that reach every
``SegmentInsertValue`` case (empty, partially filled, full with an empty or
a non-empty younger run); every output is byte-identical to the reference's
and to the fused engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare interpreter: property tests skip, the rest run
    from _hypstub import given, settings, st

from repro.core import marathon as ref_marathon
from repro.core import mergesort as ref_mergesort
from repro.core import partition as ref_part
from repro.core import runs as ref_runs
from repro.core import switchsim as ref_switchsim
from repro.data import TRACES, trace_max_value
from repro.net import engine as ref_engine
from repro.net import flow as ref_flow
from repro.net import pipeline as ref_pipeline
from repro_torch.core import marathon, mergesort, runs, switchsim
from repro_torch.kernels import bitonic
from repro_torch.net import engine, pipeline, wire

COLS = ("values", "flow_id", "seq", "segment_id")
TOPOS = {"single": {}, "leaf_spine": {"num_leaves": 3}, "tree": {"branching": 2, "height": 3}}


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def scalars(st_):
    return tuple(getattr(st_, f.name) for f in dataclasses.fields(st_) if f.compare)


# -- the faithful switch -------------------------------------------------------


@st.composite
def switch_case(draw):
    segs = draw(st.integers(min_value=1, max_value=6))
    length = draw(st.integers(min_value=1, max_value=9))
    maxv = draw(st.integers(min_value=max(segs, 7), max_value=200))
    n = draw(st.integers(min_value=0, max_value=250))
    vals = draw(st.lists(st.integers(min_value=0, max_value=maxv), min_size=n, max_size=n))
    return segs, length, maxv, np.asarray(vals, dtype=np.int64)


@settings(max_examples=60, deadline=None)
@given(switch_case())
def test_switch_matches_reference_insert_for_insert(case):
    segs, length, maxv, vals = case
    ref = ref_switchsim.Switch(segs, length, maxv)
    port = switchsim.Switch(segs, length, maxv)
    for v in vals.tolist():
        assert port.insert(v) == ref.insert(v)
        for ps, rs in zip(port.segments, ref.segments):
            np.testing.assert_array_equal(ps.stages, rs.stages)
            assert (ps.last, ps.partition_index, ps.full) == (rs.last, rs.partition_index, rs.full)
    assert list(port.flush()) == list(ref.flush())


@settings(max_examples=60, deadline=None)
@given(switch_case())
def test_switch_apply_matches_reference_and_fused(case):
    segs, length, maxv, vals = case
    rv, rs = ref_switchsim.Switch(segs, length, maxv).apply(vals)
    pv, ps = switchsim.Switch(segs, length, maxv).apply(T(vals))
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(ps, rs)
    fv, fs = marathon.marathon_flat(T(vals), segs, length, maxv)
    np.testing.assert_array_equal(N(fv), pv)
    np.testing.assert_array_equal(N(fs), ps)


def test_segment_insert_reaches_every_case():
    """A fixed stream through one segment of length 4 walks the cases in
    turn: empty, partially filled (append and right shift), full with an
    empty younger run, full with a younger run (append and shift)."""
    seq = [8, 3, 12, 5, 7, 4, 20, 1, 9, 6]
    ref, port = ref_switchsim.Segment(0, 100, 4), switchsim.Segment(0, 100, 4)
    hit = set()
    for v in seq:
        before = (port.full, port.last, port.partition_index)
        if not port.full:
            hit.add("empty" if port.last < 0 else ("append" if v >= port.stages[port.last] else "shift"))
        elif port.partition_index == 0:
            hit.add("full_young_empty")
        else:
            hit.add("full_append" if v >= port.stages[port.partition_index - 1] else "full_shift")
        assert port.insert(v) == ref.insert(v), before
        np.testing.assert_array_equal(port.stages, ref.stages)
    assert hit == {"empty", "append", "shift", "full_young_empty", "full_append", "full_shift"}
    assert port.flush() == ref.flush()


def test_switch_paper_figures_and_dictated_ranges():
    sw = switchsim.Switch(1, 6, 100)
    for v in [3, 9, 12, 17]:
        assert sw.insert(v) is None
    assert sw.insert(10) is None
    np.testing.assert_array_equal(sw.segments[0].stages[:5], [3, 9, 10, 12, 17])  # Fig. 9
    sw = switchsim.Switch(1, 4, 100)
    for v in [8, 3, 12, 5]:
        sw.insert(v)
    assert sw.insert(7) == (0, 3) and sw.insert(4) == (0, 5)  # Fig. 10
    assert [v for _, v in sw.flush()] == [8, 12, 4, 7]
    vals = TRACES["network"](1200, seed=11)
    maxv = trace_max_value("network")
    ranges = ref_part.quantile_ranges(vals, 8, maxv)
    rv, rs = ref_switchsim.Switch(8, 16, maxv, ranges=ranges).apply(vals)
    pv, ps = switchsim.Switch(8, 16, maxv, ranges=T(ranges)).apply(vals)
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(ps, rs)
    with pytest.raises(ValueError):
        switchsim.Switch(4, 4, 99, ranges=np.zeros((3, 2)))
    with pytest.raises(ValueError, match="outside the switch domain"):
        switchsim.Switch(2, 4, 9).insert(10)


# -- the per-segment MergeMarathon ----------------------------------------------


@pytest.mark.parametrize("trace_name", sorted(TRACES))
def test_persegment_marathon_matches_reference(trace_name):
    vals = TRACES[trace_name](1300, seed=23)
    maxv = trace_max_value(trace_name)
    for segs, length in ((1, 4), (8, 16), (16, 7)):
        rv, rs = ref_marathon.marathon_flat(vals, segs, length, maxv, block_sort=ref_marathon.blockwise_sort)
        for sorter in (marathon.blockwise_sort, engine.k1_block_sort):
            pv, ps = marathon.marathon_flat(T(vals), segs, length, maxv, block_sort=sorter)
            np.testing.assert_array_equal(N(pv), rv)
            np.testing.assert_array_equal(N(ps), rs)
        rstreams, rranges = ref_marathon.marathon_streams(vals, segs, length, maxv)
        pstreams, pranges = marathon.marathon_streams(T(vals), segs, length, maxv, block_sort=engine.k1_block_sort)
        np.testing.assert_array_equal(N(pranges), rranges)
        assert len(pstreams) == len(rstreams)
        for p, r in zip(pstreams, rstreams):
            np.testing.assert_array_equal(N(p), r)


@pytest.mark.parametrize("block", [1, 2, 5, 16, 64, 100])
@pytest.mark.parametrize("keys", ["int32", "negative", "wide", "int64_max"])
def test_k1_block_sort_equals_blockwise_sort(block, keys):
    """K1's per-segment sort at any width (a non-power of two is padded)
    and any keys (outside ``[0, int32 max)`` on K1's int64 path, where the
    reference fell back to numpy): equal to the plain blockwise sort."""
    rng = np.random.default_rng(block)
    v = {"int32": rng.integers(0, 1 << 20, 333), "negative": rng.integers(-50, 50, 333),
         "wide": rng.integers(0, 1 << 40, 333),
         "int64_max": np.where(rng.random(333) < 0.2, np.iinfo(np.int64).max,
                               rng.integers(0, 9, 333))}[keys].astype(np.int64)
    got = engine.k1_block_sort(T(v), block)
    np.testing.assert_array_equal(N(got), ref_marathon.blockwise_sort(v, block))
    assert engine.k1_block_sort(T(v[:0]), block).numel() == 0


# -- the hop engines -------------------------------------------------------------


@pytest.mark.parametrize("eng", ["segment", "faithful"])
@pytest.mark.parametrize("trace_name", sorted(TRACES))
def test_baseline_hops_match_reference_and_fused(trace_name, eng):
    vals = TRACES[trace_name](2000, seed=29)
    maxv = trace_max_value(trace_name)
    rb = ref_flow.interleave_batch(ref_flow.split_flows(vals, 3, 32), "bursty", seed=5)
    ranges = ref_part.quantile_ranges(vals, 8, maxv)
    rspec = ref_engine.HopSpec(8, 16, maxv, ranges, payload_size=32)
    pspec = engine.HopSpec(8, 16, maxv, T(ranges), payload_size=32)
    pb = wire.from_reference(rb, device="cpu")
    rout, rst = ref_engine.run_hop(rb, rspec, "h", eng)
    pout, pst = engine.run_hop(pb, pspec, "h", eng)
    fout, fst = engine.run_hop(pb, pspec, "h", "fused")
    got, fused = pout.to_numpy(), fout.to_numpy()
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(rout, c), err_msg=c)
        np.testing.assert_array_equal(got[c], fused[c], err_msg=c)
    assert scalars(pst) == scalars(rst) and pst == fst  # every scalar stat
    np.testing.assert_array_equal(N(pst.segment_loads), rst.segment_loads)
    np.testing.assert_array_equal(N(pst.ship_emission), rst.ship_emission)
    np.testing.assert_array_equal(N(pst.ship_emission), N(fst.ship_emission))
    assert (pst.emitted_run_lengths is None) == (rst.emitted_run_lengths is None)


def test_baseline_hops_refuse_provenance_and_take_empty_batches():
    vals = np.arange(50, dtype=np.int64)
    spec = engine.HopSpec(4, 8, 49, T(ref_part.set_ranges(49, 4)), payload_size=16)
    pb = wire.packetize_batch(T(vals))
    for eng in ("segment", "faithful"):
        with pytest.raises(ValueError, match="INT telemetry"):
            engine.run_hop(pb, spec, "h", eng, int_telemetry=True)
        with pytest.raises(ValueError, match="row indices"):
            engine.run_hop(pb.with_row_index(T(vals)), spec, "h", eng)
        out, st_ = engine.run_hop(pb.slice_keys(0, 0), spec, "h", eng)
        assert len(out) == 0 and st_.arrivals == 0 and st_.ship_emission.numel() == 0
    assert set(engine.HOP_ENGINES) == set(engine.ENGINES) == set(ref_engine.HOP_ENGINES)


@pytest.mark.parametrize("mode", ["static", "oracle", "sampled"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_run_pipeline_baseline_engines_match_reference(topo, mode):
    vals = TRACES["network"](2000, seed=31)
    kw = dict(topology=topo, num_segments=8, segment_length=16, max_value=trace_max_value("network"),
              num_flows=4, payload_size=32, range_mode=mode, verify=True, **TOPOS[topo])
    fused = pipeline.run_pipeline(vals, device="cpu", **kw)
    for eng in ("segment", "faithful"):
        ref = ref_pipeline.run_pipeline(vals, engine=eng, **kw)
        port = pipeline.run_pipeline(vals, engine=eng, device="cpu", **kw)
        assert port.engine == eng and port.num_epochs == ref.num_epochs
        got = port.delivered.to_numpy()
        for c in COLS:
            np.testing.assert_array_equal(got[c], getattr(ref.delivered, c), err_msg=(eng, c))
            np.testing.assert_array_equal(got[c], N(getattr(fused.delivered, c)), err_msg=(eng, c))
        np.testing.assert_array_equal(N(port.output), ref.output)
        assert port.passes == ref.passes == fused.passes
        assert [dataclasses.replace(s, segment_loads=None) for s in port.hop_stats] == [
            dataclasses.replace(s, segment_loads=None) for s in fused.hop_stats]


def test_faithful_flag_runs_the_faithful_engine():
    vals = TRACES["random"](4000, seed=0)[:4000]
    kw = dict(topology="single", num_segments=16, segment_length=64, max_value=trace_max_value("random"),
              payload_size=64, verify=True)
    ref = ref_pipeline.run_pipeline(vals, faithful=True, **kw)
    port = pipeline.run_pipeline(vals, faithful=True, device="cpu", **kw)
    assert port.engine == "faithful"
    np.testing.assert_array_equal(N(port.output), ref.output)
    assert port.passes == ref.passes
    with pytest.raises(ValueError, match="conflicts"):
        pipeline.run_pipeline(vals, faithful=True, engine="fused", device="cpu")


# -- the small remnants ----------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 7, 500])
def test_run_stats_match_reference(n):
    for seed in range(3):
        a = np.random.default_rng(seed + n).integers(0, 20, n).astype(np.int64)
        assert dataclasses.asdict(runs.RunStats.of(T(a))) == dataclasses.asdict(ref_runs.RunStats.of(a))
    a = np.asarray([1, 2, 3, 1, 2, 0])
    assert runs.RunStats.of(T(a)).num_runs == 3 and runs.RunStats.of(T(a)).mean_len == 2.0


@pytest.mark.parametrize("k", [2, 3, 10])
@pytest.mark.parametrize("n", [0, 1, 100, 777])
def test_merge_sort_reference_matches_reference(n, k):
    a = np.random.default_rng(n * k).integers(-1000, 1000, n).astype(np.int64)
    got = mergesort.merge_sort_reference(T(a), k=k)
    np.testing.assert_array_equal(N(got), ref_mergesort.merge_sort_reference(a, k=k))
    np.testing.assert_array_equal(N(got), N(mergesort.merge_sort(T(a), k=k)[0]) if n else np.sort(a))


def test_segment_engine_counts_k1_once_per_nonempty_segment(monkeypatch):
    """On the CPU the wrapper runs the plain network; each call of it is
    what launches K1 on the card: once per segment that received keys."""
    calls = []
    orig = bitonic.sort_rows

    def spy(x):
        calls.append(tuple(x.shape))
        return orig(x)

    monkeypatch.setattr(bitonic, "sort_rows", spy)
    vals = TRACES["network"](3000, seed=2)
    maxv = trace_max_value("network")
    rb = ref_flow.interleave_batch(ref_flow.split_flows(vals, 4, 64), "round_robin")
    spec = engine.HopSpec(16, 24, maxv, T(ref_part.set_ranges(maxv, 16)), payload_size=64)
    out, st_ = engine.segment_hop(wire.from_reference(rb, device="cpu"), spec, "h")
    assert len(calls) == int((st_.segment_loads > 0).sum()) and all(w == 32 for _, w in calls)
    np.testing.assert_array_equal(np.sort(N(out.values)), np.sort(vals))
