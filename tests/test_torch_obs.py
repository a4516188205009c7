"""Port the observability plane (``repro_torch.obs``: the recording tracer,
the metrics registry, the INT columns) and its wiring through the dataplane
against the reference ``repro.obs``, on the CPU.

Unit level: the same calls on both registries give equal snapshots, the
same stamps and gathers give equal INT stacks and summaries, and both
tracers record spans of the same shape.  Dataplane level: an observed
``run_pipeline`` equals the reference's in its span hierarchy (names,
categories, lanes, depths and argument keys; not times), its metrics
snapshot, its INT columns and summary; and every observed run equals the
unobserved one byte for byte (the port's twin of
``tests/test_obs_transparency.py``, on the fused and device engines).
"""

import json

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare interpreter: property tests skip, the rest run
    from _hypstub import given, settings, st

from repro.core import partition as ref_part
from repro.data import SCENARIOS as REF_SCENARIOS
from repro.data import TRACES as REF_TRACES
from repro.net import engine as ref_engine
from repro.net import flow as ref_flow
from repro.net import pipeline as ref_pipeline
from repro.net import wire as ref_wire
from repro.obs import IntColumns as RefInt
from repro.obs import MetricsRegistry as RefMetrics
from repro.obs import Tracer as RefTracer
from repro.obs import int_summary as ref_int_summary
from repro_torch.data import SCENARIOS, TRACES, scenario_max_value, trace_max_value
from repro_torch.net import egress, engine, pipeline, wire
from repro_torch.obs import (
    INT_FIELDS,
    NULL_TRACER,
    IntColumns,
    MetricsRegistry,
    NullTracer,
    Tracer,
    default_registry,
    int_summary,
)

SEGS, LENGTH = 8, 16
TOPOS = {"single": {}, "leaf_spine": {"num_leaves": 3}, "tree": {"branching": 2, "height": 2}}
WORKLOADS = sorted(TRACES) + sorted(SCENARIOS)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def shape(spans):
    """What two runs' spans must share: not their times."""
    return [(s.name, s.cat, s.tid, s.depth, sorted(s.args)) for s in spans]


@pytest.fixture
def x64(monkeypatch):
    """The reference's device engine enters ``jax.experimental.enable_x64``,
    which jax 0.9 no longer has: the test-scoped shim of ROADMAP.md R1."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)


# -- tracer --------------------------------------------------------------------


def test_tracer_records_nested_spans_like_the_reference(tmp_path):
    runs = []
    for tr in (RefTracer(), Tracer()):
        with tr.span("outer", cat="hop", keys=10) as outer:
            with tr.span("inner", cat="stage"):
                tr.instant("tick", cat="control", epoch=0)
            with tr.span("lane", tid=3):
                pass
            outer.set(keys_out=9)
        with tr.timed("wall", cat="egress", tid=1) as t:
            pass
        assert t.seconds >= 0
        runs.append(tr)
    ref, port = runs
    assert shape(port.spans) == shape(ref.spans)
    assert shape(port.instants) == shape(ref.instants)
    assert [s.args for s in port.spans] == [s.args for s in ref.spans]
    outer = port.find("outer")[0]
    assert outer.args == {"keys": 10, "keys_out": 9} and outer.seconds == outer.dur
    assert port.find(cat="stage") == [port.spans[0]]
    assert port.total_seconds("outer") == outer.dur
    doc, want = port.chrome_trace(), ref.chrome_trace()
    assert set(doc) == set(want)
    events = lambda d: sorted((e["ph"], e["name"], e["cat"], e["tid"], sorted(e["args"]))  # noqa: E731
                              for e in d["traceEvents"])
    assert events(doc) == events(want)
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)
    path = tmp_path / "trace.json"
    with port.span("np", n=np.int64(4)):
        pass
    port.dump(str(path))
    assert {e["name"] for e in json.loads(path.read_text())["traceEvents"]} >= {"outer", "np"}


def test_tracer_refuses_tensor_arguments():
    tr = Tracer()
    with pytest.raises(TypeError, match="tensor"):
        tr.span("hop", keys=torch.tensor(3))
    with pytest.raises(TypeError, match="tensor"):
        tr.instant("evt", n=torch.zeros(2))
    with tr.span("hop", keys=3) as sp:
        with pytest.raises(TypeError, match="tensor"):
            sp.set(keys_out=torch.tensor(3))
    NULL_TRACER.span("hop", keys=torch.tensor(3))  # records nothing, reads nothing


def test_null_tracer_records_nothing_but_timed_still_measures():
    tr = NullTracer()
    assert tr is not NULL_TRACER and not tr.enabled
    span = tr.span("x", cat="hop")
    assert span is tr.span("y")
    with span as sp:
        sp.set(anything=1)
    with tr.timed("wall") as t:
        sum(range(1000))
    assert t.seconds > 0
    tr.instant("evt")


# -- metrics -------------------------------------------------------------------


def _exercise(reg, as_tensor):
    reg.counter("keys", "leaf0").inc(5)
    reg.counter("keys", "leaf0").inc(2)
    reg.counter("keys", "spine").inc(1)
    reg.gauge("load").set(T(np.array([1, 2])) if as_tensor else np.array([1, 2]))
    reg.gauge("imbalance", "a").set(1.25)
    reg.gauge("hw").high_water(3)
    reg.gauge("hw").high_water(1)
    h = reg.histogram("runs", "s0")
    for v in (1, 2, 4, 4, 0, 1023, 7):
        h.observe(v)
    vals = np.random.default_rng(0).integers(0, 1 << 40, 500)
    h.observe_many(T(vals) if as_tensor else vals)
    h.observe_many(T(vals[:0]) if as_tensor else vals[:0])
    s = reg.series("depth", "s0")
    for i in range(9000):
        s.append(i, i % 7)


def test_metrics_registry_matches_reference():
    ref = RefMetrics()
    _exercise(ref, as_tensor=False)
    for as_tensor in (False, True):
        port = MetricsRegistry()
        _exercise(port, as_tensor)
        assert port.snapshot() == ref.snapshot()
    with pytest.raises(ValueError, match="already registered"):
        port.gauge("keys", "leaf0")
    with pytest.raises(ValueError, match=">= 0"):
        port.histogram("runs", "s0").observe(-1)
    with pytest.raises(ValueError, match=">= 0"):
        port.histogram("runs", "s0").observe_many(T(np.array([3, -2])))
    assert default_registry() is default_registry()


# -- INT columns ---------------------------------------------------------------


def _stacks(n, depth, seed):
    rng = np.random.default_rng(seed)
    ref, port = RefInt.empty(n), IntColumns.empty(n)
    for d in range(depth):
        hid = int(rng.integers(0, 5))
        qd, rt = rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 30, n)
        ref, port = ref.stamp(hid, qd, rt), port.stamp(hid, T(qd), rt)
    return ref, port


def assert_int_equal(port, ref):
    assert port.depth == ref.depth and len(port) == len(ref)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(N(getattr(port, name)), getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("n,depth", [(0, 2), (7, 1), (500, 3)])
def test_int_columns_and_summary_match_reference(n, depth):
    ref, port = _stacks(n, depth, seed=n)
    assert_int_equal(port, ref)
    idx = np.random.default_rng(1).permutation(n)[: n // 2]
    assert_int_equal(port.take(T(idx)), ref.take(idx))
    mask = np.arange(n) % 3 == 0
    assert_int_equal(port.take(T(mask)), ref.take(mask))
    assert_int_equal(port.slice(1, n - 1), ref.slice(1, n - 1))
    assert_int_equal(IntColumns.concat([port.slice(0, 2), port.take(T(idx))]),
                     RefInt.concat([ref.slice(0, 2), ref.take(idx)]))
    assert int_summary(port) == ref_int_summary(ref)
    # a single hop id with wide stamps: the mean is the exact integer mean
    wide = IntColumns.empty(3).stamp(0, [2**50, 2**50 + 1, 7], [1, 2, 4])
    rwide = RefInt.empty(3).stamp(0, [2**50, 2**50 + 1, 7], [1, 2, 4])
    assert int_summary(wide) == ref_int_summary(rwide)
    assert int_summary(None) == [] and int_summary(IntColumns.empty(0)) == []
    with pytest.raises(ValueError, match="different hop depths"):
        IntColumns.concat([port, port.stamp(9, np.zeros(n), np.zeros(n))])
    with pytest.raises(ValueError):
        IntColumns(hop_id=torch.zeros(3, 2), queue_depth=torch.zeros(3, 1), rank_ticks=torch.zeros(3, 2))


def test_wire_batch_carries_int_meta_like_the_reference():
    vals = np.arange(6, dtype=np.int64)
    z = np.zeros(6, dtype=np.int64)
    rmeta = RefInt.empty(6).stamp(3, np.ones(6), vals)
    rb = ref_wire.WireBatch(vals, z, z.copy(), z.copy()).with_int_meta(rmeta)
    pb = wire.from_reference(rb, device="cpu")
    assert_int_equal(pb.int_meta, rb.int_meta)
    assert_int_equal(pb.take(T(np.array([4, 1]))).int_meta, rb.take(np.array([4, 1])).int_meta)
    pcat = wire.concat_batches([pb.slice_keys(0, 2), pb.slice_keys(2, 6)])
    rcat = ref_wire.concat_batches([rb.slice_keys(0, 2), rb.slice_keys(2, 6)])
    assert_int_equal(pcat.int_meta, rcat.int_meta)
    assert_int_equal(pb.with_epoch(2, 4).int_meta, rb.with_epoch(2, 4).int_meta)
    got = pb.to_numpy()["int_meta"]
    for name in INT_FIELDS:
        np.testing.assert_array_equal(got[name], getattr(rmeta, name))
    plain = wire.WireBatch(T(vals), T(z), T(z), T(z))
    assert wire.concat_batches([pb, plain]).int_meta is None
    assert pb.with_int_meta(None).int_meta is None and plain.to_numpy()["int_meta"] is None
    with pytest.raises(ValueError, match="int_meta rows"):
        wire.WireBatch(T(vals), T(z), T(z), T(z), int_meta=IntColumns.empty(2))
    # the tenant column, once refused, rides beside the INT stack
    tb = wire.from_reference(rb.with_tenant(1), device="cpu")
    assert_int_equal(tb.int_meta, rmeta) and tb.tenant.tolist() == [1] * len(tb)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("n", [0, 1, 3000])
def test_fused_hop_int_stamp_matches_reference(n, stacked):
    v = np.random.default_rng(n).integers(0, 1 << 16, n)
    rb = ref_flow.interleave_batch(ref_flow.split_flows(v, 4, 32), "bursty", seed=2)
    if stacked:
        rb = rb.with_int_meta(RefInt.empty(n).stamp(4, np.arange(n), np.arange(n) * 2))
    ranges = ref_part.set_ranges(1 << 16, SEGS)
    rspec = ref_engine.HopSpec(SEGS, LENGTH, 1 << 16, ranges, payload_size=32)
    pspec = engine.HopSpec(SEGS, LENGTH, 1 << 16, T(ranges), payload_size=32)
    rout, _ = ref_engine.fused_hop(rb, rspec, "h", hop_id=9, int_telemetry=True)
    pout, _ = engine.fused_hop(wire.from_reference(rb, device="cpu"), pspec, "h", hop_id=9,
                               int_telemetry=True)
    assert_int_equal(pout.int_meta, rout.int_meta)
    plain, _ = engine.fused_hop(wire.from_reference(rb, device="cpu"), pspec, "h")
    for c in ("values", "seq", "segment_id"):
        assert torch.equal(getattr(plain, c), getattr(pout, c))


# -- the dataplane, observed -----------------------------------------------------


def _kw(topo, **over):
    kw = dict(topology=topo, num_segments=SEGS, segment_length=LENGTH, max_value=1 << 16,
              num_flows=4, payload_size=32, verify=True, **TOPOS[topo])
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    {"range_mode": "oracle", "num_servers": 4, "merge_backend": "arena"},
    {"range_mode": "sampled", "jitter_window": 8, "reorder_capacity": 64, "num_servers": 2},
    {"range_mode": "static", "merge_backend": "numpy"},
], ids=["oracle-arena", "sampled-jitter", "static-ladder"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_observed_pipeline_matches_reference(topo, over):
    vals = np.random.default_rng(11).integers(0, 1 << 16, size=6000)
    rt, pt = RefTracer(), Tracer()
    ref = ref_pipeline.run_pipeline(vals, tracer=rt, int_telemetry=True, **_kw(topo, **over))
    port = pipeline.run_pipeline(vals, tracer=pt, int_telemetry=True, device="cpu", **_kw(topo, **over))
    np.testing.assert_array_equal(N(port.output), ref.output)
    assert port.passes == ref.passes
    assert shape(pt.spans) == shape(rt.spans)
    assert shape(pt.instants) == shape(rt.instants)
    assert port.telemetry == ref.telemetry
    assert port.telemetry["int"] and "counters" in port.telemetry
    assert_int_equal(port.delivered.int_meta, ref.delivered.int_meta)
    assert port.delivered.int_meta.depth == {"single": 1, "leaf_spine": 2, "tree": 2}[topo]


@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_observed_device_engine_matches_reference(topo, x64):
    vals = np.random.default_rng(5).integers(0, 1 << 16, size=5000)
    rm, pm = RefMetrics(), MetricsRegistry()
    rt, pt = RefTracer(), Tracer()
    kw = _kw(topo, engine="device", range_mode="oracle", num_servers=2)
    ref = ref_pipeline.run_pipeline(vals, tracer=rt, metrics=rm, **kw)
    port = pipeline.run_pipeline(vals, tracer=pt, metrics=pm, device="cpu", **kw)
    np.testing.assert_array_equal(N(port.output), ref.output)
    assert port.passes == ref.passes
    assert shape(pt.spans) == shape(rt.spans)
    assert pm.snapshot() == rm.snapshot() == ref.telemetry == port.telemetry
    for a, b in zip(port.hop_stats, ref.hop_stats):
        np.testing.assert_array_equal(N(a.ship_emission), b.ship_emission)


def test_fresh_server_pool_accessors_do_not_raise():
    pool = egress.ServerPool(SEGS, 4, metrics=MetricsRegistry(), device="cpu")
    assert pool.max_reorder_depth == 0 and pool.server_imbalance == 1.0
    assert pool.server_keys == [0, 0, 0, 0]
    assert (pool.dup_packets_dropped, pool.spilled_packets, pool.spilled_keys) == (0, 0, 0)
    out, passes = pool.finish()
    assert out.numel() == 0 and len(passes) == SEGS


# -- transparency: observed == unobserved, byte for byte --------------------------


def _gen(workload, n, seed):
    """The port's generator, held to the reference's: the same bytes, or
    the same error type where the reference raises (R4 in ROADMAP.md:
    ``memory_trace`` at n=0)."""
    gen = TRACES.get(workload) or SCENARIOS[workload]
    ref_gen = REF_TRACES.get(workload) or REF_SCENARIOS[workload]
    try:
        want = ref_gen(n, seed=seed)
    except Exception as exc:  # noqa: BLE001 -- the port must raise the same type
        with pytest.raises(type(exc)):
            gen(n, seed=seed)
        return None
    got = gen(n, seed=seed)
    np.testing.assert_array_equal(got, want)
    return got


def _maxv(workload):
    return trace_max_value(workload) if workload in TRACES else scenario_max_value(workload)


def _assert_transparent(vals, maxv, topo, **over):
    kw = dict(topology=topo, num_segments=SEGS, segment_length=LENGTH, max_value=maxv,
              num_flows=4, payload_size=32, verify=True, seed=0, device="cpu", **TOPOS[topo])
    kw.update(over)
    plain = pipeline.run_pipeline(vals, **kw)
    tr = Tracer()
    int_ok = over.get("engine", "fused") == "fused"
    got = pipeline.run_pipeline(vals, tracer=tr, int_telemetry=int_ok, **kw)
    a, b = plain.to_numpy(), got.to_numpy()
    np.testing.assert_array_equal(a["output"], b["output"])
    for c in ("values", "flow_id", "seq", "segment_id"):
        np.testing.assert_array_equal(a["delivered"][c], b["delivered"][c], err_msg=c)
    assert a["passes"] == b["passes"] and a["num_epochs"] == b["num_epochs"]
    assert a["max_reorder_depth"] == b["max_reorder_depth"]
    for sa, sb in zip(a["hop_stats"], b["hop_stats"]):
        for f in ("name", "arrivals", "load_imbalance", "emitted_runs", "mean_run_len", "recirculations"):
            assert sa[f] == sb[f], f
    assert plain.telemetry is None and got.telemetry is not None
    if int_ok and len(vals):
        assert got.delivered.int_meta is not None
    np.testing.assert_array_equal(b["output"], np.sort(vals))
    return tr


@settings(max_examples=20, deadline=None)
@given(
    workload=st.sampled_from(WORKLOADS),
    topo=st.sampled_from(sorted(TOPOS)),
    engine_name=st.sampled_from(["fused", "device"]),
    num_servers=st.sampled_from([1, 2, 4]),
    range_mode=st.sampled_from(["static", "oracle", "sampled"]),
    n=st.integers(min_value=0, max_value=3000),
    seed=st.integers(min_value=0, max_value=2**16),
)
def test_tracing_is_transparent_property(workload, topo, engine_name, num_servers, range_mode, n, seed):
    vals = _gen(workload, n, seed)
    if vals is None:  # the reference's generator raised; so did the port's
        return
    if range_mode == "oracle" and not n:
        return  # quantiles of no keys raise in both packages
    _assert_transparent(vals, _maxv(workload), topo, engine=engine_name,
                        num_servers=num_servers, range_mode=range_mode)


def test_memory_trace_at_zero_keys_raises_as_the_reference():
    """R4: the reference's ``memory_trace(n=0)`` raises IndexError; the
    port's copy keeps that parity."""
    with pytest.raises(IndexError):
        REF_TRACES["memory"](0, seed=0)
    with pytest.raises(IndexError):
        TRACES["memory"](0, seed=0)


@pytest.mark.parametrize("engine_name", ["fused", "device"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_tracing_is_transparent_across_topologies(topo, engine_name):
    vals = _gen("network", 4000, seed=3)
    tr = _assert_transparent(vals, _maxv("network"), topo, engine=engine_name, range_mode="oracle")
    assert tr.find(cat="hop")


@pytest.mark.parametrize(
    "vals",
    [np.array([], dtype=np.int64), np.array([42], dtype=np.int64), np.full(500, 7, dtype=np.int64)],
    ids=["empty", "single", "all_dupes"],
)
@pytest.mark.parametrize("engine_name", ["fused", "device"])
def test_tracing_is_transparent_on_degenerate_streams(vals, engine_name):
    _assert_transparent(vals, 1 << 10, "single", engine=engine_name)


def test_tracing_is_transparent_under_jitter_sampling_and_arena():
    vals = _gen("drifting", 6000, seed=9)
    _assert_transparent(vals, _maxv("drifting"), "leaf_spine", range_mode="sampled", jitter_window=8,
                        reorder_capacity=64, num_servers=2, merge_backend="arena")
