"""Port the fault plane (``repro_torch.net.faults``) and its fail-open
recovery paths against the reference ``repro.net.faults``, on the CPU.

Plan level: ``parse_fault_plan``/``describe`` round trips, validation,
per-epoch resolution, the link-flap overlay and ``corrupt_ranges`` draw for
draw.  Hop level: ``passthrough_hop`` (wire, ``HopStats``, ship indices, row
column, INT stamps).  Fabric level: ``run_graph(faults=)`` under the
reference's fault ladder (``benchmarks/net_bench.py FAULT_PLANS``) on the
single switch, leaf-spine and tree (wire columns, stats, metrics, fault
instants), and the timing overlay under link flaps and a dead leaf.  Pool
level: shard failover, the cascade, the replay bound.  Pipeline level:
every plan's output, passes and counters, ``engine="device"``'s fused
fallback, the unsurvivable plans, and a bounded twin of the reference's
survivable-plan property test.  Every integer path is byte-identical.
"""

import dataclasses

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
from repro.data import SCENARIOS, TRACES, scenario_max_value, trace_max_value
from repro.net import egress as ref_egress
from repro.net import engine as ref_engine
from repro.net import faults as ref_faults
from repro.net import flow as ref_flow
from repro.net import pipeline as ref_pipeline
from repro.net import timing as ref_timing
from repro.net import topology as ref_topo
from repro.obs import MetricsRegistry as RefMetrics
from repro.obs import Tracer as RefTracer
from repro.obs.telemetry import IntColumns as RefInt
from repro_torch.net import egress, engine, faults, pipeline, timing, topology, wire
from repro_torch.net.control import ranges_valid
from repro_torch.obs import MetricsRegistry, Tracer

SEGS, LENGTH = 8, 16
COLS = ("values", "flow_id", "seq", "segment_id")
TOPOS = {
    "single": {},
    "leaf_spine": {"num_leaves": 3},
    "tree": {"branching": 2, "height": 3},
}
#: The reference's fault ladder (``benchmarks/net_bench.py`` FAULT_PLANS).
FAULT_PLANS = (
    ("fault_free", ""),
    ("one_hop_degraded", "degrade:l1n0@0"),
    ("half_degraded", "degrade:l1n0@0;degrade:l0n0@0;degrade:l0n1@0"),
    ("all_degraded", "degrade:all@0"),
    ("dead_interior", "crash:l1n0@0"),
    ("dead_leaf", "crash:l0n3@0"),
    ("shard_failover", "server_crash:1@0.5"),
    ("kitchen_sink", "crash:l1n0@0;degrade:l0n0@0;server_crash:2@0.3;corrupt_ranges@0"),
)
#: The same kinds of fault aimed at the hops of the other two fabrics.
TOPO_PLANS = {
    "single": ("degrade:switch@0", "flap:egress@0"),
    "leaf_spine": ("crash:leaf0@0", "degrade:spine@0;crash:leaf2@0", "crash:leaf0@0;crash:leaf1@0"),
    "tree": ("crash:l0n0@0;crash:l0n1@0;degrade:l2n0@0", "crash:l1n0@0;crash:l1n1@0"),
}
SPECS = [spec for _, spec in FAULT_PLANS if spec] + [
    "crash:l1n0@1-3;degrade:all@0;flap:uplink:leaf0@2;server_crash:1@0.25;corrupt_ranges@0",
    "flap:fabric@0-1;flap:ingress:l0n0@1",
]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


@pytest.fixture
def x64_shim(monkeypatch):
    """R1: the reference's int64 arena merge and device engine import the
    removed ``jax.experimental.enable_x64``; this test-scoped shim gives it
    back as ``jax.enable_x64(True)``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)


def assert_batch_equal(port_batch, ref_batch):
    got = port_batch.to_numpy()
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(ref_batch, c), err_msg=c)
    assert got["epoch"] == ref_batch.epoch
    for opt in ("row_index",):
        want = getattr(ref_batch, opt)
        if want is None:
            assert got[opt] is None
        else:
            np.testing.assert_array_equal(got[opt], want, err_msg=opt)


def assert_stats_equal(port_stats, ref_stats):
    got = port_stats.to_numpy()
    for f in dataclasses.fields(ref_stats):
        want = getattr(ref_stats, f.name)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)
        elif want is None:
            assert got[f.name] is None, f.name
        else:
            assert got[f.name] == want, f.name


def assert_reports_equal(port, ref):
    assert port.makespan_ticks == ref.makespan_ticks
    assert [dataclasses.asdict(s) for s in port.links] == [dataclasses.asdict(s) for s in ref.links]


def instants(tracer):
    return [(s.name, s.cat, sorted(s.args.items())) for s in tracer.instants]


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_describe_round_trip_match_reference(spec):
    ref = ref_faults.parse_fault_plan(spec, seed=5)
    port = faults.parse_fault_plan(spec, seed=5)
    assert [dataclasses.asdict(f) for f in port.faults] == [dataclasses.asdict(f) for f in ref.faults]
    assert port.describe() == ref.describe()
    assert faults.parse_fault_plan(port.describe(), seed=5) == port
    assert bool(port) and not faults.FaultPlan()
    for num_servers in (1, 2, 4):
        assert port.server_crashes(num_servers) == ref.server_crashes(num_servers)
    for epoch in range(4):
        pe, re_ = port.at_epoch(epoch), ref.at_epoch(epoch)
        assert (pe.hop_faults, pe.range_corrupt, pe.any_dataplane) == (
            re_.hop_faults, re_.range_corrupt, re_.any_dataplane)
        assert [dataclasses.asdict(f) for f in pe.link_faults] == [
            dataclasses.asdict(f) for f in re_.link_faults]
        for name in ("l1n0", "leaf0", "spine", "switch", "l0n3"):
            assert pe.hop_state(name) == re_.hop_state(name)
        base_p, base_r = timing.LinkSpec(latency=2, loss_rate=0.1), ref_timing.LinkSpec(latency=2, loss_rate=0.1)
        for link in ("ingress:leaf0", "uplink:leaf0", "uplink:l0n0", "egress", "ingress:l0n0"):
            assert dataclasses.asdict(pe.link_spec(link, base_p)) == dataclasses.asdict(
                re_.link_spec(link, base_r))
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS and faults.HOP_STATES == ref_faults.HOP_STATES


def test_fault_validation_matches_reference():
    bad = [
        dict(kind="meteor"), dict(kind="hop_crash"), dict(kind="hop_crash", target="a", epoch=-1),
        dict(kind="hop_crash", target="a", epoch=2, until=2), dict(kind="link_flap", target="e", loss_rate=2.0),
        dict(kind="link_flap", target="e", extra_latency=-1), dict(kind="server_crash", target="x"),
        dict(kind="server_crash", target="1", at_fraction=1.5), dict(kind="range_corrupt", target="t"),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            ref_faults.Fault(**kw)
        with pytest.raises(ValueError):
            faults.Fault(**kw)
    with pytest.raises(ValueError):
        faults.parse_fault_plan("meltdown:l0n0@0")
    with pytest.raises(TypeError):
        faults.FaultPlan(("crash:a",))


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_corrupt_ranges_draw_for_draw(seed):
    ranges = ref_part.quantile_ranges(np.random.default_rng(seed).integers(0, 1 << 20, 5000), 16, 1 << 20)
    for epoch in range(6):
        ref = ref_faults.FaultPlan((ref_faults.Fault("range_corrupt", epoch=epoch),), seed=seed)
        port = faults.FaultPlan((faults.Fault("range_corrupt", epoch=epoch),), seed=seed)
        got = port.at_epoch(epoch).corrupt_ranges(ranges)
        np.testing.assert_array_equal(got, ref.at_epoch(epoch).corrupt_ranges(ranges))
        assert not ranges_valid(T(got), 16, 1 << 20)  # the corruption is detectable
    assert ranges_valid(T(ranges), 16, 1 << 20)


# -- the degraded hop ----------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "rows", "int", "empty"])
def test_passthrough_hop_matches_reference(case):
    n = 0 if case == "empty" else 2500
    v = np.random.default_rng(7).integers(0, 32768, size=n).astype(np.int64)
    rb = ref_flow.interleave_batch(ref_flow.split_flows(v, 3, 32), "bursty", seed=2)
    if case == "rows":
        r = ref_flow.interleave_batch(ref_flow.split_flows(np.arange(n), 3, 32), "bursty", seed=2)
        rb = rb.with_row_index(r.values)
    if case == "int":  # an arrival stack from an earlier hop rides along
        rb = rb.with_int_meta(RefInt.empty(n).stamp(1, np.arange(n) % 5, np.arange(n) % 3))
    ranges = ref_part.quantile_ranges(v, SEGS, 32767) if n else ref_part.set_ranges(32767, SEGS)
    rspec = ref_engine.HopSpec(SEGS, LENGTH, 32767, ranges, payload_size=32)
    pspec = engine.HopSpec(SEGS, LENGTH, 32767, T(ranges), payload_size=32)
    rout, rst = ref_engine.passthrough_hop(rb, rspec, "h", hop_id=4)
    pout, pst = engine.passthrough_hop(wire.from_reference(rb, device="cpu"), pspec, "h", hop_id=4)
    assert_batch_equal(pout, rout)
    assert_stats_equal(pst, rst)
    assert pst.recirculations == 0
    if case == "int":
        got = pout.to_numpy()["int_meta"]
        for name in ("hop_id", "queue_depth", "rank_ticks"):
            np.testing.assert_array_equal(got[name], getattr(rout.int_meta, name), err_msg=name)
    # a degraded hop keeps every segment's arrival order
    if n:
        fused, _ = engine.fused_hop(wire.from_reference(rb, device="cpu"), pspec, "h")
        for s in range(SEGS):
            assert sorted(N(pout.values[pout.segment_id == s])) == sorted(N(fused.values[fused.segment_id == s]))


# -- the fabric ----------------------------------------------------------------


def _graph_pair(topo):
    kw = dict(num_segments=SEGS, segment_length=LENGTH, max_value=32767, payload_size=32, **TOPOS[topo])
    v = np.random.default_rng(11).integers(0, 32768, 3000)
    ranges = ref_part.quantile_ranges(v, SEGS, 32767)
    groups = {"single": 1, "leaf_spine": 3, "tree": 4}[topo]
    rb = ref_flow.interleave_batch(ref_flow.split_flows(v, 2 * groups, 32), "round_robin", seed=1)
    return (ref_topo.make_topology(topo, ranges=ranges, **kw),
            topology.make_topology(topo, ranges=T(ranges), **kw), rb)


@pytest.mark.parametrize("spec", [s for _, s in FAULT_PLANS] + [s for v in TOPO_PLANS.values() for s in v])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_run_graph_under_fault_plans_matches_reference(topo, spec):
    rtopo, ptopo, rb = _graph_pair(topo)
    ef_r = ref_faults.parse_fault_plan(spec, seed=3).at_epoch(0)
    ef_p = faults.parse_fault_plan(spec, seed=3).at_epoch(0)
    rm, pm, rt, pt = RefMetrics(), MetricsRegistry(), RefTracer(), Tracer()
    try:
        rout, rstats = rtopo.run_batch(rb, faults=ef_r, metrics=rm, tracer=rt)
    except ValueError as e:  # a key-destroying plan: the port refuses it too
        with pytest.raises(ValueError, match=str(e).split(";")[0][:20]):
            ptopo.run_batch(wire.from_reference(rb, device="cpu"), faults=ef_p)
        return
    pout, pstats = ptopo.run_batch(wire.from_reference(rb, device="cpu"), faults=ef_p,
                                   metrics=pm, tracer=pt)
    assert_batch_equal(pout, rout)
    assert len(pstats) == len(rstats)
    for p, r in zip(pstats, rstats):
        assert_stats_equal(p, r)
    assert pm.snapshot() == rm.snapshot()
    assert instants(pt) == instants(rt)
    assert [(s.name, sorted(s.args)) for s in pt.find(cat="hop")] == [
        (s.name, sorted(s.args)) for s in rt.find(cat="hop")]


@pytest.mark.parametrize("spec", ["flap:egress@0", "flap:fabric@0", "flap:ingress:l0n1@0",
                                  "flap:uplink:l1n0@0;crash:l0n3@0", "crash:l0n3@0",
                                  "crash:l1n0@0;degrade:l0n0@0"])
def test_timing_overlay_under_faults_matches_reference(spec):
    rtopo, ptopo, rb = _graph_pair("tree")
    link = dict(latency=2, rate_numer=3, buffer_packets=3, loss_rate=0.05)
    rcfg = ref_timing.NetworkConfig(link=ref_timing.LinkSpec(**link), switch_latency=1, seed=4)
    pcfg = timing.NetworkConfig(link=timing.LinkSpec(**link), switch_latency=1, seed=4)
    rm, pm = RefMetrics(), MetricsRegistry()
    rout, _, rrep = rtopo.run_batch(rb, network=rcfg, metrics=rm,
                                    faults=ref_faults.parse_fault_plan(spec).at_epoch(0))
    pout, _, prep = ptopo.run_batch(wire.from_reference(rb, device="cpu"), network=pcfg, metrics=pm,
                                    faults=faults.parse_fault_plan(spec).at_epoch(0))
    assert_batch_equal(pout, rout)
    assert_reports_equal(prep, rrep)
    assert pm.snapshot() == rm.snapshot()


# -- the pool ------------------------------------------------------------------


def _delivered(n=3000, seed=9):
    vals = TRACES["random"](n, seed=seed)
    res = ref_pipeline.run_pipeline(vals, num_segments=SEGS, segment_length=LENGTH,
                                    max_value=trace_max_value("random"), num_flows=4, payload_size=32)
    return vals, res.delivered


@pytest.mark.parametrize("backend", ["numpy", "arena"])
@pytest.mark.parametrize("schedule", ["one", "cascade", "at_finish", "adopter_first"])
def test_pool_failover_matches_reference(schedule, backend, x64_shim):
    vals, delivered = _delivered()
    total = int(delivered.packet_starts().size)
    crash = {"one": [(1, total // 2)], "cascade": [(0, total // 5), (1, (3 * total) // 5)],
             "at_finish": [(3, total + 5)], "adopter_first": [(2, total // 3), (1, total // 4)]}[schedule]
    rt, pt = RefTracer(), Tracer()
    ref = ref_egress.ServerPool(SEGS, 4, crash_schedule=crash, merge_backend=backend, tracer=rt)
    port = egress.ServerPool(SEGS, 4, crash_schedule=crash, merge_backend=backend, tracer=pt, device="cpu")
    # two ingest calls: the crash cut falls inside one of them
    cut = int(delivered.packet_starts()[total // 3])
    for lo, hi in ((0, cut), (cut, len(delivered))):
        ref.ingest_batch(delivered.slice_keys(lo, hi))
        port.ingest_batch(wire.from_reference(delivered.slice_keys(lo, hi), device="cpu"))
    rout, rpasses = ref.finish()
    pout, ppasses = port.finish()
    np.testing.assert_array_equal(N(pout), rout)
    np.testing.assert_array_equal(N(pout), np.sort(vals))
    assert ppasses == rpasses
    assert port.servers_failed_over == ref.servers_failed_over == len(crash)
    assert port.server_keys == ref.server_keys and port.server_imbalance == ref.server_imbalance
    assert instants(pt) == instants(rt)


def test_replay_bound_overflow_raises_as_reference():
    _, delivered = _delivered()
    total = int(delivered.packet_starts().size)
    for mod, batch, kw in ((ref_egress, delivered, {}),
                           (egress, wire.from_reference(delivered, device="cpu"), {"device": "cpu"})):
        pool = mod.ServerPool(SEGS, 4, crash_schedule=[(1, total + 1)], replay_packets=1, **kw)
        pool.ingest_batch(batch)
        with pytest.raises(ValueError, match="replay buffer"):
            pool.finish()
    # a bound the history fits in replays it whole
    port = egress.ServerPool(SEGS, 4, crash_schedule=[(1, total // 2)], replay_packets=total, device="cpu")
    port.ingest_batch(wire.from_reference(delivered, device="cpu"))
    np.testing.assert_array_equal(N(port.finish()[0]), np.sort(delivered.values))


def test_unsurvivable_plans_raise_as_reference():
    vals = TRACES["random"](1000, seed=17)
    maxv = trace_max_value("random")
    kw = dict(num_segments=SEGS, segment_length=LENGTH, max_value=maxv, num_flows=4, payload_size=32)
    cases = [
        (dict(topology="leaf_spine", num_leaves=2, fault_plan="crash:spine@0"), "egress"),
        (dict(topology="leaf_spine", num_leaves=2, fault_plan="crash:leaf0@0;crash:leaf1@0"), "ingress"),
        (dict(num_servers=2, fault_plan="server_crash:0@0.2;server_crash:1@0.4"), "no alive server"),
    ]
    for extra, match in cases:
        with pytest.raises(ValueError, match=match):
            ref_pipeline.run_pipeline(vals, **kw, **extra)
        with pytest.raises(ValueError, match=match):
            pipeline.run_pipeline(vals, device="cpu", **kw, **extra)
    with pytest.raises(ValueError, match="single-server"):
        egress.ServerPool(SEGS, 1, crash_schedule=[(0, 10)], device="cpu")
    with pytest.raises(ValueError, match="names server"):
        egress.ServerPool(SEGS, 2, crash_schedule=[(5, 10)], device="cpu")


# -- the pipeline --------------------------------------------------------------


COUNTERS = ("fault_hops_dead", "fault_hops_degraded", "servers_failed_over", "range_fallbacks")


@pytest.mark.parametrize("backend", ["numpy", "arena"])
@pytest.mark.parametrize("name,spec", FAULT_PLANS)
def test_run_pipeline_under_every_plan_matches_reference(name, spec, backend, x64_shim):
    vals = TRACES["random"](4000, seed=3)
    kw = dict(topology="tree", branching=2, height=3, num_segments=SEGS, segment_length=LENGTH,
              max_value=trace_max_value("random"), num_flows=8, payload_size=32, range_mode="oracle",
              num_servers=4, merge_backend=backend, seed=2)
    rm, pm = RefMetrics(), MetricsRegistry()
    ref = ref_pipeline.run_pipeline(vals, fault_plan=spec or None, metrics=rm, **kw)
    port = pipeline.run_pipeline(vals, fault_plan=spec or None, metrics=pm, device="cpu", **kw)
    free = pipeline.run_pipeline(vals, device="cpu", **kw)
    np.testing.assert_array_equal(N(port.output), ref.output)
    np.testing.assert_array_equal(N(port.output), N(free.output))
    assert port.passes == ref.passes
    for c in COUNTERS:
        assert getattr(port, c) == getattr(ref, c), c
    assert port.server_keys == ref.server_keys
    assert pm.snapshot()["counters"] == rm.snapshot()["counters"]
    assert_batch_equal(port.delivered, ref.delivered)
    if name == "all_degraded":  # the plain-sort baseline: the servers merge more
        assert sum(port.passes) >= sum(free.passes) and port.fault_hops_degraded == 7


@pytest.mark.parametrize("spec", ["degrade:l1n0@0", "crash:l0n3@0;flap:fabric@0", "server_crash:1@0.5",
                                  "corrupt_ranges@0", "degrade:all@0;server_crash:0@0.6"])
def test_device_engine_under_faults_matches_reference(spec, x64_shim):
    """A dataplane fault moves ``engine="device"`` onto the fused engine
    (counted, traced, on the batch's device); server and range faults keep
    the device program."""
    vals = TRACES["network"](3000, seed=4)
    kw = dict(topology="tree", branching=2, height=3, num_segments=SEGS, segment_length=LENGTH,
              max_value=trace_max_value("network"), num_flows=8, payload_size=32, range_mode="oracle",
              num_servers=2, engine="device", seed=1)
    rm, pm, rt, pt = RefMetrics(), MetricsRegistry(), RefTracer(), Tracer()
    ref = ref_pipeline.run_pipeline(vals, fault_plan=spec, metrics=rm, tracer=rt, **kw)
    port = pipeline.run_pipeline(vals, fault_plan=spec, metrics=pm, tracer=pt, device="cpu", **kw)
    np.testing.assert_array_equal(N(port.output), ref.output)
    np.testing.assert_array_equal(N(port.output), np.sort(vals))
    assert port.passes == ref.passes
    for c in COUNTERS:
        assert getattr(port, c) == getattr(ref, c), c
    fallback = faults.parse_fault_plan(spec).at_epoch(0).any_dataplane
    got = pm.snapshot()["counters"].get("fault_device_fallbacks", {})
    assert got == rm.snapshot()["counters"].get("fault_device_fallbacks", {})
    assert bool(got) == fallback
    assert [s for s in instants(pt) if s[1] == "fault"] == [s for s in instants(rt) if s[1] == "fault"]


def test_range_corruption_in_sampled_epochs_matches_reference():
    vals = SCENARIOS["drifting"](9000, seed=1)
    kw = dict(topology="leaf_spine", num_leaves=3, num_segments=SEGS, segment_length=LENGTH,
              max_value=scenario_max_value("drifting"), num_flows=1, payload_size=32,
              range_mode="sampled", num_servers=2)
    ref = ref_pipeline.run_pipeline(vals, fault_plan="corrupt_ranges@1-3;crash:leaf1@1", **kw)
    port = pipeline.run_pipeline(vals, fault_plan="corrupt_ranges@1-3;crash:leaf1@1", device="cpu", **kw)
    assert port.num_epochs == ref.num_epochs > 1
    np.testing.assert_array_equal(N(port.output), ref.output)
    assert port.passes == ref.passes
    for c in COUNTERS:
        assert getattr(port, c) == getattr(ref, c), c
    assert port.range_fallbacks == ref.range_fallbacks >= 1


def _survivable_plan(rng, graph, num_servers):
    """The reference's random survivable plan (``tests/test_pool_faults.py``):
    the egress hop, one ingress hop and one server always survive."""
    names = [n.name for n in graph.nodes]
    ingress = [n.name for n in graph.nodes if not n.parents]
    out, killed = [], set()
    for name in names:
        if name == names[-1]:
            if rng.random() < 0.3:
                out.append(("hop_degrade", name, {}))
            continue
        roll = rng.random()
        if roll < 0.3:
            if name in ingress and len(killed) + 1 >= len(ingress):
                continue
            if name in ingress:
                killed.add(name)
            out.append(("hop_crash", name, {}))
        elif roll < 0.55:
            out.append(("hop_degrade", name, {}))
    if rng.random() < 0.3:
        out.append(("link_flap", str(rng.choice(["ingress", "fabric", "egress"])),
                    {"loss_rate": float(rng.uniform(0, 0.2)), "extra_latency": int(rng.integers(0, 8))}))
    if num_servers > 1:
        for s in rng.choice(num_servers, size=int(rng.integers(0, num_servers)), replace=False):
            out.append(("server_crash", str(int(s)), {"at_fraction": float(rng.uniform(0.1, 0.9))}))
    if rng.random() < 0.25:
        out.append(("range_corrupt", "", {}))
    seed = int(rng.integers(0, 2**31))
    return (ref_faults.FaultPlan(tuple(ref_faults.Fault(k, t, **kw) for k, t, kw in out), seed=seed),
            faults.FaultPlan(tuple(faults.Fault(k, t, **kw) for k, t, kw in out), seed=seed))


@settings(max_examples=10, deadline=None)
@given(
    scenario=st.sampled_from(sorted(SCENARIOS)),
    topo=st.sampled_from(sorted(TOPOS)),
    engine_name=st.sampled_from(("fused", "segment")),
    num_servers=st.sampled_from((1, 2, 4)),
    plan_seed=st.integers(min_value=0, max_value=2**31 - 1),
)
def test_any_survivable_plan_is_byte_identical(scenario, topo, engine_name, num_servers, plan_seed):
    """The fail-open contract, as the reference property-tests it: any
    survivable plan gives the fault-free bytes, and the reference's."""
    graph = ref_topo.make_topology(topo, num_segments=SEGS, segment_length=LENGTH, max_value=9,
                                   ranges=ref_part.set_ranges(9, SEGS), **TOPOS[topo]).graph()
    rplan, pplan = _survivable_plan(np.random.default_rng(plan_seed), graph, num_servers)
    vals = SCENARIOS[scenario](1500, seed=plan_seed % 7)
    kw = dict(topology=topo, num_segments=SEGS, segment_length=LENGTH,
              max_value=scenario_max_value(scenario), num_flows=4, payload_size=32,
              engine=engine_name, num_servers=num_servers, **TOPOS[topo])
    free = pipeline.run_pipeline(vals, device="cpu", **kw)
    port = pipeline.run_pipeline(vals, fault_plan=pplan, device="cpu", **kw)
    ref = ref_pipeline.run_pipeline(vals, fault_plan=rplan, **kw)
    np.testing.assert_array_equal(N(port.output), np.sort(vals))
    np.testing.assert_array_equal(N(port.output), N(free.output))
    assert port.passes == ref.passes
    for c in COUNTERS:
        assert getattr(port, c) == getattr(ref, c), c
