"""Port the per-link timing model (``repro_torch.net.timing``) and the
servers' loss recovery against the reference ``repro.net.timing``, on the
CPU.

Link level: ``simulate_link`` under every kind of spec (ideal, latency,
bandwidth, bounded buffers with the drop and backpressure policies, wire
loss, duplicates, a replay budget that runs out) gives the reference's
arrival order, ticks and ``LinkStats`` for the same sizes, ready ticks and
seed; ``resequence``, the spec helpers and ``merge_reports`` agree too.
Fabric level: ``run_graph(network=)`` and ``run_pipeline(network=)`` give
the reference's ``NetworkReport`` (every link's counters, the makespan),
delivered raw wire and recovery counters (duplicates dropped, spills), and
the sorted output stays byte-identical to the timeless run: loss costs
time, never keys.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare interpreter: property tests skip, the rest run
    from _hypstub import given, settings, st

from repro.core import partition as ref_part
from repro.data import SCENARIOS, TRACES, scenario_max_value, trace_max_value
from repro.net import engine as ref_engine
from repro.net import flow as ref_flow
from repro.net import pipeline as ref_pipeline
from repro.net import timing as ref_timing
from repro.net import topology as ref_topo
from repro.obs import MetricsRegistry as RefMetrics
from repro.obs import Tracer as RefTracer
from repro_torch.net import engine, pipeline, timing, topology, wire
from repro_torch.obs import MetricsRegistry, Tracer

SEGS, LENGTH = 8, 16
TOPOS = {"single": {}, "leaf_spine": {"num_leaves": 3}, "tree": {"branching": 2, "height": 2}}
COLS = ("values", "flow_id", "seq", "segment_id")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def _spec_pair(**kw):
    return ref_timing.LinkSpec(**kw), timing.LinkSpec(**kw)


def _config_pair(link=None, egress=None, ingress=None, **kw):
    pair = lambda spec: (None, None) if spec is None else _spec_pair(**spec)  # noqa: E731
    (rl, pl), (re, pe), (ri, pi) = pair(link or {}), pair(egress), pair(ingress)
    return (ref_timing.NetworkConfig(link=rl, egress=re, ingress=ri, **kw),
            timing.NetworkConfig(link=pl, egress=pe, ingress=pi, **kw))


def assert_reports_equal(port, ref):
    assert port.makespan_ticks == ref.makespan_ticks
    assert [dataclasses.asdict(s) for s in port.links] == [dataclasses.asdict(s) for s in ref.links]
    for prop in ("drops", "retransmits", "duplicates", "stall_ticks", "seconds"):
        assert getattr(port, prop) == getattr(ref, prop), prop


# -- one link ------------------------------------------------------------------

LINK_SPECS = {
    "ideal": {},
    "latency": {"latency": 5},
    "bandwidth": {"rate_numer": 3, "rate_denom": 7},
    "drop": {"latency": 2, "rate_numer": 1, "buffer_packets": 2, "policy": "drop"},
    "backpressure": {"latency": 2, "rate_numer": 1, "buffer_packets": 2, "policy": "backpressure"},
    "loss": {"latency": 1, "loss_rate": 0.3, "rto": 6},
    "dup": {"latency": 3, "dup_rate": 0.4},
    "budget": {"rate_numer": 1, "buffer_packets": 1, "policy": "drop", "max_attempts": 2},
    "everything": {"latency": 2, "rate_numer": 5, "rate_denom": 2, "buffer_packets": 3,
                   "loss_rate": 0.2, "dup_rate": 0.1},
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", sorted(LINK_SPECS))
def test_simulate_link_matches_reference(kind, seed):
    rng = np.random.default_rng(seed)
    n = 400
    sizes = rng.integers(0, 40, n)
    ready = np.sort(rng.integers(0, 3000, n))
    if seed:
        ready = rng.permutation(ready)  # out-of-order offers too
    rspec, pspec = _spec_pair(**LINK_SPECS[kind])
    ref = ref_timing.simulate_link(sizes, ready, rspec, rng=np.random.default_rng(seed + 9), name="l")
    port = timing.simulate_link(sizes, ready, pspec, rng=np.random.default_rng(seed + 9), name="l")
    np.testing.assert_array_equal(port.order, ref.order)
    np.testing.assert_array_equal(port.ticks, ref.ticks)
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    np.testing.assert_array_equal(timing.resequence(n, port), ref_timing.resequence(n, ref))
    empty = timing.simulate_link(sizes[:0], ready[:0], pspec)
    assert empty.order.size == 0 and empty.stats.packets == 0


def test_link_spec_helpers_and_validation_match_reference():
    for kw in LINK_SPECS.values():
        rspec, pspec = _spec_pair(**kw)
        assert pspec.is_ideal == rspec.is_ideal
        assert pspec.effective_rto == rspec.effective_rto
        assert [pspec.backoff(a) for a in range(6)] == [rspec.backoff(a) for a in range(6)]
        sizes = np.array([0, 1, 7, 64])
        np.testing.assert_array_equal(pspec.transmission_ticks(sizes), rspec.transmission_ticks(sizes))
    for bad in ({"policy": "shout"}, {"latency": -1}, {"rate_numer": 0}, {"rate_denom": 0},
                {"buffer_packets": 0}, {"loss_rate": 1.5}, {"dup_rate": -0.1}, {"rto": 0},
                {"max_attempts": 0}):
        with pytest.raises(ValueError):
            timing.LinkSpec(**bad)
    for bad in ({"switch_latency": -1}, {"tick_ns": 0}):
        with pytest.raises(ValueError):
            timing.NetworkConfig(**bad)
    rcfg, pcfg = _config_pair(link={"latency": 1}, egress={"loss_rate": 0.1})
    for kind in ("ingress", "fabric", "egress"):
        assert dataclasses.asdict(pcfg.link_for(kind)) == dataclasses.asdict(rcfg.link_for(kind))
    assert pcfg.is_ideal == rcfg.is_ideal is False
    assert timing.NetworkConfig().is_ideal
    rep = timing.NetworkReport([timing.LinkStats("a", drops_wire=2)], 10, pcfg)
    merged = timing.merge_reports([rep, timing.NetworkReport([timing.LinkStats("b")], 5, pcfg)])
    assert merged.makespan_ticks == 15 and [s.name for s in merged.links] == ["a", "b"]
    assert merged.drops == 2 and merged.seconds == 15 * pcfg.tick_ns * 1e-9
    with pytest.raises(ValueError):
        timing.merge_reports([])


# -- the fabric overlay --------------------------------------------------------


@pytest.mark.parametrize("net", ["ideal", "drop", "backpressure", "lossy"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_run_graph_network_matches_reference(topo, net):
    cfg = {
        "ideal": {},
        "drop": {"link": {"latency": 2, "rate_numer": 2, "buffer_packets": 2}, "switch_latency": 1},
        "backpressure": {"link": {"latency": 2, "rate_numer": 2, "buffer_packets": 2,
                                  "policy": "backpressure"}},
        "lossy": {"link": {"latency": 1, "loss_rate": 0.1},
                  "egress": {"latency": 3, "loss_rate": 0.1, "dup_rate": 0.2}, "seed": 4},
    }[net]
    rcfg, pcfg = _config_pair(**cfg)
    v = np.random.default_rng(3).integers(0, 32768, 3000)
    rb = ref_flow.interleave_batch(ref_flow.split_flows(v, 4, 32), "bursty", seed=1)
    ranges = ref_part.quantile_ranges(v, SEGS, 32767)
    kw = dict(num_segments=SEGS, segment_length=LENGTH, max_value=32767, payload_size=32, **TOPOS[topo])
    rm, pm, rt, pt = RefMetrics(), MetricsRegistry(), RefTracer(), Tracer()
    rout, rstats, rrep = ref_topo.make_topology(topo, ranges=ranges, **kw).run_batch(
        rb, network=rcfg, metrics=rm, tracer=rt)
    pout, pstats, prep = topology.make_topology(topo, ranges=T(ranges), **kw).run_batch(
        wire.from_reference(rb, device="cpu"), network=pcfg, metrics=pm, tracer=pt)
    got = pout.to_numpy()
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(rout, c), err_msg=c)
    assert_reports_equal(prep, rrep)
    assert pm.snapshot() == rm.snapshot()
    assert [(s.name, sorted(s.args)) for s in pt.instants] == [(s.name, sorted(s.args)) for s in rt.instants]
    assert [s.name for s in pstats] == [s.name for s in rstats]
    if net == "ideal":  # the regression anchor: the wire drains at line rate
        assert prep.makespan_ticks == len(v) - 1 and prep.drops == 0


@pytest.mark.parametrize("net", ["drop", "lossy"])
def test_device_engine_network_matches_reference(net, monkeypatch):
    """The observed device epoch replays its taps through the same overlay:
    equal to the reference's device engine (under the R1 shim)."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
    cfg = {"drop": {"link": {"latency": 2, "rate_numer": 2, "buffer_packets": 2}},
           "lossy": {"egress": {"latency": 3, "loss_rate": 0.1, "dup_rate": 0.2}, "seed": 4}}[net]
    rcfg, pcfg = _config_pair(**cfg)
    vals = TRACES["network"](4000, seed=2)
    kw = dict(topology="tree", branching=2, height=2, num_segments=SEGS, segment_length=LENGTH,
              num_flows=4, payload_size=32, max_value=trace_max_value("network"), engine="device",
              range_mode="oracle", num_servers=2)
    ref = ref_pipeline.run_pipeline(vals, network=rcfg, **kw)
    port = pipeline.run_pipeline(vals, network=pcfg, device="cpu", **kw)
    np.testing.assert_array_equal(N(port.output), ref.output)
    assert port.passes == ref.passes
    assert_reports_equal(port.network, ref.network)
    assert (port.dup_packets_dropped, port.spilled_packets) == (ref.dup_packets_dropped, ref.spilled_packets)
    got = port.delivered.to_numpy()
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(ref.delivered, c), err_msg=c)


# -- run_pipeline under a network ------------------------------------------------


def _pipe(vals, maxv, topo, **over):
    kw = dict(topology=topo, num_segments=SEGS, segment_length=LENGTH, max_value=maxv, num_flows=4,
              payload_size=32, verify=True, **TOPOS[topo])
    kw.update(over)
    return kw


@pytest.mark.parametrize("loss", [0.0, 0.2])
@pytest.mark.parametrize("buffer_packets", [1, None])
@pytest.mark.parametrize("policy", ["drop", "backpressure"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_lossy_pipeline_matches_reference_and_lossless(topo, policy, buffer_packets, loss):
    vals = TRACES["network"](1200, seed=13)
    maxv = trace_max_value("network")
    link = dict(latency=2, rate_numer=4, rate_denom=1, buffer_packets=buffer_packets, policy=policy,
                loss_rate=loss, dup_rate=loss / 4)
    rcfg, pcfg = _config_pair(link=link, switch_latency=1, seed=13)
    kw = _pipe(vals, maxv, topo, num_servers=2, range_mode="oracle")
    ref = ref_pipeline.run_pipeline(vals, network=rcfg, **kw)
    port = pipeline.run_pipeline(vals, network=pcfg, device="cpu", **kw)
    lossless = pipeline.run_pipeline(vals, device="cpu", **kw)
    np.testing.assert_array_equal(N(port.output), ref.output)
    np.testing.assert_array_equal(N(port.output), N(lossless.output))
    assert port.passes == ref.passes == lossless.passes
    assert_reports_equal(port.network, ref.network)
    assert (port.dup_packets_dropped, port.spilled_packets, port.spilled_keys) == (
        ref.dup_packets_dropped, ref.spilled_packets, ref.spilled_keys)
    assert port.network.makespan_ticks >= vals.size - 1
    assert port.network.drops == port.network.retransmits  # every drop is re-sent
    if policy == "backpressure":  # a full buffer stalls, it never drops
        assert sum(s.drops_overflow for s in port.network.links) == 0


def test_spill_recovery_with_tight_reorder_capacity_matches_reference():
    vals = TRACES["network"](5000, seed=7)
    rcfg, pcfg = _config_pair(link=dict(latency=2, loss_rate=0.15, dup_rate=0.05, rto=400), seed=7)
    kw = dict(num_segments=SEGS, segment_length=LENGTH, num_flows=4, payload_size=32,
              max_value=trace_max_value("network"), reorder_capacity=2, verify=True, seed=7)
    rm, pm = RefMetrics(), MetricsRegistry()
    ref = ref_pipeline.run_pipeline(vals, network=rcfg, metrics=rm, **kw)
    port = pipeline.run_pipeline(vals, network=pcfg, metrics=pm, device="cpu", **kw)
    np.testing.assert_array_equal(N(port.output), ref.output)
    assert (port.dup_packets_dropped, port.spilled_packets, port.spilled_keys) == (
        ref.dup_packets_dropped, ref.spilled_packets, ref.spilled_keys)
    assert port.spilled_packets > 0 and port.dup_packets_dropped > 0
    assert pm.snapshot() == rm.snapshot()
    assert "reorder_depth" in port.telemetry["seriess"]  # the reference names kinds + "s"


def test_recovery_off_raises_on_lossy_egress():
    vals = TRACES["network"](5000, seed=7)
    _, pcfg = _config_pair(link=dict(latency=2, loss_rate=0.2, dup_rate=0.3, rto=400), seed=7)
    with pytest.raises(ValueError, match="duplicate"):
        pipeline.run_pipeline(vals, num_segments=SEGS, segment_length=LENGTH, num_flows=4,
                              payload_size=32, max_value=trace_max_value("network"), network=pcfg,
                              recovery=False, seed=7, device="cpu")


def test_sampled_epochs_merge_their_network_reports():
    vals = SCENARIOS["drifting"](9000, seed=1)
    rcfg, pcfg = _config_pair(link=dict(latency=1, rate_numer=3, buffer_packets=3), seed=2)
    kw = _pipe(vals, scenario_max_value("drifting"), "leaf_spine", range_mode="sampled")
    from repro.net.control import AdaptiveControlPlane as RefPlane
    from repro_torch.net.control import AdaptiveControlPlane

    ref = ref_pipeline.run_pipeline(vals, network=rcfg, adaptive=RefPlane(SEGS, 65535, warmup=512,
                                                                          check_every=512), **kw)
    port = pipeline.run_pipeline(vals, network=pcfg, adaptive=AdaptiveControlPlane(
        SEGS, 65535, warmup=512, check_every=512), device="cpu", **kw)
    assert port.num_epochs == ref.num_epochs > 1
    assert_reports_equal(port.network, ref.network)
    assert all(s.name.startswith("e") for s in port.network.links)


@settings(max_examples=15, deadline=None)
@given(
    scenario=st.sampled_from(sorted(SCENARIOS)),
    topo=st.sampled_from(sorted(TOPOS)),
    loss=st.sampled_from((0.0, 0.02, 0.1, 0.2)),
    dup=st.sampled_from((0.0, 0.05)),
    buffer_packets=st.sampled_from((1, 2, 8, None)),
    policy=st.sampled_from(("drop", "backpressure")),
    num_servers=st.sampled_from((1, 2, 4)),
    n=st.integers(min_value=1, max_value=300),
    seed=st.integers(min_value=0, max_value=2**16),
)
def test_lossy_delivery_byte_identical_to_lossless(scenario, topo, loss, dup, buffer_packets, policy,
                                                   num_servers, n, seed):
    """Any loss up to 20%, any buffer, either policy, any pool size: the
    port's sorted output and passes equal the lossless run's, and its
    network report equals the reference's for the same seed."""
    vals = SCENARIOS[scenario](n, seed=seed)
    kw = _pipe(vals, scenario_max_value(scenario), topo, num_servers=num_servers)
    link = dict(latency=2, rate_numer=4, rate_denom=1, buffer_packets=buffer_packets, policy=policy,
                loss_rate=loss, dup_rate=dup)
    rcfg, pcfg = _config_pair(link=link, switch_latency=1, seed=seed % 97)
    lossless = pipeline.run_pipeline(vals, device="cpu", **kw)
    port = pipeline.run_pipeline(vals, network=pcfg, device="cpu", **kw)
    ref = ref_pipeline.run_pipeline(vals, network=rcfg, **kw)
    np.testing.assert_array_equal(N(port.output), np.sort(vals))
    np.testing.assert_array_equal(N(port.output), N(lossless.output))
    assert port.passes == lossless.passes
    assert_reports_equal(port.network, ref.network)
