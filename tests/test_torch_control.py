"""Port the scenarios (``repro_torch.data.scenarios``) and the adaptive
control plane (``repro_torch.net.control``: ``ReservoirSampler``,
``AdaptiveControlPlane`` and ``run_pipeline(range_mode="sampled")``)
against the reference, on the CPU.

The same numpy seeds feed both packages.  The scenarios must give the same
bytes; the reservoir the same sample and count after the same offers; the
plane the same handoff decisions, proposals and final state over the same
payload stream; and a sampled ``run_pipeline`` the same output, passes,
ranges history, epoch count and delivered wire over every fabric, both
engines, one and four servers, on ``drifting`` and ``adversarial_skew``.
The reference's device engine needs its x64 scope, which jax 0.9 moved (R1
in ROADMAP.md): the device cells take the test-scoped shim.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import partition as ref_part
from repro.data import scenarios as ref_scen
from repro.net import control as ref_control
from repro.net import flow as ref_flow
from repro.net import pipeline as ref_pipeline
from repro_torch.core import partition
from repro_torch.data import scenarios
from repro_torch.net import control, pipeline, wire

COLS = ("values", "flow_id", "seq", "segment_id")
TOPOS = {"single": {}, "leaf_spine": {"num_leaves": 3}, "tree": {"branching": 2, "height": 3}}
SEGS, LENGTH = 8, 16


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


@pytest.fixture
def x64(monkeypatch):
    """The reference's device engine enters ``jax.experimental.enable_x64``,
    which jax 0.9 no longer has: the test-scoped shim of ROADMAP.md R1."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)


# -- scenarios -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(ref_scen.SCENARIOS))
def test_scenarios_give_the_reference_bytes(name, seed):
    for n in (0, 1, 3001):
        got = scenarios.SCENARIOS[name](n, seed=seed)
        want = ref_scen.SCENARIOS[name](n, seed=seed)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert scenarios.scenario_max_value(name) == ref_scen.scenario_max_value(name)
    assert scenarios.SCENARIO_DOMAIN == ref_scen.SCENARIO_DOMAIN


def test_scenario_options_and_validation():
    for args in ((500, 0.3, 2), (500, 1.0, 2), (500, 0.0, 2)):
        np.testing.assert_array_equal(scenarios.sortedness_dial(*args), ref_scen.sortedness_dial(*args))
    np.testing.assert_array_equal(scenarios.adversarial_skew(900, 3, hot_keys=2, hot_mass=0.5),
                                  ref_scen.adversarial_skew(900, 3, hot_keys=2, hot_mass=0.5))
    np.testing.assert_array_equal(scenarios.duplicate_heavy(900, 1, uniques=3),
                                  ref_scen.duplicate_heavy(900, 1, uniques=3))
    np.testing.assert_array_equal(scenarios.drifting(901, 4, phases=3), ref_scen.drifting(901, 4, phases=3))
    np.testing.assert_array_equal(scenarios.near_sorted_outliers(900, 5, outlier_frac=0.2),
                                  ref_scen.near_sorted_outliers(900, 5, outlier_frac=0.2))
    for fn, kw in ((scenarios.sortedness_dial, {"sortedness": 1.5}),
                   (scenarios.adversarial_skew, {"hot_mass": 1.0}),
                   (scenarios.duplicate_heavy, {"uniques": 0}),
                   (scenarios.drifting, {"phases": 0}),
                   (scenarios.near_sorted_outliers, {"outlier_frac": -0.1})):
        with pytest.raises(ValueError):
            fn(10, **kw)
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.scenario_max_value("zipf")
    import repro_torch.data as port_data
    import repro.data as ref_data

    assert sorted(port_data.__all__) == sorted(ref_data.__all__)


# -- the reservoir -------------------------------------------------------------


@pytest.mark.parametrize("capacity,payload", [(64, 1), (256, 64), (1024, 300), (4096, 256)])
def test_reservoir_matches_reference(capacity, payload):
    vals = np.random.default_rng(capacity).integers(0, 1 << 16, 20_000)
    ref = ref_control.ReservoirSampler(capacity, seed=3)
    port = control.ReservoirSampler(capacity, seed=3)
    for i in range(0, vals.size, payload):
        ref.offer(vals[i : i + payload])
        port.offer(vals[i : i + payload])
        if i // payload % 17 == 0:
            assert port.seen == ref.seen
            np.testing.assert_array_equal(port.snapshot(), ref.snapshot())
    port.offer(np.zeros(0, dtype=np.int64))
    ref.offer(np.zeros(0, dtype=np.int64))
    assert port.seen == ref.seen == vals.size
    np.testing.assert_array_equal(port.snapshot(), ref.snapshot())
    with pytest.raises(ValueError):
        control.ReservoirSampler(0)


# -- the adaptive plane --------------------------------------------------------


def _drive(plane, values, payload):
    """observe() payload by payload; install every proposal.  Returns the
    decisions and the installed tables, as host arrays."""
    fired, tables = [], []
    for i in range(0, values.size, payload):
        f = plane.observe(values[i : i + payload])
        fired.append(f)
        if f:
            nxt = plane.propose()
            tables.append(np.asarray(N(nxt) if isinstance(nxt, torch.Tensor) else nxt))
            plane.install(nxt)
    return fired, tables


@pytest.mark.parametrize("scenario,payload", [("drifting", 64), ("adversarial_skew", 100),
                                              ("sorted50", 256)])
def test_adaptive_plane_lifecycle_matches_reference(scenario, payload):
    vals = ref_scen.SCENARIOS[scenario](60_000, seed=2)
    maxv = ref_scen.scenario_max_value(scenario)
    kw = dict(warmup=2048, recent_window=2048, check_every=1024, max_epochs=6, seed=5)
    ref = ref_control.AdaptiveControlPlane(16, maxv, **kw)
    port = control.AdaptiveControlPlane(16, maxv, **kw)
    np.testing.assert_array_equal(N(port.bootstrap_ranges()), ref.bootstrap_ranges())
    rf, rt = _drive(ref, vals, payload)
    pf, pt = _drive(port, vals, payload)
    assert pf == rf and sum(pf) >= 1
    assert len(pt) == len(rt)
    for a, b in zip(pt, rt):
        np.testing.assert_array_equal(a, b)
    assert port.epoch == ref.epoch
    assert port.reservoir.seen == ref.reservoir.seen == vals.size
    np.testing.assert_array_equal(port.reservoir.snapshot(), ref.reservoir.snapshot())
    np.testing.assert_array_equal(port.recent(), ref.recent())
    np.testing.assert_array_equal(N(port.installed), ref.installed)
    for servers in (1, 3, 16):
        np.testing.assert_array_equal(port.pool_affinity(servers), ref.pool_affinity(servers))


def test_adaptive_plane_guards():
    for kw in ({"num_segments": 0, "max_value": 9}, {"num_segments": 2, "max_value": -1},
               {"num_segments": 2, "max_value": 9, "warmup": 0},
               {"num_segments": 2, "max_value": 9, "max_epochs": 0}):
        with pytest.raises(ValueError):
            control.AdaptiveControlPlane(**kw)
    plane = control.AdaptiveControlPlane(4, 99)
    with pytest.raises(RuntimeError):
        plane.observe(np.arange(4))
    plane.bootstrap_ranges()
    with pytest.raises(ValueError):
        plane.install(np.zeros((3, 2), dtype=np.int64))
    fresh = control.AdaptiveControlPlane(4, 99)
    np.testing.assert_array_equal(N(fresh.propose()), ref_control.AdaptiveControlPlane(4, 99).propose())


@pytest.mark.parametrize("scenario", ["drifting", "adversarial_skew", "duplicate_heavy"])
def test_partition_helpers_give_the_reference_splitters(scenario):
    """The plane's two helpers, on numpy-derived inputs: the port's
    ``quantile_ranges`` and ``load_imbalance`` over CPU tensors equal the
    reference's over the same arrays."""
    vals = ref_scen.SCENARIOS[scenario](5000, seed=1)
    maxv = ref_scen.scenario_max_value(scenario)
    rng = np.random.default_rng(0)
    for segs in (2, 8, 16, 64):
        sample = rng.choice(vals, size=700, replace=False)
        got = N(partition.quantile_ranges(T(sample), segs, maxv))
        want = ref_part.quantile_ranges(sample, segs, maxv)
        np.testing.assert_array_equal(got, want)
        for table in (want, ref_part.set_ranges(maxv, segs)):
            assert partition.load_imbalance(T(vals), T(table)) == ref_part.load_imbalance(vals, table)


@pytest.mark.parametrize("payload,flows", [(64, 4), (17, 3)])
def test_split_epochs_matches_reference(payload, flows):
    vals = ref_scen.drifting(30_000, seed=3)
    rb = ref_flow.interleave_batch(ref_flow.split_flows(vals, flows, payload), "weighted_fair", seed=1)
    kw = dict(warmup=1024, recent_window=1024, check_every=512, seed=2)
    ref = ref_control.AdaptiveControlPlane(8, 65535, **kw)
    port = control.AdaptiveControlPlane(8, 65535, **kw)
    repochs = ref.split_epochs(rb)
    pepochs = port.split_epochs(wire.from_reference(rb, device="cpu"))
    assert len(pepochs) == len(repochs) > 1
    for (pr, pb), (rr, rsub) in zip(pepochs, repochs):
        np.testing.assert_array_equal(N(pr), rr)
        got = pb.to_numpy()
        for c in COLS:
            np.testing.assert_array_equal(got[c], getattr(rsub, c), err_msg=c)
    # the plane saw every payload, even after its last handoff
    assert port.reservoir.seen == ref.reservoir.seen == vals.size
    np.testing.assert_array_equal(port.recent(), ref.recent())
    assert port.epoch == ref.epoch


# -- sampled run_pipeline ------------------------------------------------------


def _assert_sampled_equal(port, ref, vals):
    got = port.to_numpy()
    np.testing.assert_array_equal(got["output"], ref.output)
    np.testing.assert_array_equal(got["output"], np.sort(vals))
    assert got["passes"] == ref.passes
    assert got["num_epochs"] == ref.num_epochs and got["range_mode"] == ref.range_mode == "sampled"
    assert len(got["ranges_history"]) == len(ref.ranges_history)
    for a, b in zip(got["ranges_history"], ref.ranges_history):
        np.testing.assert_array_equal(a, b)
    for c in COLS:
        np.testing.assert_array_equal(got["delivered"][c], getattr(ref.delivered, c), err_msg=c)
    assert len(got["segment_multisets"]) == len(ref.segment_multisets)
    for a, b in zip(got["segment_multisets"], ref.segment_multisets):
        np.testing.assert_array_equal(a, b)
    assert got["server_keys"] == ref.server_keys
    assert got["server_imbalance"] == ref.server_imbalance
    assert got["max_reorder_depth"] == ref.max_reorder_depth
    assert [st["name"] for st in got["hop_stats"]] == [st.name for st in ref.hop_stats]
    for a, b in zip(got["hop_stats"], ref.hop_stats):
        for f in ("arrivals", "load_imbalance", "emitted_runs", "mean_run_len", "recirculations"):
            assert a[f] == getattr(b, f), f
        np.testing.assert_array_equal(a["segment_loads"], b.segment_loads)


@pytest.mark.parametrize("scenario", ["drifting", "adversarial_skew"])
@pytest.mark.parametrize("servers", [1, 4])
@pytest.mark.parametrize("engine", ["fused", "device"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
def test_sampled_pipeline_matches_reference(topo, engine, servers, scenario, request):
    if engine == "device":
        request.getfixturevalue("x64")
    vals = ref_scen.SCENARIOS[scenario](12_000, seed=servers)
    maxv = ref_scen.scenario_max_value(scenario)
    plane_kw = dict(warmup=1024, recent_window=1024, check_every=512, seed=4)
    kw = dict(topology=topo, num_segments=SEGS, segment_length=LENGTH, max_value=maxv, num_flows=4,
              payload_size=32, range_mode="sampled", num_servers=servers, engine=engine,
              merge_backend="arena" if servers == 4 else "numpy", seed=1, **TOPOS[topo])
    ref = ref_pipeline.run_pipeline(vals, adaptive=ref_control.AdaptiveControlPlane(SEGS, maxv, **plane_kw),
                                    **kw)
    port = pipeline.run_pipeline(vals, adaptive=control.AdaptiveControlPlane(SEGS, maxv, **plane_kw),
                                 device="cpu", **kw)
    _assert_sampled_equal(port, ref, vals)
    if scenario == "drifting":
        assert port.num_epochs > 1


def test_sampled_pipeline_default_plane_matches_reference():
    """The plane ``run_pipeline`` builds itself (seeded by ``seed``), at a
    size past its 4096-key warmup and drift windows."""
    vals = ref_scen.drifting(40_000, seed=0)
    kw = dict(topology="tree", branching=2, height=3, num_segments=16, segment_length=64,
              payload_size=256, num_flows=8, range_mode="sampled", num_servers=4,
              merge_backend="arena", max_value=65535, seed=7)
    ref = ref_pipeline.run_pipeline(vals, **kw)
    port = pipeline.run_pipeline(vals, device="cpu", **kw)
    _assert_sampled_equal(port, ref, vals)
    assert port.num_epochs > 1


@pytest.mark.parametrize("mode", ["static", "oracle", "sampled"])
def test_range_modes_on_degenerate_streams_match_reference(mode):
    streams = [np.full(3000, 5, dtype=np.int64), np.arange(2000, dtype=np.int64) % 3]
    if mode != "oracle":  # the oracle's quantiles of no keys raise in both packages
        streams.append(np.zeros(0, dtype=np.int64))
    for vals in streams:
        kw = dict(num_segments=4, segment_length=8, payload_size=16, max_value=1023, range_mode=mode)
        if mode == "sampled":
            kw["adaptive"] = ref_control.AdaptiveControlPlane(4, 1023, warmup=256, check_every=256)
        ref = ref_pipeline.run_pipeline(vals, **kw)
        if mode == "sampled":
            kw["adaptive"] = control.AdaptiveControlPlane(4, 1023, warmup=256, check_every=256)
        port = pipeline.run_pipeline(vals, device="cpu", **kw)
        np.testing.assert_array_equal(N(port.output), ref.output)
        assert port.passes == ref.passes and port.num_epochs == ref.num_epochs
