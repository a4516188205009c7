"""Port ``repro_torch.net.device_epoch`` (``engine="device"``, the whole
epoch as one program) against the reference's device engine and the port's
fused engine, on the CPU.

Seeded numpy inputs -- the reference's ``repro.data.scenarios`` traces among
them -- go through the port's ``engine="device"``, the port's
``engine="fused"`` and the reference's ``engine="device"``; the three must be
byte-identical in output, passes, the delivered wire, every ``HopStats`` and
the payload rows.  The reference's device engine needs its x64 scope, which
jax 0.9 moved (R1 in ROADMAP.md): each test that runs it takes the
test-scoped shim.  Then the cases of the reference's ``test_device_epoch.py``
that apply to the port, the grouped handoff into the servers against the
reference's, and the host-read guard over the program.
"""

import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare interpreter: property tests skip, the rest run
    from _hypstub import given, settings, st

from repro.core.partition import quantile_ranges as ref_quantile_ranges
from repro.data.scenarios import SCENARIOS, scenario_max_value
from repro.net import egress as ref_egress
from repro.net import pipeline as ref_pipeline
from repro.net import server as ref_server
from repro.net.topology import run_graph as ref_run_graph
from repro.net.topology import tree_graph as ref_tree_graph
from repro.net import flow as ref_flow
from repro.net import engine as ref_engine
from repro_torch.core.partition import set_ranges
from repro_torch.net import device_epoch as de
from repro_torch.net import egress, engine, flow, pipeline, server, topology, wire
from repro_torch.net.engine import HopSpec

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_host_reads import HostRead, NoHostReads  # noqa: E402

N = 3000
SEGS, LENGTH = 8, 16
TOPOS = {"single": {}, "leaf_spine": {"num_leaves": 4}, "tree": {"branching": 2, "height": 3}}
COLS = ("values", "flow_id", "seq", "segment_id", "row_index")
SCALARS = ("name", "arrivals", "load_imbalance", "emitted_runs", "mean_run_len", "recirculations")


@pytest.fixture
def x64(monkeypatch):
    """The reference's device engine enters ``jax.experimental.enable_x64``,
    which jax 0.9 no longer has: the test-scoped shim of ROADMAP.md R1."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)


def _common(scenario, **over):
    kw = dict(num_segments=SEGS, segment_length=LENGTH, max_value=scenario_max_value(scenario),
              num_flows=4, payload_size=32)
    kw.update(over)
    return kw


def _payload(vals):
    p = np.empty((vals.size, 2), dtype=np.int64)
    p[:, 0] = vals * 7 + 3
    p[:, 1] = np.arange(vals.size)
    return p


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def assert_runs_equal(port: dict, ref, what: str) -> None:
    """A port ``PipelineResult.to_numpy()`` against a reference result."""
    np.testing.assert_array_equal(port["output"], ref.output, err_msg=what)
    assert port["passes"] == list(ref.passes), what
    assert port["server_keys"] == list(ref.server_keys), what
    assert port["max_reorder_depth"] == ref.max_reorder_depth, what
    for c in COLS:
        want = getattr(ref.delivered, c)
        if want is None:
            assert port["delivered"][c] is None, (what, c)
        else:
            np.testing.assert_array_equal(port["delivered"][c], want, err_msg=f"{what}:{c}")
    assert len(port["hop_stats"]) == len(ref.hop_stats), what
    for a, b in zip(port["hop_stats"], ref.hop_stats):
        for f in SCALARS:
            assert a[f] == getattr(b, f), (what, f)
        np.testing.assert_array_equal(a["segment_loads"], b.segment_loads, err_msg=what)
    for key in ("sorted_payload", "payload_row_order"):
        want = getattr(ref, key)
        if want is None:
            assert port[key] is None, (what, key)
        else:
            np.testing.assert_array_equal(port[key], want, err_msg=f"{what}:{key}")


# -- three-way identity: port device, port fused, reference device ----------------


@pytest.mark.parametrize("with_payload", [False, True])
@pytest.mark.parametrize("num_servers", [1, 4])
@pytest.mark.parametrize("topo", list(TOPOS))
@pytest.mark.parametrize("scenario", ["adversarial_skew", "drifting"])
def test_device_engine_matches_fused_and_reference(x64, scenario, topo, num_servers, with_payload):
    vals = SCENARIOS[scenario](N, seed=7)
    pl = _payload(vals) if with_payload else None
    kw = _common(scenario, num_servers=num_servers, merge_backend="arena" if num_servers > 1 else "numpy",
                 topology=topo, payload=pl, verify=True, **TOPOS[topo])
    ref = ref_pipeline.run_pipeline(vals, engine="device", **kw)
    de.reset_transfer_counts()
    dev = pipeline.run_pipeline(vals, engine="device", device="cpu", **kw).to_numpy()
    assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 1}
    fused = pipeline.run_pipeline(vals, engine="fused", device="cpu", **kw).to_numpy()
    assert_runs_equal(dev, ref, "port device vs reference device")
    assert_runs_equal(fused, ref, "port fused vs reference device")
    for st_ in dev["hop_stats"]:  # as the reference's device engine: no per-run arrays
        assert st_["emitted_run_lengths"] is None and st_["ship_emission"] is None


@pytest.mark.parametrize("range_mode", ["oracle", "static"])
@pytest.mark.parametrize("length", [24, 64])
def test_device_engine_range_modes_and_widths(x64, range_mode, length):
    """Oracle and static tables, a segment length that is not a power of two
    (K1's width padded to 32) and one that is, record mode: the reference's
    device engine against the port's."""
    vals = SCENARIOS["drifting"](N, seed=3)
    kw = _common("drifting", range_mode=range_mode, segment_length=length, payload=_payload(vals),
                 topology="leaf_spine", num_leaves=4, verify=True)
    ref = ref_pipeline.run_pipeline(vals, engine="device", **kw)
    port = pipeline.run_pipeline(vals, engine="device", device="cpu", **kw).to_numpy()
    assert_runs_equal(port, ref, f"{range_mode} L={length}")


def test_wide_key_records_take_the_stable_row_argsort(x64):
    """Keys too wide for ``(value << cbits) | col`` record cells in 63 bits:
    the record branch sorts rows with a stable argsort instead; the
    reference's device engine against the port's on one fabric."""
    rng = np.random.default_rng(5)
    mv = (1 << 61) - 1
    vals = rng.integers(0, mv + 1, 1500)
    b = ref_flow.interleave_batch(ref_flow.split_flows(vals, 2, 32), "round_robin")
    r = ref_flow.interleave_batch(ref_flow.split_flows(np.arange(vals.size), 2, 32), "round_robin")
    b = b.with_row_index(r.values)
    rspec = ref_engine.HopSpec(4, 16, mv, ref_quantile_ranges(vals, 4, mv), payload_size=32)
    assert de._vbits(rspec.ranges, 1500) + 4 > 63
    rout, rstats = ref_run_graph(ref_tree_graph(2, 2), b, rspec, engine="device")
    pspec = HopSpec(4, 16, mv, torch.from_numpy(rspec.ranges), payload_size=32)
    pout, pstats = topology.run_graph(topology.tree_graph(2, 2), wire.from_reference(b, device="cpu"),
                                      pspec, "device")
    got = pout.to_numpy()
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(rout, c), err_msg=c)
    for a, b_ in zip(pstats, rstats):
        for f in SCALARS:
            assert getattr(a, f) == getattr(b_, f), f


# -- the reference test_device_epoch.py cases that apply ---------------------------


def _batch(vals, num_flows=4, payload=32, seed=0, rows=False):
    b = flow.interleave_batch(flow.split_flows(torch.from_numpy(vals), num_flows, payload),
                              "round_robin", seed=seed)
    if rows:
        r = flow.interleave_batch(flow.split_flows(torch.arange(vals.size), num_flows, payload),
                                  "round_robin", seed=seed)
        b = b.with_row_index(r.values)
    return b


@pytest.mark.parametrize("rows", [False, True])
def test_one_read_back_per_epoch_and_the_delivery(rows):
    vals = SCENARIOS["adversarial_skew"](N, seed=1)
    graph = topology.tree_graph(2, 3)
    batch = _batch(vals, rows=rows)
    spec = HopSpec(SEGS, LENGTH, max_value=scenario_max_value("adversarial_skew"))
    for _ in range(2):  # a program build, then a cache hit
        de.reset_transfer_counts()
        out, stats = topology.run_graph(graph, batch, spec, "device")
        assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 1}
    assert isinstance(out, de.DeviceDelivery)
    # any row gather degrades to a plain WireBatch
    assert type(out.take(torch.arange(len(out)))) is wire.WireBatch
    ref, rstats = topology.run_graph(graph, batch, spec, "fused")
    for c in COLS:
        a, b = getattr(out, c), getattr(ref, c)
        assert (a is None and b is None) or torch.equal(a, b), c
    assert stats == rstats
    # the grouped view: each segment's emission stream, the run flags
    assert torch.equal(out.seg_counts, rstats[-1].segment_loads)
    assert torch.equal(torch.sort(out.grouped_values).values, torch.sort(out.values).values)
    assert int(out.run_flags.sum()) == rstats[-1].emitted_runs


def test_reads_the_host_lacks_are_counted():
    """A batch that did not come from ``interleave_batch`` carries no flow
    sizes: with several ingress groups their sizes are read from the
    device, and the read is counted."""
    vals = SCENARIOS["drifting"](N, seed=2)
    b = _batch(vals)
    bare = wire.WireBatch(b.values, b.flow_id, b.seq, b.segment_id)
    assert b.flow_sizes is not None and bare.flow_sizes is None
    spec = HopSpec(SEGS, LENGTH, max_value=scenario_max_value("drifting"))
    de.reset_transfer_counts()
    out, _ = topology.run_graph(topology.leaf_spine_graph(4), bare, spec, "device")
    assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 2}
    de.reset_transfer_counts()
    out1, _ = topology.run_graph(topology.single_graph(), bare, spec, "device")
    assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 1}
    ref, _ = topology.run_graph(topology.leaf_spine_graph(4), b, spec, "fused")
    assert torch.equal(out.values, ref.values)


@given(st.integers(0, 2**32 - 1), st.integers(1, 4), st.sampled_from([8, 16, 24, 32]))
@settings(max_examples=25, deadline=None)
def test_device_hop_matches_fused_hop(seed, num_flows, length):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(64, 1200))
    mv = int(rng.integers(100, 1 << 24))
    vals = rng.integers(0, mv + 1, n)
    batch = _batch(vals, num_flows=num_flows, seed=seed % 97, rows=bool(seed % 2))
    spec = HopSpec(SEGS, length, max_value=mv)
    of, sf = engine.run_hop(batch, spec, "sw", engine="fused")
    od, sd = engine.run_hop(batch, spec, "sw", engine="device")
    for c in COLS:
        a, b = getattr(od, c), getattr(of, c)
        assert (a is None and b is None) or torch.equal(a, b), c
    assert sd == sf
    assert torch.equal(sd.segment_loads, sf.segment_loads)


def test_device_hop_empty_batch():
    spec = HopSpec(SEGS, LENGTH, max_value=1000)
    empty = flow.interleave_batch(flow.split_flows(torch.zeros(0, dtype=torch.int64), 2, 32), "round_robin")
    out, stats = engine.run_hop(empty, spec, "sw", engine="device")
    assert len(out) == 0 and stats.arrivals == 0 and stats.ship_emission.numel() == 0
    out, stats = topology.run_graph(topology.tree_graph(2, 2), empty, spec, "device")
    assert len(out) == 0 and [s.arrivals for s in stats] == [0, 0, 0]


def test_device_rejects_int_telemetry_and_observed_runs():
    """INT telemetry still raises the reference's ``ValueError``; the
    observed runs it once refused (``metrics=``, ``network=``, a recording
    tracer) now run, equal to the fused engine's observed run."""
    from repro_torch.net import timing
    from repro_torch.obs import MetricsRegistry, Tracer

    vals = SCENARIOS["adversarial_skew"](512, seed=0)
    batch = _batch(vals)
    spec = HopSpec(SEGS, LENGTH, max_value=scenario_max_value("adversarial_skew"))
    g = topology.single_graph()
    with pytest.raises(ValueError, match="telemetry"):
        topology.run_graph(g, batch, spec, "device", int_telemetry=True)
    with pytest.raises(ValueError, match="telemetry"):
        engine.run_hop(batch, spec, "sw", engine="device", int_telemetry=True)
    net = timing.NetworkConfig(link=timing.LinkSpec(latency=1, rate_numer=3, rate_denom=2, buffer_packets=2))
    for kw in ({"metrics": MetricsRegistry}, {"network": net}, {"tracer": Tracer}):
        key, val = next(iter(kw.items()))
        runs = []
        for eng in ("device", "fused"):
            obs = val() if callable(val) else val
            runs.append((topology.run_graph(g, batch, spec, eng, **{key: obs}), obs))
        (dres, dobs), (fres, fobs) = runs
        for col in ("values", "seq", "segment_id"):
            assert torch.equal(getattr(dres[0], col), getattr(fres[0], col)), (key, col)
        for a, b in zip(dres[1], fres[1]):
            assert torch.equal(a.ship_emission, b.ship_emission)
        if key == "metrics":
            assert dobs.snapshot() == fobs.snapshot()
        elif key == "network":
            assert [vars(s) for s in dres[2].links] == [vars(s) for s in fres[2].links]
        else:
            assert [(s.name, sorted(s.args)) for s in dobs.find(cat="hop")] == [
                (s.name, sorted(s.args)) for s in fobs.find(cat="hop")]


@pytest.mark.parametrize("bad", [[5, 500], [-1, 5]])
def test_device_rejects_out_of_domain_values(bad):
    spec = HopSpec(SEGS, LENGTH, max_value=100)
    batch = _batch(np.asarray(bad), num_flows=1)
    with pytest.raises(ValueError, match="domain"):
        engine.run_hop(batch, spec, "sw", engine="device")
    with pytest.raises(ValueError, match="domain"):
        topology.run_graph(topology.tree_graph(2, 2), _batch(np.asarray(bad * 4), num_flows=2), spec, "device")


def test_self_check():
    de.device_self_check(n=2048, seed=4, device="cpu")


@pytest.mark.parametrize("engine_name", ["fused", "device"])
@pytest.mark.parametrize("merge_backend", ["numpy", "arena"])
def test_payload_gathered_once_at_egress(engine_name, merge_backend):
    vals = SCENARIOS["adversarial_skew"](N, seed=11)
    payload = (vals * 7 + 3).reshape(-1, 1).repeat(3, axis=1)
    payload[:, 1] = np.arange(vals.size)
    res = pipeline.run_pipeline(vals, topology="tree", branching=2, height=3, engine=engine_name,
                                payload=payload, merge_backend=merge_backend, num_servers=4,
                                verify=True, device="cpu", **_common("adversarial_skew"))
    order = np.argsort(vals, kind="stable")
    np.testing.assert_array_equal(_np(res.payload_row_order), order)
    np.testing.assert_array_equal(_np(res.sorted_payload), payload[order])
    np.testing.assert_array_equal(_np(res.sorted_payload)[:, 0], _np(res.output) * 7 + 3)


def test_jitter_takes_the_packet_path():
    """A jittered delivery is a plain wire batch: the pool demuxes packets,
    and the run still equals the fused engine's."""
    vals = SCENARIOS["drifting"](N, seed=4)
    kw = _common("drifting", topology="leaf_spine", num_leaves=4, jitter_window=6, num_servers=2,
                 verify=True, device="cpu")
    a = pipeline.run_pipeline(vals, engine="device", **kw).to_numpy()
    b = pipeline.run_pipeline(vals, engine="fused", **kw).to_numpy()
    assert a["passes"] == b["passes"] and a["max_reorder_depth"] == b["max_reorder_depth"]
    for c in COLS[:4]:
        np.testing.assert_array_equal(a["delivered"][c], b["delivered"][c])


def test_program_cache_is_bounded_and_keyed_by_ranges():
    de.clear_program_cache()
    vals = SCENARIOS["drifting"](400, seed=1)
    batch = _batch(vals, num_flows=1)
    g = topology.single_graph()
    for i in range(3):
        spec = HopSpec(4, 8, max_value=(1 << 16) - 1 + i)
        topology.run_graph(g, batch, spec, "device")
    topology.run_graph(g, batch, HopSpec(4, 8, max_value=(1 << 16) - 1), "device")
    assert len(de._PROGRAM_CACHE) == 3
    assert de._PROGRAM_CACHE_MAX == 64
    de.clear_program_cache()
    assert not de._PROGRAM_CACHE


# -- the grouped handoff into the servers, against the reference's ----------------


def _ref_delivery():
    """The reference device engine's delivery of a drifting trace through
    the 7-hop tree (needs the x64 shim)."""
    vals = SCENARIOS["drifting"](N, seed=9)
    b = ref_flow.interleave_batch(ref_flow.split_flows(vals, 4, 32), "round_robin")
    spec = ref_engine.HopSpec(SEGS, LENGTH, scenario_max_value("drifting"))
    out, _ = ref_run_graph(ref_tree_graph(2, 3), b, spec, engine="device")
    return out


@pytest.mark.parametrize("backend", ["numpy", "arena"])
@pytest.mark.parametrize("servers", [1, 4])
def test_ingest_grouped_matches_reference(x64, backend, servers):
    d = _ref_delivery()
    ref = ref_egress.ServerPool(SEGS, servers, k=4, merge_backend=backend)
    ref.ingest_grouped(d.grouped_values, d.seg_counts, d.run_flags)
    want, wpasses = ref.finish()
    port = egress.ServerPool(SEGS, servers, k=4, merge_backend=backend, device="cpu")
    port.ingest_grouped(torch.tensor(d.grouped_values), torch.tensor(d.seg_counts), torch.tensor(d.run_flags))
    got, passes = port.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert passes == wpasses
    assert port.server_keys == ref.server_keys
    assert port.max_reorder_depth == ref.max_reorder_depth


def test_ingest_grouped_guards():
    pool = egress.ServerPool(4, 2, num_epochs=2, device="cpu")
    with pytest.raises(ValueError, match="single-epoch"):
        pool.ingest_grouped(torch.arange(4), torch.ones(8, dtype=torch.int64), torch.ones(4, dtype=torch.bool))
    pool = egress.ServerPool(4, 2, device="cpu")
    pool.ingest_grouped(torch.zeros(0, dtype=torch.int64), torch.zeros(4), torch.zeros(0, dtype=torch.bool))
    with pytest.raises(ValueError, match="length"):
        pool.ingest_grouped(torch.arange(4), torch.ones(3, dtype=torch.int64), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="sum"):
        pool.ingest_grouped(torch.arange(4), torch.ones(4, dtype=torch.int64) * 2, torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("backend", ["numpy", "arena"])
@pytest.mark.parametrize("with_starts", [False, True])
def test_ingest_segment_matches_reference(backend, with_starts):
    rng = np.random.default_rng(3)
    streams = [np.sort(rng.integers(0, 50, 40)), rng.integers(0, 50, 70), np.arange(10)[::-1].copy()]
    ref = ref_server.StreamingServer(2, k=3, merge_backend=backend)
    port = server.StreamingServer(2, k=3, merge_backend=backend, device="cpu")
    for i, s in enumerate(streams):
        starts = np.flatnonzero(np.concatenate([[True], s[1:] < s[:-1]])) if with_starts else None
        ref.ingest_segment(i % 2, s, starts)
        port.ingest_segment(i % 2, torch.from_numpy(s), None if starts is None else torch.from_numpy(starts))
    want, wpasses = ref.finish()
    got, passes = port.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert passes == wpasses and port.max_reorder_depth == ref.max_reorder_depth == 1
    assert port.keys_ingested == sum(s.size for s in streams)


def test_ingest_segment_guards():
    srv = server.StreamingServer(2, device="cpu")
    srv.ingest_segment(0, torch.zeros(0, dtype=torch.int64))
    with pytest.raises(ValueError, match="invalid segment"):
        srv.ingest_segment(2, torch.arange(3))
    srv.ingest(packet_of(torch.arange(3), sid=1, seq=1))
    with pytest.raises(ValueError, match="buffered"):
        srv.ingest_segment(1, torch.arange(3))
    arena = server.StreamingServer(1, merge_backend="arena", device="cpu")
    with pytest.raises(ValueError, match="position 0"):
        arena.ingest_segment(0, torch.arange(3), torch.tensor([1]))


def packet_of(payload, sid, seq):
    from repro_torch.net.packet import Packet

    return Packet(payload, 0, seq, sid)


# -- no host reads inside the program ----------------------------------------------


@pytest.mark.parametrize("kind", ["int", "item", "bool", "nonzero", "mask_index", "mask_put", "bincount",
                                  "repeat_interleave", "unique", "masked_select"])
def test_host_read_guard_catches(kind):
    t = torch.arange(10)
    ops = {
        "int": lambda: int(t[3]), "item": lambda: t[2].item(), "bool": lambda: bool(t[1]),
        "nonzero": lambda: t.nonzero(), "mask_index": lambda: t[t > 3],
        "mask_put": lambda: t.clone().__setitem__(t > 3, 0), "bincount": lambda: torch.bincount(t),
        "repeat_interleave": lambda: torch.repeat_interleave(t, t), "unique": lambda: torch.unique(t),
        "masked_select": lambda: t.masked_select(t > 2),
    }
    with pytest.raises(HostRead):
        with NoHostReads():
            ops[kind]()


def test_host_read_guard_lets_static_ops_through():
    t = torch.arange(10)
    with NoHostReads() as g:
        torch.repeat_interleave(t, t, output_size=45)
        t[torch.tensor([1, 2])]
        t.clone()[torch.tensor([1])] = 5
        torch.sort(t)
        torch.zeros(11, dtype=torch.int64).scatter_add_(0, t, t)
    assert g.seen["sort"] == 1 and g.seen["scatter_add_"] == 1


def _program(graph, rows: bool, length: int, mv: int = 999):
    vals = np.random.default_rng(0).integers(0, mv + 1, 3000)
    b = _batch(vals, rows=rows)
    spec = HopSpec(SEGS, length, mv, set_ranges(mv, SEGS, device="cpu"), payload_size=32)
    ns = de._group_sizes(b, graph.num_groups)
    prog = de._epoch_program(graph, spec, spec.ranges.numpy(), ns, rows, torch.device("cpu"))
    cols = [b.values] + ([b.flow_id] if graph.num_groups > 1 else []) + ([b.row_index] if rows else [])
    return prog, cols, b, spec


@pytest.mark.parametrize("length", [16, 24])
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("graph", ["single", "tree"])
def test_epoch_program_reads_nothing_on_the_host(graph, rows, length):
    g = topology.single_graph() if graph == "single" else topology.tree_graph(2, 3)
    prog, cols, _, _ = _program(g, rows, length)
    with NoHostReads() as guard:
        res = prog.fn(*cols)
    assert guard.seen["sort"] >= 1 and "_local_scalar_dense" not in guard.seen
    assert res["stats"].numel() == len(g.nodes) * (SEGS + 1) + g.num_groups + 2


@pytest.mark.parametrize("rows", [False, True])
def test_observed_program_reads_nothing_on_the_host(rows):
    """The program with taps (an observed run's) is a program key of its
    own, reads nothing on the host either, and returns one tap per hop; the
    run around it reads one tensor more than an unobserved run."""
    from repro_torch.obs import MetricsRegistry

    g = topology.tree_graph(2, 3)
    vals = np.random.default_rng(0).integers(0, 1000, 3000)
    b = _batch(vals, rows=rows)
    spec = HopSpec(SEGS, 16, 999, set_ranges(999, SEGS, device="cpu"), payload_size=32)
    ns = de._group_sizes(b, g.num_groups)
    de.clear_program_cache()
    plain = de._epoch_program(g, spec, spec.ranges.numpy(), ns, rows, torch.device("cpu"))
    taps = de._epoch_program(g, spec, spec.ranges.numpy(), ns, rows, torch.device("cpu"), True)
    assert taps is not plain and len(de._PROGRAM_CACHE) == 2
    cols = [b.values, b.flow_id] + ([b.row_index] if rows else [])
    with NoHostReads():
        res = taps.fn(*cols)
    assert "taps" not in plain.fn(*cols)
    assert len(res["taps"]) == len(g.nodes)
    for tap in res["taps"]:
        assert tap["ship"].dtype == torch.int32
        assert tap["ship"].numel() == tap["pstart"].numel() == tap["brk"].numel()
    assert res["taps"][-1]["ship"].numel() == 3000  # the egress hop sees every key
    de.reset_transfer_counts()
    topology.run_graph(g, b, spec, "device", metrics=MetricsRegistry())
    assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 2}
    de.reset_transfer_counts()
    topology.run_graph(g, b, spec, "device")
    assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 1}
    de.clear_program_cache()


@pytest.mark.parametrize("wide", [False, True])
def test_device_hop_and_rr_merge_read_nothing_on_the_host(wide):
    rng = np.random.default_rng(1)
    mv = (1 << 60) if wide else 999
    vals = torch.from_numpy(rng.integers(0, mv, 700))
    rows = torch.arange(700)
    bounds = set_ranges(mv, SEGS, device="cpu")[:, 1].contiguous()
    vbits = 0 if wide else 10
    with NoHostReads():
        a = de._device_hop(vals[:300], rows[:300], bounds, SEGS, 16, 32, vbits, torch.int64)
        b = de._device_hop(vals[300:], rows[300:], bounds, SEGS, 16, 32, vbits, torch.int64)
        merged, mrows = de._rr_merge([a, b], True, vbits > 0)
        de._device_hop(merged, mrows, bounds, SEGS, 16, 32, vbits, torch.int64)
    ref = wire.merge_round_robin_batches([
        wire.WireBatch(a["vals"], torch.zeros(300, dtype=torch.int64), a["seq"], a["sid"], row_index=a["rows"]),
        wire.WireBatch(b["vals"], torch.ones(400, dtype=torch.int64), b["seq"], b["sid"], row_index=b["rows"]),
    ], device="cpu")
    assert torch.equal(merged, ref.values) and torch.equal(mrows, ref.row_index)


def test_unported_engines_still_raise():
    batch = _batch(np.arange(100))
    spec = HopSpec(4, 8, max_value=100)
    for name in ("segment", "faithful"):
        with pytest.raises(NotImplementedError, match="M18"):
            engine.run_hop(batch, spec, "h", name)
        with pytest.raises(NotImplementedError, match="M18"):
            pipeline.run_pipeline(np.arange(100), engine=name, device="cpu")
    with pytest.raises(NotImplementedError):
        topology.run_graph(topology.single_graph(), batch, spec, "device", faults=object())
