"""Port ``repro_torch.net`` wire, flows, the fused hop and the fabrics
against the reference ``repro.net``, column by column.

The same numpy-seeded wire is handed to a reference hop and to a port hop
(:func:`repro_torch.net.wire.from_reference`); the outputs come back with
``to_numpy`` and must be byte-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core import partition as ref_part
from repro.net import control as ref_control
from repro.net import engine as ref_engine
from repro.net import flow as ref_flow
from repro.net import packet as ref_packet
from repro.net import topology as ref_topo
from repro.net import wire as ref_wire
from repro_torch.net import control, engine, flow, packet, topology, wire

COLS = ("values", "flow_id", "seq", "segment_id")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def assert_batch_equal(port_batch, ref_batch):
    got = port_batch.to_numpy()
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(ref_batch, c), err_msg=c)
    assert got["epoch"] == ref_batch.epoch
    if ref_batch.row_index is None:
        assert got["row_index"] is None
    else:
        np.testing.assert_array_equal(got["row_index"], ref_batch.row_index)


def assert_stats_equal(port_stats, ref_stats):
    got = port_stats.to_numpy()
    for f in dataclasses.fields(ref_stats):
        want = getattr(ref_stats, f.name)
        if isinstance(want, np.ndarray) or want is None:
            if want is None:
                assert got[f.name] is None, f.name
            else:
                np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)
        else:
            assert got[f.name] == want, f.name


def _arrivals(n, num_flows, payload, mode, seed, maxv=32767, rows=False):
    v = np.random.default_rng(seed).integers(0, maxv + 1, size=n).astype(np.int64)
    b = ref_flow.interleave_batch(ref_flow.split_flows(v, num_flows, payload), mode, seed=seed)
    if rows:
        r = ref_flow.interleave_batch(
            ref_flow.split_flows(np.arange(n, dtype=np.int64), num_flows, payload), mode, seed=seed
        )
        b = b.with_row_index(r.values)
    return v, b


# -- wire ----------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [[], [0], [3], [2, 0, 5, 1]])
def test_ragged_arange_and_gather(sizes):
    s = np.asarray(sizes, dtype=np.int64)
    st = np.arange(s.size, dtype=np.int64) * 10
    np.testing.assert_array_equal(N(wire.ragged_arange(T(s))), ref_wire.ragged_arange(s))
    np.testing.assert_array_equal(N(wire.ragged_gather(T(st), T(s))), ref_wire.ragged_gather(st, s))


@pytest.mark.parametrize("n,p", [(0, 4), (1, 4), (10, 4), (64, 64), (65, 64)])
def test_packetize_batch(n, p):
    v = np.arange(n, dtype=np.int64)[::-1].copy()
    assert_batch_equal(
        wire.packetize_batch(T(v), p, flow_id=3, start_seq=2),
        ref_wire.packetize_batch(v, p, flow_id=3, start_seq=2),
    )
    with pytest.raises(ValueError):
        wire.packetize_batch(T(v), 0)


def test_wire_batch_views_match_reference():
    _, rb = _arrivals(1000, 5, 16, "bursty", seed=3, rows=True)
    pb = wire.from_reference(rb, device="cpu")
    assert_batch_equal(pb, rb)
    assert len(pb) == len(rb) and pb.num_packets == rb.num_packets
    np.testing.assert_array_equal(N(pb.packet_starts()), rb.packet_starts())
    np.testing.assert_array_equal(N(pb.packet_ordinal()), rb.packet_ordinal())
    mask = (rb.values % 3) == 0
    assert_batch_equal(pb.take(T(mask)), rb.take(mask))
    idx = np.arange(len(rb))[::-7].copy()
    assert_batch_equal(pb.take(T(idx)), rb.take(idx))
    assert_batch_equal(pb.slice_keys(13, 500), rb.slice_keys(13, 500))
    assert_batch_equal(pb.with_epoch(2, 16), rb.with_epoch(2, 16))
    assert_batch_equal(pb.with_row_index(None), rb.with_row_index(None))


def test_wire_batch_validates_columns():
    z = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        wire.WireBatch(z, z[:2], z, z)
    with pytest.raises(ValueError):
        wire.WireBatch(z, z, z, z, row_index=z[:1])


def test_packets_round_trip():
    _, rb = _arrivals(300, 3, 8, "round_robin", seed=1)
    pb = wire.from_reference(rb, device="cpu")
    ref_pk = rb.to_packets()
    port_pk = pb.to_packets()
    assert len(port_pk) == len(ref_pk)
    for a, b in zip(port_pk, ref_pk):
        assert (a.flow_id, a.seq, a.segment_id) == (b.flow_id, b.seq, b.segment_id)
        np.testing.assert_array_equal(N(a.payload), b.payload)
    assert_batch_equal(wire.WireBatch.from_packets(port_pk), ref_wire.WireBatch.from_packets(ref_pk))
    assert len(wire.WireBatch.from_packets([], device="cpu")) == 0


def test_concat_round_robin_split_and_demux():
    _, a = _arrivals(500, 4, 16, "round_robin", seed=4, rows=True)
    _, b = _arrivals(301, 2, 16, "bursty", seed=5, rows=True)
    b = b.with_epoch(1, 4)
    pa, pb = wire.from_reference(a, "cpu"), wire.from_reference(b, "cpu")
    assert_batch_equal(wire.concat_batches([pa, pb]), ref_wire.concat_batches([a, b]))
    assert len(wire.concat_batches([], device="cpu")) == 0
    # uplinks with distinct flow tags, as the fabric stamps them
    ta = ref_wire.WireBatch(a.values, np.zeros(len(a), np.int64), a.seq, a.flow_id % 3, row_index=a.row_index)
    tb = ref_wire.WireBatch(b.values, np.ones(len(b), np.int64), b.seq, b.flow_id % 3, row_index=b.row_index)
    assert_batch_equal(
        wire.merge_round_robin_batches([wire.from_reference(ta, "cpu"), wire.from_reference(tb, "cpu")]),
        ref_wire.merge_round_robin_batches([ta, tb]),
    )
    for g in (1, 2, 3):
        for got, want in zip(wire.split_by_flow(pa, g), ref_wire.split_by_flow(a, g)):
            assert_batch_equal(got, want)
    with pytest.raises(ValueError):
        wire.split_by_flow(pa, 0)
    tagged = wire.from_reference(ta, "cpu")
    for got, want in zip(wire.segment_streams_batch(tagged, 3), ref_wire.segment_streams_batch(ta, 3)):
        np.testing.assert_array_equal(N(got), want)
    with pytest.raises(ValueError):
        wire.segment_streams_batch(pa, 3)  # untagged arrivals


# -- packets and flows ---------------------------------------------------------


def test_packet_helpers():
    v = np.arange(50, dtype=np.int64)
    rp = ref_packet.packetize(v, 16, flow_id=2)
    pp = packet.packetize(T(v), 16, flow_id=2)
    assert [(p.flow_id, p.seq, p.segment_id, p.size) for p in pp] == [
        (p.flow_id, p.seq, p.segment_id, p.size) for p in rp
    ]
    np.testing.assert_array_equal(N(packet.depacketize(pp)), ref_packet.depacketize(rp))
    tagged_r = [ref_packet.Packet(p.payload, p.flow_id, p.seq, p.seq % 3) for p in rp]
    tagged_p = [packet.Packet(p.payload, p.flow_id, p.seq, p.seq % 3) for p in pp]
    for got, want in zip(packet.segment_streams(tagged_p, 3), ref_packet.segment_streams(tagged_r, 3)):
        np.testing.assert_array_equal(N(got), want)
    with pytest.raises(ValueError):
        packet.segment_streams(pp, 3)
    assert packet.DEFAULT_PAYLOAD == ref_packet.DEFAULT_PAYLOAD
    assert packet.UNTAGGED == ref_packet.UNTAGGED


@pytest.mark.parametrize("mode", ["round_robin", "bursty", "weighted_fair"])
@pytest.mark.parametrize("n,flows,payload", [(0, 3, 8), (5, 8, 4), (2000, 4, 64), (3001, 7, 256)])
def test_interleave_batch_matches_reference(mode, n, flows, payload):
    v = np.random.default_rng(n).integers(0, 10**6, size=n).astype(np.int64)
    rf = ref_flow.split_flows(v, flows, payload)
    pf = flow.split_flows(T(v), flows, payload)
    assert [f.num_packets for f in pf] == [f.num_packets for f in rf]
    for a, b in zip(pf, rf):
        np.testing.assert_array_equal(N(a.values), b.values)
    assert_batch_equal(
        flow.interleave_batch(pf, mode, seed=7), ref_flow.interleave_batch(rf, mode, seed=7)
    )


def test_interleave_guards():
    f = flow.split_flows(torch.arange(10), 2)
    with pytest.raises(ValueError):
        flow.interleave_batch(f, "nope")
    with pytest.raises(ValueError):
        flow.split_flows(torch.arange(10), 0)
    with pytest.raises(ValueError):
        flow.Flow(0, torch.arange(3), payload_size=0)


# -- the fused hop -------------------------------------------------------------


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize(
    "n,S,L,payload,maxv",
    [(0, 4, 8, 16, 100), (1, 4, 8, 16, 100), (3000, 16, 64, 256, 32767),
     (2500, 7, 5, 16, 999), (1200, 4, 48, 32, 50), (900, 8, 16, 64, 2**40)],
)
def test_fused_hop_matches_reference(n, S, L, payload, maxv, rows):
    """Wire columns, row_index carry, HopStats and ship_emission of two
    chained hops, byte-identical to ``repro.net.engine.fused_hop``."""
    _, rb = _arrivals(n, 4, payload, "bursty", seed=n + S, maxv=maxv, rows=rows)
    ranges = ref_part.set_ranges(maxv, S)
    rspec = ref_engine.HopSpec(S, L, maxv, ranges, payload_size=payload)
    pspec = engine.HopSpec(S, L, maxv, T(ranges), payload_size=payload)
    pb = wire.from_reference(rb, device="cpu")
    for hop in range(2):
        rout, rst = ref_engine.fused_hop(rb, rspec, f"h{hop}")
        pout, pst = engine.fused_hop(pb, pspec, f"h{hop}")
        assert_batch_equal(pout, rout)
        assert_stats_equal(pst, rst)
        rb, pb = rout, pout


def test_emission_to_wire():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 100, size=777).astype(np.int64)
    sids = rng.integers(0, 6, size=777).astype(np.int64)
    assert_batch_equal(
        engine.emission_to_wire(T(vals), T(sids), 6, 32, epoch=1),
        ref_engine.emission_to_wire(vals, sids, 6, 32, epoch=1),
    )
    empty = engine.emission_to_wire(torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64), 6, 32)
    assert len(empty) == 0


@pytest.mark.parametrize(
    "keys,block",
    [
        ("int32", 64),      # the kernel's int32 path
        ("negative", 64),   # the reference's np.sort fallback: int64 here
        ("big", 32),        # keys >= int32 max: int64
        ("int32", 48),      # non-pow2 width: padded to 64
        ("int32", 1),
    ],
)
def test_row_sort_device_matches_reference_row_sorter(keys, block):
    rng = np.random.default_rng(block)
    rows = 9
    hi = {"int32": 1 << 30, "negative": 1000, "big": 1 << 40}[keys]
    lo = -1000 if keys == "negative" else 0
    mat = rng.integers(lo, hi, size=(rows, block)).astype(np.int64)
    row_len = rng.integers(0, block + 1, size=rows).astype(np.int64)
    mat[np.arange(block)[None, :] >= row_len[:, None]] = np.iinfo(np.int64).max
    got = N(engine.row_sort_device(T(mat), T(row_len)))
    want = ref_engine.pallas_row_sort(mat, row_len) if keys != "int32" or block != 64 else np.sort(mat, axis=1)
    valid = np.arange(block)[None, :] < row_len[:, None]
    np.testing.assert_array_equal(got[valid], want[valid])
    np.testing.assert_array_equal(got[valid], np.sort(mat, axis=1)[valid])


def test_run_hop_dispatch_and_unported_options():
    _, rb = _arrivals(200, 2, 16, "round_robin", seed=0)
    pb = wire.from_reference(rb, device="cpu")
    spec = engine.HopSpec(4, 8, 32767, T(ref_part.set_ranges(32767, 4)), payload_size=16)
    out, _ = engine.run_hop(pb, spec, "h", "fused")
    assert len(out) == 200
    with pytest.raises(ValueError):
        engine.run_hop(pb, spec, "h", "warp")
    dout, _ = engine.run_hop(pb, spec, "h", "device")
    assert torch.equal(dout.values, out.values)
    rspec = ref_engine.HopSpec(4, 8, 32767, ref_part.set_ranges(32767, 4), payload_size=16)
    for eng in ("segment", "faithful"):  # once refused: the reference's baselines
        got, gst = engine.run_hop(pb, spec, "h", eng)
        want, wst = ref_engine.run_hop(rb, rspec, "h", eng)
        assert_batch_equal(got, want)
        assert gst.emitted_runs == wst.emitted_runs and gst.recirculations == wst.recirculations
    # INT telemetry, once refused, stamps the reference's columns
    rout, _ = ref_engine.fused_hop(rb, ref_engine.HopSpec(4, 8, 32767, ref_part.set_ranges(32767, 4),
                                                          payload_size=16), "h", hop_id=3,
                                   int_telemetry=True)
    iout, _ = engine.fused_hop(pb, spec, "h", hop_id=3, int_telemetry=True)
    assert_batch_equal(iout, rout)
    for name in ("hop_id", "queue_depth", "rank_ticks"):
        np.testing.assert_array_equal(iout.to_numpy()["int_meta"][name], getattr(rout.int_meta, name))


# -- fabrics -------------------------------------------------------------------


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize(
    "graph",
    [("single", {}), ("leaf_spine", {"num_leaves": 3}), ("tree", {"branching": 2, "height": 3})],
)
def test_run_graph_matches_reference(graph, rows):
    kind, kw = graph
    v, rb = _arrivals(5000, 8, 64, "weighted_fair", seed=len(kind), rows=rows)
    ranges = ref_part.quantile_ranges(v, 16, 32767)
    rtopo = ref_topo.make_topology(kind, num_segments=16, segment_length=32,
                                   max_value=32767, ranges=ranges, payload_size=64, **kw)
    ptopo = topology.make_topology(kind, num_segments=16, segment_length=32,
                                   max_value=32767, ranges=T(ranges), payload_size=64, **kw)
    rout, rstats = rtopo.run_batch(rb)
    pout, pstats = ptopo.run_batch(wire.from_reference(rb, device="cpu"))
    assert_batch_equal(pout, rout)
    assert len(pstats) == len(rstats)
    for a, b in zip(pstats, rstats):
        assert_stats_equal(a, b)


def test_graph_builders_and_validation():
    for got, want in (
        (topology.single_graph(), ref_topo.single_graph()),
        (topology.leaf_spine_graph(4), ref_topo.leaf_spine_graph(4)),
        (topology.tree_graph(2, 3), ref_topo.tree_graph(2, 3)),
        (topology.tree_graph(3, 2), ref_topo.tree_graph(3, 2)),
    ):
        assert [(n.name, n.parents, n.group) for n in got.nodes] == [
            (n.name, n.parents, n.group) for n in want.nodes
        ]
        assert got.num_groups == want.num_groups
    H = topology.HopNode
    bad = [
        ((), 1),
        ((H("a"), H("b")), 1),                       # group 0 consumed twice
        ((H("a"),), 2),                              # group 1 feeds no hop
        ((H("a"), H("b", parents=(2,))), 1),         # non-topological parent
        ((H("a"), H("b", parents=(0,)), H("c", parents=(0,))), 1),  # two consumers
        ((H("a"), H("b", group=1), H("c", parents=(0,))), 2),       # orphan hop
    ]
    for nodes, groups in bad:
        with pytest.raises(ValueError):
            topology.HopGraph(nodes, num_groups=groups)
    with pytest.raises(ValueError):
        topology.make_topology("ring", num_segments=2, segment_length=2, max_value=9,
                               ranges=T(ref_part.set_ranges(9, 2)))
    g = topology.single_graph()
    spec = engine.HopSpec(2, 2, 9, T(ref_part.set_ranges(9, 2)))
    batch = wire.packetize_batch(torch.arange(5))
    from repro_torch.net.faults import parse_fault_plan

    # faults=, once refused, degrades the hop: arrival order within segments
    out, st = topology.run_graph(g, batch, spec, faults=parse_fault_plan("degrade:all").at_epoch(0))
    assert out.values.tolist() == [0, 1, 2, 3, 4] and st[0].recirculations == 0
    with pytest.raises(ValueError, match="egress"):
        topology.run_graph(g, batch, spec, faults=parse_fault_plan("crash:switch").at_epoch(0))
    # metrics= and network=, once refused, run as the reference's
    from repro.net import timing as ref_timing
    from repro.obs import MetricsRegistry as RefMetrics
    from repro_torch.net import timing
    from repro_torch.obs import MetricsRegistry

    rbatch = ref_wire.packetize_batch(np.arange(5))
    rspec = ref_engine.HopSpec(2, 2, 9, ref_part.set_ranges(9, 2))
    rm, pm = RefMetrics(), MetricsRegistry()
    rout, _ = ref_topo.run_graph(ref_topo.single_graph(), rbatch, rspec, metrics=rm)
    pout, _ = topology.run_graph(g, batch, spec, metrics=pm)
    assert_batch_equal(pout, rout)
    assert pm.snapshot() == rm.snapshot()
    link = dict(latency=2, rate_numer=1, rate_denom=3)
    rout, _, rrep = ref_topo.run_graph(ref_topo.single_graph(), rbatch, rspec,
                                       network=ref_timing.NetworkConfig(link=ref_timing.LinkSpec(**link)))
    pout, _, prep = topology.run_graph(g, batch, spec,
                                       network=timing.NetworkConfig(link=timing.LinkSpec(**link)))
    assert_batch_equal(pout, rout)
    assert prep.makespan_ticks == rrep.makespan_ticks > 0
    assert [vars(s) for s in prep.links] == [vars(s) for s in rrep.links]


# -- control plane -------------------------------------------------------------


def test_control_plane_matches_reference():
    v = np.random.default_rng(1).integers(0, 32768, size=10_000).astype(np.int64)
    for mode in ("width", "quantile"):
        rp = ref_control.ControlPlane(mode=mode, sample_size=512, seed=3)
        pp = control.ControlPlane(mode=mode, sample_size=512, seed=3)
        np.testing.assert_array_equal(N(pp.ranges(T(v), 16, 32767)), rp.ranges(v, 16, 32767))
    with pytest.raises(ValueError):
        control.ControlPlane(mode="bogus").ranges(T(v), 4, 10)
    assert control.RANGE_MODES == ref_control.RANGE_MODES
    good = ref_part.set_ranges(100, 4)
    cases = [good, good[:3], np.array([[1, 50], [50, 101]]), np.array([[0, 50], [50, 50]]),
             np.array([[0, 40], [50, 101]]), np.array([[0, 50], [50, 90]])]
    for r in cases:
        n_seg = r.shape[0] if r.ndim == 2 else 0
        for S in {n_seg, 4}:
            assert control.ranges_valid(T(r), S, 100) == ref_control.ranges_valid(r, S, 100)


# -- crossing over -------------------------------------------------------------


def test_from_reference_to_numpy_round_trip():
    _, rb = _arrivals(700, 3, 32, "bursty", seed=9, rows=True)
    pb = wire.from_reference(rb.with_epoch(1, 8), device="cpu")
    back = pb.to_numpy()
    again = wire.from_reference(type("B", (), back)(), device="cpu")
    assert_batch_equal(again, rb.with_epoch(1, 8))
    assert pb.device.type == "cpu"


def test_from_reference_refuses_unported_columns():
    """The tenant column, once refused, crosses over and back."""
    _, rb = _arrivals(50, 2, 16, "round_robin", seed=0)
    pb = wire.from_reference(rb.with_tenant(3), device="cpu")
    assert pb.tenant.tolist() == [3] * 50
    np.testing.assert_array_equal(pb.to_numpy()["tenant"], rb.with_tenant(3).tenant)
