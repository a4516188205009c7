"""Port ``repro_torch.net.pipeline.run_pipeline`` (and its server, pool and
jitter) against the reference ``repro.net.pipeline.run_pipeline``.

The matrix is topology x range mode x pool size x merge backend x payload x
jitter, sampled so that every value of every axis appears; each cell runs
both packages on the same numpy-seeded trace and compares output, passes,
hop stats, the delivered wire, reorder depth, server keys and the record
columns exactly (docs/ARCHITECTURE.md invariants 1-4, 6 and 7).  A few arena
cells push segments past ``MIN_DEVICE_KEYS`` so that the reference's
tournament branch, and K2's plain version in the port, are compared.
"""

import itertools

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.core.mergesort import merge_sort_reference
from repro.net import egress as ref_egress
from repro.net import pipeline as ref_pipeline
from repro.net import server as ref_server
from repro.net import wire as ref_wire
from repro_torch.core import mergesort
from repro_torch.data.traces import random_trace
from repro_torch.net import egress, packet, pipeline, server, wire

BASE = dict(num_segments=16, segment_length=64, payload_size=256, num_flows=8, k=10, max_value=32767)
TOPOS = {"single": {}, "leaf_spine": {"num_leaves": 4}, "tree": {"branching": 2, "height": 3}}
COLS = ("values", "flow_id", "seq", "segment_id")


def _payload(vals):
    p = np.empty((vals.size, 2), dtype=np.int64)
    p[:, 0] = vals * 7 + 3
    p[:, 1] = np.arange(vals.size)
    return p


def assert_same_run(port, ref, vals, with_payload):
    got = port.to_numpy()
    np.testing.assert_array_equal(got["output"], ref.output)
    np.testing.assert_array_equal(got["output"], np.sort(vals))  # invariant 1
    assert got["passes"] == ref.passes  # invariant 4
    assert got["max_reorder_depth"] == ref.max_reorder_depth
    assert got["server_keys"] == ref.server_keys
    assert got["server_imbalance"] == ref.server_imbalance
    assert got["range_mode"] == ref.range_mode and got["num_epochs"] == ref.num_epochs
    assert got["n"] == ref.n
    for a, b in zip(got["ranges_history"], ref.ranges_history):
        np.testing.assert_array_equal(a, b)
    for c in COLS:  # invariant 3: the delivered wire
        np.testing.assert_array_equal(got["delivered"][c], getattr(ref.delivered, c), err_msg=c)
    for a, b in zip(got["segment_multisets"], ref.segment_multisets):  # invariant 2
        np.testing.assert_array_equal(a, b)
    assert len(got["hop_stats"]) == len(ref.hop_stats)
    for a, b in zip(got["hop_stats"], ref.hop_stats):
        for f, v in a.items():
            want = getattr(b, f)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(v, want, err_msg=f)
            else:
                assert v == want, f
    if with_payload:
        np.testing.assert_array_equal(got["payload_row_order"], ref.payload_row_order)
        np.testing.assert_array_equal(got["sorted_payload"], ref.sorted_payload)
        np.testing.assert_array_equal(got["delivered"]["row_index"], ref.delivered.row_index)
        np.testing.assert_array_equal(got["payload_row_order"], np.argsort(vals, kind="stable"))
    else:
        assert got["sorted_payload"] is None and got["payload_row_order"] is None


def _cells():
    """Every (topology, range_mode, num_servers) once; backend, payload and
    jitter rotate so that each of their values meets every topology."""
    rot = list(itertools.product(["numpy", "arena"], [False, True], [0, 8]))
    cells = []
    for i, (topo, mode, servers) in enumerate(
        itertools.product(TOPOS, ["static", "oracle", None], [1, 2, 4])
    ):
        backend, with_payload, jitter = rot[i % len(rot)]
        cells.append((topo, mode, servers, backend, with_payload, jitter))
    return cells


@pytest.mark.parametrize("topo,mode,servers,backend,with_payload,jitter", _cells())
def test_pipeline_matches_reference(topo, mode, servers, backend, with_payload, jitter):
    n = 20_000
    vals = random_trace(n, seed=servers + len(topo))
    pl = _payload(vals) if with_payload else None
    kw = dict(BASE, topology=topo, range_mode=mode, num_servers=servers,
              merge_backend=backend, jitter_window=jitter, seed=3, **TOPOS[topo])
    ref = ref_pipeline.run_pipeline(vals, payload=pl, **kw)
    port = pipeline.run_pipeline(vals, payload=pl, device="cpu", **kw)
    assert_same_run(port, ref, vals, with_payload)


@pytest.mark.parametrize(
    "topo,mode,servers,segments",
    [("tree", "oracle", 4, 16), ("single", "static", 2, 4), ("leaf_spine", None, 1, 8)],
)
def test_arena_tournament_branch_matches_reference(topo, mode, servers, segments):
    """Segments past MIN_DEVICE_KEYS: the reference merges them with its XLA
    tournament, the port with K2's plain version; keys only."""
    n = 100_000
    vals = random_trace(n, seed=7)
    kw = dict(BASE, topology=topo, range_mode=mode, num_servers=servers, num_segments=segments,
              merge_backend="arena", seed=1, **TOPOS[topo])
    ref = ref_pipeline.run_pipeline(vals, **kw)
    mergesort.reset_branches()
    port = pipeline.run_pipeline(vals, device="cpu", **kw)
    assert mergesort.MERGE_BRANCHES["tournament"] == segments
    assert mergesort.MERGE_BRANCHES["ladder"] == 0
    assert_same_run(port, ref, vals, False)


def test_record_mode_tournament_matches_reference(monkeypatch):
    """One payload cell past MIN_DEVICE_KEYS: packed int64 records through
    the reference's tournament needs its x64 scope, which jax 0.9 moved;
    the shim is undone after the test."""
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
    n = 40_000
    vals = random_trace(n, seed=2)
    pl = _payload(vals)
    kw = dict(BASE, topology="single", range_mode="oracle", num_servers=2, num_segments=4,
              merge_backend="arena", seed=0)
    ref = ref_pipeline.run_pipeline(vals, payload=pl, verify=True, **kw)
    mergesort.reset_branches()
    port = pipeline.run_pipeline(vals, payload=pl, verify=True, device="cpu", **kw)
    assert mergesort.MERGE_BRANCHES["tournament"] == 4
    assert_same_run(port, ref, vals, True)
    assert not jax.config.jax_enable_x64


@pytest.mark.parametrize("n", [0, 1, 500])
@pytest.mark.parametrize("kind", ["random", "duplicates"])
def test_degenerate_streams(n, kind):
    vals = random_trace(n, seed=1) if kind == "random" else np.full(n, 9, dtype=np.int64)
    for servers, backend in ((1, "numpy"), (4, "arena")):
        kw = dict(BASE, topology="tree", branching=2, height=2, num_servers=servers,
                  merge_backend=backend, jitter_window=4)
        ref = ref_pipeline.run_pipeline(vals, **kw)
        port = pipeline.run_pipeline(vals, device="cpu", **kw)
        assert_same_run(port, ref, vals, False)


def test_pool_sizes_and_backends_agree():
    """Invariants 6 and 7 on the port alone: every pool size and both merge
    backends give the same output, passes and reorder depth."""
    vals = random_trace(30_000, seed=5)
    runs = [
        pipeline.run_pipeline(vals, topology="leaf_spine", num_leaves=2, jitter_window=6,
                              num_servers=s, merge_backend=b, device="cpu", **BASE).to_numpy()
        for s in (1, 2, 4) for b in ("numpy", "arena")
    ]
    for r in runs[1:]:
        np.testing.assert_array_equal(r["output"], runs[0]["output"])
        assert r["passes"] == runs[0]["passes"]
        assert r["max_reorder_depth"] == runs[0]["max_reorder_depth"]


@pytest.mark.parametrize("window", [0, 1, 8])
def test_jitter_delivery_batch_matches_reference(window):
    vals = random_trace(5000, seed=4)
    rb = ref_pipeline.run_pipeline(vals, **BASE).delivered
    pb = wire.from_reference(rb, device="cpu")
    got = pipeline.jitter_delivery_batch(pb, window, seed=11).to_numpy()
    want = ref_pipeline.jitter_delivery_batch(rb, window, seed=11)
    for c in COLS:
        np.testing.assert_array_equal(got[c], getattr(want, c))


def test_plain_stream_sort_matches_reference():
    vals = random_trace(9000, seed=8)
    out, passes, secs = pipeline.plain_stream_sort(vals, 64, 10, device="cpu")
    rout, rpasses, _ = ref_pipeline.plain_stream_sort(vals, 64, 10)
    np.testing.assert_array_equal(out.numpy(), rout)
    assert passes == rpasses and secs >= 0.0


# -- the streaming server and the pool, directly --------------------------------


def _delivered(n=3000, segments=4, jitter=5):
    vals = random_trace(n, seed=6)
    res = ref_pipeline.run_pipeline(vals, num_segments=segments, segment_length=16,
                                    payload_size=32, jitter_window=jitter)
    return vals, res.delivered


@pytest.mark.parametrize("backend", ["numpy", "arena"])
def test_streaming_server_packet_and_batch_ingest(backend):
    vals, rb = _delivered()
    ref = ref_server.StreamingServer(4, k=3, merge_backend=backend)
    port = server.StreamingServer(4, k=3, merge_backend=backend, device="cpu")
    half = len(rb) // 2
    starts = rb.packet_starts()
    cut = int(starts[np.searchsorted(starts, half)])
    ref.ingest_batch(rb.slice_keys(0, cut))
    port.ingest_batch(wire.from_reference(rb.slice_keys(0, cut), device="cpu"))
    for p in rb.slice_keys(cut, len(rb)).to_packets():
        ref.ingest(p)
        port.ingest(packet.Packet(torch.from_numpy(p.payload), p.flow_id, p.seq, p.segment_id))
    assert port.keys_ingested == ref.keys_ingested
    assert port.max_reorder_depth == ref.max_reorder_depth
    got, passes = port.finish()
    want, rpasses = ref.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert passes == rpasses


def test_streaming_server_errors_match_reference():
    _, rb = _delivered(jitter=9)
    for cap in (0, 1):
        with pytest.raises(ValueError, match="reorder buffer overflow"):
            ref_server.StreamingServer(4, reorder_capacity=cap).ingest_batch(rb)
        with pytest.raises(ValueError, match="reorder buffer overflow"):
            server.StreamingServer(4, reorder_capacity=cap, device="cpu").ingest_batch(
                wire.from_reference(rb, device="cpu")
            )
    pk = rb.to_packets()
    srv = server.StreamingServer(4, device="cpu")
    p = next(q for q in pk if q.seq == 1)
    srv.ingest(packet.Packet(torch.from_numpy(p.payload), p.flow_id, p.seq, p.segment_id))
    with pytest.raises(ValueError, match="stream incomplete"):
        srv.finish()
    with pytest.raises(ValueError, match="duplicate"):
        srv.ingest(packet.Packet(torch.from_numpy(p.payload), p.flow_id, p.seq, p.segment_id))
    with pytest.raises(ValueError, match="invalid segment"):
        srv.ingest(packet.Packet(torch.zeros(2, dtype=torch.int64), 0, 0, 9))
    with pytest.raises(ValueError):
        server.StreamingServer(0, device="cpu")
    with pytest.raises(ValueError):
        server.StreamingServer(2, merge_backend="gpu", device="cpu")
    # recovery mode, once refused: a duplicate is dropped and counted, a
    # reorder overflow spills, and the metrics match the reference's
    from repro.obs import MetricsRegistry as RefMetrics
    from repro_torch.obs import MetricsRegistry

    rm, pm = RefMetrics(), MetricsRegistry()
    rsrv = ref_server.StreamingServer(4, reorder_capacity=1, recovery=True, metrics=rm)
    psrv = server.StreamingServer(4, reorder_capacity=1, recovery=True, metrics=pm, device="cpu")
    for q in pk[::-1] + pk[:5]:
        rsrv.ingest(q)
        psrv.ingest(packet.Packet(torch.from_numpy(q.payload), q.flow_id, q.seq, q.segment_id))
    want, rpasses = rsrv.finish()
    got, ppasses = psrv.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert ppasses == rpasses
    assert (psrv.dup_packets_dropped, psrv.spilled_packets, psrv.spilled_keys) == (
        rsrv.dup_packets_dropped, rsrv.spilled_packets, rsrv.spilled_keys)
    assert psrv.dup_packets_dropped == 5 and psrv.spilled_packets > 0
    assert pm.snapshot() == rm.snapshot()


@pytest.mark.parametrize("backend", ["numpy", "arena"])
def test_grow_and_final_merge(backend):
    """Adopted segments after grow(), drained with final_merge, as the
    reference's failover adopter does."""
    _, rb = _delivered(segments=4, jitter=0)
    sub = rb.take(rb.segment_id < 2)
    rest = rb.take(rb.segment_id >= 2)
    ref = ref_server.StreamingServer(2, k=4, final_merge=True, merge_backend=backend)
    port = server.StreamingServer(2, k=4, final_merge=True, merge_backend=backend, device="cpu")
    for s in (ref, port):
        s.grow(2)
    ref.ingest_batch(sub)
    ref.ingest_batch(rest)
    port.ingest_batch(wire.from_reference(sub, device="cpu"))
    port.ingest_batch(wire.from_reference(rest, device="cpu"))
    got, passes = port.finish()
    want, rpasses = ref.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert passes == rpasses
    with pytest.raises(ValueError):
        port.grow(0)


def test_stream_sort_matches_reference_and_alg1():
    vals, rb = _delivered(n=800, jitter=3)
    pk = rb.to_packets()
    want, rpasses = ref_server.stream_sort(pk, 4, k=3)
    got, passes = server.stream_sort(
        [packet.Packet(torch.from_numpy(p.payload), p.flow_id, p.seq, p.segment_id) for p in pk],
        4, k=3, device="cpu",
    )
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), merge_sort_reference(vals, k=3))
    assert passes == rpasses


@pytest.mark.parametrize("S,servers", [(16, 1), (16, 4), (5, 3), (4, 4)])
def test_segment_affinity_and_pool(S, servers):
    np.testing.assert_array_equal(
        egress.segment_affinity(S, servers), ref_egress.segment_affinity(S, servers)
    )
    vals = random_trace(4000, seed=S)
    rb = ref_pipeline.run_pipeline(vals, num_segments=S, segment_length=8, payload_size=16,
                                   jitter_window=3).delivered
    ref = ref_egress.ServerPool(S, servers, k=5, merge_backend="arena")
    port = egress.ServerPool(S, servers, k=5, merge_backend="arena", device="cpu")
    ref.ingest_batch(rb)
    port.ingest_batch(wire.from_reference(rb, device="cpu"))
    got, passes = port.finish()
    want, rpasses = ref.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert passes == rpasses
    assert port.server_keys == ref.server_keys
    assert port.server_imbalance == ref.server_imbalance
    assert port.max_reorder_depth == ref.max_reorder_depth
    assert port.makespan_seconds >= port.merge_seconds >= 0.0


def test_pool_guards_and_concat():
    with pytest.raises(ValueError):
        egress.segment_affinity(4, 0)
    with pytest.raises(ValueError):
        egress.segment_affinity(2, 3)
    with pytest.raises(ValueError):
        egress.ServerPool(4, 2, num_epochs=0, device="cpu")
    with pytest.raises(ValueError):
        egress.ServerPool(4, 2, pool_backend="mpi", device="cpu")
    with pytest.raises(ValueError):
        egress.ServerPool(4, 2, affinity=np.array([1, 0, 0, 1]), device="cpu")
    with pytest.raises(ValueError):
        egress.ServerPool(4, 2, affinity=np.array([0, 1]), device="cpu")
    # the sharded merge (M19) is ported: with no process group it concatenates
    assert egress.ServerPool(4, 2, device="cpu", pool_backend="shard_map").pool_backend == "shard_map"
    # shard failover, once refused, is configured as in the reference
    for kw in ({"crash_schedule": [(0, 1)]}, {"replay_packets": 4}):
        assert egress.ServerPool(4, 2, device="cpu", **kw).servers_failed_over == 0
    with pytest.raises(ValueError, match="single-server"):
        egress.ServerPool(4, 1, device="cpu", crash_schedule=[(0, 1)])
    pool = egress.ServerPool(4, 2, device="cpu")
    bad = wire.packetize_batch(torch.arange(4), segment_id=7)
    with pytest.raises(ValueError, match="invalid segment"):
        pool.ingest_batch(bad)
    a = torch.tensor([1, 3, 5])
    b = torch.tensor([2, 4])
    assert egress.pool_concat([a, b], disjoint=True).tolist() == [1, 3, 5, 2, 4]
    assert egress.pool_concat([a, b], disjoint=False).tolist() == [1, 2, 3, 4, 5]
    assert egress.pool_concat([a[:0], a[:0]], disjoint=False).numel() == 0
    # an epoched pool k-way merges the server streams, as the reference does
    ref = ref_egress.ServerPool(4, 2, num_epochs=2, merge_backend="arena")
    port = egress.ServerPool(4, 2, num_epochs=2, merge_backend="arena", device="cpu")
    vals = random_trace(3000, seed=1)
    rb0 = ref_pipeline.run_pipeline(vals[:1500], num_segments=4, segment_length=8, payload_size=16).delivered
    rb1 = ref_pipeline.run_pipeline(vals[1500:], num_segments=4, segment_length=8, payload_size=16).delivered
    rb = ref_wire.concat_batches([rb0.with_epoch(0, 4), rb1.with_epoch(1, 4)])
    ref.ingest_batch(rb)
    port.ingest_batch(wire.from_reference(rb, device="cpu"))
    got, passes = port.finish()
    want, rpasses = ref.finish()
    np.testing.assert_array_equal(got.numpy(), want)
    assert passes == rpasses


def test_unported_pipeline_options_raise():
    """Every option of the reference's pipeline is ported: the fault plane's
    and the baseline engines' options (held to the reference by
    ``tests/test_torch_faults.py`` and ``tests/test_torch_baselines.py``)
    and, since the sharded slice (M19), ``pool_backend="shard_map"`` (which
    concatenates without a process group; ``tests/test_torch_sharded_sort.py``
    runs its gather on gloo ranks) run as the reference's."""
    vals = random_trace(100, seed=0)
    with pytest.raises(ValueError, match="egress"):
        pipeline.run_pipeline(vals, device="cpu", fault_plan="crash:switch@0")
    want = ref_pipeline.run_pipeline(vals)
    for kw in ({"replay_packets": 3}, {"engine": "segment"}, {"faithful": True},
               {"fault_plan": "degrade:switch@0"}, {"pool_backend": "shard_map", "num_servers": 2}):
        got = pipeline.run_pipeline(vals, device="cpu", **kw)
        np.testing.assert_array_equal(got.output.numpy(), want.output)
    with pytest.raises(ValueError):
        pipeline.run_pipeline(vals, range_mode="bogus", device="cpu")
    with pytest.raises(ValueError):
        pipeline.run_pipeline(vals, range_mode="static", control=object(), device="cpu")
    with pytest.raises(ValueError):
        pipeline.run_pipeline(vals, adaptive=object(), device="cpu")
    with pytest.raises(ValueError):
        pipeline.run_pipeline(vals, payload=np.zeros((3, 2)), device="cpu")
    with pytest.raises(ValueError, match="63 bits"):
        pipeline.run_pipeline(np.array([1 << 62, 2]), payload=np.zeros((2, 1)), device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        pipeline.run_pipeline(vals, engine="device", int_telemetry=True, device="cpu")


def _network(timing):
    return timing.NetworkConfig(
        link=timing.LinkSpec(latency=3, rate_numer=1, rate_denom=2, buffer_packets=4, loss_rate=0.05),
        egress=timing.LinkSpec(latency=2, buffer_packets=2, loss_rate=0.05, dup_rate=0.05),
        seed=5,
    )


@pytest.mark.parametrize("option", ["network", "int_telemetry", "metrics", "sampled", "recovery"])
def test_ported_pipeline_options_match_reference(option):
    """Each option this slice ported, on the same input as the reference:
    the run itself (output, passes, wire, stats) and what the option adds
    (telemetry snapshot, network report, recovery counters) are equal."""
    from repro.net import timing as ref_timing
    from repro.obs import MetricsRegistry as RefMetrics
    from repro_torch.net import timing
    from repro_torch.obs import MetricsRegistry

    vals = random_trace(6000, seed=4)
    kw = dict(BASE, topology="tree", range_mode="oracle", num_servers=2, seed=2, **TOPOS["tree"])
    extra_ref, extra_port = {}, {}
    if option == "network":
        extra_ref["network"], extra_port["network"] = _network(ref_timing), _network(timing)
    elif option == "int_telemetry":
        extra_ref["int_telemetry"] = extra_port["int_telemetry"] = True
    elif option == "metrics":
        extra_ref["metrics"], extra_port["metrics"] = RefMetrics(), MetricsRegistry()
    elif option == "sampled":
        kw["range_mode"] = "sampled"
    else:  # recovery on a jittered wire, under a reorder bound that spills
        kw.update(payload_size=16, jitter_window=8, reorder_capacity=1)
        extra_ref["recovery"] = extra_port["recovery"] = True
    ref = ref_pipeline.run_pipeline(vals, **kw, **extra_ref)
    port = pipeline.run_pipeline(vals, device="cpu", **kw, **extra_port)
    assert_same_run(port, ref, vals, False)
    assert port.telemetry == ref.telemetry
    assert (port.dup_packets_dropped, port.spilled_packets, port.spilled_keys) == (
        ref.dup_packets_dropped, ref.spilled_packets, ref.spilled_keys)
    if option == "network":
        assert port.network.makespan_ticks == ref.network.makespan_ticks
        assert [vars(s) for s in port.network.links] == [vars(s) for s in ref.network.links]
        assert port.dup_packets_dropped > 0
    if option == "sampled":
        assert port.num_epochs == ref.num_epochs > 1
    if option == "recovery":
        assert port.spilled_packets > 0
    if option in ("int_telemetry", "metrics"):
        assert port.telemetry


def test_recording_tracer_refused_null_tracer_accepted():
    """A recording tracer, once refused, now records the reference's span
    hierarchy (names, categories, lanes and argument keys; not times) and
    brings the reference's metrics snapshot; the null tracer records
    nothing and changes nothing."""
    from repro.obs import Tracer as RefTracer
    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import NULL_TRACER

    vals = random_trace(3000, seed=0)
    kw = dict(BASE, topology="leaf_spine", range_mode="sampled", num_servers=2,
              merge_backend="arena", **TOPOS["leaf_spine"])
    rt, pt = RefTracer(), Tracer()
    ref = ref_pipeline.run_pipeline(vals, tracer=rt, **kw)
    port = pipeline.run_pipeline(vals, tracer=pt, device="cpu", **kw)
    assert_same_run(port, ref, vals, False)
    assert port.telemetry == ref.telemetry and port.telemetry
    shape = lambda spans: [(s.name, s.cat, s.tid, s.depth, sorted(s.args)) for s in spans]  # noqa: E731
    assert shape(pt.spans) == shape(rt.spans)
    assert shape(pt.instants) == shape(rt.instants)
    res = pipeline.run_pipeline(vals, tracer=NULL_TRACER, verify=True, device="cpu")
    assert res.output.device.type == "cpu" and res.telemetry is None
