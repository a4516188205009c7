"""Port the multi-tenant serving plane (``repro_torch.net.scheduler``) and
the wire's ``tenant`` column against the reference ``repro.net.scheduler``,
on the CPU.

Job validation and the admission controller's FIFO; the tenant column
through every wire operation and as a packet boundary; ``run_jobs`` at
J in {1, 2, 4} on the packed single switch and per unit (multi-hop fabrics,
the segment and faithful engines): every tenant's output and passes, the
rounds, fabric calls and packed calls equal the reference's, ``pack=False``
equals ``pack=True``, every tenant equals its ``run_job_solo`` twin (and
the reference's), and the device engine packed equals the fused engine.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.data import SCENARIOS, scenario_max_value
from repro.net import packet as ref_packet
from repro.net import scheduler as ref_sched
from repro.net import timing as ref_timing
from repro.net import wire as ref_wire
from repro.obs import MetricsRegistry as RefMetrics
from repro_torch.kernels import ops
from repro_torch.net import packet, scheduler, timing, wire
from repro_torch.obs import MetricsRegistry

FABRIC = dict(num_segments=8, segment_length=16, payload_size=32)
MAXV = scenario_max_value("drifting")
MT_SCENARIOS = ("adversarial_skew", "drifting", "sorted50", "duplicate_heavy")
MT_MODES = ("sampled", "sampled", "oracle", "static")
COLS = ("values", "flow_id", "seq", "segment_id")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def N(t):
    return t.detach().cpu().numpy()


def _jobs(mod, J, n=9000, maxv=MAXV):
    """The reference bench's tenant mix (``net_bench.py MT_SCENARIOS`` /
    ``MT_MODES``, scenario-cycled), ``n`` keys per tenant."""
    return [
        mod.Job(t, SCENARIOS[MT_SCENARIOS[t % 4]](n - 500 * t, seed=t + 1), seed=t + 1,
                range_mode=MT_MODES[t % 4], max_value=maxv)
        for t in range(J)
    ]


def assert_same_jobs(port, ref):
    assert (port.rounds, port.fabric_calls, port.packed_calls) == (
        ref.rounds, ref.fabric_calls, ref.packed_calls)
    assert [jr.tenant_id for jr in port.jobs] == [jr.tenant_id for jr in ref.jobs]
    for jr in ref.jobs:
        pj = port.by_tenant(jr.tenant_id)
        np.testing.assert_array_equal(N(pj.output), jr.output)
        assert pj.passes == jr.passes
        assert (pj.n, pj.range_mode, pj.num_epochs, pj.epochs_granted, pj.rounds_active,
                pj.packed_epochs) == (jr.n, jr.range_mode, jr.num_epochs, jr.epochs_granted,
                                      jr.rounds_active, jr.packed_epochs)
        assert pj.server_keys == jr.server_keys and pj.server_imbalance == jr.server_imbalance
    assert port.fairness == ref.fairness == 1.0


# -- jobs and admission --------------------------------------------------------


def test_job_validation_and_admission_fifo():
    for mod in (ref_sched, scheduler):
        with pytest.raises(ValueError):
            mod.Job(-1, np.arange(4))
        with pytest.raises(ValueError):
            mod.Job(0, np.arange(4), range_mode="psychic")
        with pytest.raises(ValueError):
            mod.AdmissionController(0)
        with pytest.raises(ValueError):
            mod.run_jobs([mod.Job(0, np.arange(10)), mod.Job(0, np.arange(10))], **FABRIC,
                         **({"device": "cpu"} if mod is scheduler else {}))
    assert scheduler.Job(0, np.array([5, 9, 2])).max_value == 9
    assert scheduler.Job(0, torch.tensor([3, 1])).values.dtype == torch.int64
    adm = scheduler.AdmissionController(2)
    for i in range(5):
        adm.submit(i)
    assert adm.admit() == [0, 1] and adm.admit() == []
    assert adm.queued == 3 and adm.inflight == [0, 1]
    adm.release(0)
    assert adm.admit() == [2]
    adm.release(1)
    adm.release(2)
    assert adm.admit() == [3, 4]
    for i in (3, 4):
        adm.release(i)
    assert not adm.active
    assert scheduler.PACKABLE_ENGINES == ref_sched.PACKABLE_ENGINES


# -- the tenant column ---------------------------------------------------------


def _tenanted_pair():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1000, 40)
    # Two jobs' raw packets share a header tuple: only the tenant splits them.
    rb = ref_wire.concat_batches([
        ref_wire.packetize_batch(vals[:20], 8).with_tenant(1),
        ref_wire.packetize_batch(vals[20:], 8).with_tenant(2),
    ])
    rb = ref_wire.WireBatch(rb.values, np.zeros(40), np.zeros(40), np.full(40, -1), tenant=rb.tenant)
    return rb, wire.from_reference(rb, device="cpu")


def test_tenant_column_through_every_wire_op():
    rb, pb = _tenanted_pair()

    def same(p, r):
        got = p.to_numpy()
        for c in COLS + ("tenant",):
            want = getattr(r, c)
            if want is None:
                assert got[c] is None, c
            else:
                np.testing.assert_array_equal(got[c], want, err_msg=c)
        np.testing.assert_array_equal(N(p.packet_starts()), r.packet_starts())

    same(pb, rb)
    assert pb.num_packets == rb.num_packets == 2  # the tenant change is a boundary
    assert wire.WireBatch(pb.values, pb.flow_id, pb.seq, pb.segment_id).num_packets == 1
    idx = np.array([0, 3, 21, 22, 39])
    same(pb.take(T(idx)), rb.take(idx))
    same(pb.take(T(np.arange(40) % 3 == 0)), rb.take(np.arange(40) % 3 == 0))
    same(pb.slice_keys(5, 30), rb.slice_keys(5, 30))
    same(pb.with_epoch(2, 8), rb.with_epoch(2, 8))
    same(pb.with_tenant(7), rb.with_tenant(7))
    same(pb.with_tenant(None), rb.with_tenant(None))
    same(pb.with_tenant(T(np.arange(40))), rb.with_tenant(np.arange(40)))
    same(pb.with_row_index(T(np.arange(40))), rb.with_row_index(np.arange(40)))
    plain = ref_wire.packetize_batch(np.arange(5), 8)
    same(wire.concat_batches([pb, pb.slice_keys(0, 0)]), ref_wire.concat_batches([rb, rb.slice_keys(0, 0)]))
    same(wire.concat_batches([pb, wire.from_reference(plain, device="cpu")]),
         ref_wire.concat_batches([rb, plain]))
    rpk = rb.to_packets()
    ppk = pb.to_packets()
    assert [(p.flow_id, p.seq, p.segment_id, p.tenant_id) for p in ppk] == [
        (p.flow_id, p.seq, p.segment_id, p.tenant_id) for p in rpk]
    same(wire.WireBatch.from_packets(ppk, device="cpu"), ref_wire.WireBatch.from_packets(rpk))
    untenanted = [packet.Packet(torch.arange(3), 0, 0)]
    assert wire.WireBatch.from_packets(untenanted, device="cpu").tenant is None
    assert ref_packet.Packet(np.arange(3), 0, 0).tenant_id == packet.Packet(torch.arange(3), 0, 0).tenant_id
    same(wire.merge_round_robin_batches([pb, pb.with_tenant(3)], device="cpu"),
         ref_wire.merge_round_robin_batches([rb, rb.with_tenant(3)]))
    with pytest.raises(ValueError, match="tenant length"):
        wire.WireBatch(pb.values, pb.flow_id, pb.seq, pb.segment_id, tenant=torch.zeros(3))


# -- run_jobs ------------------------------------------------------------------


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("J", [1, 2, 4])
def test_run_jobs_packed_single_switch_matches_reference(J, pack):
    rm, pm = RefMetrics(), MetricsRegistry()
    ref = ref_sched.run_jobs(_jobs(ref_sched, J), engine="fused", max_inflight=4, pack=pack,
                             metrics=rm, **FABRIC)
    port = scheduler.run_jobs(_jobs(scheduler, J), engine="fused", max_inflight=4, pack=pack,
                              metrics=pm, device="cpu", verify=True, **FABRIC)
    assert_same_jobs(port, ref)
    assert pm.snapshot()["counters"] == rm.snapshot()["counters"]
    assert port.jobs_per_sec > 0 and 0 < port.p50_latency_s <= port.p99_latency_s
    if J > 1:
        assert (port.packed_calls > 0) == pack
        assert any(jr.num_epochs > 1 for jr in port.jobs)  # a sampled tenant re-partitioned


@pytest.mark.parametrize("case", ["tree", "leaf_spine", "segment", "faithful", "inflight1"])
def test_run_jobs_per_unit_matches_reference(case):
    kw = {"tree": dict(topology="tree", branching=2, height=2),
          "leaf_spine": dict(topology="leaf_spine", num_leaves=2),
          "segment": dict(engine="segment"),
          "faithful": dict(engine="faithful"),
          "inflight1": dict(max_inflight=1)}[case]
    n = 1200 if case == "faithful" else 5000
    ref = ref_sched.run_jobs(_jobs(ref_sched, 3, n=n), **FABRIC, **kw)
    port = scheduler.run_jobs(_jobs(scheduler, 3, n=n), device="cpu", **FABRIC, **kw)
    assert_same_jobs(port, ref)
    assert port.packed_calls == 0


def test_pack_false_equals_pack_true_and_solo_twins():
    jobs = _jobs(scheduler, 4)
    packed = scheduler.run_jobs([scheduler.Job(**vars(j)) for j in jobs], device="cpu", **FABRIC)
    unpacked = scheduler.run_jobs([scheduler.Job(**vars(j)) for j in jobs], pack=False, device="cpu",
                                  **FABRIC)
    assert packed.packed_calls > 0 and unpacked.packed_calls == 0
    assert packed.fabric_calls < unpacked.fabric_calls
    for j, rj in zip(jobs, _jobs(ref_sched, 4)):
        a, b = packed.by_tenant(j.tenant_id), unpacked.by_tenant(j.tenant_id)
        assert torch.equal(a.output, b.output) and a.passes == b.passes
        solo = scheduler.run_job_solo(j, device="cpu", max_inflight=4, pack=True, **FABRIC)
        rsolo = ref_sched.run_job_solo(rj, **FABRIC)
        assert torch.equal(a.output, solo.output) and a.passes == solo.passes
        np.testing.assert_array_equal(N(solo.output), rsolo.output)
        assert solo.passes == rsolo.passes and solo.num_epochs == rsolo.num_epochs


def test_device_engine_packed_equals_fused(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False)
    fused = scheduler.run_jobs(_jobs(scheduler, 4), engine="fused", device="cpu", **FABRIC)
    dev = scheduler.run_jobs(_jobs(scheduler, 4), engine="device", device="cpu", **FABRIC)
    ref = ref_sched.run_jobs(_jobs(ref_sched, 4), engine="device", **FABRIC)
    assert dev.packed_calls == fused.packed_calls > 0
    assert_same_jobs(dev, ref)
    for jr in fused.jobs:
        d = dev.by_tenant(jr.tenant_id)
        assert torch.equal(d.output, jr.output) and d.passes == jr.passes


def test_packed_keys_beyond_int32_take_the_int64_row_sort(monkeypatch):
    """Tenant slot i's keys shift by i * stride: with four tenants of keys
    up to 2^30 the packed matrix passes int32, so K1 runs on int64 keys."""
    seen = []
    orig = ops.sort_rows_padded

    def spy(x):
        seen.append(x.dtype)
        return orig(x)

    monkeypatch.setattr(ops, "sort_rows_padded", spy)
    maxv = (1 << 30) - 1
    jobs = lambda mod: [  # noqa: E731
        mod.Job(t, np.random.default_rng(t).integers(0, maxv + 1, 3000), seed=t,
                range_mode=("static", "oracle")[t % 2], max_value=maxv) for t in range(4)]
    port = scheduler.run_jobs(jobs(scheduler), device="cpu", **FABRIC)
    ref = ref_sched.run_jobs(jobs(ref_sched), **FABRIC)
    assert seen == [torch.int64] and port.packed_calls == 1
    assert_same_jobs(port, ref)
    seen.clear()
    solo = scheduler.run_job_solo(jobs(scheduler)[0], device="cpu", **FABRIC)
    assert seen == [torch.int32]  # one tenant alone stays on int32
    assert torch.equal(solo.output, port.by_tenant(0).output)


def test_lossy_network_tenants_match_reference():
    link = dict(latency=2, rate_numer=4, rate_denom=1, loss_rate=0.02)
    egress_link = dict(latency=1, loss_rate=0.02, dup_rate=0.01)
    rcfg = ref_timing.NetworkConfig(link=ref_timing.LinkSpec(**link), egress=ref_timing.LinkSpec(**egress_link))
    pcfg = timing.NetworkConfig(link=timing.LinkSpec(**link), egress=timing.LinkSpec(**egress_link))
    ref = ref_sched.run_jobs(_jobs(ref_sched, 3, n=5000), network=rcfg, num_servers=2, **FABRIC)
    port = scheduler.run_jobs(_jobs(scheduler, 3, n=5000), network=pcfg, num_servers=2, device="cpu",
                              **FABRIC)
    assert (port.rounds, port.fabric_calls, port.packed_calls) == (ref.rounds, ref.fabric_calls,
                                                                    ref.packed_calls)
    for jr in ref.jobs:
        np.testing.assert_array_equal(N(port.by_tenant(jr.tenant_id).output), jr.output)
    assert [r.makespan_ticks for r in port.network_reports] == [r.makespan_ticks for r in ref.network_reports]
    assert [[dataclasses.asdict(s) for s in r.links] for r in port.network_reports] == [
        [dataclasses.asdict(s) for s in r.links] for r in ref.network_reports]
