"""The port's CUDA kernels on the card: K1-K6 against their plain torch
versions, the launch counters, a small pipeline against its CPU run, and the
smoke LMs (dense and MoE) served on the card against the same weights on the
CPU.

Marked ``cuda``; every test skips with a reason where no card is present.
Run them on a machine with an NVIDIA card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mergesort
from repro_torch.data.traces import random_trace
from repro_torch import configs, models
from repro_torch.kernels import bitonic, build, ops
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.net.pipeline import run_pipeline
from repro_torch.serve.engine import Engine, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bitonic.build_kernels()  # every kernel of the port
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,b", [(1, 2), (3, 64), (1000, 64), (17, 128), (5, 1024), (2, 4096)])
def test_row_sort_kernel_equals_plain(gen, dtype, rows, b):
    x = torch.randint(-(1 << 20), 1 << 20, (rows, b), dtype=dtype, device="cuda", generator=gen)
    got = bitonic.sort_rows(x)
    assert torch.equal(got, bitonic.sort_rows_plain(x))
    assert torch.equal(got, torch.sort(x, dim=1).values)


def _k1_rows(gen, dtype, rows, b, kind):
    """``ragged`` keys with many ties and a random tail of each row padded
    with the dtype max, ``all_equal`` rows, or ``extremes`` (a quarter each
    of the dtype's min and max among the ties)."""
    info = torch.iinfo(dtype)
    if kind == "all_equal":
        return torch.full((rows, b), -7, dtype=dtype, device="cuda")
    x = torch.randint(-3, 4, (rows, b), dtype=dtype, device="cuda", generator=gen)
    if kind == "extremes":
        pick = torch.randint(0, 4, (rows, b), device="cuda", generator=gen)
        return torch.where(pick == 0, info.min, torch.where(pick == 1, info.max, x))
    cut = torch.randint(0, b + 1, (rows, 1), device="cuda", generator=gen)
    return torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, info.max)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b", [1 << e for e in range(1, 13)])
def test_row_sort_every_width_row_count_and_key_kind(gen, dtype, b):
    """Every width 2..4096: row counts that leave a warp or a block
    part-filled (1, 3, 5, 1000, and one that ends inside the third block
    where a block holds more than a row), ragged pads of the maximum with
    many ties, all-equal rows and the dtype's extremes; one launch a call,
    equal to the plain network and to torch.sort."""
    tile = bitonic.row_sort_items(b) * bitonic.ROW_SORT_THREADS
    for rows in (1, 3, 5, 1000, (2 * tile + tile // 2) // b + 1):
        for kind in ("ragged", "all_equal", "extremes"):
            x = _k1_rows(gen, dtype, rows, b, kind).contiguous()
            bitonic.reset_launches()
            got = bitonic.sort_rows(x)
            assert bitonic.LAUNCHES["row_sort"] == 1
            assert torch.equal(got, bitonic.sort_rows_plain(x)), (rows, kind)
            assert torch.equal(got, torch.sort(x, dim=1).values), (rows, kind)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("b", [1 << e for e in range(1, 13)])
def test_row_sort_reads_a_view_not_16_byte_aligned(gen, dtype, b):
    """A contiguous view one key past a 16-byte boundary: the kernel loads
    and stores it key by key (no 16-byte vectors), in one launch, equal to
    the plain network."""
    rows = 37
    flat = _k1_rows(gen, dtype, rows * b + 1, 1, "extremes").reshape(-1)
    x = flat[1:].view(rows, b)
    assert x.is_contiguous() and x.data_ptr() % 16
    bitonic.reset_launches()
    got = bitonic.sort_rows(x)
    assert bitonic.LAUNCHES["row_sort"] == 1
    assert torch.equal(got, bitonic.sort_rows_plain(x))
    assert torch.equal(got, torch.sort(x, dim=1).values)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("p,b", [(2, 1), (2, 2), (8, 512), (1024, 64), (4096, 2), (2, 1 << 14), (1 << 15, 128)])
def test_tournament_kernel_equals_plain(gen, dtype, p, b):
    hi = torch.iinfo(dtype).max
    x = torch.randint(0, 1 << 30, (p, b), dtype=dtype, device="cuda", generator=gen)
    cut = torch.randint(1, b + 1, (p, 1), device="cuda", generator=gen)
    x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi)
    x = torch.sort(x, dim=1).values.contiguous()
    got = ops.merge_tournament(x)
    assert torch.equal(got, bitonic.tournament_plain(x))
    assert torch.equal(got, torch.sort(x.reshape(-1)).values)


def _sorted_rows(gen, dtype, p, b, kind):
    """(p, b) sorted rows padded with the dtype max: ``random`` keys with
    ragged pads, ``all_pad`` rows, or ``all_equal`` keys."""
    hi = torch.iinfo(dtype).max
    if kind == "all_pad":
        return torch.full((p, b), hi, dtype=dtype, device="cuda")
    if kind == "all_equal":
        return torch.full((p, b), 5, dtype=dtype, device="cuda")
    x = torch.randint(0, 1 << 30, (p, b), dtype=dtype, device="cuda", generator=gen)
    cut = torch.randint(1, b + 1, (p, 1), device="cuda", generator=gen)
    x = torch.where(torch.arange(b, device="cuda")[None, :] < cut, x, hi)
    return torch.sort(x, dim=1).values.contiguous()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("p,b,kind", [
    (64, 256, "all_pad"), (64, 256, "all_equal"), (1 << 15, 64, "all_equal"),
    (2, 1 << 22, "random"),             # one pair spread over 2,048 blocks
    (8, 1 << 15, "random"), (4, 1 << 16, "all_pad"),  # B >= the tile: no tile launch
    (131_072, 64, "random"),            # the sort path's largest bucket
])
def test_tournament_merge_path_equals_plain(gen, dtype, p, b, kind):
    """The merge-path rounds: exactly the plain merge and torch.sort, one
    count per call, and the kernel's launch plan equal to the Python one."""
    x = _sorted_rows(gen, dtype, p, b, kind)
    bitonic.reset_launches()
    got = bitonic.merge_tournament(x)
    assert bitonic.LAUNCHES["tournament"] == 1
    assert torch.equal(got, bitonic.tournament_plain(x))
    assert torch.equal(got, torch.sort(x.reshape(-1)).values)
    assert build.function("tournament", "tournament_launches")(p, b) == bitonic.tournament_launches(p, b)


def test_wrappers_count_launches_and_check_inputs(gen):
    bitonic.reset_launches()
    x = torch.randint(0, 100, (8, 64), dtype=torch.int32, device="cuda", generator=gen)
    bitonic.sort_rows(x)
    bitonic.merge_tournament(torch.sort(x, dim=1).values)
    bitonic.sort_rows(x[:, :1].contiguous())  # one-key rows: nothing to launch
    assert bitonic.LAUNCHES == {"row_sort": 1, "tournament": 1, "row_sort_kv": 0, "merge_rows": 0,
                                "flash_attention": 0, "decode_attention": 0}
    with pytest.raises(ValueError, match="contiguous"):
        bitonic.sort_rows(x.t())
    with pytest.raises(TypeError):
        bitonic.sort_rows(x.to(torch.int16))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,n,hi", [(1, 32, 48), (1, 16_384, 48), (4, 16, 7), (1, 512, 1 << 20),
                                       (3, 1 << 15, 100), (1, 1 << 16, 1 << 30),
                                       (3, 2, 2), (2, 64, 5), (4, 256, 9), (1, 2048, 40), (2, 4096, 40),
                                       (4, 1 << 15, 1 << 12), (2, 1 << 17, 1000), (1, 1 << 20, 40),
                                       (3, 1 << 20, 1 << 30)])
def test_row_sort_kv_kernel_equals_plain(gen, dtype, rows, n, hi):
    """Keys and values equal the plain network exactly, duplicate keys
    included: one chunk launch up to 2,048 pairs, strided launches above,
    device-memory passes from 2^16; the kernels one call puts on the card
    (the kernel nodes of a CUDA graph of the call) are the plan's launches."""
    keys = torch.randint(0, hi, (rows, n), dtype=dtype, device="cuda", generator=gen)
    vals = torch.arange(rows * n, dtype=torch.int32, device="cuda").reshape(rows, n)
    bitonic.reset_launches()
    gk, gv = bitonic.sort_rows_kv(keys, vals)
    assert bitonic.LAUNCHES["row_sort_kv"] == 1
    wk, wv = bitonic.sort_rows_kv_plain(keys, vals)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(gk, torch.sort(keys, dim=1).values)
    launches = build.graph_kernel_launches(lambda: bitonic.sort_rows_kv(keys, vals))
    assert launches == len(bitonic.row_sort_kv_plan(n))


def test_dispatch_order_on_card_is_the_stable_argsort(gen):
    from repro_torch.models import moe

    for nk, key_max in ((32, 48), (15_704, 48), (20_000, 1 << 30)):
        key = torch.randint(0, 41, (nk,), device="cuda", generator=gen)
        order = moe.stable_argsort(key, key_max)
        assert torch.equal(order, torch.sort(key, stable=True).indices)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("rows,b", [(8, 4), (8, 64), (8, 1024), (3, 16), (65_536, 64), (4, 1 << 13), (2, 1 << 16)])
def test_merge_rows_kernel_equals_plain(gen, dtype, rows, b):
    """Widths up to a 4096-element tile run in shared memory; wider rows
    (2^14 and 2^17 elements) run their long stages in device memory."""
    def sorted_rows():
        if dtype == torch.float32:
            x = torch.randn((rows, b), device="cuda", generator=gen)
        else:
            x = torch.randint(-(1 << 30), 1 << 30, (rows, b), dtype=dtype, device="cuda", generator=gen)
        return torch.sort(x, dim=1).values.contiguous()

    a, c = sorted_rows(), sorted_rows()
    bitonic.reset_launches()
    got = bitonic.merge_rows(a, c)
    assert bitonic.LAUNCHES["merge_rows"] == 1
    assert torch.equal(got, bitonic.merge_rows_plain(a, c))
    assert torch.equal(got, torch.sort(torch.cat([a, c], dim=1), dim=1).values)


@pytest.mark.parametrize("backend,jitter", [("arena", 0), ("arena", 8), ("numpy", 8)])
def test_pipeline_on_card_equals_cpu_run(gen, backend, jitter):
    """The card's run (kernels, the slow reorder path under jitter, the
    ladder) is byte-identical to the plain versions' run on the CPU."""
    vals = random_trace(60_000, seed=3)
    payload = np.stack([vals * 7 + 3, np.arange(vals.size)], axis=1)
    kw = dict(topology="tree", branching=2, height=3, num_segments=4, segment_length=64,
              payload_size=256, num_flows=8, range_mode="oracle", num_servers=2,
              merge_backend=backend, jitter_window=jitter, payload=payload)
    bitonic.reset_launches()
    mergesort.reset_branches()
    card = run_pipeline(vals, device="cuda", **kw).to_numpy()
    assert bitonic.LAUNCHES["row_sort"] == 7
    if backend == "arena":
        assert bitonic.LAUNCHES["tournament"] >= 1
        assert mergesort.MERGE_BRANCHES["ladder"] == 0
    host = run_pipeline(vals, device="cpu", **kw).to_numpy()
    for key in ("output", "payload_row_order", "sorted_payload"):
        np.testing.assert_array_equal(card[key], host[key])
    for c in ("values", "flow_id", "seq", "segment_id", "row_index"):
        np.testing.assert_array_equal(card["delivered"][c], host["delivered"][c])
    assert card["passes"] == host["passes"]
    assert card["max_reorder_depth"] == host["max_reorder_depth"]
    np.testing.assert_array_equal(card["output"], np.sort(vals))


def _slice8_kw(engine):
    return dict(topology="tree", branching=2, height=3, num_segments=8, segment_length=64,
                payload_size=256, num_flows=8, num_servers=2, merge_backend="arena", engine=engine)


def _same_on_card_and_cpu(card, host):
    a, b = card.to_numpy(), host.to_numpy()
    np.testing.assert_array_equal(a["output"], b["output"])
    assert a["passes"] == b["passes"] and a["num_epochs"] == b["num_epochs"]
    for c in ("values", "flow_id", "seq", "segment_id"):
        np.testing.assert_array_equal(a["delivered"][c], b["delivered"][c])
    for x, y in zip(a["ranges_history"], b["ranges_history"]):
        np.testing.assert_array_equal(x, y)
    assert (a["dup_packets_dropped"], a["spilled_packets"]) == (b["dup_packets_dropped"], b["spilled_packets"])
    assert a["telemetry"] == b["telemetry"]


@pytest.mark.parametrize("engine", ["fused", "device"])
def test_sampled_pipeline_on_card_equals_cpu_run(gen, engine):
    """``range_mode="sampled"`` on the card: the epochs, ranges and output
    of the same call on the CPU, K1 launched on every epoch's hops."""
    from repro_torch.data.scenarios import drifting
    from repro_torch.net.control import AdaptiveControlPlane

    vals = drifting(80_000, seed=1)
    plane = dict(warmup=2048, recent_window=2048, check_every=2048, seed=3)
    kw = dict(_slice8_kw(engine), range_mode="sampled", max_value=65535)
    bitonic.reset_launches()
    card = run_pipeline(vals, adaptive=AdaptiveControlPlane(8, 65535, **plane), device="cuda", **kw)
    if engine == "fused":
        assert bitonic.LAUNCHES["row_sort"] == 7 * card.num_epochs
    host = run_pipeline(vals, adaptive=AdaptiveControlPlane(8, 65535, **plane), device="cpu", **kw)
    assert card.num_epochs > 1
    _same_on_card_and_cpu(card, host)
    np.testing.assert_array_equal(card.output.cpu().numpy(), np.sort(vals))


@pytest.mark.parametrize("engine", ["fused", "device"])
def test_observed_pipeline_on_card_equals_cpu_run(gen, engine):
    """A recording tracer, metrics and (fused) INT telemetry on the card:
    the same spans (not times), snapshot and INT summary as on the CPU, and
    the same output as the unobserved run on the card."""
    from repro_torch.obs import Tracer

    vals = random_trace(50_000, seed=2)
    kw = dict(_slice8_kw(engine), range_mode="oracle", int_telemetry=engine == "fused")
    runs = []
    for dev in ("cuda", "cpu"):
        tr = Tracer()
        runs.append((run_pipeline(vals, tracer=tr, device=dev, **kw), tr))
    (card, ctr), (host, htr) = runs
    _same_on_card_and_cpu(card, host)
    shape = lambda t: [(s.name, s.cat, s.tid, sorted(s.args)) for s in t.spans]  # noqa: E731
    assert shape(ctr) == shape(htr)
    plain = run_pipeline(vals, device="cuda", **dict(kw, int_telemetry=False))
    assert torch.equal(plain.output, card.output) and plain.passes == card.passes


@pytest.mark.parametrize("engine", ["fused", "device"])
def test_timed_pipeline_on_card_equals_cpu_run(gen, engine):
    """``network=`` on the card: the lossy egress healed by recovery, the
    same NetworkReport and recovery counters as on the CPU, the output
    equal to the timeless run's."""
    import dataclasses

    from repro_torch.net.timing import LinkSpec, NetworkConfig

    vals = random_trace(40_000, seed=4)
    net = NetworkConfig(link=LinkSpec(latency=2, rate_numer=4, buffer_packets=4, loss_rate=0.02),
                        egress=LinkSpec(latency=3, loss_rate=0.05, dup_rate=0.05, buffer_packets=8),
                        seed=1)
    kw = dict(_slice8_kw(engine), range_mode="oracle")
    card = run_pipeline(vals, network=net, device="cuda", **kw)
    host = run_pipeline(vals, network=net, device="cpu", **kw)
    _same_on_card_and_cpu(card, host)
    assert card.network.makespan_ticks == host.network.makespan_ticks
    assert [dataclasses.asdict(x) for x in card.network.links] == [
        dataclasses.asdict(x) for x in host.network.links]
    timeless = run_pipeline(vals, device="cuda", **kw)
    assert torch.equal(timeless.output, card.output) and timeless.passes == card.passes


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


#: q and k at 1.5 x a unit normal: scores of standard deviation 2.25 at any
#: head dim, a peaked softmax that a dropped cache block or a missing
#: online-softmax rescale moves by far more than the limit below.
QK_SCALE = 1.5


def _assert_attention_close(got, want):
    """Both sides sum in f32, in other orders, and round the output once.
    float32: 2e-5 + 1e-3 relative.  bfloat16: one ulp of each value (at most
    2^-7 of it, so 1e-2 relative) plus 4e-3 of the largest output."""
    torch.cuda.synchronize()
    if want.dtype == torch.bfloat16:
        atol, rtol = 4e-3 * want.float().abs().max().item(), 1e-2
    else:
        atol, rtol = 2e-5, 1e-3
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,T,H,KV,d", [(1, 1, 4, 2, 32), (2, 7, 4, 4, 64), (1, 130, 8, 2, 64),
                                        (1, 300, 32, 8, 128), (2, 64, 4, 1, 128), (1, 1963, 24, 8, 64)])
def test_flash_attention_kernel_equals_plain(gen, B, T, H, KV, d, causal, dtype):
    q = _randn(gen, (B, T, H, d), dtype, QK_SCALE)
    k = _randn(gen, (B, T, KV, d), dtype, QK_SCALE)
    v = _randn(gen, (B, T, KV, d), dtype)
    bitonic.reset_launches()
    got = flash_attention(q, k, v, causal=causal)
    assert bitonic.LAUNCHES["flash_attention"] == 1
    _assert_attention_close(got, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,d,causal", [
    (1, 1963, 1963, 32, 8, 128, True),   # Mistral-Nemo-12B's largest prefill
    (1, 1, 300, 4, 1, 32, False), (2, 7, 130, 6, 2, 64, False), (1, 130, 1000, 8, 2, 128, False),
    (1, 130, 7, 6, 2, 32, False), (3, 7, 7, 12, 4, 64, True), (1, 130, 130, 8, 2, 128, True),
    (2, 71, 71, 9, 3, 32, True),
])
def test_flash_attention_ragged_and_cross_lengths(gen, B, T, S, H, KV, d, causal, dtype):
    """T = 1, T = 7 (mod 16), S != T, G = 3 and 4, every head dim."""
    q = _randn(gen, (B, T, H, d), dtype, QK_SCALE)
    k = _randn(gen, (B, S, KV, d), dtype, QK_SCALE)
    v = _randn(gen, (B, S, KV, d), dtype)
    bitonic.reset_launches()
    got = flash_attention(q, k, v, causal=causal)
    assert bitonic.LAUNCHES["flash_attention"] == 1
    _assert_attention_close(got, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_attention_reads_strided_views(gen, dtype, d):
    """q, k and v as views of one fused (B, T, H + 2 KV, d) projection: last
    axis contiguous, rows strided, read in place."""
    B, T, H, KV = 2, 150, 8, 2
    qkv = _randn(gen, (B, T, H + 2 * KV, d), dtype, QK_SCALE)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        _assert_attention_close(got, flash_attention_plain(q, k, v, causal=causal))


def test_flash_attention_bf16_raises_on_misaligned_rows(gen):
    """A row stride that is not a multiple of 8 elements: the bf16 kernel's
    16-byte copies cannot take it, and the wrapper raises (no fallback);
    the f32 kernel reads the same layout."""
    x = _randn(gen, (1, 64, 4, 33), torch.float32)[..., :32]
    xb = _randn(gen, (1, 64, 4, 33), torch.bfloat16)[..., :32]
    bitonic.reset_launches()
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        flash_attention(xb, xb, xb)
    assert bitonic.LAUNCHES["flash_attention"] == 0
    _assert_attention_close(flash_attention(x, x, x), flash_attention_plain(x, x, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,d", [(1, 1, 4, 2, 32), (3, 300, 4, 4, 64), (4, 4096, 32, 8, 128),
                                        (2, 512, 16, 1, 128), (4, 4096, 24, 8, 64),
                                        (3, 700, 24, 2, 128), (4, 1000, 96, 8, 64), (2, 333, 28, 4, 32)])
def test_decode_attention_kernel_equals_plain(gen, B, S, H, KV, d, dtype):
    """Slot 0 at length 1, the last at S; G = 1, 2, 3, 4, 7 and 12."""
    q = _randn(gen, (B, H, d), dtype, QK_SCALE)
    # the layer-1 slice of a stacked (L, B, S, KV, d) cache, read in place
    kc = _randn(gen, (2, B, S, KV, d), dtype, QK_SCALE)[1]
    vc = _randn(gen, (2, B, S, KV, d), dtype)[1]
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    lengths[0] = 1
    lengths[-1] = S
    bitonic.reset_launches()
    got = decode_attention(q, kc, vc, lengths)
    assert bitonic.LAUNCHES["decode_attention"] == 1
    _assert_attention_close(got, decode_attention_plain(q, kc, vc, lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,G", [(64, 1), (64, 12), (128, 4), (128, 12)])
def test_decode_attention_length_zero_and_strided_views(gen, d, G, dtype):
    """Length-0 slots (every position masked: the mean of v over the cache),
    a length past S, and q and the caches as strided views: q a slice of a
    fused projection, the caches one slot's and one layer's slice of a
    stacked cache with the kv heads of two caches interleaved."""
    B, S, KV = 4, 777, 2
    H = KV * G
    qkv = _randn(gen, (B, H + 8, d), dtype, QK_SCALE)
    q = qkv[:, 4:4 + H]
    stacked = _randn(gen, (3, B + 1, S, 2 * KV, d), dtype, QK_SCALE)
    kc, vc = stacked[1, 1:, :, :KV], stacked[2, 1:, :, KV:]
    lengths = torch.tensor([0, 5, S + 9, 0], dtype=torch.int32, device="cuda")
    got = decode_attention(q, kc, vc, lengths)
    want = decode_attention_plain(q, kc, vc, lengths)
    _assert_attention_close(got, want)
    mean_v = vc[0].float().mean(0).repeat_interleave(G, 0)
    _assert_attention_close(got[0], mean_v.to(dtype))


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_smoke_lm_served_on_card_equals_cpu(gen, arch):
    """The f32 smoke config on the card and on the CPU, same weights: equal
    greedy tokens, logits within 1e-4; K5 once per layer per prefill, K6
    once per layer per decode step, K3 once per MoE layer of either.  The
    card's engine replays its decode step as a CUDA graph, so its decode
    launches are the graph's kernel nodes times its replays."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    want, _ = host.prefill(toks, host.init_cache(2, 32))
    got, _ = card.prefill(toks.cuda(), card.init_cache(2, 32))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    outs = []
    for model, dev in ((host, "cpu"), (card, "cuda")):
        eng = Engine(model, slots=2, max_len=64, device=dev)
        for i, n in enumerate((3, 5, 2, 7, 4)):
            eng.add(Request(rid=i, prompt=list(range(10 + i, 10 + i + n)), max_tokens=6))
        bitonic.reset_launches()
        steps = 0
        while eng.queue or any(eng.active):
            eng.step()
            steps += 1
        outs.append(sorted((r.rid, r.out) for r in eng.finished))
    assert outs[0] == outs[1]
    assert eng.decode_steps == steps
    nodes = build.graph_kernel_nodes(eng.decode_graph, ["decode_partial", "chunk_stages", "flash_fwd"])
    assert nodes["flash_fwd"] == 0
    assert bitonic.LAUNCHES["flash_attention"] == cfg.num_layers * 5  # one prefill per request
    assert bitonic.LAUNCHES["decode_attention"] == 0
    assert nodes["decode_partial"] * steps == cfg.num_layers * steps
    moe_layers = cfg.num_layers - cfg.moe.first_dense_layers if cfg.moe else 0
    assert bitonic.LAUNCHES["row_sort_kv"] + nodes["chunk_stages"] * steps == moe_layers * (5 + steps)


# -- the compiled programs: the decode step and the device epoch -----------------


def _smoke_pair(arch):
    import dataclasses

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    return cfg, host, card


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m"])
def test_decode_graph_tokens_equal_eager_step(gen, arch):
    """The engine's captured decode step against the eager step on the card,
    token for token -- the first request included, so the capture's warm-up
    step is undone -- and the cache tensors are never rebound."""
    cfg, _, card = _smoke_pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (6, 3, 9, 2, 5)]
    outs = []
    for eager in (False, True):
        eng = Engine(card, slots=3, max_len=64, device="cuda", _eager=eager)
        assert (eng.decode_graph is None) == eager
        if not eager:
            assert not any(leaf.any() for leaf in eng.cache.values())
            ptrs = {k: v.data_ptr() for k, v in eng.cache.items()}
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_tokens=7))
        outs.append(sorted((r.rid, r.out) for r in eng.run()))
        if not eager:
            assert {k: v.data_ptr() for k, v in eng.cache.items()} == ptrs
    assert outs[0] == outs[1]


def test_decode_capture_failure_raises(gen, monkeypatch):
    """A step that reads the device on the host cannot be captured: building
    the engine raises; it does not fall back to the eager step."""
    _, _, card = _smoke_pair("mistral-nemo-12b")
    step = card.decode_step

    def reads_host(cache, tokens):
        logits, cache = step(cache, tokens)
        if int(logits.argmax()) < 0:
            pass
        return logits, cache

    monkeypatch.setattr(card, "decode_step", reads_host)
    with pytest.raises(RuntimeError):
        Engine(card, slots=2, max_len=32, device="cuda")


def _epoch_batch(n=6000, rows=True, seed=0):
    from repro_torch.net import flow

    vals = torch.from_numpy(np.random.default_rng(seed).integers(0, 1 << 15, n)).cuda()
    b = flow.interleave_batch(flow.split_flows(vals, 8, 256), "round_robin")
    if rows:
        r = flow.interleave_batch(flow.split_flows(torch.arange(n, device="cuda"), 8, 256), "round_robin")
        b = b.with_row_index(r.values)
    return b


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("graph", ["single", "leaf_spine", "tree"])
def test_device_epoch_replay_equals_eager_and_fused(gen, graph, rows):
    """The captured epoch (first call and a replay) against the same program
    run eagerly on the card and against the fused engine on the card: wire
    columns, grouped view and stats; one read back per epoch; K1 one kernel
    node per hop of the captured graph."""
    import dataclasses

    from repro_torch.core.partition import set_ranges
    from repro_torch.net import device_epoch as de
    from repro_torch.net import topology
    from repro_torch.net.engine import HopSpec

    g = {"single": topology.single_graph(), "leaf_spine": topology.leaf_spine_graph(4),
         "tree": topology.tree_graph(2, 3)}[graph]
    batch = _epoch_batch(rows=rows)
    spec = HopSpec(16, 64, (1 << 15) - 1, set_ranges((1 << 15) - 1, 16, device="cpu"), payload_size=256)
    de.clear_program_cache()
    outs = []
    for _ in range(2):
        de.reset_transfer_counts()
        outs.append(de.run_graph_device(g, batch, spec))
        assert de.TRANSFER_COUNTS == {"to_device": 0, "to_host": 1}
    (prog,) = de._PROGRAM_CACHE.values()
    assert build.graph_kernel_nodes(prog.graph, ["row_sort_kernel"])["row_sort_kernel"] == len(g.nodes)
    cols = [batch.values] + ([batch.flow_id] if g.num_groups > 1 else []) + ([batch.row_index] if rows else [])
    eager = prog.fn(*cols)
    fused, fstats = topology.run_graph(g, batch, dataclasses.replace(spec, ranges=spec.ranges.cuda()), "fused")
    for out, stats in outs:
        assert torch.equal(out.values, eager["vals"]) and torch.equal(out.values, fused.values)
        assert torch.equal(out.seq, fused.seq) and torch.equal(out.segment_id, fused.segment_id)
        assert torch.equal(out.grouped_values, eager["stream"]) and torch.equal(out.run_flags, eager["brk"])
        if rows:
            assert torch.equal(out.row_index, fused.row_index)
        assert stats == fstats
        assert all(torch.equal(a.segment_loads, b.segment_loads.cpu()) for a, b in zip(stats, fstats))
    de.clear_program_cache()


def test_programs_do_not_synchronise(gen):
    """The epoch program and both smoke decode steps, run eagerly on the card
    under ``torch.cuda.set_sync_debug_mode("error")``: no op synchronises."""
    from repro_torch.core.partition import set_ranges
    from repro_torch.net import device_epoch as de
    from repro_torch.net import topology
    from repro_torch.net.engine import HopSpec

    g = topology.tree_graph(2, 3)
    batch = _epoch_batch()
    spec = HopSpec(16, 24, (1 << 15) - 1, set_ranges((1 << 15) - 1, 16, device="cpu"), payload_size=256)
    ns = de._group_sizes(batch, g.num_groups)
    prog = de._epoch_program(g, spec, spec.ranges.numpy(), ns, True, torch.device("cuda"))
    models_ = [_smoke_pair(a)[2] for a in ("mistral-nemo-12b", "granite-moe-3b-a800m")]
    caches = [m.init_cache(2, 16) for m in models_]
    prog.fn(batch.values, batch.flow_id, batch.row_index)  # builds K1 outside the check
    toks = torch.tensor([1, 2], device="cuda")
    for m, c in zip(models_, caches):
        m.decode_step(c, toks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prog.fn(batch.values, batch.flow_id, batch.row_index)
        for m, c in zip(models_, caches):
            m.decode_step(c, toks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    de.clear_program_cache()


def test_epoch_capture_failure_raises(gen):
    """A program that reads the device on the host cannot be captured: the
    call raises, and nothing runs the eager function in its place."""
    from repro_torch.net import device_epoch as de

    def reads_host(x):
        return {"y": x * int(x.sum())}

    prog = de._Program(reads_host, torch.device("cuda"))
    with pytest.raises(RuntimeError):
        prog(torch.arange(8, device="cuda"))
    assert prog.graph is None
