"""The port's CUDA kernels on the card: K1-K6, the attention backward K5b
and RWKV6's WKV forward and backward K7/K7b against their plain torch
versions, the launch counters, a small pipeline against its CPU run, and the
smoke LMs (dense, MoE, RWKV6) served and trained on the card against the
same weights on the CPU.

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
                                "flash_attention": 0, "decode_attention": 0, "flash_attention_bwd": 0,
                                "wkv": 0, "wkv_bwd": 0}
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


def test_flash_attention_bwd_bf16_refuses_unaligned_rows(gen):
    """The bf16 kernel copies 16-byte rows: a q, k, v or dO view whose rows
    start off a 16-byte boundary raises instead of running; f32 takes it."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    lse = torch.zeros(1, 2, 8, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        base = _randn(gen, (1, 8, 2, 65), dtype)
        good = _randn(gen, (1, 8, 2, 64), dtype)
        for i in range(5):  # q, k, v, o, dout: o is read element by element
            args = [good] * 5
            args[i] = base[..., 1:]
            if dtype == torch.bfloat16 and i != 3:
                with pytest.raises(ValueError, match="aligned to 16 bytes"):
                    flash_attention_bwd(*args, lse)
            else:
                flash_attention_bwd(*args, lse)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_nodes_per_call(gen, dtype):
    """One K5b call captured in a CUDA graph is the number of kernels the
    wrapper states."""
    from repro_torch.kernels import flash_attention_bwd as fb

    xs = [_randn(gen, (2, 130, 6, 64), dtype) for _ in range(5)]
    lse = torch.zeros(2, 6, 130, device="cuda")
    assert build.graph_kernel_launches(lambda: fb.flash_attention_bwd(*xs, lse)) == fb.KERNELS_PER_CALL == 3


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,G", [(64, 1), (128, 4), (128, 12)])
def test_decode_attention_lse_equals_plain(gen, d, G, dtype):
    """K6's lse against the plain logsumexp, in the same launch as the
    output: length-0 slots (lse -1e30 + log S, which is -1e30 in f32),
    ragged lengths and a length past S, q and the caches as strided views;
    the output the same bytes as without the lse.  Then the cache cut into
    four chunks with their chunk-local lengths, merged by ``merge_partials``,
    equals the whole cache's attention."""
    from repro_torch.kernels.decode_attention import merge_partials

    B, S, KV = 4, 777, 2
    H = KV * G
    q = _randn(gen, (B, H + 8, d), dtype, QK_SCALE)[:, 4:4 + H]
    stacked = _randn(gen, (3, B + 1, S, 2 * KV, d), dtype, QK_SCALE)
    kc, vc = stacked[1, 1:, :, :KV], stacked[2, 1:, :, KV:]
    lengths = torch.tensor([0, 5, S + 9, 400], dtype=torch.int32, device="cuda")
    bitonic.reset_launches()
    got, lse = decode_attention(q, kc, vc, lengths, return_lse=True)
    assert bitonic.LAUNCHES["decode_attention"] == 1
    want, want_lse = decode_attention_plain(q, kc, vc, lengths, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    assert (lse[0] == -1e30).all()
    assert torch.equal(got, decode_attention(q, kc, vc, lengths))
    _assert_attention_close(got, want)
    chunk = -(-S // 4)
    parts = [decode_attention(q, kc[:, s:s + chunk], vc[:, s:s + chunk],
                              (lengths - s).clamp(0, min(chunk, S - s)).to(torch.int32), return_lse=True)
             for s in range(0, S, chunk)]
    merged = merge_partials(torch.stack([o for o, _ in parts]), torch.stack([lse for _, lse in parts]))
    _assert_attention_close(merged[1:].to(dtype), want[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lse_over_a_cross_chunk_of_375(gen, dtype):
    """whisper-small's cross cache at a tp-4 rank: 1,500 encoder positions
    over four ranks, a chunk of 375 (not a multiple of ``BLOCK_S``), every
    row visible on every rank (a cross step's ``pos`` = S - 1) and 12 query
    heads over 12 kv heads of 64: K6 with its lse against the plain
    version on each chunk, and the four chunks merged by ``merge_partials``
    against the whole cache's attention."""
    from repro_torch.kernels.decode_attention import BLOCK_S, merge_partials

    B, S, H, d, tp = 4, 1500, 12, 64, 4
    chunk = S // tp
    assert chunk % BLOCK_S
    q = _randn(gen, (B, H, d), dtype, QK_SCALE)
    kc = _randn(gen, (B, S, H, d), dtype, QK_SCALE)
    vc = _randn(gen, (B, S, H, d), dtype)
    lengths = torch.full((B,), chunk, dtype=torch.int32, device="cuda")
    parts = []
    for r in range(tp):
        k_r, v_r = kc[:, r * chunk:(r + 1) * chunk], vc[:, r * chunk:(r + 1) * chunk]
        bitonic.reset_launches()
        o, lse = decode_attention(q, k_r, v_r, lengths, return_lse=True)
        assert bitonic.LAUNCHES["decode_attention"] == 1
        po, plse = decode_attention_plain(q, k_r, v_r, lengths, return_lse=True)
        torch.testing.assert_close(lse, plse, atol=2e-5, rtol=0)
        _assert_attention_close(o, po)
        parts.append((o, lse))
    merged = merge_partials(torch.stack([o for o, _ in parts]), torch.stack([lse for _, lse in parts]))
    whole = decode_attention_plain(q, kc, vc, torch.full((B,), S, dtype=torch.int32, device="cuda"))
    _assert_attention_close(merged.to(dtype), whole)


def test_mesh_decode_graph_equals_eager_on_one_rank(gen, tmp_path):
    """The smoke LM on a (1, 1) mesh of a one-rank NCCL group: the engine's
    captured decode step gives the eager step's tokens and the tokens of the
    engine without a mesh."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardCtx

    cfg, _, card = _smoke_pair("mistral-nemo-12b")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        ctx = ShardCtx(mesh=make_mesh((1, 1), ("data", "model")), tp="model", fsdp=None, dp=())
        meshed = models.build(cfg, ctx=ctx, device="cuda")
        meshed.load_state_dict(card.state_dict())
        prompts = [list(range(3 + i, 3 + i + n)) for i, n in enumerate((6, 3, 9, 2))]
        outs = []
        for model, eager in ((meshed, False), (meshed, True), (card, False)):
            eng = Engine(model, slots=3, max_len=64, device="cuda", _eager=eager)
            for i, p in enumerate(prompts):
                eng.add(Request(rid=i, prompt=p, max_tokens=7))
            outs.append(sorted((r.rid, r.out) for r in eng.run()))
        assert outs[0] == outs[1] == outs[2]
    finally:
        dist.destroy_process_group()


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


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m", "zamba2-1.2b"])
def test_decode_graph_tokens_equal_eager_step(gen, arch):
    """The engine's captured decode step against the eager step on the card,
    token for token -- the first request included, so the capture's warm-up
    step is undone -- and the cache tensors are never rebound (the hybrid's
    conv and ssm states are written in place by the graph, its shared
    block's k/v by K6's step)."""
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


def test_faulted_tree_equals_fault_free_and_torch_sort(gen):
    """A dead interior hop, a degraded leaf and a mid-stream shard failover
    on the 7-hop tree with arena servers, on the card: the output equals the
    fault-free run's, torch.sort's and the same plan on the CPU; K1 runs on
    the five sorting hops and K2 in the arena merges, the adopter's
    re-ingest included."""
    vals = torch.from_numpy(random_trace(60_000, seed=4)).cuda()
    kw = dict(topology="tree", branching=2, height=3, num_segments=16, segment_length=64,
              payload_size=256, num_flows=8, range_mode="oracle", num_servers=4,
              merge_backend="arena", max_value=int(vals.max()))
    free = run_pipeline(vals, device="cuda", **kw)
    plan = "crash:l1n0@0;degrade:l0n2@0;server_crash:1@0.5"
    bitonic.reset_launches()
    res = run_pipeline(vals, fault_plan=plan, device="cuda", **kw)
    launches = dict(bitonic.LAUNCHES)
    host = run_pipeline(vals.cpu(), fault_plan=plan, device="cpu", **kw)
    assert torch.equal(res.output, torch.sort(vals).values)
    assert torch.equal(res.output, free.output) and torch.equal(res.output.cpu(), host.output)
    assert res.passes == host.passes
    assert (res.fault_hops_dead, res.fault_hops_degraded, res.servers_failed_over) == (1, 1, 1)
    assert launches["row_sort"] == 5 and launches["tournament"] >= 1
    assert res.server_keys[1] == 0 and sum(res.server_keys) == vals.numel()


def test_device_engine_fault_fallback_stays_on_the_card(gen):
    vals = torch.from_numpy(random_trace(40_000, seed=5)).cuda()
    kw = dict(topology="tree", branching=2, height=3, num_segments=16, segment_length=64,
              payload_size=256, num_flows=8, range_mode="oracle", max_value=int(vals.max()),
              engine="device")
    from repro_torch.obs import MetricsRegistry

    metrics = MetricsRegistry()
    res = run_pipeline(vals, fault_plan="degrade:l1n1@0", metrics=metrics, device="cuda", **kw)
    assert res.output.device.type == "cuda"
    assert torch.equal(res.output, torch.sort(vals).values)
    assert metrics.counter("fault_device_fallbacks").value == 1


def test_segment_engine_launches_k1_once_per_nonempty_segment(gen):
    """The segment engine's per-segment block sort: one K1 launch for every
    segment that received keys, a non-power-of-two width padded; its wire
    equals the fused engine's byte for byte."""
    from repro_torch.core.partition import set_ranges
    from repro_torch.net import engine, flow

    vals = torch.from_numpy(random_trace(100_000, seed=6)).cuda()
    batch = flow.interleave_batch(flow.split_flows(vals, 8, 64), "round_robin")
    maxv = int(vals.max())
    for length in (64, 48):
        spec = engine.HopSpec(64, length, maxv, set_ranges(maxv, 64, device="cuda"), payload_size=64)
        fused, fst = engine.run_hop(batch, spec, "hop", "fused")
        bitonic.reset_launches()
        seg, sst = engine.run_hop(batch, spec, "hop", "segment")
        nonempty = int((sst.segment_loads > 0).sum())
        assert bitonic.LAUNCHES["row_sort"] == nonempty > 0
        for col in ("values", "seq", "segment_id"):
            assert torch.equal(getattr(seg, col), getattr(fused, col)), (length, col)
        assert torch.equal(sst.ship_emission, fst.ship_emission)


def test_packed_tenants_beyond_int32_sort_on_the_int64_path(gen, monkeypatch):
    """A packed round of four tenants whose shifted keys pass int32: one K1
    launch, on int64 keys, and every tenant equals its solo run."""
    from repro_torch.net import scheduler

    seen = []
    orig = bitonic.sort_rows

    def spy(x):
        seen.append(x.dtype)
        return orig(x)

    monkeypatch.setattr(bitonic, "sort_rows", spy)
    maxv = (1 << 30) - 1
    jobs = [scheduler.Job(t, np.random.default_rng(t).integers(0, maxv + 1, 50_000), seed=t,
                          range_mode="oracle", max_value=maxv) for t in range(4)]
    fabric = dict(num_segments=16, segment_length=64, payload_size=64)
    bitonic.reset_launches()
    res = scheduler.run_jobs([scheduler.Job(**vars(j)) for j in jobs], device="cuda", **fabric)
    assert res.packed_calls == 1 and seen == [torch.int64] and bitonic.LAUNCHES["row_sort"] == 1
    for j in jobs:
        solo = scheduler.run_job_solo(j, device="cuda", **fabric)
        jr = res.by_tenant(j.tenant_id)
        assert torch.equal(jr.output, solo.output) and jr.passes == solo.passes
        assert torch.equal(jr.output, torch.sort(j.values.cuda()).values)


# -- training: K5's lse, K5b, a smoke train step ---------------------------------------


def _grad_limit(want):
    """|K5b - plain| per element: both multiply in f32 and sum in other
    orders, then round once to the input's type.  f32: 2e-5 of the largest
    |want| + 1e-3 |want|; bf16: 4e-3 of the largest + 1e-2 |want|; both plus
    1e-5, since a gradient that is exactly 0 (one visible key) is rounding
    noise of order 1e-7 on each side (chip_smoke.grad_limit)."""
    w = want.float().abs()
    if want.dtype == torch.bfloat16:
        return 1e-5 + 4e-3 * w.max() + 1e-2 * w
    return 1e-5 + 2e-5 * w.max() + 1e-3 * w


def _check_k5b(gen, B, T, S, H, KV, d, dtype, causal, strided_do=False):
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_plain

    q = _randn(gen, (B, T, H, d), dtype, QK_SCALE)
    k = _randn(gen, (B, S, KV, d), dtype, QK_SCALE)
    v = _randn(gen, (B, S, KV, d), dtype)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    do = _randn(gen, (B, H, T, d), dtype).transpose(1, 2) if strided_do else _randn(gen, (B, T, H, d), dtype)
    bitonic.reset_launches()
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert bitonic.LAUNCHES["flash_attention_bwd"] == 1
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous(), name
        diff = (g.float() - w.float()).abs()
        assert (diff <= _grad_limit(w)).all(), (name, diff.max().item(), w.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,S", [(1, 1), (63, 63), (130, 130), (2048, 2048), (63, 130), (130, 63), (1, 2048)])
def test_flash_attention_bwd_kernel_equals_plain(gen, T, S, causal, d, dtype):
    """K5b against its plain twin at G = 1, 3 and 4, B = 2."""
    for G in (1, 3, 4):
        _check_k5b(gen, 2, T, S, 2 * G, 2, d, dtype, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("T,S,off", [(70, 300, 0), (70, 300, 64), (70, 300, 100), (70, 300, 230), (64, 4096, 512),
                                     (1, 130, 129), (130, 2048, 1000)])
def test_flash_attention_and_bwd_with_q_offset_equal_plain(gen, T, S, off, d, dtype):
    """Context parallelism's query offset: K5 (output and lse) and K5b at
    offsets that are and are not multiples of the 64-row tile, ragged T,
    offset + T below and at S, against the plain versions; dk and dv of the
    keys no row sees are exactly 0."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_plain

    B, H, KV = 2, 6, 2
    q = _randn(gen, (B, T, H, d), dtype, QK_SCALE)
    k = _randn(gen, (B, S, KV, d), dtype, QK_SCALE)
    v = _randn(gen, (B, S, KV, d), dtype)
    do = _randn(gen, (B, T, H, d), dtype)
    o, lse = flash_attention(q, k, v, return_lse=True, q_offset=off)
    po, plse = flash_attention_plain(q, k, v, return_lse=True, q_offset=off)
    _assert_attention_close(o, po)
    assert (lse - plse).abs().max().item() <= (2.0**-8 if dtype == torch.bfloat16 else 2e-5)
    got = flash_attention_bwd(q, k, v, o, do, lse, q_offset=off)
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, q_offset=off)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        assert (diff <= _grad_limit(w)).all(), (name, diff.max().item())
    assert not got[1][:, off + T:].any() and not got[2][:, off + T:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q_offset_zero_is_the_same_bytes_as_none(gen, dtype):
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    q, k, v, do = (_randn(gen, (2, 300, 8, 64), dtype, QK_SCALE) for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    o, lse = flash_attention(q, k, v, return_lse=True)
    o0, lse0 = flash_attention(q, k, v, return_lse=True, q_offset=0)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    for a, b in zip(flash_attention_bwd(q, k, v, o, do, lse), flash_attention_bwd(q, k, v, o, do, lse, q_offset=0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_takes_a_strided_dout(gen, dtype):
    """dO as a transposed (B, H, T, d) view: rows strided, last axis
    contiguous, read in place."""
    _check_k5b(gen, 2, 300, 300, 6, 2, 64, dtype, True, strided_do=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,d,causal", [
    (4, 2048, 2048, 24, 8, 64, True), (1, 130, 7, 6, 2, 32, False), (2, 63, 2048, 8, 2, 128, False),
    (3, 1, 1, 4, 4, 64, True)])
def test_flash_attention_lse_and_unchanged_output(gen, B, T, S, H, KV, d, causal, dtype):
    """K5 with ``return_lse``: the output is the same bytes as without it,
    and the lse is the plain logsumexp (f32 within 2e-5; bf16 within 2^-8:
    the kernel sums its probabilities as rounded to bf16)."""
    q = _randn(gen, (B, T, H, d), dtype, QK_SCALE)
    k = _randn(gen, (B, S, KV, d), dtype, QK_SCALE)
    v = _randn(gen, (B, S, KV, d), dtype)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v, causal=causal))
    _, want = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    assert (lse - want).abs().max().item() <= (2.0**-8 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_smoke_train_steps_on_card_equal_cpu(gen, arch):
    """Three AdamW steps of the float32 smoke LM on the card and on the CPU
    from the same weights and batches: losses and gradient norms within
    1e-5 relative (the card's atomic adds and its own GEMM orders); each
    parameter within 2 lr per step, the most an element can move apart when
    a gradient that is zero to rounding takes the other sign on one side
    (AdamW's first steps move every element by about lr, whatever its
    gradient's size); K5, K5b and K3 launch as the step implies."""
    import dataclasses

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0)).requires_grad_(True)
    card = models.build(cfg, device="cuda").requires_grad_(True)
    card.load_state_dict(host.state_dict())
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    n_moe = cfg.num_layers - (cfg.moe.first_dense_layers if cfg.moe else cfg.num_layers)
    runs = []
    for model in (host, card):
        step = build_train_step(model, opt_cfg)
        state = init_opt_state(dict(model.named_parameters()), opt_cfg)
        pipe, out = TokenPipeline(cfg.vocab_size, 4, 64, seed=0), []
        for _ in range(3):
            batch = {k: torch.from_numpy(v).to(model.device) for k, v in pipe.next_batch().items()}
            bitonic.reset_launches()
            state, met = step(state, batch)
            out.append((float(met["loss"]), float(met["grad_norm"])))
            if model is card:
                assert bitonic.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
                assert bitonic.LAUNCHES["flash_attention_bwd"] == cfg.num_layers
                assert bitonic.LAUNCHES["row_sort_kv"] == 2 * n_moe
        runs.append(out)
    np.testing.assert_allclose(np.array(runs[1]), np.array(runs[0]), rtol=1e-5)
    for (name, a), b in zip(card.named_parameters(), host.parameters()):
        diff = (a.detach().cpu() - b.detach()).abs().max().item()
        assert diff <= 2 * opt_cfg.lr * 3, (name, diff)


@pytest.fixture
def nccl(gen, tmp_path):
    """A one-rank NCCL process group (a ``file://`` rendezvous), destroyed
    after the test."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,block", [(1_000_003, 256), (100_001, 96), (65_537, 100), (300_007, 4096),
                                     (20_011, 5000), (77_777, None)])
def test_sort_sharded_one_rank_nccl_equals_torch_sort(gen, nccl, n, block, dtype):
    """``sort_sharded`` at one NCCL rank: lengths and presort blocks that do
    not divide evenly (a width that is not a power of two is padded on K1;
    one past ``MAX_ROW`` goes to ``torch.sort``) give ``torch.sort``, every
    key valid, nothing dropped, K1 launched once where the block is its."""
    from repro_torch.core import distributed as cd
    from repro_torch.distributed.compat import make_mesh

    mesh = make_mesh((1,), ("segment",))
    x = torch.randint(-(1 << 30), 1 << 30, (n,), dtype=dtype, device="cuda", generator=gen)
    bitonic.reset_launches()
    padded, valid, overflow = cd.sort_sharded(x, mesh, "segment", [], capacity_factor=1.5, presort_block=block)
    assert bitonic.LAUNCHES["row_sort"] == (1 if block is not None and block <= bitonic.MAX_ROW else 0)
    assert int(valid) == n and int(overflow) == 0
    assert torch.equal(padded[:n], torch.sort(x).values)
    assert bool((padded[n:] == torch.iinfo(dtype).max).all())
    if block is not None:
        assert padded.numel() % block == 0


def test_moe_layer_a2a_at_tp1_equals_moe_layer(nccl):
    """``moe_layer_a2a`` on a one-rank (1, 1) NCCL mesh against ``moe_layer``
    on the same f32 smoke weights: output, aux and dropped within 1e-5 (the
    returned rows are added in another order); every gradient of
    ``sum(y^2) + aux`` within 2^-7 of its largest magnitude, since the a2a's
    cotangents cross the fabric in bf16 as the reference's do (``_a2a_bf16``;
    2^-9 on the CPU); K3 twice a call."""
    import dataclasses

    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models.lm import init_params

    for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b"):
        cfg = configs.get_smoke_config(arch)
        p = init_params(moe.MoE(cfg, torch.float32, "cuda"), torch.Generator(device="cuda").manual_seed(0))
        p.requires_grad_(True)
        ctx = dataclasses.replace(sharding.local_ctx("cuda"), sp=True)
        x = torch.randn((2, 64, cfg.d_model), device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
        runs = []
        for fn in (lambda xi: moe.moe_layer_a2a(p, cfg, ctx, xi), lambda xi: moe.moe_layer(p, cfg, xi)):
            p.zero_grad(set_to_none=True)
            xi = x.clone().requires_grad_(True)
            bitonic.reset_launches()
            y, aux, dropped = fn(xi)
            runs.append((bitonic.LAUNCHES["row_sort_kv"], y.detach(), float(aux.detach()), int(dropped)))
            (y.square().sum() + aux).backward()
            runs[-1] += ({"x": xi.grad, **{k: v.grad for k, v in p.named_parameters()}},)
        (ka, ya, auxa, da, ga), (kb, yb, auxb, db, gb) = runs
        assert (ka, kb) == (2, 1)
        assert da == db and abs(auxa - auxb) <= 1e-6 * abs(auxb)
        torch.testing.assert_close(ya, yb, atol=1e-5, rtol=1e-5)
        for k in gb:
            assert (ga[k] - gb[k]).abs().max() <= 2**-7 * gb[k].abs().max(), (arch, k)


# -- RWKV6's WKV: K7 and K7b ------------------------------------------------------------------


def _wkv_inputs(gen, B, T, H, N=64):
    """r, k, v, dy unit normals, decays exp(-exp(w)) for w on [-8, 3], u and
    s0 nonzero (``chip_smoke.wkv_inputs``)."""
    from repro_torch.kernels import wkv

    r, k, v, dy = (torch.randn(B, T, H, N, generator=gen, device="cuda") for _ in range(4))
    w = torch.exp(-torch.exp(torch.rand(B, T, H, N, generator=gen, device="cuda") * 11 - 8))
    u = torch.randn(H, N, generator=gen, device="cuda")
    s0 = torch.randn(B, H, N, N, generator=gen, device="cuda") * 0.5
    return wkv, (r, k, v, w, u, s0), dy


def _wkv_close(got, want):
    """``chip_smoke.wkv_limit``: 1e-5 + 1e-5 max|want| + 1e-4 |want|."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs().max() + 1e-4 * want.abs()).all()


@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (1, 7, 1), (1, 64, 1), (2, 1, 3), (2, 7, 3), (2, 64, 3),
                                   (3, 37, 5), (1, 1963, 32), (2, 100, 3), (3, 65, 25), (4, 2048, 32)])
def test_wkv_kernels_equal_plain(gen, B, T, H):
    """K7 and K7b against their plain versions at the ``k7`` phase's shapes:
    the small ones (T 1: the single-step kernel), the ragged ones (T off the
    16-step chunk and the 32- and 4-step checkpoint intervals) and the
    training shape last (the wide configuration); one launch each a call (K7b's ``LAUNCHES`` counts
    calls: two passes a call)."""
    wkv, ins, dy = _wkv_inputs(gen, B, T, H)
    build.reset_launches()
    for g, w in zip(wkv.wkv(*ins), wkv.wkv_plain(*ins)):
        _wkv_close(g, w)
    for g, w in zip(wkv.wkv_bwd(*ins, dy), wkv.wkv_bwd_plain(*ins, dy)):
        _wkv_close(g, w)
    assert build.LAUNCHES["wkv"] == 1 and build.LAUNCHES["wkv_bwd"] == 1


def test_wkv_in_place_on_a_cache_slice_and_the_stride_check(gen):
    """K7 at T 1 in place on a layer's slice and on a slot's slice of a
    stacked (L, B, H, 64, 64) cache: the plain version's y and state, the
    other slices untouched; an r whose last axis is not contiguous raises."""
    wkv, _, _ = _wkv_inputs(gen, 1, 1, 1)
    cache = torch.randn(5, 4, 32, 64, 64, generator=gen, device="cuda")
    for index, B in (((2,), 4), ((3, slice(1, 2)), 1)):
        _, (r, k, v, w, u, _), _ = _wkv_inputs(gen, B, 1, 32)
        before = cache.clone()
        want_y, want_s = wkv.wkv_plain(r, k, v, w, u, cache[index].clone())
        y, s = wkv.wkv(r, k, v, w, u, cache[index], in_place=True)
        assert s.data_ptr() == cache[index].data_ptr()
        _wkv_close(y, want_y)
        _wkv_close(cache[index], want_s)
        before[index] = cache[index]
        assert torch.equal(before, cache)
    _, (r, k, v, w, u, s0), _ = _wkv_inputs(gen, 2, 5, 3)
    with pytest.raises(ValueError, match="last axis contiguous"):
        wkv.wkv(r.transpose(1, 3).contiguous().transpose(1, 3), k, v, w, u, s0)


def test_wkv_bwd_same_bytes_and_two_kernels_a_call(gen):
    """Two K7b calls at the training shape give the same bytes (no float
    atomics, fixed summation orders), and a captured call holds each of the
    plan's two passes once."""
    wkv, ins, dy = _wkv_inputs(gen, 4, 2048, 32)
    first = wkv.wkv_bwd(*ins, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, wkv.wkv_bwd(*ins, dy)))
    passes = [p.kernel for p in wkv.launch_plan(4, 2048, 32).backward]
    graph, _ = build.capture(lambda: wkv.wkv_bwd(*ins, dy))
    nodes = build.graph_kernel_nodes(graph, passes)
    assert [nodes[p] for p in passes] == [1, 1] and len(passes) == wkv.KERNELS_PER_CALL


def test_wkv_function_gradients_equal_plain_autograd(gen):
    """``WKVFn`` (K7 forward, K7b backward) against autograd through the
    plain loop: every input's gradient."""
    from repro_torch.models.rwkv6 import WKVFn

    wkv, (r, k, v, w, u, s0), dy = _wkv_inputs(gen, 2, 40, 3)
    grads = []
    for fn in (lambda *a: WKVFn.apply(*a, s0)[0], lambda *a: wkv.wkv_plain(*a, s0)[0]):
        leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, dy))
    for g, want in zip(*grads):
        _wkv_close(g, want)


def test_rwkv_smoke_decode_graph_launches_k7_once_a_layer(gen):
    """rwkv6's smoke LM (f32) on the card: its decode step captured in a CUDA
    graph holds one K7 node a layer, and the graph's logits and cache equal
    the eager step's and the CPU's."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_smoke_config("rwkv6-1.6b"), dtype="float32")
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (3, 9), generator=torch.Generator().manual_seed(1))
    hc, cc = host.init_cache(3, 16), card.init_cache(3, 16)
    host.prefill(toks, hc)
    card.prefill(toks.cuda(), cc)
    step_tok = torch.zeros(3, dtype=torch.int64, device="cuda")
    graph, (logits, _) = build.capture(lambda: card.decode_step(cc, step_tok))
    assert build.graph_kernel_nodes(graph, ["wkv_forward"])["wkv_forward"] == cfg.num_layers
    # the capture's warm-up ran one real step: replay the same on the CPU
    want, hc = host.decode_step(hc, torch.zeros(3, dtype=torch.int64))
    nxt = want.argmax(-1)
    step_tok.copy_(nxt)
    graph.replay()
    want, hc = host.decode_step(hc, nxt)
    torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
    for name in hc:
        torch.testing.assert_close(cc[name].cpu(), hc[name], atol=1e-4, rtol=1e-4)


# -- the encoder-decoder and the embeddings inputs: GQA group 7, cross shapes --------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,d,causal", [
    (1, 576, 576, 56, 8, 128, True),    # llava-next-34b: one 576-row tile, G 7
    (2, 130, 130, 14, 2, 64, True), (2, 63, 130, 7, 1, 32, False),
    (2, 100, 1500, 12, 12, 64, False),  # whisper-small's cross-attention: T rows against 1,500 frames
])
def test_gqa_group_seven_and_cross_lengths_k5_and_k5b(gen, B, T, S, H, KV, d, causal, dtype):
    """K5 (output) and K5b against their plain versions at G 7 (llava's 56
    query heads over 8) and at whisper's non-causal T != S."""
    q = _randn(gen, (B, T, H, d), dtype, QK_SCALE)
    k = _randn(gen, (B, S, KV, d), dtype, QK_SCALE)
    v = _randn(gen, (B, S, KV, d), dtype)
    _assert_attention_close(flash_attention(q, k, v, causal=causal), flash_attention_plain(q, k, v, causal=causal))
    _check_k5b(gen, B, T, S, H, KV, d, dtype, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,d,full", [(4, 4096, 56, 8, 128, False), (3, 999, 14, 2, 64, False),
                                             (4, 1500, 12, 12, 64, True), (2, 1500, 7, 1, 32, True)])
def test_gqa_group_seven_and_cross_lengths_k6(gen, B, S, H, KV, d, full, dtype):
    """K6 at G 7 and at whisper's cross-attention cache (1,500 frames, which
    K6's 128-row blocks do not divide), every position visible (``full``)
    or ragged lengths, the last layer's slice of stacked caches."""
    q = _randn(gen, (B, H, d), dtype, QK_SCALE)
    kc = _randn(gen, (2, B, S, KV, d), dtype, QK_SCALE)[1]
    vc = _randn(gen, (2, B, S, KV, d), dtype)[1]
    if full:
        lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
    else:
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    _assert_attention_close(decode_attention(q, kc, vc, lengths), decode_attention_plain(q, kc, vc, lengths))


@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-34b"])
def test_embeddings_models_decode_graph_equals_eager_and_cpu(gen, arch):
    """The smoke encoder-decoder (2 rows of 37 frames, a 4-token prompt) and
    the smoke embeddings LM (2 x 9 embedding rows, 14 heads of 32 over 2:
    G 7) in float32: prefill on the
    card against the CPU, then the decode step captured into a CUDA graph
    (its warm-up step undone by zeroing the cache) replayed six times against
    the eager step, token for token; the graph holds one K6 node an
    attention of the step (the encoder-decoder's self and cross) and no
    K5."""
    import dataclasses

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    if not cfg.is_encdec:  # llava's smoke heads of 16: K5 takes 32, 64, 128 (and llava's G 7)
        cfg = dataclasses.replace(cfg, num_heads=14, num_kv_heads=2, head_dim=32)
    host = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = models.build(cfg, device="cuda")
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(2)
    if cfg.is_encdec:
        prompt = {"enc_embeds": torch.from_numpy(rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)),
                  "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 4)))}
    else:
        prompt = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32))

    def cache_of(model):
        return model.init_cache(2, 16, 37) if cfg.is_encdec else model.init_cache(2, 16)

    def on(dev):
        return {k: v.to(dev) for k, v in prompt.items()} if cfg.is_encdec else prompt.to(dev)

    want, _ = host.prefill(on("cpu"), cache_of(host))
    outs = []
    for graph in (False, True):
        cache = cache_of(card)
        tok = torch.zeros(2, dtype=torch.int64, device="cuda")
        if graph:
            g, (buf, _) = build.capture(lambda: card.decode_step(cache, tok))
            nodes = build.graph_kernel_nodes(g, ["decode_partial", "flash_fwd"])
            k6 = 2 * cfg.num_layers if cfg.is_encdec else cfg.num_layers
            assert nodes["decode_partial"] == k6 and nodes["flash_fwd"] == 0
            for leaf in cache.values():
                leaf.zero_()
        logits, _ = card.prefill(on("cuda"), cache)
        torch.testing.assert_close(logits.cpu(), want, atol=1e-4, rtol=1e-4)
        seq = []
        for _ in range(6):
            tok.copy_(logits.argmax(-1))
            seq.append(tok.cpu())
            if graph:
                g.replay()
                logits = buf
            else:
                logits, _ = card.decode_step(cache, tok)
        outs.append(torch.stack(seq))
    assert torch.equal(outs[0], outs[1])
