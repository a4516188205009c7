"""The multi-pod dry run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``: the sharding decisions of every (arch,
shape, mesh) cell, each kernel's shape-only stand-in on the meta device and
its counted work, and a train step's folded microbatches.

The reference's decisions run on a ``jax.sharding.AbstractMesh``; its module
sets ``XLA_FLAGS`` on import, so JAX's backends start first and the variable
is restored (:func:`ref_dryrun`).  The port's run on a fake process group of
256 or 512 ranks (:func:`repro_torch.launch.dryrun.fake_world`)."""

import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

ARCHS = ["command-r-plus-104b", "deepseek-moe-16b", "granite-moe-3b-a800m", "llava-next-34b",
         "mistral-nemo-12b", "nemotron-4-340b", "rwkv6-1.6b", "starcoder2-15b", "whisper-small", "zamba2-1.2b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MESHES = {"single_pod": ((16, 16), ("data", "model")), "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def ref_dryrun():
    """``repro.launch.dryrun``, imported without its ``XLA_FLAGS`` reaching
    this process's JAX (its backends already started) or any later test."""
    import jax

    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return rd


def _fsdp(x):
    return tuple(x) if isinstance(x, (tuple, list)) else x


@pytest.fixture(scope="module")
def decisions():
    """(mesh, arch, shape) -> (dp, fsdp, sp, microbatches) of both packages."""
    from jax.sharding import AbstractMesh

    from repro import configs as ref_configs
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    rd = ref_dryrun()
    out = {}
    for name, (dims, axes) in MESHES.items():
        ref_mesh = AbstractMesh(dims, axes)
        with dryrun.fake_world(int(np.prod(dims))):
            mesh = make_production_mesh(multi_pod=name == "multi_pod", device_type="cpu")
            assert dryrun.mesh_shape(mesh) == dict(zip(axes, dims))
            for arch in ARCHS:
                for shape in SHAPES:
                    s = dryrun.SHAPES[shape]
                    assert s == rd.SHAPES[shape]
                    got = []
                    for mod, m, cfg in ((dryrun, mesh, configs.get_config(arch)),
                                        (rd, ref_mesh, ref_configs.get_config(arch))):
                        ctx = mod.build_ctx(m, s["batch"], s["seq"], s["kind"])
                        got.append((tuple(ctx.dp), _fsdp(ctx.fsdp), ctx.sp,
                                    mod.pick_microbatches(cfg, s["batch"], s["seq"], ctx)))
                    out[name, arch, shape] = got
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharding_decisions_match_the_reference(decisions, mesh, arch, shape):
    port, ref = decisions[mesh, arch, shape]
    assert port == ref


def test_tables_match_the_reference():
    from repro_torch.launch import dryrun

    rd = ref_dryrun()
    assert dryrun.SHAPES == rd.SHAPES
    assert dryrun.LONG_OK == rd.LONG_OK
    assert dryrun.BF16_MOMENT_ARCHS == rd.BF16_MOMENT_ARCHS


# -- the kernels' stand-ins -------------------------------------------------------------


def _meta(*ts):
    return [t.to("meta") for t in ts]


def _counted(fn, *args, **kw):
    """``fn`` on meta copies of ``args``: (outputs, the counter's result)."""
    from repro_torch.obs import costs

    margs = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with costs.count() as c:
        out = fn(*margs, **kw)
    return out, c.result(out)


def _same_layout(meta_out, plain_out):
    meta_out = meta_out if isinstance(meta_out, tuple) else (meta_out,)
    plain_out = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    assert len(meta_out) == len(plain_out)
    for m, p in zip(meta_out, plain_out):
        assert m.device.type == "meta"
        assert (tuple(m.shape), m.dtype) == (tuple(p.shape), p.dtype)


def _pairs(t, s, causal, off):
    """Visible (row, key) pairs by brute force."""
    if not causal:
        return t * s
    return int(((off + torch.arange(t))[:, None] >= torch.arange(s)[None, :]).sum())


K5_CASES = [  # B, T, S, H, KV, d, causal, q_offset, return_lse, dtype
    (2, 5, 5, 4, 2, 32, True, 0, False, torch.float32),
    (1, 3, 7, 4, 4, 32, True, 2, True, torch.float32),
    (2, 3, 7, 6, 2, 64, False, 0, True, torch.bfloat16),
    (1, 6, 4, 2, 1, 32, True, 0, True, torch.float32),
    (1, 4, 9, 2, 2, 32, True, 9, False, torch.float32),
    (1, 5, 5, 6, 1, 192, True, 0, True, torch.bfloat16),  # nemotron-4-340b's head dim
]


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_and_k5b_stand_ins(case):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    B, T, S, H, KV, d, causal, off, lse, dt = case
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, n, h, d, generator=g).to(dt) for n, h in ((T, H), (S, KV), (S, KV)))
    kw = dict(causal=causal, q_offset=off)
    plain = flash_attention(q, k, v, return_lse=lse, **kw)
    out, got = _counted(flash_attention, q, k, v, return_lse=lse, **kw)
    _same_layout(out, plain)
    pairs, size = _pairs(T, S, causal, off), q.element_size()
    assert got["flops"] == 4 * B * H * d * pairs
    assert got["bytes"] == (2 * B * T * H * d + 2 * B * S * KV * d) * size + (4 * B * H * T if lse else 0)
    assert got["kernels"]["flash_attention"]["calls"] == 1

    o, lse_t = flash_attention(q, k, v, return_lse=True, **kw)
    dout = torch.randn(o.shape, generator=g).to(dt)
    plain = flash_attention_bwd(q, k, v, o, dout, lse_t, **kw)
    out, got = _counted(flash_attention_bwd, q, k, v, o, dout, lse_t, **kw)
    _same_layout(out, plain)
    assert got["flops"] == 10 * B * H * d * pairs
    assert got["bytes"] == (4 * B * T * H * d + 4 * B * S * KV * d) * size + 4 * B * H * T


@pytest.mark.parametrize("lse", [False, True])
def test_k6_stand_in_and_merge_on_meta(lse):
    from repro_torch.kernels.decode_attention import decode_attention, merge_partials

    B, S, H, KV, d = 3, 11, 4, 2, 32
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, H, d, generator=g)
    kc, vc = (torch.randn(B, S, KV, d, generator=g) for _ in range(2))
    lengths = torch.tensor([0, 5, 11], dtype=torch.int32)
    plain = decode_attention(q, kc, vc, lengths, return_lse=lse)
    out, got = _counted(decode_attention, q, kc, vc, lengths, return_lse=lse)
    _same_layout(out, plain)
    assert got["flops"] == 4 * B * H * d * S  # every cache position: the lengths are data
    assert got["bytes"] == (2 * B * S * KV * d + 2 * B * H * d) * 4 + 4 * B + (4 * B * H if lse else 0)
    if lse:
        outs, lses = torch.stack([plain[0]] * 2), torch.stack([plain[1]] * 2)
        merged = merge_partials(*_meta(outs, lses))
        _same_layout(merged, merge_partials(outs, lses))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [2, 64, 1024])
def test_k3_stand_in_counts_the_network(n, dtype):
    from repro_torch.kernels.bitonic import sort_rows_kv

    rows = 3
    keys = torch.randint(0, 50, (rows, n), dtype=dtype)
    vals = torch.arange(rows * n, dtype=torch.int32).reshape(rows, n)
    plain = sort_rows_kv(keys, vals)
    out, got = _counted(sort_rows_kv, keys, vals)
    _same_layout(out, plain)
    s = int(np.log2(n))
    entry = got["kernels"]["row_sort_kv"]
    assert entry["compare_exchanges"] == rows * (n // 2) * s * (s + 1) // 2
    assert entry["ops"] == entry["compare_exchanges"] * (4 if dtype == torch.int32 else 8)
    assert got["flops"] == 0 and got["bytes"] == 2 * rows * n * (keys.element_size() + 4)


@pytest.mark.parametrize("in_place", [False, True])
def test_k7_and_k7b_stand_ins(in_place):
    from repro_torch.kernels.wkv import wkv, wkv_bwd

    B, T, H, N = 2, 3, 2, 64
    g = torch.Generator().manual_seed(2)
    r, k, v, w = (torch.rand(B, T, H, N, generator=g) for _ in range(4))
    u = torch.rand(H, N, generator=g)
    s0 = torch.rand(B, H, N, N, generator=g)
    plain = wkv(r, k, v, w, u, s0.clone(), in_place=in_place)
    ms0 = s0.to("meta")
    from repro_torch.obs import costs

    with costs.count() as c:
        out = wkv(*_meta(r, k, v, w, u), ms0, in_place=in_place)
    got = c.result(out)
    _same_layout(out, plain)
    assert (out[1] is ms0) == in_place
    assert got["flops"] == 5 * B * T * H * N * N
    dy = torch.rand(B, T, H, N, generator=g)
    plain = wkv_bwd(r, k, v, w, u, s0, dy)
    out, got = _counted(wkv_bwd, r, k, v, w, u, s0, dy)
    _same_layout(out, plain)
    assert got["flops"] == 14 * B * T * H * N * N


def _aligned(shape, dt, dev):
    return torch.randn(shape).to(dt).to(dev)


def _misaligned(shape, dt, dev):
    """A view of ``shape`` on ``dev`` whose rows are not 16-byte aligned
    (one more element a row underneath)."""
    return torch.randn(*shape[:-1], shape[-1] + 1).to(dt).to(dev)[..., :shape[-1]]


def _refused_calls():
    """(name, call on tensors of one device, the error's text): what the
    card's kernels refuse beyond the shape checks every device makes."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.kernels.wkv import wkv, wkv_bwd

    bf, f32 = torch.bfloat16, torch.float32

    def k5(d, dt, make=_aligned):
        return lambda dev: flash_attention(*(make((1, 4, 2, d), dt, dev) for _ in range(3)))

    def k5b(d, dt):
        def call(dev):
            q = torch.randn(1, 4, 2, d).to(dt).to(dev)
            return flash_attention_bwd(q, q, q, q, q, torch.zeros(1, 2, 4, device=dev))
        return call

    def k6(d, dt, make=_aligned):
        return lambda dev: decode_attention(make((2, 2, d), dt, dev), *(make((2, 5, 1, d), dt, dev)
                                                                         for _ in range(2)),
                                            torch.full((2,), 5, dtype=torch.int32, device=dev))

    def k7(n, bwd):
        def call(dev):
            seq = [torch.rand(1, 2, 1, n, device=dev) for _ in range(5)]
            u, s0 = torch.rand(1, n, device=dev), torch.rand(1, 1, n, n, device=dev)
            return wkv_bwd(*seq[:4], u, s0, seq[4]) if bwd else wkv(*seq[:4], u, s0)
        return call

    return [
        ("k5_head_dim_96", k5(96, bf), "head dims"),
        ("k5_head_dim_192_f32", k5(192, f32), "head dims"),
        ("k5_rows_misaligned", k5(32, bf, _misaligned), "aligned to 16 bytes"),
        ("k5b_head_dim_48", k5b(48, bf), "head dims"),
        ("k6_head_dim_16", k6(16, bf), "head dims"),
        ("k6_rows_misaligned", k6(32, bf, _misaligned), "aligned to 16 bytes"),
        ("k7_head_size_32", k7(32, False), "head sizes"),
        ("k7b_head_size_32", k7(32, True), "head sizes"),
    ]


@pytest.mark.parametrize("case", range(8))
def test_a_stand_in_refuses_what_the_card_refuses(case):
    """On the meta device a kernel's wrapper refuses what its CUDA dispatch
    refuses (a head dim or size no kernel is built for, rows its 16-byte
    copies cannot take), so the dry run never reports a cell that the card
    cannot run; on the CPU the plain version takes the same call."""
    from repro_torch.obs import costs

    name, call, text = _refused_calls()[case]
    call("cpu")
    with costs.count(), pytest.raises(ValueError, match=text):
        call("meta")


def test_a_kernel_counts_nothing_without_a_counter_and_its_plain_ops_are_not_counted():
    """Off a counter the wrapper runs as it is; under one, on the CPU, its
    plain version's ops are not counted, its closed form is."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.obs import costs

    q = torch.randn(1, 4, 2, 8)
    assert costs._ACTIVE is None
    want = flash_attention(q, q, q)
    with costs.count() as c:
        got = flash_attention(q, q, q)
    assert torch.equal(got, want)
    assert c.result()["flops"] == 4 * 2 * 8 * 10


# -- folded microbatches ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-1.2b"])
def test_folded_microbatches_count_as_the_full_step(arch):
    """A train step of 4 microbatches on the meta device counted from its
    first (``fold_repeats``, as the dry run counts it) equals the step
    counted microbatch by microbatch: flops, bytes, collectives, kernels,
    arguments and the peak of temps."""
    from repro_torch import configs, models
    from repro_torch.data.synthetic import input_specs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import costs
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step

    cfg = configs.get_smoke_config(arch)
    got = []
    with dryrun.fake_world(8):
        ctx = dryrun.build_ctx(make_mesh((2, 4), ("data", "model"), "cpu"), 16, 32, "train")
        for fold in (True, False):
            model = models.build(cfg, ctx, device="meta").requires_grad_(True)
            opt_cfg = AdamWConfig(chunk_threshold_bytes=dryrun.UNCHUNKED)
            state = init_opt_state(dict(model.named_parameters()), opt_cfg)
            batch = input_specs(cfg, 16 // ctx.dp_size, 32)
            step = build_train_step(model, opt_cfg, microbatches=4)
            with costs.count(fold_repeats=fold) as c:
                c.arguments(params=dict(model.named_parameters()), opt_state=state, batch=batch)
                step(state, batch)
            got.append(c.result())
    folded, full = got
    assert folded == full
    assert full["kernels"]["flash_attention"]["calls"] % 4 == 0 and full["per_collective"]


def test_a_second_fake_world_refuses_to_start():
    from repro_torch.launch import dryrun

    with dryrun.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()
