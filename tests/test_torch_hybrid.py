"""The port's Mamba2 and hybrid (zamba2) LMs against the JAX package's, on
the CPU: the SSD block and its decode step, the LM's logits, loss and
gradients, prefill and decode caches, at zamba2's smoke config in float32
(L 4, shared block every 2 layers) and two variants of it: L 5 (a short last
segment with no attention after it) and ``family="ssm"`` (the ``mamba``
kind, no shared block); the serve CLI and the mesh's refusal.  The
reference's weights come from ``PRNGKey(0)`` and are carried across by
``params_from_reference``; inputs are numpy draws.  Training, the engine and
the checkpoints are in ``test_torch_hybrid_train.py``.

Tolerances (float32 on both sides, other summation orders): the SSD block's
output and states atol/rtol 1e-5; logits and caches atol/rtol 1e-4 (the
smoke LMs' tolerance); loss rtol 1e-5 and every gradient leaf atol 1e-5 +
rtol 1e-4.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.distributed.sharding import local_ctx
from repro.models import mamba2 as ref_mamba2
from repro_torch import configs, models
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.kernels import build as kbuild
from repro_torch.launch import serve as serve_cli
from repro_torch.models import mamba2
from repro_torch.models.lm import init_params

from _torch_host_reads import NoHostReads
from _torch_hybrid_ref import ARCH, VARIANTS, close, jitted, jnp_batch, pair, trainable
from _torch_train_ref import _close_tree

SSD_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _tokens(cfg, seed: int, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape).astype(np.int32)


# -- the SSD block -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_block(name: str):
    cfg, _, params, _ = pair("hybrid")
    fn = getattr(ref_mamba2, name)
    lp = jax.tree.map(lambda a: a[0], params["layers"]["mamba"])
    return jax.jit(lambda *a: fn(lp, cfg, local_ctx(), *a))


def _states(cfg, seed: int, B: int):
    s, _, H = mamba2.dims(cfg)
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, s.conv_width - 1, mamba2.conv_channels(cfg))).astype(np.float32)
    ssm = (rng.standard_normal((B, H, s.state_dim, s.head_dim)) * 0.5).astype(np.float32)
    return conv, ssm


@pytest.mark.parametrize("given", [False, True], ids=["zero_states", "given_states"])
@pytest.mark.parametrize("T,Q", [(32, 16), (24, 12), (37, 1)], ids=["multiple", "divisor", "prime"])
def test_mamba_block_matches_reference(T, Q, given):
    """Output, conv state and ssm state of one SSD block at T a multiple of
    the chunk (16), at T it does not divide (the chunk shrinks to 12) and at
    a prime T (Q = 1: the inter-chunk loop takes T steps), from zero states
    and from given ones (a prefill continuation)."""
    cfg, _, _, port = pair("hybrid")
    assert mamba2.chunk_len(cfg, T) == Q
    u = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    if given:
        conv, ssm = _states(cfg, T + 1, 2)
        want = _ref_block("mamba_block")(jnp.asarray(u), jnp.asarray(conv), jnp.asarray(ssm))
        states = (torch.from_numpy(conv), torch.from_numpy(ssm))
    else:
        want, states = _ref_block("mamba_block")(jnp.asarray(u)), ()
    with torch.no_grad():
        got = mamba2.mamba_block(port.layers[0].mamba, cfg, torch.from_numpy(u), *states)
    for g, w, name in zip(got, want, ("y", "conv", "ssm")):
        assert tuple(g.shape) == w.shape, name
        close(g, w, err_msg=name, **SSD_TOL)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """With a decay of some 38 nats a token (``a_log`` 4), a chunk of 16
    overflows exp above the diagonal: the reference's gradient is NaN there
    (R8), the port's, masked before the exponential, is finite, and the
    forward is the same."""
    cfg, _, params, port = pair("hybrid")
    lp = jax.tree.map(lambda a: a[0], params["layers"]["mamba"])
    lp = dict(lp, a_log=jnp.full_like(lp["a_log"], 4.0))
    u = np.random.default_rng(0).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, grads = jax.value_and_grad(lambda p: ref_mamba2.mamba_block(p, cfg, local_ctx(), jnp.asarray(u))[0].sum())(lp)
    assert np.isnan(np.asarray(grads["a_log"])).any()
    m = mamba2.Mamba(cfg, torch.float32, "cpu")
    m.load_state_dict({k: v.detach().clone() for k, v in port.layers[0].mamba.state_dict().items()})
    with torch.no_grad():
        m.a_log.fill_(4.0)
    m.requires_grad_(True)
    got = mamba2.mamba_block(m, cfg, torch.from_numpy(u))[0].sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert all(torch.isfinite(p.grad).all() for p in m.parameters())


def test_mamba_block_conv_state_of_a_short_prompt_holds_the_pad():
    """A prompt shorter than W-1 leaves zero rows of the pad in the conv state."""
    cfg, _, _, port = pair("hybrid")
    u = np.random.default_rng(2).standard_normal((1, 2, cfg.d_model)).astype(np.float32)
    _, want, _ = _ref_block("mamba_block")(jnp.asarray(u))
    with torch.no_grad():
        _, got, _ = mamba2.mamba_block(port.layers[0].mamba, cfg, torch.from_numpy(u))
    close(got, want, **SSD_TOL)
    assert not got[:, 0].any() and got[:, 1:].abs().sum() > 0


def test_mamba_decode_matches_reference_step_by_step():
    """Five one-token steps from given states, each step's output and
    states within 1e-5; the port's new states are new tensors."""
    cfg, _, _, port = pair("hybrid")
    p = port.layers[0].mamba
    conv, ssm = _states(cfg, 5, 3)
    rc, rs = jnp.asarray(conv), jnp.asarray(ssm)
    pc, ps = torch.from_numpy(conv), torch.from_numpy(ssm)
    rng = np.random.default_rng(6)
    for _ in range(5):
        u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y, rc, rs = _ref_block("mamba_decode")(jnp.asarray(u), rc, rs)
        with torch.no_grad():
            got, nc, ns = mamba2.mamba_decode(p, cfg, torch.from_numpy(u), pc, ps)
        assert nc.data_ptr() != pc.data_ptr() and ns.data_ptr() != ps.data_ptr()
        pc, ps = nc, ns
        for g, w, name in ((got, y, "y"), (pc, rc, "conv"), (ps, rs, "ssm")):
            close(g, w, err_msg=name, **SSD_TOL)


def test_heads_read_their_group():
    """Head h reads group h // (H / G): the reference's ``jnp.repeat``."""
    t = torch.arange(2 * 3 * 4).reshape(2, 3, 4)
    assert np.array_equal(mamba2._heads(t, 5, 1).numpy(), np.repeat(t.numpy(), 5, axis=1))


def test_init_draws_the_reference_distributions():
    """dt_bias and a_log zeros, d_skip and norm_scale ones, conv_k N(0,1) * W^-1/2."""
    cfg = configs.get_smoke_config(ARCH)
    p = init_params(mamba2.Mamba(cfg, torch.float32, "cpu"), torch.Generator().manual_seed(0))
    assert not p.dt_bias.any() and not p.a_log.any()
    assert (p.d_skip == 1).all() and (p.norm_scale == 1).all()
    assert abs(p.conv_k.std().item() * cfg.ssm.conv_width**0.5 - 1) < 0.05
    assert abs(p.wz.std().item() * cfg.d_model**0.5 - 1) < 0.05


# -- the LM ---------------------------------------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_logits_match_reference(variant):
    """The training forward at T 37 (prime: Q = 1 in every block)."""
    cfg, _, params, port = pair(variant)
    toks = _tokens(cfg, 1, (2, 37))
    want, _ = jitted(variant, "forward")(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = port(torch.from_numpy(toks))
    close(got, want, **LOGIT_TOL)
    assert aux.item() == 0.0


def test_shared_block_placement():
    """After each full segment, and after a short last one only when L %
    every == 0: L 4 / every 2 runs it twice, L 5 twice, the mamba kind never,
    and zamba2-1.2b's depth (L 38, every 6) six times, with as many shared
    k/v layers and none after the last two Mamba layers."""
    deep = dataclasses.replace(configs.get_smoke_config(ARCH), num_layers=38, shared_attn_every=6)
    for port, n in ((pair("hybrid")[3], 2), (pair("hybrid_L5")[3], 2), (pair("ssm")[3], 0),
                    (models.build(deep, device="cpu"), 6)):
        assert sum(port._shared_after(i) for i in range(port.cfg.num_layers)) == n
        assert hasattr(port, "shared") == bool(n)
        cache = port.init_cache(1, 8)
        assert cache["shared_k"].shape[0] == n if n else "shared_k" not in cache
    assert port._shared_after(35) and not port._shared_after(36) and not port._shared_after(37)


def test_loss_and_every_gradient_match_reference():
    """``jax.value_and_grad`` of the reference's loss, ``shared.*`` included:
    the shared block's gradient is the sum over its invocations (one module
    reused)."""
    cfg, ref, params, _ = pair("hybrid")
    model = trainable("hybrid")
    b = TokenPipeline(cfg.vocab_size, 2, 24, seed=0).next_batch()
    (loss, _), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, jnp_batch(b))
    got, _ = model.loss({k: torch.from_numpy(v) for k, v in b.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    grads_port = {k: p.grad for k, p in model.named_parameters()}
    _close_tree(grads_port, grads, **GRAD_TOL)
    assert grads_port["shared.attn.wq"].abs().sum() > 0 and grads_port["layers.3.mamba.a_log"].abs().sum() > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference_caches(variant):
    """Prefill of a 21-token prompt (Q = 3) into a cache of 64, then four
    greedy steps: logits each call, and every cache leaf, leaf by leaf."""
    cfg, ref, params, port = pair(variant)
    toks = _tokens(cfg, 3, (2, 21))
    rc, pc = ref.init_cache(2, 64), port.init_cache(2, 64)
    assert set(pc) == set(rc) and all(tuple(pc[k].shape) == rc[k].shape for k in rc)
    assert pc["conv"].dtype == torch.float32 and pc["ssm"].dtype == torch.float32
    want, rc = jitted(variant, "prefill")(params, {"tokens": jnp.asarray(toks)}, rc)
    got, pc = port.prefill(torch.from_numpy(toks), pc)
    close(got, want, **LOGIT_TOL)
    for step in range(4):
        for k in rc:
            close(pc[k], rc[k], err_msg=f"{k} at step {step}", **LOGIT_TOL)
        nxt = np.asarray(want).argmax(-1).astype(np.int32)
        want, rc = jitted(variant, "decode_step")(params, rc, jnp.asarray(nxt))
        got, pc = port.decode_step(pc, torch.from_numpy(nxt))
        close(got, want, **LOGIT_TOL)


def test_bf16_cache_dtypes():
    """The conv state is cached in the model's dtype, the ssm state in f32."""
    port = models.build(configs.get_smoke_config(ARCH), device="cpu")
    cache = port.init_cache(2, 16)
    assert cache["conv"].dtype == torch.bfloat16 and cache["ssm"].dtype == torch.float32
    assert cache["shared_k"].dtype == torch.bfloat16


def test_decode_step_reads_nothing_back():
    """The hybrid's decode step is capturable: no op reads the device on the
    host (what would fail only at capture on the card fails here)."""
    port = pair("hybrid")[3]
    cache = port.init_cache(3, 16)
    with NoHostReads() as guard:
        port.decode_step(cache, torch.tensor([1, 2, 3]))
    assert guard.seen.get("bmm", 0) + guard.seen.get("mm", 0) > 0


def test_serve_cli_runs_zamba2_on_cpu(capsys):
    """``launch.serve --arch zamba2-1.2b --smoke --device cpu``: the shared
    block's attention runs K5's and K6's plain versions, so no launches."""
    kbuild.reset_launches()
    finished = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                               "--slots", "3", "--max-tokens", "4", "--max-len", "32"])
    assert sorted(r.rid for r in finished) == [0, 1, 2] and all(len(r.out) == 4 for r in finished)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    assert not any(kbuild.LAUNCHES.values())


# -- the mesh ------------------------------------------------------------------------------


def _sizes_ctx(data: int, model: int, **kw):
    """A ShardCtx whose mesh answers only its axes' sizes, every rank
    coordinate 0 (no process group)."""
    sizes = {"data": data, "model": model}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), size=lambda i: list(sizes.values())[i],
                                 get_local_rank=lambda name: 0)
    return ShardCtx(mesh=mesh, tp="model", **kw)


@pytest.mark.parametrize("ctx", [
    _sizes_ctx(2, 2), _sizes_ctx(1, 2, fsdp=None), _sizes_ctx(2, 1), _sizes_ctx(1, 1, sp=True),
    ShardCtx.grid(model=(0, 1), data=(1, 2)),
], ids=["2x2", "tp2", "fsdp2", "sp", "grid_fsdp2"])
def test_mesh_builds_each_block_shard(ctx):
    """On a mesh the Mamba2 kinds build, each block this rank's shard of the
    reference's ``spec_mamba`` (d_inner over tp, D over fsdp; the smoke
    model's 2 groups cut at tp 2), from token or embedding inputs alike (the
    embeddings model's leaves are the token model's)."""
    tp, fsdp = ctx.tp_size, ctx.axis_size(ctx.fsdp)
    for variant in ("hybrid", "ssm"):
        cfg = pair(variant)[3].cfg
        embeds = models.build(dataclasses.replace(cfg, input_kind="embeds"), ctx=ctx, device="cpu")
        assert {n: p.shape for n, p in embeds.named_parameters()} == {
            n: p.shape for n, p in models.build(cfg, ctx=ctx, device="cpu").named_parameters()}
        blk = models.build(cfg, ctx=ctx, device="cpu").layers[0].mamba
        s, d_inner, _ = mamba2.dims(cfg)
        assert blk.wx.shape == (cfg.d_model // fsdp, d_inner // tp)
        assert blk.wb.shape == (cfg.d_model // fsdp, s.num_groups * s.state_dim // tp)
        assert blk.conv_k.shape == (s.conv_width, mamba2.conv_channels(cfg))


def test_one_by_one_mesh_builds():
    port = models.build(pair("hybrid")[3].cfg, ctx=_sizes_ctx(1, 1), device="cpu")
    assert port.init_cache(1, 8)["shared_k"].shape[0] == 2
