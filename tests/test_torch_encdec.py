"""The port's encoder-decoder LM (whisper-small) against the JAX package's,
on the CPU, at its smoke config (2 + 2 layers, d 128) on the perturbed
weights of ``_torch_encdec_ref.py`` (biases and norm scales drawn): the
positions, the encoder, the cross cache, the training forward's logits,
prefill and six decode steps leaf by leaf, cross-attention at a ragged
encoder length (S 37 against T 9), the host-read guard over the decode step,
the parameter trees bit for bit, each leaf's shard on a mesh and the
cache's refusal of a length tp does not divide.  Training is
``test_torch_encdec_train.py``'s.

Tolerances: float32 on both sides 1e-4 (atol and rtol); bfloat16 logits and
caches atol 0.1, rtol 2e-2, as ``test_torch_serve.py`` holds them (the two
frameworks round at other places: matmul accumulation, the reference's bf16
attention probabilities against the port's f32 ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.distributed.sharding import local_ctx
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro_torch import models
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec
from repro_torch.models.convert import params_from_reference, params_to_reference

from _torch_encdec_ref import ARCH, B, S, T, batch_np, close, jb, jitted, pair, port_config, tb
from _torch_host_reads import NoHostReads

TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=0.1, rtol=2e-2)}
DTYPES = ["float32", "bfloat16"]
#: Decode steps after the prefill.
STEPS = 6


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", [(1, 128), (37, 128), (448, 768), (5, 7)])
def test_sinusoid_matches_reference(n, d, dtype):
    """Positions 0..n-1 at width d (an odd d cut to d columns), float32
    angles cast to the model's type.  Angles reach 447 radians, where one
    float32 rounding of the angle moves its sine by 3e-5: float32 1e-4, and
    bfloat16 one ulp of a value in [-1, 1] (2^-8)."""
    want = ref_encdec.sinusoid(n, d, jnp.dtype(dtype))
    got = encdec.sinusoid(n, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    close(got, want, atol=1e-4 if dtype == "float32" else 2**-8, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_cross_cache_match_reference(dtype):
    """The encoder's output (B, S, D) and every decoder layer's cross K/V
    from it, stacked (L, B, S, KV, hd)."""
    cfg, ref, params, port = pair(dtype)
    b = batch_np(1)
    enc = jitted(dtype, "encode")(params, jnp.asarray(b["enc_embeds"]))
    want_k, want_v = jax.jit(ref.build_cross_cache)(params, enc)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(b["enc_embeds"]))
    assert got.dtype == getattr(torch, dtype)
    close(got, enc, **TOL[dtype])
    xk, xv = port.build_cross_cache(torch.from_numpy(np.array(enc.astype(jnp.float32))).to(got.dtype))
    assert tuple(xk.shape) == want_k.shape == (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    close(xk, want_k, **TOL[dtype])
    close(xv, want_v, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_training_forward_logits_match_reference(dtype):
    """``forward(batch)``: the logits (B, T, V) and a zero aux."""
    _, _, params, port = pair(dtype)
    b = batch_np(2)
    want, want_aux = jitted(dtype, "forward")(params, jb(b))
    with torch.no_grad():
        got, aux = port(tb(b))
    assert tuple(got.shape) == want.shape
    close(got, want, **TOL[dtype])
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_steps_match_reference(dtype):
    """Prefill (the last position's logits and every cache leaf: the
    decoder's k/v at [0, T), the cross K/V, ``pos``), then six decode steps
    on the reference's greedy tokens, logits and caches after each."""
    cfg, ref, params, port = pair(dtype)
    b = batch_np(3)
    max_len = T + STEPS + 1
    batch = {"enc_embeds": b["enc_embeds"], "tokens": b["tokens"]}
    want, rcache = jitted(dtype, "prefill")(params, jb(batch), ref.init_cache(B, max_len, S))
    cache = port.init_cache(B, max_len, S)
    got, cache = port.prefill(tb(batch), cache)

    def same(got, want, rcache, cache):
        close(got, want, **TOL[dtype])
        assert set(cache) == set(rcache) == {"pos", "k", "v", "xk", "xv"}
        for k in rcache:
            assert tuple(cache[k].shape) == rcache[k].shape, k
            close(cache[k], rcache[k], err_msg=k, **TOL[dtype])

    same(got, want, rcache, cache)
    step = jitted(dtype, "decode_step")
    for _ in range(STEPS):
        tok = jnp.argmax(want, -1).astype(jnp.int32)
        want, rcache = step(params, rcache, tok)
        got, cache = port.decode_step(cache, torch.from_numpy(np.array(tok)))
        same(got, want, rcache, cache)
    assert cache["pos"].tolist() == [T + STEPS] * B


def _layer_params(params, stack: str, leaf: str, i: int = 0):
    return jax.tree.map(lambda a: a[i], params[stack][leaf])


def test_cross_attention_matches_reference_at_a_ragged_encoder_length():
    """Decoder layer 1's cross-attention at T 9 against S 37 encoder rows
    (K5's non-causal T != S), and its decode step against the same K/V
    (K6 with every one of the 37 positions visible); the decode step writes
    nothing to the K/V."""
    cfg, _, params, port = pair()
    p = _layer_params(params, "decoder", "xattn", 1)
    blk = port.decoder[1].xattn
    rng = np.random.default_rng(4)
    x, enc = rng.standard_normal((B, T, cfg.d_model), np.float32), rng.standard_normal((B, S, cfg.d_model), np.float32)
    positions = jnp.arange(T)[None, :]
    kv = ref_attn.project_cross_kv(p, cfg, jnp.asarray(enc))
    want = ref_attn.attention(p, cfg, local_ctx(), jnp.asarray(x), positions, causal=False, kv=kv)
    with torch.no_grad():
        pkv = attn_mod.project_cross_kv(blk, cfg, torch.from_numpy(enc))
        for g, w in zip(pkv, kv):
            close(g, w, **TOL["float32"])
        got = attn_mod.attention(blk, cfg, torch.from_numpy(x), torch.arange(T)[None, :], causal=False, kv=pkv)
    close(got, want, **TOL["float32"])

    full = jnp.full((B,), S - 1, jnp.int32)
    want, _, _ = ref_attn.decode_attention(p, cfg, local_ctx(), jnp.asarray(x[:, :1]), *kv, full, cross=True)
    kc, vc = (t.clone() for t in pkv)
    with torch.no_grad():
        got, kc2, vc2 = attn_mod.decode_attention(blk, cfg, torch.from_numpy(x[:, :1]), kc, vc,
                                                  torch.from_numpy(np.array(full)), cross=True)
    close(got, want, **TOL["float32"])
    assert torch.equal(kc2, pkv[0]) and torch.equal(vc2, pkv[1])


def test_cross_attention_projects_q_alone():
    """Given K/V, neither ``attention`` nor the cross decode step reads
    ``wk``, ``wv``, ``bk`` or ``bv``: NaN there changes nothing."""
    cfg, _, _, port = pair()
    blk = port.decoder[0].xattn
    x = torch.randn(B, T, cfg.d_model, generator=torch.Generator().manual_seed(5))
    kv = attn_mod.project_cross_kv(blk, cfg, torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(6)))
    pos = torch.full((B,), S - 1, dtype=torch.int32)
    with torch.no_grad():
        want = attn_mod.attention(blk, cfg, x, torch.arange(T)[None, :], causal=False, kv=kv)
        want_d = attn_mod.decode_attention(blk, cfg, x[:, :1], *kv, pos, cross=True)[0]
        saved = {n: getattr(blk, n).clone() for n in ("wk", "wv", "bk", "bv")}
        try:
            for n in saved:
                getattr(blk, n).fill_(float("nan"))
            got = attn_mod.attention(blk, cfg, x, torch.arange(T)[None, :], causal=False, kv=kv)
            got_d = attn_mod.decode_attention(blk, cfg, x[:, :1], *kv, pos, cross=True)[0]
        finally:
            for n, t in saved.items():
                getattr(blk, n).copy_(t)
    assert torch.equal(got, want) and torch.equal(got_d, want_d)


def test_decode_step_reads_nothing_on_the_host():
    """The decode step (self and cross K6, the device-side position) passes
    the host-read guard: on the card it is captured into a CUDA graph."""
    _, _, _, port = pair()
    b = batch_np(7)
    cache = port.init_cache(B, 16, S)
    logits, cache = port.prefill(tb({"enc_embeds": b["enc_embeds"], "tokens": b["tokens"]}), cache)
    tok = logits.argmax(-1)
    with NoHostReads() as guard:
        for _ in range(2):
            logits, cache = port.decode_step(cache, tok)
            tok = logits.argmax(-1)
    assert guard.seen.get("mm", 0) + guard.seen.get("addmm", 0) > 0
    assert cache["pos"].tolist() == [T + 2] * B


@pytest.mark.parametrize("dtype", DTYPES)
def test_parameter_trees_round_trip_bit_for_bit(dtype):
    """The reference's tree -> the port's state (``encoder.<i>``,
    ``decoder.<i>``) -> the reference's tree, every leaf the same bytes, and
    the state names the port's modules."""
    _, _, params, port = pair(dtype)
    tree = jax.tree.map(np.asarray, params)
    state = params_from_reference(tree)
    assert set(state) == set(port.state_dict())
    assert {n.split(".")[0] for n in state} == {"embed", "encoder", "decoder", "ln_enc", "ln_f", "head"}
    back = params_to_reference(state)
    flat_w, tdef_w = jax.tree.flatten(tree)
    flat_g, tdef_g = jax.tree.flatten(jax.tree.map(lambda t: t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                                   else t.numpy(), back))
    assert tdef_g == tdef_w
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.tobytes() == np.ascontiguousarray(w).tobytes()


def test_build_returns_the_encoder_decoder_and_its_init_draws_every_leaf():
    """``models.build`` gives an :class:`EncDecLM` whose modules carry the
    reference's leaf names; ``init`` draws matrices, zeroes biases and sets
    norms to one."""
    model = models.build(port_config(), device="cpu")
    assert isinstance(model, models.EncDecLM)
    model.init(torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert {n.split(".", 2)[-1] for n in names if n.startswith("decoder.0.")} >= {
        "ln1.scale", "attn.wq", "ln_x.scale", "xattn.wk", "xattn.bv", "ln2.scale", "mlp.w_in", "mlp.b_out"}
    assert not any(n.startswith("encoder.0.xattn") or n.startswith("encoder.0.ln_x") for n in names)
    assert bool((names["decoder.1.ln_x.scale"] == 1).all()) and not names["encoder.0.attn.bq"].any()
    assert 0.05 < float(names["decoder.0.xattn.wq"].std()) * port_config().d_model ** 0.5 < 20


@pytest.mark.parametrize("ctx", [ShardCtx.grid(model=(0, 2)), ShardCtx.grid(data=(1, 2)), ShardCtx(sp=True)],
                         ids=["tp2", "fsdp2", "sp"])
def test_mesh_builds_each_leaf_at_its_spec(ctx):
    """On a mesh each leaf is the rank's shard by ``leaf_spec`` (the
    reference's ``_spec_block``): the cross-attention's leaves cut as the
    self-attention's, the vocab over tp, and the caches sequence-sharded."""
    cfg = port_config()
    model = workers.shards_at_spec(cfg, ctx)
    tp, fsdp = ctx.tp_size, ctx.axis_size(ctx.fsdp)
    specs = model.param_specs()
    for leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"):
        assert specs[f"decoder.1.xattn.{leaf}"] == specs[f"decoder.1.attn.{leaf}"] == specs[f"encoder.0.attn.{leaf}"]
    assert model.decoder[0].xattn.wk.shape == (cfg.d_model // fsdp, cfg.num_kv_heads * cfg.resolved_head_dim // tp)
    assert model.head.w.shape == (cfg.d_model, cfg.padded_vocab // tp)
    assert model.init_cache(1, 8, 12)["xk"].shape == (2, 1, 12 // tp, 4, 32)


def test_one_by_one_mesh_builds():
    ctx = ShardCtx.grid(model=(0, 1), data=(0, 1))
    model = models.build(port_config(), ctx=ctx, device="cpu")
    assert model.ctx is ctx and model.init_cache(1, 8, 5)["xk"].shape == (2, 1, 5, 4, 32)


@pytest.mark.parametrize("what,n", [("enc_len", 37), ("max_len", 9)])
def test_cache_length_that_tp_does_not_divide_raises(what, n):
    """The cache is sequence-sharded over tp; the reference's decode step
    refuses a length tp does not divide (its ``shard_map``), so the port's
    cache names the length and tp."""
    model = models.build(port_config(), ctx=ShardCtx.grid(model=(1, 4)), device="cpu")
    lens = {"max_len": 8, "enc_len": 12, what: n}
    with pytest.raises(ValueError, match=f"{what}={n} does not split over tp=4"):
        model.init_cache(1, lens["max_len"], lens["enc_len"])


def test_prefill_refuses_a_cross_cache_of_another_length():
    _, _, _, port = pair()
    b = batch_np(8)
    with pytest.raises(ValueError, match="cross cache"):
        port.prefill(tb({"enc_embeds": b["enc_embeds"], "tokens": b["tokens"]}), port.init_cache(B, 16, S + 1))

