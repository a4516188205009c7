"""The port's LM on precomputed-embedding inputs (llava-next-34b's backbone:
the vision tiling is a stub) against the JAX package's, on the CPU, at its
smoke config (3 layers, 8 heads over 2 kv heads: G 4): the training forward,
the loss and every gradient from ``batch["embeds"]``, one AdamW step, prefill
from embeddings then greedy token decode steps cache leaf by leaf, the
host-read guard, the recurrent kinds from embeddings, and each leaf's shard
on a mesh (the parity on a mesh is ``test_torch_families_sharded.py``'s).  Where the reference cannot take them (the
``Engine``, both CLIs) the refusals are ``test_torch_serve.py``'s.

Tolerances: float32 on both sides 1e-4 (atol and rtol), every gradient leaf
atol 1e-5 + rtol 1e-4; bfloat16 logits and caches atol 0.1, rtol 2e-2, as
``test_torch_serve.py`` holds them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed.sharding import local_ctx
from repro.train import optimizer as ref_opt
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch import configs, models
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.models.convert import params_from_reference
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step

from _torch_host_reads import NoHostReads
from _torch_train_ref import _close_tree

ARCH = "llava-next-34b"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=0.1, rtol=2e-2)}
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
DTYPES = ["float32", "bfloat16"]
B, T = 2, 11


def _port_config(dtype: str = "float32"):
    return dataclasses.replace(configs.get_smoke_config(ARCH), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _pair(dtype: str = "float32"):
    """(reference cfg, reference model, its params, port model) on the
    reference's ``PRNGKey(0)`` weights."""
    cfg = dataclasses.replace(ref_get_smoke(ARCH), dtype=dtype)
    ref = ref_models.build(cfg, local_ctx())
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    port = models.build(_port_config(dtype), device="cpu")
    port.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params)))
    return cfg, ref, params, port


@functools.lru_cache(maxsize=None)
def _jitted(dtype: str, name: str):
    return jax.jit(getattr(_pair(dtype)[1], name))


def _batch(seed: int, b: int = B, t: int = T) -> dict:
    """Embeddings (b, t, D) N(0, 1) float32 and labels (b, t)."""
    cfg = _port_config()
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, t, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def test_smoke_config_is_a_gqa_group_of_four():
    cfg = _port_config()
    assert cfg.input_kind == "embeds" and cfg.num_heads // cfg.num_kv_heads == 4 and cfg.num_layers == 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_from_embeddings_matches_reference(dtype):
    """The logits of (B, T, D) float32 embeddings, cast to the model's type
    on both sides; the aux is zero."""
    _, _, params, port = _pair(dtype)
    b = _batch(1)
    want, want_aux = _jitted(dtype, "forward")(params, {"embeds": jnp.asarray(b["embeds"])})
    with torch.no_grad():
        got, aux = port(torch.from_numpy(b["embeds"]))
    assert tuple(got.shape) == want.shape
    _close(got, want, **TOL[dtype])
    assert float(aux) == float(want_aux)
    assert port.embed_inputs(torch.from_numpy(b["embeds"])).dtype == getattr(torch, dtype)


def test_loss_and_every_gradient_match_reference():
    """``loss(batch)`` reads ``batch["embeds"]``: the loss and every
    parameter's gradient against ``jax.value_and_grad`` of the reference's
    loss (the embedding table's is zero: no token is looked up)."""
    _, ref, params, port = _pair()
    b = _batch(2)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref.loss(p, {k: jnp.asarray(v) for k, v in b.items()}), has_aux=True))(params)
    model = models.build(_port_config(), device="cpu")
    model.load_state_dict(port.state_dict())
    model.requires_grad_(True)
    got, _ = model.loss({k: torch.from_numpy(v) for k, v in b.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    assert model.embed.table.grad is None and not np.asarray(grads["embed"]["table"]).any()
    _close_tree({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()},
                grads, **GRAD_TOL)


def test_adamw_step_from_embeddings_matches_reference():
    """One train step (AdamW, lr 1e-3, no warmup) on an embeddings batch
    against the reference's jitted step: loss, norm, every parameter (the
    token table, which the loss does not reach, only decayed)."""
    _, ref, params, port = _pair()
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    rcfg = ref_opt.AdamWConfig(**ocfg)
    b = _batch(3, b=4)
    rparams, _, rmet = jax.jit(ref_build_train_step(ref, rcfg))(
        params, ref_opt.init_opt_state(params, rcfg), {k: jnp.asarray(v) for k, v in b.items()})
    model = models.build(_port_config(), device="cpu")
    model.load_state_dict(port.state_dict())
    model.requires_grad_(True)
    pcfg = opt.AdamWConfig(**ocfg)
    _, met = build_train_step(model, pcfg)(opt.init_opt_state(dict(model.named_parameters()), pcfg),
                                           {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose([float(met["loss"]), float(met["grad_norm"])],
                               [float(rmet["loss"]), float(rmet["grad_norm"])], rtol=1e-4)
    _close_tree(dict(model.named_parameters()), rparams, atol=1e-4, rtol=0)


def test_only_the_named_unreached_table_gets_a_zero_gradient():
    """The train step zero-fills only what the model names as out of its
    loss's reach (the embeddings model's token table); a token model's
    parameter that the loss does not reach still fails in autograd."""
    assert models.build(_port_config(), device="cpu").loss_unreached == ("embed.table",)
    model = models.build(dataclasses.replace(_port_config(), input_kind="tokens"), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    assert model.loss_unreached == ()
    model.stray = torch.nn.Parameter(torch.zeros(3))
    model.requires_grad_(True)
    cfg = opt.AdamWConfig()
    labels = torch.from_numpy(_batch(4)["labels"])
    step = build_train_step(model, cfg)
    with pytest.raises(RuntimeError, match="not have been used"):
        step(opt.init_opt_state(dict(model.named_parameters()), cfg), {"tokens": labels, "labels": labels})


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_from_embeddings_then_token_decode_matches_reference(dtype):
    """Prefill from embeddings (last position's logits, ``k``/``v``,
    ``pos``), then five greedy decode steps on tokens (the reference's), the
    logits and every cache leaf after each."""
    _, ref, params, port = _pair(dtype)
    b = _batch(4)
    max_len = 20
    want, rcache = _jitted(dtype, "prefill")(params, {"embeds": jnp.asarray(b["embeds"])}, ref.init_cache(B, max_len))
    cache = port.init_cache(B, max_len)
    got, cache = port.prefill(torch.from_numpy(b["embeds"]), cache)

    def same():
        _close(got, want, **TOL[dtype])
        assert set(cache) == set(rcache)
        for k in rcache:
            _close(cache[k], rcache[k], err_msg=k, **TOL[dtype])

    same()
    for _ in range(5):
        tok = jnp.argmax(want, -1).astype(jnp.int32)
        want, rcache = _jitted(dtype, "decode_step")(params, rcache, tok)
        got, cache = port.decode_step(cache, torch.from_numpy(np.array(tok)))
        same()
    assert cache["pos"].tolist() == [T + 5] * B


def test_token_decode_after_embeddings_reads_nothing_on_the_host():
    _, _, _, port = _pair()
    cache = port.init_cache(B, 16)
    logits, cache = port.prefill(torch.from_numpy(_batch(5)["embeds"]), cache)
    with NoHostReads():
        logits, cache = port.decode_step(cache, logits.argmax(-1))
    assert cache["pos"].tolist() == [T + 1] * B


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b"])
def test_recurrent_kinds_take_embeddings(arch):
    """The reference's ``embed_inputs`` is kind-blind: a recurrent model
    with ``input_kind == "embeds"`` builds, takes (B, T, D) embeddings in
    ``prefill`` and decodes tokens (the parity with the reference is
    ``test_torch_families_sharded.py``'s)."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), input_kind="embeds", dtype="float32")
    model = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cache = model.init_cache(B, 16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, cfg.d_model)).astype(np.float32)) * 0.02
    logits, cache = model.prefill(x, cache)
    logits, cache = model.decode_step(cache, logits.argmax(-1))
    assert logits.shape == (B, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert cache["pos"].tolist() == [T + 1] * B


@pytest.mark.parametrize("ctx", [ShardCtx.grid(model=(0, 2)), ShardCtx.grid(data=(1, 2)), ShardCtx(sp=True)],
                         ids=["tp2", "fsdp2", "sp"])
def test_embeddings_on_a_mesh_build_each_leaf_at_its_spec(ctx):
    """On a mesh the embeddings model is the rank's shard of every leaf by
    ``leaf_spec`` (the vocab over tp for the decode step's lookup), its
    cache sequence-sharded; ``embed_inputs`` under SP keeps the rank's T
    rows of the embeddings with no collective."""
    cfg = _port_config()
    model = workers.shards_at_spec(cfg, ctx)
    tp = ctx.tp_size
    assert model.embed.table.shape == (cfg.padded_vocab // tp, cfg.d_model)
    assert model.init_cache(1, 8)["k"].shape == (3, 1, 8 // tp, 2, 16)
    x = torch.arange(2 * 8 * cfg.d_model, dtype=torch.float32).reshape(2, 8, cfg.d_model)
    rows = model.embed_inputs(x, seq_sharded=ctx.tp_size > 1)
    r = ctx.axis_index(ctx.tp)
    assert torch.equal(rows, x[:, r * 8 // tp:(r + 1) * 8 // tp])


def test_one_by_one_mesh_builds():
    model = models.build(_port_config(), ctx=ShardCtx.grid(model=(0, 1), data=(0, 1)), device="cpu")
    assert model.init_cache(1, 8)["k"].shape == (3, 1, 8, 2, 16)
