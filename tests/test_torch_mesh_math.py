"""The LM mesh slice's single-process pieces, held against the JAX package:
K6's plain version with its logsumexp, the merge of a sequence-sharded
cache's chunks, the vocab-parallel cross entropy's merge of shard
statistics, and the cut of the reference's tree into rank shards and its
gathering back.

Tolerances, all float32: attention outputs atol 1e-5 (sums in other
orders over at most 96 positions), logsumexps atol 1e-5, the cross entropy
rtol 1e-6; the cut and the gather bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from repro import models as ref_models
from repro.configs import get_smoke_config as ref_smoke
from repro.distributed.sharding import local_ctx
from repro.kernels.decode_attention import decode_attention_ref
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain, merge_partials
from repro_torch.models.convert import merge_shards, params_from_reference, params_to_reference
from repro_torch.models.layers import cross_entropy, merge_vocab_stats, vocab_stats

S = 96


def _decode_inputs(seed: int, B: int, H: int, KV: int, d: int):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, d)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, d)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    return q, k, v


def _body_stats(q, k, v, lengths, start: int, chunk: int):
    """The reference's ``_decode_body`` on one chunk, written out in jnp: the
    masked logits' max ``m``, ``l = sum exp(logits - m)`` and the unnormalised
    ``o``, at global positions ``[start, start + chunk)`` visible below
    ``lengths``."""
    B, H, d = q.shape
    KV = k.shape[2]
    qg = jnp.asarray(q).reshape(B, KV, H // KV, d) * d**-0.5
    kc, vc = jnp.asarray(k[:, start : start + chunk]), jnp.asarray(v[:, start : start + chunk])
    visible = (start + jnp.arange(chunk))[None, :] < jnp.asarray(lengths)[:, None]
    logits = jnp.where(visible[:, None, None, :], jnp.einsum("bkgd,bskd->bkgs", qg, kc), -1e30)
    m = jnp.max(logits, axis=-1, keepdims=True)
    p = jnp.exp(logits - m)
    return m[..., 0], jnp.sum(p, axis=-1), jnp.einsum("bkgs,bskd->bkgd", p, vc)


@pytest.mark.parametrize("G,d", [(1, 32), (4, 64), (3, 128)])
def test_k6_plain_lse_matches_reference_math(G, d):
    """The output against ``decode_attention_ref``; the lse against the
    reference body's ``m + log(l)`` over the whole cache; a slot of length
    0 gets -1e30 (the reference body's value in f32), and the CPU wrapper
    returns what the plain version does."""
    B, KV = 4, 2
    q, k, v = _decode_inputs(G * 1000 + d, B, KV * G, KV, d)
    lengths = np.array([1, 7, S, 33], np.int32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lengths))
    out, lse = decode_attention_plain(tq, tk, tv, tl, return_lse=True)
    want = np.asarray(decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths)))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    m, l, _ = _body_stats(q, k, v, lengths, 0, S)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)).reshape(B, -1), atol=1e-5, rtol=0)
    got, got_lse = decode_attention(tq, tk, tv, tl, return_lse=True)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)
    empty = torch.tensor([0, 3, 0, S], dtype=torch.int32)
    _, lse0 = decode_attention_plain(tq, tk, tv, empty, return_lse=True)
    assert (lse0[0] == -1e30).all() and (lse0[2] == -1e30).all() and (lse0[1] > -1e3).all()


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_chunk_merge_equals_whole_cache(chunks):
    """A cache of 96 positions cut into ``chunks`` contiguous chunks, each
    rank's K6 (plain) with its chunk-local lengths ``clip(len - start, 0,
    chunk)`` and lse, merged by ``merge_partials``: the whole cache's
    attention, and the reference's LSE-weighted psum merge of its body's
    partials.  Slots of length 1 and 30 leave the later chunks empty."""
    B, KV, G, d = 4, 2, 3, 32
    q, k, v = _decode_inputs(chunks, B, KV * G, KV, d)
    lengths = np.array([1, 30, S, 50], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    chunk = S // chunks
    outs, lses, stats = [], [], []
    for c in range(chunks):
        local = torch.from_numpy(np.clip(lengths - c * chunk, 0, chunk).astype(np.int32))
        o, lse = decode_attention_plain(tq, tk[:, c * chunk : (c + 1) * chunk], tv[:, c * chunk : (c + 1) * chunk],
                                        local, return_lse=True)
        outs.append(o)
        lses.append(lse)
        stats.append(_body_stats(q, k, v, lengths, c * chunk, chunk))
    if chunks > 1:
        assert any((torch.from_numpy(lengths) - c * chunk <= 0).any() for c in range(chunks))
    merged = merge_partials(torch.stack(outs), torch.stack(lses))
    whole = decode_attention_plain(tq, tk, tv, torch.from_numpy(lengths))
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=1e-5, rtol=0)
    m_glob = jnp.max(jnp.stack([m for m, _, _ in stats]), axis=0)
    w = [jnp.exp(m - m_glob) for m, _, _ in stats]
    num = sum(o * wi[..., None] for (_, _, o), wi in zip(stats, w))
    den = sum(l * wi for (_, l, _), wi in zip(stats, w))
    ref = np.asarray(num / jnp.maximum(den, 1e-30)[..., None]).reshape(B, KV * G, d)
    np.testing.assert_allclose(merged.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_vocab_parallel_cross_entropy_merge(shards):
    """Logits of 2 x 8 positions over 96 columns, the last 6 padding at
    -1e30 (a vocab-sharded head's masked columns), cut into ``shards``
    vocab shards: the merged statistics' mean cross entropy equals the port's
    one-shard ``cross_entropy`` and the reference's over the real columns."""
    V, pad = 96, 6
    rng = np.random.default_rng(shards)
    logits = (rng.standard_normal((2, 8, V)) * 3).astype(np.float32)
    logits[..., V - pad :] = -1e30
    labels = rng.integers(0, V - pad, (2, 8)).astype(np.int32)
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    v = V // shards
    stats = torch.stack([vocab_stats(tl[..., s * v : (s + 1) * v], tb, s * v) for s in range(shards)])
    lse, gold = merge_vocab_stats(stats)
    got = float((lse - gold).mean())
    np.testing.assert_allclose(got, float(cross_entropy(tl, tb)), rtol=1e-6)
    want = float(ref_cross_entropy(jnp.asarray(logits[..., : V - pad]), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch: str):
    cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    params = ref_models.build(cfg, local_ctx()).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}#{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("fsdp", [1, 2])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_convert_cut_and_gather_round_trip(arch, tp, fsdp):
    """Every leaf of the reference's tree cut to each (tp, fsdp) rank's shard
    by its layout -- heads, FFN hidden, experts and vocabulary over tp, the
    block matrices' D over fsdp, norms and the router whole -- then joined
    and stacked back: the reference's tree bit for bit."""
    tree = _ref_tree(arch)
    states = [[params_from_reference(tree, ShardCtx.grid(model=(t, tp), data=(f, fsdp)))
               for f in range(fsdp)] for t in range(tp)]
    shard = states[tp - 1][fsdp - 1]
    whole = params_from_reference(tree)
    D = ref_smoke(arch).d_model
    assert shard["embed.table"].shape == (whole["embed.table"].shape[0] // tp, D)
    assert shard["layers.0.attn.wq"].shape == (D // fsdp, whole["layers.0.attn.wq"].shape[1] // tp)
    assert shard["layers.0.attn.wo"].shape == (whole["layers.0.attn.wo"].shape[0] // tp, D // fsdp)
    assert shard["layers.0.ln1.scale"].shape == (D,)
    if "layers.0.moe.w_in" in whole:
        e, _, f_ = whole["layers.0.moe.w_in"].shape
        assert shard["layers.0.moe.w_in"].shape == (e // tp, D // fsdp, f_)
        assert shard["layers.0.moe.router"].shape == whole["layers.0.moe.router"].shape
    joined = merge_shards(states, ShardCtx.grid(model=(0, tp), data=(0, fsdp)))
    back = _flat(jax.tree.map(lambda t: t.numpy(), params_to_reference(joined)))
    want = _flat(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_int8_compressor_scales_the_stacked_layers_as_the_reference():
    """The port's gradients are per layer (``layers.<i>.<name>``), the
    reference's one stacked leaf (``layers.<name>``) with one scale: three
    error-feedback rounds on the smoke LM's gradient-shaped dict equal the
    reference's on the stacked tree, bit for bit."""
    from repro.distributed import collectives as ref_coll
    from repro_torch.distributed import collectives

    rng = np.random.default_rng(3)
    rounds = []
    for _ in range(3):
        tree = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * rng.uniform(0.1, 10)).astype(np.float32),
                            _ref_tree("granite-moe-3b-a800m"))
        rounds.append((params_from_reference(tree), tree))
    compress, init = collectives.make_int8_compressor()
    rcompress, rinit = ref_coll.make_int8_compressor(local_ctx())
    res, rres = init(rounds[0][0]), rinit(rounds[0][1])
    for grads, tree in rounds:
        out, res = compress(grads, res)
        rout, rres = rcompress(tree, rres)
        got = _flat(jax.tree.map(lambda t: t.numpy(), params_to_reference(out)))
        for k, v in _flat(rout).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
