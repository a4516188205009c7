"""The port's attention kernels K5 and K6, held against the JAX package.

On the CPU each wrapper runs its plain torch version, which is what these
tests compare with the reference's Pallas kernels (in interpret mode), with
its ``_sdpa`` where the TPU wrapper cannot take the shape (ragged T), and
with the reference model's attention functions at the smoke config.  Inputs
are drawn with numpy from a seed and handed to both packages.  Tolerances are
those of ``tests/test_kernels.py`` and ``tests/test_decode_kernel.py``:
float32 atol 2e-5, bfloat16 atol 2e-2, rtol 2e-2 (one bf16 rounding of the
output, and the reference stores bf16 probabilities in ``_sdpa``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro.configs import get_smoke_config
from repro.distributed.sharding import local_ctx
from repro.kernels.decode_attention import decode_attention as ref_decode_attention
from repro.kernels import ops as ref_ops
from repro.models import attention as ref_attn
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import BLOCK_S, decode_attention, decode_attention_plain
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as port_attn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2 if name == "bfloat16" else 2e-5, rtol=2e-2)


def _pair(x: np.ndarray, name: str):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(port: torch.Tensor, ref, name: str) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **_tol(name))


def _qkv(seed, B, T, S, H, KV, d, name):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, T, H, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, S, KV, d)) * 0.5).astype(np.float32)
    return [_pair(a, name) for a in (q, k, v)]


# -- K5 ----------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,T,S,H,KV,d", [
    (1, 128, 128, 2, 2, 64),   # MHA
    (2, 256, 256, 4, 2, 64),   # GQA 2:1
    (1, 128, 128, 8, 2, 128),  # GQA 4:1, d=128
    (1, 256, 256, 4, 1, 64),   # MQA
])
def test_k5_plain_matches_pallas_kernel(B, T, S, H, KV, d, name, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(T + H, B, T, S, H, KV, d, name)
    want = ref_ops.flash_attention(jq, jk, jv, causal=causal, block_q=64, block_k=64, interpret=True)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("T,H,KV,d", [(1, 4, 2, 32), (7, 4, 2, 32), (130, 8, 2, 64), (130, 32, 8, 128)])
def test_k5_plain_matches_sdpa_at_ragged_lengths(T, H, KV, d, name, causal):
    """T that no block size divides: the reference model's own attention."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(T, 1, T, T, H, KV, d, name)
    want = ref_attn._sdpa(jq, jk, jv, causal)
    _close(flash_attention(tq, tk, tv, causal=causal), want, name)


def test_k5_explicit_scale_and_wrapper_checks():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 64, 64, 4, 2, 32, "float32")
    want = ref_ops.flash_attention(jq, jk, jv, causal=True, scale=0.3, block_q=64, block_k=64,
                                   interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, scale=0.3), want, "float32")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(tq, tk[:, :, :1].expand(1, 64, 3, 32), tv[:, :, :1].expand(1, 64, 3, 32))
    with pytest.raises(TypeError, match="one type"):
        flash_attention(tq, tk.to(torch.bfloat16), tv)
    with pytest.raises(ValueError, match="q \\(B,T,H,d\\)"):
        flash_attention(tq[0], tk, tv)


def _k5_bf16_model(q, k, v, *, causal, tile=64):
    """The bf16 kernel's numerics in torch, for these tests only: f32 scores
    of the bf16 q and k with the scale applied after the product, an online
    softmax over 64-key tiles, P rounded to bf16 before P V (the running sum
    adds the rounded P), an f32 accumulator, one division by l, one cast."""
    B, T, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, T, KV, H // KV, d)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KV, H // KV, T), fa_mod.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, H // KV, T, d))
    rows = torch.arange(T)[:, None]
    for k0 in range(0, S, tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        s = torch.einsum("btkgd,bskd->bkgts", qf, kt) * d**-0.5
        if causal:
            s = s.masked_fill(rows < torch.arange(k0, k0 + kt.shape[1])[None, :], fa_mod.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).to(torch.bfloat16).float()
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum("bkgts,bskd->bkgtd", p, vt)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, d).to(torch.bfloat16)


@pytest.mark.parametrize("T", [1, 7, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [3, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_k5_bf16_numerics_model_matches_pallas_kernel(d, G, causal, T):
    """P in bf16 fits: the model of the tensor-core kernel against the
    reference Pallas kernel (interpret mode; one block where 64 does not
    divide T), on a peaked softmax (q, k at 1.5 x a unit normal)."""
    KV = 2
    rng = np.random.default_rng(1000 * d + 10 * G + T + causal)
    q = (rng.standard_normal((1, T, KV * G, d)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((1, T, KV, d)) * 1.5).astype(np.float32)
    v = rng.standard_normal((1, T, KV, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(a, "bfloat16") for a in (q, k, v)]
    blk = 64 if T % 64 == 0 else T
    want = ref_ops.flash_attention(jq, jk, jv, causal=causal, block_q=blk, block_k=blk, interpret=True)
    got = _k5_bf16_model(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, want, "bfloat16")


def test_k5_bf16_alignment_check():
    """The bf16 kernel's 16-byte copies: a misaligned base or a row stride
    that is not a multiple of 8 elements raises; a stride of a length-1 axis
    is never used and is not checked."""
    ok = torch.zeros((2, 4, 2, 32), dtype=torch.bfloat16)
    fa_mod._check_aligned(ok, ok[:, :, :1], ok.as_strided((1, 4, 2, 32), (999, 64, 32, 1)))
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa_mod._check_aligned(torch.zeros((1, 4, 2, 33), dtype=torch.bfloat16)[..., :32])
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa_mod._check_aligned(torch.zeros((1, 4, 2, 40), dtype=torch.bfloat16)[..., 1:33])


# -- K6 ----------------------------------------------------------------------


def _decode_inputs(seed, B, S, H, KV, d, name, lengths=None):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, S, KV, d)) * 0.5).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, size=B)
    lengths = np.asarray(lengths, np.int32)
    return [_pair(a, name) for a in (q, k, v)] + [(jnp.asarray(lengths), torch.from_numpy(lengths))]


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,S,H,KV,d,lengths", [
    (2, 512, 8, 2, 64, None),
    (1, 1024, 4, 4, 128, None),   # MHA
    (4, 2048, 16, 8, 64, None),   # GQA 2:1
    (2, 512, 4, 2, 64, [1, 512]),  # both edges
    (4, 300, 32, 8, 128, [1, 300, 17, 256]),  # the full config's heads, ragged S
])
def test_k6_plain_matches_pallas_kernel(B, S, H, KV, d, lengths, name):
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = _decode_inputs(S + H, B, S, H, KV, d, name, lengths)
    bs = 256 if S % 256 == 0 else S
    want = ref_decode_attention(jq, jk, jv, jl, block_s=bs, interpret=True)
    got = decode_attention(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, name)


def _k6_split_model(q, kc, vc, lengths, *, warps=4, unroll=4, gq=4):
    """K6's split in torch, for these tests only, in f32: ``BLOCK_S``-row
    blocks; in each, a warp's row groups (``32 / lanes per row`` of them,
    ``16 / itemsize`` elements a lane) each run an online softmax over their
    rows, ``unroll`` rows at a time; the row groups merge pairwise as the
    xor butterfly pairs them, the warps through the block; the visible
    blocks merge by LSE.  Query heads run in groups of ``gq``.  A slot of
    length 0 sees every position at the mask value."""
    B, H, d = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    lanes = d // (16 // q.element_size())
    rpw = 32 // lanes
    rpi = rpw * unroll * warps
    qf = q.float().reshape(B, KV, G, d) * d**-0.5
    kf, vf = kc.float().permute(0, 2, 1, 3), vc.float().permute(0, 2, 1, 3)  # (B, KV, S, d)
    ln = lengths.long()
    empty = (ln <= 0)[:, None, None, None]
    vis = torch.where(ln <= 0, S, ln.clamp(max=S))

    def merge(parts):
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        ws = [torch.exp(m - mm) for m, _, _ in parts]
        return (mm, sum(l * w for (_, l, _), w in zip(parts, ws)),
                sum(a * w[..., None] for (_, _, a), w in zip(parts, ws)))

    out = torch.zeros(B, KV, G, d)
    for g0 in range(0, G, gq):
        qg = qf[:, :, g0:g0 + gq]
        blocks = []
        for s0 in range(0, S, BLOCK_S):
            s_end = vis.clamp(max=s0 + BLOCK_S)[:, None]
            per_warp = []
            for w in range(warps):
                groups = []
                for rg in range(rpw):
                    m = torch.full(qg.shape[:3], fa_mod.NEG_INF)
                    l = torch.zeros_like(m)
                    acc = torch.zeros_like(qg)
                    for it in range(s0, s0 + BLOCK_S, rpi):
                        rows = torch.tensor([it + (w * unroll + u) * rpw + rg for u in range(unroll)])
                        ok = (rows[None, :] < s_end)[:, None, None, :]
                        rc = rows.clamp(max=S - 1)
                        sc = torch.einsum("bkgd,bkud->bkgu", qg, kf[:, :, rc])
                        sc = torch.where(empty, fa_mod.NEG_INF, sc)
                        mx = torch.maximum(m, torch.where(ok, sc, fa_mod.NEG_INF).amax(-1))
                        p = torch.where(ok, torch.exp(sc - mx[..., None]), 0.0)
                        alpha = torch.exp(m - mx)
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[..., None] + torch.einsum("bkgu,bkud->bkgd", p, vf[:, :, rc])
                        m = mx
                    groups.append((m, l, acc))
                while len(groups) > 1:  # the xor butterfly: partners 1, 2, 4 apart
                    groups = [merge(groups[i:i + 2]) for i in range(0, len(groups), 2)]
                per_warp.append(groups[0])
            blk = merge(per_warp)
            seen = (s0 < vis)[:, None, None]
            blocks.append((torch.where(seen, blk[0], fa_mod.NEG_INF), torch.where(seen, blk[1], 0.0),
                           torch.where(seen[..., None], blk[2], 0.0)))
        _, l, acc = merge(blocks)
        out[:, :, g0:g0 + gq] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(B, H, d).to(q.dtype)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 4, 7, 12, 16])
def test_k6_split_model_matches_reference_and_plain(G, d, name):
    """The kernel's split (row groups, warps, ``BLOCK_S`` blocks, heads in
    fours) against the reference's Pallas kernel (interpret mode) and the
    plain version, at lengths 0 (every position masked: the mean of v), 1,
    S and ragged, over three blocks of ``BLOCK_S``."""
    B, S, KV = 4, 3 * BLOCK_S, 2
    (jq, tq), (jk, tk), (jv, tv), (jl, tl) = _decode_inputs(
        100 * G + d, B, S, KV * G, KV, d, name, [0, 1, S, BLOCK_S + 37])
    want = ref_decode_attention(jq, jk, jv, jl, block_s=BLOCK_S, interpret=True)
    got = _k6_split_model(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, name)
    _close(got, decode_attention_plain(tq, tk, tv, tl).float(), name)
    np.testing.assert_allclose(got[0].float().numpy(), tv[0].float().mean(0).repeat_interleave(G, 0).numpy(),
                               **_tol(name))


def test_k6_alignment_check():
    """K6's 16-byte loads, by element size: a misaligned base or a row
    stride that is not a multiple of 16 bytes raises (8 bf16 or 4 f32
    elements), on q (B, H, d) and caches (B, S, KV, d) alike; a stride of a
    length-1 axis is not used."""
    ok = torch.zeros((2, 4, 3, 32), dtype=torch.bfloat16)
    fa_mod._check_aligned(ok, ok[:, :, :1], ok.float(), ok.as_strided((1, 4, 3, 32), (999, 96, 32, 1)),
                          torch.zeros((3, 4, 36))[..., :32], op="decode_attention")
    with pytest.raises(ValueError, match="decode_attention takes rows aligned to 16 bytes"):
        fa_mod._check_aligned(torch.zeros((1, 4, 2, 33), dtype=torch.bfloat16)[..., :32], op="decode_attention")
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        fa_mod._check_aligned(torch.zeros((1, 4, 2, 34))[..., 1:33], op="decode_attention")
    with pytest.raises(ValueError, match="multiples of 4"):
        fa_mod._check_aligned(torch.zeros((3, 4, 34))[..., :32], op="decode_attention")


def test_k6_reads_a_strided_cache_view_in_place():
    """A layer's slice and a slot's slice of the stacked cache are views;
    the wrapper takes them as they are."""
    (_, tq), (_, tk), (_, tv), (_, tl) = _decode_inputs(5, 3, 64, 4, 2, 32, "float32", [3, 64, 1])
    stacked_k = torch.stack([torch.zeros_like(tk), tk])  # (L, B, S, KV, d)
    stacked_v = torch.stack([torch.zeros_like(tv), tv])
    want = decode_attention_plain(tq[1:2], tk[1:2], tv[1:2], tl[1:2])
    got = decode_attention(tq[1:2], stacked_k[1][1:2], stacked_v[1][1:2], tl[1:2])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-2)


def test_k6_wrapper_checks():
    (_, tq), (_, tk), (_, tv), (_, tl) = _decode_inputs(6, 2, 32, 4, 2, 32, "float32")
    with pytest.raises(ValueError, match="lengths must be"):
        decode_attention(tq, tk, tv, tl[:1])
    with pytest.raises(TypeError, match="one type"):
        decode_attention(tq.to(torch.bfloat16), tk, tv, tl)
    with pytest.raises(ValueError, match="caches"):
        decode_attention(tq, tk[0], tv[0], tl)


def test_cpu_calls_never_launch_or_build():
    build.reset_launches()
    (_, tq), (_, tk), (_, tv) = _qkv(1, 1, 8, 8, 4, 2, 32, "float32")
    flash_attention(tq, tk, tv)
    (_, dq), (_, dk), (_, dv), (_, dl) = _decode_inputs(1, 2, 16, 4, 2, 32, "float32")
    decode_attention(dq, dk, dv, dl)
    assert build.LAUNCHES["flash_attention"] == 0 and build.LAUNCHES["decode_attention"] == 0
    assert set(build.LAUNCHES) >= {"row_sort", "tournament", "flash_attention", "decode_attention"}
    assert "flash_attention" not in build._LIBS and "decode_attention" not in build._LIBS


# -- the model's attention layer, with the reference's weights -----------------


@pytest.fixture(scope="module")
def attn_pair():
    cfg = dataclasses.replace(get_smoke_config("mistral-nemo-12b"), dtype="float32")
    params = ref_attn.init_attn(jax.random.PRNGKey(1), cfg, jnp.float32)
    p = port_attn.Attention(cfg, torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return cfg, params, p


@pytest.mark.parametrize("T", [1, 9, 33])
def test_prefill_attention_matches_reference(attn_pair, T):
    cfg, params, p = attn_pair
    x = (np.random.default_rng(T).standard_normal((2, T, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.arange(T)[None, :]
    want, (wk, wv) = ref_attn.attention(params, cfg, local_ctx(), jnp.asarray(x), jnp.asarray(pos),
                                        return_kv=True)
    got, (gk, gv) = port_attn.attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                        return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-2)


def test_decode_attention_matches_reference(attn_pair):
    """Writes the token at ``pos`` (a position past the cache is dropped)
    and attends to positions <= pos."""
    cfg, params, p = attn_pair
    B, S, KV, hd = 4, 16, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    kc = (rng.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((B, S, KV, hd)) * 0.5).astype(np.float32)
    pos = np.asarray([0, 5, S - 1, S + 3], np.int32)
    want, wk, wv = ref_attn.decode_attention(params, cfg, local_ctx(), jnp.asarray(x), jnp.asarray(kc),
                                             jnp.asarray(vc), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, gk, gv = port_attn.decode_attention(p, cfg, torch.from_numpy(x), tk, tv, torch.from_numpy(pos))
    assert gk is tk and gv is tv  # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-2)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=2e-5, rtol=2e-2)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=2e-5, rtol=2e-2)
