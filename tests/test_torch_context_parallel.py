"""Attention at a tp that does not divide the kv heads, held against the JAX
package: K5 and K5b with a query offset, the reference's
``use_context_parallel``, and the LM's two layouts there on a (1, 4) mesh --
context-parallel under SP (tp-replicated attention weights, each rank its T
rows against the gathered K/V) and column-split without it (the q/k/v
columns cut through heads) -- in training, serving and checkpoints.

The smoke configs have 2 kv heads, so tp = 4 is the mesh where both layouts
fire (Nemotron's 6 query heads are 1.5 a rank).  The reference runs in two
subprocesses side by side, on 4 fake CPU devices (the (1, 4) mesh) and on 8
(the (2, 4) FSDP mesh, its CLIs); the port as 4 gloo ranks (``cp_rank``)
and 8 (``cp_fsdp_rank``), each once for the file
(``tests/_torch_dist_workers.py``).  Both read the same inputs: the smoke
LMs' parameters in f32 drawn with numpy, and the token batches.

Tolerances: the kernels' plain versions those of ``tests/test_kernels.py``
for f32 (atol 2e-5, rtol 2e-3); the LM's those of
``tests/test_torch_lm_sharded.py``: loss rtol 1e-5, every gradient leaf
atol 1e-5 + rtol 1e-4 (under granite's a2a MoE, whose all_to_all sends
bf16 cotangents, within 2^-7 of the leaf's largest magnitude), logits atol
1e-4 with greedy tokens equal, parameters after two AdamW steps atol 1e-5 +
rtol 1e-4 but for one element in 10,000 of a leaf held within 2 * lr,
checkpoint records within 1e-5.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from repro import configs as ref_configs
from repro.distributed.sharding import ShardCtx as RefShardCtx
from repro.models import attention as ref_attn
from repro_torch import configs
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.models import attention as attn
from repro_torch.models.lm import LM, block_kind

ARCHS = list(configs.ALIASES)


# -- K5 and K5b with a query offset ---------------------------------------------------


def _qkv(S=96, B=2, H=4, KV=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, d), (B, S, KV, d), (B, S, KV, d), (B, S, H, d)))


#: Row splits of S = 96 into a rank's chunks: equal ones (T 24, offsets multiples
#: of neither tile nor 64) and ragged ones ending before and at S.
SPLITS = {"equal": (0, 24, 48, 72, 96), "ragged": (0, 20, 44, 83, 96), "short": (0, 5, 37)}


@pytest.mark.parametrize("split", list(SPLITS))
def test_k5_plain_with_offset_gives_the_reference_rows(split):
    """K5's plain version on each chunk of q rows, at its offset, against
    the rows of the reference's ``_sdpa`` over the whole sequence, and each
    chunk's lse against the reference flash forward's."""
    q, k, v, _ = _qkv()
    want = np.asarray(ref_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    lse = np.asarray(ref_attn._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)[1][4])
    lse = lse.reshape(q.shape[0], q.shape[2], q.shape[1])  # (B, KV, G, T) -> (B, H, T)
    cuts = SPLITS[split]
    for a, b in zip(cuts, cuts[1:]):
        out, got_lse = flash_attention(torch.from_numpy(q[:, a:b]), torch.from_numpy(k), torch.from_numpy(v),
                                       return_lse=True, q_offset=a)
        np.testing.assert_allclose(out.numpy(), want[:, a:b], atol=2e-5, rtol=2e-3, err_msg=f"rows {a}:{b}")
        np.testing.assert_allclose(got_lse.numpy(), lse[..., a:b], atol=2e-5, rtol=2e-3)


@pytest.mark.parametrize("split", list(SPLITS))
def test_k5b_plain_with_offset_sums_to_the_reference_gradient(split):
    """K5b's plain version on each chunk (its o and lse from K5 at the same
    offset): dq concatenated, dk and dv summed over the chunks, against
    ``jax.grad`` of the reference's ``_sdpa``; a chunk's dk and dv past the
    keys its rows see are exactly 0."""
    q, k, v, dout = _qkv()
    cuts = SPLITS[split]
    end = cuts[-1]  # the chunks' rows; rows past them take no part in the loss

    def loss(q_, k_, v_):
        return jnp.sum(ref_attn._sdpa(q_, k_, v_, True)[:, :end] * dout[:, :end])

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    dqs, dk, dv = [], 0, 0
    for a, b in zip(cuts, cuts[1:]):
        qt, dot = torch.from_numpy(q[:, a:b]), torch.from_numpy(dout[:, a:b])
        o, lse = flash_attention(qt, kt, vt, return_lse=True, q_offset=a)
        gq, gk, gv = flash_attention_bwd(qt, kt, vt, o, dot, lse, q_offset=a)
        assert not gk[:, b:].any() and not gv[:, b:].any()
        dqs.append(gq)
        dk, dv = dk + gk, dv + gv
    for got, w in zip((torch.cat(dqs, 1), dk, dv), (want[0][:, :end], want[1], want[2])):
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=2e-3)


def test_q_offset_zero_is_the_call_without_it():
    q, k, v, dout = (torch.from_numpy(t) for t in _qkv())
    o, lse = flash_attention(q, k, v, return_lse=True)
    o0, lse0 = flash_attention(q, k, v, return_lse=True, q_offset=0)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    for a, b in zip(flash_attention_bwd(q, k, v, o, dout, lse), flash_attention_bwd(q, k, v, o, dout, lse, q_offset=0)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="non-negative"):
        flash_attention(q, k, v, q_offset=-1)
    # without the causal mask the offset changes nothing
    assert torch.equal(flash_attention(q, k, v, causal=False, q_offset=40), flash_attention(q, k, v, causal=False))


# -- the layouts ------------------------------------------------------------------------


#: (layout, tp, the most q heads a rank's K5 runs in the column split) of
#: the rank bodies' test, on starcoder2's smoke config (bias, RoPE) with 6 q
#: heads and 2 kv heads of 24: context-parallel; the column split with each
#: rank's heads in one kv group (half a head a rank, 1.5 heads a rank: the
#: heads holding its columns) and spanning two (two heads a rank across a
#: group's end: both whole groups).
RANK_CASES = {"context": ("context", 4, None), "columns-half-head": ("columns", 12, 1),
              "columns-1.5-heads": ("columns", 4, 2), "columns-two-groups": ("columns", 3, 6)}


@pytest.fixture(scope="module")
def rank_ref():
    """(cfg, numpy params, x, dy, positions, the reference's output, its
    gradients of the params and of x) for :data:`RANK_CASES`."""
    from repro.distributed.sharding import local_ctx

    kw = dict(num_heads=6, num_kv_heads=2, head_dim=24, dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config("starcoder2-15b"), **kw)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("starcoder2-15b"), **kw)
    B, T, D = 2, 48, cfg.d_model
    params = {k: np.asarray(v) for k, v in ref_attn.init_attn(jax.random.PRNGKey(3), ref_cfg, jnp.float32).items()}
    rng = np.random.default_rng(5)
    params.update({k: rng.standard_normal(v.shape).astype(np.float32) * 0.1 for k, v in params.items() if k[0] == "b"})
    x = (rng.standard_normal((B, T, D)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T))

    def ref_loss(prm, x_):
        y = ref_attn.attention(prm, ref_cfg, local_ctx(), x_, jnp.asarray(pos))
        return jnp.sum(y * dy), y

    (_, y), (gp, gx) = jax.value_and_grad(ref_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return cfg, params, x, dy, pos, np.asarray(y), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_bodies_sum_to_the_reference_attention(rank_ref, case):
    """Every rank's body of a layout, run in one process (``context_project``
    and ``context_rank`` on the rank's rows against the concatenated K/V;
    ``column_rank`` on the whole projection with the rank's rows of ``wo``,
    summed), against the reference's one-device ``attention``: the output
    and ``jax.grad`` of x and of every weight (atol 1e-5 + rtol 1e-4)."""
    layout, tp, most = RANK_CASES[case]
    cfg, params, x, dy, pos, want_y, want_gp, want_gx = rank_ref
    T = x.shape[1]
    p = attn.Attention(cfg, torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    p.requires_grad_(True)
    xt, post = torch.from_numpy(x.copy()).requires_grad_(True), torch.from_numpy(pos.copy())
    if layout == "context":
        tl = T // tp
        qkv = [attn.context_project(p, cfg, xt[:, r * tl:(r + 1) * tl], post, r) for r in range(tp)]
        k, v = torch.cat([t[1] for t in qkv], 1), torch.cat([t[2] for t in qkv], 1)
        y = torch.cat([attn.context_rank(cfg, q, k, v, p.wo, r) for r, (q, _, _) in enumerate(qkv)], 1) + p.bo
    else:
        q, k, v = attn.project_qkv(p, cfg, xt, post)
        n = p.wo.shape[0] // tp
        y = sum(attn.column_rank(cfg, q, k, v, p.wo[r * n:(r + 1) * n], r, tp) for r in range(tp)) + p.bo
    names = [n_ for n_, _ in p.named_parameters()]
    grads = torch.autograd.grad(y, [xt, *p.parameters()], torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_gx), atol=1e-5, rtol=1e-4)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_gp[name]), atol=1e-5, rtol=1e-4, err_msg=name)
    if layout == "columns":
        assert max(h1 - h0 for h0, h1, *_ in (attn._column_heads(cfg, r, tp) for r in range(tp))) == most


def _fake_ctx(tp: int, sp: bool, data: int = 1):
    """A ShardCtx whose mesh answers only its axes' sizes: enough for the
    layout decisions and the modules' shapes, no process group."""
    sizes = {"data": data, "model": tp}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), size=lambda i: list(sizes.values())[i])
    return ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",), sp=sp)


def _ref_ctx(tp: int, sp: bool):
    return RefShardCtx(mesh=types.SimpleNamespace(shape={"data": 1, "model": tp}), tp="model", fsdp=None,
                       dp=("data",), sp=sp)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_use_context_parallel_matches_reference(smoke):
    """Every config, tp 1..16, SP on and off: the port's decision is the
    reference's."""
    n = 0
    for arch in ARCHS:
        get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config) if smoke
                        else (configs.get_config, ref_configs.get_config))
        cfg, ref_cfg = get(arch), ref_get(arch)
        for tp in (1, 2, 3, 4, 6, 8, 16):
            for sp in (False, True):
                want = ref_attn.use_context_parallel(ref_cfg, _ref_ctx(tp, sp))
                assert attn.use_context_parallel(cfg, _fake_ctx(tp, sp)) == want, (arch, tp, sp)
                n += want
    assert n > 10


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_every_dense_and_moe_attention_builds_at_any_tp(tp):
    """Each dense and MoE config's attention at tp where its ``H*hd`` and
    ``KV*hd`` columns divide (on the meta device, full width): the
    column-split or head layout without SP, context-parallel (whole columns)
    with SP where tp does not divide the kv heads; starcoder2-15b's 4 kv
    heads at tp 8 among them.  A tp that does not divide the columns raises
    ValueError, as the reference's spec would fail."""
    seen = set()
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        if block_kind(cfg) not in ("dense", "moe"):
            continue
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        for sp in (False, True):
            ctx = _fake_ctx(tp, sp)
            cp = attn.use_context_parallel(cfg, ctx)
            if not cp and (H * hd % tp or KV * hd % tp):
                with pytest.raises(ValueError, match="do not split"):
                    attn.Attention(cfg, torch.float32, "meta", ctx)
                continue
            a = attn.Attention(cfg, torch.float32, "meta", ctx)
            cols = 1 if cp else tp
            assert a.wq.shape == (cfg.d_model, H * hd // cols) and a.wk.shape == (cfg.d_model, KV * hd // cols)
            assert a.wo.shape == (H * hd // cols, cfg.d_model)
            seen.add((arch, attn.attn_layout(cfg, ctx)))
    if tp == 8:
        assert {("starcoder2-15b", "columns"), ("starcoder2-15b", "context")} <= seen


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m", "nemotron-4-340b", "starcoder2-15b",
                                  "deepseek-moe-16b", "command-r-plus-104b"])
def test_smoke_lm_builds_at_tp4(arch):
    """``LM(cfg, ctx)`` at tp 4, SP off and on, for the smoke dense and MoE
    configs: the attention leaves' specs are the reference's ``spec_attn``."""
    cfg = configs.get_smoke_config(arch)
    ref_cfg = ref_configs.get_smoke_config(arch)
    for sp in (False, True):
        model = LM(cfg, _fake_ctx(4, sp), device="cpu")
        want = ref_attn.spec_attn(ref_cfg, _ref_ctx(4, sp))
        for name, spec in model.param_specs().items():
            parent, leaf = name.split(".")[-2:]
            if parent == "attn":
                assert spec == tuple(want[leaf]), (name, spec, want[leaf])
        cp = ref_attn.use_context_parallel(ref_cfg, _ref_ctx(4, sp))
        assert attn.use_context_parallel(cfg, model.ctx) == cp
        assert model.layers[0].attn.wq.shape[1] == cfg.num_heads * cfg.resolved_head_dim // (1 if cp else 4)


# -- the LM on the (1, 4) and (2, 4) meshes ---------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, the (1, 4) ranks' npz, the (2, 4) ranks' npz,
    the run's directory)."""
    d = tmp_path_factory.mktemp("cp")
    workers.cp_inputs(d / "inputs.npz")
    refs = [workers.start_reference("ref_cp_train", d / "ref_train.npz", devices=4),
            workers.start_reference("ref_cp_rest", d / "ref_rest.npz", devices=8)]
    started = []
    try:
        started = [workers.start_ranks(workers.cp_rank, d / "mesh", 4),
                   workers.start_ranks(workers.cp_fsdp_rank, d / "fsdp", 8)]
        mesh, fsdp = (workers.join_ranks(pc) for pc in started)
    except BaseException:
        for pc in started:
            for p in pc.processes:
                if p.is_alive():
                    p.kill()
        for ref in refs:
            ref.kill()
            ref.communicate()
        raise
    for ref in refs:
        workers.finish_reference(ref)
    ref = {**np.load(d / "ref_train.npz"), **np.load(d / "ref_rest.npz")}
    return ref, mesh, fsdp, d


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", [c[0] for c in workers.CP_TRAIN])
def test_loss_and_every_gradient_leaf_match_reference(runs, case):
    """Mistral context-parallel (SP) and column-split (no SP), granite
    context-parallel with the a2a MoE: the layout decision, the loss, ce and
    aux on every rank, and every gradient leaf gathered whole, against
    ``jax.value_and_grad`` of the reference LM on its (1, 4) mesh."""
    ref, ranks, _, _ = runs
    assert bool(ref[f"{case}/cp"]) == case.endswith("_c")
    for r in ranks:
        assert bool(r[f"{case}/cp"]) == bool(ref[f"{case}/cp"])
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(r[f"{case}/{k}"], ref[f"{case}/{k}"], rtol=1e-5, atol=1e-7)
    want, got = _leaves(ref, f"{case}/grad/"), _leaves(ranks[0], f"{case}/grad/")
    assert set(got) == set(want) and len(want) > 10
    for k in want:
        if case.startswith("granite"):  # bf16 cotangents through the a2a
            assert np.abs(got[k] - want[k]).max() <= 2**-7 * np.abs(want[k]).max(), k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("layout", ["c", "b"])
@pytest.mark.parametrize("arch", workers.CP_SERVE_ARCHS)
def test_prefill_and_greedy_decode_match_reference(runs, arch, layout):
    """Prefill of 14 tokens and 4 greedy steps on the sequence-sharded cache
    (8 positions a rank): a context-parallel module (built under SP; its
    whole attention weights on every rank) and a column-split one (Nemotron:
    1.5 query heads a rank), against the reference's serving context."""
    ref, ranks, _, _ = runs
    for r in ranks:
        assert bool(r[f"serve/{arch}/{layout}/cp"]) == (layout == "c")
        for i in range(workers.CP_SERVE["steps"] + 1):
            np.testing.assert_allclose(r[f"serve/{arch}/{layout}/logits{i}"], ref[f"serve/{arch}/logits{i}"],
                                       atol=1e-4, rtol=0, err_msg=f"step {i}")
            np.testing.assert_array_equal(r[f"serve/{arch}/{layout}/tokens{i}"], ref[f"serve/{arch}/tokens{i}"])


def test_fsdp_context_parallel_adamw_steps_match_reference(runs):
    """``build_train_step`` on the (2, 4) mesh with FSDP over data and SP
    (the attention tp-replicated, cut over fsdp alone; its gradient summed
    over tp, counted once in the clip's norm) against the reference's jitted
    step: loss and norm per step, then every parameter."""
    ref, _, ranks, _ = runs
    assert bool(ref["adamw/cp"]) and all(bool(r["adamw/cp"]) for r in ranks)
    for i in range(2):
        assert float(ref[f"adamw/grad_norm{i}"]) > workers.OPT["grad_clip"]
        for r in ranks:
            np.testing.assert_allclose(r[f"adamw/loss{i}"], ref[f"adamw/loss{i}"], rtol=1e-5)
            np.testing.assert_allclose(r[f"adamw/grad_norm{i}"], ref[f"adamw/grad_norm{i}"], rtol=1e-5)
    want, got = _leaves(ref, "adamw/params/"), _leaves(ranks[0], "adamw/params/")
    assert set(got) == set(want)
    lr = workers.OPT["lr"]
    for k in want:
        off = np.abs(got[k] - want[k]) > 1e-5 + 1e-4 * np.abs(want[k])
        assert off.sum() <= max(1, off.size // 10_000), (k, off.sum())
        assert np.abs(got[k] - want[k]).max() <= 2 * lr, k


def test_context_parallel_checkpoint_resumes_at_1x1_and_in_the_reference_cli(runs):
    """The training CLI's loop on the (1, 4) mesh under SP (context-parallel
    attention), four steps checkpointing at 2 and 4; its step-4 checkpoint
    set aside, the port's CLI at ``--mesh 1x1`` and the reference's CLI
    resume its directory from step 2, and their steps 2 and 3 equal the
    uninterrupted run's within 1e-5."""
    ref, _, _, d = runs
    first = dict(np.load(d / "mesh" / "cli_c.npz"))
    assert list(first["step"]) == [0, 1, 2, 3]
    legs = {"resume_c": dict(np.load(d / "mesh" / "resume_c.npz")), "resume_ref_c": _leaves(ref, "resume_ref_c/")}
    for leg, rec in legs.items():
        assert list(rec["step"]) == [2, 3], leg
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(rec[k], first[k][2:], rtol=1e-5, atol=1e-5, err_msg=f"{leg} {k}")


def test_serve_cli_at_1x4_matches_the_reference_cli(runs):
    """``launch.serve --arch mistral-nemo-12b --smoke --mesh 1x4`` (2 kv heads
    over tp 4: column-split) against the reference's CLI at the same mesh on
    4 fake devices, both on the inputs' f32 weights: every request's tokens,
    on every rank."""
    ref, ranks, _, _ = runs
    want = ref["serve_cli/tokens"]
    assert want.shape == (8, 16)
    for r in ranks:
        np.testing.assert_array_equal(r["serve_cli/tokens"], want)
