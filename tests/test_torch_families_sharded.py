"""The encoder-decoder and the precomputed-embedding inputs on a (data, model)
mesh, held against the JAX package: whisper-small under tensor, sequence and
FSDP parallelism in its three attention layouts, trained, checkpointed and
served from its sequence-sharded self and cross caches; llava-next-34b's
backbone and the hybrid, Mamba2 and RWKV6 kinds from embeddings.

The reference runs on 4 fake CPU devices in two subprocesses side by side
(``tests/_torch_dist_workers.py``: ``ref_fam``), the port as 4 gloo ranks
(``fam_rank``), each once for the file; both read the same inputs
(``fam_inputs``: each smoke model's parameters in f32 drawn with numpy, the
attention's and MLP's biases among them, and batches of B 4).  The cases
(``FAM_TRAIN``): whisper (4 heads) at (2, 2) with FSDP over data and at (1,
4) with and without SP, all ``"heads"``; its 6-head variant at (2, 2)
(``"heads"``) and at (1, 4) (``"columns"``, and ``"context"`` under SP);
whisper at (1, 4) under SP on a batch of 22 frames and 10 tokens, which tp
4 divides neither (the reference cuts them unevenly; the port runs those
stacks without SP, the same function); llava (2 kv heads) at (2, 2)
(``"heads"``) and (1, 4) (``"columns"``, ``"context"``), and under SP on 10
rows (its context-parallel weights then attend whole on every rank); the recurrent
models at (1, 4), and on one device in this process.  The reference's loss
is the same function on every mesh, so it is computed once a model and batch.

Tolerances are ``test_torch_lm_sharded.py``'s: loss rtol 1e-5, every
gradient leaf atol 1e-5 + rtol 1e-4, prefill logits atol 1e-4, tokens
equal, parameters after two AdamW steps atol 1e-5 + rtol 1e-4 but for one
element in 10,000 of a leaf held within 2 * lr (whisper's key biases, whose
exact gradient is zero, within 2 * lr: ``KEY_BIASES``); the caches atol and rtol
1e-4 (``test_torch_encdec.py``'s float32 tolerance).  rwkv6's gradients get
``test_torch_recurrent_sharded.py``'s allowance of 3e-5 of each leaf's
largest magnitude (its embedding path sums many rows' rounding).
"""

import types

import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from repro_torch import configs
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.models import attention as attn_mod
from repro_torch.models.convert import params_to_reference

#: rwkv6's gradient leaves against the reference (the module docstring).
RWKV_GRAD_SCALE_TOL = 3e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
CACHE_TOL = dict(atol=1e-4, rtol=1e-4)
#: The attention layout each training case runs (``attn_layout``).
LAYOUTS = {"whisper_2x2": "heads", "whisper_1x4": "heads", "whisper_1x4_sp": "heads",
           "whisper_ragged_1x4_sp": "heads", "whisper6_2x2": "heads", "whisper6_1x4": "columns",
           "whisper6_1x4_sp": "context", "llava_2x2": "heads", "llava_1x4": "columns", "llava_1x4_sp": "context",
           "llava_ragged_1x4_sp": "context",
           "zamba2_1x4_sp": "heads", "mamba_1x4": None, "rwkv6_1x4_sp": None}
#: The attention key biases: a key bias adds ``q . bk`` to every logit of a
#: softmax row, so its exact gradient is zero and both sides' are rounding
#: (held by the gradient test's atol); AdamW divides that rounding by its own
#: root mean square, so each element moves by up to about lr in a direction
#: either side may round the other way: after two steps they are held within
#: 2 * lr, not elementwise.
KEY_BIASES = ("encoder/attn/bk", "decoder/attn/bk", "decoder/xattn/bk")
CASES = {tag: (name, mesh, sp, batch) for tag, name, mesh, sp, batch in workers.FAM_TRAIN}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's npz, the mesh's 4 ranks' npz)."""
    d = tmp_path_factory.mktemp("fam_sharded")
    workers.fam_inputs(d / "inputs.npz")
    refs = [workers.start_reference("ref_fam_grads", d / "ref_grads.npz", devices=4),
            workers.start_reference("ref_fam_rest", d / "ref_rest.npz", devices=4)]
    try:
        ranks = workers.spawn_ranks(workers.fam_rank, d / "mesh", 4)
    except BaseException:
        for ref in refs:
            ref.kill()
            ref.communicate()
        raise
    for ref in refs:
        workers.finish_reference(ref)
    ref = {**np.load(d / "ref_grads.npz"), **np.load(d / "ref_rest.npz")}
    return dict(np.load(d / "inputs.npz")), ref, ranks


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _rows(a, rank, mesh):
    """Rank ``rank``'s data-parallel rows of a global batch-first array."""
    n = a.shape[0] // mesh[0]
    d = rank // mesh[1]
    return a[d * n : (d + 1) * n]


def _fake_ctx(data: int, tp: int, sp: bool):
    """A ShardCtx whose mesh answers only its axes' sizes, every coordinate 0."""
    sizes = {"data": data, "model": tp}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), size=lambda i: list(sizes.values())[i],
                                 get_local_rank=lambda name: 0)
    return ShardCtx(mesh=mesh, tp="model", fsdp="data" if data > 1 else None, dp=("data",), sp=sp)


def _grads_close(got: dict, want: dict, name: str):
    assert set(got) == set(want) and len(want) > 10
    for k in want:
        scale = RWKV_GRAD_SCALE_TOL * np.abs(want[k]).max() if name == "rwkv6" else 0.0
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_TOL["atol"] + scale, rtol=GRAD_TOL["rtol"], err_msg=k)


def _params_close(got: dict, want: dict):
    """Parameters after AdamW steps (the module docstring's rule; a key
    bias within 2 * lr alone)."""
    assert set(got) == set(want)
    lr = workers.OPT["lr"]
    for k in want:
        off = np.abs(got[k] - want[k]) > 1e-5 + 1e-4 * np.abs(want[k])
        assert k in KEY_BIASES or off.sum() <= max(1, off.size // 10_000), (k, off.sum())
        assert np.abs(got[k] - want[k]).max() <= 2 * lr, k


# -- layouts, in process ---------------------------------------------------------------


@pytest.mark.parametrize("tag", list(CASES))
def test_each_case_runs_its_layout(tag):
    """The case's attention layout (whisper's 6-head variant and llava's 2 kv
    heads split through heads or run context-parallel at tp 4) and, under
    SP, which stacks run sequence-parallel: all, but on the ragged batches
    none."""
    name, mesh, sp, batch = CASES[tag]
    cfg = workers.fam_cfg(name, configs.get_smoke_config)
    ctx = _fake_ctx(*mesh, sp)
    want = LAYOUTS[tag]
    if want is not None:
        assert attn_mod.attn_layout(cfg, ctx) == want
    model = workers.shards_at_spec(cfg, ctx)
    lengths = workers.FAM_RAGGED if batch == "ragged" else (workers.FAM_S, workers.FAM_T)
    assert [model._seq_sharded(n) for n in lengths] == [sp and batch != "ragged"] * 2


# -- training ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(CASES))
def test_loss_and_every_gradient_leaf_match_reference(runs, tag):
    """The loss and ce on every rank and every gradient leaf (summed over
    its replicated axes by ``sync_grads``, gathered whole) against
    ``jax.value_and_grad`` of the reference model on its mesh; an
    embeddings model's untied table gets a zero gradient on both sides.
    The loss's metrics say which stacks ran sequence-parallel: under SP
    all, but on the ragged batches none."""
    _, ref, ranks = runs
    name, _, sp, batch = CASES[tag]
    want_tag = name if batch == "0" else f"{name}_{batch}"
    stacks = ("encoder", "decoder") if name in workers.FAM_ENCDEC else ("",)
    for r in ranks:
        for k in ("loss", "ce"):
            np.testing.assert_allclose(r[f"{tag}/{k}"], ref[f"{want_tag}/{k}"], rtol=1e-5, atol=1e-7)
        for stack in stacks:
            assert bool(r[f"{tag}/seq_parallel{'_' if stack else ''}{stack}"]) == (sp and batch != "ragged")
    want, got = _leaves(ref, f"{want_tag}/grad/"), _leaves(ranks[0], f"{tag}/grad/")
    _grads_close(got, want, name)
    if name in workers.FAM_ENCDEC:
        assert np.abs(want["decoder/xattn/wk"]).max() > 0 and np.abs(want["encoder/attn/wq"]).max() > 0
    else:
        assert not got["embed/table"].any() and not want["embed/table"].any()


@pytest.mark.parametrize("name", workers.FAM_RECURRENT)
def test_recurrent_kinds_from_embeddings_on_one_device_match_reference(runs, name):
    """The hybrid, Mamba2 and RWKV6 smoke models from embeddings on one
    device, in this process: the loss, every gradient leaf, the prefill
    logits and the greedy tokens against the reference."""
    inputs, ref, _ = runs
    out, grads = workers.fam_grads(inputs, name, None)
    np.testing.assert_allclose(out["loss"], ref[f"{name}/loss"], rtol=1e-5, atol=1e-7)
    _grads_close(grads, _leaves(ref, f"{name}/grad/"), name)
    got = workers.fam_serve(inputs, name, None, full=True)
    np.testing.assert_allclose(got["logits"], ref[f"prefill/{name}/logits"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["tokens"], ref[f"decode/{name}/tokens"])


@pytest.mark.parametrize("name", workers.FAM_ADAMW)
def test_two_adamw_steps_match_reference(runs, name):
    """``build_train_step`` at (2, 2) with FSDP against the reference's
    jitted step, the clip active: loss and norm per step, then every
    parameter (llava's untied table decayed alone, its gradient zero)."""
    _, ref, ranks = runs
    for i in range(2):
        assert float(ref[f"adamw/{name}/grad_norm{i}"]) > workers.OPT["grad_clip"]
        for r in ranks:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(r[f"adamw/{name}/{k}{i}"], ref[f"adamw/{name}/{k}{i}"], rtol=1e-5)
    _params_close(_leaves(ranks[0], f"adamw/{name}/params/"), _leaves(ref, f"adamw/{name}/params/"))


@pytest.mark.parametrize("name", workers.FAM_ADAMW)
def test_checkpoint_resumes_across_meshes(runs, name):
    """The (2, 2) FSDP run's step-1 checkpoint (the reference's whole trees,
    ``CheckpointManager``) restored at (1, 4) under SP (whisper's stacks
    sequence-parallel; llava's attention context-parallel) takes the second
    step as the (2, 2) run and the reference did."""
    _, ref, ranks = runs
    for r in ranks:
        assert int(r[f"resume/{name}/step"]) == 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[f"resume/{name}/{k}"], r[f"adamw/{name}/{k}1"], rtol=1e-5)
    got = _leaves(ranks[0], f"resume/{name}/params/")
    _params_close(got, _leaves(ranks[0], f"adamw/{name}/params/"))
    _params_close(got, _leaves(ref, f"adamw/{name}/params/"))


# -- serving ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", list(workers.FAM_MODELS))
def test_prefill_logits_match_reference(runs, name, mesh):
    """Each rank's rows of the prefill logits (padded vocab, pads at -1e30)
    on the serving context of each mesh (no SP: whisper's 6 heads and
    llava's 2 kv heads split through heads at tp 4)."""
    _, ref, ranks = runs
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"serve/{name}/{mesh[0]}x{mesh[1]}/logits"],
                                   _rows(ref[f"prefill/{name}/logits"], rank, mesh), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(workers.FAM_MODELS))
def test_greedy_tokens_equal_reference(runs, name):
    """Greedy decode at (1, 4) from the prefill: every rank's tokens equal
    the reference's (the first step under the host-read guard: the cross
    decode reads nothing on the host)."""
    _, ref, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r[f"serve/{name}/1x4/tokens"], ref[f"decode/{name}/tokens"])


@pytest.mark.parametrize("name", ["whisper", "whisper6", "llava"])
def test_caches_match_reference_leaf_by_leaf(runs, name):
    """The sequence-sharded caches at (1, 4), each leaf gathered over tp,
    against the reference's after the prefill and after the greedy steps:
    whisper's self ``k``/``v`` and cross ``xk``/``xv`` (the rank's S chunk of
    every head, written from the layout's heads), llava's ``k``/``v``."""
    _, ref, ranks = runs
    want = {"cache": _leaves(ref, f"prefill/{name}/cache/"), "decode_cache": _leaves(ref, f"decode/{name}/cache/")}
    keys = {"pos", "k", "v", "xk", "xv"} if name in workers.FAM_ENCDEC else {"pos", "k", "v"}
    for r in ranks:
        for tag, leaves in want.items():
            got = _leaves(r, f"serve/{name}/1x4/{tag}/")
            assert set(got) == set(leaves) == keys
            for k in keys:
                np.testing.assert_allclose(got[k], leaves[k], err_msg=f"{tag}/{k}", **CACHE_TOL)
    prompt = workers.FAM_SERVE["prompt" if name in workers.FAM_ENCDEC else "rows"]
    assert np.abs(want["cache"]["k"][:, :, prompt:]).max() == 0 < np.abs(want["cache"]["k"][:, :, :prompt]).max()


def test_params_round_trip_on_the_mesh_layouts():
    """``params_to_reference`` of a rank grid's shards joined in one process
    (``merge_shards``) is the whole tree, for whisper's cross-attention
    leaves at tp 2 with fsdp 2 (no process group)."""
    from repro_torch import models
    from repro_torch.models.convert import merge_shards, params_from_reference

    cfg = workers.fam_cfg("whisper", configs.get_smoke_config)
    whole = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0)).state_dict()
    tree = params_to_reference(whole)
    ctx = ShardCtx.grid(model=(0, 2), data=(0, 2))
    states = [[params_from_reference(tree, ShardCtx.grid(model=(t, 2), data=(f, 2)), cfg) for f in range(2)]
              for t in range(2)]
    assert states[1][0]["decoder.0.xattn.wq"].shape == (cfg.d_model // 2, cfg.num_heads * cfg.resolved_head_dim // 2)
    merged = merge_shards(states, ctx, cfg)
    assert set(merged) == set(whole)
    for k, v in whole.items():
        assert torch.equal(merged[k], v), k


@pytest.mark.parametrize("name", ["whisper", "llava"])
def test_meta_twin_shares_the_models_tensors(name):
    """``models.build(cfg, ctx, device="meta")`` allocates nothing; a state
    dict assigned to it (``load_state_dict(assign=True)``) makes it the
    model's twin on ``ctx``, its parameters the model's own tensors, its
    prefill the same bytes: how the card's (1, 1)-mesh check holds llava's
    68.8 GB once."""
    from repro_torch import models

    cfg = workers.fam_cfg(name, configs.get_smoke_config)
    model = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    ctx = ShardCtx.grid(model=(0, 1), data=(0, 1))
    twin = models.build(cfg, ctx=ctx, device="meta")
    assert all(p.is_meta for p in twin.parameters())
    twin.load_state_dict(model.state_dict(), assign=True)
    assert twin.ctx is ctx and twin.device == torch.device("cpu")
    assert all(a.data_ptr() == b.data_ptr() and not b.requires_grad
               for a, b in zip(model.parameters(), twin.parameters(), strict=True))
    rng = np.random.default_rng(0)
    if cfg.is_encdec:
        prompt = {"enc_embeds": torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)),
                  "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 3)))}
        logits = [m.prefill(prompt, m.init_cache(2, 8, 8))[0] for m in (model, twin)]
    else:
        x = torch.from_numpy(rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32))
        logits = [m.prefill(x, m.init_cache(2, 8))[0] for m in (model, twin)]
    assert torch.equal(*logits)
    with pytest.raises(ValueError, match="unsupported device"):
        models.build(cfg, device="xla")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_length_that_tp_does_not_divide_raises_under_sp(arch):
    """An MoE model under SP dispatches over all_to_all, which needs the
    even cut of T in both packages (R10): a T that tp 4 does not divide
    raises naming T and tp, before any collective."""
    from repro_torch import models

    cfg = configs.get_smoke_config(arch)
    model = models.build(cfg, ctx=_fake_ctx(1, 4, True), device="cpu")
    with pytest.raises(ValueError, match="needs T=10 divisible by tp=4"):
        model(torch.zeros(1, 10, dtype=torch.int64))
