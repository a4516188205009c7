"""The LM on a (data, model) mesh, held against the JAX package: tensor,
sequence and FSDP parallelism in training, the psum MoE dispatch and the
sequence-sharded decode in serving, the sharded train step, and checkpoints
across meshes.

The reference runs on 4 fake CPU devices in two subprocesses side by side,
the port as 4 gloo ranks (``tests/_torch_dist_workers.py``: ``ref_lm``,
``lm_rank``), each once for the file; both read the same inputs
(``lm_inputs``: every smoke LM's parameters in f32 drawn with numpy, and
the token batches).  The mesh
is (data 2, model 2), rank ``2 * d + m``; training runs with FSDP over data.
At tp = 2 the smoke configs' kv heads (2 and 4) divide, so no context
parallelism fires; the same four ranks as a (1, 4) mesh with SP run
Mistral's attention context-parallel (``tests/test_torch_context_parallel.py``
holds the rest of that layout).

Every rank calls ``backward`` on its own loss (the global mean); the train
step's all-reduce sums a replicated leaf's gradient over the axes it is
replicated on, and the whole gradient tree is gathered from the shards.
Tolerances are those of ``tests/test_torch_train_grads.py``: loss rtol 1e-5,
every gradient leaf atol 1e-5 + rtol 1e-4 -- but under the a2a MoE (granite
with SP), whose all_to_all sends its cotangents in bf16 on both sides
(``_a2a_bf16``), a cotangent whose f32 value two correct programs round to
either side of a bf16 boundary moves by 2^-8 of its size, so there each
leaf is held within 2^-7 of its largest magnitude (measured: 0.8-1.8e-3
below the MoE, 5e-7 above it); serving logits atol 1e-4 with
tokens equal; parameters after two AdamW steps atol 1e-5 + rtol 1e-4,
but for one element in 10,000 of a leaf (at least one), held within 2 * lr:
AdamW divides by sqrt(v), so where a gradient element lies near 0 its
last-ulp difference moves that coordinate's update by up to lr a step
(measured: one element of Mistral's embedding table, 1.5e-4);
checkpoint records within 1e-5.  The training CLI runs at ``--mesh 2x2``
and ``1x1``, and the reference's CLI at its ``1x1`` in the reference's
subprocess: a 2x2 directory resumes at 1x1 and in the reference's CLI, and
the 2x2 mesh resumes the directories of both; the 2x2 directory holds the
reference's whole tree (its ``CheckpointManager`` restores it).  The
serving CLI runs deepseek's f32 smoke model at ``--mesh 1x4`` on the same
4 ranks (the ``Engine`` on the sequence-sharded cache, slots refilled),
greedy and sampled (rank 0's token broadcast), against the CLI without a
mesh; a data axis above 1 is refused.
"""

import dataclasses

import jax
import numpy as np
import pytest

import _torch_dist_workers as workers
import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from repro import models as ref_models
from repro.configs import get_smoke_config as ref_smoke
from repro.distributed.sharding import local_ctx
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's npz, the mesh's 4 ranks' npz, the CLI legs'
    records by leg, the run's directory): the reference and the reference's
    training CLI beside the 4 ranks and the one-rank CLI run; a CLI run
    resumes another's directory once it is marked ready."""
    d = tmp_path_factory.mktemp("lm_sharded")
    workers.lm_inputs(d / "inputs.npz")
    refs = [workers.start_reference("ref_lm_grads", d / "ref_grads.npz", devices=4),
            workers.start_reference("ref_lm_rest", d / "ref_rest.npz", devices=4),
            workers.start_reference("ref_cli", d / "ref_cli.npz", devices=1)]
    started = []
    try:
        started = [workers.start_ranks(workers.lm_rank, d / "mesh", 4),
                   workers.start_ranks(workers.cli_one, d / "one", 1)]
        mesh, _ = (workers.join_ranks(pc) for pc in started)
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
    legs = {leg: dict(np.load(d / run / f"{leg}.npz")) for run, leg in (
        ("mesh", "cli_a"), ("one", "cli_b"), ("one", "resume_a"), ("mesh", "resume_b"), ("mesh", "resume_r"))}
    ref_cli = dict(np.load(d / "ref_cli.npz"))
    for leg in ("ref_r", "resume_ref_a"):  # the reference CLI's records
        legs[leg] = _leaves(ref_cli, f"{leg}/")
    legs["serve_one"] = dict(np.load(d / "one" / "rank0.npz"))
    ref = {**np.load(d / "ref_grads.npz"), **np.load(d / "ref_rest.npz")}
    return dict(np.load(d / "inputs.npz")), ref, mesh, legs, d


def _rows(a, rank):
    """Rank ``rank``'s data-parallel rows of a global batch-first array."""
    n = a.shape[0] // workers.LM_MESH[0]
    d = rank // workers.LM_MESH[1]
    return a[d * n : (d + 1) * n]


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", [c[0] for c in workers.LM_TRAIN])
def test_loss_and_every_gradient_leaf_match_reference(runs, case):
    """Mistral (dense) with SP off and on, granite (MoE, the a2a dispatch)
    with SP on, FSDP over data: the loss, ce and aux on every rank and every
    gradient leaf, gathered whole, against ``jax.value_and_grad`` of the
    reference LM on its mesh."""
    _, ref, ranks, _, _ = runs
    for r in ranks:
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(r[f"{case}/{k}"], ref[f"{case}/{k}"], rtol=1e-5, atol=1e-7)
    want, got = _leaves(ref, f"{case}/grad/"), _leaves(ranks[0], f"{case}/grad/")
    assert set(got) == set(want) and len(want) > 10
    for k in want:
        if case.startswith("granite"):  # bf16 cotangents through the a2a (module docstring)
            assert np.abs(got[k] - want[k]).max() <= 2**-7 * np.abs(want[k]).max(), k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)
    if case.startswith("granite"):
        assert float(ref[f"{case}/aux"]) > 0 and np.abs(want["layers/moe/router"]).max() > 0


def test_int8_compressor_on_shards_equals_reference_on_the_whole(runs):
    """``make_int8_compressor(ctx, specs)`` on each rank's shards of the
    reduced gradient (Mistral, FSDP over data): gathered, the reference's
    compressor applied to the whole gradient tree, bit for bit (a sharded
    leaf's scale is its whole leaf's max).  The reference's compressor runs
    in its subprocess, on the gradient rank 0 wrote there."""
    _, ref, ranks, _, _ = runs
    want, got = _leaves(ref, "int8/"), _leaves(ranks[0], "int8/")
    assert set(got) == set(want) == set(_leaves(ranks[0], "mistral_sp0/grad/"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_moe_training_at_tp2_without_sp_raises_as_the_reference(runs):
    _, ref, ranks, _, _ = runs
    want = str(ref["granite_sp0/train_error"])
    assert "requires the a2a dispatch" in want
    for r in ranks:
        assert str(r["granite_sp0/train_error"]) == want


def test_prefill_logits_on_the_psum_moe_layer_match_reference(runs):
    """Granite at tp = 2 without SP serves through the psum dispatch: each
    rank's rows of the prefill logits (padded vocab, pads at -1e30)."""
    _, ref, ranks, _, _ = runs
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["prefill/logits"], _rows(ref["prefill/logits"], rank), atol=1e-4, rtol=0)


def test_sequence_sharded_decode_matches_reference(runs):
    """Deepseek (dense-first layer, shared experts): prefill of 14 tokens
    and 4 greedy steps on the cache of 32 positions, 16 a rank, so the
    decode crosses from rank 0's chunk into rank 1's; 4 slots (no stack's
    depth, R2)."""
    _, ref, ranks, _, _ = runs
    for i in range(workers.SERVE["steps"] + 1):
        for rank, r in enumerate(ranks):
            np.testing.assert_allclose(r[f"serve/logits{i}"], _rows(ref[f"serve/logits{i}"], rank), atol=1e-4,
                                       rtol=0, err_msg=f"step {i}")
            np.testing.assert_array_equal(r[f"serve/tokens{i}"], _rows(ref[f"serve/tokens{i}"], rank))


def test_context_parallel_layout_matches_reference(runs):
    """A (1, 4) mesh with SP on Mistral's smoke config (2 kv heads): both go
    context-parallel, and the port's loss and every gradient leaf, gathered
    whole, are the reference's."""
    _, ref, ranks, _, _ = runs
    assert bool(ref["cp/use_context_parallel"])
    for r in ranks:
        assert bool(r["cp/cp"])
        np.testing.assert_allclose(r["cp/loss"], ref["cp/loss"], rtol=1e-5, atol=1e-7)
    want, got = _leaves(ref, "cp/grad/"), _leaves(ranks[0], "cp/grad/")
    assert set(got) == set(want) and len(want) > 10
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_two_adamw_steps_match_reference(runs):
    """``build_train_step`` on the mesh against the reference's jitted step,
    the clip active (gradient norm above 0.1): loss and norm per step, then
    every parameter."""
    _, ref, ranks, _, _ = runs
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


def test_checkpoints_resume_across_meshes(runs):
    """The training CLI, four steps checkpointing at 2 and 4: at 2x2 and at
    1x1 each step's loss and gradient norm agree; each run's step-4
    checkpoint set aside, the 1x1 CLI resumes the 2x2 directory from step 2
    and the 2x2 mesh the 1x1 directory, and their steps 2 and 3 equal the
    uninterrupted runs' within 1e-5."""
    _, _, _, legs, _ = runs
    for leg in ("cli_a", "cli_b"):
        assert list(legs[leg]["step"]) == [0, 1, 2, 3]
    for resumed, first in (("resume_a", "cli_a"), ("resume_b", "cli_b")):
        assert list(legs[resumed]["step"]) == [2, 3]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(legs["cli_a"][k], legs["cli_b"][k], rtol=1e-5)
        for resumed, first in (("resume_a", "cli_a"), ("resume_b", "cli_b")):
            np.testing.assert_allclose(legs[resumed][k], legs[first][k][2:], rtol=1e-5, err_msg=resumed)


def test_reference_cli_and_the_mesh_resume_each_other(runs):
    """The reference's training CLI (f32 smoke config, 1x1, its own weights
    from its own PRNG) resumes a copy of the 2x2 run's directory from step
    2, and the 2x2 mesh resumes the reference CLI's directory from step 2:
    steps 2 and 3 equal the uninterrupted runs' within 1e-5."""
    _, _, _, legs, _ = runs
    assert list(legs["ref_r"]["step"]) == [0, 1, 2, 3]
    for resumed in ("resume_ref_a", "resume_r"):
        assert list(legs[resumed]["step"]) == [2, 3]
    for k in ("loss", "grad_norm"):
        for resumed, first in (("resume_ref_a", "cli_a"), ("resume_r", "ref_r")):
            np.testing.assert_allclose(legs[resumed][k], legs[first][k][2:], rtol=1e-5, atol=1e-5,
                                       err_msg=resumed)


@pytest.mark.parametrize("mode", list(workers.SERVE_MODES))
def test_serve_cli_on_a_tp_mesh_equals_one_device(runs, mode):
    """``launch.serve --mesh 1x4`` (deepseek's f32 smoke model: prefill into
    slot views of the sequence-sharded cache, decode across four chunks, two
    slots refilled) gives every rank the tokens of the CLI without a mesh,
    greedy and sampled at temperature 0.8 (rank 0's token broadcast)."""
    _, _, ranks, legs, _ = runs
    want = legs["serve_one"][f"serve_{mode}/tokens"]
    assert want.shape == (6, 6)
    for r in ranks:
        np.testing.assert_array_equal(r[f"serve_{mode}/tokens"], want)
    if mode == "sampled":
        assert not np.array_equal(want, legs["serve_one"]["serve_greedy/tokens"])


def test_serve_cli_refuses_a_data_axis(runs):
    """The engine holds every slot on every rank, so ``--mesh 2x2`` is
    refused (ROADMAP §3) rather than decode every slot on both data ranks."""
    _, _, ranks, _, _ = runs
    for r in ranks:
        assert "serving takes one data rank" in str(r["serve_2x2/error"])


def test_mesh_checkpoint_holds_the_reference_tree(runs):
    """The 2x2 run's directory, restored by the reference's
    ``CheckpointManager``: the reference's parameter and AdamW trees at the
    smoke config, whole (leaf paths and shapes of its ``init``), at step 2,
    with the data cursor."""
    _, _, _, _, d = runs
    state, manifest = RefCheckpointManager(str(d / "cli_a")).restore(2)
    assert manifest["step"] == 2
    cfg = dataclasses.replace(ref_smoke("mistral-nemo-12b"), dtype="float32")
    shapes = jax.eval_shape(ref_models.build(cfg, local_ctx()).init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in workers.flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    for tree in (state["params"], state["opt"]["m"], state["opt"]["v"]):
        got = {k: tuple(np.shape(v)) for k, v in workers.flatten(tree).items()}
        assert got == want
    assert int(np.asarray(state["opt"]["step"])) == 2 and "data" in state
