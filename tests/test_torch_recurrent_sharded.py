"""The recurrent LMs on a (data, model) mesh, held against the JAX package:
zamba2 (Mamba2 + the shared attention block) and rwkv6 under tensor,
sequence and FSDP parallelism in training, their caches in serving, the
sharded train step, the engine, and checkpoints across meshes.

The reference runs on 4 fake CPU devices in two subprocesses side by side
(``tests/_torch_dist_workers.py``: ``ref_rec``), the port as 4 gloo ranks
(``rec_rank``) beside one (``rec_one``), each once for the file; both read
the same inputs (``rec_inputs``: each smoke model's parameters in f32 drawn
with numpy, the decays and token-shift mixes spread, and the token batches
of B 4 x T 32: two of the Mamba2 smoke chunks of 16).  The cases
(``REC_TRAIN``): zamba2 and rwkv6 on (2, 2) with FSDP over data (SP off;
zamba2's 2 B/C groups cut at tp 2), on (1, 4) with SP (zamba2's groups whole
at tp 4; rwkv6's 2 heads cut by tp 4), and the Mamba2 kind with SSD heads of
128 on (1, 4) (2 heads at tp 4, SP off).  The reference's loss is the same
function on every mesh (SP a layout), so it is computed once a model.

Tolerances are ``test_torch_lm_sharded.py``'s: loss rtol 1e-5, every
gradient leaf atol 1e-5 + rtol 1e-4, prefill logits atol 1e-4, tokens
equal, parameters after two AdamW steps atol 1e-5 + rtol 1e-4 but for one
element in 10,000 of a leaf held within 2 * lr, CLI records rtol 1e-5.
rwkv6 is held as ``test_torch_rwkv.py`` and ``test_torch_rwkv_train.py``
hold it on one device: its embedding's gradient is 1 / rms of the first
norm (some 50 at the table's scale) times each token's summed row
gradients, up to 16 on these batches, and carries float32 rounding
relative to that, so each gradient leaf gets 3e-5 of its largest magnitude
more (measured here: the port on one device 3.3e-5 of it from the
reference on a batch, the mesh within the plain tolerance of the port on
one device, which is held too), and the train steps' loss and gradient
norm rtol 1e-4 (measured 3.4e-5 after one AdamW step).  Its CLI runs at
2x2 and 1x1 agree in gradient norm at step 0 within that rtol (measured
1.4e-5 and 2.1e-6 with two orders of the channel mix's tp sum), and part
after it: AdamW moves each weight whose gradient lies near 0 by about lr in
the direction of its rounding (0.3% of the norm by step 3), so the later
steps hold the loss alone; the resumed run (1x1 from the 2x2 run's
checkpoint) holds both, its gradient norm to the same rtol, for the same
cross-mesh rounding (measured 1.7e-6 and 2.1e-5 with those two orders).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
import _torch_threads  # noqa: F401  (one intra-op thread a worker)
from repro import configs as ref_configs
from repro import models as ref_models
from repro.distributed.sharding import ShardCtx as RefShardCtx
from repro.distributed.sharding import local_ctx
from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro_torch import configs
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.models import mamba2, rwkv6

#: rwkv6's gradient leaves against the reference: ``test_torch_rwkv.py``'s
#: ``GRAD_SCALE_TOL`` (the module docstring).
RWKV_GRAD_SCALE_TOL = 3e-5

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's npz, the mesh's 4 ranks' npz, the one rank's
    npz and CLI records by leg, the run's directory)."""
    d = tmp_path_factory.mktemp("rec_sharded")
    workers.rec_inputs(d / "inputs.npz")
    refs = [workers.start_reference("ref_rec_grads", d / "ref_grads.npz", devices=4),
            workers.start_reference("ref_rec_rest", d / "ref_rest.npz", devices=4)]
    started = []
    try:
        started = [workers.start_ranks(workers.rec_rank, d / "mesh", 4),
                   workers.start_ranks(workers.rec_one, d / "one", 1)]
        mesh, (one,) = (workers.join_ranks(pc) for pc in started)
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
    legs = {}
    for name in workers.REC_CLI_ARCHS:
        for run, leg in (("mesh", f"cli_{name}"), ("one", f"one_{name}"), ("one", f"resume_{name}")):
            legs[leg] = dict(np.load(d / run / f"{leg}.npz"))
    ref = {**np.load(d / "ref_grads.npz"), **np.load(d / "ref_rest.npz")}
    return dict(np.load(d / "inputs.npz")), ref, mesh, one, legs, d


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _rows(a, rank, mesh):
    """Rank ``rank``'s data-parallel rows of a global batch-first array."""
    n = a.shape[0] // mesh[0]
    d = rank // mesh[1]
    return a[d * n : (d + 1) * n]


# -- the layouts, in process -----------------------------------------------------------


def _fake_ctx(data: int, tp: int, fsdp: bool):
    """A ShardCtx whose mesh answers only its axes' sizes, every coordinate 0."""
    sizes = {"data": data, "model": tp}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), size=lambda i: list(sizes.values())[i],
                                 get_local_rank=lambda name: 0)
    return ShardCtx(mesh=mesh, tp="model", fsdp="data" if fsdp else None, dp=("data",))


def _ref_ctx(data: int, tp: int, fsdp: bool):
    return RefShardCtx(mesh=types.SimpleNamespace(shape={"data": data, "model": tp}), tp="model",
                       fsdp="data" if fsdp else None, dp=("data",))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_recurrent_layouts_match_reference_at_any_tp(smoke):
    """``spec_mamba`` and ``spec_rwkv`` against the reference's for zamba2,
    rwkv6 and the 128-wide-head Mamba2 model at tp 1-16 with and without
    FSDP, and every leaf of the block built for a rank (on the meta device)
    at the shape its spec cuts: ``bc_tp`` and ``h_tp`` fall to None exactly where
    the reference's do.  Where tp does not divide rwkv6's heads the
    reference's ``bonus`` stays ``P(tp, None)`` (its partitioner cuts
    through a head); the port's is whole there."""
    get, ref_get = ((configs.get_smoke_config, ref_configs.get_smoke_config) if smoke
                    else (configs.get_config, ref_configs.get_config))
    cut = set()
    for name in workers.REC_MODELS:
        cfg, ref_cfg = workers.rec_cfg(name, get), workers.rec_cfg(name, ref_get)
        port_spec, ref_spec = ((rwkv6.spec_rwkv, ref_rwkv6.spec_rwkv) if cfg.rwkv is not None
                               else (mamba2.spec_mamba, ref_mamba2.spec_mamba))
        block = rwkv6.RWKV if cfg.rwkv is not None else mamba2.Mamba
        whole = dict(block(cfg, torch.float32, "meta").named_parameters())
        for tp in (1, 2, 4, 8, 16):
            if cfg.d_model % tp or cfg.d_ff % tp:
                continue
            for fsdp in (False, True):
                ctx = _fake_ctx(2, tp, fsdp)
                want = {k: tuple(v) for k, v in ref_spec(ref_cfg, _ref_ctx(2, tp, fsdp)).items()}
                if cfg.rwkv is not None and (cfg.d_model // cfg.rwkv.head_size) % tp:
                    want["bonus"] = (None, None)  # GSPMD cuts through a head; the port keeps it whole
                assert port_spec(cfg, ctx) == want, (name, tp, fsdp)
                for leaf, p in block(cfg, torch.float32, "meta", ctx).named_parameters():
                    n = [tp if a == "model" else 2 if a == "data" else 1 for a in want[leaf]]
                    assert p.shape == tuple(w // k for w, k in zip(whole[leaf].shape, n)), (name, tp, fsdp, leaf)
                if cfg.rwkv is not None:
                    cut |= {(name, "bonus", tp)} if want["bonus"][0] is None else set()
                else:
                    cut |= {(name, k, tp) for k in ("wb", "wdt") if want[k][1] is None}
    if smoke:
        assert ("zamba2", "wb", 4) in cut and ("mamba128", "wdt", 4) in cut and ("rwkv6", "bonus", 4) in cut


# -- training ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [c[0] for c in workers.REC_TRAIN])
def test_loss_and_every_gradient_leaf_match_reference(runs, case):
    """The loss and ce on every rank and every gradient leaf (summed over
    its replicated axes by ``sync_grads``, gathered whole) against
    ``jax.value_and_grad`` of the reference LM on its mesh."""
    _, ref, ranks, _, _, _ = runs
    name = case.split("_")[0]
    for r in ranks:
        for k in ("loss", "ce"):
            np.testing.assert_allclose(r[f"{case}/{k}"], ref[f"{name}/{k}"], rtol=1e-5, atol=1e-7)
    want, got = _leaves(ref, f"{name}/grad/"), _leaves(ranks[0], f"{case}/grad/")
    assert set(got) == set(want) and len(want) > 10
    for k in want:
        scale = RWKV_GRAD_SCALE_TOL * np.abs(want[k]).max() if name == "rwkv6" else 0.0
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 + scale, rtol=1e-4, err_msg=k)
    assert np.abs(want["layers/mamba/conv_k" if name != "rwkv6" else "layers/rwkv/mb_w"]).max() > 0
    if name == "rwkv6":  # the same model on one device, in rank 0, to the tolerance without the scale term
        one = _leaves(ranks[0], "rwkv6_one/grad/")
        for k in want:
            np.testing.assert_allclose(got[k], one[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_rwkv_chunked_form_on_a_mesh_equals_one_device(runs):
    """``LM(rwkv_chunked=True)`` at tp 4 under SP (rwkv6's 2 heads cut):
    loss and every gradient leaf against the same model on one device."""
    _, _, ranks, _, _, _ = runs
    one = ranks[0]
    for r in ranks:
        np.testing.assert_allclose(r["chunked_1x4/loss"], one["chunked_one/loss"], rtol=1e-5)
    want, got = _leaves(one, "chunked_one/grad/"), _leaves(one, "chunked_1x4/grad/")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_int8_compressor_on_recurrent_shards_equals_reference(runs):
    """``make_int8_compressor(ctx, specs)`` on zamba2's reduced gradient
    shards at (2, 2) with FSDP (the stacked scale over layers, a sharded
    leaf's scale its whole leaf's max): gathered, the reference's
    compressor on the whole tree, bit for bit."""
    _, ref, ranks, _, _, _ = runs
    want, got = _leaves(ref, "int8/"), _leaves(ranks[0], "int8/")
    assert set(got) == set(want) == set(_leaves(ranks[0], "zamba2_2x2/grad/"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["zamba2", "rwkv6"])
def test_two_adamw_steps_match_reference(runs, name):
    """``build_train_step`` at (2, 2) with FSDP against the reference's
    jitted step, the clip active: loss and norm per step, then every
    parameter."""
    _, ref, ranks, _, _, _ = runs
    rtol = 1e-4 if name == "rwkv6" else 1e-5  # the module docstring
    for i in range(2):
        assert float(ref[f"adamw/{name}/grad_norm{i}"]) > workers.OPT["grad_clip"]
        for r in ranks:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(r[f"adamw/{name}/{k}{i}"], ref[f"adamw/{name}/{k}{i}"], rtol=rtol)
    want, got = _leaves(ref, f"adamw/{name}/params/"), _leaves(ranks[0], f"adamw/{name}/params/")
    assert set(got) == set(want)
    lr = workers.OPT["lr"]
    for k in want:
        off = np.abs(got[k] - want[k]) > 1e-5 + 1e-4 * np.abs(want[k])
        assert off.sum() <= max(1, off.size // 10_000), (k, off.sum())
        assert np.abs(got[k] - want[k]).max() <= 2 * lr, k


# -- serving ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", list(workers.REC_MODELS))
def test_prefill_logits_match_reference(runs, name, mesh):
    """Each rank's rows of the prefill logits (padded vocab, pads at -1e30)
    on the serving context of each mesh: tp 2 (zamba2's groups cut) and tp 4
    (whole groups; mamba128's and rwkv6's heads cut)."""
    _, ref, ranks, _, _, _ = runs
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"prefill/{name}/{mesh[0]}x{mesh[1]}"],
                                   _rows(ref[f"prefill/{name}/logits"], rank, mesh), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(workers.REC_MODELS))
def test_engine_at_tp4_decodes_the_reference_tokens(runs, name):
    """The ``Engine`` on the (1, 4) mesh (5 slots, 6 requests of 8 tokens,
    every odd one 4 tokens long: a slot refilled while the others decode)
    gives every request the reference's greedy tokens from its batched
    prefill and decode; the host-read guard passed over the decode step on
    every rank."""
    _, ref, ranks, _, _, _ = runs
    want = ref[f"decode/{name}/tokens"]
    for r in ranks:
        got = r[f"engine/{name}/tokens"]
        assert int(r[f"engine/{name}/decode_steps"]) > workers.REC_SERVE["steps"]
        for i in range(want.shape[0]):
            n = workers.rec_max_tokens(i)
            np.testing.assert_array_equal(got[i, :n], want[i, :n], err_msg=f"request {i}")


@pytest.mark.parametrize("mode", list(workers.SERVE_MODES))
@pytest.mark.parametrize("name", workers.REC_CLI_ARCHS)
def test_serve_cli_on_a_tp_mesh_equals_one_device(runs, name, mode):
    """``launch.serve --mesh 1x4`` (8 requests on 5 slots, the smoke model in
    f32) gives every rank the tokens of the CLI without a mesh, greedy and
    sampled at temperature 0.8 (rank 0's token broadcast)."""
    _, _, ranks, one, _, _ = runs
    want = one[f"cli/{name}/serve_{mode}/tokens"]
    assert want.shape == (8, 6)
    for r in ranks:
        np.testing.assert_array_equal(r[f"cli/{name}/serve_{mode}/tokens"], want)


# -- checkpoints -----------------------------------------------------------------------


@pytest.mark.parametrize("name", workers.REC_CLI_ARCHS)
def test_checkpoints_resume_across_meshes(runs, name):
    """The training CLI, four steps checkpointing at 2 and 4: at 2x2 (FSDP
    over data) and at 1x1 each step's loss and gradient norm agree; the 2x2
    run's step-4 checkpoint set aside, the 1x1 CLI resumes its directory
    from step 2 and its steps 2 and 3 equal the 2x2 run's."""
    _, _, _, _, legs, _ = runs
    first, one, resumed = legs[f"cli_{name}"], legs[f"one_{name}"], legs[f"resume_{name}"]
    assert list(first["step"]) == list(one["step"]) == [0, 1, 2, 3] and list(resumed["step"]) == [2, 3]
    np.testing.assert_allclose(first["loss"], one["loss"], rtol=1e-5)
    if name == "rwkv6":  # the module docstring
        np.testing.assert_allclose(first["grad_norm"][0], one["grad_norm"][0], rtol=1e-4)
    else:
        np.testing.assert_allclose(first["grad_norm"], one["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(resumed["loss"], first["loss"][2:], rtol=1e-5)
    np.testing.assert_allclose(resumed["grad_norm"], first["grad_norm"][2:], rtol=1e-4 if name == "rwkv6" else 1e-5)


@pytest.mark.parametrize("name", workers.REC_CLI_ARCHS)
def test_mesh_checkpoint_holds_the_reference_tree(runs, name):
    """The 2x2 run's directory, restored by the reference's
    ``CheckpointManager``: the reference's parameter and AdamW trees at the
    smoke config, whole (the leaf paths and shapes of its ``init``), at step
    2, with the data cursor."""
    _, _, _, _, _, d = runs
    state, manifest = RefCheckpointManager(str(d / f"cli_{name}")).restore(2)
    assert manifest["step"] == 2
    cfg = dataclasses.replace(ref_configs.get_smoke_config(workers.REC_MODELS[name][0]), dtype="float32")
    shapes = jax.eval_shape(ref_models.build(cfg, local_ctx()).init, jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in workers.flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                                       shapes)).items()}
    for tree in (state["params"], state["opt"]["m"], state["opt"]["v"]):
        assert {k: tuple(np.shape(v)) for k, v in workers.flatten(tree).items()} == want
    assert int(np.asarray(state["opt"]["step"])) == 2 and "data" in state
