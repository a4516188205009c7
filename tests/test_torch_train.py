"""The port's training slice against the JAX package's, on the CPU: the token
pipeline, packing, int8 compression, the straggler monitor, AdamW, the train
step, checkpoints and the training CLI (the loss and gradients are in
``test_torch_train_grads.py``).

The reference models are the float32 smoke configs of ``mistral-nemo-12b``
(dense), ``granite-moe-3b-a800m`` (MoE) and ``deepseek-moe-16b`` (MoE with a
leading dense layer), built with ``local_ctx()`` and initialised from
``PRNGKey(0)``; their weights and AdamW state are carried into the port with
``params_from_reference`` and ``opt_state_from_reference``.  Batches come
from ``TokenPipeline`` (numpy, so both packages see the same bytes).

Tolerances, all float32 with the two frameworks summing in other orders:
- one ``apply_updates`` on identical gradients, 3 steps: parameters and
  moments atol 1e-6 (one or two f32 ulps of O(1) values; pow and cos are
  each framework's own), the gradient norm rtol 1e-5; with bfloat16 moments
  and the clip active, the clip's scale carries the norm's difference, so a
  moment may round to its neighbouring bf16 value: moments atol 1e-6 +
  rtol 2^-7, parameters atol n * lr * 2^-7 after n steps;
- 5 train steps from the same parameters and batches: losses and gradient
  norms rtol 1e-4, parameters atol 1e-4 (AdamW divides by sqrt(v), so a
  gradient's last-ulp difference moves an update by up to lr times its
  relative size);
- the learning-rate schedule: rtol 1e-6 at every step;
- the data pipeline, packing, int8 values and scales, straggler flags and
  checkpoint restarts: exact;
- one CLI resuming from the other's checkpoint: the resumed step's loss,
  gradient norm and learning rate, and every leaf of the checkpoint it
  writes, within 1e-5 (rtol and atol) of the uninterrupted run's (one step
  in the other framework);
- the reference's tree through ``params_from_reference`` and back: bit for
  bit.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_get_smoke
from repro.data import packing as ref_packing
from repro.data import synthetic as ref_synthetic
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.distributed import collectives as ref_coll
from repro.distributed.sharding import local_ctx
from repro.models import layers as ref_layers
from repro.train import optimizer as ref_opt
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch import configs
from repro_torch.data import packing, synthetic
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed import collectives as coll
from repro_torch.launch import train as train_cli
from repro_torch.models import layers
from repro_torch.models.convert import (opt_state_from_reference, opt_state_to_reference, params_from_reference,
                                       params_to_reference)
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.train.train_step import build_train_step

from _torch_train_ref import _close, _close_tree, _jb, _port, _port_steps, _ref, _ref_cli, _tb

# -- data and helpers --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_token_pipeline_is_byte_identical_and_resumes(seed):
    a, b = TokenPipeline(517, 3, 40, seed=seed), RefTokenPipeline(517, 3, 40, seed=seed)
    for _ in range(4):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    assert a.state() == b.state() == {"seed": seed, "step": 4}
    r, rr = TokenPipeline.restore(517, 3, 40, a.state()), RefTokenPipeline.restore(517, 3, 40, b.state())
    for _ in range(2):  # the restored cursors continue where the original does
        x, y, z = r.next_batch(), rr.next_batch(), a.next_batch()
        for k in ("tokens", "labels"):
            assert np.array_equal(x[k], y[k]) and np.array_equal(x[k], z[k])


@pytest.mark.parametrize("n,buffer,batch", [(4096, 256, 32), (500, 7, 5), (3, 8, 2), (0, 4, 4)])
def test_packing_order_and_waste_equal_reference(n, buffer, batch):
    lengths = np.random.default_rng(n).integers(16, 2048, size=n).tolist()
    order = packing.replacement_selection_order(lengths, buffer)
    assert order == ref_packing.replacement_selection_order(lengths, buffer)
    assert sorted(order) == list(range(n))
    assert packing.padding_waste(lengths, batch) == ref_packing.padding_waste(lengths, batch)
    packed = [lengths[i] for i in order]
    assert packing.padding_waste(packed, batch) == ref_packing.padding_waste(packed, batch)


@pytest.mark.parametrize("case", ["normal", "half_ties", "zeros", "tiny"])
def test_int8_quantize_equals_reference(case):
    rng = np.random.default_rng(7)
    x = {"normal": rng.standard_normal(1000) * 3e-3,
         "half_ties": (np.arange(-127, 128) + 0.5) / 127.0,  # x / scale lands on .5 exactly
         "zeros": np.zeros(16),
         "tiny": rng.standard_normal(64) * 1e-20}[case].astype(np.float32)
    q, s = coll.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_coll.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert s.item() == float(rs)
    assert np.array_equal(coll.dequantize_int8(q, s).numpy(), np.asarray(ref_coll.dequantize_int8(rq, rs)))


def test_int8_error_feedback_unbiased_and_equal_reference():
    """The accumulated compressed signal tracks the true one (the reference
    test's bound), and every round's output and residual equal the
    reference's."""
    g = (np.random.default_rng(0).normal(size=(256,)) * 1e-3).astype(np.float32)
    gt, gj = torch.from_numpy(g), jnp.asarray(g)
    r, rj = torch.zeros_like(gt), jnp.zeros_like(gj)
    total = torch.zeros_like(gt)
    for _ in range(50):
        d, r = coll.compress_decompress(gt, r)
        dj, rj = ref_coll.compress_decompress(gj, rj)
        assert np.array_equal(d.numpy(), np.asarray(dj)) and np.array_equal(r.numpy(), np.asarray(rj))
        total += d
    np.testing.assert_allclose(total.numpy(), g * 50, rtol=0.02, atol=1e-4)


def test_int8_compressor_over_a_gradient_dict():
    rng = np.random.default_rng(1)
    grads = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    compress, init = coll.make_int8_compressor()
    rcompress, rinit = ref_coll.make_int8_compressor(local_ctx())
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    res, rres = init(tg), rinit(jg)
    for _ in range(3):
        out, res = compress(tg, res)
        rout, rres = rcompress(jg, rres)
        for k in grads:
            assert np.array_equal(out[k].numpy(), np.asarray(rout[k]))
            assert np.array_equal(res[k].numpy(), np.asarray(rres[k]))


def test_straggler_monitor_flags_equal_reference(monkeypatch):
    """The same seeded series of step times (a fake clock) gives the same
    flags and summary in both packages."""
    times = np.random.default_rng(5).gamma(5.0, 0.01, size=80)
    times[[20, 41, 42, 70]] *= 8
    flags = {}
    for name, mod in (("port", coll), ("ref", ref_coll)):
        clock = iter(np.cumsum(np.repeat(times, 2) * np.tile([0.0, 1.0], 80)).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        mon = mod.StragglerMonitor(window=20, threshold=3.0)
        out = []
        for _ in times:
            mon.start()
            out.append(mon.stop())
        flags[name] = (out, mon.summary())
        monkeypatch.undo()
    assert flags["port"] == flags["ref"]
    assert any(flags["port"][0]) and not all(flags["port"][0])


def test_synthetic_batches_have_the_reference_shapes():
    for arch in ("mistral-nemo-12b", "whisper-small", "llava-next-34b"):
        cfg = configs.get_smoke_config(arch)
        got = synthetic.batch_shapes(cfg, 3, 11)
        want = ref_synthetic.batch_shapes(ref_get_smoke(arch), 3, 11)
        assert list(got) == list(want)
        for k in got:
            assert got[k][0] == want[k][0] and str(got[k][1]).replace("torch.", "") == jnp.dtype(want[k][1]).name
        batch = synthetic.make_batch(cfg, 3, 11, torch.Generator().manual_seed(0))
        for k, (shape, dt) in got.items():
            assert batch[k].shape == shape and batch[k].dtype == dt
            if dt == torch.int32:
                assert 0 <= int(batch[k].min()) and int(batch[k].max()) < cfg.vocab_size


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_equals_reference(z_loss):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    got = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z_loss)
    want = ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert got.dtype == torch.float32


# -- the optimizer -----------------------------------------------------------------------


def test_lr_schedule_equals_reference_at_every_step():
    for cfg in (opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
                opt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6), opt.AdamWConfig()):
        rcfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
        steps = np.arange(0, cfg.total_steps + 3)
        got = np.array([opt.lr_schedule(cfg, int(s)).item() for s in steps], np.float32)
        want = np.asarray(jax.vmap(lambda s: ref_opt.lr_schedule(rcfg, s))(jnp.asarray(steps, jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_decay_set_is_the_reference_leaf_rank():
    """The reference decays a leaf iff its rank >= 2 in its tree, where the
    scanned stack's leaves carry a layer axis: every ``layers.<i>`` norm
    scale is decayed, ``ln_f`` and the unstacked ``dense_layers`` norms are
    not."""
    _, _, _, np_params = _ref("deepseek-moe-16b")
    model = _port("deepseek-moe-16b")
    flat = {k: v for k, v in params_from_reference(np_params).items()}
    ranks = {}
    jax.tree_util.tree_map_with_path(lambda path, x: ranks.__setitem__(path, np.ndim(x)), np_params)
    want = set()
    for path, nd in ranks.items():
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if nd >= 2:
            if keys[0] == "layers":
                want |= {f"layers.{i}." + ".".join(map(str, keys[1:])) for i in range(model.cfg.num_layers - 1)}
            else:
                want.add(".".join(map(str, keys)))
    got = {k for k, p in model.named_parameters() if opt.reference_rank(k, p) >= 2}
    assert got == want and set(flat) >= got
    assert "layers.0.ln1.scale" in got and "ln_f.scale" not in got and "dense_layers.0.ln1.scale" not in got


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e6])
def test_apply_updates_equals_reference_over_three_steps(clip, moments):
    """The same gradients (numpy draws, scaled so the clip binds at 1.0 and
    not at 1e6) through both packages' AdamW, on deepseek's smoke tree
    (stacked, unstacked and final-norm leaves)."""
    _, _, params, np_params = _ref("deepseek-moe-16b")
    model = _port("deepseek-moe-16b")
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip, moment_dtype=moments)
    rcfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
    pp = dict(model.named_parameters())
    state, rstate = opt.init_opt_state(pp, cfg), ref_opt.init_opt_state(params, rcfg)
    rparams = params
    rng = np.random.default_rng(9)
    for n in range(1, 4):
        rgrads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 0.3),
                              rparams)
        grads = params_from_reference(jax.tree.map(np.asarray, rgrads))
        _, state, met = opt.apply_updates(pp, grads, state, cfg)
        rparams, rstate, rmet = ref_opt.apply_updates(rparams, rgrads, rstate, rcfg)  # eager: no fused FMAs
        # the norm sums ~1e5 squares over 50 leaves in another order: rtol 1e-5
        np.testing.assert_allclose(met["grad_norm"].item(), float(rmet["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(met["lr"].item(), float(rmet["lr"]), rtol=1e-6)
        if moments == "bfloat16" and clip == 1.0:
            # the clip scale carries the norm's 1e-6: a moment may round to the
            # neighbouring bf16 value (2^-8 of it), which moves each step's
            # update by up to lr * 2^-7
            _close_tree(pp, rparams, atol=n * cfg.lr * 2**-7, rtol=0)
            _close_tree(state["m"], rstate["m"], atol=1e-6, rtol=2**-7)
            _close_tree(state["v"], rstate["v"], atol=1e-6, rtol=2**-7)
        else:
            _close_tree(pp, rparams, atol=1e-6, rtol=0)
            _close_tree(state["m"], rstate["m"], atol=1e-6, rtol=0)
            _close_tree(state["v"], rstate["v"], atol=1e-6, rtol=0)
        assert int(state["step"]) == int(rstate["step"]) and state["m"]["ln_f.scale"].dtype == getattr(torch, moments)
    assert (float(rmet["grad_norm"]) > clip) == (clip == 1.0)


def test_opt_state_converts_from_reference():
    _, _, params, _ = _ref("granite-moe-3b-a800m")
    model = _port("granite-moe-3b-a800m")
    rstate = ref_opt.init_opt_state(params, ref_opt.AdamWConfig(moment_dtype="bfloat16"))
    rstate = dict(rstate, step=jnp.asarray(7, jnp.int32))
    got = opt_state_from_reference(jax.tree.map(np.asarray, rstate))
    want = opt.init_opt_state(dict(model.named_parameters()), opt.AdamWConfig(moment_dtype="bfloat16"))
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    for part in ("m", "v"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            assert got[part][k].dtype == torch.bfloat16 and got[part][k].shape == want[part][k].shape


# -- train steps -------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_step(arch: str):
    """The reference's jitted train step (lr 1e-3, warmup 2) and its config."""
    _, ref, _, _ = _ref(arch)
    rcfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    return jax.jit(ref_build_train_step(ref, rcfg)), rcfg


def _ref_steps(arch: str, n: int, seed: int, save=None):
    """The reference's train step run ``n`` times from PRNGKey(0) on
    ``TokenPipeline(seed)`` batches; ``save(i, params, opt, pipe)`` is called
    before step ``i``."""
    cfg, _, params, _ = _ref(arch)
    step, rcfg = _ref_step(arch)
    ostate = ref_opt.init_opt_state(params, rcfg)
    pipe, out = RefTokenPipeline(cfg.vocab_size, 4, 32, seed=seed), []
    for i in range(n):
        if save is not None:
            save(i, params, ostate, pipe)
        params, ostate, met = step(params, ostate, _jb(pipe.next_batch()))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return params, ostate, out


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m"])
def test_five_train_steps_match_reference(arch):
    rparams, rstate, rout = _ref_steps(arch, 5, 0)
    model = _port(arch)
    state, out = _port_steps(model, 5, 0)
    np.testing.assert_allclose(np.array(out), np.array(rout), rtol=1e-4)
    _close_tree(dict(model.named_parameters()), rparams, atol=1e-4, rtol=0)
    assert int(state["step"]) == int(rstate["step"]) == 5


# -- checkpoints -------------------------------------------------------------------------------


def test_checkpoint_restart_continuity_is_bit_equal(tmp_path):
    """Save at step 3, 'crash', restore into a fresh model, run 3 more: the
    losses and the final parameters equal the uninterrupted run's exactly."""
    arch = "granite-moe-3b-a800m"
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    ref_model = _port(arch)
    step = build_train_step(ref_model, cfg)
    state = opt.init_opt_state(dict(ref_model.named_parameters()), cfg)
    pipe, want = TokenPipeline(ref_model.cfg.vocab_size, 2, 16, seed=7), []
    for _ in range(6):
        state, met = step(state, _tb(pipe.next_batch()))
        want.append(float(met["loss"]))

    model = _port(arch)
    step = build_train_step(model, cfg)
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    pipe, got = TokenPipeline(model.cfg.vocab_size, 2, 16, seed=7), []
    for _ in range(3):
        state, met = step(state, _tb(pipe.next_batch()))
        got.append(float(met["loss"]))
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    mgr.save(3, {"params": model.state_dict(), "opt": state, "data": pipe.state()})
    del model, state, pipe, step

    restored, manifest = mgr.restore()
    assert manifest["step"] == 3
    model = _port(arch)
    model.load_state_dict(restored["params"])
    step = build_train_step(model, cfg)
    state = restored["opt"]
    pipe = TokenPipeline.restore(model.cfg.vocab_size, 2, 16, restored["data"])
    for _ in range(3):
        state, met = step(state, _tb(pipe.next_batch()))
        got.append(float(met["loss"]))
    assert got == want
    for (k, a), b in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(a, b), k


def test_checkpoint_atomicity_gc_and_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.arange(3) * s, "b": torch.full((2,), 1.5 * s, dtype=torch.bfloat16),
                     "l": [torch.zeros(2), np.ones(3)]})
    assert mgr.all_steps() == [2, 3]
    (tmp_path / "tmp.99").mkdir()  # a crash mid-write
    mgr2 = CheckpointManager(tmp_path, keep=2)
    assert not list(tmp_path.glob("tmp.*"))
    state, man = mgr2.restore()
    assert torch.equal(state["x"], torch.arange(3) * 3)
    assert state["b"].dtype == torch.bfloat16 and torch.equal(state["b"], torch.full((2,), 4.5, dtype=torch.bfloat16))
    assert state["l"][1].shape == (3,) and man["dtypes"] == {"b": "bfloat16"}
    # the reference reads the port's layout, bf16 included
    rstate, rman = RefCheckpointManager(tmp_path).restore()
    assert rman["step"] == 3 and str(rstate["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(rstate["b"], np.float32), [4.5, 4.5])


def test_async_checkpointer_copies_before_returning(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    ck = AsyncCheckpointer(mgr)
    x = torch.zeros(4)
    ck.save(1, {"x": x})
    x += 7  # the train step updates in place right after a save
    ck.save(2, {"x": x})
    ck.close()
    assert mgr.all_steps() == [1, 2]
    assert torch.equal(mgr.restore(1)[0]["x"], torch.zeros(4))
    assert torch.equal(mgr.restore(2)[0]["x"], torch.full((4,), 7.0))


def test_reference_checkpoint_restores_into_port_and_gives_its_next_loss(tmp_path):
    """The reference trains 2 steps and checkpoints (bf16-free f32 tree plus
    its AdamW state and data cursor); the port restores that checkpoint and
    its next step's loss and gradient norm are the reference's next step's."""
    arch = "mistral-nemo-12b"

    def save(i, params, ostate, pipe):
        if i == 2:
            RefCheckpointManager(tmp_path).save(2, {"params": params, "opt": ostate, "data": pipe.state()})

    _, _, rout = _ref_steps(arch, 3, 3, save)

    state, manifest = CheckpointManager(tmp_path).restore()
    assert manifest["step"] == 2 and json.loads((tmp_path / "step_0000000002" / "manifest.json").read_text())
    model = _port(arch, state["params"])
    ostate = opt_state_from_reference(state["opt"])
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    tpipe = TokenPipeline.restore(model.cfg.vocab_size, 4, 32, state["data"])
    ostate, met = build_train_step(model, cfg)(ostate, _tb(tpipe.next_batch()))
    np.testing.assert_allclose([float(met["loss"]), float(met["grad_norm"])], rout[2], rtol=1e-5)
    assert int(ostate["step"]) == 3


# -- the CLI -------------------------------------------------------------------------------------


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu", "--dtype", "float32",
            "--steps", "4", "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    first = train_cli.main(argv)
    assert [r["step"] for r in first] == [0, 1, 2, 3] and np.isfinite([r["loss"] for r in first]).all()
    assert CheckpointManager(tmp_path).all_steps() == [2, 4]
    import shutil

    shutil.rmtree(tmp_path / "step_0000000004")
    second = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "gnorm" in out
    assert second == first[2:]
    if not torch.cuda.is_available():  # the default device is the card: no silent CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "1"])


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or numpy leaf (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "deepseek-moe-16b"])
def test_reference_tree_round_trip_is_bit_exact(arch):
    """``params_to_reference`` after ``params_from_reference`` gives the
    reference's bfloat16 tree back, structure and bits (the dense LM, and the
    MoE LM with its list of leading dense layers); the AdamW state too.  The
    leaves are random draws of the reference's shapes and types."""
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(ref_models.build(ref_get_smoke(arch), local_ctx()).init, jax.random.PRNGKey(1))
    draw = lambda dtype: lambda s: rng.standard_normal(s.shape).astype(dtype or s.dtype)
    tree = jax.tree.map(draw(None), shapes)
    rstate = {"m": jax.tree.map(draw(jnp.bfloat16), shapes), "v": jax.tree.map(draw(np.float32), shapes),
              "step": np.asarray(5, np.int32)}
    for want, got in ((tree, params_to_reference(params_from_reference(tree))),
                      (rstate, opt_state_to_reference(opt_state_from_reference(rstate)))):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == getattr(torch, w.dtype.name) and g.shape == w.shape
            assert np.array_equal(_bits(g), _bits(w))
    assert any(w.dtype.name == "bfloat16" for w in jax.tree.leaves(tree))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_cli_resumes_from_the_others_checkpoints(writer, tmp_path, monkeypatch):
    """One CLI trains granite's float32 smoke LM 3 steps, checkpointing at 2
    and at the end; the step-3 checkpoint is set aside and the other CLI
    resumes from step 2.  Its step's record and its step-3 checkpoint
    (parameters, AdamW moments and step, data cursor) equal the
    uninterrupted run's within 1e-5."""
    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "3", "--batch", "2", "--seq", "8",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    port = ["--device", "cpu", "--dtype", "float32"]
    runs = {"reference": lambda: _ref_cli(monkeypatch, argv),
            "port": lambda: [{k: r[k] for k in ("loss", "grad_norm", "lr")} for r in train_cli.main(argv + port)]}
    first, resume = runs[writer], runs["port" if writer == "reference" else "reference"]
    want = first()
    assert len(want) == 3 and CheckpointManager(tmp_path).all_steps() == [2, 3]
    aside = tmp_path / "uninterrupted"  # not a step_* name: the managers ignore it
    aside.mkdir()
    (tmp_path / "step_0000000003").rename(aside / "step_0000000003")
    got = resume()
    assert len(got) == 1 and CheckpointManager(tmp_path).all_steps() == [2, 3]
    for k in got[0]:
        np.testing.assert_allclose(got[0][k], want[2][k], rtol=1e-5, atol=1e-5, err_msg=k)
    end, _ = CheckpointManager(tmp_path).restore(3)
    ref_end, _ = CheckpointManager(aside).restore(3)
    assert jax.tree.structure(end) == jax.tree.structure(ref_end) and end["data"] == ref_end["data"]
    assert int(end["opt"]["step"]) == int(ref_end["opt"]["step"]) == 3
    for a, b in zip(jax.tree.leaves(end), jax.tree.leaves(ref_end)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5, atol=1e-5)
