"""The port's RWKV6 LM (rwkv6-1.6b) served and trained against the JAX
package's, on the CPU, at its float32 smoke config on the perturbed weights
of ``_torch_rwkv_ref.py``: the serve engine token for token, the slot reset,
one and two AdamW steps, the decay set, the reference's parameter and AdamW
trees bit for bit, and each training CLI resuming the other's checkpoint
directory.  The model-level parity (time mix, WKV gradients, logits,
gradients, caches) is ``test_torch_rwkv.py``'s.

Tolerances (float32 on both sides): the train steps' loss and gradient norm
rtol 1e-4, parameters atol 1e-4 and first moments atol 1e-5 + rtol 1e-4 (the
training tests' tolerances); the CLIs' records and checkpoints 1e-5; greedy
tokens equal.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed.sharding import local_ctx
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.serve.sampler import SampleConfig as RefSampleConfig
from repro.train import optimizer as ref_opt
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch import models
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import (opt_state_from_reference, opt_state_to_reference, params_from_reference,
                                        params_to_reference)
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampler import SampleConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import build_train_step

from _torch_rwkv_ref import ARCH, jnp_batch, pair, port_config, trainable
from _torch_train_ref import _close_tree, _ref_cli

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


# -- serving --------------------------------------------------------------------------------


def test_engine_greedy_matches_reference_engine_token_for_token():
    """Five requests (prompts of 6 tokens, so one prefill shape) on 2 slots:
    the cache leaves' first dimension is the depth 3, not the slot count
    (R2 of the reference's engine bites where they are equal)."""
    cfg, ref, params, port = pair()
    assert all(leaf.shape[0] == 3 for k, leaf in port.init_cache(2, 8).items() if k != "pos")
    ref_eng = RefEngine(ref, params, slots=2, max_len=64, sample_cfg=RefSampleConfig(temperature=0.0))
    eng = Engine(port, slots=2, max_len=64, sample_cfg=SampleConfig(temperature=0.0), device="cpu")
    rng = np.random.default_rng(4)
    for i in range(5):
        p = rng.integers(0, cfg.vocab_size, size=6).tolist()
        ref_eng.add(RefRequest(rid=i, prompt=p, max_tokens=3 + i % 3))
        eng.add(Request(rid=i, prompt=p, max_tokens=3 + i % 3))
    want = [(r.rid, r.out) for r in ref_eng.run()]
    got = [(r.rid, r.out) for r in eng.run()]
    assert got == want and len(got) == 5


def test_engine_slot_reset_covers_every_state():
    """Admission zeroes a slot's shifts and WKV state (axis 1 of each stacked
    leaf) and leaves the other slots' states alone."""
    port = pair()[3]
    eng = Engine(port, slots=3, max_len=16, device="cpu")
    for leaf in eng.cache.values():
        leaf.fill_(1)
    eng._reset_slot(1)
    assert set(eng.cache) == {"pos", "tm_shift", "cm_shift", "wkv"}
    for name, leaf in eng.cache.items():
        slot = leaf[1] if name == "pos" else leaf[:, 1]
        others = leaf[[0, 2]] if name == "pos" else leaf[:, [0, 2]]
        assert not slot.any() and (others == 1).all(), name


# -- training -------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_train(n: int):
    cfg, ref, params, _ = pair()
    rcfg = ref_opt.AdamWConfig(**OPT)
    step = jax.jit(ref_build_train_step(ref, rcfg))
    ostate = ref_opt.init_opt_state(params, rcfg)
    pipe, out = TokenPipeline(cfg.vocab_size, 2, 16, seed=0), []
    for _ in range(n):
        params, ostate, met = step(params, ostate, jnp_batch(pipe.next_batch()))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return params, ostate, out


@pytest.mark.parametrize("n", [1, 2])
def test_adamw_steps_match_reference(n):
    """One and two train steps (AdamW, lr 1e-3, warmup 2, weight decay 0.1)
    against the reference's jitted step: loss, norm, every parameter and
    first moment."""
    rparams, rstate, rout = _ref_train(n)
    model = trainable()
    cfg = opt.AdamWConfig(**OPT)
    step = build_train_step(model, cfg)
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    pipe, out = TokenPipeline(model.cfg.vocab_size, 2, 16, seed=0), []
    for _ in range(n):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()})
        out.append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(np.array(out), np.array(rout), rtol=1e-4)
    _close_tree(dict(model.named_parameters()), rparams, atol=1e-4, rtol=0)
    _close_tree(state["m"], rstate["m"], atol=1e-5, rtol=1e-4)
    assert int(state["step"]) == int(rstate["step"]) == n


def test_decay_set_is_the_reference_leaf_rank():
    """The stacked ``layers.<i>.rwkv.*`` leaves have one more dimension in the
    reference's tree: every one of them, the (D,) mixes, ``w0`` and
    ``ln_scale`` too, is decayed, and so are ``layers.<i>.ln1.scale``; the
    final norm is not."""
    _, _, params, port = pair()
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        if np.ndim(leaf) >= 2:
            if keys[0] == "layers":
                want |= {f"layers.{i}." + ".".join(keys[1:]) for i in range(port.cfg.num_layers)}
            else:
                want.add(".".join(keys))
    got = {k for k, p in port.named_parameters() if opt.reference_rank(k, p) >= 2}
    assert got == want
    assert {"layers.0.rwkv.mu_x", "layers.2.rwkv.w0", "layers.1.rwkv.bonus", "layers.1.ln2.scale"} <= got
    assert "ln_f.scale" not in got and "embed.table" in got


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_reference_tree_round_trip_is_bit_exact():
    """``params_to_reference`` after ``params_from_reference`` gives the
    reference's bf16 tree back (``layers.{ln1, ln2, rwkv}`` stacked), and its
    AdamW state too; random leaves of the reference's shapes and types, which
    fit the port's module name for name."""
    cfg = ref_get_smoke(ARCH)
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(ref_models.build(cfg, local_ctx()).init, jax.random.PRNGKey(1))
    draw = lambda dtype: lambda s: rng.standard_normal(s.shape).astype(dtype or s.dtype)  # noqa: E731
    tree = jax.tree.map(draw(None), shapes)
    rstate = {"m": jax.tree.map(draw(np.float32), shapes), "v": jax.tree.map(draw(np.float32), shapes),
              "step": np.asarray(5, np.int32)}
    for want, got in ((tree, params_to_reference(params_from_reference(tree))),
                      (rstate, opt_state_to_reference(opt_state_from_reference(rstate)))):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == getattr(torch, w.dtype.name) and g.shape == w.shape
            assert np.array_equal(_bits(g), _bits(w))
    assert any(w.dtype.name == "bfloat16" for w in jax.tree.leaves(tree))
    port = models.build(port_config("bfloat16"), device="cpu")
    port.load_state_dict(params_from_reference(tree))
    assert port.layers[2].rwkv.wr.dtype == torch.bfloat16 and port.layers[2].rwkv.w0.dtype == torch.float32


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_cli_resumes_from_the_others_checkpoints(writer, tmp_path, monkeypatch):
    """One CLI trains rwkv6's float32 smoke LM 3 steps, checkpointing at 2 and
    at the end; the step-3 checkpoint is set aside and the other CLI resumes
    from step 2: its step's record and its step-3 checkpoint equal the
    uninterrupted run's within 1e-5."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2", "--seq", "8",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "1"]
    port = ["--device", "cpu", "--dtype", "float32"]
    runs = {"reference": lambda: _ref_cli(monkeypatch, argv),
            "port": lambda: [{k: r[k] for k in ("loss", "grad_norm", "lr")} for r in train_cli.main(argv + port)]}
    first, resume = runs[writer], runs["port" if writer == "reference" else "reference"]
    want = first()
    assert len(want) == 3 and CheckpointManager(tmp_path).all_steps() == [2, 3]
    aside = tmp_path / "uninterrupted"
    aside.mkdir()
    (tmp_path / "step_0000000003").rename(aside / "step_0000000003")
    got = resume()
    assert len(got) == 1 and CheckpointManager(tmp_path).all_steps() == [2, 3]
    for k in got[0]:
        np.testing.assert_allclose(got[0][k], want[2][k], rtol=1e-5, atol=1e-5, err_msg=k)
    end, _ = CheckpointManager(tmp_path).restore(3)
    ref_end, _ = CheckpointManager(aside).restore(3)
    assert jax.tree.structure(end) == jax.tree.structure(ref_end) and end["data"] == ref_end["data"]
    assert end["params"]["layers"]["rwkv"]["bonus"].shape == (3, 2, 64)
    for a, b in zip(jax.tree.leaves(end), jax.tree.leaves(ref_end)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5, atol=1e-5)


def test_bf16_train_step_runs_and_decays_on_cpu():
    """The bf16 smoke model (the trained models' type) takes two steps: the
    loss is finite and the bf16 matrices and f32 mixes all move."""
    model = models.build(dataclasses.replace(port_config("bfloat16")), device="cpu")
    model.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    cfg = opt.AdamWConfig(**OPT)
    step = build_train_step(model, cfg)
    state = opt.init_opt_state(dict(model.named_parameters()), cfg)
    pipe = TokenPipeline(model.cfg.vocab_size, 2, 16, seed=3)
    for _ in range(2):
        state, met = step(state, {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()})
        assert np.isfinite(float(met["loss"])) and np.isfinite(float(met["grad_norm"]))
    moved = {k for k, p in model.named_parameters() if not torch.equal(p, before[k])}
    assert {"layers.0.rwkv.wr", "layers.0.rwkv.w0", "layers.2.rwkv.bonus", "layers.1.rwkv.mb_g"} <= moved
