"""The port's hybrid (zamba2) LM served and trained against the JAX
package's, on the CPU, at zamba2's float32 smoke config: the serve engine
token for token, one and two AdamW steps, the decay set, the reference's
parameter and AdamW trees bit for bit, and each training CLI resuming the
other's checkpoint directory.  The model-level parity (SSD block, logits,
gradients, caches) is ``test_torch_hybrid.py``'s.

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

from _torch_hybrid_ref import ARCH, VARIANTS, jnp_batch, pair, port_config, trainable
from _torch_train_ref import _close_tree, _ref_cli


# -- serving --------------------------------------------------------------------------------


def test_engine_greedy_matches_reference_engine_token_for_token():
    """Four requests (prompts of 7 tokens, so one prefill shape) on 3 slots:
    no cache leaf's first dimension is 3 (conv and ssm are (4, ...),
    shared_k (2, ...)), so R2 of the reference's engine does not bite."""
    cfg, ref, params, port = pair("hybrid")
    assert all(leaf.shape[0] != 3 for k, leaf in port.init_cache(3, 8).items() if k != "pos")
    ref_eng = RefEngine(ref, params, slots=3, max_len=64, sample_cfg=RefSampleConfig(temperature=0.0))
    eng = Engine(port, slots=3, max_len=64, sample_cfg=SampleConfig(temperature=0.0), device="cpu")
    rng = np.random.default_rng(4)
    for i in range(4):
        p = rng.integers(0, cfg.vocab_size, size=7).tolist()
        ref_eng.add(RefRequest(rid=i, prompt=p, max_tokens=3 + i % 3))
        eng.add(Request(rid=i, prompt=p, max_tokens=3 + i % 3))
    want = [(r.rid, r.out) for r in ref_eng.run()]
    got = [(r.rid, r.out) for r in eng.run()]
    assert got == want and len(got) == 4


def test_engine_slot_reset_covers_every_state():
    """Admission zeroes a slot's conv, ssm and shared k/v (axis 1 of each
    stacked leaf) and leaves the other slots' states alone."""
    port = pair("hybrid")[3]
    eng = Engine(port, slots=3, max_len=16, device="cpu")
    for leaf in eng.cache.values():
        leaf.fill_(1)
    eng._reset_slot(1)
    assert set(eng.cache) == {"pos", "conv", "ssm", "shared_k", "shared_v"}
    for name, leaf in eng.cache.items():
        slot = leaf[1] if name == "pos" else leaf[:, 1]
        others = leaf[[0, 2]] if name == "pos" else leaf[:, [0, 2]]
        assert not slot.any() and (others == 1).all(), name


# -- training -------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_train(n: int):
    cfg, ref, params, _ = pair("hybrid")
    rcfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    step = _ref_step()
    ostate = ref_opt.init_opt_state(params, rcfg)
    pipe, out = TokenPipeline(cfg.vocab_size, 2, 16, seed=0), []
    for _ in range(n):
        params, ostate, met = step(params, ostate, jnp_batch(pipe.next_batch()))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return params, ostate, out


@functools.lru_cache(maxsize=None)
def _ref_step():
    rcfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    return jax.jit(ref_build_train_step(pair("hybrid")[1], rcfg))


@pytest.mark.parametrize("n", [1, 2])
def test_adamw_steps_match_reference(n):
    """One and two train steps (AdamW, lr 1e-3, warmup 2, weight decay 0.1)
    against the reference's jitted step: loss, norm, every parameter and
    first moment."""
    rparams, rstate, rout = _ref_train(n)
    model = trainable("hybrid")
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
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
    """The stacked ``layers.<i>.mamba.{dt_bias,a_log,d_skip,norm_scale}`` and
    ``layers.<i>.ln1.scale`` have rank 2 in the reference's tree and are
    decayed; ``shared.*`` is not stacked, so its norms are not."""
    _, _, params, port = pair("hybrid")
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
    assert {"layers.0.mamba.dt_bias", "layers.3.mamba.norm_scale", "layers.1.ln1.scale"} <= got
    assert "shared.ln1.scale" not in got and "shared.attn.wq" in got and "ln_f.scale" not in got


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("variant", ["hybrid", "ssm"])
def test_reference_tree_round_trip_is_bit_exact(variant):
    """``params_to_reference`` after ``params_from_reference`` gives the
    reference's bf16 tree back (``layers.mamba.*`` stacked, ``shared.*``
    carried), and its AdamW state too; random leaves of the reference's
    shapes and types, which fit the port's module name for name."""
    cfg = dataclasses.replace(ref_get_smoke(ARCH), **VARIANTS[variant])
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
    port = models.build(port_config(variant, "bfloat16"), device="cpu")
    port.load_state_dict(params_from_reference(tree))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_cli_resumes_from_the_others_checkpoints(writer, tmp_path, monkeypatch):
    """One CLI trains zamba2's float32 smoke LM 3 steps, checkpointing at 2
    and at the end; the step-3 checkpoint is set aside and the other CLI
    resumes from step 2: its step's record and its step-3 checkpoint equal
    the uninterrupted run's within 1e-5."""
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
    assert "shared" in end["params"] and end["params"]["layers"]["mamba"]["a_log"].shape[0] == 4
    for a, b in zip(jax.tree.leaves(end), jax.tree.leaves(ref_end)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5, atol=1e-5)
