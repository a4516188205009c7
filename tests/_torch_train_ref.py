"""Shared helpers of the training parity tests: the reference's float32
smoke models and the port's twins with the same weights."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed.sharding import local_ctx
from repro.launch import train as ref_train_cli
from repro_torch import configs, models
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.convert import params_from_reference
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step


@functools.lru_cache(maxsize=None)
def _ref(arch: str):
    """(cfg, reference model, its params, numpy copies of the params)."""
    cfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
    ref = ref_models.build(cfg, local_ctx())
    params = ref.init(jax.random.PRNGKey(0))
    return cfg, ref, params, jax.tree.map(np.asarray, params)


def _port(arch: str, np_params=None):
    """A trainable port model with the reference's weights."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    model = models.build(cfg, device="cpu")
    model.load_state_dict(params_from_reference(np_params if np_params is not None else _ref(arch)[3]))
    return model.requires_grad_(True)


def _batch_np(vocab, seed, batch=2, seq=16):
    return TokenPipeline(vocab, batch, seq, seed=seed).next_batch()


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **tol)


def _close_tree(port: dict, ref_tree, **tol):
    want = params_from_reference(jax.tree.map(np.asarray, ref_tree))
    assert set(port) == set(want)
    for k, v in port.items():
        _close(v, want[k].float(), err_msg=k, **tol)


def _port_steps(model, n: int, seed: int, microbatches: int = 1, state=None):
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    step = build_train_step(model, cfg, microbatches=microbatches)
    state = state or opt.init_opt_state(dict(model.named_parameters()), cfg)
    pipe, out = TokenPipeline(model.cfg.vocab_size, 4, 32, seed=seed), []
    for _ in range(n):
        state, met = step(state, _tb(pipe.next_batch()))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return state, out


def _ref_cli(monkeypatch, argv: list[str]) -> list[dict]:
    """The reference's training CLI on the float32 smoke config; returns one
    record per step it ran (its own log rounds them)."""
    records = []

    def recording_jit(fn, **kw):
        step = jax.jit(fn, **kw)

        def call(params, opt_state, batch):
            out = step(params, opt_state, batch)
            records.append({k: float(out[2][k]) for k in ("loss", "grad_norm", "lr")})
            return out
        return call

    class _Jax:  # the module's view of jax, with the step's jit recording
        jit = staticmethod(recording_jit)

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(ref_train_cli, "jax", _Jax())
    monkeypatch.setattr(ref_train_cli, "get_smoke_config",
                        lambda arch: dataclasses.replace(ref_get_smoke(arch), dtype="float32"))
    monkeypatch.setattr("sys.argv", ["train", *argv])
    ref_train_cli.main()
    return records
