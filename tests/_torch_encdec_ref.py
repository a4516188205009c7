"""Shared helpers of the encoder-decoder parity tests: the reference's
whisper-small smoke model (2 + 2 layers, d 128) on perturbed weights beside
the port's twin with the same weights, and the reference's calls jitted once
a dtype.

The reference's init leaves every bias at zero and every norm scale at one,
so a port that dropped the cross-attention's k/v biases or swapped two norms
would pass on it.  The tests' weights are the reference's ``PRNGKey(0)`` draw
with every bias drawn N(0, 0.1) and every norm scale 1 + N(0, 0.1), numpy
draws from a seed, loaded into both packages."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import models as ref_models
from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed.sharding import local_ctx
from repro_torch import configs, models
from repro_torch.models.convert import params_from_reference

ARCH = "whisper-small"
#: Frames, prompt tokens and rows of the tests' batches: a ragged encoder
#: length against a shorter decoder.
S, T, B = 37, 9, 2


def port_config(dtype: str = "float32"):
    return dataclasses.replace(configs.get_smoke_config(ARCH), dtype=dtype)


def perturb(params, seed: int = 7):
    """The reference's tree (numpy leaves) with every bias N(0, 0.1) and
    every norm scale 1 + N(0, 0.1), in each leaf's own type."""
    rng = np.random.default_rng(seed)

    def walk(tree, leaf=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        if leaf == "scale":
            return (1.0 + rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        if leaf.startswith("b"):
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a

    return walk(params)


@functools.lru_cache(maxsize=None)
def pair(dtype: str = "float32"):
    """(reference cfg, reference model, its perturbed params, port model) on
    the same weights."""
    cfg = dataclasses.replace(ref_get_smoke(ARCH), dtype=dtype)
    ref = ref_models.build(cfg, local_ctx())
    tree = perturb(jax.jit(ref.init)(jax.random.PRNGKey(0)))
    port = models.build(port_config(dtype), device="cpu")
    port.load_state_dict(params_from_reference(tree))
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port


@functools.lru_cache(maxsize=None)
def jitted(dtype: str, name: str):
    """The reference model's method ``name``, jitted once a dtype."""
    return jax.jit(getattr(pair(dtype)[1], name))


def trainable():
    """A fresh trainable float32 port model with the tests' weights."""
    model = models.build(port_config(), device="cpu")
    model.load_state_dict(pair()[3].state_dict())
    return model.requires_grad_(True)


def batch_np(seed: int, b: int = B, s: int = S, t: int = T) -> dict:
    """``enc_embeds`` (b, s, D) N(0, 1) float32, ``tokens`` and ``labels``
    (b, t) int32 in the vocabulary."""
    cfg = port_config()
    rng = np.random.default_rng(seed)
    return {"enc_embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)}


def tb(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def jb(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)
