"""Shared helpers of the hybrid (zamba2) parity tests: the reference's
float32 smoke model and its variants beside the port's twins with the same
weights, and the reference's calls jitted once per variant."""

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

ARCH = "zamba2-1.2b"
#: zamba2's smoke config and its two variants: a short last segment, and the mamba kind.
VARIANTS = {"hybrid": {}, "hybrid_L5": {"num_layers": 5}, "ssm": {"family": "ssm"}}


def port_config(variant: str, dtype: str = "float32"):
    return dataclasses.replace(configs.get_smoke_config(ARCH), **VARIANTS[variant], dtype=dtype)


@functools.lru_cache(maxsize=None)
def pair(variant: str):
    """(reference cfg, reference model, its params, port model) on the same
    float32 weights (the reference's ``PRNGKey(0)`` draw)."""
    cfg = dataclasses.replace(ref_get_smoke(ARCH), **VARIANTS[variant], dtype="float32")
    ref = ref_models.build(cfg, local_ctx())
    params = jax.jit(ref.init)(jax.random.PRNGKey(0))
    port = models.build(port_config(variant), device="cpu")
    port.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params)))
    return cfg, ref, params, port


@functools.lru_cache(maxsize=None)
def jitted(variant: str, name: str):
    """The reference model's method ``name``, jitted once per variant."""
    return jax.jit(getattr(pair(variant)[1], name))


def trainable(variant: str):
    """A fresh trainable port model with the reference's weights."""
    _, _, params, _ = pair(variant)
    model = models.build(port_config(variant), device="cpu")
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params)))
    return model.requires_grad_(True)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def jnp_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}
