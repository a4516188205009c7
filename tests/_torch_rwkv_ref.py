"""Shared helpers of the RWKV6 parity tests: the reference's float32 smoke
model on perturbed weights beside the port's twin with the same weights,
and the reference's calls jitted once per variant.

The reference's init leaves ``bonus`` and ``mb_*`` at zero and ``w0`` at -6
(every decay near 1), so a WKV that ignored ``u``, a lost low-rank mixer or
a wrong decay would pass on it.  The tests' weights are the reference's
``PRNGKey(0)`` draw with ``bonus`` and every ``mb_*`` drawn N(0, 0.1) and
``w0`` spread uniformly over [-6, 3] (decays from exp(-e^-6) = 0.9975 down
to exp(-e^3) = 2e-9), numpy draws from a seed, loaded into both packages."""

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
from repro_torch.models import rwkv6
from repro_torch.models.convert import params_from_reference

ARCH = "rwkv6-1.6b"
#: The reference's LM options of each variant: its scan (K7) and its chunked form.
VARIANTS = {"scan": {}, "chunked": {"rwkv_chunked": True}}


def port_config(dtype: str = "float32"):
    return dataclasses.replace(configs.get_smoke_config(ARCH), dtype=dtype)


def perturb(params, seed: int = 7):
    """The reference's tree with ``bonus`` and ``mb_*`` N(0, 0.1) and ``w0``
    uniform on [-6, 3] (numpy leaves)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)
    blk = dict(tree["layers"]["rwkv"])
    for name in ("bonus", *(f"mb_{c}" for c in rwkv6.MIX)):
        blk[name] = (rng.standard_normal(blk[name].shape) * 0.1).astype(blk[name].dtype)
    blk["w0"] = rng.uniform(-6.0, 3.0, blk["w0"].shape).astype(np.float32)
    tree["layers"] = dict(tree["layers"], rwkv=blk)
    return tree


@functools.lru_cache(maxsize=None)
def pair(variant: str = "scan"):
    """(reference cfg, reference model, its perturbed params, port model) on
    the same float32 weights."""
    cfg = dataclasses.replace(ref_get_smoke(ARCH), dtype="float32")
    ref = ref_models.build(cfg, local_ctx(), **VARIANTS[variant])
    tree = perturb(jax.jit(ref.init)(jax.random.PRNGKey(0)))
    port = models.build(port_config(), device="cpu", **VARIANTS[variant])
    port.load_state_dict(params_from_reference(tree))
    return cfg, ref, jax.tree.map(jnp.asarray, tree), port


@functools.lru_cache(maxsize=None)
def jitted(variant: str, name: str):
    """The reference model's method ``name``, jitted once per variant."""
    return jax.jit(getattr(pair(variant)[1], name))


def trainable(variant: str = "scan"):
    """A fresh trainable port model with the tests' weights."""
    model = models.build(port_config(), device="cpu", **VARIANTS[variant])
    model.load_state_dict(pair(variant)[3].state_dict())
    return model.requires_grad_(True)


def block_params(layer: int = 0):
    """The reference's parameters of one layer's RWKV block."""
    return jax.tree.map(lambda a: a[layer], pair()[2]["layers"]["rwkv"])


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


def jnp_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}
