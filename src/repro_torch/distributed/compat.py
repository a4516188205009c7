"""Meshes on ``torch.distributed``: the port's counterpart of
:mod:`repro.distributed.compat`.

The reference is single-controller: one process drives every device, and
``shard_map`` runs a body on each shard of a mesh.  The port is SPMD: one
process per device (``torchrun --nproc-per-node N``, or the tests' spawned
ranks), each running the body on its own shard, and the collectives are
``torch.distributed`` calls on the process group of a mesh axis.  So
``shard_map`` has no counterpart: the functions that wrap a body in it in the
reference (``core.distributed.sort_sharded``, ``pp.gpipe``,
``models.moe.moe_layer_a2a``) take this rank's shard and return this rank's
result.

:func:`make_mesh` is ``jax.make_mesh``'s counterpart, a
:class:`~torch.distributed.device_mesh.DeviceMesh` over an initialized process
group (NCCL on the card, gloo on the CPU).
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with ``mesh_dim_names=axes`` over every
    rank of the initialized process group, ranks laid out row-major (the
    last axis varies fastest, as ``jax.make_mesh`` lays out devices).

    Needs a process group of exactly ``prod(shape)`` ranks and raises
    otherwise; ``device_type`` is ``"cuda"`` (NCCL) unless the caller asks
    for ``"cpu"`` (gloo)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(torch.distributed.init_process_group, one rank per device)"
        )
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(
            f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
            f"has {dist.get_world_size()}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
