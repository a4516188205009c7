"""``--mesh`` for the CLIs: the process group, the rank's device and the
:class:`~repro_torch.distributed.sharding.ShardCtx`; and the production
meshes of the dry run (:func:`make_production_mesh`).

``--mesh DxM`` is a ``(data, model)`` mesh and ``PxDxM`` a ``(pod, data,
model)`` one, as the reference's ``parse_mesh`` reads it.  The port is SPMD,
one process a device: a mesh of more than one rank runs under ``torchrun
--nproc-per-node=N`` (its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
rendezvous address, ``env://``), NCCL on the card and gloo on the CPU.  A
``1x1`` mesh outside ``torchrun`` starts a one-rank group of its own
through a ``file://`` rendezvous in a temporary directory.  A process group
the caller has already started is used as it is.
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch
import torch.distributed as dist

from ..distributed.compat import make_mesh  # the reference's launch.mesh.make_mesh too
from ..distributed.sharding import ShardCtx


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production meshes: one pod ``(data 16, model 16)``,
    256 ranks, or two ``(pod 2, data 16, model 16)``, 512.  A ``DeviceMesh``
    over the process group already started, which must have that many ranks
    (the dry run's fake one: :func:`repro_torch.launch.dryrun.fake_world`).
    On 8-card H100 hosts the 16-way ``model`` axis spans two NVLink
    domains."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def parse_mesh(s: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    dims = tuple(int(x) for x in s.split("x"))
    if len(dims) == 2:
        return dims, ("data", "model")
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    raise ValueError(f"mesh {s!r}: want DxM or PxDxM")


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` under torchrun for a CUDA
    ``device``, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def mesh_context(spec: str | None, device: torch.device, *, train: bool):
    """Yields the ``ShardCtx`` of ``--mesh spec`` on ``device`` (None without
    a mesh), starting the process group it needs and destroying the one it
    started on exit.  Training's context has ``fsdp="data"`` unless the
    data axis is 1 (the reference's ``launch/train.py``), serving's none.
    Serving takes a mesh of one data rank (``1xM``): the port's engine
    holds every slot on every rank, so a data axis above 1 is refused rather
    than have every data rank decode every slot (the reference's serve CLI
    fails at such a mesh as well: its batch-1 admission prefill does not
    split over the data axis)."""
    if spec is None:
        yield None
        return
    dims, axes = parse_mesh(spec)
    if not train and math.prod(dims[:-1]) > 1:
        raise SystemExit(f"--mesh {spec}: serving takes one data rank (1xM); the engine does not "
                         "shard its slots over data ranks")
    started = False
    with tempfile.TemporaryDirectory() as tmp:
        if not dist.is_initialized():
            backend = "nccl" if device.type == "cuda" else "gloo"
            if "RANK" in os.environ:
                dist.init_process_group(backend, init_method="env://")
            elif math.prod(dims) == 1:
                dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
            else:
                raise SystemExit(f"--mesh {spec} has {math.prod(dims)} ranks: run it under "
                                 f"torchrun --nproc-per-node={math.prod(dims)}")
            started = True
        try:
            mesh = make_mesh(dims, axes, device.type)
            shape = dict(zip(axes, dims))
            dp = ("pod", "data") if "pod" in shape else ("data",)
            if train:
                ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None if shape["data"] == 1 else "data", dp=dp)
            else:
                ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=())
            yield ctx
        finally:
            if started:
                dist.destroy_process_group()
