"""AdamW as plain functions on dicts of tensors.

Counterpart of :mod:`repro.train.optimizer`.  The moments are kept in
``moment_dtype`` (float32 by default, bfloat16 for the biggest archs) and the
update math runs in float32; parameters stay in their own type, with no
float32 master copy, as in the reference.  ``torch.optim.AdamW`` is not used:
it keeps its moments in the parameter's type.

Parameters are the model's own tensors, keyed by their state-dict names, and
:func:`apply_updates` updates them and the moments *in place* (the reference
returns new trees), always a row-chunk at a time so that the float32
transients stay below ``chunk_threshold_bytes`` per leaf (the reference's
``chunked_update`` switch is not needed: the update is elementwise, so
chunking never changes a value).

Weight decay follows the reference leaf by leaf: it decays a leaf iff its
rank is at least 2 *in the reference's tree*, where every per-layer leaf of
a scanned stack carries a leading layer axis.  So each ``layers.<i>`` (and
``encoder.<i>``, ``decoder.<i>``) norm scale and bias is decayed (rank 1 here, rank 2 stacked there), while
``ln_f`` and deepseek's unstacked ``dense_layers`` are not
(:func:`reference_rank`).

On a mesh each rank updates its own shard; the clip's global norm sums the
squares of every shard, counting a leaf replicated over ranks once
(:func:`global_norm` with ``ctx`` and ``specs``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..distributed.sharding import psum, replicated_axes
from ..models.lm import STACKS


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" for the biggest archs
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    chunk_threshold_bytes: int = 1 << 28  # 256 MB


def reference_rank(name: str, p: torch.Tensor) -> int:
    """The rank of leaf ``name`` in the reference's tree: one more than here
    for the scanned stacks' per-layer leaves (``layers.<i>.*``, the
    encoder-decoder's ``encoder.<i>.*`` and ``decoder.<i>.*``)."""
    return p.dim() + (1 if name.partition(".")[0] in STACKS else 0)


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments of each parameter in ``moment_dtype`` on its device, and
    the step counter (int32, on the first parameter's device)."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def opt_state_specs(param_specs: dict) -> dict:
    """The layouts of :func:`init_opt_state`'s tree from the parameters'
    (:meth:`LM.param_specs`): each moment as its parameter, the step
    replicated."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def global_norm(grads: dict, ctx=None, specs: dict | None = None) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares.  On a mesh (``ctx`` and
    the leaves' ``specs``) each rank sums its shards, a leaf replicated over
    an axis only on that axis's rank 0, and the ranks' sums are added."""
    if ctx is None or ctx.mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    mine = [g for name, g in grads.items()
            if all(ctx.axis_index(a) == 0 for a in replicated_axes(ctx, specs[name]))]
    dev = next(iter(grads.values())).device
    sq = sum((torch.sum(torch.square(g.float())) for g in mine), torch.zeros((), device=dev))
    axes = [a for a in ctx.mesh.mesh_dim_names if ctx.axis_size(a) > 1]
    return torch.sqrt(psum(sq, [ctx.group(a) for a in axes]) if axes else sq)


def _row_chunks(n_rows: int, row_elems: int, limit_bytes: int):
    """Slices of dim 0 whose float32 copies stay within ``limit_bytes``."""
    rows = max(1, limit_bytes // max(4 * row_elems, 1))
    for r0 in range(0, n_rows, rows):
        yield slice(r0, min(r0 + rows, n_rows))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig, ctx=None, specs=None):
    """One AdamW step on ``params`` (name -> tensor) with ``grads`` (the same
    names).  Updates the parameters and ``state``'s moments in place; returns
    ``(params, state, {"grad_norm", "lr"})``.  On a mesh (``ctx``, the
    leaves' ``specs``) ``params`` are this rank's shards and the clip's norm
    is the global one."""
    step = state["step"] + 1
    gnorm = global_norm(grads, ctx, specs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step).to(gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=stepf.device) ** stepf
    c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=stepf.device) ** stepf

    for name, p in params.items():
        g, m, v = grads[name], state["m"][name], state["v"][name]
        decay = reference_rank(name, p) >= 2  # decoupled weight decay on matrices only
        if p.dim() == 0:
            p, g, m, v = p.view(1), g.view(1), m.view(1), v.view(1)
        row = p[0].numel() if p.shape[0] else 1
        for sl in _row_chunks(p.shape[0], row, cfg.chunk_threshold_bytes):
            g32 = g[sl].float() * scale
            m32 = b1 * m[sl].float() + (1 - b1) * g32
            v32 = b2 * v[sl].float() + (1 - b2) * torch.square(g32)
            upd = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
            if decay:
                upd = upd + cfg.weight_decay * p[sl].float()
            p[sl] = (p[sl].float() - lr * upd).to(p.dtype)
            m[sl] = m32.to(m.dtype)
            v[sl] = v32.to(v.dtype)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
