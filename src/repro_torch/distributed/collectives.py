"""int8 error-feedback gradient compression and the straggler-aware step
monitor.

Counterpart of :mod:`repro.distributed.collectives`: each gradient leaf is
quantized to int8 with a per-leaf scale and the quantization error is
carried into the next step (error feedback, which keeps SGD/Adam
convergence).  ``torch.round`` and ``jnp.round`` both round half to even, so
``q`` and the scale equal the reference's.  The compressor is a gradient
hook that the caller runs before the optimizer; like the reference's, it
does no cross-replica reduce itself: on a mesh it runs on the gradients the
train step has already summed over their replicated axes, each rank on its
shards, and a sharded leaf's scale is the max over its whole leaf (an
all-reduce of the shards' maxima), so the values are the reference's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..obs import costs


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the scale ``max|x| / 127 + 1e-12``; ``amax`` gives
    the max where ``x`` is a shard of the leaf."""
    scale = (x.abs().max() if amax is None else amax) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(x: torch.Tensor, residual: torch.Tensor, amax: torch.Tensor | None = None):
    """One error-feedback round: returns (decompressed, new_residual).
    ``amax``: the max of ``|x + residual|`` over the whole leaf where ``x``
    is a part of it."""
    xe = x + residual
    q, s = quantize_int8(xe, amax)
    deq = dequantize_int8(q, s)
    return deq, xe - deq


def make_int8_compressor(ctx=None, specs: dict | None = None):
    """Returns (compressor_fn, init_residual_fn) over dicts of gradient
    tensors.  ``compressor_fn(grads, residuals) -> (grads, residuals)``
    quantizes and dequantizes each leaf in float32 with error feedback and
    casts back to the leaf's type; the caller runs it before the optimizer.
    ``ctx`` is the reference's :class:`ShardCtx` argument; with a mesh and
    the leaves' layouts (``specs``, :meth:`LM.param_specs`) each leaf is
    this rank's shard and its scale the whole leaf's.

    A leaf's scale is the reference leaf's: the LM's scanned stack is one
    leaf there (``layers.<name>``, every layer's slice), so the gradients
    of ``layers.<i>.<name>`` share the max over every ``i``."""

    def groups(name):
        if ctx is None or ctx.mesh is None or specs is None:
            return ()
        axes = {a for e in specs[name] if e is not None for a in (e if isinstance(e, tuple) else (e,))}
        return tuple(ctx.groups(sorted(axes)))

    def init_residual(grads: dict) -> dict:
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device) for k, g in grads.items()}

    def compress(grads: dict, residuals: dict):
        xe = {k: g.float() + residuals[k] for k, g in grads.items()}
        amax = {k: x.abs().max() for k, x in xe.items()}
        stacks: dict[str, list[str]] = {}
        for k in grads:
            head, _, rest = k.partition(".")
            if head == "layers":
                stacks.setdefault(rest.partition(".")[2], []).append(k)
        for names in stacks.values():
            top = torch.stack([amax[k] for k in names]).max()
            amax.update(dict.fromkeys(names, top))
        out_g, out_r = {}, {}
        for k, g in grads.items():
            for grp in groups(k):
                amax[k] = amax[k].clone()
                costs.collective("all-reduce", amax[k])
                dist.all_reduce(amax[k], op=dist.ReduceOp.MAX, group=grp)
            dg, out_r[k] = compress_decompress(g.float(), residuals[k], amax[k])
            out_g[k] = dg.to(g.dtype)
        return out_g, out_r

    return compress, init_residual


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step wall-time tracker with MAD outlier detection (host clock;
    the caller synchronises the card before ``stop`` where device time
    matters)."""

    window: int = 50
    threshold: float = 4.0  # MAD multiples
    times: list = dataclasses.field(default_factory=list)
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record one step; True if this step is a straggler outlier."""
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.times = self.times[-self.window :]
        if len(self.times) < 8:
            return False
        med = float(np.median(self.times))
        mad = float(np.median(np.abs(np.asarray(self.times) - med))) + 1e-9
        return dt > med + self.threshold * mad

    def summary(self) -> dict:
        arr = np.asarray(self.times) if self.times else np.zeros(1)
        return {
            "median_s": float(np.median(arr)),
            "p95_s": float(np.percentile(arr, 95)),
            "max_s": float(arr.max()),
        }
