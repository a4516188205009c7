"""Feed-forward block: gated (SwiGLU/GeGLU) or plain.

Counterpart of :mod:`repro.models.mlp`.  The gated form is
``act(x @ w_in) * (x @ w_gate) @ w_out``: the activation is on ``w_in``.
On a tp mesh ``w_in``/``w_gate`` are column-parallel and ``w_out``
row-parallel (``spec_mlp``): each rank's partial output is summed over tp,
or reduce-scattered over T under sequence parallelism, before ``b_out``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, tp_sum
from .layers import activation


def spec_mlp(ctx: ShardCtx, gated: bool = True, use_bias: bool = True) -> dict:
    s = {"w_in": ctx.spec_w2(False), "w_out": ctx.spec_w2(True)}
    if gated:
        s["w_gate"] = ctx.spec_w2(False)
    if use_bias:
        s["b_in"] = (ctx.tp,)
        s["b_out"] = (None,)
    return s


class MLP(nn.Module):
    """Weights in the reference's (d_in, d_out) layout; with ``tp`` /
    ``fsdp`` > 1 this rank's shard of each (``spec_mlp``)."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, use_bias: bool, dtype, device,
                 tp: int = 1, fsdp: int = 1):
        super().__init__()
        if d_ff % tp or d_model % fsdp:
            raise ValueError(f"an MLP of {d_model} x {d_ff} does not split over tp={tp}, fsdp={fsdp}")

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        D, F = d_model, d_ff // tp
        self.w_in = param(D // fsdp, F)
        self.w_out = param(F, D // fsdp)
        if gated:
            self.w_gate = param(D // fsdp, F)
        if use_bias:
            self.b_in = param(F)
            self.b_out = param(D)


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor, ctx: ShardCtx | None = None, *,
        seq_sharded: bool = False) -> torch.Tensor:
    """``x`` (..., D) whole on every tp rank; ``p`` this rank's shard (its
    fsdp dims gathered).  At tp > 1 the row-parallel output is summed over
    tp, or with ``seq_sharded`` ((B, T, D), the output T-sharded:
    sequence parallelism) reduce-scattered over T."""
    act = activation(cfg.mlp_act)
    h = x @ p.w_in
    if hasattr(p, "b_in"):
        h = h + p.b_in
    h = act(h) * (x @ p.w_gate) if hasattr(p, "w_gate") else act(h)
    out = tp_sum(h @ p.w_out, ctx, seq_sharded)
    if hasattr(p, "b_out"):
        out = out + p.b_out
    return out
