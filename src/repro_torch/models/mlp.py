"""Feed-forward block: gated (SwiGLU/GeGLU) or plain.

Counterpart of :mod:`repro.models.mlp`.  The gated form is
``act(x @ w_in) * (x @ w_gate) @ w_out``: the activation is on ``w_in``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import activation, dense_init


class MLP(nn.Module):
    """Weights in the reference's (d_in, d_out) layout."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, use_bias: bool, dtype, device):
        super().__init__()

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)

        self.w_in = param(d_model, d_ff)
        self.w_out = param(d_ff, d_model)
        if gated:
            self.w_gate = param(d_model, d_ff)
        if use_bias:
            self.b_in = param(d_ff)
            self.b_out = param(d_model)


@torch.no_grad()
def init_mlp(p: MLP, generator: torch.Generator) -> MLP:
    dense_init(p.w_in, generator)
    dense_init(p.w_out, generator, scale=p.w_out.shape[0] ** -0.5)
    if hasattr(p, "w_gate"):
        dense_init(p.w_gate, generator)
    if hasattr(p, "b_in"):
        p.b_in.zero_()
        p.b_out.zero_()
    return p


def mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.mlp_act)
    h = x @ p.w_in
    if hasattr(p, "b_in"):
        h = h + p.b_in
    h = act(h) * (x @ p.w_gate) if hasattr(p, "w_gate") else act(h)
    out = h @ p.w_out
    if hasattr(p, "b_out"):
        out = out + p.b_out
    return out
