"""Mixture-of-Experts with sort-based dispatch, on one device.

Counterpart of :mod:`repro.models.moe` at tp = 1 (``moe_layer`` with
``_dispatch_body`` on one shard).  Assignments are grouped by expert id with
a range sort -- the switch's segments are the experts -- and each one's
rank inside its expert's group is its capacity slot; assignments past the
capacity are dropped and counted.  The sort runs on K3 (the key-value
bitonic sort, :func:`repro_torch.kernels.ops.argsort_padded`), as the
reference's kernel was built to be used.

The reference sorts with ``jnp.argsort``, which is stable, and the order
inside an expert's group decides which assignments keep a slot when the
capacity binds (at decode it is one slot per expert).  K3 is not stable, so
:func:`stable_argsort` sorts the composite key ``key * nk + index``: unique
keys, for which every correct sort gives the stable permutation of ``key``.

The expert outputs come back to their tokens by a gather of each token's
``k`` slots summed in float32, then cast: no atomics, so the sum is the same
on every run and device (the reference adds them in the activation's type,
in expert order, with a scatter-add).  Under autograd the integer dispatch
carries no gradient; the weights reach ``topk_p`` through the ``slot_p``
index write, the tokens through the gathers, whose backward adds rows with
atomics (so a training step on the card is not bit-reproducible).  The expert-parallel all_to_all
dispatch (``moe_layer_a2a``) and every tp > 1 path belong to the sharded
slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import activation, dense_init
from .mlp import MLP, init_mlp, mlp


def padded_experts(num_experts: int, multiple: int = 16) -> int:
    """Expert count padded to the reference's tp width (granite: 40 -> 48).
    The router never picks a padded expert, so it processes an empty
    capacity buffer: pure shape padding, kept so that weights carry across."""
    return -(-num_experts // multiple) * multiple


class MoE(nn.Module):
    """Router (f32, ``(D, num_experts)``) and expert slabs ``(E, ...)`` at
    the padded expert count, in the reference's layout; ``shared`` is the
    always-on MLP of width ``num_shared * d_expert``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        require_full_f32(device)
        m = cfg.moe
        D, Fe, E = cfg.d_model, m.d_expert, padded_experts(m.num_experts)

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        self.router = param(D, m.num_experts, dt=torch.float32)
        self.w_in = param(E, D, Fe)
        self.w_out = param(E, Fe, D)
        if cfg.mlp_gated:
            self.w_gate = param(E, D, Fe)
        if m.num_shared:
            self.shared = MLP(D, m.num_shared * Fe, cfg.mlp_gated, cfg.use_bias, dtype, device)


@torch.no_grad()
def init_moe(p: MoE, generator: torch.Generator) -> MoE:
    """The reference's distributions: router N(0,1) * D^-1/2 in f32, ``w_in``
    and ``w_gate`` N(0,1) * D^-1/2, ``w_out`` N(0,1) * d_expert^-1/2, each
    drawn in f32 and cast; the shared MLP as any MLP."""
    dense_init(p.router, generator)
    for w, fan_in in ((p.w_in, p.w_in.shape[1]), (p.w_out, p.w_out.shape[1]),
                      (getattr(p, "w_gate", None), p.w_in.shape[1])):
        if w is not None:
            draw = torch.randn(w.shape, generator=generator, device=w.device, dtype=torch.float32)
            w.copy_(draw.mul_(fan_in**-0.5))
            del draw
    if hasattr(p, "shared"):
        init_mlp(p.shared, generator)
    return p


def require_full_f32(device) -> None:
    """The router's product must run in full float32: with TF32 on, the card
    rounds its inputs to 10 mantissa bits and router near-ties pick other
    experts than the CPU does.  TF32 is off by torch's default; this raises,
    on a CUDA ``device``, if it has been turned on."""
    if torch.device(device).type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "the MoE router needs full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (torch's default)"
        )


def route(probs: torch.Tensor, k: int):
    """Each token's top-``k`` experts and their weights, renormalised to sum
    to one: ``(weights (n, k) f32, expert ids (n, k))``."""
    topk_p, topk_idx = torch.topk(probs, k, dim=-1)
    return topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9), topk_idx


def stable_argsort(key: torch.Tensor, key_max: int) -> torch.Tensor:
    """``argsort(key, stable=True)`` of a 1-D ``key`` with values in
    ``[0, key_max]``, on K3: the composite keys ``key * nk + arange(nk)`` are
    unique, so K3's unstable network orders them as a stable sort orders
    ``key``.  int32 while the composites stay below the int32 pad, else
    int64.  Returns the permutation (int64)."""
    nk = key.numel()
    dtype = torch.int32 if (key_max + 1) * nk < 2**31 else torch.int64
    composite = key.to(dtype) * nk + torch.arange(nk, dtype=dtype, device=key.device)
    _, order = ops.argsort_padded(composite)
    return order.long()


@dataclasses.dataclass
class Dispatch:
    """Where each assignment goes, indexed by its position in expert order."""

    order: torch.Tensor    # (n*k,) assignment at each sorted position
    slot: torch.Tensor     # (n*k,) flat capacity slot e * C + c, or E * C if dropped
    dropped: torch.Tensor  # () assignments over their expert's capacity


def dispatch(eid: torch.Tensor, num_slabs: int, capacity: int) -> Dispatch:
    """Range-partition the assignments ``eid`` (n*k,) into ``num_slabs``
    expert buffers of ``capacity`` slots: sort by expert id (stable), rank
    within the expert's group, keep ranks below the capacity.  At tp = 1
    every expert is local, so the key is the expert id itself."""
    nk = eid.numel()
    order = stable_argsort(eid, num_slabs)
    sk = eid[order]
    first = torch.searchsorted(sk, sk, side="left")
    rank = torch.arange(nk, device=eid.device) - first
    live = rank < capacity
    slot = torch.where(live, sk * capacity + rank, num_slabs * capacity)
    return Dispatch(order=order, slot=slot, dropped=(~live).sum())


def moe_layer(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """x (B, T, D) -> (output (B, T, D), Switch load-balance aux, dropped
    assignment count), as the reference's ``moe_layer`` at tp = 1.  On the
    card, TF32 must stay off (:func:`require_full_f32`, checked when the
    :class:`MoE` is built)."""
    m = cfg.moe
    B, T, D = x.shape
    n, k = B * T, m.top_k
    xf = x.reshape(n, D)

    logits = xf.float() @ p.router  # full f32: see require_full_f32
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = route(probs, k)

    # Switch-style load-balance aux: E * sum_e f_e * p_e
    me = probs.mean(0)
    counts = torch.zeros(m.num_experts, dtype=torch.float32, device=x.device)
    counts.index_add_(0, topk_idx.reshape(-1), torch.ones(n * k, device=x.device))
    aux = m.num_experts * (me * counts / (n * k)).sum()

    E = p.w_in.shape[0]
    C = max(int(n * m.top_k / m.num_experts * m.capacity_factor), 1)
    d = dispatch(topk_idx.reshape(n * k), E, C)

    # gather token vectors into (E, C, D) buffers; an empty slot reads token
    # (slot mod n) times 0.  Each gather's backward adds rows with index_add
    # where indexing would group equal indices and add each group in
    # sequence: every empty slot (or dropped assignment) on one junk row made
    # that backward take most of a training step.
    slot_tok = torch.full((E * C + 1,), n, dtype=torch.long, device=x.device)
    slot_tok[d.slot] = d.order // k  # only the junk entry E*C sees repeats
    slot_p = torch.zeros(E * C + 1, dtype=torch.float32, device=x.device)
    slot_p[d.slot] = topk_p.reshape(n * k)[d.order]
    slot_tok = slot_tok[:-1]
    filled = slot_tok < n
    src = torch.where(filled, slot_tok, torch.arange(E * C, device=x.device) % n)
    buf = (xf.index_select(0, src) * filled[:, None].to(xf.dtype)).view(E, C, D)

    act = activation(cfg.mlp_act)
    h = torch.bmm(buf, p.w_in)
    h = act(h) * torch.bmm(buf, p.w_gate) if hasattr(p, "w_gate") else act(h)
    y = torch.bmm(h, p.w_out)
    y = y * slot_p[:-1].view(E, C, 1).to(y.dtype)

    # each token's k slots (a zero row where dropped), summed in f32
    pos = torch.empty_like(d.order)
    pos[d.order] = torch.arange(n * k, device=x.device)
    slot_of = d.slot[pos]
    kept = slot_of < E * C
    src = torch.where(kept, slot_of, torch.arange(n * k, device=x.device) % (E * C))
    out = (y.reshape(E * C, D).index_select(0, src) * kept[:, None].to(y.dtype)).view(n, k, D).float().sum(1)

    out = out.reshape(B, T, D).to(x.dtype)
    if m.num_shared:
        out = out + mlp(p.shared, cfg, x)
    return out, aux, d.dropped


def moe_layer_a2a(*args, **kwargs):
    raise NotImplementedError(
        "the all_to_all expert-parallel dispatch runs over tp > 1 shards: it is "
        "the sharded slice of the port (M19)"
    )
