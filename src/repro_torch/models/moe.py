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
atomics (so a training step on the card is not bit-reproducible).

:func:`moe_layer_a2a` is the expert-parallel dispatch over tp ranks (the
reference's, with sequence parallelism): each rank routes its own tokens,
sends each assignment to the rank owning its expert over an all_to_all,
groups what it receives into its experts' capacity slots, and returns the
outputs by the reverse exchange.  Its two grouping sorts run on K3 through
:func:`stable_argsort`, where the reference calls ``jnp.argsort``.

At tp > 1 without sequence parallelism :func:`moe_layer` is the reference's
psum dispatch (``_dispatch_body``): every tp rank routes the same tokens,
dispatches the assignments of its own ``padded_experts / tp`` slabs with K3,
and the ranks sum their outputs and dropped counts.  On a mesh the capacity
and the load-balance aux are the reference's, over the global batch (the dp
shards' statistics are summed).  On a tp mesh the shared experts are a
tp-parallel MLP (``spec_mlp``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, all_reduce_sum, gather_seq, psum
from ..kernels import ops
from ..obs import costs
from .layers import activation
from .mlp import MLP, mlp, spec_mlp


def padded_experts(num_experts: int, multiple: int = 16) -> int:
    """Expert count padded to the reference's tp width (granite: 40 -> 48).
    The router never picks a padded expert, so it processes an empty
    capacity buffer: pure shape padding, kept so that weights carry across."""
    return -(-num_experts // multiple) * multiple


def spec_moe(ctx: ShardCtx, gated: bool = True, shared: bool = True) -> dict:
    s = {"router": (None, None), "w_in": (ctx.tp, ctx.fsdp, None), "w_out": (ctx.tp, None, ctx.fsdp)}
    if gated:
        s["w_gate"] = (ctx.tp, ctx.fsdp, None)
    if shared:
        s["shared"] = spec_mlp(ctx)
    return s


class MoE(nn.Module):
    """Router (f32, ``(D, num_experts)``) and expert slabs ``(E, ...)`` at
    the padded expert count, in the reference's layout; ``shared`` is the
    always-on MLP of width ``num_shared * d_expert``.  With ``tp_size`` /
    ``fsdp`` > 1 the module holds one rank's shard of each (``spec_moe``:
    ``E / tp_size`` slabs, D cut over fsdp, the shared MLP tp-parallel;
    ``convert.params_from_reference(tree, tp_rank=r, tp_size=tp, ...)``)."""

    def __init__(self, cfg: ModelConfig, dtype, device, tp_size: int = 1, fsdp: int = 1):
        super().__init__()
        require_full_f32(device)
        m = cfg.moe
        D, Fe, E = cfg.d_model, m.d_expert, padded_experts(m.num_experts)
        if E % tp_size:
            raise ValueError(f"{E} padded experts not divisible by tp={tp_size}")
        if D % fsdp:
            raise ValueError(f"d_model {D} does not split over fsdp={fsdp}")
        E //= tp_size

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        self.router = param(D, m.num_experts, dt=torch.float32)
        self.w_in = param(E, D // fsdp, Fe)
        self.w_out = param(E, Fe, D // fsdp)
        if cfg.mlp_gated:
            self.w_gate = param(E, D // fsdp, Fe)
        if m.num_shared:
            self.shared = MLP(D, m.num_shared * Fe, cfg.mlp_gated, cfg.use_bias, dtype, device,
                              tp=tp_size, fsdp=fsdp)


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


def _rank_in_group(sorted_key: torch.Tensor) -> torch.Tensor:
    """Each position's rank within its run of equal sorted keys."""
    first = torch.searchsorted(sorted_key, sorted_key, side="left")
    return torch.arange(sorted_key.numel(), device=sorted_key.device) - first


@dataclasses.dataclass
class Dispatch:
    """Where each assignment goes, indexed by its position in expert order."""

    order: torch.Tensor    # (n*k,) assignment at each sorted position
    slot: torch.Tensor     # (n*k,) flat capacity slot e * C + c, or E * C if dropped
    dropped: torch.Tensor  # () assignments over their expert's capacity


def dispatch(eid: torch.Tensor, num_slabs: int, capacity: int, first: int = 0) -> Dispatch:
    """Range-partition the assignments ``eid`` (n*k,) into the ``num_slabs``
    expert buffers of experts ``[first, first + num_slabs)``, ``capacity``
    slots each: sort by local expert id (stable; another rank's experts
    key ``num_slabs`` and sort last), rank within the expert's group, keep
    ranks below the capacity.  ``dropped`` counts the local assignments over
    capacity.  At tp = 1 every expert is local and the key is the id."""
    key = eid - first if first else eid
    key = torch.where((key >= 0) & (key < num_slabs), key, num_slabs)
    order = stable_argsort(key, num_slabs)
    sk = key[order]
    rank = _rank_in_group(sk)
    mine = sk < num_slabs
    live = mine & (rank < capacity)
    slot = torch.where(live, sk * capacity + rank, num_slabs * capacity)
    return Dispatch(order=order, slot=slot, dropped=(mine & ~live).sum())


def moe_layer(p: MoE, cfg: ModelConfig, x: torch.Tensor, ctx: ShardCtx | None = None):
    """x (B, T, D) -> (output (B, T, D), Switch load-balance aux, dropped
    assignment count), as the reference's ``moe_layer``.  On a ``ctx`` the
    tokens are this rank's dp shard (whole over tp) and ``p`` its shard:
    capacity, aux and dropped are the reference's over the global batch,
    and at tp > 1 each rank runs its own slabs and the ranks sum (the psum
    dispatch).  On the card, TF32 must stay off (:func:`require_full_f32`,
    checked when the :class:`MoE` is built)."""
    m = cfg.moe
    B, T, D = x.shape
    n, k = B * T, m.top_k
    xf = x.reshape(n, D)
    dp_groups = ctx.groups(ctx.dp) if ctx is not None else []
    dp_size = ctx.dp_size if ctx is not None else 1

    logits = xf.float() @ p.router  # full f32: see require_full_f32
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = route(probs, k)

    # Switch-style load-balance aux: E * sum_e f_e * p_e, over the global batch
    me = probs.mean(0)
    counts = torch.zeros(m.num_experts, dtype=torch.float32, device=x.device)
    counts.index_add_(0, topk_idx.reshape(-1), torch.ones(n * k, device=x.device))
    if dp_groups:
        me, counts = psum(me, dp_groups) / dp_size, psum(counts, dp_groups)
    aux = m.num_experts * (me * counts / (n * dp_size * k)).sum()

    E = p.w_in.shape[0]
    tp = ctx.tp_size if ctx is not None else 1
    if E * tp != padded_experts(m.num_experts):
        raise ValueError(f"{E} expert slabs on a rank of tp={tp}; want {padded_experts(m.num_experts)} / {tp}")
    C = max(int(n * dp_size * m.top_k / m.num_experts * m.capacity_factor), 1)
    d = dispatch(topk_idx.reshape(n * k), E, C, ctx.axis_index(ctx.tp) * E if tp > 1 else 0)

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

    dropped = d.dropped
    if tp > 1:
        # merge the expert-range shards' contributions (the psum dispatch)
        out = all_reduce_sum(out, ctx.group(ctx.tp))
        dropped = psum(dropped, ctx.group(ctx.tp))
    if dp_groups:
        dropped = psum(dropped, dp_groups)
    out = out.reshape(B, T, D).to(x.dtype)
    if m.num_shared:
        out = out + mlp(p.shared, cfg, x, ctx)
    return out, aux, dropped


class _A2A(torch.autograd.Function):
    """Tiled all_to_all over the first axis on ``group``; the backward
    exchanges the cotangent back, in bf16 and cast back when ``bf16_grad``
    (the reference's ``_a2a_bf16``, whose cotangent crosses the fabric in
    bf16; the gradients' parity depends on it)."""

    @staticmethod
    def forward(ctx, x, group, bf16_grad):
        ctx.group, ctx.bf16_grad = group, bf16_grad
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.bf16_grad:
            return _a2a(g.to(torch.bfloat16), ctx.group).to(g.dtype), None, None
        return _a2a(g, ctx.group), None, None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    costs.collective("all-to-all", x, out)
    dist.all_to_all_single(out, x, group=group)
    return out


def _a2a_bf16(x: torch.Tensor, group) -> torch.Tensor:
    return _A2A.apply(x, group, True)


def _dispatch_a2a_body(x, w_in, w_gate, w_out, router, *, cfg: ModelConfig, capacity: int,
                       send_cap: int, ctx: ShardCtx):
    """all_to_all expert dispatch on this rank (the reference's
    ``_dispatch_a2a_body`` step for step).  x: (n_loc, D), this rank's own
    tokens; w_*: (E_local, ...), its expert slabs.  Assignments are
    range-partitioned by owning rank, sent over the fabric, grouped into
    per-expert capacity slots by the same sort-rank primitive, processed and
    returned by the reverse exchange.  Row ``tp_size`` of the send matrix
    and slab ``e_local`` of the expert buffers collect what is dropped."""
    m = cfg.moe
    n_loc, D = x.shape
    k, E = m.top_k, m.num_experts
    e_local = w_in.shape[0]
    tp_size, tp = ctx.tp_size, ctx.group(ctx.tp)
    dev = ctx.axis_index(ctx.tp)
    device = x.device

    logits = x.float() @ router  # full f32: see require_full_f32
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = route(probs, k)
    # load-balance aux from local stats, averaged over the tp shards
    me = all_reduce_sum(probs.mean(0), tp) / tp_size
    ce = torch.zeros(E, dtype=torch.float32, device=device)
    ce.index_add_(0, topk_idx.reshape(-1), torch.ones(n_loc * k, device=device))
    ce = psum(ce / (n_loc * k), tp) / tp_size
    aux = E * (me * ce).sum()

    eid = topk_idx.reshape(n_loc * k)
    tok = torch.arange(n_loc, device=device).repeat_interleave(k)
    prob = topk_p.reshape(n_loc * k)
    dst = eid // e_local  # owning rank: the range partition

    # rank within destination (the sort-rank primitive of core.distributed)
    order = stable_argsort(dst, tp_size - 1)
    sd = dst[order]
    rank = _rank_in_group(sd)
    live = rank < send_cap
    slot = torch.where(live, sd * send_cap + rank, tp_size * send_cap)
    overflow = (~live).sum()

    nsend = (tp_size + 1) * send_cap
    send_x = torch.zeros(nsend, D, dtype=x.dtype, device=device).index_add(
        0, slot, x[tok[order]] * live[:, None].to(x.dtype))
    send_e = torch.full((nsend,), E, dtype=torch.int32, device=device)
    send_e[slot] = eid[order].to(torch.int32)
    send_t = torch.full((nsend,), n_loc, dtype=torch.int64, device=device)
    send_t[slot] = tok[order]
    send_p = torch.zeros(nsend, dtype=torch.float32, device=device).index_add(0, slot, prob[order] * live)

    # the fabric (bf16 cotangents for the big payload)
    nr = tp_size * send_cap
    rx = _a2a_bf16(send_x[:nr].view(tp_size, send_cap, D), tp)
    re = _a2a(send_e[:nr], tp)
    rp = _A2A.apply(send_p[:nr], tp, False)

    # group received assignments into per-expert capacity slots
    rxf = rx.reshape(nr, D)
    lkey = torch.where(re < E, re - dev * e_local, e_local)
    lkey = torch.where((lkey >= 0) & (lkey < e_local), lkey, e_local)
    order2 = stable_argsort(lkey, e_local)
    sk = lkey[order2]
    rank2 = _rank_in_group(sk)
    live2 = (sk < e_local) & (rank2 < capacity)
    slot2 = torch.where(live2, sk * capacity + rank2, e_local * capacity)
    overflow = overflow + ((~live2) & (sk < e_local)).sum()

    nbuf = (e_local + 1) * capacity
    buf = torch.zeros(nbuf, D, dtype=x.dtype, device=device).index_add(
        0, slot2, rxf[order2] * live2[:, None].to(x.dtype))
    slot_src = torch.full((nbuf,), nr, dtype=torch.int64, device=device)
    slot_src[slot2] = order2
    slot_p = torch.zeros(nbuf, dtype=torch.float32, device=device).index_add(0, slot2, rp[order2] * live2)

    act = activation(cfg.mlp_act)
    b = buf[: e_local * capacity].view(e_local, capacity, D)
    h = torch.bmm(b, w_in)
    h = act(h) * torch.bmm(b, w_gate) if w_gate is not None else act(h)
    y = torch.bmm(h, w_out)
    y = y * slot_p[: e_local * capacity].view(e_local, capacity, 1).to(y.dtype)

    # return by the reverse exchange: scatter back to receive order, a2a
    back = torch.zeros(nr + 1, D, dtype=y.dtype, device=device).index_add(
        0, slot_src[: e_local * capacity], y.reshape(-1, D))
    ry = _a2a_bf16(back[:nr].view(tp_size, send_cap, D), tp)

    # each token's k returned rows, summed in f32 (as moe_layer sums them)
    out = torch.zeros(n_loc + 1, D, dtype=torch.float32, device=device).index_add(
        0, send_t[:nr], ry.reshape(nr, D).float())
    return out[:n_loc], aux, overflow


def use_a2a(cfg: ModelConfig, ctx: ShardCtx) -> bool:
    return ctx.sp and ctx.tp_size > 1


def moe_layer_a2a(p: MoE, cfg: ModelConfig, ctx: ShardCtx, x: torch.Tensor,
                  x_full: torch.Tensor | None = None):
    """all_to_all expert-parallel MoE over T-sharded tokens (SP), on this rank.

    x: (B_loc, T_loc, D), this rank's tokens: B sharded over the dp axes, T
    over tp, as the reference's ``P(dp, tp, None)``; ``p`` holds this tp
    rank's expert slabs (``MoE(..., tp_size=tp)``).  The capacities are the
    reference's, from the global token count ``B * T``.  ``x_full`` (B_loc,
    T, D), the full-T activation, feeds the shared experts, which each rank
    runs with the whole shared MLP on its own T chunk.  Returns (this rank's
    output (B_loc, T_loc, D), aux as the mean over every dp x tp shard,
    dropped as their sum), the last two replicated.  The shared experts run
    tp-parallel on ``x_full`` (``x`` gathered over T when it is not given)
    and are reduce-scattered back over T.  The token payloads'
    cotangents cross the fabric in bf16, as the reference's do, so an f32
    layer's gradients are within bf16 rounding of ``moe_layer``'s.  On the
    card, TF32 must stay off (:func:`require_full_f32`)."""
    m = cfg.moe
    require_full_f32(x.device)
    if ctx.mesh is None:
        raise ValueError("moe_layer_a2a runs on a mesh: give the ShardCtx a DeviceMesh (make_mesh)")
    B, T, D = x.shape
    tp_size = ctx.tp_size
    if p.w_in.shape[0] * tp_size != padded_experts(m.num_experts):
        raise ValueError(
            f"{p.w_in.shape[0]} expert slabs on a rank of tp={tp_size}; want "
            f"{padded_experts(m.num_experts)} / {tp_size}"
        )
    dp_size = math.prod(ctx.axis_size(a) for a in ctx.dp)
    n = B * dp_size * T * tp_size  # the reference's global B * T
    n_loc = n // tp_size
    capacity = max(int(n * m.top_k / m.num_experts * m.capacity_factor), 1)
    send_cap = max(int(n_loc * m.top_k / tp_size * 2.0), 8)  # 2x slack
    out, aux, dropped = _dispatch_a2a_body(
        x.reshape(-1, D), p.w_in, getattr(p, "w_gate", None), p.w_out, p.router,
        cfg=cfg, capacity=capacity, send_cap=send_cap, ctx=ctx)
    # the scalars vary over dp and tp: the mean and the sum over all of them
    groups = [ctx.group(a) for a in (*ctx.dp, ctx.tp) if ctx.axis_size(a) > 1]
    if groups:
        aux = psum(aux, groups) / (dp_size * tp_size)
        dropped = psum(dropped, groups)
    y = out.reshape(x.shape).to(x.dtype)
    if m.num_shared:
        xf = x_full if x_full is not None else gather_seq(x, ctx)
        y = y + mlp(p.shared, cfg, xf, ctx, seq_sharded=True)
    return y, aux, dropped
