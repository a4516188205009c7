"""Pipeline parallelism: the GPipe schedule over a mesh axis.

Counterpart of :mod:`repro.distributed.pp`.  ``gpipe`` runs a stage function
over ``S`` pipeline stages (the ranks along ``axis``) and ``M``
microbatches with the classic (M + S - 1)-tick schedule: each tick every
rank applies its stage to its current buffer and passes the activation to
the next stage (``ppermute``: a ``send``/``recv`` pair).  Bubbles at the
edges are masked.  The backward runs the same schedule in reverse: the
permute's transpose sends each gradient to the previous stage.

The reference writes the ticks as a ``lax.scan`` under ``shard_map``; here
every rank loops over the ticks.  Each tick's ops are the same on every
rank (the stage choice is a mask, not a branch), so every rank's autograd
graph holds the same permutes in the same order and the backward's sends
and receives pair up.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import psum


class _PPermute(torch.autograd.Function):
    """Send ``y`` to ``dst`` and receive the same shape from ``src`` (zeros
    where there is none); backward sends the gradient to ``src`` and takes
    the one from ``dst``.  ``src``/``dst`` are global ranks or None."""

    @staticmethod
    def forward(ctx, y, group, src, dst, tag):
        ctx.group, ctx.src, ctx.dst, ctx.tag = group, src, dst, tag
        return _exchange(y, group, send_to=dst, recv_from=src, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, send_to=ctx.src, recv_from=ctx.dst, tag=ctx.tag), None, None, None, None


def _exchange(y, group, *, send_to, recv_from, tag):
    y = y.contiguous()
    out = torch.zeros_like(y)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, y, send_to, group, tag))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from, group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def gpipe(stage_fn, stage_params, microbatches: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Run a pipelined stack on this rank.

    stage_fn: (params of one stage, x (mb, ...)) -> y (mb, ...), shape-uniform
    stage_params: this rank's shard of the stacked (S, ...) stage tree, a
        dict whose leaves are (1, ...) (the reference's ``P(axis)`` shard;
        ``models.convert.params_from_reference(tree, stage=s)``)
    microbatches: (M, mb, ...) input microbatches, the same on every rank
    Returns the (M, mb, ...) outputs of the final stage, replicated over
    ``axis``: a loss of them on every rank is counted once, and each rank's
    backward gives the gradient of its own stage's parameters.
    """
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    M = microbatches.shape[0]
    idx = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    src = ranks[idx - 1] if idx > 0 else None
    dst = ranks[idx + 1] if idx < S - 1 else None
    p = {k: v[0] for k, v in stage_params.items()}
    zero = torch.zeros_like(microbatches[0])
    first = torch.tensor(idx == 0, device=zero.device)
    buf, outs = zero, []
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (if in range); the others use buf
        x_in = torch.where(first, microbatches[min(max(t, 0), M - 1)], buf)
        live = torch.tensor(0 <= t - idx < M, device=zero.device)
        y = torch.where(live, stage_fn(p, x_in), zero)
        buf = _PPermute.apply(y, group, src, dst, t) if S > 1 else zero
        # collect final-stage outputs (a masked sum below)
        outs.append(torch.where(live & (idx == S - 1), y, zero))
    # tick t emits microbatch t - (S - 1) at the last stage; replicate it
    return psum(torch.stack(outs[S - 1:]), group)


def sequential_reference(stage_fn, stage_params, microbatches: torch.Tensor) -> torch.Tensor:
    """Oracle: apply all stages in order to each microbatch (``stage_params``
    the whole (S, ...) stack)."""
    S = next(iter(stage_params.values())).shape[0]
    out = []
    for x in microbatches:
        for s in range(S):
            x = stage_fn({k: v[s] for k, v in stage_params.items()}, x)
        out.append(x)
    return torch.stack(out)
