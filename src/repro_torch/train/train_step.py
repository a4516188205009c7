"""Train-step builder: microbatched gradient accumulation and AdamW.

Counterpart of :mod:`repro.train.train_step`.
``build_train_step(model, opt_cfg, microbatches)`` returns
``step(opt_state, batch) -> (opt_state, metrics)``, which updates the
model's parameters in place (the reference returns new ones).  The model
must be trainable (``model.requires_grad_(True)``).  The batch is split into
``microbatches`` slices along its first axis, run one after the other, each
with the model's per-block recompute, so live activations are one
microbatch deep; their gradients accumulate in ``accum_dtype`` and are
averaged.  A batch that ``microbatches`` does not divide raises, as the
reference's reshape into ``(microbatches, B // microbatches, ...)`` does.
With one microbatch the gradients keep the parameters' type, as the
reference's ``jax.value_and_grad`` gives them.  ``grad_compressor`` is
an optional ``grads -> grads`` hook applied before the optimizer (the int8
error-feedback compressor plugs in here).

On a mesh (a model built with a ``ShardCtx``) every rank runs the step on
its rows of the batch (:func:`shard_batch`) and its shard of the
parameters.  Each rank's loss is the global mean, so the gradient of a
sharded leaf is whole on its rank, and a leaf replicated over a dp or tp
axis gets the sum of the ranks' gradients over that axis by an all-reduce
after ``backward`` (an fsdp leaf comes reduce-scattered from the gather's
transpose); then the compressor, the global-norm clip over every shard and
AdamW on each rank's shard.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..distributed.sharding import replicated_axes, shard_leaf
from ..obs import costs
from .optimizer import AdamWConfig, apply_updates


def shard_batch(batch: dict, ctx, microbatches: int = 1) -> dict:
    """This rank's rows of a global ``batch`` (arrays or tensors, rows
    first): microbatch ``i`` of the result is this rank's dp shard of the
    global microbatch ``i`` (rows ``[i * B/m, (i + 1) * B/m)``), as the
    reference splits the batch and then shards each microbatch over dp."""
    if ctx is None or ctx.dp_size == 1:
        return batch
    out = {}
    for k, x in batch.items():
        B = x.shape[0]
        if B % (microbatches * ctx.dp_size):
            raise ValueError(f"a batch of B={B} rows does not split into {microbatches} microbatches "
                             f"over dp={ctx.dp_size}")
        t = torch.as_tensor(x)
        parts = [shard_leaf(mb, ctx.spec_batch(), ctx.coords()) for mb in t.chunk(microbatches)]
        out[k] = torch.cat(parts) if isinstance(x, torch.Tensor) else torch.cat(parts).numpy()
    return out


def sync_grads(grads: dict, ctx, specs: dict) -> dict:
    """Sum each gradient over the axes its leaf is replicated on
    (:func:`~repro_torch.distributed.sharding.replicated_axes`), in place."""
    for name, g in grads.items():
        for a in replicated_axes(ctx, specs[name]):
            costs.collective("all-reduce", g)
            dist.all_reduce(g, group=ctx.group(a))
    return grads


def build_train_step(
    model,
    opt_cfg: AdamWConfig,
    microbatches: int = 1,
    aux_weight: float = 0.01,
    grad_compressor: Callable | None = None,
    accum_dtype=torch.float32,
) -> Callable:
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise ValueError("the model is frozen: call model.requires_grad_(True) before building a train step")
    ctx = getattr(model, "ctx", None)
    specs = model.param_specs() if ctx is not None else None

    # the leaves the model's loss does not reach (an embeddings model's token
    # table) get a zero gradient, as the reference's jax.grad gives them; any
    # other leaf cut off from the loss still fails in autograd
    unreached = set(getattr(model, "loss_unreached", ()))
    reached = [p for name, p in params.items() if name not in unreached]

    def loss_and_grads(mb: dict):
        loss, metrics = model.loss(mb, aux_weight=aux_weight)
        got = iter(torch.autograd.grad(loss, reached))
        grads = {name: torch.zeros_like(p) if name in unreached else next(got) for name, p in params.items()}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(opt_state: dict, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"microbatches={microbatches} does not divide the batch of B={B} rows")
            size = B // microbatches
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for k, p in params.items()}
            # a float32 zero (the loss's type), so that every microbatch adds alike
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(params.values())).device)
            # the dry run may count the first microbatch for all of them
            with costs.repeats(microbatches) as runs:
                for i in range(runs):
                    mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
                    mb_loss, mb_metrics, mb_grads = loss_and_grads(mb)
                    for k, acc in grads.items():  # each gradient freed once added
                        acc += mb_grads.pop(k).to(accum_dtype)
                    loss = loss + mb_loss
                    del mb_loss, mb_metrics
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss / microbatches
            metrics = {}
        if ctx is not None:
            grads = sync_grads({k: g.contiguous() for k, g in grads.items()}, ctx, specs)
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        _, opt_state, opt_metrics = apply_updates(params, grads, opt_state, opt_cfg, ctx=ctx, specs=specs)
        return opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step
