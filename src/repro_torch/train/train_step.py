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
"""

from __future__ import annotations

from typing import Callable

import torch

from .optimizer import AdamWConfig, apply_updates


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
    names, leaves = list(params), list(params.values())

    def loss_and_grads(mb: dict):
        loss, metrics = model.loss(mb, aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))

    def train_step(opt_state: dict, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"microbatches={microbatches} does not divide the batch of B={B} rows")
            size = B // microbatches
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device) for k, p in params.items()}
            loss = 0.0
            for i in range(microbatches):
                mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
                mb_loss, _, mb_grads = loss_and_grads(mb)
                for k, g in mb_grads.items():
                    grads[k] += g.to(accum_dtype)
                del mb_grads
                loss = loss + mb_loss
            grads = {k: g / microbatches for k, g in grads.items()}
            loss = loss / microbatches
            metrics = {}
        if grad_compressor is not None:
            grads = grad_compressor(grads)
        _, opt_state, opt_metrics = apply_updates(params, grads, opt_state, opt_cfg)
        return opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step
