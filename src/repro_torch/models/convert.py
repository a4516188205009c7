"""Carry the reference's weights and AdamW state across: its ``LM.init``
tree <-> this port's module state, its ``init_opt_state`` tree <-> the
port's optimizer state.

The reference keeps layer parameters stacked ``(L, ...)`` under ``layers``
(the encoder-decoder's under ``encoder`` and ``decoder``); the port has one
module per layer, so each stack is cut into ``layers.<i>.<...>``
(``encoder.<i>.<...>``, ``decoder.<i>.<...>``).  Every other leaf keeps its path, joined by dots; a
list (deepseek-moe's ``dense_layers``, one dict per layer) contributes its
index, ``dense_layers.<i>.<...>``.  Leaves
are numpy arrays (``jax.tree.map(numpy.asarray, params)``), bfloat16 ones
included, or CPU tensors (a reference checkpoint restored by
:class:`repro_torch.train.checkpoint.CheckpointManager`); values are copied
bit for bit.  :func:`params_to_reference` and :func:`opt_state_to_reference`
go the other way (tensors stacked back into each stack), which is the tree
the training CLI checkpoints, so either package's CLI resumes the other's.

On a mesh every leaf is cut by its layout (:func:`repro_torch.models.lm.leaf_spec`,
the reference's ``spec_*``): ``params_from_reference(tree, ctx, cfg)``
gives one rank's shard (``ctx`` a mesh's context, or one rank's
coordinates without a mesh, :meth:`ShardCtx.grid`), and
``params_to_reference(state, ctx, cfg)`` all-gathers a rank's shards back
to the whole tree (every rank of the mesh takes part).  :func:`merge_shards`
joins a full grid of shard states in one process.  The config is read where
the layout depends on it: a model whose attention runs context-parallel (kv
heads that tp does not divide, under the ctx's sequence parallelism) keeps
its attention leaves whole over tp, and without the config such a cut
raises.  Checkpoints are the whole tree either way, so a model trained
context-parallel serves in the column-split layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..distributed.sharding import ShardCtx, gather_leaf, shard_leaf
from .lm import STACKS, leaf_spec


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: carry the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = _tensor(tree)


def params_from_reference(tree: dict, ctx: ShardCtx | None = None, cfg: ModelConfig | None = None, *,
                          stage: int | None = None) -> dict[str, torch.Tensor]:
    """A state dict for :class:`repro_torch.models.lm.LM` (``load_state_dict``)
    from the reference's parameter tree.

    With ``ctx`` (a mesh's, or :meth:`ShardCtx.grid` coordinates) one rank's
    shard of it, for the sharded paths: every leaf is cut by its layout
    (:func:`repro_torch.models.lm.leaf_spec`, which reads ``cfg`` for the
    attention's leaves under sequence parallelism) to the ctx's tp and fsdp
    coordinates (attention columns, FFN hidden, expert slabs and vocabulary
    over tp, the block matrices' D over fsdp; norms and the router stay
    whole, and so does a context-parallel attention over tp); ``stage``
    keeps pipeline stage ``stage``'s slice ``[stage : stage + 1]`` of every
    leaf of a stacked stage tree (the ``P(axis)`` shard
    ``distributed.pp.gpipe`` takes)."""
    state: dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        if key in STACKS:
            flat: dict[str, torch.Tensor] = {}
            _flatten(sub, "", flat)
            n = {v.shape[0] for v in flat.values()}
            if len(n) != 1:
                raise ValueError(f"stacked {key} leaves disagree on depth: {sorted(n)}")
            for i in range(n.pop()):
                for name, v in flat.items():
                    state[f"{key}.{i}.{name}"] = v[i].clone()
        else:
            _flatten(sub, f"{key}.", state)
    ctx = ctx if ctx is not None else ShardCtx()
    coords = ctx.coords()
    if stage is None and all(n == 1 for _, n in coords.values()):
        return state
    out = {}
    for name, v in state.items():
        if stage is not None:
            v = v[stage : stage + 1]
        try:
            out[name] = shard_leaf(v, leaf_spec(name, v.dim(), ctx, cfg), coords).clone()
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    return out


def merge_shards(states, ctx: ShardCtx, cfg: ModelConfig | None = None) -> dict[str, torch.Tensor]:
    """The whole state dict from every rank's shard: ``states[t][f]`` is
    :func:`params_from_reference`'s state at tp rank ``t`` and fsdp rank
    ``f`` of ``ctx``'s axis sizes (the inverse of the cut, in one process;
    ``cfg`` as there)."""
    out = {}
    for name, v in states[0][0].items():
        spec = leaf_spec(name, v.dim(), ctx, cfg)

        def join(parts, axis):
            dim = spec.index(axis) if axis in spec else None
            return parts[0] if dim is None else torch.cat(parts, dim)

        out[name] = join([join([states[t][f][name] for f in range(ctx.axis_size(ctx.fsdp))], ctx.fsdp)
                          for t in range(ctx.tp_size)], ctx.tp)
    return out


def opt_state_from_reference(state: dict, ctx: ShardCtx | None = None, cfg: ModelConfig | None = None) -> dict:
    """The port's AdamW state (:func:`repro_torch.train.optimizer.init_opt_state`
    layout: ``m`` and ``v`` keyed by state-dict name, ``step`` an int32
    scalar) from the reference's ``{"m", "v", "step"}`` tree; ``ctx`` and
    ``cfg`` cut the moments as :func:`params_from_reference` cuts the
    parameters."""
    return {"m": params_from_reference(state["m"], ctx, cfg), "v": params_from_reference(state["v"], ctx, cfg),
            "step": _tensor(state["step"]).to(torch.int32).reshape(())}


def _nest(flat: dict[str, torch.Tensor]) -> dict:
    """Dotted names -> nested dicts; the items of ``dense_layers`` a list."""
    root: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    if "dense_layers" in root:
        layers = root["dense_layers"]
        root["dense_layers"] = [layers[str(i)] for i in range(len(layers))]
    return root


def params_to_reference(state: dict[str, torch.Tensor], ctx: ShardCtx | None = None,
                        cfg: ModelConfig | None = None) -> dict:
    """The reference's parameter tree from a state dict of
    :class:`repro_torch.models.lm.LM`: ``layers.<i>.<name>`` stacked into
    ``layers.<name>`` of depth L.  The stacked leaves are new tensors; the
    others are the state dict's own, detached.  With a ``ctx`` of a mesh,
    ``state`` is this rank's shard and every leaf is all-gathered whole
    first (every rank of the mesh must call it), by the layouts of
    :func:`params_from_reference` (``cfg`` as there)."""
    if ctx is not None and ctx.mesh is not None:
        state = {name: gather_leaf(ctx, v.detach(), leaf_spec(name, v.dim(), ctx, cfg)) for name, v in state.items()}
    per_layer: dict[str, dict[str, dict[int, torch.Tensor]]] = {}
    rest: dict[str, torch.Tensor] = {}
    for name, v in state.items():
        head, _, tail = name.partition(".")
        if head in STACKS:
            i, _, leaf = tail.partition(".")
            per_layer.setdefault(head, {}).setdefault(leaf, {})[int(i)] = v.detach()
        else:
            rest[name] = v.detach()
    tree = _nest(rest)
    for head, leaves in per_layer.items():
        stacked = {leaf: torch.stack([by_i[i] for i in range(len(by_i))]) for leaf, by_i in leaves.items()}
        tree[head] = _nest(stacked)
    return tree


def opt_state_to_reference(state: dict, ctx: ShardCtx | None = None, cfg: ModelConfig | None = None) -> dict:
    """The reference's ``{"m", "v", "step"}`` AdamW tree from the port's (a
    rank's shards gathered whole with a ``ctx``, as
    :func:`params_to_reference`)."""
    return {"m": params_to_reference(state["m"], ctx, cfg), "v": params_to_reference(state["v"], ctx, cfg),
            "step": state["step"].detach().clone()}
