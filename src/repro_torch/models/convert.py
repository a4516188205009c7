"""Carry the reference's weights and AdamW state across: its ``LM.init``
tree <-> this port's module state, its ``init_opt_state`` tree <-> the
port's optimizer state.

The reference keeps layer parameters stacked ``(L, ...)`` under ``layers``;
the port has one module per layer, so the stack is cut into
``layers.<i>.<...>``.  Every other leaf keeps its path, joined by dots; a
list (deepseek-moe's ``dense_layers``, one dict per layer) contributes its
index, ``dense_layers.<i>.<...>``.  Leaves
are numpy arrays (``jax.tree.map(numpy.asarray, params)``), bfloat16 ones
included, or CPU tensors (a reference checkpoint restored by
:class:`repro_torch.train.checkpoint.CheckpointManager`); values are copied
bit for bit.  :func:`params_to_reference` and :func:`opt_state_to_reference`
go the other way (tensors stacked back into ``layers``), which is the tree
the training CLI checkpoints, so either package's CLI resumes the other's.
"""

from __future__ import annotations

import numpy as np
import torch


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


_EXPERT_SLABS = ("w_in", "w_gate", "w_out")


def params_from_reference(tree: dict, *, tp_rank: int = 0, tp_size: int = 1,
                          stage: int | None = None) -> dict[str, torch.Tensor]:
    """A state dict for :class:`repro_torch.models.lm.LM` (``load_state_dict``)
    from the reference's parameter tree.

    One rank's shard of it, for the sharded paths: ``tp_size > 1`` keeps tp
    rank ``tp_rank``'s expert slabs (the 3-D ``w_in``, ``w_gate`` and
    ``w_out`` of an MoE, ``padded_experts / tp_size`` of them, the
    reference's ``P(tp, ...)`` shard; an MLP's weights are 2-D and stay
    whole); ``stage`` keeps pipeline stage ``stage``'s slice ``[stage :
    stage + 1]`` of every leaf of a stacked stage tree (the ``P(axis)``
    shard ``distributed.pp.gpipe`` takes)."""
    state: dict[str, torch.Tensor] = {}
    for key, sub in tree.items():
        if key == "layers":
            flat: dict[str, torch.Tensor] = {}
            _flatten(sub, "", flat)
            n = {v.shape[0] for v in flat.values()}
            if len(n) != 1:
                raise ValueError(f"stacked layer leaves disagree on depth: {sorted(n)}")
            for i in range(n.pop()):
                for name, v in flat.items():
                    state[f"layers.{i}.{name}"] = v[i].clone()
        else:
            _flatten(sub, f"{key}.", state)
    if stage is None and tp_size == 1:
        return state
    return {name: _shard(name, v, tp_rank, tp_size, stage) for name, v in state.items()}


def _shard(name: str, v: torch.Tensor, tp_rank: int, tp_size: int, stage: int | None) -> torch.Tensor:
    if stage is not None:
        v = v[stage : stage + 1]
    if tp_size > 1 and name.rsplit(".", 1)[-1] in _EXPERT_SLABS and v.dim() == 3:
        if v.shape[0] % tp_size:
            raise ValueError(f"{name}: {v.shape[0]} expert slabs not divisible by tp={tp_size}")
        e = v.shape[0] // tp_size
        v = v[tp_rank * e : (tp_rank + 1) * e]
    return v.clone()


def opt_state_from_reference(state: dict) -> dict:
    """The port's AdamW state (:func:`repro_torch.train.optimizer.init_opt_state`
    layout: ``m`` and ``v`` keyed by state-dict name, ``step`` an int32
    scalar) from the reference's ``{"m", "v", "step"}`` tree."""
    return {"m": params_from_reference(state["m"]), "v": params_from_reference(state["v"]),
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


def params_to_reference(state: dict[str, torch.Tensor]) -> dict:
    """The reference's parameter tree from a state dict of
    :class:`repro_torch.models.lm.LM`: ``layers.<i>.<name>`` stacked into
    ``layers.<name>`` of depth L.  The stacked leaves are new tensors; the
    others are the state dict's own, detached."""
    per_layer: dict[str, dict[int, torch.Tensor]] = {}
    rest: dict[str, torch.Tensor] = {}
    for name, v in state.items():
        head, _, tail = name.partition(".")
        if head == "layers":
            i, _, leaf = tail.partition(".")
            per_layer.setdefault(leaf, {})[int(i)] = v.detach()
        else:
            rest[name] = v.detach()
    tree = _nest(rest)
    if per_layer:
        stacked = {leaf: torch.stack([by_i[i] for i in range(len(by_i))]) for leaf, by_i in per_layer.items()}
        tree["layers"] = _nest(stacked)
    return tree


def opt_state_to_reference(state: dict) -> dict:
    """The reference's ``{"m", "v", "step"}`` AdamW tree from the port's."""
    return {"m": params_to_reference(state["m"]), "v": params_to_reference(state["v"]),
            "step": state["step"].detach().clone()}
