"""Fault-tolerant checkpointing: atomic, device-agnostic, keep-last-k, async.

Counterpart of :mod:`repro.train.checkpoint`, with the same on-disk layout,
so each package's manager reads the other's files: ``<dir>/step_<10 digits>/``
holds ``state.npz`` (the flattened tree: dict keys joined by ``/``, list
items as ``#<i>``; bfloat16 leaves stored as a ``uint16`` bit view) and
``manifest.json`` (the step, a ``dtypes`` sidecar naming each bit-viewed
leaf's type, and the caller's extras).  Leaves are host copies, so a
checkpoint written on the card restores on the CPU.  A tree comes back as it
was saved: the reference's training state is its stacked parameter tree, so
the port's training CLI saves and resumes that tree
(:func:`repro_torch.models.convert.params_to_reference`), and each CLI
resumes from the other's directory.

Crash safety: writes go to ``<dir>/tmp.<step>.<uuid>`` and are renamed into
place (atomic on POSIX); partial checkpoints are never visible and are
removed when the next manager opens the directory.  :class:`AsyncCheckpointer`
moves the serialize-and-write off the training thread through a bounded
queue; the host copy is taken before ``save`` returns, because the train
step updates its tensors in place.
"""

from __future__ import annotations

import json
import os
import pathlib
import queue
import shutil
import threading
import uuid

import numpy as np
import torch

def _to_host_tree(tree, copy: bool):
    """The tree with every tensor detached on the CPU (a copy of a CPU tensor
    only with ``copy``: the async writer must not see later in-place
    updates) and every other leaf a numpy array."""
    if isinstance(tree, dict):
        return {k: _to_host_tree(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host_tree(v, copy) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy)
    return np.array(tree)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return [fix(v) for _, v in items]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _pack(flat: dict) -> tuple[dict, dict]:
    """numpy arrays for ``np.savez`` and the dtype sidecar."""
    packed, dtypes = {}, {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:  # numpy has no bfloat16
            dtypes[k] = "bfloat16"
            packed[k] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            packed[k] = v.numpy() if isinstance(v, torch.Tensor) else v
    return packed, dtypes


def _unpack(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(np.array(arr))
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    raise ValueError(f"checkpoint leaf of unknown stored type {dtype_name!r}")


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._gc_tmp()

    def _gc_tmp(self) -> None:
        for p in self.dir.glob("tmp.*"):
            shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, state: dict, extra: dict | None = None) -> None:
        """state: a tree of tensors or arrays, e.g. {"params":…, "opt":…, "data":…}."""
        tmp = self.dir / f"tmp.{step}.{uuid.uuid4().hex[:8]}"
        final = self.dir / f"step_{step:010d}"
        tmp.mkdir(parents=True, exist_ok=True)
        packed, dtypes = _pack(_flatten(_to_host_tree(state, copy=False)))
        np.savez(tmp / "state.npz", **packed)
        manifest = {"step": int(step), "dtypes": dtypes, **(extra or {})}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> tuple[dict, dict]:
        """Returns (state, manifest): a tree of CPU tensors.  Raises
        FileNotFoundError if there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        dtypes = manifest.get("dtypes", {})
        with np.load(path / "state.npz") as z:
            flat = {k: _unpack(z[k], dtypes.get(k)) for k in z.files}
        return _unflatten(flat), manifest


class AsyncCheckpointer:
    """Background writer with a bounded queue (writes inline if saturated)."""

    def __init__(self, mgr: CheckpointManager):
        self.mgr = mgr
        self.q: queue.Queue = queue.Queue(maxsize=1)
        self.err: Exception | None = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            try:
                self.mgr.save(*item)
            except Exception as e:  # surfaced on the next save or close
                self.err = e

    def save(self, step: int, state: dict, extra: dict | None = None) -> None:
        if self.err:
            raise self.err
        host = _to_host_tree(state, copy=True)
        try:
            self.q.put_nowait((step, host, extra))
        except queue.Full:
            self.mgr.save(step, host, extra)  # backpressure: write inline

    def close(self) -> None:
        self.q.put(None)
        self._t.join()
        if self.err:
            raise self.err
