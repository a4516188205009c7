"""One rank's costs of a call: flops, bytes moved, collectives and memory.

The dry run (:mod:`repro_torch.launch.dryrun`) traces a step on the meta
device, where nothing is allocated or computed, and reads its costs from
:func:`count`, the one context manager of this module.  The counting rules
are those of the reference's HLO counters (``benchmarks/hlo_analysis.py``,
``benchmarks/roofline.py``), applied to the eager torch ops the port runs:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s (2 M N K a
  matmul, the convolutions, SDPA), plus each hand-written kernel's own count
  (:func:`kernel`);
* **bytes**: the operands plus the results of every op that allocates a
  result or writes one in place, a result written over an operand counted
  once (an op whose results only alias its inputs -- a view, a reshape --
  moves none, as the reference's ``reshape`` and ``bitcast``; nor does a
  factory that writes nothing, ``empty``, or a collective); plus each
  kernel's own bytes (its inputs read once, its outputs written once);
* **collectives**: a count and bytes per kind, an all-reduce 2x its
  operand's bytes, a reduce-scatter its operand's, an all-gather and an
  all-to-all their result's.  They are taken where the port calls
  ``torch.distributed`` (:func:`collective`), since a dispatch mode does not
  see every c10d call;
* **memory**: the storages an op allocates (a result whose storage is none of
  its inputs'), live from the op until the storage is freed; the peak of
  their sum over the call is ``temp_bytes``.  The caller names the call's
  arguments, part by part (:meth:`Counter.arguments`): each part's bytes are
  ``arguments``, their sum ``argument_bytes``, and those an op writes in
  place ``alias_bytes``.  :func:`part_bytes` counts live tensors the same
  way.

A hand-written kernel's wrapper carries :func:`kernel`: while a counter is
active the wrapper's own ops are not counted, and its closed-form work is, on
every device (on the meta device the wrapper returns empty outputs of the
kernel's shapes).  :func:`repeats` lets a counter count the first of ``n``
identical repetitions ``n`` times (the train step's microbatches).  With no
counter active each hook is one test of a module global.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

#: The collective kinds, in the reference's names.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

#: Ops that write no bytes: factories of uninitialised memory.
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}

_ACTIVE: "Counter | None" = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_ids(tensors) -> set[int]:
    return {id(t.untyped_storage()) for t in tensors}


class Counter:
    """What one :func:`count` saw; :meth:`result` gives it as a dict."""

    def __init__(self, fold_repeats: bool):
        self.fold_repeats = fold_repeats
        self.bytes = 0
        self.kernel_flops = 0.0
        self.folded_flops = 0.0
        self.per_collective = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.kernels = defaultdict(lambda: {"calls": 0, "flops": 0.0, "ops": 0.0, "bytes": 0.0})
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}   # id of a storage allocated in the call -> bytes
        self._args: dict[int, int] = {}       # id of an argument's storage -> bytes
        self._parts: dict[str, int] = {}      # an argument part's name -> bytes
        self._keep: list = []                 # the argument storages, alive while counting
        self._written: set[int] = set()
        self._flop_mode = None
        self.paused = False

    # -- arguments and storages ----------------------------------------------------
    def arguments(self, **parts) -> dict[str, int]:
        """Name the call's arguments, part by part (tensors anywhere in each
        keyword's tree); returns each part's bytes, every storage counted
        once, in the first part that holds it."""
        for name, tree in parts.items():
            n = 0
            for t in _tensors(tree):
                st = t.untyped_storage()
                if id(st) not in self._args:
                    self._args[id(st)] = st.nbytes()
                    self._keep.append(st)
                    n += st.nbytes()
            self._parts[name] = self._parts.get(name, 0) + n
        return dict(self._parts)

    @property
    def argument_bytes(self) -> int:
        return sum(self._parts.values())

    def _free(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= n

    def _allocated(self, outs, held: set) -> None:
        """Track the storages of ``outs`` not in ``held`` (the ids of the
        inputs' storages); an argument's among them is written in place."""
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held:
                if key in self._args:
                    self._written.add(key)
                continue
            if key in self._storages or key in self._args:
                continue
            n = st.nbytes()
            self._storages[key] = n
            weakref.finalize(st, self._free, key, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    # -- totals --------------------------------------------------------------------
    @property
    def flops(self) -> float:
        counted = self._flop_mode.get_total_flops() if self._flop_mode is not None else 0
        return float(counted) + self.kernel_flops + self.folded_flops

    def _snapshot(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": {k: dict(v) for k, v in self.per_collective.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}

    def _fold(self, before: dict, times: int) -> None:
        """Add ``times`` more of what was counted since ``before``."""
        self.folded_flops += times * (self.flops - before["flops"])
        self.bytes += times * (self.bytes - before["bytes"])
        for table, old in ((self.per_collective, before["coll"]), (self.kernels, before["kernels"])):
            for name, now in list(table.items()):
                was = old.get(name, {})
                for field in now:
                    now[field] += times * (now[field] - was.get(field, 0))

    def result(self, out=None) -> dict:
        """The counts, with the bytes of the call's result ``out``: the
        storages it allocated that ``out`` holds (``output_bytes``)."""
        out_bytes, seen = 0, set()
        for t in _tensors(out):
            st = t.untyped_storage()
            if id(st) not in seen and id(st) not in self._args:
                seen.add(id(st))
                out_bytes += st.nbytes()
        coll = {k: dict(self.per_collective[k]) if k in self.per_collective else {"count": 0, "bytes": 0}
                for k in COLLECTIVES}
        coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": coll["total_bytes"],
            "per_collective": {k: dict(v) for k, v in self.per_collective.items()},
            "collectives": coll,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "memory": {"argument_bytes": self.argument_bytes, "arguments": dict(self._parts),
                       "output_bytes": out_bytes,
                       "temp_bytes": self.peak,
                       "alias_bytes": sum(self._args[k] for k in self._written)},
        }


class _CostMode(TorchDispatchMode):
    """Counts each op's bytes and tracks the storages it allocates."""

    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counter
        outs = _tensors(out)
        if not outs:
            return out
        inputs = _tensors((args, kwargs))
        held = _storage_ids(inputs)
        moves = func._schema.is_mutable or any(id(t.untyped_storage()) not in held for t in outs)
        if moves and func.namespace not in ("c10d", "_c10d_functional") and func._opname not in _NO_BYTES:
            ins = {id(t) for t in inputs}
            c.bytes += sum(_nbytes(t) for t in inputs) + sum(_nbytes(t) for t in outs if id(t) not in ins)
        c._allocated(outs, held)
        return out


def part_bytes(**parts) -> dict[str, int]:
    """Each part's bytes as :meth:`Counter.arguments` counts them, for
    tensors that live on a device (what a measured run held)."""
    return Counter(fold_repeats=False).arguments(**parts)


@contextlib.contextmanager
def count(*, fold_repeats: bool = False):
    """Count the costs of what runs inside; yields the :class:`Counter`.
    With ``fold_repeats`` each :func:`repeats` block runs its first
    repetition only and counts it as many times as it asked for.  Not
    reentrant."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("costs.count is already active")
    from torch.utils.flop_counter import FlopCounterMode

    counter = Counter(fold_repeats)
    _ACTIVE = counter
    try:
        with FlopCounterMode(display=False) as flop_mode, _CostMode(counter):
            counter._flop_mode = flop_mode
            yield counter
    finally:
        _ACTIVE = None


def collective(kind: str, operand: torch.Tensor, result: torch.Tensor | None = None) -> None:
    """Count one collective of ``kind`` (:data:`COLLECTIVES`) at its call
    site: an all-reduce by its ``operand``, a reduce-scatter by its operand,
    an all-gather or all-to-all by its ``result``."""
    c = _ACTIVE
    if c is None:
        return
    if kind == "all-reduce":
        n = 2 * _nbytes(operand)
    elif kind == "reduce-scatter":
        n = _nbytes(operand)
    else:
        n = _nbytes(result if result is not None else operand)
    entry = c.per_collective[kind]
    entry["count"] += 1
    entry["bytes"] += n


def kernel(name: str, work):
    """Decorator of a hand-written kernel's wrapper ``name``: while a counter
    is active, ``work(*args, **kwargs)`` (the wrapper's arguments) gives the
    call's ``{"flops", "bytes"}`` (and ``"ops"``, integer operations, for a
    sort), which are counted, and the wrapper runs with no op of its own
    counted; its outputs' storages are tracked as allocated by the call.
    Without a counter the wrapper is called as it is."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            c = _ACTIVE
            if c is None or c.paused:
                return fn(*args, **kwargs)
            w = work(*args, **kwargs)
            c.paused = True
            try:
                with _disable_current_modes():
                    out = fn(*args, **kwargs)
            finally:
                c.paused = False
            entry = c.kernels[name]
            entry["calls"] += 1
            for key, value in w.items():
                entry[key] = entry.get(key, 0.0) + value
            c.kernel_flops += w.get("flops", 0.0)
            c.bytes += w["bytes"]
            c._allocated(_tensors(out), _storage_ids(_tensors((args, kwargs))))
            return out

        return call

    return wrap


@contextlib.contextmanager
def repeats(n: int):
    """``with repeats(n) as runs: for _ in range(runs): ...`` -- ``n``
    identical repetitions of a block (the same ops on the same shapes).
    ``runs`` is ``n``, or 1 where the active counter folds repeats: it then
    counts that one run's flops, bytes, collectives and kernels ``n`` times
    (the peak of live bytes is one run's, which each repeats)."""
    c = _ACTIVE
    if c is None or not c.fold_repeats or n <= 1:
        yield n
        return
    before = c._snapshot()
    yield 1
    c._fold(before, n - 1)
