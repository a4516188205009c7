"""Faithful PISA/RMT switch simulator running MergeMarathon, element at a time.

Counterpart of :mod:`repro.core.switchsim`: the paper's Algorithms 2 and 3
kept deliberately one value at a time, so that every case of
``SegmentInsertValue`` (empty / partially filled / full with an older and a
younger run) runs exactly as written.  It is host code by nature: Python
ints and numpy, with the port's own numpy routing (nothing of the reference
is imported).  The fused engine is held to it by the tests.

Deviations from the paper's pseudocode, as in the reference:

* Alg. 2 ``SetRanges`` as printed gives closed intervals whose endpoints
  overlap; the ranges here are half-open and cover ``[0, max_value]``.
* Alg. 3's shift loop, executed literally, smears one value; the intent
  (Figs. 9-10: every value after the swap index moves one stage forward) is
  a right shift of the block, which is what runs here.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

# Sentinel of an unpopulated pipeline stage.
EMPTY = -1


def _host_ranges(max_value: int, num_segments: int) -> np.ndarray:
    """Alg. 2 equal-width ``[lo, hi)`` rows over ``[0, max_value]``."""
    if num_segments <= 0:
        raise ValueError("num_segments must be positive")
    q, r = divmod(max_value + 1, num_segments)
    if q == 0:
        raise ValueError(f"more segments ({num_segments}) than domain values ({max_value + 1})")
    widths = np.full(num_segments, q, dtype=np.int64)
    widths[:r] += 1
    hi = np.cumsum(widths)
    return np.stack([hi - widths, hi], axis=1)


@dataclasses.dataclass
class Segment:
    """One pipeline segment: ``length`` match-action stages.

    ``stages[partition_index:]`` is the older run, ``stages[:partition_index]``
    the younger one; each stage holds one value.
    """

    range_lo: int  # inclusive
    range_hi: int  # exclusive
    length: int
    stages: np.ndarray = dataclasses.field(init=False)
    last: int = dataclasses.field(default=-1, init=False)
    partition_index: int = dataclasses.field(default=0, init=False)
    full: bool = dataclasses.field(default=False, init=False)

    def __post_init__(self) -> None:
        self.stages = np.full(self.length, EMPTY, dtype=np.int64)

    # -- Alg. 3, SegmentInsertValue ------------------------------------
    def insert(self, v: int) -> int | None:
        """Insert ``v``; return the evicted value if the segment was full."""
        if not self.full:
            self._insert_not_full(v)
            return None
        return self._insert_full(v)

    def _insert_not_full(self, v: int) -> None:
        # Cases 1 and 2: keep the stages ascending by bubbling v through.
        if self.last < 0:
            self.stages[0] = v
        elif v >= self.stages[self.last]:
            self.stages[self.last + 1] = v
        else:
            i = int(np.searchsorted(self.stages[: self.last + 1], v, "right"))
            self.stages[i + 1 : self.last + 2] = self.stages[i : self.last + 1]
            self.stages[i] = v
        self.last += 1
        if self.last == self.length - 1:
            self.full = True

    def _insert_full(self, v: int) -> int:
        # Case 3: evict the older run's head, insert v into the younger run.
        pi = self.partition_index
        evicted = int(self.stages[pi])
        if pi == 0:
            self.stages[0] = v
        else:
            x = self.stages[pi - 1]  # max of the younger run
            if v >= x:
                self.stages[pi] = v
            else:
                i = int(np.searchsorted(self.stages[:pi], v, "right"))
                self.stages[i + 1 : pi + 1] = self.stages[i:pi]
                self.stages[i] = v
        self.partition_index = (pi + 1) % self.length
        return evicted

    # -- Alg. 3, SwitchFlush (two recirculation passes) -----------------
    def flush(self) -> list[int]:
        out: list[int] = []
        if not self.full:
            out.extend(int(x) for x in self.stages[: self.last + 1])
        else:
            pi = self.partition_index
            out.extend(int(x) for x in self.stages[pi:])  # pass 1: older run
            out.extend(int(x) for x in self.stages[:pi])  # pass 2: younger run
        self.stages[:] = EMPTY
        self.last = -1
        self.partition_index = 0
        self.full = False
        return out


@dataclasses.dataclass
class Switch:
    """Alg. 2: the switch, ``number_of_segments`` parallel pipelines.

    ``ranges`` (a host array or a tensor, ``(S, 2)``) overrides the
    equal-width table, as a fabric's control plane dictates it."""

    number_of_segments: int
    segment_length: int
    max_value: int
    ranges: np.ndarray | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self) -> None:
        if self.ranges is None:
            self.ranges = _host_ranges(self.max_value, self.number_of_segments)
        else:
            if isinstance(self.ranges, torch.Tensor):
                self.ranges = self.ranges.detach().cpu().numpy()
            self.ranges = np.asarray(self.ranges, dtype=np.int64)
            if self.ranges.shape != (self.number_of_segments, 2):
                raise ValueError(
                    f"dictated ranges shape {self.ranges.shape} != "
                    f"({self.number_of_segments}, 2)"
                )
        self._bounds = self.ranges[:, 1].copy()
        self._lo = int(self.ranges[0, 0])
        self.segments = [
            Segment(int(lo), int(hi), self.segment_length) for lo, hi in self.ranges
        ]

    def _route(self, v: int) -> int:
        s = int(np.searchsorted(self._bounds, v, side="right"))
        if v < self._lo or s >= len(self.segments):
            raise ValueError("value outside the switch domain")
        return s

    def insert(self, v: int) -> tuple[int, int] | None:
        """SwitchInsert: route ``v``; return ``(segment_id, evicted)`` or
        ``None``."""
        s = self._route(v)
        evicted = self.segments[s].insert(v)
        if evicted is None:
            return None
        return (s, evicted)

    def flush(self) -> Iterator[tuple[int, int]]:
        for sid, seg in enumerate(self.segments):
            for v in seg.flush():
                yield (sid, v)

    # -- Alg. 3, ApplySwitch --------------------------------------------
    def apply(self, stream: Iterable[int]) -> tuple[np.ndarray, np.ndarray]:
        """Run the stream through the switch; ``(values, segment_ids)`` in
        emission order, as host int64 arrays."""
        if isinstance(stream, torch.Tensor):
            stream = stream.detach().cpu().numpy()
        vals: list[int] = []
        sids: list[int] = []
        for v in stream:
            out = self.insert(int(v))
            if out is not None:
                sids.append(out[0])
                vals.append(out[1])
        for sid, v in self.flush():
            sids.append(sid)
            vals.append(v)
        return np.asarray(vals, dtype=np.int64), np.asarray(sids, dtype=np.int64)
