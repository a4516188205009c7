"""Length-bucketed sequence packing via replacement selection — the paper's
run-lengthening applied to batch construction.

The port's own copy of :mod:`repro.data.packing` (host code, numpy and
``heapq``; the same order and waste, byte for byte).

Variable-length examples stream through a bounded buffer of size ``y`` (the
"segment length"); emitting the minimum-length-≥-last gives long
nearly-sorted runs of lengths, so consecutive batches have near-uniform
lengths and padding waste drops.  This is classical replacement selection —
the same algorithm the switch pipeline implements in hardware — applied at
the data layer, with the buffer playing the role of the pipeline stages.
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator, Sequence

import numpy as np


def replacement_selection_order(
    lengths: Sequence[int], buffer: int
) -> list[int]:
    """Emit indices of ``lengths`` in replacement-selection order: ascending
    runs of expected length ~2*buffer (vs ~2 for random order)."""
    it = iter(range(len(lengths)))
    heap: list[tuple[int, int]] = []
    frozen: list[tuple[int, int]] = []
    for i in it:
        heap.append((lengths[i], i))
        if len(heap) >= buffer:
            break
    heapq.heapify(heap)
    out: list[int] = []
    last = None
    for i in it:
        if heap:
            l, j = heapq.heappop(heap)
        else:
            heap, frozen = frozen, []
            heapq.heapify(heap)
            last = None
            l, j = heapq.heappop(heap)
        out.append(j)
        last = l
        if lengths[i] >= (last or 0):
            heapq.heappush(heap, (lengths[i], i))
        else:
            frozen.append((lengths[i], i))
    while heap or frozen:
        if not heap:
            heap, frozen = frozen, []
            heapq.heapify(heap)
        l, j = heapq.heappop(heap)
        out.append(j)
    return out


def padding_waste(lengths: Sequence[int], batch: int) -> float:
    """Fraction of padded tokens when batching consecutive groups of
    ``batch`` sequences to the group max."""
    lengths = np.asarray(lengths)
    total, padded = 0, 0
    for g in range(0, len(lengths), batch):
        grp = lengths[g : g + batch]
        total += int(grp.max()) * len(grp)
        padded += int((grp.max() - grp).sum())
    return padded / max(total, 1)
