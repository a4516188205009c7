"""The yardstick: one H100's peaks and the least work of K1 and K2.

Frozen from the bound rules of ``PERF.md``'s kernel table (the ``kernels``
line of ``chip_smoke.py``): a kernel's least time is the larger of its
bytes at the HBM rate and its integer operations at the card's integer
rate.  The work is counted from a job's own sizes -- the keys through each
sorting hop, the block length, the narrowest cell that holds a record, the
runs the servers merge -- never from launches or padded shapes, so a share
reads the same work whatever kernel implements it.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3; 132 SMs x 64
integer lanes x 1.98 GHz for 32-bit integer operations.  A compare-exchange
costs 2 operations on 32-bit cells (min and max) and 6 on 64-bit cells (a
64-bit compare is two 32-bit compares, and min and max each select two
32-bit halves); a merge step (one comparison and one select per output key)
costs 2 on 32-bit cells and 4 on 64-bit cells.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_COMPARE_EXCHANGE = {4: 2, 8: 6}
OPS_PER_MERGE_STEP = {4: 2, 8: 4}


def log2(n: int) -> int:
    return int(n).bit_length() - 1


def bits(n: int) -> int:
    """Bits of the largest value below ``n`` (at least 1)."""
    return max(1, (int(n) - 1).bit_length())


def cell_bytes(key_bits: int) -> int:
    """The narrowest cell, 4 or 8 bytes, that holds a non-negative record
    of ``key_bits`` bits below the sign bit."""
    return 4 if key_bits <= 31 else 8


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def block_sort_seconds(keys: float, block: int, cell: int) -> float:
    """Least time to sort ``keys`` keys in rows of ``block`` (a power of
    two): every key read and written once; a bitonic network's
    ``s (s + 1) / 2`` stages of ``block / 2`` compare-exchanges a row,
    ``s = log2(block)`` (the count of PERF.md's K1 row)."""
    s = log2(block)
    ce = keys / 2 * s * (s + 1) / 2
    return least_seconds(2.0 * keys * cell, ce * OPS_PER_COMPARE_EXCHANGE[cell])


def merge_seconds(keys: float, runs_per_merge: float, cell: int) -> float:
    """Least time to merge ``keys`` keys held in sorted runs, ``runs_per_merge``
    to each merge: every key read and written once, ``log2`` of the runs
    merge steps a key (PERF.md's K2 rule)."""
    depth = math.log2(runs_per_merge) if runs_per_merge > 1 else 0.0
    return least_seconds(2.0 * keys * cell, keys * depth * OPS_PER_MERGE_STEP[cell])


def fabric_levels(pipeline: dict) -> int:
    """Sorting hops a key passes through on its way to the servers: one a
    level of the fabric (every level of a tree sorts each key once)."""
    topo = pipeline.get("topology", "single")
    if topo == "single":
        return 1
    if topo == "tree":
        return int(pipeline.get("height", 2))
    if topo == "leaf_spine":
        return 2
    raise ValueError(f"no level count for topology {topo!r}")
