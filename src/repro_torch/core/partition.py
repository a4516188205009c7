"""Range partitioning (Alg. 2 ``SetRanges``) and balanced ranges, on tensors.

Counterpart of :mod:`repro.core.partition`.  Range tables are small
``(num_segments, 2)`` int64 tensors on the device of the keys they route;
the splitter arithmetic of :func:`quantile_ranges` runs on the host in
numpy, over the handful of order statistics it needs, so that it reproduces
``np.quantile``'s ``linear`` method bit for bit (``torch.quantile`` refuses
inputs above 2^24 elements and interpolates differently).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def set_ranges(max_value: int, num_segments: int, device="cuda") -> torch.Tensor:
    """Paper Alg. 2: equal-width half-open ranges covering [0, max_value].

    ``(num_segments, 2)`` int64 ``[lo, hi)`` rows; the first ``r`` segments
    have width ``q+1``, the rest ``q`` (``q, r = divmod(max_value + 1, S)``).
    """
    if num_segments <= 0:
        raise ValueError("num_segments must be positive")
    domain = max_value + 1
    q, r = divmod(domain, num_segments)
    if q == 0:
        raise ValueError(
            f"more segments ({num_segments}) than domain values ({domain})"
        )
    widths = np.full(num_segments, q, dtype=np.int64)
    widths[:r] += 1
    hi = np.cumsum(widths)
    lo = hi - widths
    return torch.from_numpy(np.stack([lo, hi], axis=1)).to(resolve_device(device))


def segment_of(values: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Which segment owns each value: ``searchsorted`` over the exclusive
    upper bounds, ``right=True`` as the reference's ``side="right"``."""
    bounds = ranges[:, 1].contiguous()
    seg = torch.searchsorted(bounds, values, right=True)
    if values.numel():
        lo_ok = int(values.min()) >= int(ranges[0, 0])
        if not lo_ok or int(seg.max()) >= ranges.shape[0]:
            raise ValueError("value outside the switch domain")
    return seg


def load_imbalance(values: torch.Tensor, ranges: torch.Tensor) -> float:
    """Peak-over-mean segment load of routing ``values`` through ``ranges``."""
    if values.numel() == 0:
        return 1.0
    counts = torch.bincount(segment_of(values, ranges), minlength=ranges.shape[0])
    return float(int(counts.max()) / (values.numel() / ranges.shape[0]))


def sorted_quantiles(sorted_values: torch.Tensor, qs: np.ndarray) -> np.ndarray:
    """``np.quantile(values, qs)`` (method ``linear``) from a sorted tensor.

    Only the two order statistics around each virtual index leave the
    device; the interpolation repeats numpy's own steps in float64 (integer
    difference first, then the weight, and the ``t >= 0.5`` form from the
    upper neighbour), so the result is numpy's to the bit.
    """
    n = int(sorted_values.numel())
    if n == 0:
        raise ValueError("cannot take quantiles of an empty sample")
    virtual = np.asanyarray((n - 1) * np.asarray(qs, dtype=np.float64))
    prev = np.floor(virtual)
    nxt = prev + 1
    above = virtual >= n - 1
    prev[above] = -1
    nxt[above] = -1
    below = virtual < 0
    prev[below] = 0
    nxt[below] = 0
    prev_i = prev.astype(np.intp)
    next_i = nxt.astype(np.intp)
    idx = torch.from_numpy(np.concatenate([prev_i, next_i]) % n)
    picked = sorted_values[idx.to(sorted_values.device)].cpu().numpy()
    a, b = picked[: prev_i.size], picked[prev_i.size :]
    t = np.asanyarray(virtual - prev_i, dtype=virtual.dtype)
    diff = np.subtract(b, a)
    out = np.asanyarray(np.add(a, diff * t))
    np.subtract(b, diff * (1 - t), out=out, where=t >= 0.5, casting="unsafe",
                dtype=type(out.dtype))
    return out


def quantile_ranges(
    sample: torch.Tensor, num_segments: int, max_value: int
) -> torch.Tensor:
    """Balanced (equal-load) ranges from a sample -- beyond-paper.

    Splitters are the sample quantiles; duplicates are widened to the next
    representable key so the ranges stay strictly increasing and cover
    [0, max_value].  Returned on the sample's device.
    """
    if num_segments <= 0:
        raise ValueError("num_segments must be positive")
    if num_segments > max_value + 1:
        raise ValueError(
            f"more segments ({num_segments}) than domain values ({max_value + 1})"
        )
    need = num_segments - 1
    qs = sorted_quantiles(
        torch.sort(sample.reshape(-1)).values,
        np.linspace(0, 1, num_segments + 1)[1:-1],
    )
    splits = np.unique(np.floor(qs).astype(np.int64))
    splits = splits[(splits > 0) & (splits <= max_value)][:need]
    missing = need - len(splits)
    if missing > 0:
        pool = np.setdiff1d(
            np.unique(np.linspace(1, max_value, min(max_value, 4 * need)).astype(np.int64)),
            splits,
        )
        if pool.size < missing:
            pool = np.setdiff1d(np.arange(1, max_value + 1, dtype=np.int64), splits)
        take = (np.arange(missing) * pool.size) // missing
        splits = np.sort(np.concatenate([splits, pool[take]]))
    lo = np.concatenate([[0], splits])
    hi = np.concatenate([splits, [max_value + 1]])
    out = np.stack([lo, hi], axis=1).astype(np.int64)
    if out.shape != (num_segments, 2):
        raise AssertionError(f"quantile_ranges produced shape {out.shape}")
    return torch.from_numpy(out).to(sample.device)
