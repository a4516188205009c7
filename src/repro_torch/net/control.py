"""Control plane: the range tables every hop of a fabric shares.

Counterpart of :mod:`repro.net.control` for the ``"static"`` (paper Alg. 2,
equal width) and ``"oracle"`` (full-data quantile splitters) range modes
and the one-shot :class:`ControlPlane`.  The adaptive ``"sampled"`` plane
(``ReservoirSampler``, ``AdaptiveControlPlane``) is a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.partition import quantile_ranges, set_ranges

#: The range modes of the reference (``"sampled"`` is not ported yet).
RANGE_MODES = ("oracle", "sampled", "static")


def ranges_valid(ranges: torch.Tensor, num_segments: int, max_value: int) -> bool:
    """Whether a range table is safe to program into the fabric: rows of
    ``[lo, hi)`` that start at 0, are non-empty and contiguous, and cover
    the key domain."""
    r = torch.as_tensor(ranges)
    if tuple(r.shape) != (num_segments, 2):
        return False
    lo, hi = r[:, 0], r[:, 1]
    if int(lo[0]) != 0 or int(hi[-1]) < int(max_value) + 1:
        return False
    if not bool(torch.all(hi > lo)):
        return False
    return bool(torch.all(lo[1:] == hi[:-1]))


@dataclasses.dataclass(frozen=True)
class ControlPlane:
    """One-shot control plane: ``mode="width"`` is Alg. 2, ``"quantile"``
    the balanced splitters from a bounded sample (drawn with numpy's
    ``default_rng``, as in the reference, so the sample is the same)."""

    mode: str = "width"
    sample_size: int = 4096
    seed: int = 0

    def ranges(
        self, values: torch.Tensor, num_segments: int, max_value: int
    ) -> torch.Tensor:
        if self.mode == "width":
            return set_ranges(max_value, num_segments, device=values.device)
        if self.mode == "quantile":
            if values.numel() > self.sample_size:
                rng = np.random.default_rng(self.seed)
                pick = rng.choice(values.numel(), size=self.sample_size, replace=False)
                values = values[torch.from_numpy(pick).to(values.device)]
            return quantile_ranges(values, num_segments, max_value)
        raise ValueError(f"unknown control-plane mode {self.mode!r}")
