"""Public wrappers around the sort kernels, with the reference's guards.

Counterpart of :mod:`repro.kernels.ops` for the two kernels of the sort
dataplane.  The device of the tensor decides what runs: a CUDA tensor
launches the Hopper kernel (:mod:`repro_torch.kernels.bitonic`), a CPU
tensor takes its plain torch version.  There is no ``interpret=`` and no
x64 scope: torch keeps int64 keys as they are.
"""

from __future__ import annotations

import torch

from . import bitonic


def _check_sort_keys(x: torch.Tensor, op: str) -> None:
    """Key-dtype guard: the networks compare integer keys and pad with the
    dtype max, which float (NaN order) and bool keys do not have."""
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(
            f"{op} sorts integer keys only, got dtype {x.dtype}; the bitonic "
            "network needs an integer pad sentinel"
        )


def sort_rows_padded(x: torch.Tensor) -> torch.Tensor:
    """Row sort for any row count: the fused hop's one kernel call per hop.

    The column count must be a power of two (the bitonic contract; ragged
    columns are the caller's padding; the kernel wrapper raises otherwise).
    Unlike the TPU grid, the kernel takes any number of rows, so no row
    padding is added.
    """
    _check_sort_keys(x, "sort_rows_padded")
    return bitonic.sort_rows(x)


def merge_tournament(x: torch.Tensor) -> torch.Tensor:
    """Merge ``P`` padded sorted rows (P, B) into one sorted (P*B,) stream --
    the run arena's one kernel call per length bucket.  P and B powers of
    two; no size cap (the TPU's VMEM cap does not apply)."""
    _check_sort_keys(x, "merge_tournament")
    return bitonic.merge_tournament(x)
