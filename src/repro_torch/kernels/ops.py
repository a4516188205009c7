"""Public wrappers around the kernels, with the reference's guards.

Counterpart of :mod:`repro.kernels.ops` for the four bitonic kernels: the
sort dataplane's row sort and tournament (K1, K2), the MoE dispatch's
key-value sort (K3) and the row merge (K4), and for flash attention (K5).
The device of the tensor decides what runs: a CUDA tensor launches the
Hopper kernel (:mod:`repro_torch.kernels.bitonic`,
:mod:`repro_torch.kernels.flash_attention`), a CPU tensor takes its plain
torch version.  There is no ``interpret=`` and no x64 scope: torch keeps
int64 keys as they are; and no tile sizes (the reference's ``block_q``,
``block_k`` and row tiles are the TPU grid's).
"""

from __future__ import annotations

import torch

from . import bitonic
from . import flash_attention as _flash


def _check_sort_keys(x: torch.Tensor, op: str) -> None:
    """Key-dtype guard: the networks compare integer keys and pad with the
    dtype max, which float (NaN order) and bool keys do not have."""
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(
            f"{op} sorts integer keys only, got dtype {x.dtype}; the bitonic "
            "network needs an integer pad sentinel"
        )


def blockwise_sort(x: torch.Tensor, block: int) -> torch.Tensor:
    """MergeMarathon segment emission: sort consecutive ``block`` chunks of a
    1-D stream on K1.  ``block`` must be a power of two dividing ``x.numel()``
    (ragged tails are padded by the caller with the dtype max)."""
    (n,) = x.shape
    if block & (block - 1) or n % block:
        raise ValueError(f"n={n} block={block}: need pow2 block dividing n")
    return bitonic.sort_rows(x.reshape(n // block, block)).reshape(n)


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of (rows, B) on K1; B a power of two."""
    return bitonic.sort_rows(x)


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


def sort_rows_kv(keys: torch.Tensor, vals: torch.Tensor):
    """Row-wise key-value sort on K3 (the MoE dispatch: key = expert id,
    value = assignment index).  Not stable: equal keys come out in the
    network's order, the same on the CPU and the card."""
    _check_sort_keys(keys, "sort_rows_kv")
    return bitonic.sort_rows_kv(keys, vals)


def merge_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise merge of two sorted (rows, B) matrices into (rows, 2B) on K4."""
    return bitonic.merge_rows(a, b)


def argsort_padded(keys: torch.Tensor):
    """1-D argsort on K3: pad to the next power of two with the dtype max
    (the pads sort to the tail and are sliced off), values ``arange(m)`` as
    int32.  Returns the first ``n`` sorted keys and their positions."""
    _check_sort_keys(keys, "argsort_padded")
    (n,) = keys.shape
    m = 1 << (max(n, 2) - 1).bit_length()
    pad = torch.full((m - n,), torch.iinfo(keys.dtype).max, dtype=keys.dtype, device=keys.device)
    kp = torch.cat([keys, pad])[None, :]
    vp = torch.arange(m, dtype=torch.int32, device=keys.device)[None, :]
    ks, vs = sort_rows_kv(kp, vp)
    return ks[0, :n], vs[0, :n]


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Flash attention on K5: q (B, T, H, d) against k, v (B, S, KV, d)."""
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)
