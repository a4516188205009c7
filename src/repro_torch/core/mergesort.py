"""The computation server's merges: natural k-way merge sort and the run
arena's batched tournament, on tensors (paper Alg. 1, §4.3.2).

Counterpart of :mod:`repro.core.mergesort`.  :func:`merge_two` is a stable
two-way merge by ``searchsorted`` + scatter; :func:`merge_runs_flat` buckets
an arena's runs by power-of-two length, lays each bucket out as one padded
``(P, B)`` matrix and merges it with kernel K2
(:func:`repro_torch.kernels.ops.merge_tournament`).  Its branch rules are the
reference's, verbatim, and every branch taken is counted in
:data:`MERGE_BRANCHES`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.trace import NULL_TRACER
from .runs import run_starts

#: Below this many keys the ladder wins (the reference's threshold).
MIN_DEVICE_KEYS = 4096

#: Branches :func:`merge_runs_flat` took since :func:`reset_branches`.
MERGE_BRANCHES = {"empty": 0, "single": 0, "ladder": 0, "tournament": 0}


def reset_branches() -> None:
    for key in MERGE_BRANCHES:
        MERGE_BRANCHES[key] = 0


def merge_two(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge of two sorted tensors (Fig. 6's inner loop)."""
    n, m = a.numel(), b.numel()
    dtype = torch.promote_types(a.dtype, b.dtype)
    if n == 0 or m == 0:
        keep = b if n == 0 else a
        return keep.contiguous() if keep.dtype == dtype else keep.to(dtype)
    out = torch.empty(n + m, dtype=dtype, device=a.device)
    # Output position of each b element: elements of a <= it go first.
    ib = torch.searchsorted(a, b, right=True) + torch.arange(m, device=a.device)
    mask = torch.ones(n + m, dtype=torch.bool, device=a.device)
    mask[ib] = False
    out[ib] = b.to(dtype)
    out[mask] = a.to(dtype)
    return out


def merge_runs(runs: list[torch.Tensor]) -> torch.Tensor:
    """Merge sorted runs into one via a tournament of two-way merges."""
    while len(runs) > 1:
        nxt = [merge_two(runs[i], runs[i + 1]) for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _merge_set(arr: torch.Tensor, starts, ends) -> torch.Tensor:
    """Merge the runs ``arr[starts[i]:ends[i]]`` (each sorted) into one."""
    return merge_runs([arr[int(s) : int(e)] for s, e in zip(starts, ends)])


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _ragged_gather(starts: torch.Tensor, sizes: torch.Tensor, total: int) -> torch.Tensor:
    """Flat indices of the slices ``[starts[i], starts[i] + sizes[i])``."""
    if total == 0:
        return torch.zeros(0, dtype=torch.int64, device=starts.device)
    offs = torch.zeros_like(sizes)
    offs[1:] = torch.cumsum(sizes[:-1], 0)
    rel = torch.arange(total, dtype=torch.int64, device=starts.device) - torch.repeat_interleave(
        offs, sizes, output_size=total
    )
    return torch.repeat_interleave(starts, sizes, output_size=total) + rel


def _device_dtype(lo: int, hi: int) -> torch.dtype | None:
    """Narrowest kernel dtype whose max can serve as the pad sentinel, by
    the reference's rule (``mergesort.py::_device_dtype``).

    The reference's uint16 range (``0 <= lo``, ``hi < 65535``) falls in
    the int32 branch: the kernels take int32/int64, and a key below 65535
    can never equal the int32 max sentinel.  The rule decides the branch
    (device or ladder), never the output.
    """
    i32 = np.iinfo(np.int32)
    i64 = np.iinfo(np.int64)
    if i32.min < lo and hi < i32.max:
        return torch.int32
    if i64.min < lo and hi < i64.max:
        return torch.int64
    return None


def merge_runs_flat(
    buf: torch.Tensor,
    starts: torch.Tensor,
    lengths: torch.Tensor,
    *,
    min_device_keys: int = MIN_DEVICE_KEYS,
    tracer=None,
    tid: int = 0,
) -> torch.Tensor:
    """Merge the sorted runs ``buf[starts[i]:starts[i]+lengths[i]]`` into one
    sorted int64 tensor on ``buf``'s device.

    Runs are bucketed by power-of-two length; each bucket is one padded
    ``(P, B)`` matrix (two ragged gathers) merged by kernel K2, and the
    bucket winners merge with :func:`merge_runs`.  Totals below
    ``min_device_keys`` or key ranges without a pad sentinel take the
    ladder, as in the reference.  The run table (one entry per run) is read
    on the host once.
    """
    tr = tracer or NULL_TRACER
    dev = buf.device
    starts_h = starts.detach().cpu().numpy().astype(np.int64)
    lengths_h = lengths.detach().cpu().numpy().astype(np.int64)
    keep = lengths_h > 0
    if not keep.all():
        starts_h, lengths_h = starts_h[keep], lengths_h[keep]
    R = int(starts_h.size)
    if R == 0:
        MERGE_BRANCHES["empty"] += 1
        return torch.zeros(0, dtype=torch.int64, device=dev)
    if R == 1:
        MERGE_BRANCHES["single"] += 1
        s = int(starts_h[0])
        return buf[s : s + int(lengths_h[0])].to(torch.int64)
    total = int(lengths_h.sum())
    ends = torch.from_numpy(np.concatenate([starts_h, starts_h + lengths_h - 1])).to(dev)
    picked = buf[ends].cpu().numpy()
    lo = int(picked[:R].min())
    hi = int(picked[R:].max())
    dtype = _device_dtype(lo, hi)
    if total < min_device_keys or dtype is None:
        MERGE_BRANCHES["ladder"] += 1
        return merge_runs(
            [buf[int(s) : int(s) + int(n)] for s, n in zip(starts_h, lengths_h)]
        ).to(torch.int64)
    from ..kernels import ops

    MERGE_BRANCHES["tournament"] += 1
    pad = torch.iinfo(dtype).max
    buckets = (2 ** np.ceil(np.log2(lengths_h))).astype(np.int64)
    winners: list[torch.Tensor] = []
    for B in np.unique(buckets):
        B = int(B)
        sel = buckets == B
        P = int(sel.sum())
        if P == 1:
            i = int(np.nonzero(sel)[0][0])
            winners.append(buf[int(starts_h[i]) : int(starts_h[i] + lengths_h[i])])
            continue
        with tr.span(f"tournament:b{B}", cat="server", tid=tid, runs=P):
            rows = max(2, _next_pow2(P))
            sl = torch.from_numpy(lengths_h[sel]).to(dev)
            n_sel = int(lengths_h[sel].sum())
            mat = torch.full((rows, B), pad, dtype=dtype, device=dev)
            dst = _ragged_gather(torch.arange(P, device=dev) * B, sl, n_sel)
            src = _ragged_gather(torch.from_numpy(starts_h[sel]).to(dev), sl, n_sel)
            mat.view(-1)[dst] = buf[src].to(dtype)
            merged = ops.merge_tournament(mat)
            winners.append(merged[:n_sel])
    if len(winners) == 1:
        return winners[0].to(torch.int64)
    with tr.span("winners", cat="server", tid=tid, runs=len(winners)):
        return merge_runs([w.to(torch.int64) for w in winners])


def merge_runs_batched(
    runs: list[torch.Tensor],
    *,
    min_device_keys: int = MIN_DEVICE_KEYS,
    tracer=None,
    tid: int = 0,
) -> torch.Tensor:
    """:func:`merge_runs` for a list of sorted tensors, through the arena
    layout and :func:`merge_runs_flat`."""
    nonempty = [r for r in runs if r.numel()]
    if not nonempty:
        dev = runs[0].device if runs else None
        return torch.zeros(0, dtype=torch.int64, device=dev)
    runs = nonempty
    if len(runs) == 1:
        return runs[0].to(torch.int64)
    lengths = torch.tensor([r.numel() for r in runs], dtype=torch.int64)
    starts = torch.cumsum(lengths, 0) - lengths
    return merge_runs_flat(
        torch.cat(runs), starts, lengths,
        min_device_keys=min_device_keys, tracer=tracer, tid=tid,
    )


def merge_sort(a: torch.Tensor, k: int = 10) -> tuple[torch.Tensor, int]:
    """Natural k-way merge sort.  Returns (sorted tensor, number of passes)."""
    a = a.contiguous()
    if a.numel() <= 1:
        return a.clone(), 0
    starts = run_starts(a).cpu().numpy()
    passes = 0
    cur = a
    while starts.size > 1:
        ends = np.concatenate([starts[1:], [cur.numel()]])
        parts = []
        new_starts = [0]
        for g in range(0, starts.size, k):
            merged = _merge_set(cur, starts[g : g + k], ends[g : g + k])
            parts.append(merged)
            new_starts.append(new_starts[-1] + merged.numel())
        cur = torch.cat(parts)
        starts = np.asarray(new_starts[:-1], dtype=np.int64)
        passes += 1
    return cur, passes


def merge_sort_reference(a, k: int = 10) -> torch.Tensor:
    """Pure-Python Alg. 1 with an explicit k-ary minimum selection (Fig. 6):
    the slow, obviously correct twin of :func:`merge_sort`, on host ints."""
    vals = torch.as_tensor(a).tolist()
    runs: list[list[int]] = []
    cur: list[int] = []
    prev = None
    for v in vals:
        if prev is not None and v < prev:
            runs.append(cur)
            cur = []
        cur.append(int(v))
        prev = v
    if cur:
        runs.append(cur)
    while len(runs) > 1:
        nxt = []
        for g in range(0, len(runs), k):
            group = runs[g : g + k]
            merged: list[int] = []
            idx = [0] * len(group)
            while True:
                # "the minimum among the first element of each Run"
                best, bv = -1, None
                for j, r in enumerate(group):
                    if idx[j] < len(r) and (bv is None or r[idx[j]] < bv):
                        best, bv = j, r[idx[j]]
                if best < 0:
                    break
                merged.append(bv)
                idx[best] += 1
            nxt.append(merged)
        runs = nxt
    return torch.tensor(runs[0] if runs else [], dtype=torch.int64)


def server_sort(
    streams: list[torch.Tensor], k: int = 10
) -> tuple[torch.Tensor, list[int]]:
    """§4.3.2: sort each segment separately, concatenate by segment id."""
    if not streams:
        return torch.zeros(0, dtype=torch.int64), []
    outs, passes = [], []
    for sub in streams:
        s, p = merge_sort(sub, k=k)
        outs.append(s)
        passes.append(p)
    return torch.cat(outs), passes
