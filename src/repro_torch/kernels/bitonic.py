"""Bitonic networks on torch tensors, and the two Hopper kernels that run them.

Counterpart of :mod:`repro.kernels.bitonic`.  Its four kernels are ported
here as CUDA C++ for ``sm_90a`` (sources under ``csrc/``):

* **K1** :func:`sort_rows` -- ascending sort of every row of a ``(rows, B)``
  int32/int64 matrix (``csrc/row_sort.cu``; replaces ``sort_tiles``): rows
  in registers, a thread holding ``ITEMS`` consecutive keys loaded as
  16-byte vectors, each stage in the tier of :func:`row_sort_tiers`;
* **K2** :func:`merge_tournament` -- merge of ``P`` padded sorted rows into one
  sorted ``P*B`` row by merge-path rounds (``csrc/tournament.cu``; replaces
  ``tournament_tiles``);
* **K3** :func:`sort_rows_kv` -- key-value sort of every row, int32 values
  following int32/int64 keys, not stable (``csrc/row_sort_kv.cu``; replaces
  ``sort_tiles_kv``): the MoE dispatch's argsort, in the launches of
  :func:`row_sort_kv_plan`;
* **K4** :func:`merge_rows` -- row-wise merge of two sorted ``(rows, B)``
  matrices into ``(rows, 2B)`` (``csrc/merge_rows.cu``; replaces
  ``merge_tiles``).

Each has a plain torch version in this module (:func:`sort_rows_plain`,
:func:`tournament_plain`, :func:`sort_rows_kv_plain`,
:func:`merge_rows_plain`) that runs the same network stage by stage, or for
K2 the same merge round by round (:func:`co_rank` is its search).  The
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  On the meta device (the dry run,
which meets K3 alone on the MoE path) :func:`sort_rows_kv` returns empty
outputs, its work :func:`sort_rows_kv_work`.  Every launch adds one to
:data:`LAUNCHES` (the record of :mod:`.build`, shared by every kernel of the
port), so a run can show that it went through the kernels.

The kernels are compiled with ``nvcc`` at first use into ``build/kernels/``
by :mod:`.build` (a plain C interface, loaded with ``ctypes``); nothing is
built or imported from ``triton``/CUDA when this module loads.
"""

from __future__ import annotations

import torch

from ..obs import costs
from . import build
from .build import LAUNCHES, reset_launches  # noqa: F401  (the one record of every kernel)

#: Widest row K1 sorts, consecutive keys a K1 thread holds, and the threads
#: of a K1 block (``csrc/row_sort.cu``: ``MAX_ROW``, ``ITEMS``, ``THREADS``).
MAX_ROW, ROW_SORT_ITEMS, ROW_SORT_THREADS = build.source_constants(
    "row_sort.cu", "MAX_ROW", "ITEMS", "THREADS")


# ---------------------------------------------------------------------------
# The network (plain torch)
# ---------------------------------------------------------------------------


def _stages(n: int):
    """The bitonic network schedule: (k, j) compare-exchange stages."""
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def _is_pow2(n: int) -> bool:
    return n >= 1 and not n & (n - 1)


def compare_exchange(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """One network stage over the last axis (length a power of two).

    Elements ``i`` and ``i ^ j`` are compared; the pair ascends iff
    ``(i & k) == 0`` -- :func:`repro.kernels.bitonic.compare_exchange`.
    """
    *lead, n = x.shape
    nb = n // (2 * j)
    a = x.reshape(*lead, nb, 2, j)
    asc = ((torch.arange(nb, device=x.device) * 2 * j) & k == 0)[:, None]
    lo, hi = a[..., 0, :], a[..., 1, :]
    mn = torch.minimum(lo, hi)
    mx = torch.maximum(lo, hi)
    out = torch.stack(
        [torch.where(asc, mn, mx), torch.where(asc, mx, mn)], dim=-2
    )
    return out.reshape(*lead, n)


def compare_exchange_kv(keys: torch.Tensor, vals: torch.Tensor, k: int, j: int):
    """Key-value stage: values follow their key's swap decision, which is
    ``asc ? k0 > k1 : k0 < k1`` (strict) -- :func:`repro.kernels.bitonic.
    compare_exchange_kv`."""
    *lead, n = keys.shape
    nb = n // (2 * j)
    ka = keys.reshape(*lead, nb, 2, j)
    va = vals.reshape(*lead, nb, 2, j)
    asc = ((torch.arange(nb, device=keys.device) * 2 * j) & k == 0)[:, None]
    k0, k1 = ka[..., 0, :], ka[..., 1, :]
    v0, v1 = va[..., 0, :], va[..., 1, :]
    swap = torch.where(asc, k0 > k1, k0 < k1)
    ko = torch.stack([torch.where(swap, k1, k0), torch.where(swap, k0, k1)], dim=-2)
    vo = torch.stack([torch.where(swap, v1, v0), torch.where(swap, v0, v1)], dim=-2)
    return ko.reshape(*lead, n), vo.reshape(*lead, n)


def _half_clean(x: torch.Tensor, j: int) -> torch.Tensor:
    """Ascending half-cleaner of distance ``j`` over the last axis."""
    *lead, n = x.shape
    a = x.reshape(*lead, n // (2 * j), 2, j)
    lo, hi = a[..., 0, :], a[..., 1, :]
    return torch.stack(
        [torch.minimum(lo, hi), torch.maximum(lo, hi)], dim=-2
    ).reshape(*lead, n)


def sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """K1's plain version: the full bitonic network over every row."""
    n = x.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"bitonic length must be a power of two, got {n}")
    for k, j in _stages(n):
        x = compare_exchange(x, k, j)
    return x


def sort_rows_kv_plain(keys: torch.Tensor, vals: torch.Tensor):
    """K3's plain version: the full key-value network over every row.  Not
    stable; deterministic, so the kernel equals it exactly, ties included."""
    n = keys.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"bitonic length must be a power of two, got {n}")
    for k, j in _stages(n):
        keys, vals = compare_exchange_kv(keys, vals, k, j)
    return keys, vals


def merge_rows_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4's plain version: ``concat(a, flip(b))`` row by row is bitonic; the
    merge stages ``j = B .. 1`` with ``k = 2B`` (all ascending) sort it --
    :func:`repro.kernels.bitonic.bitonic_merge_rows`."""
    x = torch.cat([a, b.flip(-1)], dim=-1)
    n = x.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"bitonic length must be a power of two, got {n}")
    j = n // 2
    while j >= 1:
        x = _half_clean(x, j)
        j //= 2
    return x


def co_rank(a: torch.Tensor, b: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """How many of the first ``diag`` keys of the stable merge of the sorted
    rows ``a`` (R, na) and ``b`` (R, nb) come from ``a``, for every entry of
    ``diag`` (R, D): the binary search K2 runs along the cross diagonal.

    The tie rule is the kernel's: a's key comes first when ``a[i] <= b[j]``.
    The result is the least ``i`` in ``[max(0, d - nb), min(d, na)]`` with
    ``a[i] > b[d - 1 - i]``.
    """
    na, nb = a.shape[-1], b.shape[-1]
    lo = (diag - nb).clamp(min=0)
    hi = diag.clamp(max=na)
    if na == 0 or nb == 0:
        return lo
    while True:
        live = lo < hi
        if not bool(live.any()):
            return lo
        mid = (lo + hi) // 2
        av = a.gather(-1, mid.clamp(max=na - 1))
        bv = b.gather(-1, (diag - 1 - mid).clamp(0, nb - 1))
        right = av <= bv
        lo = torch.where(live & right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)


def merge_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge of the sorted rows of ``a`` and ``b`` (R, w) into (R, 2w):
    output ``d`` of each row is a's key ``i = co_rank(d)`` or b's key
    ``d - i``, whichever the tie rule takes first."""
    w = a.shape[-1]
    diag = torch.arange(2 * w, device=a.device).expand(a.shape[0], 2 * w)
    i = co_rank(a, b, diag)
    j = diag - i
    av = a.gather(-1, i.clamp(max=w - 1))
    bv = b.gather(-1, j.clamp(max=w - 1))
    take_a = (j >= w) | ((i < w) & (av <= bv))
    return torch.where(take_a, av, bv)


#: Keys of K2's shared-memory tile (``csrc/tournament.cu``: ``TILE``).
TOURNAMENT_TILE = 16384


def tournament_launches(P: int, B: int) -> int:
    """Kernel launches of one K2 call on a (P, B) matrix: one launch for the
    rounds whose row pairs fit a tile of :data:`TOURNAMENT_TILE` keys (when
    ``2B`` does), then one per wider round -- ``1 + log2(P*B / tile)`` for
    ``B < tile``, ``log2(P)`` otherwise; 0 for one row.  The kernel's own
    count is the C function ``tournament_launches``."""
    n = P * B
    if P == 1:
        return 0
    tile = min(n, TOURNAMENT_TILE)
    count, w = 0, B
    if 2 * w <= tile:
        count, w = 1, tile
    while w < n:
        count, w = count + 1, 2 * w
    return count


def row_sort_items(b: int) -> int:
    """Keys a K1 thread holds at row width ``b``: :data:`ROW_SORT_ITEMS`, or
    ``b / ROW_SORT_THREADS`` where a block of that many would hold less than
    a row (``b = 4096``)."""
    if b > ROW_SORT_ITEMS * ROW_SORT_THREADS:
        return b // ROW_SORT_THREADS
    return ROW_SORT_ITEMS


def row_sort_tiers(b: int) -> list[tuple[str, int, int]]:
    """K1's stages at row width ``b`` in order, each ``(tier, k, j)``: the
    tier is ``"register"`` for ``j < n`` (inside a thread's ``n =
    row_sort_items(b)`` registers), ``"shuffle"`` for ``n <= j <
    ROW_SORT_THREADS`` (by warp shuffle with lane ``^ j / n``) and
    ``"shared"`` above (after a transpose through shared memory, in
    registers again); the kernel's ``network`` takes the same rule."""
    n = row_sort_items(b)
    return [("register" if j < n else "shuffle" if j < ROW_SORT_THREADS else "shared", k, j)
            for k, j in _stages(b)]


_ITEMS, _THREADS, _GROUP = build.source_constants("row_sort_kv.cu", "ITEMS", "THREADS", "GROUP")

#: Pairs one K3 block holds (``csrc/row_sort_kv.cu``: ``CHUNK``, ``THREADS``
#: threads x ``ITEMS`` pairs in registers).
ROW_SORT_KV_CHUNK = _ITEMS * _THREADS

#: Most elements a thread of K3's strided launch holds (``GROUP``): its
#: stages reach pairs up to ``ROW_SORT_KV_CHUNK * ROW_SORT_KV_GROUP / 2``
#: apart; wider stages are device-memory passes.
ROW_SORT_KV_GROUP = _GROUP


def row_sort_kv_plan(n: int) -> list[tuple[str, list[tuple[int, int]]]]:
    """The kernel launches of one K3 call on rows of ``n`` pairs, in order,
    each ``(kind, stages)`` with the ``(k, j)`` stages it runs; together the
    stages are :func:`_stages` of ``n``, in order.

    * ``"chunk"``: one block per ``C = min(n, ROW_SORT_KV_CHUNK)`` pairs
      runs stages with ``j < C`` (first every stage with ``k <= C``, then
      ``j = C/2 .. 1`` of one ``k``);
    * ``"strided"``: a thread holds the ``2 j_first / C`` elements
      ``i + m C`` that stages ``j = j_first .. C`` of one ``k`` connect;
    * ``"global"``: one device-memory pass of one stage with
      ``j >= C * ROW_SORT_KV_GROUP``.

    For ``k > C``: the device-memory passes, one strided launch, one chunk
    launch.  No launch for ``n < 2``.  The kernel's C ``plan`` runs the same
    loop."""
    if n < 2:
        return []
    c = min(n, ROW_SORT_KV_CHUNK)
    plan = [("chunk", list(_stages(c)))]
    k = 2 * c
    while k <= n:
        j = k // 2
        while j >= ROW_SORT_KV_CHUNK * ROW_SORT_KV_GROUP:
            plan.append(("global", [(k, j)]))
            j //= 2
        plan.append(("strided", [(k, jj) for jj in _halvings(j, ROW_SORT_KV_CHUNK)]))
        plan.append(("chunk", [(k, jj) for jj in _halvings(ROW_SORT_KV_CHUNK // 2, 1)]))
        k *= 2
    return plan


def _halvings(hi: int, lo: int) -> list[int]:
    """``hi, hi/2, ..., lo`` (powers of two)."""
    out = []
    while hi >= lo:
        out.append(hi)
        hi //= 2
    return out


def tournament_plain(x: torch.Tensor) -> torch.Tensor:
    """K2's plain version: merge the ``P`` sorted rows of ``x`` into one.

    Round by round, as the kernel merges: adjacent row pairs of width ``w``
    become rows of ``2w`` by a merge at every co-rank (:func:`merge_pairs`).
    """
    P, B = x.shape
    if not (_is_pow2(P) and _is_pow2(B)):
        raise ValueError(f"tournament shape must be powers of two, got {tuple(x.shape)}")
    n = P * B
    flat = x.reshape(n)
    w = B
    while w < n:
        pairs = flat.reshape(n // (2 * w), 2, w)
        flat = merge_pairs(pairs[:, 0], pairs[:, 1]).reshape(n)
        w *= 2
    return flat


# ---------------------------------------------------------------------------
# Building and loading the CUDA kernels (shared helper: ``build.py``)
# ---------------------------------------------------------------------------

# (in, out, rows, B, stream), for int32 and int64
build.register("row_sort", "row_sort.cu", {
    f"row_sort_{sfx}": [build.PTR, build.PTR, build.I64, build.INT, build.PTR]
    for sfx in ("i32", "i64")
})
# (in, out, scratch, P, B, stream), and the launch count of a (P, B) call
build.register("tournament", "tournament.cu", {
    **{f"tournament_{sfx}": [build.PTR] * 3 + [build.I64, build.I64, build.PTR]
       for sfx in ("i32", "i64")},
    "tournament_launches": [build.I64, build.I64],
})

# (keys in, vals in, keys out, vals out, rows, n, stream), int32/int64 keys
build.register("row_sort_kv", "row_sort_kv.cu", {
    f"row_sort_kv_{sfx}": [build.PTR] * 4 + [build.I64, build.I64, build.PTR]
    for sfx in ("i32", "i64")
})
# (a, b, out, rows, B, stream), for int32, int64 and float32
build.register("merge_rows", "merge_rows.cu", {
    f"merge_rows_{sfx}": [build.PTR] * 3 + [build.I64, build.I64, build.PTR]
    for sfx in ("i32", "i64", "f32")
})


def build_kernels(names=None) -> float:
    """Compile and load the kernels (default: every kernel of the port, one
    ``nvcc`` per source, in parallel); see :func:`build.build_kernels`."""
    return build.build_kernels(names)


def _kernel(name: str, dtype: torch.dtype):
    suffix = {torch.int32: "i32", torch.int64: "i64", torch.float32: "f32"}[dtype]
    return build.function(name, f"{name}_{suffix}")


def _check_kernel_input(x: torch.Tensor, op: str) -> None:
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{op} takes int32 or int64 keys, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{op} takes a 2-D matrix, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{op} takes a contiguous matrix")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{op}: unsupported device {x.device}")


# ---------------------------------------------------------------------------
# The wrappers: the plain version on the CPU, the kernel on the card
# ---------------------------------------------------------------------------


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """K1: ascending sort of every row of ``x`` (rows, B); B a power of two
    up to :data:`MAX_ROW`.  Returns a new tensor."""
    _check_kernel_input(x, "sort_rows")
    rows, b = x.shape
    if not _is_pow2(b) or b > MAX_ROW:
        raise ValueError(f"row width must be a power of two <= {MAX_ROW}, got {b}")
    if x.device.type == "cpu":
        return sort_rows_plain(x)
    if rows == 0 or b == 1:
        return x.clone()  # nothing to sort: no launch
    out = torch.empty_like(x)
    fn = _kernel("row_sort", x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), rows, b, stream)
    build.check_launch(err, "row_sort")
    LAUNCHES["row_sort"] += 1
    return out


def merge_tournament(x: torch.Tensor) -> torch.Tensor:
    """K2: merge the ``P`` sorted rows of ``x`` (P, B), padded with the dtype
    maximum, into one sorted ``(P*B,)`` row.  P and B powers of two."""
    _check_kernel_input(x, "merge_tournament")
    P, B = x.shape
    if not (_is_pow2(P) and _is_pow2(B)):
        raise ValueError(f"tournament shape must be powers of two, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return tournament_plain(x)
    if P == 1:
        return x.reshape(P * B).clone()  # one sorted row: no launch
    out = torch.empty(P * B, dtype=x.dtype, device=x.device)
    # rounds ping-pong between out and scratch; one launch needs no scratch
    scratch = torch.empty_like(out) if tournament_launches(P, B) > 1 else None
    fn = _kernel("tournament", x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 P, B, stream)
    build.check_launch(err, "tournament")
    LAUNCHES["tournament"] += 1
    return out


def _check_same(x: torch.Tensor, y: torch.Tensor, op: str) -> None:
    if x.shape != y.shape:
        raise ValueError(f"{op}: shapes {tuple(x.shape)} and {tuple(y.shape)} differ")
    if x.device != y.device:
        raise ValueError(f"{op}: inputs lie on {x.device} and {y.device}")
    if not y.is_contiguous():
        raise ValueError(f"{op} takes contiguous matrices")


#: Integer operations of one K3 compare-exchange by key size in bytes: an
#: int32 key's compare and select 2 (an int64 key's 6), its int32 value's
#: select 2 more.
OPS_PER_KV_COMPARE_EXCHANGE = {4: 4, 8: 8}


def sort_rows_kv_work(keys: torch.Tensor, vals: torch.Tensor) -> dict:
    """One K3 call's work: the compare-exchanges of the stages of
    :func:`row_sort_kv_plan` (the whole network) over every row, as integer
    operations (``ops``; no flops); keys and int32 values read and written
    once."""
    rows, n = keys.shape
    stages = sum(len(st) for _, st in row_sort_kv_plan(n))
    ce = rows * (n // 2) * stages
    return {"flops": 0.0, "ops": float(ce * OPS_PER_KV_COMPARE_EXCHANGE[keys.element_size()]),
            "compare_exchanges": float(ce), "bytes": 2.0 * rows * n * (keys.element_size() + 4)}


@costs.kernel("row_sort_kv", sort_rows_kv_work)
def sort_rows_kv(keys: torch.Tensor, vals: torch.Tensor):
    """K3: sort every row of ``keys`` (rows, n) ascending, the int32 ``vals``
    following their keys; n a power of two.  Not stable.  Returns new
    ``(keys, vals)`` (on the meta device, the dry run's, empty)."""
    _check_kernel_input(keys, "sort_rows_kv")
    if vals.dtype != torch.int32:
        raise TypeError(f"sort_rows_kv takes int32 values, got {vals.dtype}")
    _check_same(keys, vals, "sort_rows_kv")
    rows, n = keys.shape
    if not _is_pow2(n):
        raise ValueError(f"row width must be a power of two, got {n}")
    if keys.device.type == "meta":
        return torch.empty_like(keys), torch.empty_like(vals)
    if keys.device.type == "cpu":
        return sort_rows_kv_plain(keys, vals)
    if rows == 0 or n == 1:
        return keys.clone(), vals.clone()  # nothing to sort: no launch
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    fn = _kernel("row_sort_kv", keys.dtype)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = fn(keys.data_ptr(), vals.data_ptr(), ko.data_ptr(), vo.data_ptr(), rows, n, stream)
    build.check_launch(err, "row_sort_kv")
    LAUNCHES["row_sort_kv"] += 1
    return ko, vo


def merge_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4: merge the sorted rows of ``a`` and ``b`` (rows, B) into sorted
    rows of ``(rows, 2B)``; B a power of two; int32, int64 or float32."""
    if a.dtype not in (torch.int32, torch.int64, torch.float32) or b.dtype != a.dtype:
        raise TypeError(f"merge_rows takes int32, int64 or float32 of one type, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError(f"merge_rows takes contiguous 2-D matrices, got shape {tuple(a.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_rows: unsupported device {a.device}")
    _check_same(a, b, "merge_rows")
    rows, B = a.shape
    if not _is_pow2(B):
        raise ValueError(f"row width must be a power of two, got {B}")
    if a.device.type == "cpu":
        return merge_rows_plain(a, b)
    out = torch.empty((rows, 2 * B), dtype=a.dtype, device=a.device)
    if rows == 0:
        return out  # no launch
    fn = _kernel("merge_rows", a.dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, B, stream)
    build.check_launch(err, "merge_rows")
    LAUNCHES["merge_rows"] += 1
    return out
