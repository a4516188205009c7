"""Run detection and the run arena, on tensors (paper Def. 3.1.1, §6.3).

Counterpart of :mod:`repro.core.runs`.  A *run* is a maximal non-decreasing
sub-sequence.  :class:`RunArena` keeps one segment's runs as adjacent slices
of one device buffer, with an int64 offsets table, exactly as the reference
does with numpy.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device


def run_starts(a: torch.Tensor) -> torch.Tensor:
    """Indices where a new run starts (always includes 0 for non-empty a)."""
    if a.numel() == 0:
        return torch.zeros(0, dtype=torch.int64, device=a.device)
    breaks = torch.nonzero(a[1:] < a[:-1]).reshape(-1) + 1
    zero = torch.zeros(1, dtype=torch.int64, device=a.device)
    return torch.cat([zero, breaks])


def run_lengths(a: torch.Tensor) -> torch.Tensor:
    starts = run_starts(a)
    if starts.numel() == 0:
        return starts
    end = torch.tensor([a.numel()], dtype=torch.int64, device=a.device)
    return torch.diff(torch.cat([starts, end]))


@dataclasses.dataclass(frozen=True)
class RunStats:
    """Run statistics of a stream (the paper's §6.3 table)."""

    n: int
    num_runs: int
    mean_len: float
    median_len: float
    min_len: int
    max_len: int

    @classmethod
    def of(cls, a: torch.Tensor) -> "RunStats":
        a = torch.as_tensor(a)
        lens = run_lengths(a)
        if lens.numel() == 0:
            return cls(0, 0, 0.0, 0.0, 0, 0)
        # The mean and median of numpy (float64; the median of an even
        # count is the mean of the two middle lengths).
        srt = torch.sort(lens).values.tolist()
        m = len(srt)
        median = float(srt[m // 2]) if m % 2 else (srt[m // 2 - 1] + srt[m // 2]) / 2
        return cls(
            n=int(a.numel()),
            num_runs=m,
            mean_len=int(lens.sum()) / m,
            median_len=float(median),
            min_len=srt[0],
            max_len=srt[-1],
        )


class RunArena:
    """Flat run storage for one segment: a contiguous keys buffer on the
    device plus an offsets table, so closed runs are slices.

    :meth:`feed` detects run breaks with one vectorized compare and keeps
    the youngest run open across payloads; :meth:`run_offsets` hands the
    segment to :func:`repro_torch.core.mergesort.merge_runs_flat`.  Buffers
    grow by doubling and are int64 end to end.
    """

    def __init__(self, capacity: int = 1024, device="cuda") -> None:
        self.device = resolve_device(device)
        self._buf = torch.empty(max(int(capacity), 1), dtype=torch.int64, device=self.device)
        self._n = 0
        self._starts = torch.zeros(16, dtype=torch.int64, device=self.device)
        self._num_runs = 0

    def __len__(self) -> int:
        return self._n

    @property
    def num_runs(self) -> int:
        """Maximal ascending runs fed so far (the open run included)."""
        return self._num_runs

    @property
    def tail(self) -> int | None:
        """Last key of the open run (None while the arena is empty)."""
        return int(self._buf[self._n - 1]) if self._n else None

    @staticmethod
    def _grow(arr: torch.Tensor, used: int, need: int) -> torch.Tensor:
        cap = arr.numel()
        if need <= cap:
            return arr
        while cap < need:
            cap *= 2
        out = torch.empty(cap, dtype=arr.dtype, device=arr.device)
        out[:used] = arr[:used]
        return out

    def _append(self, arr: torch.Tensor, new_starts: torch.Tensor) -> None:
        m = int(arr.numel())
        self._buf = self._grow(self._buf, self._n, self._n + m)
        self._buf[self._n : self._n + m] = arr
        self._n += m
        r = int(new_starts.numel())
        if r:
            self._starts = self._grow(self._starts, self._num_runs, self._num_runs + r)
            self._starts[self._num_runs : self._num_runs + r] = new_starts
            self._num_runs += r

    def _opens_new(self, arr: torch.Tensor) -> bool:
        return self._n == 0 or int(arr[0]) < int(self._buf[self._n - 1])

    def feed(self, arr: torch.Tensor) -> None:
        """Append one in-order payload; extend or break runs columnarly."""
        if arr.numel() == 0:
            return
        breaks = torch.nonzero(arr[1:] < arr[:-1]).reshape(-1) + 1
        new_starts = breaks + self._n
        if self._opens_new(arr):
            head = torch.tensor([self._n], dtype=torch.int64, device=self.device)
            new_starts = torch.cat([head, new_starts])
        self._append(arr, new_starts)

    def feed_runs(self, arr: torch.Tensor, starts: torch.Tensor) -> None:
        """Append a payload whose run starts (payload-relative, ``starts[0]
        == 0``) are already known; identical to :meth:`feed` of ``arr``."""
        if arr.numel() == 0:
            return
        if starts.numel() == 0 or int(starts[0]) != 0:
            raise ValueError("run starts must begin at payload position 0")
        new_starts = starts.to(device=self.device, dtype=torch.int64) + self._n
        if not self._opens_new(arr):
            new_starts = new_starts[1:]
        self._append(arr, new_starts)

    @property
    def keys(self) -> torch.Tensor:
        """The contiguous key buffer (a view; runs are adjacent slices)."""
        return self._buf[: self._n]

    def run_offsets(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(starts, lengths)`` of every run, in arrival order."""
        starts = self._starts[: self._num_runs]
        end = torch.tensor([self._n], dtype=torch.int64, device=self.device)
        lengths = torch.diff(torch.cat([starts, end]))
        return starts.clone(), lengths


def merge_passes(num_runs: int, k: int) -> int:
    """k-way merge iterations to reduce ``num_runs`` runs to one (the
    paper's ``log_k(ell)``, exact ceil-log)."""
    if num_runs <= 1:
        return 0
    passes = 0
    while num_runs > 1:
        num_runs = -(-num_runs // k)
        passes += 1
    return passes
