"""Reading the device trace of a traced window (``torch.profiler``).

:func:`read_trace` turns a finished profile into a :class:`DeviceTrace`:
the device's kernel, copy and memset intervals, and the host's operations
and labelled ranges, both on the profiler's clock and clipped to the range
the harness labels ``WINDOW``.  The busy time is the union of the device
intervals (overlapping streams are counted once); an idle gap is a stretch
of the window with no device interval, named by the innermost host range
that covers its middle.  Kernels are found by name patterns, which each
metric's own file keeps.
"""

from __future__ import annotations

import dataclasses
import heapq

import torch

WINDOW = "sortbench.window"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window: tuple[int, int]  # ns on the profiler's clock
    device: list[tuple[int, int, str]]  # (start, end, name), sorted by start
    host: list[tuple[int, int, str]]  # host ops and labelled ranges

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def union(self) -> list[tuple[int, int]]:
        out: list[list[int]] = []
        for s, e, _ in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e9

    def seconds_of(self, patterns) -> float:
        """Device seconds of every interval whose name holds one of
        ``patterns`` (case-insensitive), overlaps included."""
        pats = [p.lower() for p in patterns]
        return sum(e - s for s, e, n in self.device if any(p in n.lower() for p in pats)) / 1e9

    def top_ops(self) -> list[list]:
        by: dict[str, float] = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e9
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:_TOP]]

    def idle_gaps(self) -> list[list]:
        """Idle seconds by what the host was doing: each gap is named by the
        innermost host operation or range covering its middle."""
        lo, hi = self.window
        edges = [(lo, lo)] + self.union() + [(hi, hi)]
        host = sorted(self.host)
        active: list[tuple[int, int, str]] = []  # a heap by end
        i = 0
        by: dict[str, float] = {}
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b <= a:
                continue
            mid = (a + b) // 2
            while i < len(host) and host[i][0] <= mid:
                s, e, n = host[i]
                heapq.heappush(active, (e, s, n))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            inner = min(active, key=lambda x: x[0] - x[1], default=None)
            name = inner[2] if inner is not None else "host (no traced op)"
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:_TOP]]


def read_trace(prof) -> DeviceTrace | None:
    """The window's device and host intervals, or None when the trace has no
    labelled window or no device interval in it."""
    window = None
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s, e = int(ev.start_ns()), int(ev.end_ns())
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kind = getattr(ev, "activity_type", None)
            if (kind is None or kind() in _DEVICE_KINDS) and e > s:
                device.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        elif e > s:
            host.append((s, e, name))
    if window is None:
        return None
    lo, hi = window
    # A labelled host range has a device-side twin of the same name (a GPU
    # user annotation), which is no device work; torch builds without
    # ``activity_type`` tell them apart by name only.
    labels = {n for _, _, n in host} | {WINDOW}
    device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi and n not in labels)
    host = [(s, e, n) for s, e, n in host if e > lo and s < hi]
    if not device:
        return None
    return DeviceTrace(window=window, device=device, host=host)


def profiler():
    """A profiler of the host and the card, without shapes or stacks."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
