"""Hierarchical span tracer with Chrome-trace-event export.

Counterpart of :mod:`repro.obs.trace`.  A :class:`Tracer` records nested
**spans** -- context managers that append wall-clock intervals to a flat
event list, each with a category, a lane (Chrome ``tid``: the egress servers
get lanes of their own) and free-form args -- and zero-duration instants
(control-plane handoffs, link reports).  :meth:`Tracer.dump` writes the
Chrome trace-event JSON (``{"traceEvents": [...]}``) that Perfetto and
``chrome://tracing`` load.

Spans read the host's wall clock and never synchronise the card: on a CUDA
device a span measures when the host enqueued its work, not when the card
ran it.  Where device time matters the caller synchronises around the span
(the egress pool does so inside its ``timed`` regions; ``chip_smoke.py``'s
stage clock does so for the pipeline's stages).  A span argument is a Python
value, never a tensor: reading a device tensor for an argument would be a
hidden host read, so :meth:`Tracer.span` refuses one.

The default everywhere is :data:`NULL_TRACER`, whose ``span()`` returns one
shared no-op context manager.  Both tracers are also the repo's one
wall-clock source: :meth:`timed` always measures and exposes ``.seconds``,
which is how the egress pool's ``per_server_seconds`` keep their values with
tracing off.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch


@dataclasses.dataclass
class Span:
    """One closed interval on the trace timeline."""

    name: str
    cat: str
    ts: float  # start, seconds since the tracer's origin
    dur: float  # duration, seconds
    tid: int  # lane (Chrome thread id); servers get distinct lanes
    depth: int  # nesting depth within its lane at open time
    args: dict

    @property
    def seconds(self) -> float:
        return self.dur


class _NullSpan:
    """Shared no-op span: the zero-overhead path of :class:`NullTracer`."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        """Late-annotation no-op (the recording span attaches args)."""


_NULL_SPAN = _NullSpan()


class _Timed:
    """Measure-only interval: the null tracer's :meth:`~Tracer.timed`.

    Always runs the clock — results fields like ``per_server_seconds`` keep
    their values with tracing off — but records nothing.
    """

    __slots__ = ("_clock", "_t0", "seconds")

    def __init__(self, clock) -> None:
        self._clock = clock
        self.seconds = 0.0

    def __enter__(self) -> "_Timed":
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = self._clock() - self._t0
        return False

    def set(self, **args) -> None:
        pass


class NullTracer:
    """The default tracer: records nothing, costs (almost) nothing.

    ``span()`` hands back one shared stateless context manager;  ``timed()``
    still measures wall-clock (it is the repo's timing primitive) but keeps
    no record;  ``instant()`` is a no-op.  ``enabled`` lets hot paths skip
    building argument dicts entirely.
    """

    enabled = False
    clock = staticmethod(time.perf_counter)

    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        return _NULL_SPAN

    def timed(self, name: str, cat: str = "", tid: int = 0, **args):
        return _Timed(self.clock)

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        pass


#: Process-wide shared null tracer — the ``tracer or NULL_TRACER`` default.
NULL_TRACER = NullTracer()


class _RecordingSpan:
    """Context manager that appends a :class:`Span` to its tracer on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0", "_depth",
                 "seconds")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int,
                 args: dict) -> None:
        _check_args(name, args)
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args
        self.seconds = 0.0

    def __enter__(self) -> "_RecordingSpan":
        self._depth = self._tracer._enter(self._tid)
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer.clock()
        self.seconds = t1 - self._t0
        self._tracer._exit(self._tid)
        self._tracer.spans.append(
            Span(
                name=self._name,
                cat=self._cat,
                ts=self._t0 - self._tracer.origin,
                dur=self.seconds,
                tid=self._tid,
                depth=self._depth,
                args=self._args,
            )
        )
        return False

    def set(self, **args) -> None:
        """Attach args discovered mid-span (e.g. counts known after work)."""
        _check_args(self._name, args)
        self._args.update(args)


class Tracer:
    """Recording tracer: hierarchical spans + instant events, Chrome export.

    Spans nest per lane (``tid``): the dataplane runs on lane 0, egress
    servers on ``1 + server_index`` so the pool's simulated-parallel work
    renders as parallel tracks.  The span hierarchy the pipeline emits::

        pipeline
        └─ epoch:<e>
           └─ hop:<name>             (cat="hop", one per fabric node)
              ├─ route / rank / sort / emit   (cat="stage")
              └─ stats / packetize           (cat="stage")
        server<s>:ingest             (cat="server", lane 1+s)
        └─ ladder:L<d>               (cat="server", eager k-way merges)
        server<s>:finish             (cat="server", lane 1+s)
        └─ merge:seg<sid>            (cat="server")
           └─ tournament:b<B> / winners      (cat="server", arena backend)
        pool:merge                   (cat="egress", distributed merge)

    All timestamps come from ``clock`` (default ``time.perf_counter``),
    relative to the tracer's construction time.
    """

    enabled = True

    def __init__(self, clock=time.perf_counter) -> None:
        self.clock = clock
        self.origin = clock()
        self.spans: list[Span] = []
        self.instants: list[Span] = []
        self._depths: dict[int, int] = {}

    # -- span bookkeeping ----------------------------------------------
    def _enter(self, tid: int) -> int:
        depth = self._depths.get(tid, 0)
        self._depths[tid] = depth + 1
        return depth

    def _exit(self, tid: int) -> None:
        self._depths[tid] = self._depths.get(tid, 1) - 1

    # -- public API -----------------------------------------------------
    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        """Open a recorded span; use as a context manager."""
        return _RecordingSpan(self, name, cat, tid, args)

    def timed(self, name: str, cat: str = "", tid: int = 0, **args):
        """Like :meth:`span`; the name marks it as a results timing source."""
        return _RecordingSpan(self, name, cat, tid, args)

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        """A zero-duration event (control-plane handoffs, faults)."""
        _check_args(name, args)
        self.instants.append(
            Span(
                name=name,
                cat=cat,
                ts=self.clock() - self.origin,
                dur=0.0,
                tid=tid,
                depth=self._depths.get(tid, 0),
                args=args,
            )
        )

    # -- queries --------------------------------------------------------
    def find(self, name: str | None = None, cat: str | None = None) -> list[Span]:
        """Spans matching a name and/or category (both exact)."""
        return [
            s
            for s in self.spans
            if (name is None or s.name == name)
            and (cat is None or s.cat == cat)
        ]

    def total_seconds(self, name: str | None = None, cat: str | None = None) -> float:
        """Summed duration of the matching spans."""
        return sum(s.dur for s in self.find(name, cat))

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event JSON document (dict).

        Complete events (``"ph": "X"``) for spans, instant events
        (``"ph": "i"``) for the point events; timestamps in microseconds,
        as the format requires.  Viewable in Perfetto / ``chrome://tracing``.
        """
        events = [
            {
                "ph": "X",
                "name": s.name,
                "cat": s.cat or "default",
                "ts": s.ts * 1e6,
                "dur": s.dur * 1e6,
                "pid": 0,
                "tid": s.tid,
                "args": s.args,
            }
            for s in self.spans
        ] + [
            {
                "ph": "i",
                "name": s.name,
                "cat": s.cat or "default",
                "ts": s.ts * 1e6,
                "s": "t",  # thread-scoped instant
                "pid": 0,
                "tid": s.tid,
                "args": s.args,
            }
            for s in self.instants
        ]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        """Write :meth:`chrome_trace` as JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh, indent=1, default=_jsonable)
            fh.write("\n")


def _check_args(name: str, args: dict) -> None:
    """Refuse tensor arguments: a span records host values only."""
    for key, val in args.items():
        if isinstance(val, torch.Tensor):
            raise TypeError(
                f"span {name!r}: argument {key!r} is a tensor; pass a Python "
                "value (a tensor argument would be a hidden host read)"
            )


def _jsonable(obj):
    """Best-effort JSON fallback for numpy scalars/arrays in span args."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)
