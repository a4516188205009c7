"""The null tracer: the port's signatures keep ``tracer=`` like the reference.

Counterpart of :mod:`repro.obs.trace`'s ``NullTracer``/``NULL_TRACER``.  The
recording ``Tracer`` and its Chrome-trace export belong to a later slice;
``tracer=`` arguments of the port accept ``None`` or a null tracer.
"""

from __future__ import annotations

import time


class _NullSpan:
    """Shared no-op context manager returned by ``NullTracer.span``."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Timed:
    """Wall-clock measuring context manager that records nothing."""

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
    """Records nothing; ``timed()`` still measures wall-clock seconds."""

    enabled = False
    clock = staticmethod(time.perf_counter)

    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        return _NULL_SPAN

    def timed(self, name: str, cat: str = "", tid: int = 0, **args):
        return _Timed(self.clock)

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        pass


#: Process-wide shared null tracer -- the ``tracer or NULL_TRACER`` default.
NULL_TRACER = NullTracer()


def check_tracer(tracer) -> None:
    """Refuse a recording tracer: recording is a later slice of the port."""
    if tracer is not None and getattr(tracer, "enabled", False):
        raise NotImplementedError(
            "recording tracers are not ported yet (later slice: obs/trace "
            "Tracer); pass tracer=None"
        )
