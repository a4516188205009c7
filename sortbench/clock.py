"""The stage clock: a frozen copy of ``chip_smoke.py``'s ``StageClock``.

It is handed to ``run_pipeline`` as its ``tracer``.  Like the program's null
tracer it records nothing into the run (``enabled`` is False, so the program
takes its unobserved path), but spans of the ``pipeline``, ``hop`` and
``control`` categories synchronise the card on entry and exit, so that
their wall seconds are device time.  Two stages have no span of their own:
``pre_epoch``, from the start of the pipeline to its first epoch (flows,
interleave, payload rows, the range table), and ``egress``, from the end of
its last epoch to the end of the pipeline (the server pool).

Seconds add up over every job the clock sees; ``jobs`` counts the
``pipeline`` spans.  Every span and timed interval is also a
``record_function`` range, so the traced run's idle gaps can be named by
the stage the host was in.
"""

from __future__ import annotations

import time

import torch

_SYNCED = ("pipeline", "hop", "control")


class _Timed:
    """A measured interval (the null tracer's ``timed``, labelled): its
    ``seconds`` feed the program's own results, such as the servers'."""

    def __init__(self, label: str) -> None:
        self.seconds = 0.0
        self._rf = torch.profiler.record_function(label)

    def __enter__(self):
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        return False

    def set(self, **kw):
        pass


class StageClock:
    enabled = False

    def __init__(self, device: torch.device) -> None:
        self._sync = device.type == "cuda"
        self.seconds: dict[str, float] = {}
        self.jobs = 0
        self._marks: dict[str, float] = {}

    def _now(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    def _add(self, name: str, sec: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + sec

    def span(self, name: str, cat: str = "", tid: int = 0, **args):
        if cat not in _SYNCED:
            return _Timed(name)
        clock = self

        class _Span:
            def __enter__(self):
                self.rf = torch.profiler.record_function(name)
                self.rf.__enter__()
                self.t0 = clock._now()
                if name == "pipeline":
                    clock._marks = {"start": self.t0}
                    clock.jobs += 1
                elif name.startswith("epoch:") and "pre_done" not in clock._marks:
                    clock._marks["pre_done"] = self.t0
                    clock._add("pre_epoch", self.t0 - clock._marks.get("start", self.t0))
                return self

            def __exit__(self, *exc):
                t1 = clock._now()
                clock._add(name.split(":")[0] if name.startswith("epoch:") else name, t1 - self.t0)
                if name.startswith("epoch:"):
                    clock._marks["epoch_end"] = t1
                elif name == "pipeline":
                    clock._add("egress", t1 - clock._marks.get("epoch_end", t1))
                self.rf.__exit__(*exc)
                return False

            def set(self, **kw):
                pass

        return _Span()

    def timed(self, name: str, cat: str = "", tid: int = 0, **args):
        return _Timed(name)

    def instant(self, name: str, cat: str = "", tid: int = 0, **args) -> None:
        pass
