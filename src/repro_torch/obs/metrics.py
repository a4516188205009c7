"""Process-wide metric registry: counters, gauges, histograms, series.

Counterpart of :mod:`repro.obs.metrics`, on the host.  Where
:mod:`repro_torch.obs.trace` answers *where time went*, this module answers
*what the dataplane's state looked like*: keys in and out per hop, segment
loads, the servers' run-length distribution, the reorder buffer's depth over
time, arena fill, control-plane handoffs.

* :class:`Counter` -- monotone accumulator (``inc``);
* :class:`Gauge` -- last-write-wins value (``set`` / ``high_water``); a
  tensor is read to a list once;
* :class:`Histogram` -- power-of-two buckets; :meth:`Histogram.observe_many`
  takes a numpy array or a tensor, read to the host once per call, and
  buckets it with the reference's own float64 arithmetic;
* :class:`Series` -- an (x, y) timeline with stride-doubling decimation.

A :class:`MetricsRegistry` keys every instrument by ``(name, label)``;
:meth:`~MetricsRegistry.snapshot` renders it as the dict that lands in
``PipelineResult.telemetry``, equal to the reference's for the same run.
"""

from __future__ import annotations

import numpy as np
import torch


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, v: int | float = 1) -> None:
        self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins value; may hold a scalar or a small list/vector."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = None

    def set(self, v) -> None:
        self.value = v.tolist() if hasattr(v, "tolist") else v

    def high_water(self, v) -> None:
        """Keep the maximum of all values set through this method."""
        self.value = v if self.value is None else max(self.value, v)

    def snapshot(self):
        return self.value


class Histogram:
    """Power-of-two bucketed distribution of non-negative values.

    Bucket ``b`` counts observations in ``[2**(b-1), 2**b)`` (bucket 0 is
    exactly the zeros), i.e. an integer ``v`` lands in bucket
    ``v.bit_length()`` — one int op per scalar observe, no search.
    """

    __slots__ = ("counts", "total", "n", "lo", "hi")

    #: bucket count: values up to 2**63 (int64 keys / run lengths)
    NBUCKETS = 65

    def __init__(self) -> None:
        self.counts = np.zeros(self.NBUCKETS, dtype=np.int64)
        self.total = 0
        self.n = 0
        self.lo = None
        self.hi = None

    def observe(self, v: int) -> None:
        v = int(v)
        if v < 0:
            raise ValueError(f"histogram values must be >= 0, got {v}")
        self.counts[v.bit_length()] += 1
        self.total += v
        self.n += 1
        self.lo = v if self.lo is None else min(self.lo, v)
        self.hi = v if self.hi is None else max(self.hi, v)

    def observe_many(self, values) -> None:
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()  # the one read per call
        v = np.asarray(values)
        if v.size == 0:
            return
        if v.min() < 0:
            raise ValueError("histogram values must be >= 0")
        # bit_length, vectorized: 0 → bucket 0, else floor(log2(v)) + 1.
        buckets = np.zeros(v.shape, dtype=np.int64)
        nz = v > 0
        buckets[nz] = np.int64(np.floor(np.log2(v[nz]))) + 1
        self.counts += np.bincount(buckets, minlength=self.NBUCKETS)
        self.total += int(v.sum())
        self.n += int(v.size)
        self.lo = int(v.min()) if self.lo is None else min(self.lo, int(v.min()))
        self.hi = int(v.max()) if self.hi is None else max(self.hi, int(v.max()))

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        nz = np.nonzero(self.counts)[0]
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.lo,
            "max": self.hi,
            "mean": self.mean,
            # sparse buckets: {"2**b upper bound exponent": count}
            "buckets": {int(b): int(self.counts[b]) for b in nz},
        }


class Series:
    """An append-only (x, y) timeline with bounded memory.

    When ``max_points`` is reached the series decimates itself by keeping
    every other point and doubles its sampling stride — the shape survives,
    the memory stays O(max_points) however long the run.
    """

    __slots__ = ("xs", "ys", "max_points", "_stride", "_skip")

    def __init__(self, max_points: int = 4096) -> None:
        self.xs: list = []
        self.ys: list = []
        self.max_points = max_points
        self._stride = 1
        self._skip = 0

    def append(self, x, y) -> None:
        if self._skip:
            self._skip -= 1
            return
        self._skip = self._stride - 1
        self.xs.append(x)
        self.ys.append(y)
        if len(self.xs) >= self.max_points:
            self.xs = self.xs[::2]
            self.ys = self.ys[::2]
            self._stride *= 2

    def snapshot(self) -> dict:
        return {"x": list(self.xs), "y": list(self.ys),
                "stride": self._stride}


_KINDS = {
    "counter": Counter,
    "gauge": Gauge,
    "histogram": Histogram,
    "series": Series,
}


class MetricsRegistry:
    """All instruments of one run, keyed by ``(name, label)``.

    ``name`` is the metric ("hop_keys_in"), ``label`` the emitting site
    ("leaf0", "server2") — the same instrument comes back on every call, so
    call sites never hold references across components.
    """

    def __init__(self) -> None:
        self._instruments: dict[tuple[str, str, str], object] = {}

    def _get(self, kind: str, name: str, label: str):
        key = (kind, name, label)
        inst = self._instruments.get(key)
        if inst is None:
            for other_kind in _KINDS:
                if other_kind != kind and (other_kind, name, label) in self._instruments:
                    raise ValueError(
                        f"metric {name!r}[{label!r}] already registered as "
                        f"a {other_kind}, requested as a {kind}"
                    )
            inst = self._instruments[key] = _KINDS[kind]()
        return inst

    def counter(self, name: str, label: str = "") -> Counter:
        return self._get("counter", name, label)

    def gauge(self, name: str, label: str = "") -> Gauge:
        return self._get("gauge", name, label)

    def histogram(self, name: str, label: str = "") -> Histogram:
        return self._get("histogram", name, label)

    def series(self, name: str, label: str = "") -> Series:
        return self._get("series", name, label)

    def snapshot(self) -> dict:
        """The registry as nested JSON-able dicts:
        ``{kind: {name: {label: value}}}``."""
        out: dict[str, dict] = {}
        for (kind, name, label), inst in sorted(self._instruments.items()):
            out.setdefault(kind + "s", {}).setdefault(name, {})[label] = (
                inst.snapshot()
            )
        return out


#: Lazily-created process-wide registry for callers that want one shared
#: sink (the pipeline builds a per-run registry instead — runs stay
#: independent; this exists for ad-hoc scripts and REPL use).
_DEFAULT: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT
