"""Observability plane of the port (counterpart of ``repro.obs``).

* :mod:`repro_torch.obs.trace` -- *where did the time go?*  A hierarchical
  span :class:`Tracer` (epoch -> hop -> stages; servers on lanes of their
  own) with Chrome-trace export, and the :data:`NULL_TRACER` default.
* :mod:`repro_torch.obs.metrics` -- *what did the dataplane's state look
  like?*  A :class:`MetricsRegistry` of counters, gauges, histograms and
  series, snapshotted into ``PipelineResult.telemetry``.
* :mod:`repro_torch.obs.telemetry` -- *what did each key experience?*  INT
  per-hop metadata columns (:class:`IntColumns`) riding the wire to egress.

All of it is opt-in, and a run's output is byte-identical with it on or off.
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
    default_registry,
)
from .telemetry import INT_FIELDS, IntColumns, int_summary
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "INT_FIELDS",
    "IntColumns",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "Series",
    "Span",
    "Tracer",
    "default_registry",
    "int_summary",
]
