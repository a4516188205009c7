"""The paper's evaluation traces and the beyond-paper scenarios, drawn from
a seed (counterpart of ``repro.data``)."""

from .scenarios import (
    SCENARIO_DOMAIN,
    SCENARIOS,
    adversarial_skew,
    drifting,
    duplicate_heavy,
    near_sorted_outliers,
    scenario_max_value,
    sortedness_dial,
)
from .traces import TRACES, memory_trace, network_trace, random_trace, trace_max_value

__all__ = [
    "SCENARIO_DOMAIN",
    "SCENARIOS",
    "adversarial_skew",
    "drifting",
    "duplicate_heavy",
    "near_sorted_outliers",
    "scenario_max_value",
    "sortedness_dial",
    "TRACES",
    "memory_trace",
    "network_trace",
    "random_trace",
    "trace_max_value",
]
