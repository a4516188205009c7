"""The in-network sort dataplane on tensors: wire, flows, the fused hop,
fabrics, control plane, link timing, streaming servers, egress pool and the
end-to-end ``run_pipeline`` (counterpart of ``repro.net``).

The package re-exports the control plane (:mod:`.control`, the adaptive
``"sampled"`` plane included) and the link timing model (:mod:`.timing`);
the rest is imported from its module.
"""

from .control import (
    RANGE_MODES,
    AdaptiveControlPlane,
    ControlPlane,
    ReservoirSampler,
    ranges_valid,
)
from .timing import (
    POLICIES,
    LinkSpec,
    LinkStats,
    NetworkConfig,
    NetworkReport,
    merge_reports,
    resequence,
    simulate_link,
)

__all__ = [
    "RANGE_MODES",
    "AdaptiveControlPlane",
    "ControlPlane",
    "ReservoirSampler",
    "ranges_valid",
    "POLICIES",
    "LinkSpec",
    "LinkStats",
    "NetworkConfig",
    "NetworkReport",
    "merge_reports",
    "resequence",
    "simulate_link",
]
