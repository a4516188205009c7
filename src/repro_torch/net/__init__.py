"""The in-network sort dataplane on tensors: wire, flows, the hop engines,
fabrics, control plane, link timing, faults, streaming servers, egress pool,
the end-to-end ``run_pipeline`` and the multi-tenant scheduler (counterpart
of ``repro.net``).

The package re-exports the control plane (:mod:`.control`, the adaptive
``"sampled"`` plane included), the link timing model (:mod:`.timing`), the
fault plane (:mod:`.faults`), the hop engines' registry (:mod:`.engine`) and
the multi-tenant scheduler (:mod:`.scheduler`); the rest is imported from
its module.
"""

from .control import (
    RANGE_MODES,
    AdaptiveControlPlane,
    ControlPlane,
    ReservoirSampler,
    ranges_valid,
)
from .engine import ENGINES, HOP_ENGINES, passthrough_hop
from .faults import (
    FAULT_KINDS,
    HOP_STATES,
    EpochFaults,
    Fault,
    FaultPlan,
    parse_fault_plan,
)
from .scheduler import (
    PACKABLE_ENGINES,
    AdmissionController,
    Job,
    JobResult,
    MultiTenantResult,
    run_job_solo,
    run_jobs,
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
    "ENGINES",
    "HOP_ENGINES",
    "passthrough_hop",
    "FAULT_KINDS",
    "HOP_STATES",
    "EpochFaults",
    "Fault",
    "FaultPlan",
    "parse_fault_plan",
    "PACKABLE_ENGINES",
    "AdmissionController",
    "Job",
    "JobResult",
    "MultiTenantResult",
    "run_job_solo",
    "run_jobs",
    "POLICIES",
    "LinkSpec",
    "LinkStats",
    "NetworkConfig",
    "NetworkReport",
    "merge_reports",
    "resequence",
    "simulate_link",
]
