"""The in-network sort dataplane on tensors: wire, flows, the hop engines,
fabrics, control plane, link timing, faults, streaming servers, egress pool,
the end-to-end ``run_pipeline`` and the multi-tenant scheduler (counterpart
of ``repro.net``, with the same exports).

The reference's packet-list forms are here too: :func:`interleave` (and
:data:`INTERLEAVES`) and :func:`jitter_delivery` over lists of
:class:`Packet`, on the batch forms' schedules; :class:`SwitchHop` runs a
wire batch (``process_batch``) or a packet list (``process``).
``pallas_row_sort`` is the hop's row sort on kernel K1
(:func:`~repro_torch.net.engine.row_sort_device`).
"""

from .control import (
    RANGE_MODES,
    AdaptiveControlPlane,
    ControlPlane,
    ReservoirSampler,
    ranges_valid,
)
from .device_epoch import (
    DeviceDelivery,
    device_hop,
    device_self_check,
    run_graph_device,
)
from .egress import (
    ServerPool,
    segment_affinity,
)
from .engine import (
    ENGINES,
    HOP_ENGINES,
    HopSpec,
    HopStats,
    emission_to_wire,
    fused_hop,
    pallas_row_sort,
    passthrough_hop,
    run_hop,
)
from .faults import (
    FAULT_KINDS,
    HOP_STATES,
    EpochFaults,
    Fault,
    FaultPlan,
    parse_fault_plan,
)
from .flow import (
    INTERLEAVES,
    Flow,
    interleave,
    interleave_batch,
    split_flows,
)
from .packet import (
    DEFAULT_PAYLOAD,
    UNTAGGED,
    Packet,
    depacketize,
    packetize,
    segment_streams,
)
from .pipeline import (
    PipelineResult,
    jitter_delivery,
    jitter_delivery_batch,
    plain_stream_sort,
    run_pipeline,
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
from .server import (
    MERGE_BACKENDS,
    StreamingServer,
    stream_sort,
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
from .topology import (
    TOPOLOGIES,
    AggregationTree,
    HopGraph,
    HopNode,
    LeafSpine,
    SingleSwitch,
    SwitchHop,
    leaf_spine_graph,
    make_topology,
    run_graph,
    single_graph,
    tree_graph,
)
from .wire import (
    WireBatch,
    concat_batches,
    merge_round_robin_batches,
    packetize_batch,
    ragged_arange,
    ragged_gather,
    segment_streams_batch,
    split_by_flow,
)

__all__ = [
    "RANGE_MODES",
    "AdaptiveControlPlane",
    "ControlPlane",
    "ReservoirSampler",
    "ranges_valid",
    "FAULT_KINDS",
    "HOP_STATES",
    "EpochFaults",
    "Fault",
    "FaultPlan",
    "parse_fault_plan",
    "DeviceDelivery",
    "device_hop",
    "device_self_check",
    "run_graph_device",
    "ServerPool",
    "segment_affinity",
    "ENGINES",
    "HOP_ENGINES",
    "HopSpec",
    "HopStats",
    "emission_to_wire",
    "fused_hop",
    "pallas_row_sort",
    "passthrough_hop",
    "run_hop",
    "INTERLEAVES",
    "Flow",
    "interleave",
    "interleave_batch",
    "split_flows",
    "DEFAULT_PAYLOAD",
    "UNTAGGED",
    "Packet",
    "depacketize",
    "packetize",
    "segment_streams",
    "PipelineResult",
    "jitter_delivery",
    "jitter_delivery_batch",
    "plain_stream_sort",
    "run_pipeline",
    "PACKABLE_ENGINES",
    "AdmissionController",
    "Job",
    "JobResult",
    "MultiTenantResult",
    "run_job_solo",
    "run_jobs",
    "MERGE_BACKENDS",
    "StreamingServer",
    "stream_sort",
    "POLICIES",
    "LinkSpec",
    "LinkStats",
    "NetworkConfig",
    "NetworkReport",
    "merge_reports",
    "resequence",
    "simulate_link",
    "TOPOLOGIES",
    "AggregationTree",
    "HopGraph",
    "HopNode",
    "LeafSpine",
    "SingleSwitch",
    "SwitchHop",
    "leaf_spine_graph",
    "make_topology",
    "run_graph",
    "single_graph",
    "tree_graph",
    "WireBatch",
    "concat_batches",
    "merge_round_robin_batches",
    "packetize_batch",
    "ragged_arange",
    "ragged_gather",
    "segment_streams_batch",
    "split_by_flow",
]
