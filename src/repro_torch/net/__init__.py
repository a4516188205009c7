"""The in-network sort dataplane on tensors: wire, flows, the fused hop,
fabrics, control plane, streaming servers, egress pool and the end-to-end
``run_pipeline`` (counterpart of ``repro.net``)."""
