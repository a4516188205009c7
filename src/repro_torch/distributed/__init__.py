"""Distributed helpers of the port (counterpart of ``repro.distributed``) on
``torch.distributed``, one rank per device: meshes (``compat``), the
sharding context, the per-layer FSDP gather and the pool's mesh
(``sharding``), the GPipe schedule (``pp``) and the gradient compressor and
straggler monitor (``collectives``)."""
