"""Distributed-training helpers of the port (counterpart of
``repro.distributed``).  Only the one-device part of ``collectives`` is here;
sharding, pipeline parallelism and the cross-replica reduce are the sharded
slice (M19)."""
