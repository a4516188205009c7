"""Sharded egress: a segment-affinity pool of streaming compute servers.

Counterpart of :mod:`repro.net.egress`.  The delivered wire batch is
demultiplexed by segment affinity -- server ``s`` owns a contiguous block of
base segments -- onto ``S`` independent
:class:`~repro_torch.net.server.StreamingServer` instances, and the shard
outputs are reassembled by :func:`pool_concat` (a concatenation within one
control-plane epoch, a k-way merge otherwise).

The demux is packet-granular: the per-packet headers are read on the host
once per batch, and each server's rows move in one device gather.  The pool's
wall-clock is the makespan (slowest server plus the merge); on a CUDA device
each timed region ends with a synchronise, so the seconds are device time,
not enqueue time.  Shard failover (``crash_schedule``), replay buffers,
loss recovery and the ``"shard_map"`` pool merge are later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.mergesort import merge_runs
from ..obs.trace import NULL_TRACER, check_tracer
from .server import StreamingServer
from .wire import WireBatch, ragged_gather


def segment_affinity(num_segments: int, num_servers: int) -> np.ndarray:
    """Contiguous-block map from base segment id to owning server:
    ``b * num_servers // num_segments`` (non-decreasing)."""
    if num_servers <= 0:
        raise ValueError("num_servers must be positive")
    if num_servers > num_segments:
        raise ValueError(
            f"num_servers ({num_servers}) exceeds num_segments "
            f"({num_segments}); a server needs at least one segment"
        )
    base = np.arange(num_segments, dtype=np.int64)
    return base * num_servers // num_segments


def pool_concat(outs: list[torch.Tensor], *, disjoint: bool) -> torch.Tensor:
    """Merge per-server outputs into the global sorted stream: the host
    branch of the reference's ``core/distributed.py::pool_concat``.

    ``disjoint=True`` (one epoch: server order is key-range order)
    concatenates; otherwise the sorted server streams are k-way merged.
    """
    if not outs:
        raise ValueError("pool_concat needs at least one server output")
    outs = [o.to(torch.int64) for o in outs]
    if len(outs) == 1:
        return outs[0]
    if not disjoint:
        nonempty = [o for o in outs if o.numel()]
        return merge_runs(nonempty) if nonempty else outs[0][:0]
    return torch.cat(outs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServerPool:
    """``S`` independent streaming servers behind a segment-affinity demux.

    ``num_segments`` is the base (per-epoch) segment count; with
    ``num_epochs > 1`` the pool addresses ``num_segments * num_epochs``
    virtual segment ids, re-sharded per epoch onto the same blocks.
    """

    def __init__(
        self,
        num_segments: int,
        num_servers: int = 1,
        *,
        num_epochs: int = 1,
        k: int = 10,
        reorder_capacity: int | None = None,
        affinity: np.ndarray | None = None,
        merge_backend: str = "numpy",
        pool_backend: str = "numpy",
        recovery: bool = False,
        crash_schedule=None,
        replay_packets: int | None = None,
        tracer=None,
        metrics=None,
        device="cuda",
    ) -> None:
        if num_epochs < 1:
            raise ValueError("num_epochs must be >= 1")
        if pool_backend not in ("numpy", "shard_map"):
            raise ValueError(
                f"unknown pool_backend {pool_backend!r}; options: numpy, shard_map"
            )
        if pool_backend == "shard_map":
            raise NotImplementedError(
                'pool_backend="shard_map" is not ported yet (later slice: '
                "the multi-card pool merge)"
            )
        if crash_schedule or replay_packets is not None:
            raise NotImplementedError(
                "shard failover (crash_schedule, replay_packets) is not ported "
                "yet (later slice: net/faults)"
            )
        check_tracer(tracer)
        self.device = resolve_device(device)
        base = segment_affinity(num_segments, num_servers)
        if affinity is not None:
            affinity = np.asarray(affinity, dtype=np.int64)
            want = np.tile(base, num_epochs)
            if affinity.shape != want.shape:
                raise ValueError(
                    f"affinity length {affinity.size} != "
                    f"{num_segments} segments x {num_epochs} epochs"
                )
            if affinity.size and (
                affinity.min() < 0
                or affinity.max() >= num_servers
                or np.any(np.diff(affinity.reshape(num_epochs, -1), axis=1) < 0)
            ):
                raise ValueError(
                    "affinity must be non-decreasing within each epoch with "
                    "values in [0, num_servers) — contiguous key-range "
                    "blocks are what make server-order concatenation sorted"
                )
            self._affinity = affinity
        else:
            self._affinity = np.tile(base, num_epochs)
        self.num_segments = num_segments
        self.num_servers = num_servers
        self.num_epochs = num_epochs
        self.eff_segments = num_segments * num_epochs
        self.merge_backend = merge_backend
        self.pool_backend = pool_backend
        counts = np.bincount(self._affinity, minlength=num_servers)
        local = np.zeros(self.eff_segments, dtype=np.int64)
        for s in range(num_servers):
            local[self._affinity == s] = np.arange(counts[s])
        self._local_of = local
        self._local_of_dev = torch.from_numpy(local).to(self.device)
        self._tr = tracer or NULL_TRACER
        self.servers = [
            StreamingServer(
                int(counts[s]) if counts[s] else 1,  # idle server: 1 port
                k=k,
                reorder_capacity=reorder_capacity,
                final_merge=num_epochs > 1,
                merge_backend=merge_backend,
                recovery=recovery,
                tracer=tracer,
                metrics=metrics,
                name=f"server{s}",
                lane=1 + s,
                device=self.device,
            )
            for s in range(num_servers)
        ]
        self.per_server_seconds = [0.0] * num_servers
        self.merge_seconds = 0.0

    # -- ingestion ------------------------------------------------------
    def _timed_ingest(self, s: int, batch: WireBatch) -> None:
        with self._tr.timed(f"server{s}:wall", cat="egress", tid=1 + s) as t:
            self.servers[s].ingest_batch(batch)
            _sync(self.device)
        self.per_server_seconds[s] += t.seconds

    def ingest_batch(self, batch: WireBatch) -> None:
        """Demux a delivered wire batch by segment affinity; feed each server
        its shard with segment ids renumbered into its local space.

        Masking whole packets preserves each segment's packet order, so every
        server sees exactly the sub-sequence of the wire its NIC would."""
        n = len(batch)
        if n == 0:
            return
        lo, hi = int(batch.segment_id.min()), int(batch.segment_id.max())
        if lo < 0 or hi >= self.eff_segments:
            raise ValueError(f"packet with invalid segment id {lo if lo < 0 else hi}")
        if self.num_servers == 1:
            self._timed_ingest(0, batch)
            return
        starts_d = batch.packet_starts()
        starts = starts_d.cpu().numpy()
        sizes = np.diff(np.concatenate([starts, [n]]))
        pserv = self._affinity[batch.segment_id[starts_d].cpu().numpy()]
        dev = batch.device
        for s in range(self.num_servers):
            sel = np.flatnonzero(pserv == s)
            if not sel.size:
                continue
            sel_sizes = sizes[sel]
            sub = batch.take(
                ragged_gather(
                    torch.from_numpy(starts[sel]).to(dev),
                    torch.from_numpy(sel_sizes).to(dev),
                    int(sel_sizes.sum()),
                )
            )
            sub = WireBatch(
                sub.values,
                sub.flow_id,
                sub.seq,
                self._local_of_dev[sub.segment_id],
                epoch=sub.epoch,
            )
            self._timed_ingest(s, sub)
            del sub

    def ingest_grouped(self, values: torch.Tensor, seg_counts, run_flags: torch.Tensor) -> None:
        """Segment-grouped handoff from the device epoch.

        ``values`` holds every segment's complete emission-order stream
        contiguously, segment-ascending (the program's grouped layout),
        ``seg_counts`` the per-segment key counts, and ``run_flags`` marks
        the maximal-ascending-run starts within ``values``.  Each server
        receives its segments as whole in-order streams through
        :meth:`StreamingServer.ingest_segment`: byte-identical to demuxing
        and reassembling the equivalent packet wire, without touching
        packet headers.  The run starts of all segments come from one
        ``nonzero`` over the flags, split by the segment bounds on the host.
        Single-epoch pools only: the multi-epoch handoff interleaves epochs
        on the wire, which this layout cannot express."""
        if self.num_epochs != 1:
            raise ValueError("grouped handoff supports single-epoch pools only")
        n = int(values.numel())
        if n == 0:
            return
        seg_counts = torch.as_tensor(seg_counts).cpu().numpy().astype(np.int64)
        if seg_counts.size != self.eff_segments:
            raise ValueError(
                f"seg_counts length {seg_counts.size} != {self.eff_segments} segments"
            )
        if int(seg_counts.sum()) != n:
            raise ValueError("seg_counts do not sum to the stream length")
        bounds = np.concatenate([[0], np.cumsum(seg_counts)])
        flat = torch.nonzero(run_flags.to(torch.bool)).reshape(-1).cpu().numpy()
        cuts = np.searchsorted(flat, bounds)
        for v in range(self.eff_segments):
            a, b = int(bounds[v]), int(bounds[v + 1])
            if a == b:
                continue
            s = int(self._affinity[v])
            starts = torch.from_numpy(flat[cuts[v] : cuts[v + 1]] - a)
            with self._tr.timed(f"server{s}:wall", cat="egress", tid=1 + s) as t:
                self.servers[s].ingest_segment(int(self._local_of[v]), values[a:b], starts)
                _sync(self.device)
            self.per_server_seconds[s] += t.seconds

    # -- completion -----------------------------------------------------
    def finish(self) -> tuple[torch.Tensor, list[int]]:
        """Drain every server; merge the shard outputs.  Passes come back
        in virtual-segment order, as from a single server."""
        outs: list[torch.Tensor] = []
        per_server_passes: list[list[int]] = []
        for s, server in enumerate(self.servers):
            try:
                with self._tr.timed(f"server{s}:wall", cat="egress", tid=1 + s) as t:
                    out, passes = server.finish()
                    _sync(self.device)
            except ValueError as e:
                owned = np.flatnonzero(self._affinity == s)
                raise ValueError(
                    f"server{s} (virtual segments {owned.tolist()}): {e}"
                ) from e
            self.per_server_seconds[s] += t.seconds
            outs.append(out)
            per_server_passes.append(passes)
        passes = [
            per_server_passes[int(self._affinity[v])][int(self._local_of[v])]
            for v in range(self.eff_segments)
        ]
        with self._tr.timed("pool:merge", cat="egress", servers=self.num_servers) as t:
            output = pool_concat(outs, disjoint=self.num_epochs == 1)
            _sync(self.device)
        self.merge_seconds = t.seconds
        return output, passes

    # -- observability --------------------------------------------------
    @property
    def max_reorder_depth(self) -> int:
        return max((s.max_reorder_depth for s in self.servers), default=0)

    @property
    def server_keys(self) -> list[int]:
        """Keys ingested per server (the pool's load distribution)."""
        return [srv.keys_ingested for srv in self.servers]

    @property
    def server_imbalance(self) -> float:
        """Peak-over-mean per-server key load over the servers that own a
        segment; 1.0 for a perfect shard or an empty pool."""
        keys = self.server_keys
        total = sum(keys)
        owners = int(np.unique(self._affinity).size) if total else 0
        if total == 0 or not owners:
            return 1.0
        return max(keys) / (total / owners)

    @property
    def makespan_seconds(self) -> float:
        """Slowest server + pool merge."""
        return max(self.per_server_seconds, default=0.0) + self.merge_seconds
