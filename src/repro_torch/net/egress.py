"""Sharded egress: a segment-affinity pool of streaming compute servers.

Counterpart of :mod:`repro.net.egress`.  The delivered wire batch is
demultiplexed by segment affinity -- server ``s`` owns a contiguous block of
base segments -- onto ``S`` independent
:class:`~repro_torch.net.server.StreamingServer` instances, and the shard
outputs are reassembled by :func:`repro_torch.core.distributed.pool_concat`
(a concatenation within one control-plane epoch, a k-way merge otherwise).

The demux is packet-granular: the per-packet headers are read on the host
once per batch, and each server's rows move in one device gather.  The pool's
wall-clock is the makespan (slowest server plus the merge); on a CUDA device
each timed region ends with a synchronise, so the seconds are device time,
not enqueue time.  ``recovery`` turns on every member server's loss-recovery
mode (for the raw egress link of :mod:`repro_torch.net.timing`), and
``metrics`` reaches every server and the pool's own gauges.

Shard failover (the fault plane's ``server_crash``): ``crash_schedule``
kills shard ``s`` after the pool has ingested a given number of packets.
Until then the shard's sub-batches (on the device, virtual segment ids)
are kept in a replay buffer bounded by ``replay_packets``; at the crash the
nearest alive shard grows ports for the dead shard's segments and
re-ingests that history in its original order, which rebuilds the dead
shard's state exactly, so the output stays byte-identical.

``pool_backend="shard_map"`` (the reference's name, kept so that its callers
work unchanged) concatenates the shards with a ``torch.distributed``
all_gather over a mesh of ``S`` ranks (``sharding.pool_mesh``); with fewer
ranks than servers, as on one card, the pool concatenates on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.distributed import pool_concat
from ..obs.trace import NULL_TRACER
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
        self.recovery = recovery
        counts = np.bincount(self._affinity, minlength=num_servers)
        local = np.zeros(self.eff_segments, dtype=np.int64)
        for s in range(num_servers):
            local[self._affinity == s] = np.arange(counts[s])
        self._local_of = local
        self._local_of_dev = torch.from_numpy(local).to(self.device)
        self._tr = tracer or NULL_TRACER
        self._metrics = metrics
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
        # -- shard failover: [(server, at_packets)]; shard s dies once the
        # pool has ingested at_packets packets (pending crashes fire at
        # finish()).  A doomed shard's sub-batches are retained for replay.
        self._crash_at: dict[int, int] = {}
        for s, at in crash_schedule or []:
            s = int(s)
            if not 0 <= s < num_servers:
                raise ValueError(f"crash_schedule names server {s}; pool has {num_servers}")
            if num_servers == 1:
                raise ValueError(
                    "cannot schedule a crash on a single-server pool — there is "
                    "no shard to fail over to"
                )
            self._crash_at[s] = int(at)
        self._replay_cap = replay_packets
        self._replay: dict[int, list[WireBatch]] = {s: [] for s in self._crash_at}
        self._replay_len: dict[int, int] = {s: 0 for s in self._crash_at}
        self._replay_lost: dict[int, int] = {s: 0 for s in self._crash_at}
        self._dead: set[int] = set()
        self._packets_seen = 0
        self.servers_failed_over = 0

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
        server sees exactly the sub-sequence of the wire its NIC would.  In
        recovery mode a retransmit copy separated from its original only by
        other servers' packets would land next to it after the demux and
        fuse into one double-length packet (boundaries are header runs): the
        demux applies the egress link's rule first, adjacent identical copies
        deliver once."""
        n = len(batch)
        if n == 0:
            return
        lo, hi = int(batch.segment_id.min()), int(batch.segment_id.max())
        if lo < 0 or hi >= self.eff_segments:
            raise ValueError(f"packet with invalid segment id {lo if lo < 0 else hi}")
        if self.num_servers == 1 and not self._crash_at:
            self._timed_ingest(0, batch)
            return
        starts_d = batch.packet_starts()
        starts = starts_d.cpu().numpy()
        sizes = np.diff(np.concatenate([starts, [n]]))
        heads = {"seg": batch.segment_id[starts_d].cpu().numpy()}
        if self.recovery:
            heads["flow"] = batch.flow_id[starts_d].cpu().numpy()
            heads["seq"] = batch.seq[starts_d].cpu().numpy()
        P = int(starts.size)
        # Shard crashes trigger at global packet ordinals: split this
        # batch's packet window at every pending cut, failing the shard over
        # between the chunks.
        cuts = sorted(
            (max(at - self._packets_seen, 0), s)
            for s, at in self._crash_at.items()
            if s not in self._dead and at < self._packets_seen + P
        )
        lo = 0
        for cut, s in cuts:
            cut = max(cut, lo)
            if cut > lo:
                self._ingest_packets(batch, starts, sizes, heads, lo, cut)
            self._crash(s)
            lo = cut
        if lo < P:
            self._ingest_packets(batch, starts, sizes, heads, lo, P)
        self._packets_seen += P

    def _ingest_packets(self, batch: WireBatch, starts, sizes, heads: dict, plo: int,
                        phi: int) -> None:
        """Demux the contiguous packet window ``[plo, phi)`` of ``batch``."""
        pseg = heads["seg"]
        window = np.arange(plo, phi, dtype=np.int64)
        pserv = self._affinity[pseg[window]]
        dev = batch.device
        for s in range(self.num_servers):
            sel = window[pserv == s]
            if not sel.size:
                continue
            if self.recovery and sel.size > 1:
                pflow, pseq = heads["flow"], heads["seq"]
                dup = (
                    (pflow[sel][1:] == pflow[sel][:-1])
                    & (pseq[sel][1:] == pseq[sel][:-1])
                    & (pseg[sel][1:] == pseg[sel][:-1])
                )
                if dup.any():
                    keep = np.ones(sel.size, dtype=bool)
                    keep[1:] = ~dup
                    self.servers[s].dup_packets_dropped += int(dup.sum())
                    sel = sel[keep]
            sel_sizes = sizes[sel]
            idx = ragged_gather(
                torch.from_numpy(starts[sel]).to(dev),
                torch.from_numpy(sel_sizes).to(dev),
                int(sel_sizes.sum()),
            )
            # Only the columns a server reads move: the INT stack, the row
            # column and the tenant stay behind.
            sub = WireBatch(
                batch.values[idx], batch.flow_id[idx], batch.seq[idx],
                batch.segment_id[idx], epoch=batch.epoch,
            )
            del idx
            if s in self._crash_at and s not in self._dead:
                # A doomed shard's history (virtual segment ids: the local
                # numbering changes at failover), up to the replay bound.
                self._retain_replay(s, sub)
            self._timed_ingest(s, self._localize(sub))
            del sub

    def _localize(self, sub: WireBatch) -> WireBatch:
        """``sub`` with its virtual segment ids renumbered into the owning
        server's local ports."""
        return WireBatch(
            sub.values, sub.flow_id, sub.seq, self._local_of_dev[sub.segment_id],
            epoch=sub.epoch,
        )

    def _retain_replay(self, s: int, sub: WireBatch) -> None:
        """Append ``sub`` (whole packets, virtual segment ids) to shard
        ``s``'s bounded replay buffer.  Packets beyond the bound are counted
        as lost, and that shard's crash then refuses the failover."""
        starts = sub.packet_starts()
        n = int(starts.numel())
        if self._replay_cap is not None:
            room = max(self._replay_cap - self._replay_len[s], 0)
            if n > room:
                self._replay_lost[s] += n - room
                if not room:
                    return
                sub = sub.slice_keys(0, int(starts[room]))
                n = room
        self._replay[s].append(sub)
        self._replay_len[s] += n

    def _crash(self, s: int) -> None:
        """Kill shard ``s``: the nearest alive shard adopts its segments and
        re-ingests its history from the replay buffer, in the original
        order, which rebuilds the dead shard's per-segment state exactly."""
        if s in self._dead:
            return
        alive = [t for t in range(self.num_servers) if t != s and t not in self._dead]
        if not alive:
            raise ValueError(
                f"server{s} crashed with no alive server left to adopt its "
                "shard — an unsurvivable fault plan"
            )
        if self._replay_lost.get(s, 0):
            raise ValueError(
                f"server{s} crashed but its replay buffer (capacity "
                f"{self._replay_cap} packets) had dropped "
                f"{self._replay_lost[s]} packets — shard unrecoverable; "
                "raise replay_packets"
            )
        t = min(alive, key=lambda a: (abs(a - s), a))
        self._dead.add(s)
        self.servers_failed_over += 1
        vsegs = np.flatnonzero(self._affinity == s)
        self._tr.instant(
            f"fault:server{s}", cat="fault", packets_seen=self._packets_seen,
            virtual_segments=[int(v) for v in vsegs],
        )
        self._tr.instant(f"reroute:server{s}->server{t}", cat="fault")
        if self._metrics is not None:
            self._metrics.counter("pool_failovers", f"server{s}").inc()
        if vsegs.size:
            # The adopted segments get fresh ports after the adopter's own;
            # its outputs are no longer one key range: it k-way merges.
            base = self.servers[t].num_segments
            self.servers[t].grow(int(vsegs.size))
            self._local_of[vsegs] = base + np.arange(vsegs.size, dtype=np.int64)
            self._local_of_dev = torch.from_numpy(self._local_of).to(self.device)
            self._affinity[vsegs] = t
            self.servers[t].final_merge = True
        history = self._replay.pop(s, [])
        self._replay_len.pop(s, None)
        self._crash_at.pop(s, None)
        # Cascade: an adopter that is itself doomed keeps the victim's
        # history in its own replay buffer, so a second failover rebuilds
        # the first victim's segments too.
        adopter_doomed = t in self._crash_at
        for sub in history:
            if adopter_doomed:
                self._retain_replay(t, sub)
            self._timed_ingest(t, self._localize(sub))

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
        in virtual-segment order, as from a single server.  Crashes
        scheduled past the end of the stream fire first."""
        for _at, s in sorted(
            (at, s) for s, at in self._crash_at.items() if s not in self._dead
        ):
            self._crash(s)
        outs: list[torch.Tensor] = []
        per_server_passes: list[list[int]] = []
        for s, server in enumerate(self.servers):
            if s in self._dead:
                outs.append(torch.zeros(0, dtype=torch.int64, device=self.device))
                per_server_passes.append([])
                continue
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
            output = pool_concat(outs, disjoint=self.num_epochs == 1 and not self._dead,
                                 backend=self.pool_backend)
            _sync(self.device)
        self.merge_seconds = t.seconds
        if self._metrics is not None:
            self._metrics.gauge("pool_server_keys").set(self.server_keys)
            self._metrics.gauge("pool_imbalance").set(self.server_imbalance)
        return output, passes

    # -- observability --------------------------------------------------
    @property
    def max_reorder_depth(self) -> int:
        return max((s.max_reorder_depth for s in self.servers), default=0)

    @property
    def dup_packets_dropped(self) -> int:
        """Retransmit duplicates dropped across the pool (recovery mode)."""
        return sum(s.dup_packets_dropped for s in self.servers)

    @property
    def spilled_packets(self) -> int:
        """Packets fed out of band on reorder overflow, pool-wide."""
        return sum(s.spilled_packets for s in self.servers)

    @property
    def spilled_keys(self) -> int:
        """Keys carried by spilled packets, pool-wide."""
        return sum(s.spilled_keys for s in self.servers)

    @property
    def server_keys(self) -> list[int]:
        """Keys ingested per server (the pool's load distribution); a dead
        shard reports 0, its load moved to the adopter."""
        return [0 if s in self._dead else srv.keys_ingested
                for s, srv in enumerate(self.servers)]

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
