"""Streaming computation server: sort overlapped with packet arrival.

Counterpart of :mod:`repro.net.server`.  A :class:`StreamingServer` keeps,
per segment (port number), a bounded reorder buffer keyed by the packets'
per-segment sequence numbers, incremental natural-run detection across
packet boundaries, and one of two run-merge engines:

* ``"numpy"`` -- the eager k-way ladder: closed runs enter level 0 and every
  ``k`` runs of a level merge one level up with :func:`merge_runs` (tensor
  ``searchsorted`` + scatter merges on the keys' device; the name is the
  reference's);
* ``"arena"`` -- each segment's runs are adjacent slices of one device
  buffer (:class:`repro_torch.core.runs.RunArena`), merged at drain time by
  :func:`repro_torch.core.mergesort.merge_runs_flat`, i.e. kernel K2.

Keys stay on the device.  :meth:`StreamingServer.ingest_batch` copies the
per-packet header arrays (one entry per packet) to the host once per batch
for the reorder logic; the keys of every in-order segment move in one
device gather.  Output and pass counts are byte-identical to the reference.

With ``recovery=True`` the server heals a lossy wire (the raw egress link of
:mod:`repro_torch.net.timing`) instead of refusing it: duplicate sequence
numbers are counted and dropped, and when the bounded reorder buffer
overflows the youngest buffered packet is *spilled* -- fed out of band to the
run detector -- with its seq remembered so the in-order cursor steps over it
and late copies still dedupe.  A segment that sees a duplicate, a spill or
any reordering leaves the columnar fast path for the per-packet one.
``metrics`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry`) receives
the reference's server counters, gauges, run-length histogram and the
``reorder_depth`` series.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.mergesort import merge_runs, merge_runs_batched, merge_runs_flat
from ..core.runs import RunArena, merge_passes, run_starts
from ..obs.trace import NULL_TRACER
from .packet import Packet
from .wire import WireBatch, ragged_gather

#: Run-merge engines a streaming server can drain with.
MERGE_BACKENDS = ("numpy", "arena")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class StreamingServer:
    """Consumes tagged packets incrementally; emits the global sort."""

    def __init__(
        self,
        num_segments: int,
        k: int = 10,
        reorder_capacity: int | None = None,
        final_merge: bool = False,
        merge_backend: str = "numpy",
        *,
        recovery: bool = False,
        tracer=None,
        metrics=None,
        name: str = "server0",
        lane: int = 1,
        device="cuda",
    ) -> None:
        if num_segments <= 0:
            raise ValueError("num_segments must be positive")
        if merge_backend not in MERGE_BACKENDS:
            raise ValueError(
                f"unknown merge_backend {merge_backend!r}; "
                f"options: {', '.join(MERGE_BACKENDS)}"
            )
        self.device = resolve_device(device)
        self.num_segments = num_segments
        self.k = k
        self.reorder_capacity = reorder_capacity
        self.final_merge = final_merge
        self.merge_backend = merge_backend
        self.recovery = recovery
        self.name = name
        self.lane = lane
        self._tr = tracer or NULL_TRACER
        self._metrics = metrics
        # Run lengths buffer here as plain ints; one histogram observe at
        # finish() keeps the per-run path free of registry lookups.
        self._run_len_buf: list[int] = []
        S = num_segments
        self._pending: list[dict[int, torch.Tensor]] = [{} for _ in range(S)]
        self._next_seq = [0] * S
        self._cur: list[list[torch.Tensor]] = [[] for _ in range(S)]
        self._tail: list[int | None] = [None] * S
        self._levels: list[list[list[torch.Tensor]]] = [[] for _ in range(S)]
        self._run_count = [0] * S
        self._arenas: list[RunArena] | None = (
            [RunArena(device=self.device) for _ in range(S)]
            if merge_backend == "arena"
            else None
        )
        self._ingested = 0
        self.max_reorder_depth = 0
        # Recovery state: seqs spilled out of band, kept until the in-order
        # cursor passes them so that late duplicates still dedupe.
        self._spilled: list[set[int]] = [set() for _ in range(S)]
        self.dup_packets_dropped = 0
        self.spilled_packets = 0
        self.spilled_keys = 0

    @property
    def keys_ingested(self) -> int:
        """Keys fed past the reorder buffer so far."""
        return self._ingested

    def grow(self, m: int) -> None:
        """Append ``m`` fresh segments (ports) after the server's own."""
        if m <= 0:
            raise ValueError("grow() needs a positive segment count")
        self.num_segments += m
        self._pending.extend({} for _ in range(m))
        self._next_seq.extend([0] * m)
        self._cur.extend([] for _ in range(m))
        self._tail.extend([None] * m)
        self._levels.extend([] for _ in range(m))
        self._run_count.extend([0] * m)
        self._spilled.extend(set() for _ in range(m))
        if self._arenas is not None:
            self._arenas.extend(RunArena(device=self.device) for _ in range(m))

    # -- ingestion ------------------------------------------------------
    def ingest(self, packet: Packet) -> None:
        self._ingest_payload(
            packet.segment_id, packet.seq, packet.payload.to(self.device)
        )

    def _ingest_payload(self, sid: int, seq: int, payload: torch.Tensor) -> None:
        if not 0 <= sid < self.num_segments:
            raise ValueError(f"packet with invalid segment id {sid}")
        buf = self._pending[sid]
        if seq < self._next_seq[sid] or seq in buf or seq in self._spilled[sid]:
            if self.recovery:
                # A retransmit whose original also made it: count and drop.
                self.dup_packets_dropped += 1
                if self._metrics is not None:
                    self._metrics.counter("server_dup_packets", self.name).inc()
                return
            raise ValueError(f"duplicate packet seg={sid} seq={seq}")
        buf[seq] = payload
        depth = len(buf)
        self.max_reorder_depth = max(self.max_reorder_depth, depth)
        if self._metrics is not None:
            # Timeline of buffer occupancy, x = keys ingested so far.
            self._metrics.series("reorder_depth", self.name).append(self._ingested, depth)
        if self.reorder_capacity is not None and depth > self.reorder_capacity:
            if not self.recovery:
                raise ValueError(
                    f"reorder buffer overflow on segment {sid}: {depth} "
                    f"packets buffered, capacity {self.reorder_capacity}"
                )
            # In-order progress may relieve the pressure before any spill.
            self._drain(sid)
            while len(buf) > self.reorder_capacity:
                self._spill(sid)
        self._drain(sid)

    def _drain(self, sid: int) -> None:
        """Advance the in-order cursor: feed buffered packets, step over
        spilled seqs (their keys are already in the run detector)."""
        buf = self._pending[sid]
        spilled = self._spilled[sid]
        while True:
            nxt = self._next_seq[sid]
            if nxt in buf:
                self._next_seq[sid] = nxt + 1
                self._feed(sid, buf.pop(nxt))
            elif spilled and nxt in spilled:
                spilled.discard(nxt)
                self._next_seq[sid] = nxt + 1
            else:
                return

    def _spill(self, sid: int) -> None:
        """Evict the youngest buffered packet out of band (recovery mode):
        its keys go straight to the run detector, whose run-break rule keeps
        the merge's inputs sorted -- the cost is shorter runs, never a
        different output."""
        buf = self._pending[sid]
        seq = max(buf)
        arr = buf.pop(seq)
        self._spilled[sid].add(seq)
        self.spilled_packets += 1
        self.spilled_keys += int(arr.numel())
        if self._metrics is not None:
            self._metrics.counter("server_spilled_packets", self.name).inc()
            self._metrics.counter("server_spilled_keys", self.name).inc(int(arr.numel()))
        self._feed(sid, arr)

    def ingest_batch(self, batch: WireBatch) -> None:
        """Consume a columnar wire batch.

        Every segment whose packets arrive in sequence order is fed with one
        device gather; segments that saw reordering go through the
        per-packet reorder buffer, byte-identical to :meth:`ingest`.
        """
        n = len(batch)
        if n == 0:
            return
        with self._tr.span(
            f"{self.name}:ingest", cat="server", tid=self.lane, keys=n
        ):
            self._ingest_batch_body(batch, n)

    def _ingest_batch_body(self, batch: WireBatch, n: int) -> None:
        starts_d = batch.packet_starts()
        # The per-packet headers, once per batch, for the reorder logic.
        starts = _host(starts_d)
        bounds = np.concatenate([starts, [n]])
        sizes = np.diff(bounds)
        sids_p = _host(batch.segment_id[starts_d])
        seqs_p = _host(batch.seq[starts_d])
        if sids_p.min() < 0 or sids_p.max() >= self.num_segments:
            bad = int(sids_p.min()) if sids_p.min() < 0 else int(sids_p.max())
            raise ValueError(f"packet with invalid segment id {bad}")
        dev = batch.device
        slow: list[int] = []
        for s in np.unique(sids_p):
            s = int(s)
            pmask = sids_p == s
            seqs = seqs_p[pmask]
            # A zero-capacity buffer rejects even in-order packets; the slow
            # path raises the same overflow error as per-packet ingest.
            in_order = (
                (self.reorder_capacity is None or self.reorder_capacity >= 1)
                and not self._pending[s]
                and not self._spilled[s]
                and np.array_equal(
                    seqs,
                    np.arange(self._next_seq[s], self._next_seq[s] + seqs.size),
                )
            )
            if not in_order:
                slow.append(s)
                continue
            self.max_reorder_depth = max(self.max_reorder_depth, 1)
            self._next_seq[s] += int(seqs.size)
            sel_sizes = sizes[pmask]
            idx = ragged_gather(
                torch.from_numpy(starts[pmask]).to(dev),
                torch.from_numpy(sel_sizes).to(dev),
                int(sel_sizes.sum()),
            )
            self._feed(s, batch.values[idx])
        if slow:
            slow_set = set(slow)
            for s, q, a, b in zip(sids_p, seqs_p, bounds[:-1], bounds[1:]):
                if int(s) in slow_set:
                    self._ingest_payload(int(s), int(q), batch.values[int(a) : int(b)])

    def ingest_segment(self, sid: int, values: torch.Tensor, run_starts=None) -> None:
        """Whole-segment in-order handoff from the device epoch.

        ``values`` is the segment's complete emission-order stream for the
        epoch -- what the reorder buffer would have reassembled from the
        segment's packets -- so the packet machinery is skipped.
        ``run_starts`` (payload-relative, ``run_starts[0] == 0``, best on the
        host) carries the run boundaries the device already detected; the
        arena backend takes them through
        :meth:`~repro_torch.core.runs.RunArena.feed_runs`, the ladder
        re-detects them.  Byte-identical to ingesting the same stream packet
        by packet in order."""
        m = int(values.numel())
        if m == 0:
            return
        if sid < 0 or sid >= self.num_segments:
            raise ValueError(f"packet with invalid segment id {sid}")
        if self._pending[sid] or self._spilled[sid]:
            raise ValueError(
                f"segment {sid} has buffered packets; the grouped handoff "
                "requires a clean in-order stream"
            )
        with self._tr.span(f"{self.name}:ingest", cat="server", tid=self.lane, keys=m):
            # The packet path would have held one packet at a time.
            self.max_reorder_depth = max(self.max_reorder_depth, 1)
            if run_starts is not None and self._arenas is not None:
                self._ingested += m
                self._arenas[sid].feed_runs(values, run_starts)
            else:
                self._feed(sid, values)

    def _feed(self, sid: int, arr: torch.Tensor) -> None:
        """Continue natural-run detection over one in-order payload."""
        if arr.numel() == 0:
            return
        self._ingested += int(arr.numel())
        if self._arenas is not None:
            self._arenas[sid].feed(arr)
            return
        tail = self._tail[sid]
        if tail is not None and int(arr[0]) < tail:
            self._close_run(sid)
        breaks = _host(torch.nonzero(arr[1:] < arr[:-1]).reshape(-1) + 1)
        parts = torch.tensor_split(arr, breaks.tolist())
        for chunk in parts[:-1]:
            self._cur[sid].append(chunk)
            self._close_run(sid)
        self._cur[sid].append(parts[-1])
        self._tail[sid] = int(parts[-1][-1])

    def _close_run(self, sid: int) -> None:
        if not self._cur[sid]:
            return
        cur = self._cur[sid]
        run = cur[0] if len(cur) == 1 else torch.cat(cur)
        self._cur[sid] = []
        self._tail[sid] = None
        self._run_count[sid] += 1
        if self._metrics is not None:
            self._run_len_buf.append(int(run.numel()))
        self._push_run(sid, run, 0)

    def _push_run(self, sid: int, run: torch.Tensor, depth: int) -> None:
        levels = self._levels[sid]
        while len(levels) <= depth:
            levels.append([])
        levels[depth].append(run)
        if len(levels[depth]) == self.k:
            with self._tr.span(
                f"ladder:L{depth}", cat="server", tid=self.lane, runs=self.k
            ):
                merged = merge_runs(levels[depth])
            levels[depth] = []
            self._push_run(sid, merged, depth + 1)

    # -- completion -----------------------------------------------------
    def finish(self) -> tuple[torch.Tensor, list[int]]:
        """Drain state; return ``(globally sorted stream, passes/segment)``."""
        for sid in range(self.num_segments):
            # A spilled seq the cursor never passed means an earlier packet
            # never arrived: recovery dedupes and reorders, it never invents
            # keys, so a genuine loss still fails here.
            if self._pending[sid] or self._spilled[sid]:
                have = set(self._pending[sid]) | self._spilled[sid]
                missing = [
                    q for q in range(self._next_seq[sid], max(have) + 1)
                    if q not in have
                ]
                raise ValueError(
                    f"{self.name}: segment {sid}: stream incomplete — "
                    f"missing seqs {_format_seq_ranges(missing)} "
                    f"(next expected {self._next_seq[sid]}, "
                    f"{len(self._pending[sid])} buffered, "
                    f"{len(self._spilled[sid])} spilled out of band)"
                )
        with self._tr.span(f"{self.name}:finish", cat="server", tid=self.lane):
            out, passes = self._finish_body()
        m = self._metrics
        if m is not None:
            if self._run_len_buf:
                m.histogram("server_run_length", self.name).observe_many(
                    np.asarray(self._run_len_buf, dtype=np.int64)
                )
                self._run_len_buf = []
            m.gauge("server_keys_ingested", self.name).set(self._ingested)
            m.gauge("server_max_reorder_depth", self.name).set(self.max_reorder_depth)
            m.gauge("server_merge_passes", self.name).set(list(passes))
            m.counter("server_runs_detected", self.name).inc(
                sum(a.num_runs for a in self._arenas)
                if self._arenas is not None
                else sum(self._run_count)
            )
        return out, passes

    def _finish_body(self) -> tuple[torch.Tensor, list[int]]:
        tr = self._tr
        outs: list[torch.Tensor] = []
        passes: list[int] = []
        if self._arenas is not None:
            for sid in range(self.num_segments):
                arena = self._arenas[sid]
                if len(arena):
                    starts, lengths = arena.run_offsets()
                    if self._metrics is not None:
                        self._metrics.histogram("server_run_length", self.name).observe_many(lengths)
                        self._metrics.gauge("server_arena_fill", self.name).high_water(len(arena))
                    with tr.span(
                        f"merge:seg{sid}", cat="server", tid=self.lane,
                        keys=len(arena), runs=int(lengths.numel()),
                    ):
                        outs.append(
                            merge_runs_flat(
                                arena.keys, starts, lengths,
                                tracer=tr if tr.enabled else None, tid=self.lane,
                            )
                        )
                passes.append(merge_passes(arena.num_runs, self.k))
        else:
            for sid in range(self.num_segments):
                self._close_run(sid)
                remaining = [r for level in self._levels[sid] for r in level]
                if remaining:
                    with tr.span(
                        f"merge:seg{sid}", cat="server", tid=self.lane,
                        runs=len(remaining),
                    ):
                        outs.append(merge_runs(remaining))
                passes.append(merge_passes(self._run_count[sid], self.k))
        if not outs:
            out = torch.zeros(0, dtype=torch.int64, device=self.device)
        elif self.final_merge:
            with tr.span("merge:final", cat="server", tid=self.lane, runs=len(outs)):
                out = (
                    merge_runs_batched(outs, tracer=tr if tr.enabled else None, tid=self.lane)
                    if self._arenas is not None
                    else merge_runs(outs)
                )
        else:
            out = torch.cat(outs)
        if out.numel() != self._ingested:
            raise AssertionError(
                f"{self.name}: merged {out.numel()} keys of {self._ingested} ingested"
            )
        return out.to(torch.int64), passes


def _format_seq_ranges(seqs: list[int]) -> str:
    """Compress a sorted seq list into range notation: ``[3-5, 9]``."""
    if not seqs:
        return "[]"
    parts: list[str] = []
    lo = prev = seqs[0]
    for q in seqs[1:]:
        if q == prev + 1:
            prev = q
            continue
        parts.append(str(lo) if lo == prev else f"{lo}-{prev}")
        lo = prev = q
    parts.append(str(lo) if lo == prev else f"{lo}-{prev}")
    return "[" + ", ".join(parts) + "]"


def stream_sort(
    packets: list[Packet],
    num_segments: int,
    k: int = 10,
    reorder_capacity: int | None = None,
    device="cuda",
) -> tuple[torch.Tensor, list[int]]:
    """One-shot convenience: ingest every packet, then finish."""
    server = StreamingServer(
        num_segments, k=k, reorder_capacity=reorder_capacity, device=device
    )
    for p in packets:
        server.ingest(p)
    return server.finish()


def plain_runs_upper_bound(values: torch.Tensor, k: int) -> int:
    """Passes a switchless server would need on the raw stream (baseline)."""
    return merge_passes(int(run_starts(torch.as_tensor(values)).numel()), k)
