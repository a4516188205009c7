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
Loss recovery (``recovery=True``: duplicate drop, reorder-overflow spill)
and the metrics registry are a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..core.mergesort import merge_runs, merge_runs_batched, merge_runs_flat
from ..core.runs import RunArena, merge_passes
from ..obs.trace import NULL_TRACER, check_tracer
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
        if recovery:
            raise NotImplementedError(
                "server loss recovery (recovery=True) is not ported yet "
                "(later slice: net/server recovery and spill)"
            )
        if metrics is not None:
            raise NotImplementedError(
                "the metrics registry is not ported yet (later slice: obs/metrics)"
            )
        check_tracer(tracer)
        self.device = resolve_device(device)
        self.num_segments = num_segments
        self.k = k
        self.reorder_capacity = reorder_capacity
        self.final_merge = final_merge
        self.merge_backend = merge_backend
        self.name = name
        self.lane = lane
        self._tr = tracer or NULL_TRACER
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
        if seq < self._next_seq[sid] or seq in buf:
            raise ValueError(f"duplicate packet seg={sid} seq={seq}")
        buf[seq] = payload
        depth = len(buf)
        self.max_reorder_depth = max(self.max_reorder_depth, depth)
        if self.reorder_capacity is not None and depth > self.reorder_capacity:
            raise ValueError(
                f"reorder buffer overflow on segment {sid}: {depth} "
                f"packets buffered, capacity {self.reorder_capacity}"
            )
        self._drain(sid)

    def _drain(self, sid: int) -> None:
        """Advance the in-order cursor over the buffered packets."""
        buf = self._pending[sid]
        while self._next_seq[sid] in buf:
            nxt = self._next_seq[sid]
            self._next_seq[sid] = nxt + 1
            self._feed(sid, buf.pop(nxt))

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
        if self._pending[sid]:
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
            if self._pending[sid]:
                have = set(self._pending[sid])
                missing = [
                    q for q in range(self._next_seq[sid], max(have) + 1)
                    if q not in have
                ]
                raise ValueError(
                    f"{self.name}: segment {sid}: stream incomplete — "
                    f"missing seqs {_format_seq_ranges(missing)} "
                    f"(next expected {self._next_seq[sid]}, "
                    f"{len(self._pending[sid])} buffered)"
                )
        with self._tr.span(f"{self.name}:finish", cat="server", tid=self.lane):
            return self._finish_body()

    def _finish_body(self) -> tuple[torch.Tensor, list[int]]:
        tr = self._tr
        outs: list[torch.Tensor] = []
        passes: list[int] = []
        if self._arenas is not None:
            for sid in range(self.num_segments):
                arena = self._arenas[sid]
                if len(arena):
                    starts, lengths = arena.run_offsets()
                    with tr.span(
                        f"merge:seg{sid}", cat="server", tid=self.lane,
                        keys=len(arena), runs=int(lengths.numel()),
                    ):
                        outs.append(
                            merge_runs_flat(arena.keys, starts, lengths, tid=self.lane)
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
                    merge_runs_batched(outs, tid=self.lane)
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

