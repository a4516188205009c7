"""Control plane: the range tables every hop of a fabric shares.

Counterpart of :mod:`repro.net.control`, in its three range modes:
``"static"`` (paper Alg. 2, equal width), ``"oracle"`` (full-data quantile
splitters) and ``"sampled"`` -- the :class:`AdaptiveControlPlane`, which
bootstraps on equal-width ranges, samples the live stream into a
:class:`ReservoirSampler`, installs estimated quantile ranges after a warmup
prefix and re-partitions again when a recent-traffic window shows the
installed ranges have drifted out of balance.  A re-partition closes an
*epoch*: keys already in the fabric keep their routing, and the servers
k-way merge the per-(epoch, segment) outputs, so a bad estimate costs
balance, never correctness.

The plane is host code.  Its decisions are a loop over packets with one
numpy ``default_rng`` draw set per payload -- every draw decides the
reservoir, so the loop and the generator stay the reference's, draw for
draw.  :meth:`AdaptiveControlPlane.split_epochs` copies the batch's keys and
packet starts to the host once and loops there; the epochs it returns are
views of the batch's device columns.  Range tables come back as int64 CPU
tensors from the port's :func:`~repro_torch.core.partition.quantile_ranges`
and :func:`~repro_torch.core.partition.set_ranges`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.partition import load_imbalance, quantile_ranges, set_ranges
from ..obs.trace import NULL_TRACER

#: The range modes ``run_pipeline`` takes.
RANGE_MODES = ("oracle", "sampled", "static")


def ranges_valid(ranges: torch.Tensor, num_segments: int, max_value: int) -> bool:
    """Whether a range table is safe to program into the fabric: rows of
    ``[lo, hi)`` that start at 0, are non-empty and contiguous, and cover
    the key domain."""
    r = torch.as_tensor(ranges)
    if tuple(r.shape) != (num_segments, 2):
        return False
    lo, hi = r[:, 0], r[:, 1]
    if int(lo[0]) != 0 or int(hi[-1]) < int(max_value) + 1:
        return False
    if not bool(torch.all(hi > lo)):
        return False
    return bool(torch.all(lo[1:] == hi[:-1]))


@dataclasses.dataclass(frozen=True)
class ControlPlane:
    """One-shot control plane: ``mode="width"`` is Alg. 2, ``"quantile"``
    the balanced splitters from a bounded sample (drawn with numpy's
    ``default_rng``, as in the reference, so the sample is the same)."""

    mode: str = "width"
    sample_size: int = 4096
    seed: int = 0

    def ranges(
        self, values: torch.Tensor, num_segments: int, max_value: int
    ) -> torch.Tensor:
        if self.mode == "width":
            return set_ranges(max_value, num_segments, device=values.device)
        if self.mode == "quantile":
            if values.numel() > self.sample_size:
                rng = np.random.default_rng(self.seed)
                pick = rng.choice(values.numel(), size=self.sample_size, replace=False)
                values = values[torch.from_numpy(pick).to(values.device)]
            return quantile_ranges(values, num_segments, max_value)
        raise ValueError(f"unknown control-plane mode {self.mode!r}")


class ReservoirSampler:
    """Bounded uniform sample of an unbounded key stream (Algorithm R).

    ``offer`` is vectorized over packet payloads: the fill phase copies, the
    steady state keeps arrival ``t`` (0-based) with probability ``cap/(t+1)``
    into a uniformly random slot.  Batched slot assignment lets later writes
    within one payload shadow earlier ones — the sample stays uniform to
    within one payload, which is far below what the splitter needs.
    Deterministic for a fixed seed, like every other randomized piece of the
    harness.
    """

    def __init__(self, capacity: int = 4096, seed: int = 0) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._buf = np.empty(capacity, dtype=np.int64)
        self._fill = 0
        self._seen = 0

    @property
    def seen(self) -> int:
        """Total keys offered so far."""
        return self._seen

    def offer(self, values: np.ndarray) -> None:
        v = np.asarray(values, dtype=np.int64).ravel()
        if v.size == 0:
            return
        if self._fill < self.capacity:
            take = min(self.capacity - self._fill, v.size)
            self._buf[self._fill : self._fill + take] = v[:take]
            self._fill += take
            self._seen += take
            v = v[take:]
            if v.size == 0:
                return
        t = self._seen + np.arange(v.size)
        keep = self._rng.random(v.size) * (t + 1) < self.capacity
        if keep.any():
            slots = self._rng.integers(0, self.capacity, size=v.size)
            self._buf[slots[keep]] = v[keep]
        self._seen += v.size

    def snapshot(self) -> np.ndarray:
        """Copy of the current sample (≤ capacity keys)."""
        return self._buf[: self._fill].copy()


class AdaptiveControlPlane:
    """Estimates balanced segment ranges from the live packet stream.

    Lifecycle, driven by the pipeline one payload at a time:

    1. ``bootstrap_ranges()`` installs equal-width ranges (Alg. 2 — the only
       thing computable before traffic exists) and opens epoch 1.
    2. ``observe(payload)`` feeds the reservoir and a sliding
       ``recent_window`` of the newest keys; it returns ``True`` when the
       current epoch should close.  The first handoff fires once ``warmup``
       keys have been seen; later handoffs fire when, re-checked every
       ``check_every`` keys, the installed ranges' load imbalance on the
       recent window exceeds ``rebalance_factor ×`` what freshly estimated
       ranges would achieve (distribution drift).
    3. ``propose()`` returns the next epoch's ranges — from the whole-prefix
       reservoir at the warmup handoff (the distribution so far), from the
       recent window at drift handoffs (the distribution *now*) — and
       ``install()`` commits them, opening the next epoch.

    ``max_epochs`` caps the number of installed range-sets (bootstrap
    included), bounding re-partition churn the way a real control plane
    rate-limits table rewrites.
    """

    def __init__(
        self,
        num_segments: int,
        max_value: int,
        *,
        sample_capacity: int = 4096,
        warmup: int = 4096,
        recent_window: int = 4096,
        check_every: int = 4096,
        rebalance_factor: float = 2.0,
        max_epochs: int = 4,
        seed: int = 0,
        tracer=None,
        metrics=None,
        label: str = "",
    ) -> None:
        if num_segments <= 0:
            raise ValueError("num_segments must be positive")
        if max_value < 0:
            raise ValueError("max_value must be non-negative")
        if warmup <= 0 or recent_window <= 0 or check_every <= 0:
            raise ValueError("warmup/recent_window/check_every must be positive")
        if max_epochs < 1:
            raise ValueError("max_epochs must be >= 1")
        self.num_segments = num_segments
        self.max_value = max_value
        self.warmup = warmup
        self.recent_window = recent_window
        self.check_every = check_every
        self.rebalance_factor = rebalance_factor
        self.max_epochs = max_epochs
        self.reservoir = ReservoirSampler(sample_capacity, seed)
        self._tr = tracer or NULL_TRACER
        self._metrics = metrics
        # Emitting-site label for the observability plane — the multi-tenant
        # scheduler sets it per job so each tenant's control-plane counters
        # and trace instants stay distinguishable on a shared fabric.
        self.label = label
        self.installed: torch.Tensor | None = None
        self.epoch = 0  # number of installed range-sets
        self._since_check = 0
        self._recent_chunks: list[np.ndarray] = []
        self._recent_total = 0
        self._pending: np.ndarray | None = None  # drift proposal from observe()

    # -- sliding window -------------------------------------------------
    def _push_recent(self, v: np.ndarray) -> None:
        self._recent_chunks.append(v)
        self._recent_total += v.size
        while (
            self._recent_chunks
            and self._recent_total - self._recent_chunks[0].size
            >= self.recent_window
        ):
            self._recent_total -= self._recent_chunks[0].size
            self._recent_chunks.pop(0)

    def recent(self) -> np.ndarray:
        """The newest ≤ ``recent_window`` keys, oldest first."""
        if not self._recent_chunks:
            return np.zeros(0, dtype=np.int64)
        cat = np.concatenate(self._recent_chunks)
        return cat[-self.recent_window :]

    # -- lifecycle ------------------------------------------------------
    def bootstrap_ranges(self) -> torch.Tensor:
        """Epoch 1's ranges: equal-width (needs only the key domain)."""
        ranges = set_ranges(self.max_value, self.num_segments, device="cpu")
        self.install(ranges)
        return ranges

    def install(self, ranges) -> None:
        """Commit ``ranges`` as the fabric's routing for the next epoch."""
        ranges = torch.as_tensor(ranges, dtype=torch.int64).cpu()
        if tuple(ranges.shape) != (self.num_segments, 2):
            raise ValueError(
                f"ranges shape {tuple(ranges.shape)} != ({self.num_segments}, 2)"
            )
        self.installed = ranges
        self.epoch += 1
        self._since_check = 0
        self._pending = None
        self._tr.instant(
            "control:install", cat="control",
            epoch=self.epoch, keys_seen=self.reservoir.seen,
            **({"tenant": self.label} if self.label else {}),
        )
        if self._metrics is not None:
            self._metrics.counter("control_installs", self.label).inc()

    def observe(self, payload: np.ndarray) -> bool:
        """Feed one payload; return ``True`` when the epoch should close."""
        if self.installed is None:
            raise RuntimeError("observe() before bootstrap_ranges()")
        v = np.asarray(payload, dtype=np.int64).ravel()
        self.reservoir.offer(v)
        self._push_recent(v)
        self._since_check += v.size
        if self.epoch >= self.max_epochs:
            return False
        if self.epoch == 1:  # bootstrap epoch: hand off after the warmup
            if self.reservoir.seen >= self.warmup:
                self._handoff("warmup")
                return True
            return False
        if self._since_check < self.check_every:
            return False
        self._since_check = 0
        recent = self.recent()
        if recent.size < 4 * self.num_segments:  # too few keys to judge
            return False
        recent_t = torch.from_numpy(recent)
        cur = load_imbalance(recent_t, self.installed)
        proposed = quantile_ranges(recent_t, self.num_segments, self.max_value)
        best = load_imbalance(recent_t, proposed)
        if cur > self.rebalance_factor * max(best, 1.0):
            self._pending = proposed  # propose() reuses the scored ranges
            self._handoff("drift", imbalance=cur, achievable=best)
            return True
        return False

    def _handoff(self, kind: str, **args) -> None:
        """Record an epoch-close decision (warmup or drift) as telemetry."""
        self._tr.instant(
            f"control:handoff:{kind}", cat="control",
            epoch=self.epoch, keys_seen=self.reservoir.seen,
            **({"tenant": self.label} if self.label else {}), **args,
        )
        if self._metrics is not None:
            self._metrics.counter(f"control_{kind}_handoffs", self.label).inc()

    def propose(self) -> torch.Tensor:
        """Ranges for the next epoch (does not install them)."""
        if self._pending is not None:  # drift handoff: the ranges observe() scored
            return self._pending
        if self.epoch <= 1:
            sample = self.reservoir.snapshot()  # uniform over the prefix
        else:
            sample = self.recent()  # drift: what traffic looks like *now*
        if sample.size == 0:
            return set_ranges(self.max_value, self.num_segments, device="cpu")
        return quantile_ranges(torch.from_numpy(sample), self.num_segments, self.max_value)

    def pool_affinity(self, num_servers: int) -> np.ndarray:
        """Virtual-segment→server map for the epochs installed so far.

        Epoch handoff re-shards the fresh epoch's virtual segment ids onto
        the *same* contiguous affinity blocks
        (:func:`repro_torch.net.egress.segment_affinity`), so a pool server keeps
        its key-range lane across re-partitions — only the range boundaries
        move, never the segment→server wiring.  Length is
        ``num_segments * max(epoch, 1)``, matching the virtual id space the
        delivered wire carries after :meth:`split_epochs`.
        """
        from .egress import segment_affinity

        return np.tile(
            segment_affinity(self.num_segments, num_servers),
            max(self.epoch, 1),
        )

    def split_epochs(self, batch) -> list[tuple[torch.Tensor, "object"]]:
        """Partition an arrival :class:`~repro_torch.net.wire.WireBatch` into
        epochs on its columns.

        Drives the observe/propose/install lifecycle one payload at a time
        (the paper's switch reprograms between packets, never inside one),
        but the data path stays columnar: each epoch is a column slice
        ``[epoch start, last packet of the epoch]``, closed *after* the
        payload that triggered the handoff.  The keys and the packet starts
        come to the host once; the loop runs over numpy views of them, and
        runs to the end of the stream whatever the epoch count (the plane's
        reservoir and window see every payload, as in the reference).
        Returns ``[(ranges, sub-batch), ...]`` with at least one entry;
        empty epochs are dropped (keeping the first if all are).
        """
        n = len(batch)
        values = batch.values.cpu().numpy()
        starts = batch.packet_starts().cpu().numpy()
        bounds = np.concatenate([starts, [n]]).astype(np.int64)
        cur_ranges = self.bootstrap_ranges()
        epochs: list[tuple[torch.Tensor, object]] = []
        epoch_start = 0
        for a, b in zip(bounds[:-1], bounds[1:]):
            if self.observe(values[a:b]):
                nxt = self.propose()
                self.install(nxt)
                epochs.append((cur_ranges, batch.slice_keys(epoch_start, int(b))))
                cur_ranges = nxt
                epoch_start = int(b)
        epochs.append((cur_ranges, batch.slice_keys(epoch_start, n)))
        nonempty = [(r, sub) for r, sub in epochs if len(sub)]
        return nonempty or epochs[:1]
