"""INT-style in-band telemetry columns that ride the wire to egress.

Counterpart of :mod:`repro.obs.telemetry`.  With ``int_telemetry=True`` every
hop of the fused engine stamps three per-key columns onto the
:class:`~repro_torch.net.wire.WireBatch` flowing through it:

``hop_id``
    which fabric node processed the key at this depth (the INT switch id);
``queue_depth``
    how many keys of the key's segment were resident in the hop's switch
    memory when the key was emitted, capped at the 2·L pipeline size;
``rank_ticks``
    the key's insertion rank within its segment at this hop.

Each column is an ``(n, d)`` int64 tensor on the batch's device -- row = key,
column = hop depth -- held in an immutable :class:`IntColumns`.  Every row
gather the batch undergoes applies to the stack too, so the telemetry never
detaches from its keys.  :func:`int_summary` aggregates the stack into the
per-(depth, hop) report, equal to the reference's; it reads one small
tensor per depth level.
"""

from __future__ import annotations

import dataclasses

import torch

#: Column names, in storage order, of the per-hop INT metadata stack.
INT_FIELDS = ("hop_id", "queue_depth", "rank_ticks")


def _as_matrix(a, n: int, d: int, name: str, device) -> torch.Tensor:
    m = torch.as_tensor(a, dtype=torch.int64, device=device)
    if tuple(m.shape) != (n, d):
        raise ValueError(f"{name} must have shape {(n, d)}, got {tuple(m.shape)}")
    return m


@dataclasses.dataclass(frozen=True, eq=False)
class IntColumns:
    """The per-key INT metadata stack: three ``(n, d)`` int64 tensors on one
    device.  :meth:`stamp` returns a new stack one column deeper."""

    hop_id: torch.Tensor
    queue_depth: torch.Tensor
    rank_ticks: torch.Tensor

    def __post_init__(self):
        hid = torch.as_tensor(self.hop_id)
        if hid.dim() != 2:
            raise ValueError(f"hop_id must be 2-D, got shape {tuple(hid.shape)}")
        n, d = hid.shape
        for name in INT_FIELDS:
            object.__setattr__(
                self, name, _as_matrix(getattr(self, name), n, d, name, hid.device)
            )

    # -- shape ----------------------------------------------------------
    def __len__(self) -> int:
        return int(self.hop_id.shape[0])

    @property
    def depth(self) -> int:
        """Number of hops stamped onto these keys so far."""
        return int(self.hop_id.shape[1])

    @property
    def device(self) -> torch.device:
        return self.hop_id.device

    @classmethod
    def empty(cls, n: int, depth: int = 0, device="cpu") -> "IntColumns":
        z = torch.zeros((n, depth), dtype=torch.int64, device=device)
        return cls(hop_id=z, queue_depth=z.clone(), rank_ticks=z.clone())

    # -- key-following transforms ---------------------------------------
    def take(self, idx) -> "IntColumns":
        """Row gather: the same permutation or selection as the keys."""
        return IntColumns(**{name: getattr(self, name)[idx] for name in INT_FIELDS})

    def slice(self, lo: int, hi: int) -> "IntColumns":
        return IntColumns(**{name: getattr(self, name)[lo:hi] for name in INT_FIELDS})

    @staticmethod
    def concat(parts: list["IntColumns"]) -> "IntColumns":
        """Stack row-wise; every part must be at the same hop depth."""
        if not parts:
            return IntColumns.empty(0)
        depths = {p.depth for p in parts}
        if len(depths) > 1:
            raise ValueError(
                f"cannot concat IntColumns at different hop depths: {sorted(depths)}"
            )
        return IntColumns(
            **{name: torch.cat([getattr(p, name) for p in parts]) for name in INT_FIELDS}
        )

    # -- stamping -------------------------------------------------------
    def stamp(self, hop_id: int, queue_depth, rank_ticks) -> "IntColumns":
        """Append one hop's metadata column; returns a depth+1 stack."""
        n = len(self)
        dev = self.device
        qd = torch.as_tensor(queue_depth, dtype=torch.int64, device=dev).reshape(n, 1)
        rt = torch.as_tensor(rank_ticks, dtype=torch.int64, device=dev).reshape(n, 1)
        hid = torch.full((n, 1), int(hop_id), dtype=torch.int64, device=dev)
        return IntColumns(
            hop_id=torch.cat([self.hop_id, hid], dim=1),
            queue_depth=torch.cat([self.queue_depth, qd], dim=1),
            rank_ticks=torch.cat([self.rank_ticks, rt], dim=1),
        )

    # -- reporting ------------------------------------------------------
    def summary(self) -> list[dict]:
        """Per-(depth, hop_id) aggregates: how many keys each fabric node
        saw at each depth and the mean and max of its stamps.

        Each level's sums and maxima come back in one small read.  The means
        divide exact integer sums, which is what numpy's float64 mean of the
        same integers gives (every partial sum is exact below 2**53)."""
        rows = []
        for level in range(self.depth):
            hids = self.hop_id[:, level]
            qd = self.queue_depth[:, level]
            rt = self.rank_ticks[:, level]
            uniq = torch.unique(hids)
            agg = torch.stack([
                torch.stack([
                    m.sum(),
                    torch.where(m, qd, 0).sum(), torch.where(m, qd, torch.iinfo(torch.int64).min).max(),
                    torch.where(m, rt, 0).sum(), torch.where(m, rt, torch.iinfo(torch.int64).min).max(),
                ])
                for m in (hids == h for h in uniq)
            ]).cpu().tolist()
            for hid, (keys, qsum, qmax, rsum, rmax) in zip(uniq.cpu().tolist(), agg):
                rows.append(
                    {
                        "depth": int(level),
                        "hop_id": int(hid),
                        "keys": int(keys),
                        "mean_queue_depth": qsum / keys,
                        "max_queue_depth": int(qmax),
                        "mean_rank_ticks": rsum / keys,
                        "max_rank_ticks": int(rmax),
                    }
                )
        return rows


def int_summary(cols: "IntColumns | None") -> list[dict]:
    """:meth:`IntColumns.summary`, tolerating a batch with no telemetry."""
    return [] if cols is None or len(cols) == 0 else cols.summary()
