"""Deterministic, resumable synthetic token pipeline.

The port's own numpy copy of :mod:`repro.data.tokens`: byte-identical
batches and the same ``state()``/``restore()``.  LM batches come from a
seeded Markov-ish token stream.  The cursor (``state()``) is part of every
checkpoint, so restarts resume mid-epoch with no repeated or skipped batches.
Batches are laid out host-side (numpy int32); the caller moves them to its
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def restore(cls, vocab_size: int, batch: int, seq: int, state: dict):
        return cls(
            vocab_size, batch, seq,
            seed=int(state["seed"]), step=int(state["step"]),
        )

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, step))

    def next_batch(self) -> dict:
        """{"tokens": (B, T) int32, "labels": (B, T) int32}.

        Markov chain with a banded transition structure so the loss has
        learnable signal (tests assert loss decreases)."""
        rng = self._rng(self.step)
        self.step += 1
        B, T, V = self.batch, self.seq, self.vocab_size
        toks = np.empty((B, T + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        jumps = rng.integers(-3, 4, size=(B, T))
        resets = rng.random((B, T)) < 0.05
        fresh = rng.integers(0, V, size=(B, T))
        for t in range(T):
            nxt = (toks[:, t] + jumps[:, t]) % V
            toks[:, t + 1] = np.where(resets[:, t], fresh[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
