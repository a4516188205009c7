"""The paper's three evaluation traces, synthesized from a seed (§6).

Counterpart of :mod:`repro.data.traces`, kept as the port's own copy: the
same numpy ``default_rng`` draws, so every seed gives the same bytes.

The paper uses (a) a uniform random trace with 100M values and 32,768 unique
values, (b) CAIDA packet lengths (100M values, 1,475 uniques), (c) SNIA
SYSTOR'17 IO sizes (77M values, 368 uniques).  CAIDA/SNIA are not
redistributable, so these traces match the properties the paper identifies
as what drives its results (§6.3): the unique-value count and the heavy
skew of the real traces.

* ``random_trace`` — uniform over 32,768 uniques (paper's own generator).
* ``network_trace`` — packet lengths: tri-modal (TCP acks ~40-64B, mid-size,
  MTU-limited ~1460-1500B) + Zipf tail over 1,475 distinct lengths.
* ``memory_trace`` — IO sizes: power-of-two-aligned block sizes (512B..1MB)
  with Zipf popularity over 368 distinct sizes, plus short bursts of repeats
  (sequential IO), which gives the long pre-existing runs the paper observes.
"""

from __future__ import annotations

import numpy as np

RANDOM_UNIQUES = 32_768
NETWORK_UNIQUES = 1_475
MEMORY_UNIQUES = 368

# Default size of the reference's traces (the paper's are 100M / 100M / 77M).
DEFAULT_N = 4_000_000


def random_trace(n: int = DEFAULT_N, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, RANDOM_UNIQUES, size=n, dtype=np.int64)


def network_trace(n: int = DEFAULT_N, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Distinct packet lengths 40..1514 → 1475 uniques.
    lengths = np.arange(40, 40 + NETWORK_UNIQUES, dtype=np.int64)
    # Tri-modal mass: acks, mid, MTU; Zipf-ish tail elsewhere.
    w = 1.0 / (np.arange(1, NETWORK_UNIQUES + 1) ** 1.1)
    rng.shuffle(w)
    w[:30] += 40.0      # ack-sized burst (40-69B)
    w[600:650] += 5.0   # mid-size mode
    w[-40:] += 60.0     # MTU-limited mode (~1474-1514B)
    w /= w.sum()
    return rng.choice(lengths, size=n, p=w)


def memory_trace(n: int = DEFAULT_N, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # 368 distinct IO sizes: multiples of 512B up to ~184KB.
    sizes = (np.arange(1, MEMORY_UNIQUES + 1, dtype=np.int64)) * 512
    w = 1.0 / (np.arange(1, MEMORY_UNIQUES + 1) ** 1.3)
    # 4K/8K/64K/128K page- and block-aligned spikes.
    for hot in (8, 16, 128, 256):
        if hot <= MEMORY_UNIQUES:
            w[hot - 1] += 3.0
    w /= w.sum()
    draws = rng.choice(sizes, size=n, p=w)
    # Sequential-IO bursts: repeat the previous size with p=0.3 (gives the
    # pre-existing runs the paper's memory trace exhibits).
    rep = rng.random(n) < 0.3
    rep[0] = False
    idx = np.arange(n)
    idx[rep] = 0
    np.maximum.accumulate(idx, out=idx)
    return draws[idx]


TRACES = {
    "random": random_trace,
    "network": network_trace,
    "memory": memory_trace,
}


def trace_max_value(name: str) -> int:
    return {
        "random": RANDOM_UNIQUES - 1,
        "network": 40 + NETWORK_UNIQUES - 1,
        "memory": MEMORY_UNIQUES * 512,
    }[name]
