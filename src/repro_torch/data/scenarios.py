"""Beyond-paper workload scenarios: the traffic the paper never swept.

Counterpart of :mod:`repro.data.scenarios`, kept as the port's own copy: the
same numpy ``default_rng`` draws, so every seed gives the same bytes (a torch
generator would give other bits).  Each generator dials one axis the paper's
three traces leave fixed, with the contract of
:mod:`repro_torch.data.traces`: deterministic for a seed, int64 keys in
``[0, scenario_max_value(name)]``.

* ``sorted90`` / ``sorted50`` -- the sortedness dial: a fraction of keys sit
  in globally sorted position, the rest are shuffled among themselves.
* ``adversarial_skew`` -- almost all mass on a handful of hot keys at the top
  of the domain: the worst case for equal-width ranges, the easy case for
  quantile splitters.
* ``duplicate_heavy`` -- a handful of distinct values; correctness must come
  from the merge, not the partition.
* ``drifting`` -- the key distribution marches across the domain in phases;
  any ranges fixed from a prefix go stale mid-stream (the case the adaptive
  control plane, :mod:`repro_torch.net.control`, exists for).
* ``near_sorted_outliers`` -- an almost-sorted stream with a sprinkle of
  far-displaced keys.
"""

from __future__ import annotations

import numpy as np

#: Shared key domain for every scenario: keys lie in [0, SCENARIO_DOMAIN).
SCENARIO_DOMAIN = 1 << 16

DEFAULT_N = 1_000_000


def sortedness_dial(
    n: int = DEFAULT_N, sortedness: float = 0.9, seed: int = 0
) -> np.ndarray:
    """Sorted stream with a ``1 - sortedness`` fraction shuffled in place.

    ``sortedness=1`` is fully sorted (one run); ``0`` is a uniform shuffle.
    Displaced keys swap only among themselves, so the dial moves disorder
    without changing the value distribution.
    """
    if not 0.0 <= sortedness <= 1.0:
        raise ValueError("sortedness must be in [0, 1]")
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, SCENARIO_DOMAIN, size=n, dtype=np.int64))
    k = int(round(n * (1.0 - sortedness)))
    if k >= 2:
        pos = rng.choice(n, size=k, replace=False)
        vals[pos] = vals[rng.permutation(pos)]
    return vals


def adversarial_skew(
    n: int = DEFAULT_N,
    seed: int = 0,
    hot_keys: int = 4,
    hot_mass: float = 0.95,
) -> np.ndarray:
    """``hot_mass`` of the stream on ``hot_keys`` keys at the domain top.

    Equal-width ranges put every hot key in the last segment (imbalance ≈
    number of segments); balanced splitters isolate each hot key.
    """
    if not 0.0 < hot_mass < 1.0:
        raise ValueError("hot_mass must be in (0, 1)")
    rng = np.random.default_rng(seed)
    hot = SCENARIO_DOMAIN - 1 - rng.choice(
        SCENARIO_DOMAIN // 64, size=hot_keys, replace=False
    ).astype(np.int64)
    out = rng.integers(0, SCENARIO_DOMAIN, size=n, dtype=np.int64)
    mask = rng.random(n) < hot_mass
    out[mask] = hot[rng.integers(0, hot_keys, size=int(mask.sum()))]
    return out


def duplicate_heavy(
    n: int = DEFAULT_N, seed: int = 0, uniques: int = 8
) -> np.ndarray:
    """Low-cardinality stream: ``uniques`` distinct keys, Zipf popularity."""
    if uniques < 1:
        raise ValueError("uniques must be >= 1")
    rng = np.random.default_rng(seed)
    keys = np.sort(
        rng.choice(SCENARIO_DOMAIN, size=uniques, replace=False)
    ).astype(np.int64)
    w = 1.0 / np.arange(1, uniques + 1, dtype=np.float64)
    w /= w.sum()
    return keys[rng.choice(uniques, size=n, p=w)]


def drifting(
    n: int = DEFAULT_N, seed: int = 0, phases: int = 4
) -> np.ndarray:
    """Distribution marches across the domain in ``phases`` disjoint bands.

    Phase ``p`` draws uniformly from band ``p`` of the domain, so ranges
    estimated during any prefix are wrong for every later phase — the
    scenario the adaptive control plane's epoch handoff targets.
    """
    if phases < 1:
        raise ValueError("phases must be >= 1")
    rng = np.random.default_rng(seed)
    band = SCENARIO_DOMAIN // phases
    base, extra = divmod(n, phases)
    parts = []
    for p in range(phases):
        lo = p * band
        hi = SCENARIO_DOMAIN if p == phases - 1 else lo + band
        size = base + (1 if p < extra else 0)
        parts.append(rng.integers(lo, hi, size=size, dtype=np.int64))
    return np.concatenate(parts)


def near_sorted_outliers(
    n: int = DEFAULT_N, seed: int = 0, outlier_frac: float = 0.01
) -> np.ndarray:
    """Sorted stream with ``outlier_frac`` of keys replaced by uniform noise.

    Unlike the sortedness dial, outliers take *new* values anywhere in the
    domain — long runs survive, but every run boundary a switch emits must
    tolerate far-displaced keys.
    """
    if not 0.0 <= outlier_frac <= 1.0:
        raise ValueError("outlier_frac must be in [0, 1]")
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.integers(0, SCENARIO_DOMAIN, size=n, dtype=np.int64))
    k = int(round(n * outlier_frac))
    if k:
        pos = rng.choice(n, size=k, replace=False)
        vals[pos] = rng.integers(0, SCENARIO_DOMAIN, size=k)
    return vals


def _with_sortedness(s: float):
    return lambda n=DEFAULT_N, seed=0: sortedness_dial(n, s, seed)


#: name -> generator(n, seed=...) with the same calling shape as data.TRACES.
SCENARIOS = {
    "sorted90": _with_sortedness(0.9),
    "sorted50": _with_sortedness(0.5),
    "adversarial_skew": adversarial_skew,
    "duplicate_heavy": duplicate_heavy,
    "drifting": drifting,
    "near_sorted_outliers": near_sorted_outliers,
}


def scenario_max_value(name: str) -> int:
    """Domain upper bound for a scenario (uniform across the suite)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; options: {sorted(SCENARIOS)}")
    return SCENARIO_DOMAIN - 1
