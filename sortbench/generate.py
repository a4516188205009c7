"""The one traffic generator: a sort job's keys and payload from a mix file.

A traffic mix (``sortbench/traffic/<mix>.json``) is data only:

* ``domain`` -- every job draws fresh keys, independent and uniform over
  ``[0, domain)``;
* ``shuffled_fraction`` -- 1.0 leaves the draws in their random order;
  below 1 the keys are sorted and that fraction of positions, drawn
  without replacement, is permuted among itself (the sortedness dial of the
  program's ``data/scenarios.py``, with the displaced keys swapping only
  among themselves).

The configuration adds ``payload_columns`` full-width random int64 columns
(every bit drawn), so a run that narrowed the records would not sort right.

Every draw comes from a ``torch.Generator`` on the job's device, seeded from
``(seed, job, rank, stream)`` alone: the same arguments give the same
tensors, and no job shares a draw with another.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1
_INT63 = (1 << 63) - 1


def mix_seed(*parts: int) -> int:
    """A 63-bit generator seed from any whole numbers (splitmix64 steps)."""
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (int(p) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x ^= x >> 31
    return x & _INT63


def _gen(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix_seed(*parts))


def random_int64(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` int64 values with all 64 bits uniform (random bytes, viewed)."""
    raw = torch.randint(0, 256, (n * 8,), dtype=torch.uint8, generator=gen, device=device)
    return raw.view(torch.int64)


def uniform_keys(n: int, domain: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` independent uniform int64 keys in ``[0, domain)``."""
    if domain <= 0:
        raise ValueError("domain must be positive")
    if domain <= 1 << 62:
        return torch.randint(0, domain, (n,), dtype=torch.int64, generator=gen, device=device)
    # Wider domains: 63 random bits, reduced; the bias is below 2**-62.
    return (random_int64(n, gen, device) & _INT63).remainder_(domain)


def job_keys(mix: dict, n: int, seed: int, job: int, rank: int = 0, device="cuda") -> torch.Tensor:
    """Job ``job``'s ``n`` int64 keys on ``rank`` under ``mix``."""
    domain = int(mix["domain"])
    frac = float(mix["shuffled_fraction"])
    if not 0.0 <= frac <= 1.0:
        raise ValueError("shuffled_fraction must be in [0, 1]")
    gen = _gen(device, seed, job, rank, 1)
    keys = uniform_keys(n, domain, gen, device)
    if frac == 1.0:
        return keys
    keys = torch.sort(keys).values
    k = int(round(n * frac))
    if k >= 2:
        pos = torch.randperm(n, generator=gen, device=device)[:k]
        keys[pos] = keys[pos[torch.randperm(k, generator=gen, device=device)]]
    return keys


def job_payload(columns: int, n: int, seed: int, job: int, rank: int = 0, device="cuda"):
    """Job ``job``'s ``(n, columns)`` full-width int64 payload, or None."""
    if columns <= 0:
        return None
    gen = _gen(device, seed, job, rank, 2)
    return random_int64(n * columns, gen, device).view(n, columns)


def sample_index(seed: int, bound: int) -> int:
    """A number in ``[0, bound)`` drawn from ``seed`` (the judged job)."""
    return mix_seed(seed, 3) % bound


def strided_sample(keys: torch.Tensor, per_rank: int) -> torch.Tensor:
    """The control plane's sample of one rank's keys: ``per_rank`` keys at a
    stride of ``n // per_rank``."""
    stride = max(1, keys.numel() // per_rank)
    return keys[::stride][:per_rank].contiguous()
