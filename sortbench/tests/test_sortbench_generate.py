"""The traffic generator repeats from the seed and keeps each mix's shape."""

from __future__ import annotations

import pytest
import torch

from sortbench import generate
from sortbench.harness import load_json
from sortbench.tests.conftest import ROOT

MIXES = {p.stem: load_json(p) for p in sorted((ROOT / "sortbench" / "traffic").glob("*.json"))}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_keys_repeat_from_the_seed(mix):
    a = generate.job_keys(MIXES[mix], 5000, 2147483659, 3, device="cpu")
    b = generate.job_keys(MIXES[mix], 5000, 2147483659, 3, device="cpu")
    assert torch.equal(a, b)
    assert a.dtype == torch.int64 and a.numel() == 5000
    assert int(a.min()) >= 0 and int(a.max()) < int(MIXES[mix]["domain"])
    for other in (dict(job=4), dict(rank=1), dict(seed=2147483660)):
        kw = dict(seed=2147483659, job=3, rank=0) | other
        assert not torch.equal(a, generate.job_keys(MIXES[mix], 5000, device="cpu", **kw))


def test_every_job_draws_fresh_keys():
    mix = MIXES["random"]
    a = generate.job_keys(mix, 100_000, 7, 0, device="cpu")
    b = generate.job_keys(mix, 100_000, 7, 1, device="cpu")
    assert not torch.equal(torch.sort(a).values, torch.sort(b).values)
    counts = torch.bincount(a, minlength=mix["domain"])
    assert int(counts.min()) >= 0 and float(counts.double().std()) > 0.5  # independent draws, not one multiset


def test_sorted_fraction_keeps_most_keys_in_place():
    mix = MIXES["sorted90"]
    n = 200_000
    keys = generate.job_keys(mix, n, 11, 0, device="cpu")
    base = torch.sort(keys).values
    in_place = float((keys == base).double().mean())
    assert 0.9 <= in_place < 0.95  # displaced keys can land on an equal value
    assert not torch.equal(keys, base)


def test_iid_wide_keys_use_the_high_bits():
    keys = generate.job_keys(MIXES["uniform64"], 4096, 5, 0, device="cpu")
    assert int(keys.max()) > 1 << 62
    assert int(keys.min()) >= 0


def test_payload_is_full_width_and_repeats():
    p = generate.job_payload(2, 4096, 9, 1, device="cpu")
    assert p.shape == (4096, 2) and p.dtype == torch.int64
    assert torch.equal(p, generate.job_payload(2, 4096, 9, 1, device="cpu"))
    assert int(p.min()) < -(1 << 62) and int(p.max()) > 1 << 62
    assert generate.job_payload(0, 4096, 9, 1, device="cpu") is None


def test_sample_index_and_seeds():
    assert generate.sample_index(3, 4) == generate.sample_index(3, 4)
    assert 0 <= generate.sample_index(2**31 + 77, 4) < 4
    seeds = {generate.mix_seed(2147483659, j) for j in range(-2, 50)}
    assert len(seeds) == 52 and all(0 <= s < 1 << 63 for s in seeds)
