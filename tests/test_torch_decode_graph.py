"""The serve engine's compiled decode step (the reference's
``jax.jit(model.decode_step)``), on the CPU.

On the card the engine captures ``decode_step`` into a CUDA graph when it
is built (``tests/test_torch_cuda.py`` holds its tokens to the eager
step's).  What the CPU can check: that the step never reads the device on
the host -- the dense and both MoE smoke models' ``decode_step`` run under
the host-read guard, which fails on every op that would break the capture
-- that the warm-up step the capture needs is undone before the first
request, that the CPU engine stays eager, and how a graph's kernel nodes
are told apart by name.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro_torch import configs, models
from repro_torch.kernels import build
from repro_torch.serve.engine import Engine, Request

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_host_reads import HostRead, NoHostReads  # noqa: E402

ARCHS = ["mistral-nemo-12b", "granite-moe-3b-a800m", "deepseek-moe-16b"]


def _model(arch: str, dtype: str = "float32"):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    return models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_on_the_host(arch, dtype):
    model = _model(arch, dtype)
    cache = model.init_cache(3, 16)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, model.cfg.vocab_size, (3, 5)))
    model.prefill(toks, cache)
    tokens = torch.tensor([1, 2, 3])
    with NoHostReads() as guard:
        for _ in range(2):
            logits, out = model.decode_step(cache, tokens)
    assert out is cache and logits.shape == (3, model.cfg.vocab_size)
    assert guard.seen["mm"] >= 1
    if model.cfg.moe is not None:
        assert guard.seen["searchsorted"] >= 1  # the dispatch ran under the guard


def test_guard_catches_a_host_read_in_a_step():
    """The guard would catch a step that reads a count on the host (what a
    ``dropped`` turned into an int would be)."""
    model = _model("granite-moe-3b-a800m")
    cache = model.init_cache(2, 16)
    with pytest.raises(HostRead):
        with NoHostReads():
            logits, _ = model.decode_step(cache, torch.tensor([1, 2]))
            int(logits.argmax())


def _serve(eng: Engine, prompts) -> list:
    for i, p in enumerate(prompts):
        eng.add(Request(rid=i, prompt=p, max_tokens=5))
    return sorted((r.rid, r.out) for r in eng.run())


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "granite-moe-3b-a800m"])
def test_warm_up_step_is_undone_before_the_first_request(arch):
    """The capture's warm-up is a real step (``pos`` advances, a k/v row is
    written in every slot); the engine zeroes the cache after it, in place.
    The same on the CPU: a warm-up step and the reset leave the first
    requests' tokens as they were."""
    model = _model(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=n).tolist() for n in (4, 6, 3)]
    want = _serve(Engine(model, slots=2, max_len=32, device="cpu"), prompts)
    eng = Engine(model, slots=2, max_len=32, device="cpu")
    model.decode_step(eng.cache, torch.zeros(2, dtype=torch.int64))
    assert eng.cache["pos"].tolist() == [1, 1]
    leaves = {k: v.data_ptr() for k, v in eng.cache.items()}
    eng._reset_cache()
    assert {k: v.data_ptr() for k, v in eng.cache.items()} == leaves  # never rebound
    assert all(not v.any() for v in eng.cache.values())
    assert _serve(eng, prompts) == want


def test_cpu_engine_stays_eager_and_counts_its_steps():
    model = _model("mistral-nemo-12b")
    eng = Engine(model, slots=2, max_len=32, device="cpu")
    assert eng.decode_graph is None
    out = _serve(eng, [[1, 2, 3], [4, 5]])
    assert eng.decode_steps == 5
    assert _serve(Engine(model, slots=2, max_len=32, device="cpu", _eager=True), [[1, 2, 3], [4, 5]]) == out


def test_kernel_node_names_are_told_apart():
    names = [
        "_ZN12_GLOBAL__N_115row_sort_kernelILi64ElEEvPKT0_PS2_xi",
        "_ZN12_GLOBAL__N_19flash_fwdIfEEvPKT_S3_S3_PS1_iiif",
        "_ZN12_GLOBAL__N_114flash_fwd_bf16ILi128EEEvPK13__nv_bfloat16S3_S3_PS1_iiif",
        "_ZN12_GLOBAL__N_114decode_partialI13__nv_bfloat16EEvPKT_S4_S4_PKiPfS7_iiiiiPKxf",
        "_ZN12_GLOBAL__N_112decode_mergeI13__nv_bfloat16EEvPKfS4_PKiPT_iiiiPKx",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long>>",
    ]
    got = build.count_entries(names, ["row_sort_kernel", "flash_fwd", "flash_fwd_bf16", "decode_partial",
                                      "decode_merge", "chunk_stages"])
    assert got == {"row_sort_kernel": 1, "flash_fwd": 1, "flash_fwd_bf16": 1, "decode_partial": 1,
                   "decode_merge": 1, "chunk_stages": 0, "all": 6}
