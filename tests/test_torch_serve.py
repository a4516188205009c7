"""The port's serve path (configs, LM, engine, sampler, CLI) against the JAX
package's, on the CPU.

The reference models are the smoke configs of ``mistral-nemo-12b`` (dense)
and of the two MoE models, ``granite-moe-3b-a800m`` and ``deepseek-moe-16b``
(with its leading dense layer), built with ``local_ctx()`` and initialised
from ``PRNGKey(0)``; their weights are carried into the port with
``params_from_reference``.  At float32 the logits agree within atol/rtol
1e-4 and the greedy tokens are identical.  At bfloat16 the two frameworks
round at other places (matmul accumulation, the reference's bf16 attention
probabilities against the port's f32 ones, the MoE's f32 sum of expert
outputs against the reference's bf16 adds), so logits, which are O(4) here,
are held within atol 0.1 (a few bf16 steps at that size) and rtol 2e-2, and
tokens are not compared with the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread a worker)

from repro import models as ref_models
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.distributed.sharding import local_ctx
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import Request as RefRequest
from repro.serve.sampler import SampleConfig as RefSampleConfig
from repro.serve.sampler import sample as ref_sample
from repro_torch import configs, models
from repro_torch.kernels import build as kbuild
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampler import SampleConfig, sample

ARCH = "mistral-nemo-12b"
MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=0.1, rtol=2e-2)}


@functools.lru_cache(maxsize=None)
def _build_pair(arch: str, dtype: str):
    """(cfg, reference model, reference params, port model) sharing weights."""
    cfg = dataclasses.replace(ref_get_smoke(arch), dtype=dtype)
    ref = ref_models.build(cfg, local_ctx())
    params = ref.init(jax.random.PRNGKey(0))
    port = models.build(dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype), device="cpu")
    port.load_state_dict(params_from_reference(jax.tree.map(np.asarray, params)))
    return cfg, ref, params, port


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return _build_pair(ARCH, request.param)


@pytest.fixture(scope="module")
def pair32():
    return _build_pair(ARCH, "float32")


@pytest.fixture(scope="module", params=[(a, d) for a in MOE_ARCHS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def moe_pair(request):
    return _build_pair(*request.param)


def _close(port: torch.Tensor, ref, dtype: str) -> None:
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), **TOL[dtype])


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_config_copies_equal_the_reference(arch):
    for ours, theirs in ((configs.get_config(arch), ref_get_config(arch)),
                         (configs.get_smoke_config(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        assert ours.padded_vocab == theirs.padded_vocab
    assert configs.list_archs() == sorted(configs.ALIASES)


# -- weights carried across ----------------------------------------------------------


def test_params_from_reference_fills_every_weight_bit_for_bit(pair):
    cfg, _, params, port = pair
    state = params_from_reference(jax.tree.map(np.asarray, params))
    assert set(state) == set(port.state_dict())
    for i in (0, cfg.num_layers - 1):
        want = np.asarray(params["layers"]["attn"]["wq"][i]).astype(np.float32)
        got = port.layers[i].attn.wq.float().numpy()
        np.testing.assert_array_equal(got, want)
    assert port.embed.table.dtype == getattr(torch, cfg.dtype)


def test_moe_params_from_reference_fill_every_weight_bit_for_bit(moe_pair):
    """Expert slabs at the padded count, the f32 router, the shared experts
    and deepseek's leading dense layers (a list in the reference's tree)."""
    cfg, _, params, port = moe_pair
    state = params_from_reference(jax.tree.map(np.asarray, params))
    assert set(state) == set(port.state_dict())
    last = len(port.layers) - 1
    for name in ("w_in", "w_out", "router"):
        want = np.asarray(params["layers"]["moe"][name][last]).astype(np.float32)
        np.testing.assert_array_equal(getattr(port.layers[last].moe, name).float().numpy(), want)
    assert port.layers[0].moe.router.dtype == torch.float32
    n_dense = cfg.moe.first_dense_layers
    assert len(port.layers) == cfg.num_layers - n_dense
    if n_dense:
        want = np.asarray(params["dense_layers"][0]["mlp"]["w_in"]).astype(np.float32)
        np.testing.assert_array_equal(port.dense_layers[0].mlp.w_in.float().numpy(), want)
        assert port.dense_layers[0].mlp.w_in.shape[1] == cfg.moe.d_ff_dense
        np.testing.assert_array_equal(port.layers[0].moe.shared.w_gate.float().numpy(),
                                      np.asarray(params["layers"]["moe"]["shared"]["w_gate"][0]).astype(np.float32))


def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), d_model=256, d_ff=512, vocab_size=1024)
    m = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    blk = m.layers[0]
    for w, std in ((m.embed.table, 0.02), (blk.attn.wq, cfg.d_model**-0.5),
                   (blk.attn.wo, (H * hd) ** -0.5), (blk.mlp.w_out, cfg.d_ff**-0.5),
                   (m.head.w, cfg.d_model**-0.5)):
        assert abs(w.float().std().item() / std - 1) < 0.05
        assert abs(w.float().mean().item()) < 0.05 * std
    assert torch.equal(blk.ln1.scale, torch.ones(cfg.d_model))
    again = models.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[2].mlp.w_gate, m.layers[2].mlp.w_gate)


# -- prefill and decode ------------------------------------------------------------


def test_prefill_logits_and_caches_match_reference(pair):
    _check_prefill(pair)


def test_moe_prefill_logits_and_caches_match_reference(moe_pair):
    _check_prefill(moe_pair)


def _check_prefill(pair):
    cfg, ref, params, port = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want, rcache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, ref.init_cache(2, 32))
    got, pcache = port.prefill(torch.from_numpy(toks), port.init_cache(2, 32))
    assert got.shape == (2, cfg.vocab_size)
    _close(got, want, cfg.dtype)
    assert set(pcache) == set(rcache)  # k_dense/v_dense for deepseek's dense layer
    for key in set(rcache) - {"pos"}:
        assert tuple(pcache[key].shape) == rcache[key].shape
        _close(pcache[key], rcache[key], cfg.dtype)
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(rcache["pos"]))


def test_six_decode_steps_match_reference(pair):
    _check_decode(pair)


def test_moe_six_decode_steps_match_reference(moe_pair):
    """Decode batches of 3 tokens meet a capacity of one slot per expert:
    the order inside each expert's group decides what is dropped."""
    _check_decode(moe_pair)


def _check_decode(pair):
    cfg, ref, params, port = pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(3, 5)).astype(np.int32)
    _, rcache = ref.prefill(params, {"tokens": jnp.asarray(toks)}, ref.init_cache(3, 16))
    _, pcache = port.prefill(torch.from_numpy(toks), port.init_cache(3, 16))
    tok = toks[:, -1]
    for _ in range(6):
        want, rcache = ref.decode_step(params, rcache, jnp.asarray(tok))
        got, pcache = port.decode_step(pcache, torch.from_numpy(tok))
        _close(got, want, cfg.dtype)
        tok = np.argmax(np.asarray(want, np.float32), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(rcache["pos"]))
    for key in set(rcache) - {"pos"}:
        _close(pcache[key], rcache[key], cfg.dtype)


# -- the engine --------------------------------------------------------------------


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, size=k).tolist() for k in (3, 5, 2, 7, 4)]


def _generate_alone(port, prompt, n):
    cache = port.init_cache(1, 64)
    if len(prompt) > 1:
        _, cache = port.prefill(torch.tensor([prompt[:-1]]), cache)
    tok, out = prompt[-1], []
    for _ in range(n):
        logits, cache = port.decode_step(cache, torch.tensor([tok]))
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
    return out


def test_engine_greedy_matches_reference_engine_token_for_token(pair32):
    cfg, ref, params, port = pair32
    ref_eng = RefEngine(ref, params, slots=2, max_len=64, sample_cfg=RefSampleConfig(temperature=0.0))
    eng = Engine(port, slots=2, max_len=64, sample_cfg=SampleConfig(temperature=0.0), device="cpu")
    for i, p in enumerate(_prompts(cfg)):
        ref_eng.add(RefRequest(rid=i, prompt=p, max_tokens=6))
        eng.add(Request(rid=i, prompt=p, max_tokens=6))
    want = [(r.rid, r.out) for r in ref_eng.run()]
    got = [(r.rid, r.out) for r in eng.run()]
    assert got == want
    assert len(got) == 5 and all(len(out) == 6 for _, out in got)


@pytest.mark.parametrize("arch,slots", [("granite-moe-3b-a800m", 2), ("deepseek-moe-16b", 3)])
def test_moe_engine_greedy_matches_reference_engine_token_for_token(arch, slots):
    """Every decode step routes all slots' tokens (idle slots too) into one
    capacity slot per expert, so drops decide tokens.  The slot count differs
    from every cache stack's depth (granite 3 layers; deepseek 1 dense + 2
    MoE): the reference engine's ``_reset_slot``/``_graft`` take axis 0 as
    the slot axis of any cache leaf whose first dimension equals the slot
    count (R2 in ROADMAP.md)."""
    cfg, ref, params, port = _build_pair(arch, "float32")
    ref_eng = RefEngine(ref, params, slots=slots, max_len=64, sample_cfg=RefSampleConfig(temperature=0.0))
    eng = Engine(port, slots=slots, max_len=64, sample_cfg=SampleConfig(temperature=0.0), device="cpu")
    for i, p in enumerate(_prompts(cfg)):
        ref_eng.add(RefRequest(rid=i, prompt=p, max_tokens=6))
        eng.add(Request(rid=i, prompt=p, max_tokens=6))
    want = [(r.rid, r.out) for r in ref_eng.run()]
    got = [(r.rid, r.out) for r in eng.run()]
    assert got == want
    assert len(got) == 5 and all(len(out) == 6 for _, out in got)


def test_engine_batched_equals_alone_in_both_types(pair):
    """Continuous batching changes no request's greedy output (bf16 too)."""
    cfg, _, _, port = pair
    eng = Engine(port, slots=2, max_len=64, device="cpu")
    prompts = _prompts(cfg)
    for i, p in enumerate(prompts):
        eng.add(Request(rid=i, prompt=p, max_tokens=6))
    finished = {r.rid: r.out for r in eng.run()}
    for i, p in enumerate(prompts):
        assert finished[i] == _generate_alone(port, p, 6)


def test_engine_eos_frees_slot_and_queue_backfills(pair32):
    cfg, ref, params, port = pair32
    first = _generate_alone(port, [5, 7], 1)[0]
    runs = []
    for make_eng, make_req in (
        (lambda: Engine(port, slots=1, max_len=64, device="cpu"), Request),
        (lambda: RefEngine(ref, params, slots=1, max_len=64,
                           sample_cfg=RefSampleConfig(temperature=0.0)), RefRequest),
    ):
        eng = make_eng()
        eng.add(make_req(rid=0, prompt=[5, 7], max_tokens=10, eos=first))
        eng.add(make_req(rid=1, prompt=[3, 2, 1], max_tokens=3))
        runs.append([(r.rid, r.out, r.done) for r in eng.run()])
    got, want = runs
    assert got == want
    assert got[0] == (0, [first], True)  # stopped at eos, freeing the one slot
    assert got[1][0] == 1 and len(got[1][1]) == 3  # backfilled from the queue


# -- the sampler ---------------------------------------------------------------------


def test_sampler_greedy_topk_and_topp():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[1.0, 5.0, 2.0, -1.0]])
    assert sample(logits, gen, SampleConfig(temperature=0.0)).tolist() == [1]
    assert sample(logits, gen, SampleConfig(temperature=0.0)).dtype == torch.int32
    # top-k = 1 is greedy whatever the temperature
    assert sample(logits, gen, SampleConfig(temperature=1.0, top_k=1)).tolist() == [1]
    seen = {sample(logits, gen, SampleConfig(temperature=1.0, top_k=2)).item() for _ in range(64)}
    assert seen == {1, 2}
    # one dominant logit: top_p = 0.5 keeps only it
    dom = torch.tensor([[10.0, 0.0, 0.0, 0.0]])
    assert {sample(dom, gen, SampleConfig(temperature=1.0, top_p=0.5)).item() for _ in range(16)} == {0}
    # a batch: each row draws from its own head
    two = torch.tensor([[0.0, 9.0, 9.0, -9.0], [9.0, -9.0, -9.0, 9.0]])
    for _ in range(16):
        a, b = sample(two, gen, SampleConfig(temperature=1.0, top_k=2)).tolist()
        assert a in (1, 2) and b in (0, 3)
    # the same seed gives the same draws
    draws = [sample(two, torch.Generator().manual_seed(3), SampleConfig(temperature=2.0)).tolist()
             for _ in range(2)]
    assert draws[0] == draws[1]


def test_sampler_agrees_with_reference_where_it_is_deterministic():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 300)).astype(np.float32)
    want = np.asarray(ref_sample(jnp.asarray(logits), jax.random.PRNGKey(0), RefSampleConfig(temperature=0.0)))
    got = sample(torch.from_numpy(logits), None, SampleConfig(temperature=0.0)).numpy()
    np.testing.assert_array_equal(got, want)
    # top-k membership: every draw lies in the reference's top-k set
    k = 7
    _, top = jax.lax.top_k(jnp.asarray(logits), k)
    top = np.asarray(top)
    gen = torch.Generator().manual_seed(1)
    for _ in range(8):
        draw = sample(torch.from_numpy(logits), gen, SampleConfig(temperature=1.5, top_k=k)).numpy()
        assert all(draw[i] in top[i] for i in range(5))


# -- the CLI and what is not ported yet ---------------------------------------------------


def test_serve_cli_runs_on_cpu(capsys):
    kbuild.reset_launches()
    finished = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                               "--slots", "2", "--max-tokens", "4", "--max-len", "32"])
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert all(len(r.out) == 4 and r.done for r in finished)
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    assert kbuild.LAUNCHES["flash_attention"] == 0 and kbuild.LAUNCHES["decode_attention"] == 0


def test_serve_cli_runs_moe_on_cpu(capsys):
    """The MoE CLI on the CPU: the dispatch runs K3's plain version, so no
    kernel launches."""
    kbuild.reset_launches()
    finished = serve_cli.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
                               "--requests", "3", "--slots", "2", "--max-tokens", "4", "--max-len", "32"])
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert all(len(r.out) == 4 and r.done for r in finished)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    assert not any(kbuild.LAUNCHES.values())


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_other_families_build_on_a_mesh(arch):
    """The encoder-decoder and the embeddings model build on one device and
    on a mesh above 1x1 (tp 2 here), each leaf the rank's shard by its
    ``leaf_spec``."""
    import _torch_dist_workers as workers
    from repro_torch.distributed.sharding import ShardCtx

    cfg = configs.get_smoke_config(arch)
    assert models.build(cfg, device="cpu").cfg.name == arch
    model = workers.shards_at_spec(cfg, ShardCtx.grid(model=(1, 2)))
    assert model.embed.table.shape[0] == cfg.padded_vocab // 2


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
@pytest.mark.parametrize("entry", ["engine", "serve_cli", "train_cli"])
def test_families_the_reference_cannot_serve_or_train_are_refused(entry, arch):
    """The reference's engine prefills tokens alone, its serve CLI refuses
    the encoder-decoder and its training CLI's token pipeline carries no
    embeddings: the port refuses all three up front for both families."""
    from repro_torch.launch import train as train_cli

    argv = ["--arch", arch, "--smoke", "--device", "cpu"]
    if entry == "engine":
        with pytest.raises(ValueError, match="token prompts of a decoder-only model"):
            Engine(models.build(configs.get_smoke_config(arch), device="cpu"), device="cpu")
    elif entry == "serve_cli":
        with pytest.raises(SystemExit, match="decoder-only|token prompts"):
            serve_cli.main(argv)
    else:
        with pytest.raises(SystemExit, match="token pipeline carries no embeddings"):
            train_cli.main(argv + ["--steps", "1"])


def test_training_forward_is_not_ported(pair32):
    """The name is older than the training slice: the forward now exists and
    gives the reference's ``LM.forward`` logits and aux (f32, 1e-4)."""
    cfg, ref, params, port = pair32
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want, want_aux = ref.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = port(torch.from_numpy(toks))
    _close(got, want, "float32")
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6)
