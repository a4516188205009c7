"""Workers of the port's multi-rank parity tests (``test_torch_sharded_sort.py``,
``test_torch_distributed.py``, ``test_torch_lm_sharded.py``,
``test_torch_context_parallel.py``, ``test_torch_recurrent_sharded.py``,
``test_torch_families_sharded.py``, ``test_torch_dryrun_ranks.py``).

Two kinds, both writing numpy arrays to ``.npz`` files that the tests compare:

* ``ref_sort`` / ``ref_dist`` / ``ref_lm_grads`` / ``ref_lm_rest`` /
  ``ref_cp_train`` / ``ref_cp_rest`` / ``ref_rec_grads`` / ``ref_rec_rest`` /
  ``ref_fam_grads`` / ``ref_fam_rest`` run the JAX package's sharded functions
  on fake CPU devices (``ref_cli`` and ``ref_cp_rest`` its CLIs).  They run in a subprocess started by
  :func:`start_reference` with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (the flag must not
  reach the test process):
  ``python tests/_torch_dist_workers.py ref_sort OUT.npz``.
* ``sort_rank`` / ``dist_rank`` / ``lm_rank`` / ``cp_rank`` /
  ``cp_fsdp_rank`` / ``rec_rank`` / ``fam_rank`` / ``dry_rank`` (and the CLI legs ``cli_*``, ``rec_one``) run one gloo rank of the
  port each, started by
  :func:`start_ranks` (``torch.multiprocessing.start_processes``, a
  ``file://`` rendezvous in the run's own directory, so parallel test
  workers never share a port); rank ``r`` writes ``rank{r}.npz`` and its
  output to ``rank{r}.log``.

Every run is bounded: :func:`join_ranks` and :func:`finish_reference` wait
up to a deadline, and on overrun kill every rank (or the subprocess) and
fail the test with their output, so a hung rank fails one test, never the
whole suite.

The inputs are made here from numpy seeds, so both sides see the same
arrays; each side computes its own splitters, mesh and results.  Imports of
jax, ``repro`` and ``repro_torch`` stay inside the functions of their side.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: Wall-clock limits of one multi-rank run and one reference subprocess (s).
RANKS_DEADLINE = 240
REFERENCE_DEADLINE = 300

WORLD = 8
N_SORT = 8 * 4096
POOL_SHARDS = [  # disjoint sorted ranges, one ragged and one empty; the last holds int64 max
    np.arange(0, 50, 3, dtype=np.int64),
    np.zeros(0, dtype=np.int64),
    np.arange(100, 107, dtype=np.int64),
    np.array([1000, 1 << 40, np.iinfo(np.int64).max], dtype=np.int64),
]
PIPE = dict(topology="leaf_spine", num_segments=8, segment_length=16, payload_size=64,
            num_flows=4, num_servers=4, merge_backend="numpy", seed=3)
PIPE_N = 6000
MOE_ARCH = "deepseek-moe-16b"
MOE_B, MOE_T = 2, 32
PP = dict(S=4, M=6, mb=8, d=32)
FSDP = dict(rows=8, cols=6, batch=12)


# -- shared inputs ------------------------------------------------------------------


def sort_cases() -> dict:
    """name -> (keys, splitter sample, capacity factor, presort block): the
    four cases of the reference's ``dist_sort_driver.py`` at its capacity
    factor, its tight-capacity overflow case, the presort at block 256 and
    at 96 (not a power of two), and keys holding the dtype's max (R6)."""
    rng = np.random.default_rng(0)
    n = N_SORT
    base = {
        "uniform": rng.integers(0, 1 << 20, size=n).astype(np.int32),
        "zipf": rng.zipf(1.3, size=n).clip(0, 1 << 20).astype(np.int32),
        "descending": np.sort(rng.integers(0, 999, size=n)).astype(np.int32)[::-1].copy(),
        "float32": rng.normal(size=n).astype(np.float32),
    }
    cases = {name: (x, x[:: max(1, x.size // 4096)], 8.0, None) for name, x in base.items()}
    cases["overflow"] = (base["descending"], base["descending"], 1.5, None)
    x = rng.integers(0, 1 << 16, size=n).astype(np.int32)
    cases["presort256"] = (x, x, 4.0, 256)
    cases["presort96"] = (x, x, 4.0, 96)
    x = rng.integers(0, 1 << 20, size=n).astype(np.int32)
    x[rng.choice(n, 300, replace=False)] = np.iinfo(np.int32).max
    cases["dtype_max"] = (x, x, 4.0, 256)
    return cases


def pipe_values() -> np.ndarray:
    return np.random.default_rng(5).integers(0, 1 << 16, size=PIPE_N).astype(np.int64)


def moe_input(d_model: int) -> np.ndarray:
    return (np.random.default_rng(1).standard_normal((MOE_B, MOE_T, d_model)) * 0.3).astype(np.float32)


def pp_inputs() -> dict:
    S, M, mb, d = PP["S"], PP["M"], PP["mb"], PP["d"]
    rng = np.random.default_rng(2)
    return {"w": (rng.standard_normal((S, d, d)) * d**-0.5).astype(np.float32),
            "b": (rng.standard_normal((S, d)) * 0.1).astype(np.float32),
            "xs": rng.standard_normal((M, mb, d)).astype(np.float32)}


def fsdp_inputs() -> dict:
    """``w`` sharded on dim 0, ``v`` on dim 1, ``b`` replicated; ``x`` the
    batch, split over the fsdp ranks."""
    r, c, nb = FSDP["rows"], FSDP["cols"], FSDP["batch"]
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((r, c)).astype(np.float32),
            "v": rng.standard_normal((c, r)).astype(np.float32),
            "b": rng.standard_normal((c,)).astype(np.float32),
            "x": rng.standard_normal((nb, r)).astype(np.float32)}


def moe_params(cfg) -> dict:
    """The MoE layer's parameters in the reference's tree, drawn with numpy
    at the reference's scales (router and slabs at the padded expert
    count)."""
    m, D = cfg.moe, cfg.d_model
    E, F, Fs = -(-m.num_experts // 16) * 16, m.d_expert, m.num_shared * m.d_expert
    rng = np.random.default_rng(6)

    def draw(*shape, fan_in):
        return (rng.standard_normal(shape) * fan_in**-0.5).astype(np.float32)

    return {"router": draw(D, m.num_experts, fan_in=D), "w_in": draw(E, D, F, fan_in=D),
            "w_gate": draw(E, D, F, fan_in=D), "w_out": draw(E, F, D, fan_in=F),
            "shared": {"w_in": draw(D, Fs, fan_in=D), "w_gate": draw(D, Fs, fan_in=D),
                       "w_out": draw(Fs, D, fan_in=Fs)}}


def moe_cfg(cfg):
    """The smoke config in f32 at capacity factor 8, as ``moe_a2a_driver.py`` runs it."""
    return dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


# -- the reference (JAX, 8 fake devices) --------------------------------------------


def ref_sort(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.core import distributed as rd
    from repro.distributed.compat import make_mesh
    from repro.distributed.sharding import pool_mesh
    from repro.net.pipeline import run_pipeline

    assert len(jax.devices()) == WORLD, jax.devices()
    mesh = make_mesh((WORLD,), ("sortaxis",))
    res = {}
    for name, (x, sample, cf, block) in sort_cases().items():
        splitters = rd.make_splitters(sample, WORLD)
        padded, valid, overflow = rd.sort_sharded(jnp.asarray(x), mesh, "sortaxis", splitters,
                                                  capacity_factor=cf, presort_block=block)
        res[f"{name}/splitters"] = splitters
        res[f"{name}/padded"] = np.asarray(padded)
        res[f"{name}/valid"] = np.asarray(valid)
        res[f"{name}/overflow"] = np.asarray(overflow)
    # the pool's int64 keys need x64 (without it the gather runs in int32)
    with jax.enable_x64(True):
        res["pool_concat_sharded"] = rd.pool_concat_sharded(POOL_SHARDS, pool_mesh(4), "server")
        r = run_pipeline(pipe_values(), pool_backend="shard_map", **PIPE)
    res["pipe/output"], res["pipe/passes"] = r.output, np.asarray(r.passes)
    np.savez(out, **res)


def ref_dist(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.distributed.compat import make_mesh
    from repro.distributed.pp import gpipe
    from repro.distributed.sharding import ShardCtx, fsdp_gather
    from repro.models import moe as moe_mod
    from jax.sharding import PartitionSpec as P

    assert len(jax.devices()) == WORLD, jax.devices()
    res = {}
    # fsdp_gather over "data" (4) of a (2, 4) mesh: forward and the gradient
    mesh = make_mesh((2, 4), ("replica", "data"))
    ctx = ShardCtx(mesh=mesh, tp=None, fsdp="data", dp=("replica", "data"))
    f = fsdp_inputs()
    tree = {k: jnp.asarray(f[k]) for k in ("w", "v", "b")}
    specs = {"w": P("data", None), "v": P(None, "data"), "b": P(None)}

    def fsdp_loss(t):
        g = fsdp_gather(ctx, t, specs)
        h = jnp.tanh(jnp.asarray(f["x"]) @ g["w"] + g["b"])
        return jnp.sum((h @ g["v"]) ** 2)

    loss, grads = jax.value_and_grad(fsdp_loss)(tree)
    res["fsdp/loss"] = np.asarray(loss)
    for k, v in grads.items():
        res[f"fsdp/grad/{k}"] = np.asarray(v)

    # gpipe over "pipe" (4) of a (2, 4) mesh
    mesh = make_mesh((2, 4), ("data", "pipe"))
    pi = pp_inputs()
    params = {"w": jnp.asarray(pi["w"]), "b": jnp.asarray(pi["b"])}
    xs = jnp.asarray(pi["xs"])

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    res["pp/out"] = np.asarray(jax.jit(lambda p, x: gpipe(stage, p, x, mesh, "pipe"))(params, xs))
    g = jax.jit(jax.grad(lambda p: jnp.sum(gpipe(stage, p, xs, mesh, "pipe") ** 2)))(params)
    for k, v in g.items():
        res[f"pp/grad/{k}"] = np.asarray(v)

    # moe_layer_a2a on a (2, 4) mesh (the reference's moe_a2a_driver.py)
    mesh = make_mesh((2, 4), ("data", "model"))
    cfg = moe_cfg(get_smoke_config(MOE_ARCH))
    ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",), sp=True)
    params = jax.tree.map(jnp.asarray, moe_params(cfg))
    x = jnp.asarray(moe_input(cfg.d_model))
    y, aux, dropped = jax.jit(lambda p, x_: moe_mod.moe_layer_a2a(p, cfg, ctx, x_))(params, x)
    res["moe/y"], res["moe/aux"], res["moe/dropped"] = np.asarray(y), np.asarray(aux), np.asarray(dropped)
    for name, fn in (("y", lambda y_, a_: jnp.sum(jnp.square(y_))), ("aux", lambda y_, a_: a_)):
        def loss(p, x_, fn=fn):
            y_, a_, _ = moe_mod.moe_layer_a2a(p, cfg, ctx, x_)
            return fn(y_, a_)

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
        res[f"moe/grad_{name}/x"] = np.asarray(gx)
        for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
            key = ".".join(str(getattr(k, "key", k)) for k in path)
            res[f"moe/grad_{name}/{key}"] = np.asarray(v)
    np.savez(out, **res)


# -- the port (one gloo rank each) --------------------------------------------------


def _init(rank: int, world: int, rdv: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # eight ranks share the machine's cores

    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)


def sort_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as pd
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import pool_mesh
    from repro_torch.net.pipeline import run_pipeline

    _init(rank, world, rdv)
    try:
        mesh = make_mesh((world,), ("sortaxis",), device_type="cpu")
        res = {}
        for name, (x, sample, cf, block) in sort_cases().items():
            splitters = pd.make_splitters(sample, world)
            n_loc = x.size // world
            xl = torch.from_numpy(x[rank * n_loc : (rank + 1) * n_loc])
            padded, valid, overflow = pd.sort_sharded(xl, mesh, "sortaxis", splitters,
                                                      capacity_factor=cf, presort_block=block)
            res[f"{name}/splitters"] = splitters
            res[f"{name}/padded"] = padded.numpy()
            res[f"{name}/valid"] = valid.numpy()
            res[f"{name}/overflow"] = overflow.numpy()
        pm = pool_mesh(4, "server", "cpu")
        res["pool_mesh_size"] = np.array(pm.size())
        shards = [torch.from_numpy(s) for s in POOL_SHARDS]
        res["pool_concat_sharded"] = pd.pool_concat_sharded(shards, pm, "server").numpy()
        errors = []
        for bad in (lambda: pd.pool_concat_sharded(shards[:3], pm, "server"),
                    lambda: make_mesh((3,), ("x",), device_type="cpu")):
            try:
                bad()
            except ValueError as e:
                errors.append(str(e))
        res["errors"] = np.array(errors)
        calls = []
        inner = pd.pool_concat_sharded
        pd.pool_concat_sharded = lambda *a, **k: calls.append(1) or inner(*a, **k)
        vals = torch.from_numpy(pipe_values())
        for backend in ("numpy", "shard_map"):
            r = run_pipeline(vals, pool_backend=backend, device="cpu", **PIPE)
            res[f"pipe/{backend}/output"], res[f"pipe/{backend}/passes"] = r.output.numpy(), np.asarray(r.passes)
        res["pipe/sharded_calls"] = np.array(len(calls))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def dist_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.pp import gpipe, sequential_reference
    from repro_torch.distributed.sharding import ShardCtx, fsdp_gather, shard_leaf
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_reference

    _init(rank, world, rdv)
    try:
        res = {}
        # fsdp_gather: this rank's shards of w (dim 0) and v (dim 1), b whole,
        # its own rows of the batch
        mesh = make_mesh((2, 4), ("replica", "data"), device_type="cpu")
        ctx = ShardCtx(mesh=mesh, tp=None, fsdp="data", dp=("replica", "data"))
        f = fsdp_inputs()
        d, nd = ctx.axis_index("data"), ctx.axis_size("data")
        rows, cols, nb = FSDP["rows"] // nd, FSDP["rows"] // nd, FSDP["batch"] // nd
        tree = {"w": torch.from_numpy(f["w"][d * rows : (d + 1) * rows]),
                "v": torch.from_numpy(f["v"][:, d * cols : (d + 1) * cols]),
                "b": torch.from_numpy(f["b"])}
        for v in tree.values():
            v.requires_grad_(True)
        g = fsdp_gather(ctx, tree, {"w": 0, "v": 1, "b": None})
        h = torch.tanh(torch.from_numpy(f["x"][d * nb : (d + 1) * nb]) @ g["w"] + g["b"])
        loss = ((h @ g["v"]) ** 2).sum()
        loss.backward()
        res["fsdp/loss"] = loss.detach().numpy()
        res["fsdp/gathered_w"] = g["w"].detach().numpy()
        for k, v in tree.items():
            res[f"fsdp/grad/{k}"] = v.grad.numpy()

        # gpipe: this rank's stage shard of the stacked parameters
        mesh = make_mesh((2, 4), ("data", "pipe"), device_type="cpu")
        pi = pp_inputs()
        s = mesh.get_local_rank("pipe")
        params = params_from_reference({"w": pi["w"], "b": pi["b"]}, stage=s)
        for v in params.values():
            v.requires_grad_(True)
        xs = torch.from_numpy(pi["xs"])

        def stage(p, x):
            return torch.tanh(x @ p["w"] + p["b"])

        out = gpipe(stage, params, xs, mesh, "pipe")
        (out**2).sum().backward()
        res["pp/out"] = out.detach().numpy()
        res["pp/sequential"] = sequential_reference(
            stage, {k: torch.from_numpy(pi[k]) for k in ("w", "b")}, xs).numpy()
        for k, v in params.items():
            res[f"pp/grad/{k}"] = v.grad.numpy()

        # moe_layer_a2a on a (2, 4) mesh: this rank's tokens and expert slabs
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        cfg = moe_cfg(configs.get_smoke_config(MOE_ARCH))
        ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",), sp=True)
        tree = moe_params(cfg)
        tpi = ctx.axis_index("model")
        x = shard_leaf(torch.from_numpy(moe_input(cfg.d_model)), ctx.spec_resid(), ctx.coords()).numpy()
        for name in ("y", "aux"):
            p = moe.MoE(cfg, torch.float32, "cpu", tp_size=ctx.tp_size)
            p.load_state_dict(params_from_reference(tree, ctx))
            p.requires_grad_(True)
            xt = torch.from_numpy(x.copy()).requires_grad_(True)
            y, aux, dropped = moe.moe_layer_a2a(p, cfg, ctx, xt)
            (y.square().sum() if name == "y" else aux).backward()
            res["moe/y"], res["moe/aux"], res["moe/dropped"] = y.detach().numpy(), aux.detach().numpy(), dropped.numpy()
            res[f"moe/grad_{name}/x"] = xt.grad.numpy()
            for k, v in p.named_parameters():
                res[f"moe/grad_{name}/{k}"] = np.zeros(v.shape, np.float32) if v.grad is None else v.grad.numpy()
        try:
            moe.moe_layer_a2a(moe.MoE(cfg, torch.float32, "cpu"), cfg, ctx, torch.from_numpy(x.copy()))
        except ValueError as e:
            res["moe/full_slabs_error"] = np.array(str(e))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# -- the LM on a (data, model) mesh ---------------------------------------------------

LM_MESH = (2, 2)  # (data, model); rank = 2 * data + model
LM_TRAIN = [  # name, arch, sequence parallelism; fsdp over data
    ("mistral_sp0", "mistral-nemo-12b", False),
    ("mistral_sp1", "mistral-nemo-12b", True),
    ("granite_sp1", "granite-moe-3b-a800m", True),
]
#: The reference's loss and gradients of a case are the ones of another case
#: whose parameters and batch it shares (the reference LM with SP on is the
#: same function; only the partitioner's layout differs).
REF_SAME = {"mistral_sp1": "mistral_sp0"}
LM_B, LM_T = 4, 16
SERVE = dict(arch="deepseek-moe-16b", B=4, T=14, max_len=32, steps=4)
PREFILL = dict(arch="granite-moe-3b-a800m", B=4, T=8, max_len=16)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=0.1)
#: The training CLI legs: the reference's flags (REF_CLI), the port's adds its own.
REF_CLI = ["--smoke", "--batch", "4", "--seq", "16", "--ckpt-every", "2", "--log-every", "100",
           "--arch", "mistral-nemo-12b", "--steps", "4"]
CLI = REF_CLI + ["--dtype", "float32", "--device", "cpu"]
#: The serving CLI legs: deepseek's f32 smoke model (4 kv heads, 16 padded
#: experts: both split over tp = 4), 6 requests on 4 slots, so two slots are
#: refilled; the cache of 32 positions is 8 a rank at tp = 4.
SERVE_CLI = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu", "--requests", "6",
             "--max-tokens", "6", "--max-len", "32"]
SERVE_MODES = {"greedy": [], "sampled": ["--temperature", "0.8"]}
ARCHS = ("mistral-nemo-12b", "granite-moe-3b-a800m", "deepseek-moe-16b")
#: Rank 0's gathered mistral_sp0 gradient, for the reference's int8 compressor.
INT8_IN = "int8_in.npz"


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> {"a/b/#0/c": leaf}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flatten(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in flatten(v, f"{prefix}#{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def shards_at_spec(cfg, ctx):
    """``cfg``'s model built on the CPU for the rank that ``ctx`` (a context
    without a process group) stands at, each leaf checked to be the
    one-device model's leaf cut by its ``leaf_spec``; returns the model."""
    from repro_torch import models
    from repro_torch.models.lm import leaf_spec

    whole = {n: tuple(p.shape) for n, p in models.build(cfg, device="cpu").named_parameters()}
    model = models.build(cfg, ctx=ctx, device="cpu")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(got) == set(whole)
    for name, shape in got.items():
        cut = [1 if e is None else int(np.prod([ctx.axis_size(a) for a in (e if isinstance(e, tuple) else (e,))]))
               for e in leaf_spec(name, len(shape), ctx, cfg)]
        assert shape == tuple(w // k for w, k in zip(whole[name], cut)), (name, shape, whole[name])
    return model


def lm_inputs(out: Path, archs=ARCHS) -> None:
    """Write the cases' inputs to ``out``: each smoke LM's parameters (f32,
    numpy draws at the reference's scales, norm scales near 1) as the
    reference's tree, and the token batches.  Runs in the test process."""
    import torch

    from repro_torch import configs
    from repro_torch.models.convert import params_to_reference
    from repro_torch.models.lm import LM

    rng = np.random.default_rng(7)
    res = {}
    for arch in archs:
        cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
        state = {}
        for name, p in LM(cfg, device="cpu").named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                v = 1.0 + 0.1 * rng.standard_normal(p.shape)
            elif leaf.startswith("b"):
                v = np.zeros(p.shape)
            else:
                v = rng.standard_normal(p.shape) * (0.02 if leaf == "table" else p.shape[-2] ** -0.5)
            state[name] = torch.from_numpy(v.astype(np.float32))
        for k, v in flatten(params_to_reference(state)).items():
            res[f"{arch}/params/{k}"] = v
        res[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (3, LM_B, LM_T)).astype(np.int32)
        res[f"{arch}/labels"] = rng.integers(0, cfg.vocab_size, (3, LM_B, LM_T)).astype(np.int32)
    res["serve/prompt"] = rng.integers(0, 512, (SERVE["B"], SERVE["T"])).astype(np.int32)
    res["prefill/prompt"] = rng.integers(0, 512, (PREFILL["B"], PREFILL["T"])).astype(np.int32)
    np.savez(out, **res)


def lm_tree(inputs: dict, arch: str) -> dict:
    pre = f"{arch}/params/"
    return unflatten({k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)})


def ref_lm(out: str, part: str) -> None:
    """The reference's side of ``test_torch_lm_sharded.py`` on a (2, 2) mesh
    of fake devices, in two parts that run side by side: ``grads`` (the
    loss and gradients, then the int8 compressor on the port's gradient,
    once rank 0 has written it) and ``rest`` (the MoE's training error,
    prefill, the sequence-sharded decode, two AdamW steps, and on the
    (1, 4) mesh with SP context parallelism's flag, loss and gradients)."""
    import jax
    import jax.numpy as jnp

    from repro import models
    from repro.configs import get_smoke_config
    from repro.distributed.compat import make_mesh
    from repro.distributed.collectives import make_int8_compressor
    from repro.distributed.sharding import ShardCtx, local_ctx
    from repro.models.attention import use_context_parallel
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import build_train_step

    d = Path(out).parent
    inputs = dict(np.load(d / "inputs.npz"))
    mesh = make_mesh(LM_MESH, ("data", "model"))
    res = {}

    def cfg_of(arch):
        return dataclasses.replace(get_smoke_config(arch), dtype="float32")

    def params_of(arch):
        return jax.tree.map(jnp.asarray, lm_tree(inputs, arch))

    def batch_of(arch, i):
        return {"tokens": jnp.asarray(inputs[f"{arch}/tokens"][i]), "labels": jnp.asarray(inputs[f"{arch}/labels"][i])}

    if part == "grads":
        for name, arch, sp in LM_TRAIN:
            if name in REF_SAME:  # the same function of the parameters and the batch: SP is a layout
                res.update({f"{name}/{k.split('/', 1)[1]}": v for k, v in res.items()
                            if k.startswith(f"{REF_SAME[name]}/")})
                continue
            ctx = ShardCtx(mesh=mesh, tp="model", fsdp="data", dp=("data",), sp=sp)
            model = models.build(cfg_of(arch), ctx)
            (loss, met), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params_of(arch), batch_of(arch, 0))
            res[f"{name}/loss"], res[f"{name}/ce"], res[f"{name}/aux"] = (np.asarray(x) for x in (loss, met["ce"],
                                                                                                  met["aux"]))
            for k, v in flatten(g).items():
                res[f"{name}/grad/{k}"] = v

        # the reference's int8 compressor (eager) on the port's gathered gradient
        _wait_ready(d, INT8_IN, "")
        grads = dict(np.load(d / INT8_IN))
        compress, init = make_int8_compressor(local_ctx())
        res.update({f"int8/{k}": np.asarray(v) for k, v in compress(grads, init(grads))[0].items()})
    else:
        serve_ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",))
        arch = PREFILL["arch"]
        model = models.build(cfg_of(arch), ShardCtx(mesh=mesh, tp="model", fsdp="data", dp=("data",)))
        try:
            jax.jit(model.loss)(params_of(arch), batch_of(arch, 0))  # raises while tracing
        except ValueError as e:
            res["granite_sp0/train_error"] = np.array(str(e))
        model = models.build(cfg_of(arch), serve_ctx)
        cache = model.init_cache(PREFILL["B"], PREFILL["max_len"])
        logits, _ = jax.jit(model.prefill)(params_of(arch), {"tokens": jnp.asarray(inputs["prefill/prompt"])}, cache)
        res["prefill/logits"] = np.asarray(logits)

        arch = SERVE["arch"]
        model = models.build(cfg_of(arch), serve_ctx)
        params = params_of(arch)
        cache = model.init_cache(SERVE["B"], SERVE["max_len"])
        logits, cache = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(inputs["serve/prompt"])}, cache)
        step = jax.jit(model.decode_step)
        for i in range(SERVE["steps"] + 1):
            res[f"serve/logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            res[f"serve/tokens{i}"] = np.asarray(tok)
            if i < SERVE["steps"]:
                logits, cache = step(params, cache, tok)

        arch = "mistral-nemo-12b"
        model = models.build(cfg_of(arch), ShardCtx(mesh=mesh, tp="model", fsdp="data", dp=("data",)))
        opt = AdamWConfig(**OPT)
        params = params_of(arch)
        state = init_opt_state(params, opt)
        step = jax.jit(build_train_step(model, opt))
        for i in range(2):
            params, state, met = step(params, state, batch_of(arch, i + 1))
            res[f"adamw/loss{i}"], res[f"adamw/grad_norm{i}"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])
        for k, v in flatten(params).items():
            res[f"adamw/params/{k}"] = v

        mesh14 = make_mesh((1, 4), ("data", "model"))
        ctx14 = ShardCtx(mesh=mesh14, tp="model", fsdp=None, dp=("data",), sp=True)
        arch = "mistral-nemo-12b"
        res["cp/use_context_parallel"] = np.array(use_context_parallel(cfg_of(arch), ctx14))
        model = models.build(cfg_of(arch), ctx14)
        (loss, _), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params_of(arch), batch_of(arch, 0))
        res["cp/loss"] = np.asarray(loss)
        res.update({f"cp/grad/{k}": v for k, v in flatten(g).items()})
    np.savez(out, **res)


def ref_cli(out: str) -> None:
    """The reference's training CLI: four steps into ``cli_r`` (the 2x2 mesh
    resumes it), then it resumes a copy of the 2x2 run's ``cli_a`` from
    step 2; the records of both legs to ``out``."""
    d, res = Path(out).parent, {}
    _ref_cli_leg(d, "ref_r", "cli_r", True, res)
    _wait_ready(d, "cli_a")
    _ref_cli_leg(d, "resume_ref_a", "cli_a_ref", False, res)
    np.savez(out, **res)


def _ref_cli_leg(d: Path, leg: str, ckpt: str, first: bool, res: dict) -> None:
    """The reference's training CLI (``--mesh 1x1``, its smoke config in
    f32) into the directory ``d / ckpt``, its jitted step wrapped to record
    each step's loss and gradient norm into ``res`` under ``leg/``; a first
    leg sets its step-4 checkpoint aside and marks the directory ready, as
    :func:`_cli_leg` does."""
    import jax

    from repro.configs import get_smoke_config
    from repro.launch import train as ref_cli

    records = []

    def recording_jit(fn, **kw):
        step = jax.jit(fn, **kw)

        def call(params, opt_state, batch):
            out = step(params, opt_state, batch)
            records.append([float(out[2][k]) for k in ("loss", "grad_norm")])
            return out
        return call

    class _Jax:  # the CLI module's view of jax, with the step's jit recording
        jit = staticmethod(recording_jit)

        def __getattr__(self, name):
            return getattr(jax, name)

    saved = ref_cli.jax, ref_cli.get_smoke_config, sys.argv
    ref_cli.jax = _Jax()
    ref_cli.get_smoke_config = lambda arch: dataclasses.replace(get_smoke_config(arch), dtype="float32")
    sys.argv = ["train", *REF_CLI, "--ckpt-dir", str(d / ckpt)]
    try:
        ref_cli.main()
    finally:
        ref_cli.jax, ref_cli.get_smoke_config, sys.argv = saved
    rec = np.array(records)
    res[f"{leg}/step"] = np.arange(4 - len(rec), 4)
    res[f"{leg}/loss"], res[f"{leg}/grad_norm"] = rec[:, 0], rec[:, 1]
    if first:
        _set_aside(d / ckpt)


def _lm_ctx(mesh, **kw):
    from repro_torch.distributed.sharding import ShardCtx

    return ShardCtx(mesh=mesh, tp="model", dp=("data",), **kw)


def lm_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """The LM cases on one rank of the (2, 2) mesh, then the training CLI at
    ``--mesh 2x2``: four steps into ``cli_a`` (which :func:`cli_one`
    resumes at 1x1), then it resumes :func:`cli_one`'s ``cli_b``."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed.collectives import make_int8_compressor
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.launch import train as train_cli
    from repro_torch.models.convert import params_from_reference, params_to_reference
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch, sync_grads

    _init(rank, world, rdv)
    try:
        inputs = dict(np.load(Path(out_dir).parent / "inputs.npz"))
        mesh = make_mesh(LM_MESH, ("data", "model"), device_type="cpu")
        res = {}

        def cfg_of(arch):
            return dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")

        def model_of(arch, ctx):
            model = LM(cfg_of(arch), ctx, device="cpu")
            model.load_state_dict(params_from_reference(lm_tree(inputs, arch), ctx, cfg_of(arch)))
            return model

        def batch_of(arch, i, ctx):
            b = {"tokens": inputs[f"{arch}/tokens"][i], "labels": inputs[f"{arch}/labels"][i]}
            return {k: torch.from_numpy(v) for k, v in shard_batch(b, ctx).items()}

        for name, arch, sp in LM_TRAIN:
            ctx = _lm_ctx(mesh, fsdp="data", sp=sp)
            model = model_of(arch, ctx).requires_grad_(True)
            loss, met = model.loss(batch_of(arch, 0, ctx))
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
            grads = sync_grads(dict(zip(names, grads)), ctx, model.param_specs())
            whole = params_to_reference(grads, ctx, model.cfg)
            res[f"{name}/loss"], res[f"{name}/ce"], res[f"{name}/aux"] = (x.detach().numpy() for x in (
                loss, met["ce"], met["aux"]))
            if rank == 0:
                for k, v in flatten(whole).items():
                    res[f"{name}/grad/{k}"] = v
            if name == "mistral_sp0":  # the int8 compressor on the shards of the reduced gradient
                compress, init_res = make_int8_compressor(ctx, model.param_specs())
                packed = params_to_reference(compress(grads, init_res(grads))[0], ctx, model.cfg)
                if rank == 0:
                    res.update({f"int8/{k}": v for k, v in flatten(packed).items()})
                    # the reference's compressor takes this gradient in ref_lm's grads part
                    np.savez(Path(out_dir) / "int8_in.tmp.npz", **flatten(whole))
                    (Path(out_dir) / "int8_in.tmp.npz").rename(Path(out_dir).parent / INT8_IN)

        arch = PREFILL["arch"]
        model = model_of(arch, _lm_ctx(mesh, fsdp="data"))
        try:
            model.loss(batch_of(arch, 0, model.ctx))
        except ValueError as e:
            res["granite_sp0/train_error"] = np.array(str(e))
        serve_ctx = _lm_ctx(mesh, fsdp=None)
        model = model_of(arch, serve_ctx)
        rows = shard_batch({"p": inputs["prefill/prompt"]}, serve_ctx)["p"]
        cache = model.init_cache(rows.shape[0], PREFILL["max_len"])
        res["prefill/logits"] = model.prefill(torch.from_numpy(rows), cache)[0].numpy()

        arch = SERVE["arch"]
        model = model_of(arch, serve_ctx)
        rows = shard_batch({"p": inputs["serve/prompt"]}, serve_ctx)["p"]
        cache = model.init_cache(rows.shape[0], SERVE["max_len"])
        logits, cache = model.prefill(torch.from_numpy(rows), cache)
        for i in range(SERVE["steps"] + 1):
            res[f"serve/logits{i}"] = logits.numpy()
            tok = torch.argmax(logits, dim=-1)
            res[f"serve/tokens{i}"] = tok.numpy()
            if i < SERVE["steps"]:
                logits, cache = model.decode_step(cache, tok)

        # the same four ranks as a (1, 4) mesh: Mistral's 2 kv heads go context-parallel under SP
        mesh14 = make_mesh((1, 4), ("data", "model"), device_type="cpu")
        res.update(_lm_grads(inputs, "mistral-nemo-12b", _lm_ctx(mesh14, fsdp=None, sp=True), "cp", rank))

        arch = "mistral-nemo-12b"
        ctx = _lm_ctx(mesh, fsdp="data")
        model = model_of(arch, ctx).requires_grad_(True)
        opt = AdamWConfig(**OPT)
        state = init_opt_state(dict(model.named_parameters()), opt)
        step = build_train_step(model, opt)
        for i in range(2):
            state, met = step(state, batch_of(arch, i + 1, ctx))
            res[f"adamw/loss{i}"], res[f"adamw/grad_norm{i}"] = float(met["loss"]), float(met["grad_norm"])
        whole = params_to_reference(model.state_dict(), ctx, model.cfg)
        if rank == 0:
            for k, v in flatten(whole).items():
                res[f"adamw/params/{k}"] = v

        _cli_leg(out_dir, "cli_a", "cli_a", "2x2", True, rank, spare="cli_a_ref")
        _wait_ready(Path(out_dir).parent, "cli_b")
        _cli_leg(out_dir, "resume_b", "cli_b", "2x2", False, rank)
        res.update(_serve_legs("1x4"))
        try:
            _serve_legs("2x2")
        except SystemExit as e:
            res["serve_2x2/error"] = np.array(str(e))
        _wait_ready(Path(out_dir).parent, "cli_r")
        _cli_leg(out_dir, "resume_r", "cli_r", "2x2", False, rank)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _cli_leg(out_dir: str, leg: str, ckpt: str, mesh: str, first: bool, rank: int,
             spare: str | None = None, cli: list[str] = CLI) -> None:
    """The training CLI (``cli``), four steps at ``--mesh mesh``
    checkpointing every two, into the directory ``ckpt``; rank 0 writes its
    records to ``{leg}.npz``.  A first leg sets its step-4 checkpoint aside,
    so that another run resumes from step 2 (with ``spare``, a copy of the
    directory under that name for a second run), and then marks it ready."""
    from repro_torch.launch import train as train_cli

    d = Path(out_dir).parent / ckpt
    recs = train_cli.main(cli + ["--mesh", mesh, "--ckpt-dir", str(d)])
    if rank == 0:
        np.savez(Path(out_dir) / f"{leg}.npz", **{k: np.array([r[k] for r in recs])
                                                  for k in ("step", "loss", "grad_norm")})
        if first:
            _set_aside(d, spare)


def _set_aside(d: Path, spare: str | None = None) -> None:
    """Move the step-4 checkpoint of ``d`` into ``d/aside`` (not a step_*
    name: the managers ignore it), copy the rest to ``spare``, and mark
    ``d`` ready."""
    (d / "aside").mkdir()
    (d / "step_0000000004").rename(d / "aside" / "step_0000000004")
    if spare is not None:
        shutil.copytree(d, d.parent / spare, ignore=shutil.ignore_patterns("aside"))
    (d / "aside" / "ready").touch()


def _wait_ready(base: Path, ckpt: str, mark: str = "aside/ready") -> None:
    """Wait for another run's first leg to mark ``base / ckpt`` ready (or
    for the file ``base / ckpt / mark``)."""
    ready = Path(base) / ckpt / mark
    deadline = time.monotonic() + RANKS_DEADLINE
    while not ready.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{ready} never appeared")
        time.sleep(0.05)


def cli_one(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One rank at ``--mesh 1x1``: four steps into ``cli_b`` (the 2x2 mesh
    resumes it), then it resumes the 2x2 run's ``cli_a`` from step 2; then
    the serving CLI without a mesh."""
    import torch.distributed as dist

    _init(rank, world, rdv)
    try:
        _cli_leg(out_dir, "cli_b", "cli_b", "1x1", True, rank)
        _wait_ready(Path(out_dir).parent, "cli_a")
        _cli_leg(out_dir, "resume_a", "cli_a", "1x1", False, rank)
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **_serve_legs(None))


def _serve_legs(mesh: str | None, cli: list[str] = SERVE_CLI) -> dict:
    """The serving CLI (``cli``, f32) at ``--mesh mesh`` (None: no mesh) in
    each of ``SERVE_MODES``: ``serve_<mode>/tokens``, the requests' tokens by
    request id."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_cli

    saved = serve_cli.get_smoke_config
    serve_cli.get_smoke_config = lambda arch: dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    res = {}
    try:
        for mode, flags in SERVE_MODES.items():
            finished = serve_cli.main(cli + flags + ([] if mesh is None else ["--mesh", mesh]))
            res[f"serve_{mode}/tokens"] = np.array([r.out for r in sorted(finished, key=lambda r: r.rid)])
    finally:
        serve_cli.get_smoke_config = saved
    return res


def _lm_grads(inputs: dict, arch: str, ctx, name: str, rank: int, batch: int = 0) -> dict:
    """The port's loss, ce and aux on this rank and (rank 0) every gradient
    leaf, summed over its replicated axes and gathered whole, of ``arch``'s
    inputs on ``ctx``."""
    import torch

    from repro_torch import configs
    from repro_torch.models.convert import params_from_reference, params_to_reference
    from repro_torch.models.attention import use_context_parallel
    from repro_torch.models.lm import LM
    from repro_torch.train.train_step import shard_batch, sync_grads

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    model = LM(cfg, ctx, device="cpu")
    model.load_state_dict(params_from_reference(lm_tree(inputs, arch), ctx, cfg))
    model.requires_grad_(True)
    b = {"tokens": inputs[f"{arch}/tokens"][batch], "labels": inputs[f"{arch}/labels"][batch]}
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in shard_batch(b, ctx).items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    whole = params_to_reference(sync_grads(dict(zip(names, grads)), ctx, model.param_specs()), ctx, cfg)
    res = {f"{name}/{k}": v.detach().numpy() for k, v in (("loss", loss), ("ce", met["ce"]), ("aux", met["aux"]))}
    res[f"{name}/cp"] = np.array(use_context_parallel(cfg, ctx))
    if rank == 0:
        res.update({f"{name}/grad/{k}": v for k, v in flatten(whole).items()})
    return res


# -- context parallelism on a (1, 4) mesh ---------------------------------------------

CP_MESH = (1, 4)
CP_FSDP_MESH = (2, 4)
CP_ARCHS = ("mistral-nemo-12b", "granite-moe-3b-a800m", "nemotron-4-340b")
CP_TRAIN = [  # name, arch, sequence parallelism: (C) with SP, (B) without
    ("mistral_c", "mistral-nemo-12b", True),
    ("mistral_b", "mistral-nemo-12b", False),
    ("granite_c", "granite-moe-3b-a800m", True),
]
#: Prefill of 14 tokens and 4 greedy steps on a cache of 32 positions (8 a rank).
CP_SERVE = dict(B=4, T=14, max_len=32, steps=4)
CP_SERVE_ARCHS = ("mistral-nemo-12b", "nemotron-4-340b")
#: The serving CLI against the reference's: Mistral's f32 smoke model, the CLIs' defaults.
CP_SERVE_CLI = ["--arch", "mistral-nemo-12b", "--smoke", "--mesh", "1x4"]


def cp_inputs(out: Path) -> None:
    lm_inputs(out, CP_ARCHS)


def ref_cp(out: str, part: str) -> None:
    """The reference's side of ``test_torch_context_parallel.py``, in two
    parts that run side by side: ``train`` on 4 fake devices (the (1, 4)
    mesh's loss and gradients with SP on and off; prefill and greedy decode
    on its serving context) and ``rest`` on 8 (two AdamW steps on the (2, 4)
    mesh with FSDP and SP; the serving CLI at ``--mesh 1x4`` on the inputs'
    weights; the training CLI resuming the port's context-parallel
    directory)."""
    import jax
    import jax.numpy as jnp

    from repro import models
    from repro.configs import get_smoke_config
    from repro.distributed.compat import make_mesh
    from repro.distributed.sharding import ShardCtx
    from repro.models.attention import use_context_parallel
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import build_train_step

    d = Path(out).parent
    inputs = dict(np.load(d / "inputs.npz"))
    res = {}

    def cfg_of(arch):
        return dataclasses.replace(get_smoke_config(arch), dtype="float32")

    def params_of(arch):
        return jax.tree.map(jnp.asarray, lm_tree(inputs, arch))

    def batch_of(arch, i):
        return {"tokens": jnp.asarray(inputs[f"{arch}/tokens"][i]), "labels": jnp.asarray(inputs[f"{arch}/labels"][i])}

    if part == "train":
        mesh = make_mesh(CP_MESH, ("data", "model"))
        for name, arch, sp in CP_TRAIN:
            ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",), sp=sp)
            res[f"{name}/cp"] = np.array(use_context_parallel(cfg_of(arch), ctx))
            model = models.build(cfg_of(arch), ctx)
            (loss, met), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params_of(arch), batch_of(arch, 0))
            for k, v in (("loss", loss), ("ce", met["ce"]), ("aux", met["aux"])):
                res[f"{name}/{k}"] = np.asarray(v)
            res.update({f"{name}/grad/{k}": v for k, v in flatten(g).items()})
        ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",))
        for arch in CP_SERVE_ARCHS:
            model = models.build(cfg_of(arch), ctx)
            params = params_of(arch)
            cache = model.init_cache(CP_SERVE["B"], CP_SERVE["max_len"])
            prompt = jnp.asarray(inputs[f"{arch}/tokens"][2][:, :CP_SERVE["T"]])
            logits, cache = jax.jit(model.prefill)(params, {"tokens": prompt}, cache)
            step = jax.jit(model.decode_step)
            for i in range(CP_SERVE["steps"] + 1):
                res[f"serve/{arch}/logits{i}"] = np.asarray(logits)
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                res[f"serve/{arch}/tokens{i}"] = np.asarray(tok)
                if i < CP_SERVE["steps"]:
                    logits, cache = step(params, cache, tok)
    else:
        arch = "mistral-nemo-12b"
        mesh = make_mesh(CP_FSDP_MESH, ("data", "model"))
        ctx = ShardCtx(mesh=mesh, tp="model", fsdp="data", dp=("data",), sp=True)
        res["adamw/cp"] = np.array(use_context_parallel(cfg_of(arch), ctx))
        model = models.build(cfg_of(arch), ctx)
        opt = AdamWConfig(**OPT)
        params = params_of(arch)
        state = init_opt_state(params, opt)
        step = jax.jit(build_train_step(model, opt))
        for i in range(2):
            params, state, met = step(params, state, batch_of(arch, i + 1))
            res[f"adamw/loss{i}"], res[f"adamw/grad_norm{i}"] = np.asarray(met["loss"]), np.asarray(met["grad_norm"])
        res.update({f"adamw/params/{k}": v for k, v in flatten(params).items()})
        res.update(_ref_serve_cli(inputs))
        _wait_ready(d, "cli_c")
        _ref_cli_leg(d, "resume_ref_c", "cli_c_ref", False, res)
    np.savez(out, **res)


def _ref_serve_cli(inputs: dict) -> dict:
    """The reference's serving CLI at ``CP_SERVE_CLI`` (f32), its weights the
    inputs' instead of its PRNG draw: the requests' tokens by request id."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.launch import serve as ref_serve
    from repro.models.lm import LM as RefLM

    finished = []
    tree = jax.tree.map(jnp.asarray, lm_tree(inputs, "mistral-nemo-12b"))

    class Engine(ref_serve.Engine):
        def run(self, *a, **k):
            out = super().run(*a, **k)
            finished.extend(out)
            return out

    saved = ref_serve.get_smoke_config, ref_serve.Engine, RefLM.init, sys.argv
    ref_serve.get_smoke_config = lambda arch: dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_serve.Engine = Engine
    RefLM.init = lambda self, key: tree
    sys.argv = ["serve", *CP_SERVE_CLI]
    try:
        ref_serve.main()
    finally:
        ref_serve.get_smoke_config, ref_serve.Engine, RefLM.init, sys.argv = saved
    return {"serve_cli/tokens": np.array([r.out for r in sorted(finished, key=lambda r: r.rid)])}


def cp_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """The port's side on one rank of the (1, 4) mesh: the training cases,
    prefill and greedy decode with each arch's context-parallel (SP) and
    column-split modules, the training CLI's loop on the context-parallel
    layout into ``cli_c`` (four steps, a checkpoint every two), the serving
    CLI at ``--mesh 1x4``; then rank 0 alone resumes ``cli_c`` at ``--mesh
    1x1``."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.attention import use_context_parallel
    from repro_torch.models.lm import LM

    _init(rank, world, rdv)
    try:
        inputs = dict(np.load(Path(out_dir).parent / "inputs.npz"))
        mesh = make_mesh(CP_MESH, ("data", "model"), device_type="cpu")
        res = {}
        for name, arch, sp in CP_TRAIN:
            res.update(_lm_grads(inputs, arch, _lm_ctx(mesh, fsdp=None, sp=sp), name, rank))
        for arch in CP_SERVE_ARCHS:
            cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
            for layout, sp in (("c", True), ("b", False)):
                ctx = _lm_ctx(mesh, fsdp=None, sp=sp)
                model = LM(cfg, ctx, device="cpu")
                model.load_state_dict(params_from_reference(lm_tree(inputs, arch), ctx, cfg))
                res[f"serve/{arch}/{layout}/cp"] = np.array(use_context_parallel(cfg, ctx))
                cache = model.init_cache(CP_SERVE["B"], CP_SERVE["max_len"])
                prompt = torch.from_numpy(inputs[f"{arch}/tokens"][2][:, :CP_SERVE["T"]])
                logits, cache = model.prefill(prompt, cache)
                for i in range(CP_SERVE["steps"] + 1):
                    res[f"serve/{arch}/{layout}/logits{i}"] = logits.numpy()
                    tok = torch.argmax(logits, dim=-1)
                    res[f"serve/{arch}/{layout}/tokens{i}"] = tok.numpy()
                    if i < CP_SERVE["steps"]:
                        logits, cache = model.decode_step(cache, tok)
        _cp_cli_leg(out_dir, rank, mesh)
        res.update(_cp_serve_cli(inputs))
    finally:
        dist.destroy_process_group()
    if rank == 0:  # the context-parallel directory resumed on one device
        _wait_ready(Path(out_dir).parent, "cli_c")
        _cli_leg(out_dir, "resume_c", "cli_c", "1x1", False, rank)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)


def _cp_cli_leg(out_dir: str, rank: int, mesh) -> None:
    """The training CLI (``CLI``) at ``--mesh 1x4`` with its context
    swapped for the same mesh under SP, so the attention runs
    context-parallel (the CLI sets no SP, as the reference's does not):
    four steps into ``cli_c``, its step-4 checkpoint set aside and a copy
    ``cli_c_ref`` for the reference's CLI."""
    import contextlib

    from repro_torch.launch import train as train_cli

    @contextlib.contextmanager
    def sp_mesh(spec, device, *, train):
        yield _lm_ctx(mesh, fsdp=None, sp=True)

    saved = train_cli.mesh_context
    train_cli.mesh_context = sp_mesh
    try:
        _cli_leg(out_dir, "cli_c", "cli_c", "1x4", True, rank, spare="cli_c_ref")
    finally:
        train_cli.mesh_context = saved


def _cp_serve_cli(inputs: dict) -> dict:
    """The port's serving CLI at ``CP_SERVE_CLI`` (f32, ``--device cpu``), its
    weights the inputs' (each rank's cut) instead of its generator's draw."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.lm import LM

    tree = lm_tree(inputs, "mistral-nemo-12b")

    def load(self, generator):
        self.load_state_dict(params_from_reference(tree, self.ctx, self.cfg))
        return self

    saved = serve_cli.get_smoke_config, LM.init
    serve_cli.get_smoke_config = lambda arch: dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    LM.init = load
    try:
        finished = serve_cli.main(CP_SERVE_CLI + ["--device", "cpu"])
    finally:
        serve_cli.get_smoke_config, LM.init = saved
    return {"serve_cli/tokens": np.array([r.out for r in sorted(finished, key=lambda r: r.rid)])}


def cp_fsdp_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """Two AdamW steps of ``build_train_step`` on the (2, 4) mesh with FSDP
    over data and SP (Mistral: its attention context-parallel and cut over
    fsdp alone); rank 0 writes the parameters gathered whole."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models.convert import params_from_reference, params_to_reference
    from repro_torch.models.attention import use_context_parallel
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    _init(rank, world, rdv)
    try:
        inputs = dict(np.load(Path(out_dir).parent / "inputs.npz"))
        arch = "mistral-nemo-12b"
        cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
        ctx = _lm_ctx(make_mesh(CP_FSDP_MESH, ("data", "model"), device_type="cpu"), fsdp="data", sp=True)
        model = LM(cfg, ctx, device="cpu")
        model.load_state_dict(params_from_reference(lm_tree(inputs, arch), ctx, cfg))
        model.requires_grad_(True)
        opt = AdamWConfig(**OPT)
        state = init_opt_state(dict(model.named_parameters()), opt)
        step = build_train_step(model, opt)
        res = {"adamw/cp": np.array(use_context_parallel(cfg, ctx))}
        for i in range(2):
            b = {"tokens": inputs[f"{arch}/tokens"][i + 1], "labels": inputs[f"{arch}/labels"][i + 1]}
            state, met = step(state, {k: torch.from_numpy(v) for k, v in shard_batch(b, ctx).items()})
            res[f"adamw/loss{i}"], res[f"adamw/grad_norm{i}"] = float(met["loss"]), float(met["grad_norm"])
        whole = params_to_reference(model.state_dict(), ctx, cfg)
        if rank == 0:
            res.update({f"adamw/params/{k}": v for k, v in flatten(whole).items()})
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# -- the recurrent LMs on a mesh ------------------------------------------------------

#: The recurrent models: the zamba2 and rwkv6 smoke configs in f32, and
#: zamba2's as the ``mamba`` kind with SSD heads of 128 (2 heads, 2 groups: at
#: tp 4 its d_inner columns cut through a head).
REC_MODELS = {"zamba2": ("zamba2-1.2b", {}), "rwkv6": ("rwkv6-1.6b", {}),
              "mamba128": ("zamba2-1.2b", {"family": "ssm", "ssm_head_dim": 128})}
REC_TRAIN = [  # name, model, mesh, sequence parallelism (FSDP over data where it is 2)
    ("zamba2_2x2", "zamba2", (2, 2), False),
    ("rwkv6_2x2", "rwkv6", (2, 2), False),
    ("zamba2_1x4", "zamba2", (1, 4), True),
    ("rwkv6_1x4", "rwkv6", (1, 4), True),
    ("mamba128_1x4", "mamba128", (1, 4), False),
]
REC_B, REC_T = 4, 32  # T 32: two chunks of the Mamba2 smoke chunk 16
#: Serving: 6 requests of 8 prompt tokens on 5 slots (none a stack's depth,
#: R2), 5 tokens each but every odd request 4, so a slot is refilled while
#: the others decode; a cache of 32 positions (8 a rank at tp 4).
REC_SERVE = dict(requests=6, prompt=8, steps=5, slots=5, max_len=32)
#: The CLIs: the training CLI at 2x2 and 1x1 (a checkpoint every 2 steps),
#: the serving CLI at 1x4 and without a mesh (8 requests on 5 slots).
REC_CLI = ["--smoke", "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--log-every", "100", "--steps", "4",
           "--dtype", "float32", "--device", "cpu"]
REC_SERVE_CLI = ["--smoke", "--device", "cpu", "--requests", "8", "--slots", "5", "--max-tokens", "6",
                 "--max-len", "32"]
REC_CLI_ARCHS = ("zamba2", "rwkv6")
REC_INT8 = "rec_int8_in.npz"


def rec_cfg(name: str, get_smoke_config):
    """``name``'s config (:data:`REC_MODELS`) from either package's getter."""
    arch, over = REC_MODELS[name]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if "family" in over:
        cfg = dataclasses.replace(cfg, family=over["family"],
                                  ssm=dataclasses.replace(cfg.ssm, head_dim=over["ssm_head_dim"]))
    return cfg


def _rec_leaf(name: str, shape, rng) -> np.ndarray:
    """One leaf of the inputs' weights: norm scales, ``d_skip`` and
    ``ln_scale`` near 1; ``dt_bias`` and ``a_log`` N(0, 0.5); RWKV6's
    leaves about the reference's init, perturbed as ``_torch_rwkv_ref.py``
    does: the token-shift mixes 0.5 + N(0, 0.1), ``w0`` uniform on [-6, 3]
    (decays from 0.9975 down to 2e-9), ``bonus`` and the ``mb_*`` N(0, 0.1),
    ``wa``, ``wb`` and the ``ma_*`` N(0, 0.01); the table N(0, 0.02), any
    other matrix N(0, 1) / sqrt(d_in) (``conv_k`` over its width)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "ln_scale", "norm_scale", "d_skip"):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if leaf.startswith(("mu_", "cm_mu_")):
        return 0.5 + 0.1 * rng.standard_normal(shape)
    if leaf == "w0":
        return rng.uniform(-6.0, 3.0, shape)
    if leaf in ("dt_bias", "a_log"):
        return 0.5 * rng.standard_normal(shape)
    if leaf == "bonus" or leaf.startswith("mb_"):
        return 0.1 * rng.standard_normal(shape)
    if ".rwkv." in name and (leaf in ("wa", "wb") or leaf.startswith("ma_")):
        return 0.01 * rng.standard_normal(shape)
    if len(shape) == 1:  # biases
        return np.zeros(shape)
    return rng.standard_normal(shape) * (0.02 if leaf == "table" else shape[0] ** -0.5)


def rec_inputs(out: Path) -> None:
    """Write each recurrent model's weights (the reference's tree, f32) and
    token batches to ``out``, and the serving prompts.  Runs in the test
    process."""
    import torch

    from repro_torch import configs
    from repro_torch.models.convert import params_to_reference
    from repro_torch.models.lm import LM

    rng = np.random.default_rng(11)
    res = {}
    for name in REC_MODELS:
        cfg = rec_cfg(name, configs.get_smoke_config)
        state = {n: torch.from_numpy(_rec_leaf(n, p.shape, rng).astype(np.float32))
                 for n, p in LM(cfg, device="cpu").named_parameters()}
        res.update({f"{name}/params/{k}": v for k, v in flatten(params_to_reference(state)).items()})
        res[f"{name}/tokens"] = rng.integers(0, cfg.vocab_size, (3, REC_B, REC_T)).astype(np.int32)
        res[f"{name}/labels"] = rng.integers(0, cfg.vocab_size, (3, REC_B, REC_T)).astype(np.int32)
        res[f"{name}/prompts"] = rng.integers(0, cfg.vocab_size, (REC_SERVE["requests"], REC_SERVE["prompt"]))
    np.savez(out, **res)


def rec_max_tokens(i: int) -> int:
    """Request ``i``'s token budget in the engine's run (:data:`REC_SERVE`)."""
    return REC_SERVE["steps"] - i % 2


def ref_rec(out: str, part: str) -> None:
    """The reference's side of ``test_torch_recurrent_sharded.py`` on 4 fake
    devices, in two parts that run side by side: ``grads`` (the loss and
    gradients of each model once, on the (2, 2) mesh with FSDP, mamba128 on
    the (1, 4) mesh: the reference's loss is the same function on either
    mesh, SP a layout; then its int8 compressor on the port's zamba2
    gradient) and ``rest`` (two AdamW steps on the (2, 2) mesh with FSDP;
    on the (1, 4) serving context each model's prefill of the prompts but
    their last token and greedy decode from it)."""
    import jax
    import jax.numpy as jnp

    from repro import models
    from repro.configs import get_smoke_config
    from repro.distributed.compat import make_mesh
    from repro.distributed.collectives import make_int8_compressor
    from repro.distributed.sharding import ShardCtx, local_ctx
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import build_train_step

    d = Path(out).parent
    inputs = dict(np.load(d / "inputs.npz"))
    res = {}

    def params_of(name):
        pre = f"{name}/params/"
        return jax.tree.map(jnp.asarray, unflatten({k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}))

    def batch_of(name, i):
        return {"tokens": jnp.asarray(inputs[f"{name}/tokens"][i]), "labels": jnp.asarray(inputs[f"{name}/labels"][i])}

    def ctx_of(mesh, **kw):
        return ShardCtx(mesh=make_mesh(mesh, ("data", "model")), tp="model", dp=("data",), **kw)

    if part == "grads":
        for name, mesh in (("zamba2", (2, 2)), ("rwkv6", (2, 2)), ("mamba128", (1, 4))):
            model = models.build(rec_cfg(name, get_smoke_config), ctx_of(mesh, fsdp="data"))
            (loss, met), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params_of(name), batch_of(name, 0))
            res[f"{name}/loss"], res[f"{name}/ce"] = np.asarray(loss), np.asarray(met["ce"])
            res.update({f"{name}/grad/{k}": v for k, v in flatten(g).items()})
        _wait_ready(d, REC_INT8, "")
        grads = dict(np.load(d / REC_INT8))
        compress, init = make_int8_compressor(local_ctx())
        res.update({f"int8/{k}": np.asarray(v) for k, v in compress(grads, init(grads))[0].items()})
    else:
        opt = AdamWConfig(**OPT)
        for name in ("zamba2", "rwkv6"):
            model = models.build(rec_cfg(name, get_smoke_config), ctx_of((2, 2), fsdp="data"))
            params = params_of(name)
            state = init_opt_state(params, opt)
            step = jax.jit(build_train_step(model, opt))
            for i in range(2):
                params, state, met = step(params, state, batch_of(name, i + 1))
                res[f"adamw/{name}/loss{i}"] = np.asarray(met["loss"])
                res[f"adamw/{name}/grad_norm{i}"] = np.asarray(met["grad_norm"])
            res.update({f"adamw/{name}/params/{k}": v for k, v in flatten(params).items()})
        for name in REC_MODELS:
            model = models.build(rec_cfg(name, get_smoke_config), ctx_of((1, 4), fsdp=None))
            params = params_of(name)
            prompts = inputs[f"{name}/prompts"]
            cache = model.init_cache(prompts.shape[0], REC_SERVE["max_len"])
            logits, cache = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(prompts[:, :-1])}, cache)
            res[f"prefill/{name}/logits"] = np.asarray(logits)
            step = jax.jit(model.decode_step)
            tok, toks = jnp.asarray(prompts[:, -1].astype(np.int32)), []
            for _ in range(REC_SERVE["steps"]):
                logits, cache = step(params, cache, tok)
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            res[f"decode/{name}/tokens"] = np.stack(toks, axis=1)
    np.savez(out, **res)


def _port_model(inputs: dict, name: str, cfg, ctx, **kw):
    """The port's model of ``cfg`` on ``ctx`` (None: one device), this
    rank's shard of the inputs' weights of ``name``."""
    from repro_torch import models
    from repro_torch.models.convert import params_from_reference

    pre = f"{name}/params/"
    tree = unflatten({k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)})
    model = models.build(cfg, ctx, device="cpu", **kw)
    model.load_state_dict(params_from_reference(tree, ctx, cfg))
    return model


def _rec_model(inputs: dict, name: str, ctx, **kw):
    from repro_torch import configs

    return _port_model(inputs, name, rec_cfg(name, configs.get_smoke_config), ctx, **kw)


def _rec_grads(inputs: dict, name: str, ctx, rank: int, tag: str, **kw) -> dict:
    """The port's loss on this rank and (rank 0) every gradient leaf, summed
    over its replicated axes and gathered whole, of the batch ``0`` of
    ``name`` on ``ctx``; with the rank's reduced gradient under ``grads``."""
    import torch

    from repro_torch.models.convert import params_to_reference
    from repro_torch.train.train_step import shard_batch, sync_grads

    model = _rec_model(inputs, name, ctx, **kw).requires_grad_(True)
    b = {"tokens": inputs[f"{name}/tokens"][0], "labels": inputs[f"{name}/labels"][0]}
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in shard_batch(b, ctx).items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    grads = dict(zip(names, grads))
    if ctx is not None:
        grads = sync_grads(grads, ctx, model.param_specs())
    res = {f"{tag}/loss": loss.detach().numpy(), f"{tag}/ce": met["ce"].detach().numpy()}
    whole = params_to_reference(grads, ctx, model.cfg)
    if rank == 0:
        res.update({f"{tag}/grad/{k}": v for k, v in flatten(whole).items()})
    return res, grads, model


def rec_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """The port's side on one of 4 ranks: the training cases on the (2, 2)
    and (1, 4) meshes (and rwkv6's chunked form on the (1, 4) mesh beside one
    device), the int8 compressor, two AdamW steps, prefill on both serving
    meshes, the ``Engine`` at tp 4 and the host-read guard over its decode
    step, the training CLI at ``--mesh 2x2`` (four steps, the step-4
    checkpoint set aside for :func:`rec_one`) and the serving CLI at
    ``--mesh 1x4``."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import make_int8_compressor
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models.convert import params_to_reference
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    from _torch_host_reads import NoHostReads

    _init(rank, world, rdv)
    try:
        inputs = dict(np.load(Path(out_dir).parent / "inputs.npz"))
        meshes = {m: make_mesh(m, ("data", "model"), device_type="cpu") for m in ((2, 2), (1, 4))}
        res = {}
        for tag, name, mesh, sp in REC_TRAIN:
            ctx = _lm_ctx(meshes[mesh], fsdp="data" if mesh[0] > 1 else None, sp=sp)
            out, grads, model = _rec_grads(inputs, name, ctx, rank, tag)
            res.update(out)
            if tag == "zamba2_2x2":  # the int8 compressor on the shards of the reduced gradient
                compress, init_res = make_int8_compressor(ctx, model.param_specs())
                packed = params_to_reference(compress(grads, init_res(grads))[0], ctx, model.cfg)
                whole = params_to_reference(grads, ctx, model.cfg)
                if rank == 0:
                    res.update({f"int8/{k}": v for k, v in flatten(packed).items()})
                    np.savez(Path(out_dir) / "rec_int8.tmp.npz", **flatten(whole))
                    (Path(out_dir) / "rec_int8.tmp.npz").rename(Path(out_dir).parent / REC_INT8)
        if rank == 0:  # rwkv6 on one device, for the mesh's gradients
            res.update(_rec_grads(inputs, "rwkv6", None, 0, "rwkv6_one")[0])
        # rwkv6's chunked form at tp 4 under SP (heads cut) against one device
        ctx = _lm_ctx(meshes[(1, 4)], fsdp=None, sp=True)
        res.update(_rec_grads(inputs, "rwkv6", ctx, rank, "chunked_1x4", rwkv_chunked=True)[0])
        if rank == 0:
            res.update(_rec_grads(inputs, "rwkv6", None, 0, "chunked_one", rwkv_chunked=True)[0])

        opt = AdamWConfig(**OPT)
        for name in ("zamba2", "rwkv6"):
            ctx = _lm_ctx(meshes[(2, 2)], fsdp="data")
            model = _rec_model(inputs, name, ctx).requires_grad_(True)
            state = init_opt_state(dict(model.named_parameters()), opt)
            step = build_train_step(model, opt)
            for i in range(2):
                b = {"tokens": inputs[f"{name}/tokens"][i + 1], "labels": inputs[f"{name}/labels"][i + 1]}
                state, met = step(state, {k: torch.from_numpy(v) for k, v in shard_batch(b, ctx).items()})
                res[f"adamw/{name}/loss{i}"] = float(met["loss"])
                res[f"adamw/{name}/grad_norm{i}"] = float(met["grad_norm"])
            whole = params_to_reference(model.state_dict(), ctx, model.cfg)
            if rank == 0:
                res.update({f"adamw/{name}/params/{k}": v for k, v in flatten(whole).items()})

        for name in REC_MODELS:
            prompts = inputs[f"{name}/prompts"]
            for mesh in ((2, 2), (1, 4)):
                ctx = _lm_ctx(meshes[mesh], fsdp=None)
                model = _rec_model(inputs, name, ctx)
                rows = shard_batch({"p": prompts[:, :-1]}, ctx)["p"]
                cache = model.init_cache(rows.shape[0], REC_SERVE["max_len"])
                res[f"prefill/{name}/{mesh[0]}x{mesh[1]}"] = model.prefill(torch.from_numpy(rows), cache)[0].numpy()
            # the engine at tp 4 (serving takes one data rank): every slot on every rank
            ctx = _serve_ctx(meshes[(1, 4)])
            model = _rec_model(inputs, name, ctx)
            cache = model.init_cache(2, REC_SERVE["max_len"])
            with NoHostReads():
                model.decode_step(cache, torch.tensor([1, 2]))
            eng = Engine(model, slots=REC_SERVE["slots"], max_len=REC_SERVE["max_len"], device="cpu")
            for i, p in enumerate(prompts):
                eng.add(Request(rid=i, prompt=[int(t) for t in p], max_tokens=rec_max_tokens(i)))
            finished = sorted(eng.run(), key=lambda r: r.rid)
            res[f"engine/{name}/tokens"] = np.array([r.out + [-1] * (REC_SERVE["steps"] - len(r.out))
                                                     for r in finished])
            res[f"engine/{name}/decode_steps"] = np.array(eng.decode_steps)

        for name in REC_CLI_ARCHS:
            arch = REC_MODELS[name][0]
            _cli_leg(out_dir, f"cli_{name}", f"cli_{name}", "2x2", True, rank, cli=REC_CLI + ["--arch", arch])
            for mode, legs in _serve_legs("1x4", REC_SERVE_CLI + ["--arch", arch]).items():
                res[f"cli/{name}/{mode}"] = legs
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _serve_ctx(mesh):
    """The serving CLI's context on ``mesh``: tp over ``model``, no fsdp and
    no batch axis (the engine holds every slot on every rank)."""
    from repro_torch.distributed.sharding import ShardCtx

    return ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=())


def rec_one(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One rank: the training CLI at ``--mesh 1x1`` for zamba2 and rwkv6,
    four steps each, then each resumes the 2x2 run's directory from step 2;
    then the serving CLI without a mesh."""
    import torch.distributed as dist

    _init(rank, world, rdv)
    try:
        for name in REC_CLI_ARCHS:
            cli = REC_CLI + ["--arch", REC_MODELS[name][0]]
            _cli_leg(out_dir, f"one_{name}", f"one_{name}", "1x1", False, rank, cli=cli)
            _wait_ready(Path(out_dir).parent, f"cli_{name}")
            _cli_leg(out_dir, f"resume_{name}", f"cli_{name}", "1x1", False, rank, cli=cli)
    finally:
        dist.destroy_process_group()
    res = {}
    for name in REC_CLI_ARCHS:
        for mode, legs in _serve_legs(None, REC_SERVE_CLI + ["--arch", REC_MODELS[name][0]]).items():
            res[f"cli/{name}/{mode}"] = legs
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)


# -- the encoder-decoder and the embeddings models on a mesh ---------------------------

#: The models of ``test_torch_families_sharded.py``: whisper-small's smoke
#: model (4 heads: ``"heads"`` at tp 2 and 4), its variant with 6 heads of 32
#: (``"heads"`` at tp 2; at tp 4 ``"columns"`` without SP, ``"context"`` with
#: it), llava-next-34b's smoke model from embeddings (8 q heads over 2 kv
#: heads: ``"heads"`` at tp 2, ``"columns"``/``"context"`` at tp 4), and the
#: hybrid (zamba2), Mamba2 and RWKV6 smoke models from embeddings; all f32.
FAM_MODELS = {"whisper": ("whisper-small", {}),
              "whisper6": ("whisper-small", {"num_heads": 6, "num_kv_heads": 6, "head_dim": 32}),
              "llava": ("llava-next-34b", {}),
              "zamba2": ("zamba2-1.2b", {"input_kind": "embeds"}),
              "mamba": ("zamba2-1.2b", {"input_kind": "embeds", "family": "ssm"}),
              "rwkv6": ("rwkv6-1.6b", {"input_kind": "embeds"})}
FAM_ENCDEC = ("whisper", "whisper6")
FAM_RECURRENT = ("zamba2", "mamba", "rwkv6")
#: The models with a ``ragged`` batch (:data:`FAM_RAGGED`).
FAM_RAGGED_MODELS = ("whisper", "llava")
#: Batches: B 4 rows of S 24 frames and T 16 tokens (whisper), or of T 16
#: embedding rows (one Mamba2 smoke chunk); ``ragged``: whisper at S 22 and T
#: 10, llava at T 10, lengths tp 4 does not divide (the reference cuts them
#: unevenly under SP; the port runs those stacks without it).
FAM_B, FAM_S, FAM_T = 4, 24, 16
FAM_RAGGED = (22, 10)
FAM_TRAIN = [  # tag, model, mesh, sequence parallelism, batch (FSDP over data where it is 2)
    ("whisper_2x2", "whisper", (2, 2), False, "0"),
    ("whisper_1x4", "whisper", (1, 4), False, "0"),
    ("whisper_1x4_sp", "whisper", (1, 4), True, "0"),
    ("whisper_ragged_1x4_sp", "whisper", (1, 4), True, "ragged"),
    ("whisper6_2x2", "whisper6", (2, 2), False, "0"),
    ("whisper6_1x4", "whisper6", (1, 4), False, "0"),
    ("whisper6_1x4_sp", "whisper6", (1, 4), True, "0"),
    ("llava_2x2", "llava", (2, 2), False, "0"),
    ("llava_1x4", "llava", (1, 4), False, "0"),
    ("llava_1x4_sp", "llava", (1, 4), True, "0"),
    ("llava_ragged_1x4_sp", "llava", (1, 4), True, "ragged"),
    ("zamba2_1x4_sp", "zamba2", (1, 4), True, "0"),
    ("mamba_1x4", "mamba", (1, 4), False, "0"),
    ("rwkv6_1x4_sp", "rwkv6", (1, 4), True, "0"),
]
#: Serving: whisper's prompt of 5 tokens against 24 frames, the embeddings
#: models' of 8 rows; 4 greedy steps; caches of 16 positions (4 a rank at tp 4).
FAM_SERVE = dict(prompt=5, rows=8, steps=4, max_len=16)
#: The models trained two AdamW steps, and the checkpoint resumed across meshes.
FAM_ADAMW = ("whisper", "llava")


def fam_cfg(name: str, get_smoke_config):
    """``name``'s config (:data:`FAM_MODELS`) from either package's getter."""
    arch, over = FAM_MODELS[name]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **over)


def _fam_leaf(name: str, shape, rng) -> np.ndarray:
    """:func:`_rec_leaf`, with the attention's and the MLP's biases N(0, 0.1)
    (the reference's init leaves them zero, so a dropped bias would pass)."""
    if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "bo", "b_in", "b_out"):
        return 0.1 * rng.standard_normal(shape)
    return _rec_leaf(name, shape, rng)


def _fam_batch(cfg, rng, s: int, t: int) -> dict:
    if cfg.is_encdec:
        return {"enc_embeds": rng.standard_normal((FAM_B, s, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (FAM_B, t)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (FAM_B, t)).astype(np.int32)}
    return {"embeds": rng.standard_normal((FAM_B, t, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (FAM_B, t)).astype(np.int32)}


def fam_inputs(out: Path) -> None:
    """Write each model's weights (the reference's tree), its batches 0-2
    (whisper and llava also ``ragged``) and its serving prompt to ``out``.  Runs in the
    test process."""
    import torch

    from repro_torch import configs, models
    from repro_torch.models.convert import params_to_reference

    rng = np.random.default_rng(13)
    res = {}
    for name in FAM_MODELS:
        cfg = fam_cfg(name, configs.get_smoke_config)
        state = {n: torch.from_numpy(_fam_leaf(n, p.shape, rng).astype(np.float32))
                 for n, p in models.build(cfg, device="cpu").named_parameters()}
        res.update({f"{name}/params/{k}": v for k, v in flatten(params_to_reference(state)).items()})
        batches = {str(i): _fam_batch(cfg, rng, FAM_S, FAM_T) for i in range(3)}
        if name in FAM_RAGGED_MODELS:
            batches["ragged"] = _fam_batch(cfg, rng, *FAM_RAGGED)
        for i, b in batches.items():
            res.update({f"{name}/batch{i}/{k}": v for k, v in b.items()})
        prompt = _fam_batch(cfg, rng, FAM_S, FAM_SERVE["prompt"] if cfg.is_encdec else FAM_SERVE["rows"])
        res.update({f"{name}/prompt/{k}": v for k, v in prompt.items() if k != "labels"})
    np.savez(out, **res)


def fam_batch(inputs: dict, name: str, i: str) -> dict:
    pre = f"{name}/batch{i}/"
    return {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}


def fam_prompt(inputs: dict, name: str) -> dict:
    pre = f"{name}/prompt/"
    return {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}


def ref_fam(out: str, part: str) -> None:
    """The reference's side of ``test_torch_families_sharded.py`` on 4 fake
    devices, in two parts that run side by side: ``grads`` (the loss and
    gradients of each model on its batch 0, and on ``ragged`` too, on
    the (2, 2) mesh with FSDP: the reference's loss is the same function on
    every mesh) and ``rest`` (two AdamW steps of whisper and llava on that
    mesh; on the (1, 4) serving context each model's prefill of its prompt
    and greedy steps from it, the caches after the prefill and after the
    steps)."""
    import jax
    import jax.numpy as jnp

    from repro import models
    from repro.configs import get_smoke_config
    from repro.distributed.compat import make_mesh
    from repro.distributed.sharding import ShardCtx
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import build_train_step

    inputs = dict(np.load(Path(out).parent / "inputs.npz"))
    res = {}

    def params_of(name):
        pre = f"{name}/params/"
        return jax.tree.map(jnp.asarray, unflatten({k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}))

    def ctx_of(mesh, **kw):
        return ShardCtx(mesh=make_mesh(mesh, ("data", "model")), tp="model", dp=("data",), **kw)

    if part == "grads":
        for name, i in [(n, "0") for n in FAM_MODELS] + [(n, "ragged") for n in FAM_RAGGED_MODELS]:
            model = models.build(fam_cfg(name, get_smoke_config), ctx_of((2, 2), fsdp="data"))
            batch = {k: jnp.asarray(v) for k, v in fam_batch(inputs, name, i).items()}
            (loss, met), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params_of(name), batch)
            tag = name if i == "0" else f"{name}_{i}"
            res[f"{tag}/loss"], res[f"{tag}/ce"] = np.asarray(loss), np.asarray(met["ce"])
            res.update({f"{tag}/grad/{k}": v for k, v in flatten(g).items()})
    else:
        opt = AdamWConfig(**OPT)
        for name in FAM_ADAMW:
            model = models.build(fam_cfg(name, get_smoke_config), ctx_of((2, 2), fsdp="data"))
            params = params_of(name)
            state = init_opt_state(params, opt)
            step = jax.jit(build_train_step(model, opt))
            for i in range(2):
                batch = {k: jnp.asarray(v) for k, v in fam_batch(inputs, name, str(i + 1)).items()}
                params, state, met = step(params, state, batch)
                res[f"adamw/{name}/loss{i}"] = np.asarray(met["loss"])
                res[f"adamw/{name}/grad_norm{i}"] = np.asarray(met["grad_norm"])
            res.update({f"adamw/{name}/params/{k}": v for k, v in flatten(params).items()})
        for name in FAM_MODELS:
            cfg = fam_cfg(name, get_smoke_config)
            model = models.build(cfg, ctx_of((1, 4), fsdp=None))
            params = params_of(name)
            prompt = {k: jnp.asarray(v) for k, v in fam_prompt(inputs, name).items()}
            if cfg.is_encdec:
                cache = model.init_cache(FAM_B, FAM_SERVE["max_len"], FAM_S)
            else:
                cache = model.init_cache(FAM_B, FAM_SERVE["max_len"])
            logits, cache = jax.jit(model.prefill)(params, prompt, cache)
            res[f"prefill/{name}/logits"] = np.asarray(logits)
            res.update({f"prefill/{name}/cache/{k}": np.asarray(v) for k, v in cache.items()})
            step = jax.jit(model.decode_step)
            tok, toks = jnp.argmax(logits, axis=-1).astype(jnp.int32), []
            for _ in range(FAM_SERVE["steps"]):
                toks.append(np.asarray(tok))
                logits, cache = step(params, cache, tok)
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            res[f"decode/{name}/tokens"] = np.stack(toks, axis=1)
            res.update({f"decode/{name}/cache/{k}": np.asarray(v) for k, v in cache.items()})
    np.savez(out, **res)


def fam_model(inputs: dict, name: str, ctx):
    from repro_torch import configs

    return _port_model(inputs, name, fam_cfg(name, configs.get_smoke_config), ctx)


def fam_grads(inputs: dict, name: str, ctx, batch: str = "0") -> tuple[dict, dict]:
    """The port's loss and ce and every gradient leaf (summed over its
    replicated axes, gathered whole: the reference's tree) of ``name`` on
    ``ctx`` (None: one device) on the batch ``batch``; a leaf the loss does
    not reach (an embeddings model's table) gets a zero gradient, as
    ``build_train_step`` gives it."""
    import torch

    from repro_torch.models.convert import params_to_reference
    from repro_torch.train.train_step import shard_batch, sync_grads

    model = fam_model(inputs, name, ctx).requires_grad_(True)
    loss, met = model.loss({k: torch.from_numpy(v) for k, v in shard_batch(fam_batch(inputs, name, batch),
                                                                          ctx).items()})
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
    if ctx is not None:
        grads = sync_grads(grads, ctx, model.param_specs())
    out = {k: v.detach().numpy() for k, v in met.items() if k == "ce" or k.startswith("seq_parallel")}
    out["loss"] = loss.detach().numpy()
    return out, flatten(params_to_reference(grads, ctx, model.cfg))


def fam_serve(inputs: dict, name: str, ctx, full: bool = False) -> dict:
    """Prefill of ``name``'s prompt (this rank's rows) on ``ctx``: the
    logits; with ``full`` also :data:`FAM_SERVE`'s greedy steps from it, the
    first under the host-read guard, their tokens and, but for the
    recurrent models, every cache leaf after the prefill and after the
    steps, whole over tp."""
    import torch

    from repro_torch.distributed.sharding import gather_leaf
    from repro_torch.train.train_step import shard_batch

    from _torch_host_reads import NoHostReads

    model = fam_model(inputs, name, ctx)
    cfg = model.cfg
    prompt = {k: torch.from_numpy(v) for k, v in shard_batch(fam_prompt(inputs, name), ctx).items()}
    B = next(iter(prompt.values())).shape[0]
    if cfg.is_encdec:
        cache = model.init_cache(B, FAM_SERVE["max_len"], FAM_S)
        logits, cache = model.prefill(prompt, cache)
    else:
        cache = model.init_cache(B, FAM_SERVE["max_len"])
        logits, cache = model.prefill(prompt["embeds"], cache)
    res = {"logits": logits.numpy()}
    if not full:
        return res

    def whole(tag):
        if name in FAM_RECURRENT:
            return {}
        return {f"{tag}/{k}": (gather_leaf(ctx, v, (None, None, ctx.tp, None, None)) if v.dim() == 5 else v).numpy().copy()
                for k, v in cache.items()}

    res.update(whole("cache"))
    tok, toks = logits.argmax(-1), []
    for i in range(FAM_SERVE["steps"]):
        toks.append(tok)
        if i == 0:
            with NoHostReads():
                logits, cache = model.decode_step(cache, tok)
        else:
            logits, cache = model.decode_step(cache, tok)
        tok = logits.argmax(-1)
    toks.append(tok)
    res["tokens"] = torch.stack(toks, 1).numpy()
    res.update(whole("decode_cache"))
    return res


def fam_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """The port's side on one of 4 ranks: the training cases
    (:data:`FAM_TRAIN`), two AdamW steps of whisper and llava at (2, 2) with
    FSDP, the first step's checkpoint resumed at (1, 4) with SP for the
    second, and serving on the (2, 2) and (1, 4) serving contexts."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models.convert import (opt_state_from_reference, opt_state_to_reference,
                                            params_from_reference, params_to_reference)
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    _init(rank, world, rdv)
    try:
        inputs = dict(np.load(Path(out_dir).parent / "inputs.npz"))
        meshes = {m: make_mesh(m, ("data", "model"), device_type="cpu") for m in ((2, 2), (1, 4))}
        res = {}
        for tag, name, mesh, sp, batch in FAM_TRAIN:
            ctx = _lm_ctx(meshes[mesh], fsdp="data" if mesh[0] > 1 else None, sp=sp)
            out, grads = fam_grads(inputs, name, ctx, batch)
            res.update({f"{tag}/{k}": v for k, v in out.items()})
            if rank == 0:
                res.update({f"{tag}/grad/{k}": v for k, v in grads.items()})

        opt = AdamWConfig(**OPT)
        for name in FAM_ADAMW:
            ctx = _lm_ctx(meshes[(2, 2)], fsdp="data")
            model = fam_model(inputs, name, ctx).requires_grad_(True)
            state = init_opt_state(dict(model.named_parameters()), opt)
            step = build_train_step(model, opt)
            ckpt = Path(out_dir).parent / f"ckpt_{name}"
            for i in range(2):
                b = shard_batch(fam_batch(inputs, name, str(i + 1)), ctx)
                state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
                res[f"adamw/{name}/loss{i}"] = float(met["loss"])
                res[f"adamw/{name}/grad_norm{i}"] = float(met["grad_norm"])
                if i == 0:  # every rank gathers the whole trees; rank 0 writes them
                    tree = {"params": params_to_reference(model.state_dict(), ctx, model.cfg),
                            "opt": opt_state_to_reference(state, ctx, model.cfg)}
                    if rank == 0:
                        CheckpointManager(ckpt).save(1, tree)
                    dist.barrier()
            whole = params_to_reference(model.state_dict(), ctx, model.cfg)
            if rank == 0:
                res.update({f"adamw/{name}/params/{k}": v for k, v in flatten(whole).items()})
            # the step-1 checkpoint resumed on the (1, 4) mesh under SP for the second step
            ctx = _lm_ctx(meshes[(1, 4)], fsdp=None, sp=True)
            tree, manifest = CheckpointManager(ckpt).restore(1)
            model = fam_model(inputs, name, ctx)
            model.load_state_dict(params_from_reference(tree["params"], ctx, model.cfg))
            model.requires_grad_(True)
            state = opt_state_from_reference(tree["opt"], ctx, model.cfg)
            b = shard_batch(fam_batch(inputs, name, "2"), ctx)
            state, met = build_train_step(model, opt)(state, {k: torch.from_numpy(v) for k, v in b.items()})
            res[f"resume/{name}/loss"] = float(met["loss"])
            res[f"resume/{name}/grad_norm"] = float(met["grad_norm"])
            res[f"resume/{name}/step"] = int(manifest["step"])
            whole = params_to_reference(model.state_dict(), ctx, model.cfg)
            if rank == 0:
                res.update({f"resume/{name}/params/{k}": v for k, v in flatten(whole).items()})

        for name in FAM_MODELS:
            for mesh in ((2, 2), (1, 4)):
                ctx = _lm_ctx(meshes[mesh], fsdp=None)
                got = fam_serve(inputs, name, ctx, full=mesh == (1, 4))
                res.update({f"serve/{name}/{mesh[0]}x{mesh[1]}/{k}": v for k, v in got.items()})
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# -- the dry run against a real step (test_torch_dryrun_ranks.py) -------------------

#: The cells: each arch's smoke config, one train step with SP
#: (``launch.dryrun.build_ctx``), B 8 x T 32, on a (data 2, model 2) mesh and
#: on a (pod 2, data 2, model 1) one, whose FSDP runs over the flattened
#: (pod, data) group as the 512-rank mesh's does.
DRY = dict(meshes={"flat": ((2, 2), ("data", "model")), "pod": ((2, 2, 1), ("pod", "data", "model"))},
           batch=8, seq=32, archs=("mistral-nemo-12b", "granite-moe-3b-a800m"))


def dry_costs(result: dict, prefix: str) -> dict:
    """A cost dict's flops, collectives and kernels as flat npz entries."""
    out = {f"{prefix}/flops": np.float64(result["flops"])}
    for kind, c in result["per_collective"].items():
        out[f"{prefix}/coll/{kind}/count"] = np.int64(c["count"])
        out[f"{prefix}/coll/{kind}/bytes"] = np.int64(c["bytes"])
    for name, k in result["kernels"].items():
        out[f"{prefix}/kernel/{name}/calls"] = np.int64(k["calls"])
        out[f"{prefix}/kernel/{name}/flops"] = np.float64(k["flops"])
    return out


def dry_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One gloo rank: each ``DRY`` arch's train step on each ``DRY`` mesh,
    on this rank's rows of a batch, the step's costs counted
    (``obs.costs.count``), written as :func:`dry_costs` under
    ``mesh/arch``."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs, models
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import UNCHUNKED, build_ctx, pick_microbatches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import costs
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    _init(rank, world, rdv)
    try:
        res = {}
        for (name, (dims, axes)), arch in itertools.product(DRY["meshes"].items(), DRY["archs"]):
            mesh = make_mesh(dims, axes, "cpu")
            cfg = configs.get_smoke_config(arch)
            ctx = build_ctx(mesh, DRY["batch"], DRY["seq"], "train")
            model = models.build(cfg, ctx, device="cpu")
            model.init(torch.Generator().manual_seed(0))
            model.requires_grad_(True)
            opt_cfg = AdamWConfig(chunk_threshold_bytes=UNCHUNKED)
            mb = pick_microbatches(cfg, DRY["batch"], DRY["seq"], ctx)
            step = build_train_step(model, opt_cfg, microbatches=mb)
            state = init_opt_state(dict(model.named_parameters()), opt_cfg)
            batch = shard_batch(make_batch(cfg, DRY["batch"], DRY["seq"], torch.Generator().manual_seed(1)), ctx, mb)
            with costs.count() as counter:
                step(state, batch)
            res.update(dry_costs(counter.result(), f"{name}/{arch}"))
            res[f"{name}/{arch}/microbatches"] = np.int64(mb)
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


# -- bounded runs --------------------------------------------------------------------


def _rank_main(rank: int, name: str, world: int, rdv: str, out_dir: str) -> None:
    """A spawned rank: its output to ``rank{r}.log``, then ``name``'s worker."""
    log = open(Path(out_dir) / f"rank{rank}.log", "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    globals()[name](rank, world, rdv, out_dir)


def start_ranks(fn, out_dir: Path, world: int = WORLD):
    """Start ``fn(rank, world, rendezvous, out_dir)`` on ``world`` gloo ranks
    without waiting (:func:`join_ranks` waits).  ``out_dir`` is this run's
    own directory."""
    import torch.multiprocessing as mp

    out_dir.mkdir(parents=True, exist_ok=True)
    pc = mp.start_processes(_rank_main, args=(fn.__name__, world, str(out_dir / "rendezvous"), str(out_dir)),
                            nprocs=world, join=False, start_method="spawn")
    pc.out_dir, pc.world, pc.deadline = out_dir, world, time.monotonic() + RANKS_DEADLINE
    return pc


def _logs(out_dir: Path, world: int) -> str:
    parts = []
    for r in range(world):
        f = out_dir / f"rank{r}.log"
        parts.append(f"--- rank {r} ---\n" + (f.read_text()[-4000:] if f.exists() else "(no output)"))
    return "\n".join(parts)


def join_ranks(pc) -> list:
    """Wait for :func:`start_ranks`' ranks up to their deadline and load
    each rank's npz.  A rank that fails, or a run past the deadline, kills
    every rank and raises AssertionError with the ranks' output."""
    from torch.multiprocessing import ProcessExitedException, ProcessRaisedException

    try:
        while not pc.join(timeout=max(0.05, min(1.0, pc.deadline - time.monotonic()))):
            if time.monotonic() > pc.deadline:
                raise TimeoutError(f"the ranks ran past {RANKS_DEADLINE} s")
    except (ProcessRaisedException, ProcessExitedException, TimeoutError) as e:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
        raise AssertionError(f"{e}\n{_logs(pc.out_dir, pc.world)}") from None
    return [dict(np.load(pc.out_dir / f"rank{r}.npz")) for r in range(pc.world)]


def spawn_ranks(fn, out_dir: Path, world: int = WORLD) -> list:
    """Run ``fn(rank, world, rendezvous, out_dir)`` on ``world`` gloo ranks,
    bounded by ``RANKS_DEADLINE``, and load each rank's npz."""
    return join_ranks(start_ranks(fn, out_dir, world))


def start_reference(name: str, out: Path, devices: int = WORLD) -> subprocess.Popen:
    """Start ``python _torch_dist_workers.py name out`` on ``devices`` fake
    CPU devices."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    proc = subprocess.Popen([sys.executable, str(Path(__file__)), name, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.deadline = time.monotonic() + REFERENCE_DEADLINE
    return proc


def finish_reference(proc: subprocess.Popen) -> None:
    """Wait for :func:`start_reference`'s subprocess up to its deadline; kill
    it on overrun; raise AssertionError with its output unless it ended
    well."""
    try:
        log, _ = proc.communicate(timeout=max(1.0, proc.deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        raise AssertionError(f"the reference ran past {REFERENCE_DEADLINE} s:\n{log[-4000:]}") from None
    assert proc.returncode == 0, log[-8000:]


def run_both(ref_name: str, rank_fn, d: Path, devices: int = WORLD, world: int = WORLD):
    """The reference subprocess and the port's ranks side by side, both
    bounded: (the reference's npz, every rank's npz)."""
    ref = start_reference(ref_name, d / "ref.npz", devices)
    try:
        ranks = spawn_ranks(rank_fn, d, world)
    except BaseException:
        ref.kill()
        ref.communicate()
        raise
    finish_reference(ref)
    return dict(np.load(d / "ref.npz")), ranks


if __name__ == "__main__":
    {"ref_sort": ref_sort, "ref_dist": ref_dist, "ref_cli": ref_cli,
     "ref_lm_grads": lambda out: ref_lm(out, "grads"), "ref_lm_rest": lambda out: ref_lm(out, "rest"),
     "ref_cp_train": lambda out: ref_cp(out, "train"), "ref_cp_rest": lambda out: ref_cp(out, "rest"),
     "ref_rec_grads": lambda out: ref_rec(out, "grads"), "ref_rec_rest": lambda out: ref_rec(out, "rest"),
     "ref_fam_grads": lambda out: ref_fam(out, "grads"), "ref_fam_rest": lambda out: ref_fam(out, "rest"),
     }[sys.argv[1]](sys.argv[2])
