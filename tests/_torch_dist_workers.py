"""Workers of the port's multi-rank parity tests (``test_torch_sharded_sort.py``,
``test_torch_distributed.py``).

Two kinds, both writing numpy arrays to ``.npz`` files that the tests compare:

* ``ref_sort`` / ``ref_dist`` run the JAX package's sharded functions on 8
  fake CPU devices.  They run in a subprocess started with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the flag must not
  reach the test process):
  ``python tests/_torch_dist_workers.py ref_sort OUT.npz``.
* ``sort_rank`` / ``dist_rank`` run one gloo rank of the port each, started
  by :func:`spawn_ranks` (``torch.multiprocessing.spawn``, a ``file://``
  rendezvous in the test's temporary directory, so parallel test workers
  never share a port); rank ``r`` writes ``rank{r}.npz``.

The inputs are made here from numpy seeds, so both sides see the same
arrays; each side computes its own splitters, mesh and results.  Imports of
jax, ``repro`` and ``repro_torch`` stay inside the functions of their side.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

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
    from repro_torch.distributed.sharding import ShardCtx, fsdp_gather
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
        dpi, tpi = ctx.axis_index("data"), ctx.axis_index("model")
        T_loc = MOE_T // ctx.tp_size
        x = moe_input(cfg.d_model)[dpi : dpi + 1, tpi * T_loc : (tpi + 1) * T_loc]
        for name in ("y", "aux"):
            p = moe.MoE(cfg, torch.float32, "cpu", tp_size=ctx.tp_size)
            p.load_state_dict(params_from_reference(tree, tp_rank=tpi, tp_size=ctx.tp_size))
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


def spawn_ranks(fn, out_dir: Path, world: int = WORLD) -> list:
    """Run ``fn(rank, world, rendezvous, out_dir)`` on ``world`` gloo ranks
    and load each rank's npz."""
    import torch.multiprocessing as mp

    mp.spawn(fn, args=(world, str(out_dir / "rendezvous"), str(out_dir)), nprocs=world, join=True)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


if __name__ == "__main__":
    {"ref_sort": ref_sort, "ref_dist": ref_dist}[sys.argv[1]](sys.argv[2])
