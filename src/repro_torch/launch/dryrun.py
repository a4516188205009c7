"""Multi-pod dry run: trace every (arch x shape x mesh) cell as one rank.

The port's counterpart of :mod:`repro.launch.dryrun`.  For each cell it
traces the port's own step -- the train step, ``prefill`` or ``decode_step``
-- as rank 0 of a 256-rank ``(data 16, model 16)`` world or a 512-rank
``(pod 2, data 16, model 16)`` one, and reports that rank's costs.  The
world is ``torch.distributed``'s ``"fake"`` backend (:func:`fake_world`:
every collective returns at once) and every tensor lies on the meta device,
so nothing is allocated, computed or sent and no card is needed: the model
is built at the rank's shard (:func:`repro_torch.models.build` on
``device="meta"``), and each hand-written kernel's wrapper returns empty
outputs of its shapes and counts its own work.

The reference lowers and compiles each cell with XLA and reads XLA's
analyses.  The port has no compiler: :mod:`repro_torch.obs.costs` counts the
ops the port runs, eagerly, under the same rules (``flops_per_device``,
``bytes_per_device``, ``collective_bytes_per_device``, ``per_collective``,
``collectives``), and ``memory`` from the storages' lifetimes.  So the bytes
are those of unfused ops, each reading and writing its tensors; prefill
ignores ``sp`` (ROADMAP §3), so a prefill cell holds whole-T activations where
the reference's holds T / tp.  ``lower_s`` and ``compile_s`` become
``trace_s``; ``xla_cost_*`` (XLA's own analysis), ``code_bytes`` (compiled
code) and ``loops`` (HLO while loops) have no counterpart and are dropped.  A
train cell of several microbatches counts the first one for all of them
(:func:`repro_torch.obs.costs.repeats`: they run the same ops on the same
shapes; ``tests/test_torch_dryrun.py`` holds the folded count to the full
one).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        [--multi-pod | --both-meshes] [--rwkv-chunked] [--out F]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback

import torch
import torch.distributed as dist

from .. import models
from ..configs import get_config, list_archs
from ..data.synthetic import input_specs
from ..distributed.sharding import ShardCtx
from ..obs import costs
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import build_train_step
from .mesh import make_production_mesh

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32_768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32_768, batch=128, kind="decode"),
    "long_500k": dict(seq=524_288, batch=1, kind="decode"),
}

# long_500k needs O(1)-state decode: run only for ssm/hybrid archs
# (DESIGN.md §7); pure full-attention archs record an explicit skip.
LONG_OK = {"zamba2-1.2b", "rwkv6-1.6b"}

# >=100B params: bf16 optimizer moments (DESIGN.md §5)
BF16_MOMENT_ARCHS = {"command-r-plus-104b", "nemotron-4-340b"}

#: AdamW's row chunk in the dry run: no leaf is chunked, as the reference's
#: ``chunked_update=False``.
UNCHUNKED = 1 << 62


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``world_size``-rank process group of the ``"fake"`` backend, this
    process its rank 0, destroyed on exit.  Raises if a group is already
    started."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_ctx(mesh, batch: int, seq: int, kind: str) -> ShardCtx:
    shape = mesh_shape(mesh)
    dp = ("pod", "data") if "pod" in shape else ("data",)
    # ZeRO state shards across ALL dp ranks: pod x data on the 512-rank mesh
    fsdp = ("pod", "data") if "pod" in shape else "data"
    dp_size = math.prod(shape[a] for a in dp)
    if batch % dp_size or batch < dp_size:
        dp = ()  # replicate tiny batches (long-context decode)
    tp_size = shape["model"]
    sp = kind in ("train", "prefill") and seq % tp_size == 0
    return ShardCtx(mesh=mesh, tp="model", fsdp=fsdp, dp=dp, sp=sp)


def pick_microbatches(cfg, batch: int, seq: int, ctx: ShardCtx) -> int:
    """Memory napkin: keep per-device remat-saved residuals under ~2 GB."""
    dp_size = max(math.prod(ctx.axis_size(a) for a in ctx.dp) if ctx.dp else 1, 1)
    tp = ctx.tp_size if ctx.sp else 1
    tokens_local = batch // dp_size * seq // tp
    resid_bytes = cfg.num_layers * tokens_local * cfg.d_model * 2
    target = 2e9
    mb = 1
    while resid_bytes / mb > target and (batch // (2 * mb)) % max(dp_size, 1) == 0 and batch // (2 * mb) >= dp_size:
        mb *= 2
    return mb


def lower_cell(arch: str, shape_name: str, mesh, verbose: bool = True, rwkv_chunked: bool = False, *,
               cfg=None, spec: dict | None = None, chunk_bytes: int = UNCHUNKED) -> dict:
    """The result dict of one cell: ``arch`` at ``SHAPES[shape_name]``
    (``spec`` in its place, a dict of ``seq``, ``batch`` and ``kind``) on
    ``mesh`` (its process group started), traced as the mesh's rank 0.
    ``cfg`` replaces ``get_config(arch)`` (a smoke config); ``chunk_bytes``
    is AdamW's ``chunk_threshold_bytes`` (none chunked by default).  A
    train step's first microbatch is counted for all."""
    spec = SHAPES[shape_name] if spec is None else spec
    seq, batch, kind = spec["seq"], spec["batch"], spec["kind"]
    cfg = get_config(arch) if cfg is None else cfg
    shape = mesh_shape(mesh)

    if shape_name == "long_500k" and arch not in LONG_OK:
        return {
            "arch": arch, "shape": shape_name, "status": "skipped",
            "reason": "pure full-attention arch: no sub-quadratic path (DESIGN.md §7)",
        }

    ctx = build_ctx(mesh, batch, seq, kind)
    kw = {"rwkv_chunked": True} if cfg.rwkv is not None and rwkv_chunked else {}
    t0 = time.perf_counter()
    model = models.build(cfg, ctx, device="meta", **kw)
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    rows = batch // ctx.dp_size  # this rank's rows of the batch
    extra: dict = {}
    args: dict = {"params": params}
    if kind == "train":
        big = arch in BF16_MOMENT_ARCHS
        opt_cfg = AdamWConfig(moment_dtype="bfloat16" if big else "float32", chunk_threshold_bytes=chunk_bytes)
        mb = pick_microbatches(cfg, batch, seq, ctx)
        model.requires_grad_(True)
        args["opt_state"] = init_opt_state(dict(model.named_parameters()), opt_cfg)
        args["batch"] = input_specs(cfg, rows, seq)
        step = build_train_step(model, opt_cfg, microbatches=mb,
                                accum_dtype=torch.bfloat16 if big else torch.float32)

        def run():
            return step(args["opt_state"], args["batch"])

        extra = {"microbatches": mb}
    else:
        cache_kw = {"enc_len": seq} if cfg.is_encdec else {}
        args["cache"] = model.init_cache(rows, seq, **cache_kw)
        if kind == "prefill":
            batch_in = input_specs(cfg, rows, seq)
            batch_in.pop("labels")
            args["batch"] = batch_in
            inputs = batch_in if cfg.is_encdec else next(iter(batch_in.values()))

            def run():
                return model.prefill(inputs, args["cache"])
        else:
            args["batch"] = {"tokens": torch.empty((rows,), dtype=torch.int32, device="meta")}

            def run():
                return model.decode_step(args["cache"], args["batch"]["tokens"])

    with costs.count(fold_repeats=True) as counter:
        counter.arguments(**args)
        out = run()
    got = counter.result(out)
    trace_s = time.perf_counter() - t0
    memory = got["memory"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "kind": kind,
        "mesh": shape,
        "status": "ok",
        "seq": seq,
        "batch": batch,
        "params_b": cfg.param_count(),
        "active_params_b": cfg.active_param_count(),
        "flops_per_device": got["flops"],
        "bytes_per_device": got["bytes"],
        "collective_bytes_per_device": got["collective_bytes"],
        "per_collective": got["per_collective"],
        "kernels": got["kernels"],
        "memory": memory,
        "collectives": got["collectives"],
        "ctx": {"dp": list(ctx.dp), "fsdp": ctx.fsdp, "sp": ctx.sp, "rows": rows},
        "trace_s": round(trace_s, 3),
        **extra,
    }
    if verbose:
        hbm = memory["argument_bytes"] + memory["temp_bytes"]
        print(f"  ok  flops/dev={result['flops_per_device']:.3e} "
              f"hbm/dev={hbm / 2**30:.2f}GiB "
              f"coll={result['collective_bytes_per_device'] / 2**20:.1f}MiB "
              f"trace={trace_s:.1f}s", flush=True)
    return result


def run_cells(archs, shapes, multi_pod: bool, *, rwkv_chunked: bool = False,
              verbose: bool = True) -> list[dict]:
    """Every (arch, shape) cell on one production mesh, in a fake world of
    its own; a cell that raises is recorded as an ``error``."""
    results = []
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        shape = mesh_shape(mesh)
        if verbose:
            print(f"== mesh {shape} ({math.prod(shape.values())} ranks) ==", flush=True)
        for arch in archs:
            for name in shapes:
                if verbose:
                    print(f"[{arch} × {name}]", flush=True)
                try:
                    r = lower_cell(arch, name, mesh, verbose=verbose, rwkv_chunked=rwkv_chunked)
                except Exception as e:
                    traceback.print_exc()
                    r = {"arch": arch, "shape": name, "mesh": shape, "status": "error", "error": repr(e)}
                if r["status"] == "skipped" and verbose:
                    print(f"  skipped: {r['reason']}")
                results.append(r)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Trace every (arch x shape x mesh) cell as one rank of a fake world")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rwkv-chunked", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for multi_pod in meshes:
        results += run_cells(archs, shapes, multi_pod, rwkv_chunked=args.rwkv_chunked)

    ok = sum(r["status"] == "ok" for r in results)
    skipped = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n== {ok} ok / {skipped} skipped / {err} errors ==")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
