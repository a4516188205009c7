"""Training CLI: config -> model -> token pipeline -> fault-tolerant train loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
        --smoke [--device cuda|cpu] [--dtype float32] --steps 100 --batch 8 \
        --seq 128 --ckpt-dir /tmp/ckpt

``--arch`` takes the dense ``mistral-nemo-12b`` (and the other dense
configs), the MoE ``granite-moe-3b-a800m`` and ``deepseek-moe-16b``, the
hybrid ``zamba2-1.2b`` and the RWKV6 ``rwkv6-1.6b``.  The embeddings models (``whisper-small``,
``llava-next-34b``) are refused up front: the token pipeline carries no
embeddings (the reference's CLI fails at its first step).

Counterpart of ``repro.launch.train``: the reference's flags, plus
``--device`` (default ``cuda``; it raises without a card unless asked for
``cpu``) and ``--dtype`` (default the config's).  Without ``--mesh`` it trains on
one device; ``--mesh DxM`` (or ``PxDxM``) trains the model sharded over a
``(data, model)`` mesh, one process a device under ``torchrun
--nproc-per-node=D*M`` (:mod:`.mesh`): tp over ``model``, FSDP over ``data``
when it is more than 1, each rank its rows of every global batch; where
``M`` does not divide the kv heads the attention's columns split heads
(sequence parallelism, and with it context parallelism, is not set by the
CLI, as the reference's sets it not).  It
resumes from the newest checkpoint in ``--ckpt-dir`` (parameters, optimizer
state and data cursor), writes checkpoints asynchronously every
``--ckpt-every`` steps and at the end, logs loss, gradient norm and learning
rate every ``--log-every`` steps and flags straggler steps.  The weights are
drawn from ``--seed`` on the device.

Checkpoints hold the reference's trees (parameters stacked under ``layers``,
:func:`~repro_torch.models.convert.params_to_reference`), whole whatever the
mesh: on a mesh the shards are all-gathered and rank 0 writes, and every
rank resumes by cutting its shard.  So each CLI resumes from the other's
directory, at any mesh.  A directory written before the port saved that
tree (flat ``layers.<i>.`` state-dict names) resumes as well.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

import torch.distributed as dist

from .. import models, resolve_device
from ..configs import get_config, get_smoke_config
from ..data.tokens import TokenPipeline
from ..distributed.collectives import StragglerMonitor, make_int8_compressor
from ..models.convert import opt_state_from_reference, opt_state_to_reference, params_from_reference, params_to_reference
from ..train.checkpoint import AsyncCheckpointer, CheckpointManager
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import build_train_step, shard_batch
from .mesh import mesh_context, rank_device


def main(argv=None) -> list[dict]:
    """Runs the loop; returns one record per step run here: ``step``,
    ``loss``, ``grad_norm``, ``lr`` and ``straggler``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, help="DxM or PxDxM (default: one device, no process group)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec or cfg.input_kind != "tokens":
        raise SystemExit(f"{cfg.name} trains on embeddings: the token pipeline carries no embeddings")
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    dev = resolve_device(args.device)
    if args.mesh is not None:
        dev = rank_device(dev)
    with mesh_context(args.mesh, dev, train=True) as ctx:
        return _train(args, cfg, ctx, dev)


def _train(args, cfg, ctx, dev) -> list[dict]:
    lead = ctx is None or dist.get_rank() == 0
    model = models.build(cfg, ctx=ctx, device=dev).requires_grad_(True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1), total_steps=args.steps)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if ctx is not None:
            dist.barrier()  # every rank has read the directory before rank 0 writes to it
        ckpt = AsyncCheckpointer(mgr) if lead else None
        if mgr.latest_step() is not None:
            state, manifest = mgr.restore()
            params, opt = state["params"], state["opt"]
            if isinstance(params.get("layers"), dict):  # the reference's stacked tree
                params, opt = params_from_reference(params, ctx, cfg), opt_state_from_reference(opt, ctx, cfg)
            model.load_state_dict(params)
            opt_state = {"m": {k: v.to(dev) for k, v in opt["m"].items()},
                         "v": {k: v.to(dev) for k, v in opt["v"].items()},
                         "step": opt["step"].to(device=dev, dtype=torch.int32)}
            pipe = TokenPipeline.restore(cfg.vocab_size, args.batch, args.seq, state["data"])
            start_step = manifest["step"]
            if lead:
                print(f"resumed from step {start_step}")
    if start_step == 0:
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        opt_state = init_opt_state(dict(model.named_parameters()), opt_cfg)

    hook = None
    if args.compress_grads:
        compress, init_res = make_int8_compressor(ctx, model.param_specs() if ctx is not None else None)
        res_holder = {"r": None}

        def hook(grads):
            if res_holder["r"] is None:
                res_holder["r"] = init_res(grads)
            g, res_holder["r"] = compress(grads, res_holder["r"])
            return g

    step_fn = build_train_step(model, opt_cfg, microbatches=args.microbatches, grad_compressor=hook)
    mon = StragglerMonitor()

    def snapshot():
        """The whole reference tree (gathered by every rank on a mesh)."""
        return {"params": params_to_reference(model.state_dict(), ctx, cfg),
                "opt": opt_state_to_reference(opt_state, ctx, cfg), "data": pipe.state()}

    def save(step):
        snap = snapshot()
        if ckpt is not None:
            ckpt.save(step, snap)

    records = []
    for step in range(start_step, args.steps):
        rows = shard_batch(pipe.next_batch(), ctx, args.microbatches)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
        mon.start()
        opt_state, metrics = step_fn(opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        straggler = mon.stop()
        rec = {"step": step, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "straggler": straggler}
        records.append(rec)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {rec['loss']:.4f} gnorm {rec['grad_norm']:.3f} "
                  f"lr {rec['lr']:.2e}" + ("  [straggler]" if straggler else ""), flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if args.ckpt_dir:
        if args.steps % args.ckpt_every:  # not already saved by the loop
            save(args.steps)
        if ckpt is not None:
            ckpt.close()
        if ctx is not None:
            dist.barrier()  # the checkpoint is on disk before any rank returns
    if lead:
        print("timing:", mon.summary())
    return records


if __name__ == "__main__":
    main()
