#!/usr/bin/env python3
"""The sharded fabric across the cards of one host, one process per card.

    python3 scripts/sharded_cards.py [--ranks 4] [--n KEYS] [--seq TOKENS] [--seed S] [--device cuda|cpu]

Starts ``--ranks`` processes (``torch.multiprocessing.spawn``, a ``file://``
rendezvous in a temporary directory): NCCL, one card each, or gloo with
``--device cpu`` (a rehearsal on the host).  Rank 0 prints one JSON line a
phase, then the cards' names and power limit, then ``{"ok": true, ...}``;
a failed check exits non-zero before that.

1. ``sort`` -- ``sort_sharded`` on ``random_trace(n, seed)`` as int64 (rank
   ``r`` holds keys ``[r n / R, (r + 1) n / R)``), presort block 256,
   capacity factor 2.0: every rank's valid chunk equals its slice of
   ``torch.sort`` of the whole input, nothing dropped, K1 once a rank; the
   median of three calls (a barrier and a synchronise around each), keys/s
   over all ranks, each rank's peak memory;
2. ``pool`` -- ``run_pipeline`` on ``chip_smoke.py``'s ``end_to_end``
   configuration with one server a rank and ``pool_backend="shard_map"``
   at ``n`` keys on every rank: output and passes equal to the numpy pool's,
   the gather called once, its seconds;
3. ``moe_a2a`` -- granite-moe-3b-a800m's MoE layer at full width, bf16, tp
   = R with sequence parallelism: 1 x (R * seq) tokens, rank ``r`` its T
   chunk, expert slabs ``r``; against ``moe_layer`` on the whole input on
   every rank: dropped equal, aux within 1e-5, the output chunk and every
   gradient of ``sum(y^2) + aux`` within ``chip_smoke.MOE_A2A_LIMIT``; forward
   and backward ms (median of three) beside ``moe_layer``'s on ``seq``
   tokens on one card;
4. ``lm_train`` (two lines an arch) -- each LM of ``--lm-arch`` (default
   Mistral-Nemo-12B at all 40 layers, which one card cannot train; the
   hybrid ``zamba2-1.2b`` and the RWKV6 ``rwkv6-1.6b`` as well, their
   blocks cut by heads over tp; the encoder-decoder ``whisper-small`` and
   the embeddings model ``llava-next-34b`` at ``FAMILY_TRAIN``'s shapes) on a
   ``(1, R)`` mesh and a
   ``(R/2, 2)`` mesh with FSDP over data, ``LM_STEPS`` AdamW steps of B
   ``--lm-batch`` x ``--lm-seq`` tokens: step seconds, tokens/s, each rank's
   peak memory, the losses of the two meshes beside each other; rank 0's
   kernel launches a step, and one more step under ``torch.profiler``: the
   NCCL kernels' share of the kernel time, the share of the wall with a
   kernel running, the costliest kernels;
5. ``lm_serve`` (a line an arch) -- the LM served at ``(1, R)`` (the
   sequence-sharded cache, or the recurrent states cut by heads; the decode
   step captured with its NCCL collectives) and by each rank alone on its
   card, 8 requests of 64-511 prompt tokens, 32 greedy tokens each: ms per
   decode step of both, how many requests' tokens are equal, rank 0's
   kernel launches on the mesh's run; the logits of both and of the
   one-card model in float32 on the same weights (the distance between
   the one-card model and that copy is the dtype's rounding) on the first
   prompt, and where a request's tokens part, at that position: each
   pair's largest difference beside the gap between the two tokens.
   ``family_serve`` takes its place for whisper-small and llava-next-34b,
   which no ``Engine`` drives (:func:`phase_family_serve`).

6. ``cp`` (two lines, ``--phases cp``: not in the default run) --
   starcoder2-15b (``CP_ARCH``: 4 kv heads, which tp 8 does not divide) at
   ``(1, R)``: ``LM_STEPS`` AdamW steps with sequence parallelism, so the
   attention runs context-parallel (each rank its T chunk against the
   gathered K/V, K5/K5b at its query offset), B ``CP_BATCH`` x
   ``--lm-seq`` tokens: step seconds,
   tokens/s, losses, every rank's peak memory; then served without SP (the
   attention's columns split through heads) against each rank alone on its
   card, as ``lm_serve``.  A card's bytes under the context-parallel layout
   at tp 8: the attention weights whole on every rank (40 x 81.8M = 3.27B
   parameters), the MLP, embedding and head cut eight ways (1.59B): 4.86B
   parameters, 9.7 GB in bf16, as much again for the gradients and 38.9 GB
   for the f32 AdamW moments, 58 GB before activations -- so the batch is
   cut (``CP_BATCH``), never the widths.

``--phases sort``, ``lm`` or ``cp`` runs one group, ``--lm-phases train``
or ``serve`` one of the lm group's; ``--lm-smoke`` the LM phases at the
smoke config (a rehearsal with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: AdamW steps of each ``lm_train`` mesh (the first includes the warm-up).
LM_STEPS = 3
#: The ``cp`` phase's model and global batch (the module docstring says why 1).
CP_ARCH = "starcoder2-15b"
CP_BATCH = 1


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"sharded_cards: FAILED: {msg}")


def _median_s(torch, dist, fn, reps: int = 3) -> tuple[float, list]:
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dist.barrier()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], times


def phase_sort(torch, dist, args, dev, rank: int, world: int) -> dict:
    from repro_torch.core import distributed as cd
    from repro_torch.data.traces import random_trace
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.kernels import build

    mesh = make_mesh((world,), ("segment",), dev.type)
    full = random_trace(args.n, seed=args.seed)
    n_loc = args.n // world
    x = torch.from_numpy(full[rank * n_loc : (rank + 1) * n_loc]).to(dev)
    splitters = cd.make_splitters(full[:: max(1, args.n // 4096)], world)
    kw = dict(capacity_factor=2.0, presort_block=256)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    padded, valid, overflow = cd.sort_sharded(x, mesh, "segment", splitters, **kw)
    k1 = build.LAUNCHES["row_sort"]
    counts = torch.zeros(world, dtype=torch.int64, device=dev)
    counts[rank] = valid[0]
    dist.all_reduce(counts)
    drops = overflow.clone()
    dist.all_reduce(drops)
    start = int(counts[:rank].sum())
    want = torch.sort(torch.from_numpy(full[: n_loc * world]).to(dev)).values[start : start + int(valid)]
    _check(int(drops) == 0 and int(counts.sum()) == n_loc * world, f"dropped {int(drops)}, valid {counts.tolist()}")
    _check(torch.equal(padded[: int(valid)], want), f"rank {rank}'s range differs from torch.sort")
    _check(k1 == (1 if dev.type == "cuda" else 0), f"K1 launched {k1} times")
    del padded, want
    med, times = _median_s(torch, dist, lambda: cd.sort_sharded(x, mesh, "segment", splitters, **kw))
    peak = torch.tensor([torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0], device=dev)
    peaks = [torch.zeros_like(peak) for _ in range(world)]
    dist.all_gather(peaks, peak)
    return {"phase": "sort", "n": n_loc * world, "ranks": world, "dtype": "int64", **kw,
            "capacity_per_rank": n_loc * 2, "valid_per_rank": counts.tolist(), "seconds": times,
            "median_s": med, "keys_per_s": n_loc * world / med,
            "peak_device_bytes_per_rank": [int(p) for p in peaks], "k1_launches_per_rank": k1}


def phase_pool(torch, dist, args, dev, world: int) -> dict:
    import chip_smoke
    from repro_torch.core import distributed as cd
    from repro_torch.data.traces import random_trace, trace_max_value
    from repro_torch.net.pipeline import run_pipeline

    cfg = dict(chip_smoke.E2E, num_servers=world)
    values = torch.from_numpy(random_trace(args.n, seed=args.seed)).to(dev)
    calls = []
    inner = cd.pool_concat_sharded
    cd.pool_concat_sharded = lambda *a, **k: calls.append(1) or inner(*a, **k)
    try:
        runs = {}
        for backend in ("numpy", "shard_map"):
            dist.barrier()
            t0 = time.perf_counter()
            res = run_pipeline(values, max_value=trace_max_value("random"), seed=args.seed,
                               device=dev, pool_backend=backend, **cfg)
            runs[backend] = (res, time.perf_counter() - t0)
    finally:
        cd.pool_concat_sharded = inner
    (a, a_s), (b, b_s) = runs["numpy"], runs["shard_map"]
    _check(torch.equal(a.output, b.output) and a.passes == b.passes, "the shard_map pool differs from numpy's")
    _check(len(calls) == 1, f"the gather ran {len(calls)} times")
    return {"phase": "pool", "n": args.n, "num_servers": world, "numpy_s": a_s, "shard_map_s": b_s,
            "pool_merge_s": {"numpy": a.pool_merge_seconds, "shard_map": b.pool_merge_seconds}}


def phase_moe(torch, dist, args, dev, rank: int, world: int) -> dict:
    import chip_smoke
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.lm import init_params

    cfg = configs.get_config(chip_smoke.SHARDED_MOE["arch"])
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    full = init_params(moe.MoE(cfg, dt, dev), gen).requires_grad_(True)
    part = moe.MoE(cfg, dt, dev, tp_size=world)
    part.load_state_dict(params_from_reference(full.state_dict(), sharding.ShardCtx.grid(model=(rank, world))))
    part.requires_grad_(True)
    ctx = sharding.ShardCtx(mesh=make_mesh((1, world), ("data", "model"), dev.type), tp="model",
                            fsdp=None, dp=("data",), sp=True)
    x = torch.randn((1, world * args.seq, cfg.d_model), generator=gen, device=dev).to(dt)
    t = slice(rank * args.seq, (rank + 1) * args.seq)

    def step(p, fn, xi):
        p.zero_grad(set_to_none=True)
        xi = xi.clone().requires_grad_(True)
        y, aux, dropped = fn(xi)
        (y.float().square().sum() + aux).backward()
        return y.detach(), float(aux.detach()), int(dropped), xi.grad, {k: v.grad for k, v in p.named_parameters()}

    a2a = lambda xi: moe.moe_layer_a2a(part, cfg, ctx, xi)  # noqa: E731
    ya, auxa, da, gxa, ga = step(part, a2a, x[:, t])
    yb, auxb, db, gxb, gb = step(full, lambda xi: moe.moe_layer(full, cfg, xi), x)
    dist.all_reduce(ga["router"])

    def rel(u, v) -> float:
        return float((u.float() - v.float()).abs().max() / v.float().abs().max())

    e = full.w_in.shape[0] // world
    errs = {"y": rel(ya, yb[:, t]), "grad_x": rel(gxa, gxb[:, t]), "grad_router": rel(ga["router"], gb["router"]),
            **{f"grad_{k}": rel(ga[k], gb[k][rank * e : (rank + 1) * e]) for k in ("w_in", "w_gate", "w_out")}}
    _check(da == db, f"dropped {da} against moe_layer's {db}")
    _check(abs(auxa - auxb) <= 1e-5 * abs(auxb), f"aux {auxa} against {auxb}")
    _check(all(v <= chip_smoke.MOE_A2A_LIMIT for v in errs.values()), f"beyond the limit: {errs}")
    a2a_s, _ = _median_s(torch, dist, lambda: step(part, a2a, x[:, t]))
    one = x[:, : args.seq]
    local_s, _ = _median_s(torch, dist, lambda: step(full, lambda xi: moe.moe_layer(full, cfg, xi), one))
    errs_all = [None] * world
    dist.all_gather_object(errs_all, errs)
    return {"phase": "moe_a2a", "arch": cfg.name, "tp": world, "tokens": world * args.seq,
            "tokens_per_rank": args.seq, "dtype": "bfloat16", "dropped": da, "aux": auxa,
            "limit": chip_smoke.MOE_A2A_LIMIT, "rel_err_per_rank": errs_all,
            "a2a_fwd_bwd_ms": a2a_s * 1e3, "moe_layer_one_card_fwd_bwd_ms": local_s * 1e3}


#: The encoder-decoder's and the embeddings model's runs (``lm_train``,
#: ``family_serve``): whisper-small trained at ``TRAIN_ENCDEC``'s B 8 x (1,500
#: frames + 448 tokens) and served at ``SERVE_ENCDEC``'s 4 x 1,500 frames;
#: llava-next-34b trained at 40 of its 60 layers, B 2 x 2,048 embedding rows
#: (a rank's shard of 40 layers is 5.8B parameters, 69.7 GB with its bf16
#: gradient and f32 AdamW moments: 44 layers would need 76.4 GB of the 80; B
#: 2 so that the 2x2 mesh's two data ranks get a row each), served whole at
#: ``SERVE_EMBEDS``' traffic (``--lm-layers`` cuts the float32 check).
FAMILY_TRAIN = {"whisper-small": dict(batch=8, seq=448, frames=1500),
                "llava-next-34b": dict(batch=2, seq=2048, layers=40)}


def lm_config(args, arch: str, layers: int | None = None):
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_smoke_config(arch) if args.lm_smoke else configs.get_config(arch)
    if args.lm_dtype:
        cfg = dataclasses.replace(cfg, dtype=args.lm_dtype)
    layers = args.lm_layers or (None if args.lm_smoke else layers)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _profiled_step(torch, dist, dev, fn) -> dict | None:
    """``fn()`` (one more train step) under ``torch.profiler`` on every rank:
    rank 0's wall seconds (the profiler's host cost included), its kernels'
    summed device ms, the NCCL kernels' share of them (a collective's time
    includes its wait for the slowest rank), the share of the wall in which
    some kernel ran, and the eight costliest kernels.  None on the CPU or
    where the profiler saw no kernel."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dist.barrier()
    # device-side ranges of user annotations (NCCL names each call's) repeat their kernels' time
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(by_name.values())
    nccl = sum(ms for name, ms in by_name.items() if "nccl" in name.lower())
    return {"wall_s": wall, "kernels": len(kernels), "kernel_ms": total, "nccl_kernel_ms": nccl,
            "nccl_share_of_kernel_ms": nccl / total, "busy_share_of_wall": busy / 1e6 / wall,
            "top_kernels_ms": sorted(((ms, name[:80]) for name, ms in by_name.items()), reverse=True)[:8]}


def phase_lm_train(torch, dist, args, dev, rank: int, world: int, arch: str) -> list[dict]:
    """``arch`` (default Mistral-Nemo-12B at all 40 layers), bf16, trained ``LM_STEPS`` AdamW
    steps at ``--mesh 1xR`` and at ``(R/2)x2`` (FSDP over data) on the same
    ``TokenPipeline`` batches (B ``--lm-batch`` x ``--lm-seq``): each mesh's
    steps ms, tokens/s over the ranks and every rank's peak memory; the two
    meshes' losses beside each other; rank 0's kernel launches a step
    (counted from zero before the steps) and one more step profiled
    (:func:`_profiled_step`)."""
    import numpy as np

    import chip_smoke
    from repro_torch import models
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.kernels import build
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    fam = FAMILY_TRAIN.get(arch, {})
    cfg = lm_config(args, arch, fam.get("layers"))
    batch_rows, seq, frames = fam.get("batch", args.lm_batch), fam.get("seq", args.lm_seq), fam.get("frames", 0)
    if args.lm_smoke:
        frames = min(frames, 36)
    lines = []
    for shape in ((1, world), (world // 2, 2)):
        ctx = ShardCtx(mesh=make_mesh(shape, ("data", "model"), dev.type), tp="model",
                       fsdp=None if shape[0] == 1 else "data", dp=("data",))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = models.build(cfg, ctx=ctx, device=dev).requires_grad_(True)
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        opt_cfg = AdamWConfig(lr=3e-4)
        state = init_opt_state(dict(model.named_parameters()), opt_cfg)
        step = build_train_step(model, opt_cfg)
        # every rank draws the global batch from the seed and keeps its rows
        next_batch = chip_smoke.batch_source(torch, cfg, batch_rows, seq, args.seed, dev, frames)
        recs = []
        build.reset_launches()
        for i in range(LM_STEPS):
            batch = shard_batch(next_batch(), ctx)
            dist.barrier()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dist.barrier()
            recs.append({"step": i, "s": time.perf_counter() - t0, "loss": float(met["loss"]),
                         "grad_norm": float(met["grad_norm"])})
        launches = {k: n // LM_STEPS for k, n in build.LAUNCHES.items() if n}
        _check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs), f"{shape}: a loss is not finite")
        batch = shard_batch(next_batch(), ctx)
        profile = _profiled_step(torch, dist, dev, lambda: step(state, batch))
        peak = torch.tensor([torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0], device=dev)
        peaks = [torch.zeros_like(peak) for _ in range(world)]
        dist.all_gather(peaks, peak)
        med = float(np.median([r["s"] for r in recs[1:]]))
        tokens = batch_rows * seq
        lines.append({"phase": "lm_train", "arch": cfg.name, "layers": cfg.num_layers, "mesh": list(shape),
                      "fsdp": ctx.fsdp, "batch": batch_rows, "seq": seq, "frames": frames, "steps": recs,
                      "params_per_rank": sum(p.numel() for p in model.parameters()),
                      "step_s_median_after_first": med, "tokens_per_s": tokens / med,
                      "peak_device_bytes_per_rank": [int(p) for p in peaks],
                      "launches_per_step_rank0": launches, "profiled_step_rank0": profile})
        del model, state, step
    a, b = (ln["steps"] for ln in lines)
    lines[-1]["loss_rel_diff_vs_first_mesh"] = [abs(x["loss"] - y["loss"]) / abs(x["loss"]) for x, y in zip(a, b)]
    return lines


def phase_lm_serve(torch, dist, args, dev, rank: int, world: int, cfg) -> dict:
    """``cfg`` (``lm``: Mistral-Nemo-12B at full width and depth, bf16)
    served at ``--mesh 1xR`` (the sequence-sharded cache, or the recurrent
    states cut by heads; the decode step captured with its NCCL collectives)
    and by each rank alone on its card: the same 8 requests, greedy; ms per
    decode step of both; the tokens compared; rank 0's kernel launches on
    the mesh's run (counted from zero before it; a captured decode step's
    kernel nodes times its replays).  Then the logits, against the one-card
    model in float32 on the same (rounded) weights, whose distance from the
    one-card logits is the model dtype's rounding: the first prompt's
    prefill logits of all three, and for each request whose tokens part,
    the three models' prefill logits at that position (its prompt and the
    tokens both runs share), each pair's largest difference beside the gap
    between the two tokens."""
    import dataclasses

    import numpy as np

    from repro_torch import models
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.kernels import build
    from repro_torch.serve.engine import Engine, Request

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(64, 512))).tolist() for _ in range(8)]
    out, held, launches = {}, {}, {}
    for name, ctx in (("one_card", None),
                      ("mesh", ShardCtx(mesh=make_mesh((1, world), ("data", "model"), dev.type), tp="model",
                                        fsdp=None, dp=()))):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        model = models.build(cfg, ctx=ctx, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        eng = Engine(model, slots=4, max_len=1024, device=dev)
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_tokens=32))
        times = []
        orig = eng._decode

        def timed():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = orig()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return logits

        eng._decode = timed
        dist.barrier()
        build.reset_launches()
        finished = eng.run()
        if name == "mesh":
            launches = {k: n for k, n in build.LAUNCHES.items() if n}
            if eng.decode_graph is not None:
                nodes = build.graph_kernel_nodes(eng.decode_graph, ["decode_partial", "wkv_forward"])
                launches["graph_nodes_per_decode_step"] = nodes
                for key, entry in (("decode_attention", "decode_partial"), ("wkv", "wkv_forward")):
                    if nodes[entry]:
                        launches[key] = launches.get(key, 0) + nodes[entry] * eng.decode_steps
        out[name] = {"tokens": sorted((r.rid, r.out) for r in finished),
                     "ms_per_decode_step_median": sorted(times)[len(times) // 2] * 1e3,
                     "decode_steps": len(times), "captured": eng.decode_graph is not None}
        # free the captured graph (its NCCL collectives) before the group goes
        eng._decode = orig
        if eng.decode_graph is not None:
            eng.decode_graph.reset()
        del eng, finished
        gc.collect()
        held[name] = model
    if cfg.dtype != "float32":
        f32 = models.build(dataclasses.replace(cfg, dtype="float32"), device=dev)
        with torch.no_grad():
            for (k, p), (k1, p1) in zip(f32.named_parameters(), held["one_card"].named_parameters(), strict=True):
                _check(k == k1 and p.shape == p1.shape, f"the float32 copy's {k} is not the model's {k1}")
                p.copy_(p1)
        held["float32"] = f32

    def logits_at(tokens: list[int]) -> dict:
        with torch.no_grad():
            return {name: m.prefill(torch.tensor([tokens], device=dev), m.init_cache(1, 1024))[0][0, :cfg.vocab_size]
                    .float().cpu() for name, m in held.items()}

    def compare(lg: dict, a: int | None = None, b: int | None = None) -> dict:
        one, mesh = lg["one_card"], lg["mesh"]
        top2 = one.topk(2).values
        res = {"mesh_vs_one_card_max_abs": float((mesh - one).abs().max()), "one_card_std": float(one.std()),
               "one_card_top2_gap": float(top2[0] - top2[1]), "argmax_equal": bool(mesh.argmax() == one.argmax())}
        if "float32" in lg:
            res["one_card_vs_float32_max_abs"] = float((one - lg["float32"]).abs().max())
        if a is not None:
            res.update({"tokens": [a, b], "argmax": {k: int(v.argmax()) for k, v in lg.items()},
                        **{f"gap_{k}": float(v[a] - v[b]) for k, v in lg.items()}})
        return res

    first = compare(logits_at(prompts[0]))
    # rank 0's tokens on every rank, so that all ranks make the same prefill calls
    toks = [dict(out[k]["tokens"]) for k in ("one_card", "mesh")]
    dist.broadcast_object_list(toks, src=0)
    one_toks, mesh_toks = toks
    same, parted = 0, []
    for rid, p in enumerate(prompts):
        a_out, b_out = one_toks[rid], mesh_toks[rid]
        at = next((i for i, (x, y) in enumerate(zip(a_out, b_out)) if x != y), None)
        if at is None:
            same += a_out == b_out
            continue
        parted.append({"rid": rid, "at": at, **compare(logits_at(p + a_out[:at]), a_out[at], b_out[at])})
    for v in out.values():
        del v["tokens"]
    del held
    gc.collect()
    return {"phase": "lm_serve", "arch": cfg.name, "dtype": str(cfg.dtype), "tp": world, "requests": len(prompts),
            "requests_with_equal_tokens": same, "first_prompt_prefill_logits": first, "parted": parted,
            "launches_mesh_rank0": launches, **out}


def phase_family_serve(torch, dist, args, dev, rank: int, world: int, cfg) -> dict:
    """The encoder-decoder or the embeddings model (``cfg``), served by each
    rank alone on its card and at ``--mesh 1xR`` (the sequence-sharded self
    and cross caches; the decode step captured with its NCCL collectives),
    one after the other (llava's whole 68.8 GB and its 17.2 GB shard do not
    fit one card together): whisper a prefill of ``SERVE_ENCDEC``'s 4 x
    1,500 frames and 4-token prompt, llava one prompt of 1-5 576-row tiles a
    slot of 4 (``SERVE_EMBEDS``), then 32 greedy steps of every row; ms per
    decode step (the graph's replay between two synchronisations, median;
    ``chip_smoke``'s ``capture_decode`` and ``decode_loop``), the prefill's
    seconds, each rank's peak memory, rank 0's launches on the mesh's run
    (``chip_smoke.serve_launches``: a captured step's kernel nodes times its
    replays), how many rows' tokens are equal, and the first row's prefill
    logits' largest difference beside the gap between its two best tokens
    on one card."""
    import numpy as np

    import chip_smoke
    from repro_torch import models
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.kernels import build

    steps = 32
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encdec:
        run = chip_smoke.SERVE_ENCDEC
        B, frames = run["batch"], 36 if args.lm_smoke else run["frames"]
        prompt = {"enc_embeds": (torch.randn(B, frames, cfg.d_model, generator=gen, device=dev)
                                 * chip_smoke.EMBED_SCALE).to(dt),
                  "tokens": torch.tensor([[t % cfg.vocab_size for t in run["prompt"]]] * B, device=dev)}
    else:
        run = chip_smoke.SERVE_EMBEDS
        B, tile = run["slots"], 8 if args.lm_smoke else run["tile"]
        tiles = np.random.default_rng(args.seed).integers(run["tiles"][0], run["tiles"][1] + 1, size=B)
        prompt = [(torch.randn(1, int(n) * tile, cfg.d_model, generator=gen, device=dev)
                   * chip_smoke.EMBED_SCALE).to(dt) for n in tiles]
    mesh = ShardCtx(mesh=make_mesh((1, world), ("data", "model"), dev.type), tp="model", fsdp=None, dp=())
    out, toks, first = {}, {}, {}
    for name, ctx in (("one_card", None), ("mesh", mesh)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = models.build(cfg, ctx=ctx, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        if cfg.is_encdec:
            cache = model.init_cache(B, run["max_len"], frames)
        else:
            cache = model.init_cache(B, 256 if args.lm_smoke else run["max_len"])
        graph = chip_smoke.capture_decode(torch, model, cache, B, dev.type)
        dist.barrier()
        build.reset_launches()
        t0 = time.perf_counter()
        if cfg.is_encdec:
            logits, _ = model.prefill(prompt, cache)
        else:
            parts = []
            for s, p in enumerate(prompt):
                view = {k: v[s:s + 1] if k == "pos" else v[:, s:s + 1] for k, v in cache.items()}
                parts.append(model.prefill(p, view)[0])
            logits = torch.cat(parts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        first[name] = logits[0, :cfg.vocab_size].float().cpu()
        toks[name], times, finite = chip_smoke.decode_loop(torch, model, cache, logits, steps, graph)
        _check(finite, f"{cfg.name} ({name}): a decode step's logits are not finite")
        launches = chip_smoke.serve_launches(build, graph, dict(build.LAUNCHES), steps)
        if graph is not None:
            graph[0].reset()  # its NCCL collectives go before the group does
        peak = torch.tensor([torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0], device=dev)
        peaks = [torch.zeros_like(peak) for _ in range(world)]
        dist.all_gather(peaks, peak)
        out[name] = {"prefill_s": prefill_s, "ms_per_decode_step_median": sorted(times)[len(times) // 2] * 1e3,
                     "decode_steps": steps, "captured": graph is not None,
                     "peak_device_bytes_per_rank": [int(p) for p in peaks], "launches_rank0": launches}
        del model, cache, graph, logits
        gc.collect()
    one, mesh_logits = first["one_card"], first["mesh"]
    top2 = one.topk(2).values
    same = int((toks["one_card"] == toks["mesh"]).all(dim=1).sum())
    if cfg.dtype == "float32":
        _check(same == B, f"{cfg.name} in float32: {B - same} of {B} rows' tokens differ from one card's")
    return {"phase": "family_serve", "arch": cfg.name, "layers": cfg.num_layers, "dtype": str(cfg.dtype),
            "tp": world, "rows": B, "rows_with_equal_tokens": same,
            "first_row_prefill_logits": {"mesh_vs_one_card_max_abs": float((mesh_logits - one).abs().max()),
                                         "one_card_top2_gap": float(top2[0] - top2[1]),
                                         "argmax_equal": bool(mesh_logits.argmax() == one.argmax())},
            "first_tokens": {k: v[:, :8].tolist() for k, v in toks.items()}, **out}


def phase_cp(torch, dist, args, dev, rank: int, world: int) -> list[dict]:
    """``CP_ARCH`` at ``(1, R)``: trained with SP (context-parallel
    attention, checked to be the layout) and served without it (column
    split) beside each rank alone on its card."""
    import numpy as np

    from repro_torch import configs, models
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardCtx
    from repro_torch.kernels import build
    from repro_torch.models.attention import attn_layout
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, shard_batch

    cfg = lm_config(args, CP_ARCH)
    mesh = make_mesh((1, world), ("data", "model"), dev.type)
    ctx = ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=("data",), sp=True)
    _check(attn_layout(cfg, ctx) == "context", f"{cfg.name} at tp {world}: the attention is not context-parallel")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = models.build(cfg, ctx=ctx, device=dev).requires_grad_(True)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    opt_cfg = AdamWConfig(lr=3e-4)
    state = init_opt_state(dict(model.named_parameters()), opt_cfg)
    step = build_train_step(model, opt_cfg)
    pipe = TokenPipeline(cfg.vocab_size, CP_BATCH, args.lm_seq, seed=args.seed)
    recs = []
    build.reset_launches()
    for i in range(LM_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(pipe.next_batch(), ctx).items()}
        dist.barrier()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        recs.append({"step": i, "s": time.perf_counter() - t0, "loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"])})
    launches = dict(build.LAUNCHES)
    _check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs), "cp: a loss is not finite")
    _check(dev.type == "cpu" or (launches["flash_attention"] == 2 * cfg.num_layers * LM_STEPS
                                 and launches["flash_attention_bwd"] == cfg.num_layers * LM_STEPS),
           f"cp: K5/K5b launches {launches}, want 2 and 1 a layer a step")
    peak = torch.tensor([torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0], device=dev)
    peaks = [torch.zeros_like(peak) for _ in range(world)]
    dist.all_gather(peaks, peak)
    med = float(np.median([r["s"] for r in recs[1:]]))
    train = {"phase": "cp_train", "arch": cfg.name, "layers": cfg.num_layers, "mesh": [1, world], "sp": True,
             "layout": "context", "batch": CP_BATCH, "seq": args.lm_seq, "steps": recs,
             "params_per_rank": sum(p.numel() for p in model.parameters()),
             "step_s_median_after_first": med, "tokens_per_s": CP_BATCH * args.lm_seq / med,
             "launches": {k: launches[k] for k in ("flash_attention", "flash_attention_bwd")},
             "peak_device_bytes_per_rank": [int(p) for p in peaks]}
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    serve = phase_lm_serve(torch, dist, args, dev, rank, world, cfg)
    serve.update(phase="cp_serve", layout=attn_layout(cfg, ShardCtx(mesh=mesh, tp="model", fsdp=None, dp=())))
    return [train, serve]


def run_rank(rank: int, world: int, rdv: str, args) -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import torch.distributed as dist

    dev = torch.device(args.device, rank) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{rdv}",
                            rank=rank, world_size=world)
    try:
        phases = []
        if "sort" in args.phases:
            phases += [lambda: [phase_sort(torch, dist, args, dev, rank, world)],
                       lambda: [phase_pool(torch, dist, args, dev, world)],
                       lambda: [phase_moe(torch, dist, args, dev, rank, world)]]
        if "lm" in args.phases:
            for arch in args.lm_arch:
                if "train" in args.lm_phases:
                    phases.append(lambda arch=arch: phase_lm_train(torch, dist, args, dev, rank, world, arch))
                if "serve" in args.lm_phases:
                    serve = phase_family_serve if arch in FAMILY_TRAIN else phase_lm_serve
                    phases.append(lambda arch=arch, serve=serve: [serve(torch, dist, args, dev, rank, world,
                                                                        lm_config(args, arch))])
        if "cp" in args.phases:
            phases += [lambda: phase_cp(torch, dist, args, dev, rank, world)]
        for phase in phases:
            for line in phase():
                if rank == 0:
                    print(json.dumps(line), flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=100_000_000, help="keys in the sort and the pool run")
    ap.add_argument("--seq", type=int, default=2048, help="MoE tokens a rank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--phases", nargs="+", choices=("sort", "lm", "cp"), default=["sort", "lm"])
    ap.add_argument("--lm-arch", nargs="+", default=["mistral-nemo-12b"],
                    help="the lm phases' archs, one after the other")
    ap.add_argument("--lm-phases", nargs="+", choices=("train", "serve"), default=["train", "serve"],
                    help="the lm group's phases, for each arch")
    ap.add_argument("--lm-smoke", action="store_true", help="the LM phases at the arch's smoke config")
    ap.add_argument("--lm-dtype", choices=("float32", "bfloat16"), default=None, help="default: the config's")
    ap.add_argument("--lm-layers", type=int, default=None,
                    help="cut every lm phase's model to this many layers (default: llava-next-34b trains at "
                         "40 of 60, every other model whole)")
    ap.add_argument("--lm-batch", type=int, default=2)
    ap.add_argument("--lm-seq", type=int, default=2048)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"sharded_cards: {args.ranks} ranks need {args.ranks} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if args.device == "cuda":
        import chip_smoke
        from repro_torch.kernels import build

        smi = chip_smoke.smi_line()
        build.build_kernels()  # once, before the ranks load them
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run_rank, args=(args.ranks, f"{tmp}/rendezvous", args), nprocs=args.ranks, join=True)
    if args.device == "cuda":
        print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": args.device if args.device == "cpu" else "gpu",
                                             "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
                                             "count": args.ranks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
