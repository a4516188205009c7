"""Serving CLI: slot-based continuous batching over a smoke or full config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
        [--smoke] [--device cuda|cpu] [--requests 8] [--slots 4] [--max-tokens 16]

``--arch`` takes the dense ``mistral-nemo-12b`` (and the other dense
configs), the MoE ``granite-moe-3b-a800m`` and ``deepseek-moe-16b``, the
hybrid ``zamba2-1.2b`` and the RWKV6 ``rwkv6-1.6b``.  The encoder-decoder (``whisper-small``)
and the embeddings model (``llava-next-34b``) are refused, as the
reference's CLI refuses the first and its engine prefills tokens alone.

Counterpart of ``repro.launch.serve``: the weights are drawn from
``--seed`` on the device, prompts of 2-11 tokens from numpy's
``default_rng(seed)``.  Without ``--mesh`` it serves from one device;
``--mesh 1xM`` serves the model sharded over tp (the ``model`` axis), one
process a device under ``torchrun --nproc-per-node=M`` (:mod:`.mesh`),
with the sequence-sharded KV cache (where M does not divide the kv heads,
the attention's columns split heads), a recurrent model's states cut by
heads; every rank holds every slot and
samples the same token, and rank 0 prints.  A data axis above 1 is refused:
the engine holds every slot on every rank (the reference's CLI fails there
too: its batch-1 admission prefill does not split over the data axis).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import models, resolve_device
from ..configs import get_config, get_smoke_config
from ..serve.engine import Engine, Request
from ..serve.sampler import SampleConfig
from .mesh import mesh_context, rank_device


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, help="1xM (default: one device, no process group)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit("the serve CLI takes decoder-only archs")
    if cfg.input_kind != "tokens":
        raise SystemExit("the serve CLI takes token prompts: its Engine has no embeddings prefill")
    dev = resolve_device(args.device)
    if args.mesh is not None:
        dev = rank_device(dev)
    with mesh_context(args.mesh, dev, train=False) as ctx:
        return _serve(args, cfg, ctx, dev)


def _serve(args, cfg, ctx, dev) -> list[Request]:
    lead = ctx is None or dist.get_rank() == 0
    model = models.build(cfg, ctx=ctx, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(args.seed))

    eng = Engine(
        model, slots=args.slots, max_len=args.max_len,
        sample_cfg=SampleConfig(temperature=args.temperature, top_k=args.top_k),
        seed=args.seed, device=dev,
    )
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(2, 12))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        eng.add(Request(rid=rid, prompt=prompt, max_tokens=args.max_tokens))

    t0 = time.perf_counter()
    finished = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in finished)
    if not lead:
        return finished
    print(f"served {len(finished)} requests, {tokens} tokens "
          f"in {dt:.2f}s ({tokens/dt:.1f} tok/s) on {dev}")
    for r in finished[:4]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}…")
    return finished


if __name__ == "__main__":
    main()
