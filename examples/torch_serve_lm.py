"""End-to-end serving driver on the PyTorch port: batched requests through
the continuous-batching engine with the partial-sort top-k sampler.  The
twin of ``examples/serve_lm.py`` on ``repro_torch``; on the card the engine
replays its decode step as one CUDA graph.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 12 --slots 4 [--device cuda|cpu]

The weights are drawn from a ``torch.Generator`` seeded 0 (the reference
draws from ``PRNGKey(0)``), so the tokens differ from the reference's; the
schedule (steps, active slots, tokens per request) is the same.
"""

import argparse
import time

import _bootstrap  # noqa: F401
import numpy as np
import torch

from repro_torch import models, resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampler import SampleConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=24)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = models.build(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"serving {cfg.name} (reduced config, "
          f"{cfg.param_count()/1e6:.1f}M params), "
          f"{args.slots} slots, top-k={args.top_k}")

    eng = Engine(
        model, slots=args.slots, max_len=128,
        sample_cfg=SampleConfig(temperature=args.temperature,
                                top_k=args.top_k),
        device=dev,
    )
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        plen = int(rng.integers(2, 16))
        eng.add(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, size=plen).tolist(),
            max_tokens=args.max_tokens,
        ))

    t0 = time.perf_counter()
    steps = 0
    while eng.queue or any(eng.active):
        active = eng.step()
        steps += 1
        if steps % 16 == 0:
            print(f"  step {steps}: {active} active, "
                  f"{len(eng.queue)} queued, {len(eng.finished)} done")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in eng.finished)
    print(f"\nserved {len(eng.finished)} requests / {tokens} tokens "
          f"in {dt:.2f}s ({tokens/dt:.1f} tok/s, {steps} engine steps)")
    for r in eng.finished[:3]:
        print(f"  req {r.rid}: {len(r.prompt)}-token prompt -> {r.out}")


if __name__ == "__main__":
    main()
