"""End-to-end training driver on the PyTorch port: a deepseek-style MoE LM
with sort-based expert dispatch (K3 on the card), fault-tolerant
checkpointing, and loss verification.  The twin of
``examples/train_moe.py`` on ``repro_torch``.

Default is a fast ~10M-param run; ``--big`` trains a ~100M-param model.

    PYTHONPATH=src python examples/torch_train_moe.py --steps 120 [--device cuda|cpu]
    PYTHONPATH=src python examples/torch_train_moe.py --big --steps 300

The weights are drawn from a ``torch.Generator`` seeded 0 (the reference
draws from ``PRNGKey(0)``), so the losses differ from the reference's run.
Checkpoints hold the reference's tree
(:func:`repro_torch.models.convert.params_to_reference`); the default
directory is ``build/torch_moe_ckpt`` under the checkout.
"""

import argparse
import time
from pathlib import Path

import _bootstrap  # noqa: F401
import torch

from repro_torch import models, resolve_device
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.convert import opt_state_to_reference, params_to_reference
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import build_train_step

DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / "torch_moe_ckpt"


def make_config(big: bool) -> ModelConfig:
    if big:  # ~100M params, 16 experts top-2
        return ModelConfig(
            name="moe-100m", family="moe", num_layers=8, d_model=512,
            num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=8192,
            moe=MoEConfig(num_experts=16, top_k=2, d_expert=512,
                          num_shared=1, capacity_factor=2.0),
        )
    return ModelConfig(
        name="moe-10m", family="moe", num_layers=4, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=2048,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=256,
                      num_shared=1, capacity_factor=2.0),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = make_config(args.big)
    model = models.build(cfg, device=dev).requires_grad_(True)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active), "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}")

    model.init(torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    step_fn = build_train_step(model, opt_cfg)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
        opt, metrics = step_fn(opt, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"aux {float(metrics.get('aux', 0.0)):.4f}", flush=True)
        if (step + 1) % 50 == 0:
            mgr.save(step + 1, {"params": params_to_reference(model.state_dict()),
                                "opt": opt_state_to_reference(opt), "data": pipe.state()})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tok = args.steps * args.batch * args.seq
    print(f"\n{tok} tokens in {dt:.1f}s ({tok/dt:.0f} tok/s)")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'OK: learning' if losses[-1] < losses[0] - 0.5 else 'WARN'})")
    if mgr.latest_step():
        print(f"checkpoints at {args.ckpt_dir}: steps {mgr.all_steps()}")


if __name__ == "__main__":
    main()
