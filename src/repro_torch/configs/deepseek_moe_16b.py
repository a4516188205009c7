"""deepseek-moe-16b [moe]: fine-grained 64 routed experts top-6 + 2 shared,
first layer dense.  [arXiv:2401.06066; hf]"""

import dataclasses

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,       # MHA
    d_ff=1408,             # = expert hidden (fine-grained)
    vocab_size=102_400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared=2,
        capacity_factor=1.25,
        first_dense_layers=1,
        d_ff_dense=10_944,
    ),
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, num_shared=1,
                  capacity_factor=2.0, first_dense_layers=1, d_ff_dense=256),
)
