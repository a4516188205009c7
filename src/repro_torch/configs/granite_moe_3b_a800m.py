"""granite-moe-3b-a800m [moe]: 40 experts top-8, fine-grained d_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

import dataclasses

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,              # = expert hidden
    vocab_size=49_155,
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_expert=512,
        num_shared=0,
        capacity_factor=1.25,
    ),
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, num_shared=0,
                  capacity_factor=2.0),
)
