"""zamba2-1.2b [hybrid]: Mamba2 backbone + one shared attention block
invoked every 6 SSM layers (params reused).  [arXiv:2411.15242; hf]"""

import dataclasses

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,      # MHA on the shared block
    d_ff=8192,
    vocab_size=32_000,
    ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, num_groups=8,
                  conv_width=4, chunk=256),
    shared_attn_every=6,
    mlp_act="gelu",
    mlp_gated=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    ssm=SSMConfig(state_dim=16, expand=2, head_dim=32, num_groups=2,
                  conv_width=4, chunk=16),
    shared_attn_every=2,
)
