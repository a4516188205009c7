"""command-r-plus-104b [dense]: GQA kv=8, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33_792,
    vocab_size=256_000,
    mlp_act="silu",
    mlp_gated=True,
    use_bias=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    head_dim=16,
    d_ff=384,
    vocab_size=512,
)
