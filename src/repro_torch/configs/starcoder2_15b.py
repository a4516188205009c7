"""starcoder2-15b [dense]: GQA kv=4, RoPE, bias=True, non-gated GELU.
[arXiv:2402.19173; hf]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    mlp_act="gelu",
    mlp_gated=False,
    use_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=512,
)
