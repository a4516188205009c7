"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""

import dataclasses

from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # rwkv heads = d_model / head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    use_rope=False,
    mlp_gated=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    d_ff=448,
    vocab_size=512,
    rwkv=RWKVConfig(head_size=64, decay_lora=16, mix_lora=8),
)
