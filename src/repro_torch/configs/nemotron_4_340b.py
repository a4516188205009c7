"""nemotron-4-340b [dense]: GQA kv=8, squared-ReLU non-gated MLP.
[arXiv:2402.16819; unverified]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    mlp_act="relu2",
    mlp_gated=False,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=192,
    num_heads=6,
    num_kv_heads=2,
    d_ff=768,
    vocab_size=512,
)
