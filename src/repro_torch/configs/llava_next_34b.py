"""llava-next-34b [vlm]: LM backbone only; anyres vision tiling is a STUB —
input_specs() provides precomputed patch+text embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    input_kind="embeds",
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=128,
    num_heads=8,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=512,
)
