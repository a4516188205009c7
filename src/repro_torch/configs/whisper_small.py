"""whisper-small [audio]: enc-dec backbone; conv/mel frontend is a STUB —
input_specs() provides precomputed frame embeddings.
[arXiv:2212.04356; unverified]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,        # MHA
    d_ff=3072,
    vocab_size=51_865,
    use_rope=False,         # sinusoidal absolute positions
    mlp_act="gelu",
    mlp_gated=False,
    use_bias=True,
    input_kind="embeds",
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=2,
    encoder_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
)
