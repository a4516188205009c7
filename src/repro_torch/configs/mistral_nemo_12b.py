"""mistral-nemo-12b [dense]: GQA kv=8, head_dim=128 (decoupled from
d_model/num_heads), 128k context.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,          # q/o project 5120 <-> 4096
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG,
    num_layers=3,
    d_model=160,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=448,
    vocab_size=512,
)
