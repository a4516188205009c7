"""Unified model configuration covering all assigned architecture families."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size (fine-grained)
    num_shared: int = 0         # always-on shared experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_dense_layers: int = 0 # leading dense layers (deepseek-moe style)
    d_ff_dense: int = 0         # hidden size of those dense layers


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    expand: int = 2
    head_dim: int = 64          # mamba2 head dim (d_inner / n_heads)
    num_groups: int = 8         # B/C groups
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64        # low-rank dim of the data-dependent decay
    mix_lora: int = 32          # low-rank dim of the token-shift lerps


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    # MLP
    mlp_act: str = "silu"       # silu | gelu | relu2
    mlp_gated: bool = True
    use_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # positions
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # family extensions
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    # hybrid (zamba2): a single SHARED attention+mlp block invoked every
    # `shared_attn_every` ssm layers, params reused across invocations
    shared_attn_every: int = 0
    # enc-dec (whisper): encoder depth; num_layers is the decoder depth
    encoder_layers: int = 0
    # input modality: [vlm]/[audio] take precomputed embeddings (stub frontend)
    input_kind: Literal["tokens", "embeds"] = "tokens"
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 (Megatron-style padding) so the
        embedding/head shard evenly over tp and align to TPU lanes.  Padded
        logit columns are masked to -1e30 before the loss/sampler."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.rwkv is not None or (
            self.family == "ssm" and self.ssm is not None
        )

    @property
    def supports_long_context(self) -> bool:
        """O(1)-state decode: SSM / linear-attention / hybrid families."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += D * V  # head

        def attn_params() -> int:
            return D * H * hd + 2 * D * KV * hd + H * hd * D

        def mlp_params(f: int) -> int:
            return D * f * (3 if self.mlp_gated else 2)

        if self.rwkv is not None:
            hs = self.rwkv.head_size
            per = 4 * D * D + D * D  # r,k,v,g,o  (decay/mix loras are small)
            per += 2 * D * self.rwkv.decay_lora
            per += int(1.5 * D * F)  # rwkv channel-mix: k,v,r projections
            total += L * per
        elif self.family in ("ssm", "hybrid") and self.ssm is not None:
            s = self.ssm
            d_inner = s.expand * D
            nheads = d_inner // s.head_dim
            per = D * (2 * d_inner) + 2 * D * s.num_groups * s.state_dim
            per += D * nheads + d_inner * D
            per += (d_inner + 2 * s.num_groups * s.state_dim) * s.conv_width
            total += L * per
            if self.shared_attn_every:
                total += attn_params() + mlp_params(F)  # one shared block
        elif self.moe is not None:
            m = self.moe
            dense = m.first_dense_layers
            per_moe = attn_params() + D * m.num_experts  # router
            per_moe += (m.num_experts + m.num_shared) * (
                D * m.d_expert * (3 if self.mlp_gated else 2)
            )
            total += (L - dense) * per_moe
            total += dense * (attn_params() + mlp_params(m.d_ff_dense or F))
        else:
            total += L * (attn_params() + mlp_params(F))
            if self.encoder_layers:
                total += self.encoder_layers * (attn_params() + mlp_params(F))
                total += L * attn_params()  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        expert_p = self.d_model * m.d_expert * (3 if self.mlp_gated else 2)
        inactive = (self.num_layers - m.first_dense_layers) * (
            (m.num_experts - m.top_k) * expert_p
        )
        return full - inactive
