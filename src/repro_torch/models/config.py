"""Model configuration — one dataclass covering all ten assigned families."""
from __future__ import annotations

import dataclasses
import math
from typing import Any


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention options
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full attention
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE options
    n_experts: int = 0             # routed experts (0 = dense FFN)
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    shared_d_ff: int = 0           # shared-expert hidden dim
    first_dense_layers: int = 0    # leading dense layers (deepseek style)
    # --- MLA options (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM options (rwkv / mamba side)
    ssm_state: int = 0
    ssm_heads: int = 0
    d_inner: int = 0
    conv_width: int = 4
    # --- modality frontend stubs
    stub_frontend: bool = False    # inputs are precomputed embeddings
    num_codebooks: int = 0         # musicgen: parallel output heads
    # --- numerics
    dtype: Any = "bfloat16"
    norm_eps: float = 1e-5
    vocab_round: int = 256

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_round)

    @property
    def padded_experts(self) -> int:
        """Experts padded to shard evenly over a 16-way model axis."""
        if self.n_experts == 0:
            return 0
        return pad_to(self.n_experts, 16)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (bounded decode state)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (validated against schemas in tests)."""
        from repro_torch.models import registry

        return registry.build(self).n_params

    # ---------------------------------------------------------- reductions
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_heads = max(2, min(self.n_heads, 4))
        ratio = max(1, self.n_heads // max(self.n_kv_heads, 1))
        small_kv = max(1, small_heads // min(ratio, small_heads))
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=small_heads,
            n_kv_heads=small_kv,
            head_dim=64 // small_heads if self.head_dim == 0 else 16,
            d_ff=128,
            vocab_size=512,
            vocab_round=64,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            topk=min(self.topk, 2) if self.topk else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            shared_d_ff=32 if self.shared_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=0,
            d_inner=128 if self.d_inner else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            num_codebooks=self.num_codebooks,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
