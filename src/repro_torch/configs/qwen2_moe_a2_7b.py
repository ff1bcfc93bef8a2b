"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed top-4 + 4 shared.

60 routed experts are padded to 64 (never-routed dummies) so the expert
dim shards evenly over the 16-way model axis (see DESIGN.md).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,                    # unused (all layers MoE); shared uses 5632
    vocab_size=151936,
    n_experts=60,
    n_shared_experts=4,
    topk=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    qkv_bias=True,
    rope_theta=1000000.0,
)
