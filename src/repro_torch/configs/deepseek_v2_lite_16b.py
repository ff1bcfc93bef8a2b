"""deepseek-v2-lite-16b [arXiv:2405.04434; hf] — MLA + MoE (64e top-6)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                   # first dense layer FFN
    vocab_size=102400,
    # MoE: 64 routed top-6 + 2 shared; layer 0 dense.
    n_experts=64,
    n_shared_experts=2,
    topk=6,
    moe_d_ff=1408,
    shared_d_ff=2816,
    first_dense_layers=1,
    # MLA
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
)
