"""rwkv6-3b "Finch" [arXiv:2404.05892; hf] — attention-free, data-dep decay."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                   # 2560 / 64 rwkv heads
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
)
