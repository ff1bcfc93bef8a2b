"""hymba-1.5b [arXiv:2411.13676] — parallel attention + mamba heads, SWA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,             # padded to 32256
    ssm_state=16,
    d_inner=3200,
    conv_width=4,
    sliding_window=1024,
    rope_theta=10000.0,
)
