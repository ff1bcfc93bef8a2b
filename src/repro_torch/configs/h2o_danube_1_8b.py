"""h2o-danube-1.8b [arXiv:2401.16818; hf] — llama+mistral mix with SWA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,          # mistral-style SWA -> long_500k eligible
    rope_theta=10000.0,
)
