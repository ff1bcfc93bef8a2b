"""pixtral-12b [hf:mistralai/Pixtral-12B-2409] — ViT frontend (stub) +
mistral-nemo decoder backbone. input_specs() provides patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    stub_frontend=True,
    rope_theta=1000000.0,
)
