"""musicgen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

Frontend stub: input_specs() provides precomputed frame embeddings;
the model trains 4 parallel codebook heads over vocab 2048.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    vocab_round=64,
    num_codebooks=4,
    stub_frontend=True,
    rope_theta=10000.0,
)
