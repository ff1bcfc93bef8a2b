"""Data pipeline substrate."""
from repro_torch.data.pipeline import (
    DataConfig, SyntheticEmbeddings, SyntheticTokens, make_pipeline,
)

__all__ = ["DataConfig", "SyntheticEmbeddings", "SyntheticTokens", "make_pipeline"]
