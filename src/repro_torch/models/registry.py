"""Model registry: config -> model object, by family."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def build(cfg: ModelConfig):
    """The port's model for ``cfg``: the decoder for the ``dense`` and
    ``moe`` families (MoE FFNs, MLA attention), RWKV-6 for ``ssm`` and
    Hymba for ``hybrid``."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv6 import RWKV6LM

        return RWKV6LM(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hymba import HymbaLM

        return HymbaLM(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")
