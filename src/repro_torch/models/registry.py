"""Model registry: config -> model object, by family."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def build(cfg: ModelConfig):
    """The port's model for ``cfg``: ``dense`` and ``hybrid`` families.
    MoE/MLA configs raise from the decoder; ``ssm`` (RWKV-6) comes with
    the rwkv6 slice of the port."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models.transformer import DecoderLM

        return DecoderLM(cfg)
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the RWKV-6 family is not ported yet; it comes with "
            f"the rwkv6 slice of repro_torch.models (with the wkv6 kernel)"
        )
    if cfg.family == "hybrid":
        from repro_torch.models.hymba import HymbaLM

        return HymbaLM(cfg)
    raise ValueError(f"unknown model family {cfg.family!r}")
