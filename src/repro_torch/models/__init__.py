"""LM zoo of the port: the dense, MoE and MLA decoder, RWKV-6 and Hymba,
config-driven."""
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.params import (
    ParamDef,
    init_params,
    param_count,
    params_from_numpy,
)
from repro_torch.models.registry import build

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "build",
    "ParamDef", "init_params", "param_count", "params_from_numpy",
]
