"""Abstract input specs per (arch x shape) cell: empty meta tensors.

The port of ``repro.launch.specs``. Where the reference has a
``jax.ShapeDtypeStruct``, these functions give a tensor of the same shape
and dtype on the meta device, which allocates nothing; the dry run
(``launch/dryrun.py``) counts a step on them. Token inputs stay int32, as
in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.registry import build


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _inputs(cfg: ModelConfig, B: int, S: int) -> torch.Tensor:
    if cfg.stub_frontend:
        return _meta((B, S, cfg.d_model), torch.bfloat16)
    return _meta((B, S), torch.int32)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.num_codebooks > 1:
        labels = _meta((B, S, cfg.num_codebooks), torch.int32)
    else:
        labels = _meta((B, S), torch.int32)
    return {"inputs": _inputs(cfg, B, S), "labels": labels}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """serve_step(params, cache, pos, token) stand-ins (minus params). The
    port's decode step takes ``pos`` as a Python int; the stand-in keeps
    the reference's int32 scalar."""
    model = build(cfg)
    B, S = shape.global_batch, shape.seq_len
    cache = {k: _meta(s, dt) for k, (s, dt) in model.cache_spec(B, S).items()}
    return {"cache": cache, "pos": _meta((), torch.int32),
            "token": _inputs(cfg, B, 1)}


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return {"inputs": _inputs(cfg, shape.global_batch, shape.seq_len)}


def runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch x shape) cell defined? (long_500k needs sub-quadratic.)"""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is full-attention (see DESIGN.md Arch-applicability)"
        )
    return True, ""
