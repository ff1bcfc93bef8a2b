"""What the kinds of traffic share: the comparison of served tokens and of
logits with the reference."""
from __future__ import annotations

import torch

from bench.harness import Check, Number


def token_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """By how much each served token's reference logit lies below the
    reference's best: ref_logits (..., V), served (...)."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, served[..., None].long())[..., 0]


def judge(readings: dict, limits: dict) -> Check:
    """``readings``: number name -> its readings (one an answer, or one a
    leaf of the cache). A number is the worst of its readings; every
    reading over its number's limit counts as failed."""
    numbers, failed = [], 0
    for name, vals in readings.items():
        vals = vals.flatten().double()
        numbers.append(Number(name, float(vals.max()), float(limits[name])))
        failed += int((vals > limits[name]).sum())
    return Check(numbers, failed)
