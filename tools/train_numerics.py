#!/usr/bin/env python3
"""How far fp32 gradients sit from float64 ones, leaf by leaf, on the
train parity check's model and batches.

    PYTHONPATH=src python3 tools/train_numerics.py [--device cpu|cuda]

The model, parameters, batches and optimizer are those of
``chip_smoke.py``'s card-against-CPU train check (reduced fp32
smollm-135m, parameters from seed 0, SyntheticTokens B=8, S=64 from
seed 1, AdamW lr 1e-3). Each of three steps takes the fp32 model's
gradients and a float64 copy's at the same parameters, then takes the
fp32 train step. For each leaf it prints the largest difference as a
share of the leaf's largest float64 entry, and the number of entries
whose gradients are more than 1% apart (relative); the last line gives
the largest of each over the leaves, pooled over the steps. These are
the two quantities that check holds, here between precisions on one
device instead of between devices.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models import build
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.training import AdamWConfig, TrainState, make_train_step
from repro_torch.training import optimizer
from repro_torch.training.loop import value_and_grad

REL = 1e-2


def leaf_names(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config("smollm-135m").reduced()
    model = build(cfg)
    model64 = build(dataclasses.replace(cfg, dtype="float64"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = tree_map(lambda t: t.to(args.device), params)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 8, seed=1), device=args.device)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    state = TrainState(params, optimizer.init(params))
    names = leaf_names(params)
    loose = [0] * len(names)
    worst = 0.0
    for i in range(3):
        batch = data.batch(i)
        p64 = tree_map(lambda t: t.detach().to(torch.float64, copy=True), state.params)
        _, g64 = value_and_grad(lambda p: model64.loss(p, batch), p64)
        _, g32 = value_and_grad(lambda p: model.loss(p, batch), state.params)
        for j, (name, a, b) in enumerate(zip(names, tree_leaves(g64), tree_leaves(g32))):
            d = (b.double() - a).abs()
            ratio = float(d.max() / a.abs().max())
            n = int((d > REL * a.abs()).sum())
            worst = max(worst, ratio)
            loose[j] += n
            print(f"step {i} {name}: {a.numel()} entries, max |diff| {ratio:.3e} of the "
                  f"leaf's largest, {n} more than {REL:g} apart ({n / a.numel():.3%})")
        state, _ = step(state, batch)
    sizes = [t.numel() for t in tree_leaves(state.params)]
    share, name = max((n / (3 * s), nm) for n, s, nm in zip(loose, sizes, names))
    print(f"fp32 against float64 on {args.device}, 3 steps: max |diff| {worst:.3e} of a "
          f"leaf's largest; largest share of a leaf's (entry, step) pairs more than "
          f"{REL:g} apart {share:.3%} ({name})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
