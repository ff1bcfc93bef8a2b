"""Weights, caches and tokens made from the seed, on the device.

The weights take the program's parameter layout (its schema's shapes, read
on the meta device) and the configuration file's init rules: one flat
float32 buffer drawn in a few large calls of one generator on the device,
carved into leaves and scaled leaf by leaf. The same tensors go to the
program and to the reference.
"""
from __future__ import annotations

import fnmatch
import hashlib
import math

import torch

DRAW = 1 << 30            # elements one normal_ call draws


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, tokens, cache, ...) of a run."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _leaves(val, path + ".")
        else:
            yield path, val


def _set(tree: dict, path: str, value) -> None:
    *heads, last = path.split(".")
    for h in heads:
        tree = tree.setdefault(h, {})
    tree[last] = value


def init_rule(path: str, shape: tuple, init: dict) -> tuple:
    """(kind, std) of one leaf: the first rule whose pattern matches its
    dotted path, else the default. ``fan_in`` is N(0, 1/fan_in), the fan-in
    being one layer's matrix's first dim (stacked leaves lead with the
    layer axis)."""
    for rule in init["rules"]:
        if fnmatch.fnmatchcase(path, rule[0]):
            kind = rule[1]
            return kind, (rule[2] if kind == "normal" else None)
    kind = init["default"]
    if kind != "fan_in":
        raise ValueError(f"unknown default init {kind!r}")
    per_layer = shape[1:] if path.startswith("layers.") else shape
    return "normal", 1.0 / math.sqrt(max(per_layer[0], 1))


def make_params(abstract: dict, init: dict, seed: int, device) -> dict:
    """The parameter tree of ``abstract`` (meta tensors) drawn from the
    seed under ``init``."""
    plan = [(path, tuple(t.shape), *init_rule(path, tuple(t.shape), init))
            for path, t in _leaves(abstract)]
    total = sum(math.prod(shape) for _, shape, kind, _ in plan if kind == "normal")
    buf = torch.empty(total, dtype=torch.float32, device=device)
    gen = generator(seed, "weights", device)
    for a in range(0, total, DRAW):
        buf[a:a + DRAW].normal_(generator=gen)
    out: dict = {}
    off = 0
    for path, shape, kind, std in plan:
        if kind == "normal":
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape).mul_(std)
            off += n
        elif kind in ("zeros", "ones"):
            leaf = getattr(torch, kind)(shape, dtype=torch.float32, device=device)
        else:
            raise ValueError(f"{path}: unknown init {kind!r}")
        _set(out, path, leaf)
    return out


def make_state(spec: dict, scales: dict, seed: int, device) -> dict:
    """A cache in the program's layout (``spec``: name -> (shape, dtype))
    drawn from the seed, each leaf N(0, scale^2) in its own dtype."""
    gen = generator(seed, "state", device)
    return {name: (scales[name] * torch.randn(shape, generator=gen, device=device)).to(dt)
            for name, (shape, dt) in spec.items()}


def make_tokens(seed: int, tag: str, vocab: int, shape: tuple, device) -> torch.Tensor:
    return torch.randint(0, vocab, shape, generator=generator(seed, tag, device),
                         device=device)
