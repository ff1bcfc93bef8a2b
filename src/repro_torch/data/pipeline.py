"""Deterministic synthetic data pipeline, host-sharded.

The port of ``repro.data.pipeline``. Produces reproducible token streams
(a mixture of Zipfian unigrams and repeated-ngram structure so losses
actually decrease) keyed by (seed, step, shard), so that:

  * restarts resume mid-epoch exactly (the cursor is the step counter
    persisted in checkpoints);
  * every data-parallel host generates only its shard (no global array on
    any single host) — the pattern a real corpus loader follows;
  * elastic rescales remap shards deterministically.

``SyntheticTokens.batch_np`` is the reference's NumPy, array for array;
``batch`` hands the arrays to ``device`` (through pinned memory on the
card, so the copy does not wait for the steps already queued there).
``SyntheticEmbeddings`` draws from a ``torch.Generator`` seeded by the
reference's formula: the same shapes, dtypes, scale and (seed, step,
shard) keying, not ``jax.random``'s bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_alpha: float = 1.1
    ngram_period: int = 97


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return (p / p.sum()).astype(np.float64)


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; on the card through pinned
    memory, asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class SyntheticTokens:
    cfg: DataConfig
    device: str = "cuda"

    def __post_init__(self):
        self._probs = _zipf_probs(self.cfg.vocab_size, self.cfg.zipf_alpha)

    def batch_np(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> dict[str, np.ndarray]:
        """The shard's slice of the global batch for ``step``."""
        cfg = self.cfg
        if cfg.global_batch % n_shards:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by {n_shards}"
            )
        per = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard])
        )
        toks = rng.choice(
            cfg.vocab_size, size=(per, cfg.seq_len + 1), p=self._probs
        ).astype(np.int32)
        # inject periodic structure: repeat a window to create learnable
        # bigram statistics
        period = cfg.ngram_period
        reps = cfg.seq_len // (2 * period)
        for r in range(reps):
            lo = 2 * r * period
            toks[:, lo + period: lo + 2 * period] = toks[:, lo: lo + period]
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """``batch_np`` as int32 tensors on ``device``."""
        return {k: _to_device(v, self.device)
                for k, v in self.batch_np(step, shard, n_shards).items()}


@dataclasses.dataclass
class SyntheticEmbeddings:
    """Stub modality frontend: precomputed frame/patch embeddings."""

    cfg: DataConfig
    d_model: int
    num_codebooks: int = 0
    device: str = "cuda"

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        cfg = self.cfg
        per = cfg.global_batch // n_shards
        gen = torch.Generator(device=self.device).manual_seed(
            (cfg.seed * 1_000_003 + step * 613 + shard) % (2 ** 31)
        )
        emb = 0.02 * torch.randn((per, cfg.seq_len, self.d_model),
                                 generator=gen, device=self.device)
        shape = (per, cfg.seq_len) + (
            (self.num_codebooks,) if self.num_codebooks > 1 else ())
        labels = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                               device=self.device, dtype=torch.int32)
        return {"inputs": emb, "labels": labels}


def make_pipeline(model_cfg, seq_len: int, global_batch: int, seed: int = 1234,
                  device="cuda"):
    dc = DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
    )
    if model_cfg.stub_frontend:
        return SyntheticEmbeddings(dc, model_cfg.d_model,
                                   model_cfg.num_codebooks, device=device)
    return SyntheticTokens(dc, device=device)
