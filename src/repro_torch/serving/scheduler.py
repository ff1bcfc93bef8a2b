"""Continuous-batching serving scheduler (vLLM-style slot management).

A fixed pool of cache slots; requests join as slots free up, every active
slot advances one token per scheduler tick, and finished sequences
release their slot immediately (no tail-of-batch stragglers). The port of
``repro.serving.scheduler``: a slot's cache is zeroed in place when a new
request takes it.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.serving.stats import percentile


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int
    max_new_tokens: int
    # runtime state
    generated: list = dataclasses.field(default_factory=list)
    pos: int = 0                       # next position to feed
    slot: int = -1
    done: bool = False
    enqueue_t: float = 0.0
    finish_t: float = 0.0


@dataclasses.dataclass
class ServeStats:
    completed: int = 0
    steps: int = 0
    tokens_out: int = 0
    latencies: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        return {
            "completed": self.completed,
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "p50_latency_s": percentile(self.latencies, 50),
            "p95_latency_s": percentile(self.latencies, 95),
            "p99_latency_s": percentile(self.latencies, 99),
        }


class ContinuousBatcher:
    """Slot-based continuous batching around a model's ``decode_step``.

    One independent cache per slot (batch 1), so each slot keeps its own
    position; every tick feeds each active slot its next prompt token
    (prefill, one token per tick) or its last generated token.
    """

    def __init__(self, model, params, n_slots: int, max_len: int,
                 eos_token: int | None = None, device="cuda"):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_token
        self.device = torch.device(device)
        self.queue: collections.deque[Request] = collections.deque()
        self.active: dict[int, Request] = {}       # slot -> request
        self.free_slots = list(range(n_slots))
        self.caches = [model.init_cache(1, max_len, device=self.device)
                       for _ in range(n_slots)]
        self.stats = ServeStats()

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request) -> None:
        req.enqueue_t = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and self.free_slots:
            slot = self.free_slots.pop()
            req = self.queue.popleft()
            req.slot = slot
            for buf in self.caches[slot].values():
                buf.zero_()
            self.active[slot] = req

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """One scheduler tick: admit, advance every active slot one token."""
        self._admit()
        if not self.active:
            return
        for slot, req in list(self.active.items()):
            if req.pos < len(req.prompt):
                tok = int(req.prompt[req.pos])          # prefill (1 tok/step)
            else:
                tok = req.generated[-1] if req.generated else 0
            logits, self.caches[slot] = self.model.decode_step(
                self.params, self.caches[slot], req.pos,
                torch.tensor([[tok]], dtype=torch.int64, device=self.device),
            )
            req.pos += 1
            if req.pos >= len(req.prompt):              # decoding phase
                nxt = int(torch.argmax(logits.reshape(-1)))
                nxt = min(nxt, self.model.cfg.vocab_size - 1)
                req.generated.append(nxt)
                self.stats.tokens_out += 1
                hit_eos = self.eos is not None and nxt == self.eos
                if (len(req.generated) >= req.max_new_tokens or hit_eos
                        or req.pos >= self.max_len - 1):
                    req.done = True
                    req.finish_t = time.perf_counter()
                    self.stats.completed += 1
                    self.stats.latencies.append(req.finish_t - req.enqueue_t)
                    del self.active[slot]
                    self.free_slots.append(slot)
        self.stats.steps += 1

    def run_until_drained(self, max_steps: int = 100_000) -> ServeStats:
        while (self.queue or self.active) and self.stats.steps < max_steps:
            self.step()
        return self.stats
