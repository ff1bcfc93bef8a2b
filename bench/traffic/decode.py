"""Closed-loop decode: B sequences one token a step, from a cache made from
the seed as after a long prompt.

Each step feeds the next of B seeded token streams (teacher-forced) at
position ``start`` + step through the program's serving step
(``launch/steps.make_serve_step``), which updates the cache in place,
takes each row's greedy token from the logits and waits for it. The time
between tokens is read from CUDA events recorded after each step, on the
device's clock. A row runs from ``start`` to the end of its ``context``;
a run that gets there starts a new segment: the cache as it was made,
fresh tokens from the seed, and the same positions again, so every step
decodes within the stated context however fast the steps are. The check
runs the plain reference over the last complete segment (the current one
if none is complete) from the same starting cache, at once: how far each
served token's reference logit lies below the reference's best
(``token_gap``), and the cache at the segment's end against the
reference's (``state_err``, the worst leaf's largest gap over its largest
|entry|).
"""
from __future__ import annotations

import time

import torch

from bench import stats, weights
from bench.reference.plain import Precision, no_tf32
from bench.traffic.common import judge, token_gaps

HEAD_BLOCK = 128          # positions whose logits the check holds at once


class Kind:
    def __init__(self, ctx):
        from repro_torch.launch.steps import make_serve_step

        mix = ctx.cell.mix
        self.ctx = ctx
        self.B, self.pos0 = mix["batch"], mix["start"]
        self.seg_len = mix["context"] - mix["start"]
        self.vocab = ctx.cfg["vocab_size"]
        self.fn = make_serve_step(ctx.model)
        spec = ctx.model.cache_spec(self.B, mix["context"])
        self.start_state = weights.make_state(spec, ctx.cell.config["state_init"], ctx.seed,
                                              ctx.device)
        self.cuda = ctx.device.type == "cuda"
        self.n = 0                      # steps of the run
        self.segments = 0               # segments started
        self.done = None                # the last complete segment: tokens, served, cache
        self.marks: list = []
        self._new_segment()
        for _ in range(mix["warmup_steps"]):
            self.step()

    def _new_segment(self) -> None:
        self.cache = {k: v.clone() for k, v in self.start_state.items()}
        self.tokens = weights.make_tokens(self.ctx.seed, f"tokens.{self.segments}", self.vocab,
                                          (self.B, self.seg_len), self.ctx.device)
        self.served = torch.zeros((self.B, self.seg_len), dtype=torch.long,
                                  device=self.ctx.device)
        self.i = 0                      # steps of this segment
        self.segments += 1

    def _mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step(self) -> None:
        if self.i == self.seg_len:
            self.done = (self.tokens, self.served, self.cache)
            self._new_segment()
        i = self.i
        logits, self.cache = self.fn(self.ctx.params, self.cache, self.pos0 + i,
                                     self.tokens[:, i:i + 1])
        self.served[:, i] = logits[:, -1, :self.vocab].argmax(-1)
        self._mark()
        self.i += 1
        self.n += 1

    def start_window(self) -> None:
        self.window_from = self.n
        self.marks = []
        self._mark()

    def attempted(self) -> int:
        return self.B * self.n

    def end_to_end(self, elapsed: float) -> dict:
        steps = self.n - self.window_from
        if self.cuda:
            itl = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            itl = [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]
        return {"decode_tok_s": self.B * steps / elapsed,
                "itl_p95_ms": stats.percentile(itl, 95)}

    def position(self) -> int:
        return self.pos0 + self.i

    def free_program(self) -> None:
        self.fn = None
        self.marks = []

    def checked(self) -> tuple:
        """The segment the check covers: its tokens, served tokens and cache."""
        if self.done is not None:
            return self.done
        return self.tokens[:, :self.i], self.served[:, :self.i], self.cache

    def check(self, control: str | None = None):
        """The reference over the checked segment's tokens from the starting
        cache; with ``control``, the reference in that precision takes the
        program's place (its greedy tokens and its cache)."""
        no_tf32()
        ctx = self.ctx
        toks, served, state = self.checked()
        T = toks.shape[1]
        key = (self.segments, self.i)
        if getattr(self, "ref", (None, None))[1] != key:
            self.ref = (ctx.ref.decode(ctx.params, toks, ctx.cfg, Precision(),
                                       self.start_state, self.pos0), key)
        (x, ref_state), _ = self.ref
        if control is not None:
            cx, state = ctx.ref.decode(ctx.params, toks, ctx.cfg, Precision(control),
                                       self.start_state, self.pos0)
            served = torch.cat([ctx.ref.head(ctx.params, cx[:, a:a + HEAD_BLOCK],
                                             Precision(control))[..., :self.vocab].argmax(-1)
                                for a in range(0, T, HEAD_BLOCK)], 1)
        gaps = torch.cat([token_gaps(ctx.ref.head(ctx.params, x[:, a:a + HEAD_BLOCK],
                                                  Precision())[..., :self.vocab],
                                     served[:, a:a + HEAD_BLOCK])
                          for a in range(0, T, HEAD_BLOCK)], 1)
        errs = [((state[k].float() - ref_state[k]).abs().amax() / ref_state[k].abs().amax())
                for k in ref_state]
        rows = {"token_gap": gaps.flatten(), "state_err": torch.stack(errs)}
        return judge(rows, ctx.cell.spec["limits"])
