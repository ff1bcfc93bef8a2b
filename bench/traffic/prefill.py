"""Closed-loop prefill: whole-batch steps of fresh prompts, back to back.

Each step draws B prompts of S tokens from the seed's stream, runs the
program's serving prefill (``launch/steps.make_prefill_step``) to the
last position's logits and waits for them. The check draws steps from the
seed among those of the window and holds each row's logits against the
plain reference's: the widest gap relative to the reference's largest
|logit| (``logit_err``). Two rows' greedy tokens are too few for a gap of
served tokens to tell the program from the control.
"""
from __future__ import annotations

import random

import torch

from bench import weights
from bench.reference.plain import Precision, no_tf32
from bench.traffic.common import judge


class Kind:
    def __init__(self, ctx):
        from repro_torch.launch.steps import make_prefill_step

        mix = ctx.cell.mix
        self.ctx = ctx
        self.B, self.S = mix["batch"], mix["prompt"]
        self.vocab = ctx.cfg["vocab_size"]
        self.fn = make_prefill_step(ctx.model, use_kernel=True)
        self.gen = weights.generator(ctx.seed, "prompts", ctx.device)
        self.done: list = []            # (generator state, last logits) a step
        self.refs: dict = {}            # step -> (prompts, the reference's logits)
        for _ in range(mix["warmup_steps"]):
            self.step()
        self.done.clear()

    def _prompts(self, gen) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.B, self.S), generator=gen,
                             device=self.ctx.device)

    def step(self) -> None:
        state = self.gen.get_state()
        logits = self.fn(self.ctx.params, self._prompts(self.gen))
        self.ctx.sync()
        self.done.append((state, logits[:, -1, :self.vocab]))

    def start_window(self) -> None:
        self.done.clear()

    def attempted(self) -> int:
        return self.B * len(self.done)

    def end_to_end(self, elapsed: float) -> dict:
        return {"prefill_tok_s": self.B * self.S * len(self.done) / elapsed}

    def free_program(self) -> None:
        self.fn = None

    def check(self, control: str | None = None):
        """The reference over the prompts of steps drawn from the seed; with
        ``control``, the reference in that precision takes the program's
        place."""
        no_tf32()
        ctx, spec = self.ctx, self.ctx.cell.spec
        pick = random.Random(weights.sub_seed(ctx.seed, "check"))
        idx = sorted(pick.sample(range(len(self.done)), min(spec["check_steps"], len(self.done))))
        errs = []
        gen = torch.Generator(device=ctx.device)
        for i in idx:
            state, logits = self.done[i]
            if i not in self.refs:
                gen.set_state(state)
                prompts = self._prompts(gen)
                self.refs[i] = (prompts, ctx.ref.prefill_last_logits(
                    ctx.params, prompts, ctx.cfg, Precision())[:, :self.vocab])
            prompts, ref = self.refs[i]
            if control is not None:
                logits = ctx.ref.prefill_last_logits(ctx.params, prompts, ctx.cfg,
                                                     Precision(control))[:, :self.vocab]
            logits = logits.float()
            errs.append((logits - ref).abs().amax(-1) / ref.abs().amax(-1))
        return judge({"logit_err": torch.cat(errs)}, spec["limits"])
