#!/usr/bin/env python3
"""Where the time of the port's LM serving path goes, on one NVIDIA card.

    python3 tools/profile_serve.py [--arch hymba-1.5b] [--top 15]
    python3 tools/profile_serve.py --arch rwkv6-3b

From the root of a checkout, on a machine with a CUDA card, at the
config's full width with weights from a seeded generator on the card
(bf16 compute, the config's own dtype), for any family the port's
registry builds (the prefill runs that family's kernels: flash_attention
and mamba_scan for Hymba, wkv6 for RWKV-6):

1. the prefill step with the kernels (B=4, prompt 2048): wall time of
   three runs after a warm-up, then one run under ``torch.profiler``: the
   card's busy time as a share of the wall time, and the operators with
   the most device time;
2. the decode step (B=4, after a 32-token prompt teacher-forced through
   it): wall time per step over 32 steps, then 8 steps under
   ``torch.profiler``: busy share, device kernels launched per step, and
   the operators with the most device time.

Without a card it exits 1: a measurement of the card never runs on the
CPU instead.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _busy(trace, wall: float, what: str, top: int, steps: int = 1) -> None:
    from torch.autograd import DeviceType

    events = trace.key_averages()
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in dev)
    launches = sum(e.count for e in dev)
    print(f"torch.profiler, {what}: wall {wall:.4f} s, card busy "
          f"{busy_us / 1e6:.4f} s ({busy_us / 1e6 / wall:.2%} of the wall time), "
          f"{launches / steps:.0f} device kernels and copies per step")
    print(events.table(sort_by="self_cuda_time_total", row_limit=top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/profile_serve.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: torch finds no CUDA card", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build as build_model

    print(f"torch {torch.__version__} on {torch.cuda.get_device_name(0)}")
    build.load()
    model = build_model(get_config(args.arch))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, device="cuda")
    B, S = 4, 2048
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=gen, device="cuda")

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prefill = make_prefill_step(model)
    wall(lambda: prefill(params, toks))                    # warm-up
    runs = [wall(lambda: prefill(params, toks)) for _ in range(3)]
    print(f"prefill B={B} S={S} with the kernels: {runs} s, median "
          f"{statistics.median(runs):.4f} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        w = wall(lambda: prefill(params, toks))
    _busy(trace, w, f"one prefill (B={B}, S={S})", args.top)

    step = make_serve_step(model)
    cache = model.init_cache(B, 32 + 48, device="cuda")
    for t in range(32):
        _, cache = step(params, cache, t, toks[:, t:t + 1])
    n = 32
    w = wall(lambda: [step(params, cache, 32 + t, toks[:, t:t + 1]) for t in range(n)])
    print(f"decode B={B}: {n} steps in {w:.4f} s, {w / n * 1e3:.3f} ms per step, "
          f"{B * n / w:.1f} tok/s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        w = wall(lambda: [step(params, cache, 64 + t, toks[:, t:t + 1]) for t in range(8)])
    _busy(trace, w, f"8 decode steps (B={B})", args.top, steps=8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
