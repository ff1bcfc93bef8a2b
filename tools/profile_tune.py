#!/usr/bin/env python3
"""Where the time of the port's time-domain tune goes, on one NVIDIA card.

    python3 tools/profile_tune.py [--procs 4096] [--top 20]

From the root of a checkout, on a machine with a CUDA card:

1. times ``repro_torch.apps.run.tune`` over the nine apps (time domain)
   from cold schedule caches, in turns: NumPy engine, torch engine, torch
   engine, NumPy engine (host clock, the torch runs ending in
   ``torch.cuda.synchronize()``);
2. profiles one more cold torch tune with ``cProfile`` and prints the
   functions with the most own time and the most cumulative time;
3. traces one more cold torch tune with ``torch.profiler`` and prints the
   card's busy time (kernels and copies, each counted once) as a share of
   the wall time, and the operators with the most device time.

Without a card it exits 1: a measurement of the card never runs on the
CPU instead.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/profile_tune.py",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, default=4096)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_tune: torch finds no CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import apps
    from repro_torch.apps import run
    from repro_torch.kernels import build
    from repro_torch.sim.collectives import clear_caches

    print(f"torch {torch.__version__} on {torch.cuda.get_device_name(0)}")
    build.load()
    selection = list(apps.iter_apps())

    def tune(backend: str) -> float:
        clear_caches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = run.tune(selection, args.procs, report=lambda line: None,
                      time_domain=True, backend=backend, device="cuda")
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"profile_tune: the {backend} tune exited {rc}")
        return time.perf_counter() - t0

    # First-call set-up (CUDA context, the kernels' library) stays out of
    # the timed runs.
    run.tune(selection[:1], 64, report=lambda line: None, time_domain=True,
             backend="torch", device="cuda")
    for backend in ("numpy", "torch", "torch", "numpy"):
        print(f"cold tune at {args.procs} procs, {backend:5s} engine: "
              f"{tune(backend):.3f} s", flush=True)

    prof = cProfile.Profile()
    prof.enable()
    wall = tune("torch")
    prof.disable()
    print(f"\ncProfile of a cold torch tune ({wall:.3f} s with the profiler on)")
    for key in ("tottime", "cumtime"):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
        print(out.getvalue())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        wall = tune("torch")
    events = trace.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    print(f"torch.profiler, cold torch tune: wall {wall:.3f} s, card busy "
          f"{busy_us / 1e6:.4f} s ({busy_us / 1e6 / wall:.2%} of the wall time)")
    print(events.table(sort_by="self_cuda_time_total", row_limit=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
