"""Training launcher: --arch <id> [--steps N] [--scale reduced|full].

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 200 --batch 16 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]

The port of ``repro.launch.train``, with the same flags and final JSON
line (``first_loss``, ``last_loss``, ``steps``, ``wall_s``,
``steps_per_s``), plus ``--device`` (default ``cuda``: without a card it
exits 2 unless ``--device cpu``). ``--scale full`` trains the config at
its published widths and depth. ``--fail-at N`` with ``--ckpt-dir``
injects one failure before step N and restarts from the latest
checkpoint; the failure is raised where the step's batch is drawn, so the
step number reaches the injector (the reference's guarded step function
is called with the state and the batch, and fails on the batch draw).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch


@dataclasses.dataclass
class _Injected:
    """A pipeline that runs ``injector.check(step)`` before each batch."""

    pipeline: object
    injector: object

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        self.injector.check(step)
        return self.pipeline.batch(step, shard, n_shards)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--scale", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--backpressure", type=int, default=2,
                    help="max in-flight steps (the Backpressure directive)")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated failure at this step (demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default: cuda; there is no "
                         "silent fallback to the CPU)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> tuple[list[dict], dict]:
    """The run ``args`` describe: (the history of the last run of the loop,
    one dict a step, as ``TrainLoop.run`` returns it; the summary that
    ``main`` prints)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build
    from repro_torch.runtime import FailureInjector, SimulatedFailure
    from repro_torch.training import (
        AdamWConfig, TrainLoop, TrainState, init_state, make_train_step,
    )

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "reduced":
        cfg = cfg.reduced()
    model = build(cfg)
    print(f"arch={args.arch} scale={args.scale} params={model.n_params:,}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    pipe = make_pipeline(cfg, seq_len=args.seq, global_batch=args.batch,
                         seed=args.seed, device=device)
    step_fn = make_train_step(model, opt_cfg, compress_grads=args.compress_grads)

    mgr = None
    start = 0
    state = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
        if args.resume and mgr.latest_step() is not None:
            start, tree, extra = mgr.restore(device=device)
            state = TrainState.from_tree(tree)
            print(f"resumed from step {start}")
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = init_state(model, gen, opt_cfg, device=device,
                           compress_grads=args.compress_grads)

    loop = TrainLoop(step_fn, pipe, backpressure=args.backpressure,
                     checkpoint_manager=mgr, save_every=args.save_every)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    if args.fail_at is None:
        state, hist = loop.run(state, start, args.steps)
    else:
        # Demonstrate checkpoint/restart under an injected failure.
        if mgr is None:
            raise SystemExit("--fail-at needs --ckpt-dir")
        injector = FailureInjector(fail_at_steps=(args.fail_at,), max_failures=1)
        guarded = TrainLoop(step_fn, _Injected(pipe, injector),
                            backpressure=args.backpressure,
                            checkpoint_manager=mgr, save_every=args.save_every)
        try:
            state, hist = guarded.run(state, start, args.steps)
        except SimulatedFailure as e:
            print(f"!! {e}; restarting from latest checkpoint")
            mgr.wait()
            start, tree, _ = mgr.restore(device=device)
            state = TrainState.from_tree(tree)
            print(f"restored step {start}")
            state, hist = loop.run(state, start, args.steps)
    dt = time.time() - t0
    if mgr is not None:
        mgr.wait()
    return hist, {
        "first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
        "steps": len(hist), "wall_s": round(dt, 1),
        "steps_per_s": round(len(hist) / dt, 2),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda (the default) needs an NVIDIA GPU, and "
              "torch finds no CUDA card here; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    _, summary = train(args)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
