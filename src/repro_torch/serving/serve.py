"""CLI front-end of the tuning service: ``python -m repro_torch.serving.serve``.

Replays a request trace (``--trace FILE`` in JSONL, or a seeded
``--demo`` trace skewed toward repeats) through a resident
:class:`~repro_torch.serving.mapsvc.MappingService` and prints one line per
resolved request plus the :class:`~repro_torch.serving.stats.ServiceStats`
JSON metrics surface. Flags mirror the batch CLI
(``repro_torch.apps.run``): ``--cache-dir`` persists both the plan cache and
the placement price cache, ``--backend``/``--dtype`` pick the pricing
engine, and ``--device`` is where ``--backend torch`` prices (``cuda``
by default; without a card its requests are rejected with an error
unless ``--device cpu`` is given):

    python -m repro_torch.serving.serve --demo 20 --backend torch
    python -m repro_torch.serving.serve --demo 20 --backend torch --device cpu

Trace format (one JSON object per line; ``#`` comments and blanks ok)::

    {"app": "cannon"}
    {"app": "stencil", "procs": 16, "priority": 1}
    {"app": "cannon", "procs": 64, "deadline_s": 5.0, "timeout_s": 30.0}

Fields are :class:`~repro_torch.serving.mapsvc.TuneRequest` arguments
verbatim. The process exits 1 only when a request failed with an
``"error"`` rejection — sheds (queue-full/deadline/timeout) are normal
operation under load and reported, not fatal.
"""
from __future__ import annotations

import argparse
import json
import random
import sys

from repro_torch.serving.mapsvc import (
    DEFAULT_COALESCE,
    DEFAULT_QUEUE_LIMIT,
    MappingService,
    Rejected,
    TuneRequest,
    load_trace,
    replay,
)
from repro_torch.search.tuner import DEFAULT_BEAM

_ENGINES = {"numpy": "batched", "torch": "batched-torch", "event": "event"}


def demo_trace(n: int, seed: int = 0) -> list[TuneRequest]:
    """A synthetic service workload: mixed apps and scales, skewed
    toward repeats (~70% of requests re-ask an earlier question — the
    regime a plan cache exists for)."""
    from repro_torch import apps

    pool = [
        TuneRequest(app.name, procs)
        for app in apps.iter_apps()
        if app.search_space is not None
        for procs in (None, app.default_procs * 4)
    ]
    rng = random.Random(seed)
    out: list[TuneRequest] = []
    for _ in range(n):
        if out and rng.random() < 0.7:
            out.append(rng.choice(out))        # repeat an earlier question
        else:
            out.append(rng.choice(pool))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.serve",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--trace", metavar="FILE",
                     help="JSONL request trace to replay")
    src.add_argument("--demo", type=int, metavar="N",
                     help="generate a seeded N-request demo trace instead")
    ap.add_argument("--seed", type=int, default=0,
                    help="--demo trace seed (default 0)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persist plan + price caches under DIR "
                         "(plans in DIR/plans, prices in DIR/prices)")
    ap.add_argument("--backend", choices=tuple(_ENGINES), default="numpy",
                    help="pricing engine (default numpy)")
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64", help="torch engine precision")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --backend torch prices (default: cuda; "
                         "there is no silent fallback to the CPU)")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker threads; 0 drains on the main thread "
                         "(default 1)")
    ap.add_argument("--queue-limit", type=int, default=DEFAULT_QUEUE_LIMIT,
                    help=f"admission bound (default {DEFAULT_QUEUE_LIMIT})")
    ap.add_argument("--coalesce", type=int, default=DEFAULT_COALESCE,
                    help="max requests batched per drain "
                         f"(default {DEFAULT_COALESCE})")
    ap.add_argument("--beam", type=int, default=DEFAULT_BEAM,
                    help=f"tuner beam width (default {DEFAULT_BEAM})")
    ap.add_argument("--no-warm-start", dest="warm_start",
                    action="store_false",
                    help="disable warm-seeding from nearby cached plans")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="also write the ServiceStats summary to PATH")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per request instead of text")
    args = ap.parse_args(argv)

    requests = (load_trace(args.trace) if args.trace
                else demo_trace(args.demo, args.seed))
    errors = 0
    with MappingService(args.cache_dir, engine=_ENGINES[args.backend],
                        dtype=args.dtype, beam=args.beam,
                        workers=args.workers, queue_limit=args.queue_limit,
                        coalesce=args.coalesce,
                        warm_start=args.warm_start,
                        device=args.device) as svc:
        results = replay(svc, requests)
        for req, res in zip(requests, results):
            if isinstance(res, Rejected):
                errors += res.reason == "error"
                if args.json:
                    print(json.dumps({"app": req.app, "rejected": res.reason,
                                      "detail": res.detail}))
                else:
                    print(f"[{req.app}] REJECTED ({res.reason}) {res.detail}")
            elif args.json:
                print(json.dumps(res.summary()))
            else:
                cand = res.candidate
                desc = ("x".join(str(g) for g in cand["grid"])
                        + " " + "/".join(cand["dist"]))
                cost = ("" if res.placed_cost is None
                        else f" placed={res.placed_cost:.3e}s")
                print(f"[{res.app}] procs={res.procs} {res.provenance:>5s} "
                      f"{desc}{cost} ({res.elapsed_s * 1e3:.1f} ms)")
        summary = svc.stats.summary()
    print(json.dumps(summary, indent=2))
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(summary, fh, indent=2)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
