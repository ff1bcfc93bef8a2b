"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It makes the weights and inputs on the card from the seed, builds the
program's kernels into the checkout at first use, warms up the cell's own
shapes, runs closed-loop steps for ``--seconds`` (``--trace 1``: a fixed
count of them under the profiler), checks what the steps produced against
the plain reference, and prints the numbers compared on standard error and
one JSON line last on standard output. Without a card it exits 2; if JAX or
the JAX package was loaded, 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The program from the checkout's ``src``, this folder as ``bench``
    (and not as top-level modules: ``bench/trace.py`` would hide the
    standard library's ``trace``), and every cache of the program inside
    the checkout at a fixed path."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and str(Path(p).resolve()) != here]
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    import repro_torch  # noqa: F401  (the program: a checkout without it runs nothing)
    import torch

    from bench import harness

    cell = harness.load_cell(args.workload, ROOT)

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench/run.py: {args.workload} needs {chips} CUDA card(s); torch finds "
              f"{found}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench/run.py: the run loaded {bad}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
