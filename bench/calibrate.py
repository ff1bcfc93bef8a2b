"""Readings that a cell's limits are set from, many seeds in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed it makes one run of the cell as ``bench/run.py`` does, its
window ``run_seconds`` of ``BENCHMARK.json`` long, and prints one JSON line
with the numbers the check compares (``program``); for a seed among
``--control-seeds`` also the same numbers with the reference in the
control's precision (fp8, the next below the configuration's bf16) in the
program's place (``control``). Run it on the card; the benchmark's own runs
do not.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL = "fp8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/calibrate.py", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if p and str(Path(p).resolve()) != here]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("bench/calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    seconds = harness.load_json(ROOT / "BENCHMARK.json")["run_seconds"]
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(cell, seed, seconds, False, device, time.perf_counter(),
                          CONTROL if seed in controls else None)
        line = {"workload": cell.name, "seed": seed, "attempted": res["attempted"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "program": {k: v["value"] for k, v in res["checks"].items()}}
        if "control" in res:
            line["control"] = res["control"]
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
