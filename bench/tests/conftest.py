"""Fixtures of the benchmark's tests: the program on the path, and a copy
of the benchmark whose configurations and mixes are cut to a size the CPU
runs in seconds (the cells' limits as they are).

The sizes are data: ``bench/tests/tiny/configs/<config>.json`` holds a
configuration's ``port`` at CPU size and the init rules it replaces
(``init_rules``, by pattern), ``bench/tests/tiny/traffic/<traffic>.json``
the keys of a mix it changes (``mix``). Every configuration and mix of a
cell has one; a cell without is named, and nothing is built at full width.

    PYTHONPATH=src python -m pytest -q bench/tests          # CPU, ~1 min
    PYTHONPATH=src python -m pytest -q -m cuda bench/tests  # on the card
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = Path("bench") / "tests" / "tiny"

# The decode cells at B=8, which BENCHMARK.json leaves out (their host-bound
# steps spread too widely between runs for a bound), as a later change would
# add them: the tiny copy carries them, each reporting the metrics of the
# cell named by its ``like``.
HELD = [
    {"name": "hymba-decode-32k", "config": "hymba-1.5b", "traffic": "decode_32k", "chips": 1,
     "why": "B=8 rows from position 30720 on a seeded window ring and Mamba state, closed loop",
     "like": "hymba-decode-32k-b128"},
    {"name": "rwkv6-decode-32k", "config": "rwkv6-3b", "traffic": "decode_32k", "chips": 1,
     "why": "B=8 rows from position 30720 on a seeded WKV state, closed loop",
     "like": "hymba-decode-32k-b128"},
]


def cells(src: Path = ROOT) -> list[dict]:
    """The workloads of ``src``'s BENCHMARK.json and the held cells."""
    bench = json.loads((src / "BENCHMARK.json").read_text())
    return bench["workloads"] + [{k: v for k, v in w.items() if k != "like"} for w in HELD]


def missing_tiny(src: Path = ROOT) -> list[str]:
    """The tiny files that the cells of ``src`` need and that are not there."""
    want = {f"configs/{w['config']}.json" for w in cells(src)}
    want |= {f"traffic/{w['traffic']}.json" for w in cells(src)}
    return sorted(f"{TINY / f}" for f in want if not (src / TINY / f).is_file())


def tiny(kind: str, name: str, src: Path = ROOT) -> dict:
    """``bench/tests/tiny/<kind>/<name>.json`` of ``src``."""
    return json.loads((src / TINY / kind / f"{name}.json").read_text())


def port_params(arch: str, port: dict) -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import registry

    return registry.build(dataclasses.replace(get_config(arch), **port)).n_params


def make_tiny_root(path: Path, src: Path = ROOT, dtype: str = "bfloat16",
                   full_depth: bool = False) -> Path:
    """A copy of ``src``'s BENCHMARK.json, with the held cells, and of its
    bench/ at ``path``, every configuration and mix at its tiny size; with
    ``full_depth``, each configuration keeps the depth it is run at."""
    missing = missing_tiny(src)
    if missing:
        raise FileNotFoundError(f"no tiny sizes for a cell of {src}: {missing}")
    shutil.copytree(src / "bench", path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["workloads"] = cells(src)
    for m in bench["end_to_end"] + bench["per_layer"]:
        for w in HELD:
            if w["like"] in m.get("workloads", []):
                m["workloads"].append(w["name"])
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        f = path / c["file"]
        conf, small = json.loads(f.read_text()), tiny("configs", c["name"], src)
        rules = {r[0]: r for r in small.get("init_rules", [])}
        unknown = set(rules) - {r[0] for r in conf["init"]["rules"]}
        if unknown:
            raise ValueError(f"{c['name']}: tiny init rules for no rule of the configuration: "
                             f"{sorted(unknown)}")
        conf["init"]["rules"] = [rules.get(r[0], r) for r in conf["init"]["rules"]]
        depth = {"n_layers": conf["port"]["n_layers"]} if full_depth else {}
        conf["port"] = {**small["port"], **depth, "dtype": dtype}
        conf["n_params"] = port_params(conf["arch"], conf["port"])
        f.write_text(json.dumps(conf))
    for mix in {w["traffic"] for w in bench["workloads"]}:
        f = path / "bench" / "traffic" / f"{mix}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **tiny("traffic", mix, src)["mix"]}))
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def cuda_card():
    """Skips a test without a CUDA card: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
