"""Fixtures of the benchmark's tests: the program on the path, and a copy
of the benchmark whose configurations and mixes are cut to a size the CPU
runs in seconds (the cells' limits as they are).

    PYTHONPATH=src python -m pytest -q bench/tests          # CPU, ~2 min
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

TINY_PORT = {
    "hymba-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=500, d_inner=128, ssm_state=8, conv_width=4,
                       sliding_window=16, rope_theta=10000.0, norm_eps=1e-5),
    "rwkv6-3b": dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
                     vocab_size=500, norm_eps=1e-5),
}
TINY_MIX = {"prefill_32k": dict(prompt=64),
            "decode_32k": dict(start=40, context=64),
            "decode_32k_b128": dict(batch=16, start=40, context=64)}

# The decode cells at B=8, which BENCHMARK.json leaves out (their host-bound
# steps spread too widely between runs for a bound), as a later change would
# add them: the tiny copy carries them, reporting what the B=128 cell reports.
HELD = [
    {"name": "hymba-decode-32k", "config": "hymba-1.5b", "traffic": "decode_32k", "chips": 1,
     "why": "B=8 rows from position 30720 on a seeded window ring and Mamba state, closed loop"},
    {"name": "rwkv6-decode-32k", "config": "rwkv6-3b", "traffic": "decode_32k", "chips": 1,
     "why": "B=8 rows from position 30720 on a seeded WKV state, closed loop"},
]


def port_params(name: str, port: dict) -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import registry

    return registry.build(dataclasses.replace(get_config(name), **port)).n_params


def make_tiny_root(path: Path, dtype: str = "bfloat16") -> Path:
    """A copy of BENCHMARK.json, with the held decode cells, and of bench/
    at ``path``, with the tiny sizes."""
    shutil.copytree(ROOT / "bench", path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] += HELD
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hymba-decode-32k-b128" in m.get("workloads", []):
            m["workloads"] += [w["name"] for w in HELD]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, port in TINY_PORT.items():
        f = path / "bench" / "configs" / f"{name}.json"
        conf = json.loads(f.read_text())
        # logits at the published width's scale: the limits on token gaps
        # are in logits
        for rule in conf["init"]["rules"]:
            if rule[0] == "lm_head":
                rule[2] *= (conf["port"]["d_model"] / port["d_model"]) ** 0.5
        conf["port"] = {**port, "dtype": dtype}
        conf["n_params"] = port_params(name, conf["port"])
        f.write_text(json.dumps(conf))
    for mix, upd in TINY_MIX.items():
        f = path / "bench" / "traffic" / f"{mix}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **upd}))
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
