"""The plain references against the program's plain path at reduced sizes,
on the CPU, float32 on both sides; the chunked scans against step-by-step
loops; and the references' independence from the program. The
configurations are those of BENCHMARK.json's cells and the held ones, each
at its tiny size (``bench/tests/tiny``), its reference loaded from its file;
the decode comparison runs for those with a decode cell."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from bench import harness, weights
from bench.reference import plain
from bench.tests.conftest import ROOT, cells, tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FILES = {c["name"]: c["file"] for c in BENCH["configs"]}
CONFIGS = sorted({w["config"] for w in cells()})
TOL = 2e-5                 # two float32 orders of summation, relative to the largest |entry|


def _kind(traffic: str) -> str:
    return harness.load_json(ROOT / "bench" / "traffic" / f"{traffic}.json")["kind"]


DECODE = sorted({w["config"] for w in cells() if _kind(w["traffic"]) == "decode"})


def _setup(name: str, seed: int = 5):
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.params import abstract_params

    conf = json.loads((ROOT / FILES[name]).read_text())
    port = {**tiny("configs", name)["port"], "dtype": "float32"}
    model = registry.build(dataclasses.replace(get_config(conf["arch"]), **port))
    params = weights.make_params(abstract_params(model.schema), conf["init"], seed, "cpu")
    cfg = {**port, **conf.get("fixed", {})}
    ref = harness.load_file(ROOT / "bench" / "reference" / f"{conf['reference']}.py",
                            f"test_reference_{conf['reference']}")
    return model, params, cfg, conf, ref


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_match_the_program(name):
    from repro_torch.launch.steps import make_prefill_step

    model, params, cfg, _, ref = _setup(name)
    toks = torch.randint(0, cfg["vocab_size"], (2, 80), generator=torch.Generator().manual_seed(1))
    prog = make_prefill_step(model, use_kernel=True)(params, toks)[:, -1]
    assert _rel(prog, ref.prefill_last_logits(params, toks, cfg, plain.Precision())) < TOL


@pytest.mark.parametrize("name", DECODE)
def test_decode_steps_and_cache_match_the_program(name):
    """Teacher-forced steps through the program's serving step against the
    reference run over all of them at once from the same seeded cache,
    past the ring's length (hymba's window is 16 here)."""
    from repro_torch.launch.steps import make_serve_step

    model, params, cfg, conf, ref = _setup(name)
    B, T, pos0 = 2, 40, 50
    state = weights.make_state(model.cache_spec(B, 64), conf["state_init"], 3, "cpu")
    start = {k: v.clone() for k, v in state.items()}
    toks = torch.randint(0, cfg["vocab_size"], (B, T), generator=torch.Generator().manual_seed(2))
    step = make_serve_step(model)
    logits = []
    for t in range(T):
        out, state = step(params, state, pos0 + t, toks[:, t:t + 1])
        logits.append(out[:, -1])
    x, ref_state = ref.decode(params, toks, cfg, plain.Precision(), start, pos0)
    assert _rel(torch.stack(logits, 1), ref.head(params, x, plain.Precision())) < TOL
    assert set(ref_state) == set(state)
    for k in state:
        assert _rel(state[k].float(), ref_state[k]) < TOL, k


def test_selective_scan_matches_the_step_by_step_recurrence():
    g = torch.Generator().manual_seed(0)
    B, T, di, n = 2, 37, 6, 4
    xs, Bm, Cm = (torch.randn(B, T, k, generator=g) for k in (di, n, n))
    dt = torch.nn.functional.softplus(torch.randn(B, T, di, generator=g))
    A = -torch.rand(di, n, generator=g) * 2
    h = torch.randn(B, di, n, generator=g)
    y, hT = plain.selective_scan(xs, dt, Bm, Cm, A, h)
    ys = []
    for t in range(T):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * xs[:, t])[..., None] * Bm[:, t, None]
        ys.append((h * Cm[:, t, None]).sum(-1))
    assert _rel(y, torch.stack(ys, 1)) < 1e-5 and _rel(hT, h) < 1e-5


def test_wkv6_matches_the_step_by_step_recurrence():
    g = torch.Generator().manual_seed(0)
    B, T, H, N = 2, 35, 3, 8
    r, k, v = (torch.randn(B, T, H, N, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, N, generator=g)))
    u = torch.randn(H, N, generator=g)
    S = torch.randn(B, H, N, N, generator=g)
    y, ST = plain.wkv6(r, k, v, w, u, S)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    assert _rel(y, torch.stack(ys, 1)) < 1e-5 and _rel(ST, S) < 1e-5


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 0.1])
    q = plain.fp8(x)
    assert q[0] == 448.0 and abs(float(q[2]) - 0.1) <= 0.1 / 16
    a, b = torch.tensor([[0.3, 1.7, -0.9]]), torch.tensor([[1.3], [0.11], [2.2]])
    assert not torch.equal(plain.Precision("fp8").mm(a, b), plain.Precision().mm(a, b))


def test_references_import_nothing_of_the_program():
    """In a fresh process: every file of the references and the work
    counts, the benchmark's weights, kernels and peaks leave no module of
    the program, of JAX or of the JAX package behind."""
    files = sorted(str(p) for d in ("reference", "work") for p in (ROOT / "bench" / d).glob("*.py"))
    code = ("import importlib.util, sys; sys.path.insert(0, %r)\n"
            "import bench.kernels, bench.peaks, bench.weights\n"
            "for i, f in enumerate(%r):\n"
            "    spec = importlib.util.spec_from_file_location(f'isolated_{i}', f)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))" % (str(ROOT), files))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
