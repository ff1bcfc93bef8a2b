"""The harness on the CPU: BENCHMARK.json against the contract's rules,
cells, mixes, kinds and metrics found by their files, the work counts
against hand counts, the trace reader, the isolation check, and whole runs
at tiny sizes: sound, with the timed path broken underneath, and with the
control in the program's place."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, kernels, peaks, stats, weights
from bench.trace import Trace
from bench.tests.conftest import ROOT, cells, make_tiny_root, missing_tiny, tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in cells()]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")
# The program's settings that have a key of the published config beside them;
# a file maps more under ``published_as``.
COUNTERPARTS = {"n_layers": "num_hidden_layers", "d_model": "hidden_size", "dtype": "torch_dtype",
                "vocab_size": "vocab_size", "d_ff": "intermediate_size"}
EXPERTS = ("n_routed_experts", "num_experts", "num_local_experts")
# A width, which no cut may change: hidden, intermediate, latent, state and
# projection sizes, head sizes, expansion factors, windows, experts a token.
WIDTH = re.compile(r".*(_dim|_rank)$|.*(hidden_size|intermediate|inner|latent|state|proj"
                   r"|head_size|expan|window|conv|per_tok)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


# ------------------------------------------------------------ the contract
def _keeps_to_the_contract(b: dict, root) -> None:
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and len(b["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (root / c["file"]).is_file()
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:          # each cell listed reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], root)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def _files_are_there(b: dict, root) -> None:
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"], root)
        bench = root / "bench"
        for f in (f"traffic/{cell.mix['kind']}.py", f"reference/{cell.config['reference']}.py",
                  f"work/{cell.config['family']}.py",
                  *(f"metrics/{m['name']}.py" for m in cell.per_layer)):
            assert (bench / f).is_file(), f
        assert set(cell.spec["limits"]) and all(v > 0 for v in cell.spec["limits"].values())


def _hold_the_published_widths(b: dict, root) -> None:
    """Each configuration's file holds it as run: its ``port`` equals each
    published key it has a counterpart for. The keys it cuts are listed in
    ``reduced``, as in BENCHMARK.json, with their published values under
    ``published``; each differs from it, none is a width, the floors of a
    cut hold (8 routed experts, an eighth of the vocabulary), and the file
    says under ``deployment`` how many chips share a layer."""
    for c in b["configs"]:
        conf = json.loads((root / c["file"]).read_text())
        name, reduced, published = c["name"], conf["reduced"], conf.get("published", {})
        assert reduced == c["reduced"], name
        assert set(published) == set(reduced) and set(reduced) <= set(conf), name
        assert [k for k in reduced if conf[k] == published[k] or WIDTH.match(k)] == [], name
        pairs = {**COUNTERPARTS, **conf.get("published_as", {})}
        port = conf["port"]
        assert all(pairs[k] in conf for k in ("n_layers", "d_model", "dtype", "vocab_size")), name
        assert all(k in port and v in conf for k, v in conf.get("published_as", {}).items()), name
        differ = {k for k, v in pairs.items() if k in port and v in conf and port[k] != conf[v]}
        assert differ == set(), (name, differ)
        if reduced:
            chips = conf.get("deployment", {}).get("chips_per_layer")
            assert isinstance(chips, int) and chips >= 1, name
        for k in EXPERTS:
            if k in conf:
                assert conf[k] >= min(8, published.get(k, conf[k])), (name, k)
        assert 8 * conf["vocab_size"] >= published.get("vocab_size", conf["vocab_size"]), name


def test_benchmark_json_keeps_to_the_contract():
    _keeps_to_the_contract(BENCH, ROOT)


def test_every_file_a_cell_is_made_of_is_there():
    _files_are_there(BENCH, ROOT)


def test_configuration_files_hold_the_published_widths():
    _hold_the_published_widths(BENCH, ROOT)


def test_every_cell_has_its_tiny_sizes():
    assert missing_tiny() == []


def _cut(entry, conf, **keys):
    """Cut ``keys`` (published name -> value as run), declared in full."""
    entry["reduced"] = conf["reduced"] = sorted(keys)
    conf["published"] = {k: conf.get(k, 64) for k in keys}
    conf.update(keys)
    conf["deployment"] = {"chips_per_layer": 2}


CUTS = {
    "port_undeclared": lambda e, c: c["port"].update(n_layers=16),
    "no_published_value": lambda e, c: (_cut(e, c, num_hidden_layers=16), c.pop("published")),
    "same_as_published": lambda e, c: (_cut(e, c, num_hidden_layers=16),
                                       c["published"].update(num_hidden_layers=16)),
    "not_in_benchmark_json": lambda e, c: (_cut(e, c, num_hidden_layers=16),
                                           e.update(reduced=[])),
    "no_deployment": lambda e, c: (_cut(e, c, num_hidden_layers=16), c.pop("deployment")),
    "a_width": lambda e, c: _cut(e, c, mamba_d_state=8),
    "vocabulary_under_an_eighth": lambda e, c: _cut(e, c, vocab_size=3000),
    "experts_under_8": lambda e, c: _cut(e, c, n_routed_experts=4),
}


@pytest.mark.parametrize("case", sorted(CUTS))
def test_an_undeclared_or_wide_cut_is_refused(tmp_path, case):
    b = json.loads(json.dumps(BENCH))
    entry = next(c for c in b["configs"] if c["name"] == "hymba-1.5b")
    conf = json.loads((ROOT / entry["file"]).read_text())
    CUTS[case](entry, conf)
    if "n_layers" in conf["port"] and case != "port_undeclared":
        conf["port"]["n_layers"] = conf["num_hidden_layers"]
    conf["port"]["vocab_size"] = conf["vocab_size"]
    (tmp_path / "bench/configs").mkdir(parents=True)
    (tmp_path / entry["file"]).write_text(json.dumps(conf))
    b["configs"] = [entry]
    with pytest.raises(AssertionError):
        _hold_the_published_widths(b, tmp_path)


# --------------------------------------------------------------- counting
def test_work_counts_match_hand_counts():
    from bench.work import hymba, rwkv6

    cells = {c["name"]: harness.load_cell(w["name"]).model_cfg()
             for c in BENCH["configs"] for w in BENCH["workloads"] if w["config"] == c["name"]}
    h, r = cells["hymba-1.5b"], cells["rwkv6-3b"]
    # hymba: attention 2*1600*1600 + 2*1600*320; mamba 1600*6400 + 3200*32 + 2*3200*48
    # + 3200*1600; MLP 3*1600*5504
    assert hymba.matrix_params(h) == 6_144_000 + 15_769_600 + 26_419_200
    assert hymba.vector_params(h) == 4 * 1600 + 4 * 3200 + 2 * 3200 + 3200 * 16
    padded = 32256           # the program's head and embedding rows
    total = 32 * (hymba.matrix_params(h) + hymba.vector_params(h)) + 2 * padded * 1600 + 1600
    assert total == 1_652_328_000
    assert rwkv6.matrix_params(r) == 6 * 2560 ** 2 + 2 * 2560 * 64 + 2 * 2560 * 8960
    assert 32 * (rwkv6.matrix_params(r) + rwkv6.vector_params(r)) + 2 * 65536 * 2560 + 2560 \
        == 3_073_313_280
    for S, W in ((1, 4), (5, 4), (9, 4), (7, 0)):
        assert kernels.attention_pairs(S, W) == sum(
            min(q + 1, W) if W else q + 1 for q in range(S))
    ops, nbytes = kernels.flash(2, 8, 4, 2, 16, 4, 2)
    assert ops == 4 * 16 * 2 * 4 * kernels.attention_pairs(8, 4)
    assert nbytes == 2 * (2 * 2 * 8 * 4 * 16 + 2 * 2 * 8 * 2 * 16)
    assert kernels.wkv6(1, 3, 2, 4) == (5 * 16 * 6, 4 * (5 * 24 + 8 + 32))
    assert kernels.mamba_scan(1, 2, 3, 4) == (7 * 24 + 6, 4 * (18 + 16 + 12 + 12))
    pre = hymba.prefill(h, 2, 32768)["flops"]
    hand = (32 * (2 * hymba.matrix_params(h) * 65536
                  + 4 * 64 * 25 * 2 * kernels.attention_pairs(32768, 1024)
                  + 7 * 65536 * 3200 * 16 + 65536 * 3200 + 8 * 65536 * 3200)
            + 2 * 2 * 32001 * 1600)
    assert math.isclose(pre, hand, rel_tol=1e-12)
    dec = rwkv6.decode(r, 8, 30720)
    assert math.isclose(dec["bytes"], 2 * (32 * (rwkv6.matrix_params(r) + 12 * 2560)
                                           + 65536 * 2560 + 2560)
                        + 32 * 8 * (2 * 4 * 40 * 64 * 64 + 8 * 2560), rel_tol=1e-12)
    assert peaks.bound_s(67e12, 0, "float32") == (1.0, "operations")
    assert peaks.bound_s(0, 3.35e12, "bfloat16") == (1.0, "bytes")


# ------------------------------------------------------------ small pieces
def test_isolation_compares_whole_top_level_names():
    assert harness.forbidden_modules({"repro_torch.models": 0, "numpy": 0}) == []
    assert harness.forbidden_modules({"repro.core": 0, "jaxlib.xla": 0, "reproduce": 0}) == \
        ["jaxlib", "repro"]
    assert harness.forbidden_modules({"flax": 0, "jax._src": 0}) == ["flax", "jax"]


def test_percentile_is_the_nearest_rank():
    assert stats.percentile(range(1, 101), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([4, 1, 3, 2], 50) == 2


def test_weights_follow_the_seed_and_the_rules():
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.params import abstract_params

    conf = json.loads((ROOT / "bench/configs/hymba-1.5b.json").read_text())
    model = registry.build(dataclasses.replace(get_config("hymba-1.5b"),
                                               **{**tiny("configs", "hymba-1.5b")["port"],
                                                  "d_ff": 4096}))
    meta = abstract_params(model.schema)
    a = weights.make_params(meta, conf["init"], 2 ** 40 + 3, CPU)
    b = weights.make_params(meta, conf["init"], 2 ** 40 + 3, CPU)
    c = weights.make_params(meta, conf["init"], 2 ** 40 + 4, CPU)
    assert torch.equal(a["lm_head"], b["lm_head"]) and not torch.equal(a["lm_head"], c["lm_head"])
    assert torch.equal(a["layers"]["mamba"]["D"], torch.ones_like(a["layers"]["mamba"]["D"]))
    assert abs(float(a["layers"]["mlp"]["w_down"].std()) - 4096 ** -0.5) < 0.05 * 4096 ** -0.5
    assert abs(float(a["embed"]["table"].std()) - 0.02) < 0.002
    assert weights.sub_seed(2 ** 31 + 7, "w") != weights.sub_seed(2 ** 31 + 8, "w")


def test_trace_reader_unions_device_time_and_names_the_gaps():
    us = 1e6

    def ev(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts * us, "dur": dur * us, "tid": tid}

    events = [ev("user_annotation", "bench.step", 0.0, 1.0),
              ev("user_annotation", "bench.step", 1.0, 1.0),
              ev("kernel", "k1", 0.1, 0.3), ev("kernel", "k2", 0.2, 0.3),
              ev("gpu_memcpy", "cp", 1.5, 0.1),
              ev("cuda_runtime", "cudaLaunchKernel", 0.05, 0.01),
              ev("cuda_runtime", "cudaLaunchKernel", 0.15, 0.01),
              ev("cuda_runtime", "cudaMemcpyAsync", 1.4, 0.01),
              ev("cpu_op", "aten::mm", 0.6, 0.8), ev("cpu_op", "aten::other", 0.6, 0.8, tid=2)]
    t = Trace(events, 2)
    assert t.window_s == 2.0 and t.launches == 2
    assert math.isclose(t.busy_s, 0.5)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("k1", "k2")
    gaps = dict(bd["idle_gaps"])
    assert math.isclose(gaps["aten::mm"], 1.0) and "aten::other" not in gaps


# ----------------------------------------------------------- the command
def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "bench/run.py", "--workload", "hymba-prefill-32k",
                           "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode == 2 and out.stdout == "" and "CUDA" in out.stderr


def test_run_from_the_benchmark_files_alone_fails(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_py(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


# ------------------------------------------------------------- whole runs
def _run(root, cell, trace=False, seconds=0.3):
    return harness.run(harness.load_cell(cell, root), 2 ** 31 + 11, seconds, trace, CPU,
                       time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_the_cells_metrics(tiny_root, cell):
    res = _run(tiny_root, cell)
    c = harness.load_cell(cell, tiny_root)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(c.spec["limits"])
    traced = _run(tiny_root, cell, trace=True)
    assert traced["correct"]
    assert {"mfu.prefill", "mfu.decode"} & set(traced["metrics"])
    assert traced["device"]["window_s"] > 0 and "breakdown" in traced


def _hashes(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _only_appended(old, new) -> bool:
    """Whether ``new`` is ``old`` with entries appended to its lists."""
    if isinstance(old, dict):
        return isinstance(new, dict) and set(old) == set(new) and all(
            _only_appended(old[k], new[k]) for k in old)
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(
            _only_appended(a, b) for a, b in zip(old, new))
    return old == new


def test_a_cell_mix_kind_config_and_metric_added_as_files_are_found(tmp_path, monkeypatch):
    """A configuration of a new family, cut in depth, with its tiny sizes,
    reference and work count; a mix and a kind; a metric that reads a span
    under a name the program has never opened: each added to a copy of the
    benchmark as new files and appended entries, with no file there
    changed, and found by the checks and by a whole run, untraced and
    traced."""
    src = tmp_path / "src"
    shutil.copytree(ROOT / "bench", src / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", src)
    hashes, old = _hashes(src), json.loads((src / "BENCHMARK.json").read_text())
    bench = src / "bench"

    def add(name, text):
        assert not (bench / name).exists(), name
        (bench / name).write_text(text if isinstance(text, str) else json.dumps(text))

    conf = json.loads((bench / "configs/hymba-1.5b.json").read_text())
    layer = harness.load_file(bench / "work/hymba.py", "test_work_hymba")
    cfg = {**conf["port"], **conf["fixed"]}
    per_layer = layer.matrix_params(cfg) + layer.vector_params(cfg)
    conf.update(name="hymba-1.5b-half", family="hymba_twin", reference="hymba_twin",
                num_hidden_layers=16, reduced=["num_hidden_layers"],
                published={"num_hidden_layers": 32},
                published_as={"d_inner": "mamba_d_inner", "ssm_state": "mamba_d_state"},
                deployment={"chips_per_layer": 1, "why": "the first of two pipeline stages"},
                n_params=conf["n_params"] - 16 * per_layer)
    conf["port"]["n_layers"] = 16
    add("configs/hymba-1.5b-half.json", conf)
    add("reference/hymba_twin.py", "from bench.reference.hymba import *  # noqa: F401,F403\n")
    add("work/hymba_twin.py", "from bench.work.hymba import *  # noqa: F401,F403\n")
    add("traffic/prefill_48.json", {"kind": "prefill_again", "batch": 3, "prompt": 48,
                                    "warmup_steps": 1})
    add("traffic/prefill_again.py", "from bench.traffic.prefill import Kind as _Prefill\n\n\n"
                                    "class Kind(_Prefill):\n    pass\n")
    add("metrics/steps_traced.py", "def read(r):\n    return r.trace.steps\n")
    add("metrics/route_calls.prefill.py",
        "import json\n\nfrom bench import spans\nfrom bench.harness import OUT\n\n\n"
        "def read(r):\n"
        "    path = r.ctx.cell.root / OUT / f'{r.ctx.cell.name}.trace.json'\n"
        "    events = json.loads(path.read_text())['traceEvents']\n"
        "    return spans.Spans(events, r.trace.start, r.trace.end).calls.get('moe.route')\n")
    add("workloads/hymba-half-48.json", {"name": "hymba-half-48", "config": "hymba-1.5b-half",
                                         "traffic": "prefill_48", "check_steps": 1,
                                         "trace_steps": 2, "limits": {"logit_err": 0.12}})
    b = json.loads((src / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "hymba-1.5b-half", "source": "test",
                         "file": "bench/configs/hymba-1.5b-half.json",
                         "reduced": ["num_hidden_layers"], "why": "test"})
    b["workloads"].append({"name": "hymba-half-48", "config": "hymba-1.5b-half",
                           "traffic": "prefill_48", "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("prefill_tok_s", "mfu.prefill"):
            m["workloads"].append("hymba-half-48")
    for name in ("steps_traced", "route_calls.prefill"):
        b["per_layer"].append({"name": name, "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "test",
                               "moves": "prefill_tok_s", "workloads": ["hymba-half-48"]})
    (src / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(FileNotFoundError, match="hymba-1.5b-half.json.*prefill_48.json"):
        make_tiny_root(tmp_path / "early", src)
    small = tiny("configs", "hymba-1.5b")
    small["port"]["sliding_window"] = 8
    add("tests/tiny/configs/hymba-1.5b-half.json", small)
    add("tests/tiny/traffic/prefill_48.json", {"why": "small already", "mix": {}})

    after = _hashes(src)
    assert {k: after[k] for k in hashes} == hashes
    assert _only_appended(old, json.loads((src / "BENCHMARK.json").read_text()))
    for check in (_keeps_to_the_contract, _files_are_there, _hold_the_published_widths):
        check(b, src)
    assert missing_tiny(src) == []

    from repro_torch import tracing
    from repro_torch.launch import steps

    make = steps.make_prefill_step

    def routed(model, use_kernel=True):
        fn = make(model, use_kernel)

        def step(params, inputs):
            with tracing.span("moe.route"):
                return fn(params, inputs)

        return step

    monkeypatch.setattr(steps, "make_prefill_step", routed)
    root = make_tiny_root(tmp_path / "tiny", src)
    res = _run(root, "hymba-half-48")
    assert res["correct"] and set(res["metrics"]) == {"prefill_tok_s", "setup_s"}
    assert res["attempted"] % 3 == 0
    traced = _run(root, "hymba-half-48", trace=True)
    assert traced["correct"] and traced["metrics"]["steps_traced"]["value"] == 2
    assert traced["metrics"]["route_calls.prefill"]["value"] == 2


def test_the_control_in_the_programs_place_is_not_correct(tmp_path):
    """The reference with fp8 products in the program's place, at full depth
    and tiny widths, fails each cell's check under the cell's limits."""
    root = make_tiny_root(tmp_path, full_depth=True)
    for name in CELLS:
        cell = harness.load_cell(name, root)
        kind = cell.module("traffic", cell.mix["kind"]).Kind(harness.build(cell, 7, CPU))
        kind.start_window()
        for _ in range(3):
            kind.step()
        assert not kind.check("fp8").correct, name


# ----------------------------------------------- the timed path broken
def _broken_prefill(monkeypatch, alter):
    from repro_torch.launch import steps

    make = steps.make_prefill_step

    def fake(model, use_kernel=True):
        fn = make(model, use_kernel)
        return lambda params, inputs: alter(fn(params, inputs), fn, params, inputs)

    monkeypatch.setattr(steps, "make_prefill_step", fake)


def _swap_extremes(out, fn, params, inputs):
    out = out.clone()
    row = out[0, -1]
    hi, lo = row.argmax(), row.argmin()
    row[hi], row[lo] = row[lo].clone(), row[hi].clone()
    return out


def _half_batch(out, fn, params, inputs):
    half = fn(params, inputs[: inputs.shape[0] // 2])
    return torch.cat([half, half], 0)


@pytest.mark.parametrize("alter", [_swap_extremes, _half_batch], ids=["answer", "half_batch"])
@pytest.mark.parametrize("cell", ["hymba-prefill-32k", "rwkv6-prefill-32k"])
def test_a_broken_prefill_is_not_correct(tiny_root, monkeypatch, cell, alter):
    _broken_prefill(monkeypatch, alter)
    assert not _run(tiny_root, cell)["correct"]


def _broken_decode(monkeypatch, fault):
    from repro_torch.launch import steps

    make = steps.make_serve_step

    def fake(model):
        fn = make(model)
        calls = [0]

        def step(params, cache, pos, token):
            calls[0] += 1
            if fault == "half_batch":     # the first half of the rows, twice
                h = token.shape[0] // 2
                logits, _ = fn(params, {k: v[:, :h] for k, v in cache.items()}, pos, token[:h])
                return torch.cat([logits, logits], 0), cache
            if fault == "state":          # the step leaves its state as it was
                logits, _ = fn(params, {k: v.clone() for k, v in cache.items()}, pos, token)
                return logits, cache
            logits, cache = fn(params, cache, pos, token)
            if calls[0] % 10 == 5:        # one row's token altered where it is produced
                logits = logits.clone()
                logits[0, -1, logits[0, -1].argmin()] = 1e4
            return logits, cache

        return step

    monkeypatch.setattr(steps, "make_serve_step", fake)


@pytest.mark.parametrize("fault", ["token", "state", "half_batch"])
@pytest.mark.parametrize("cell", ["hymba-decode-32k-b128", "hymba-decode-32k", "rwkv6-decode-32k"])
def test_a_broken_decode_is_not_correct(tiny_root, monkeypatch, cell, fault):
    _broken_decode(monkeypatch, fault)
    assert not _run(tiny_root, cell)["correct"]


def test_decode_starts_a_new_segment_at_the_end_of_its_context(tiny_root, monkeypatch):
    """However many steps a run takes, no step decodes past the mix's
    context: at its end the rows start again from the cache as it was made,
    on fresh tokens, and the check covers the last complete segment."""
    from repro_torch.launch import steps

    make, positions = steps.make_serve_step, []

    def recording(model):
        fn = make(model)

        def step(params, cache, pos, token):
            positions.append(pos)
            return fn(params, cache, pos, token)

        return step

    monkeypatch.setattr(steps, "make_serve_step", recording)
    cell = harness.load_cell("rwkv6-decode-32k", tiny_root)
    kind = cell.module("traffic", cell.mix["kind"]).Kind(harness.build(cell, 2 ** 32 + 5, CPU))
    seg = cell.mix["context"] - cell.mix["start"]
    first = kind.tokens.clone()
    for _ in range(2 * seg + 3 - cell.mix["warmup_steps"]):
        kind.step()
    assert kind.n == 2 * seg + 3 and kind.segments == 3
    assert min(positions) == cell.mix["start"] and max(positions) == cell.mix["context"] - 1
    toks, served, _ = kind.checked()
    assert toks.shape == served.shape == (cell.mix["batch"], seg)
    assert not torch.equal(toks, first) and kind.position() == cell.mix["start"] + 3
    kind.free_program()
    assert kind.check().correct


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_a_tiny_decode_runs_on_the_card(tiny_root, cuda_card):
    res = harness.run(harness.load_cell("hymba-decode-32k", tiny_root), 5, 0.5, False,
                      cuda_card, time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["itl_p95_ms"]["value"] > 0
