"""The harness on the CPU: BENCHMARK.json against the contract's rules,
cells, mixes, kinds and metrics found by their files, the work counts
against hand counts, the trace reader, the isolation check, and whole runs
at tiny sizes: sound, with the timed path broken underneath, and with the
control in the program's place."""
from __future__ import annotations

import dataclasses
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
from bench.tests.conftest import HELD, ROOT, make_tiny_root

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"] + HELD]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CPU = torch.device("cpu")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


# ------------------------------------------------------------ the contract
def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
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
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
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
        cell = harness.load_cell(w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def test_every_file_a_cell_is_made_of_is_there():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        bench = ROOT / "bench"
        for f in (f"traffic/{cell.mix['kind']}.py", f"reference/{cell.config['reference']}.py",
                  f"work/{cell.config['family']}.py",
                  *(f"metrics/{m['name']}.py" for m in cell.per_layer)):
            assert (bench / f).is_file(), f
        assert set(cell.spec["limits"]) and all(v > 0 for v in cell.spec["limits"].values())


def test_configuration_files_hold_the_published_widths():
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == []
        port = conf["port"]
        assert port["n_layers"] == conf["num_hidden_layers"]
        assert port["d_model"] == conf["hidden_size"] and port["dtype"] == conf["torch_dtype"]
        assert port["vocab_size"] == conf["vocab_size"]
        assert port["d_ff"] == conf["intermediate_size"]


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

    from bench.tests.conftest import TINY_PORT

    conf = json.loads((ROOT / "bench/configs/hymba-1.5b.json").read_text())
    model = registry.build(dataclasses.replace(get_config("hymba-1.5b"),
                                               **{**TINY_PORT["hymba-1.5b"], "d_ff": 4096}))
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
    assert math.isclose(t.busy_s, 0.5) and math.isclose(t.kernel_time(("k",))[0], 0.6)
    assert t.kernel_time(("k2",))[1] == 1
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


def test_a_cell_mix_kind_config_and_metric_added_as_files_are_found(tmp_path):
    root = make_tiny_root(tmp_path)
    bench = root / "bench"
    conf = json.loads((bench / "configs/hymba-1.5b.json").read_text())
    conf["name"] = "hymba-1.5b-narrow"
    conf["port"]["sliding_window"] = 8
    (bench / "configs/hymba-1.5b-narrow.json").write_text(json.dumps(conf))
    (bench / "traffic/prefill_48.json").write_text(json.dumps(
        {"kind": "prefill_again", "batch": 3, "prompt": 48, "warmup_steps": 1}))
    (bench / "traffic/prefill_again.py").write_text(
        "from bench.traffic.prefill import Kind as _Prefill\n\n\nclass Kind(_Prefill):\n    pass\n")
    (bench / "metrics/steps_traced.py").write_text("def read(r):\n    return r.trace.steps\n")
    (bench / "workloads/hymba-narrow-48.json").write_text(json.dumps(
        {"name": "hymba-narrow-48", "config": "hymba-1.5b-narrow", "traffic": "prefill_48",
         "check_steps": 1, "trace_steps": 2, "limits": {"logit_err": 0.12}}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "hymba-1.5b-narrow", "source": "test",
                         "file": "bench/configs/hymba-1.5b-narrow.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "hymba-narrow-48", "config": "hymba-1.5b-narrow",
                           "traffic": "prefill_48", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "prefill_tok_s":
            m["workloads"].append("hymba-narrow-48")
    b["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                           "source": "device_trace", "layer": "test", "moves": "prefill_tok_s",
                           "workloads": ["hymba-narrow-48"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = _run(root, "hymba-narrow-48")
    assert res["correct"] and set(res["metrics"]) == {"prefill_tok_s", "setup_s"}
    assert res["attempted"] % 3 == 0
    traced = _run(root, "hymba-narrow-48", trace=True)
    assert traced["metrics"]["steps_traced"]["value"] == 2 and traced["correct"]


def test_the_control_in_the_programs_place_is_not_correct(tmp_path):
    """The reference with fp8 products in the program's place, at full depth
    and tiny widths, fails each cell's check under the cell's limits."""
    from bench.tests import conftest

    deep = {k: {**v, "n_layers": 32} for k, v in conftest.TINY_PORT.items()}
    saved = conftest.TINY_PORT
    conftest.TINY_PORT = deep
    try:
        root = make_tiny_root(tmp_path)
    finally:
        conftest.TINY_PORT = saved
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
