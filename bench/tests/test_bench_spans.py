"""The span reader (``bench/spans.py``) and the metrics that read the
program's spans and counters, on hand-made Chrome traces: device time put
down to nested spans through the launches' correlation ids, the window,
kernels launched outside every program span, runs with no program spans or
no device, and the span table's command."""
from __future__ import annotations

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest

from bench import harness, spans, trace
from bench.peaks import PEAK_OPS, bound_s
from bench.tests.conftest import ROOT

US = 1e6


def span(name, a, b, tid=1, cat=None, args=None):
    """A span as the trace files it: the harness's step a ``user_annotation``,
    the program's light ranges and the operators ``cpu_op`` events."""
    cat = cat or ("user_annotation" if name == "bench.step" else "cpu_op")
    return {"ph": "X", "cat": cat, "name": name, "ts": a * US, "dur": (b - a) * US, "tid": tid,
            "args": args or {}}


def launched(corr, t, kernel, a, dur, tid=1, cat="kernel"):
    """A runtime launch call at ``t`` on thread ``tid`` and the device event
    it started, linked by ``corr``."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t * US,
             "dur": 5.0, "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": kernel, "ts": a * US, "dur": dur * US, "tid": 7,
             "args": {"correlation": corr}}]


def prefill_trace(kernel_span="kernel.flash_attention"):
    """One benchmark step around one program step: a layer whose attention
    side launches a product, a cast and a kernel, a mixer, and launches
    outside the program's spans and outside every span. An operator is
    not a span: the product launched inside ``aten::mm`` is the ``gemm``'s."""
    return [
        span("bench.step", 0.0, 1.0), span("step.prefill", 0.01, 0.9),
        span("layer", 0.02, 0.5), span("attn", 0.03, 0.2), span("gemm", 0.04, 0.046),
        span("aten::mm", 0.041, 0.046), span("record_param_comms", 0.0405, 0.046),
        span("cast.weight", 0.06, 0.07), span(kernel_span, 0.08, 0.09),
        span("ssm", 0.25, 0.45), span("gemm", 0.26, 0.27),
        span("head", 0.6, 0.7), span("gemm", 0.61, 0.62),
        *launched(1, 0.045, "nvjet_gemm", 0.10, 0.20),
        *launched(2, 0.065, "elementwise_cast", 0.30, 0.05, cat="gpu_memcpy"),
        *launched(3, 0.085, "flash_bf16_kernel", 0.35, 0.04),
        *launched(4, 0.265, "nvjet_gemm", 0.40, 0.10),
        *launched(5, 0.28, "scan_tail", 0.50, 0.02),          # ssm's own
        *launched(6, 0.615, "nvjet_gemm", 0.60, 0.05),
        *launched(7, 0.95, "after_the_step", 0.70, 0.10),      # inside bench.step only
        {"ph": "X", "cat": "kernel", "name": "unlaunched", "ts": 0.85 * US, "dur": 0.05 * US,
         "tid": 7, "args": {"correlation": 99}},
        *launched(8, 0.99, "past_the_window", 0.95, 0.10),     # half in the window
    ]


def test_device_time_goes_to_every_span_open_at_its_launch():
    s = spans.Spans(prefill_trace(), 0.0, 1.0)
    assert math.isclose(s.device_s, 0.20 + 0.05 + 0.04 + 0.10 + 0.02 + 0.05 + 0.10 + 0.05 + 0.05)
    incl = {n: s.inclusive(n) for n in ("gemm", "cast.weight", "kernel.flash_attention", "attn",
                                        "ssm", "layer", "head", "step.prefill", "bench.step")}
    want = {"gemm": 0.35, "cast.weight": 0.05, "kernel.flash_attention": 0.04, "attn": 0.29,
            "ssm": 0.12, "layer": 0.41, "head": 0.05, "step.prefill": 0.46,
            "bench.step": 0.61}
    assert all(math.isclose(incl[n], want[n]) for n in want), incl
    assert math.isclose(s.self_s("ssm"), 0.02) and math.isclose(s.self_s("attn"), 0.0)
    assert math.isclose(s.self_s("bench.step"), 0.15)           # after the step, clipped
    assert math.isclose(s.self_s(spans.NO_SPAN), 0.05)
    assert s.calls["gemm"] == 3 and s.calls["layer"] == 1
    # idle: 0-0.1 (attn open), 0.39-0.4 (ssm), 0.52-0.6 and 0.8-0.85
    # (step.prefill), 0.65-0.7 (head), 0.9-0.95 (bench.step)
    idle = s.idle(trace.Trace(prefill_trace(), 1).gaps())
    want = {"attn": 0.1, "ssm": 0.01, "step.prefill": 0.13, "head": 0.05, "bench.step": 0.05}
    assert set(idle) == set(want) and all(math.isclose(idle[n], want[n]) for n in want), idle


def test_spans_of_other_threads_do_not_claim_a_launch():
    events = [span("bench.step", 0.0, 1.0), span("step.prefill", 0.0, 1.0),
              span("attn", 0.0, 1.0, tid=2), *launched(1, 0.5, "k", 0.5, 0.1)]
    s = spans.Spans(events, 0.0, 1.0)
    assert s.inclusive("attn") == 0.0 and math.isclose(s.self_s("step.prefill"), 0.1)


AUTOGRAD = {"Sequence number": 3, "Fwd thread id": 0}    # a Function's apply, a backward node


@pytest.mark.parametrize("name, cat, args, found", [
    ("step.prefill", "cpu_op", None, True), ("kernel.wkv6", "cpu_op", None, True),
    ("moe.dispatch", "cpu_op", None, True), ("mla_latent", "cpu_op", None, True),
    ("bench.step", "user_annotation", None, True), ("ProfilerStep#3", "user_annotation", None, True),
    ("aten::mm", "cpu_op", None, False), ("c10d::allreduce_", "cpu_op", None, False),
    ("nccl:all_reduce", "cpu_op", None, False), ("record_param_comms", "cpu_op", None, False),
    ("detach", "cpu_op", None, False), ("detach_", "cpu_op", None, False),
    ("_Constrain", "cpu_op", AUTOGRAD, False), ("_AllGather", "cpu_op", AUTOGRAD, False),
    ("MulBackward0", "cpu_op", AUTOGRAD, False), ("_SetBackward", "cpu_op", AUTOGRAD, False),
    ("moe.dispatch", "kernel", None, False), ("cudaLaunchKernel", "cuda_runtime", None, False)])
def test_a_span_is_known_by_its_form(name, cat, args, found):
    """Any host range the program opens is a span, whatever its name;
    torch's operators, process-group ranges, autograd ranges and own ranges
    are not."""
    assert spans.is_span(span(name, 0.0, 1.0, cat=cat, args=args)) is found


def test_a_span_under_a_new_name_takes_its_device_time():
    events = [span("bench.step", 0.0, 1.0), span("step.prefill", 0.0, 0.9),
              span("moe.route", 0.1, 0.2), span("moe.dispatch", 0.12, 0.15),
              span("aten::index_select", 0.13, 0.14), *launched(1, 0.135, "gather", 0.3, 0.1),
              *launched(2, 0.18, "topk", 0.5, 0.05)]
    s = spans.Spans(events, 0.0, 1.0)
    assert {"moe.route", "moe.dispatch"} <= s.names and "aten::index_select" not in s.names
    assert math.isclose(s.inclusive("moe.route"), 0.15)
    assert math.isclose(s.self_s("moe.dispatch"), 0.1) and math.isclose(s.self_s("moe.route"), 0.05)


def test_a_span_the_program_opens_under_a_new_name_is_found(tmp_path):
    """The program's own span, opened under a name it has never used, in a
    CPU profile that also runs an autograd ``Function`` forward and a
    backward pass: the span is found, and neither the ``Function``'s range
    nor a backward node's is a span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    class _Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    w = torch.ones(4, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("never.used_before"):
            y = _Twice.apply(w @ w).sum()
        y.backward()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"_Twice", "_TwiceBackward", "SumBackward0", "MmBackward0"} <= names
    assert {e["name"] for e in events if spans.is_span(e)} == {"never.used_before"}
    assert spans.Spans(events, 0.0, math.inf).calls["never.used_before"] == 1


# ------------------------------------------------------------- the metrics
def _reading(tmp_path, events, cell, kind="prefill", steps=1):
    real = harness.load_cell(cell)
    out = tmp_path / harness.OUT
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{cell}.trace.json").write_text(json.dumps({"traceEvents": events}))
    return SimpleNamespace(
        ctx=SimpleNamespace(cell=SimpleNamespace(root=tmp_path, name=cell,
                                                 mix={**real.mix, "kind": kind}),
                            cfg=real.model_cfg(),
                            work=real.module("work", real.config["family"])),
        trace=SimpleNamespace(start=0.0, end=1.0, steps=steps))


def _metric(name):
    return harness.load_file(ROOT / "bench" / "metrics" / f"{name}.py", f"test_metric_{name}")


@pytest.fixture
def step_records(monkeypatch):
    from repro_torch import tracing

    def use(records):
        monkeypatch.setattr(tracing, "steps", lambda: list(records))

    return use


def test_prefill_metrics_read_the_spans_and_the_counters(tmp_path, step_records):
    r = _reading(tmp_path, prefill_trace(), "hymba-prefill-32k")
    s = spans.Spans(prefill_trace(), 0.0, 1.0)
    assert math.isclose(_metric("cast_share.prefill").read(r), 100 * 0.05 / s.device_s)
    step_records([{"name": "step.decode", "counts": {"gemm.flops": 1}},
                  {"name": "step.prefill", "counts": {"gemm.flops": 7e13}}])
    assert math.isclose(_metric("gemm_roofline.prefill").read(r),
                        100 * 7e13 / (PEAK_OPS["bfloat16"] * 0.35))
    launches = r.ctx.work.kernel_launches(r.ctx.cfg, r.ctx.cell.mix["batch"],
                                          r.ctx.cell.mix["prompt"])
    assert math.isclose(_metric("flash_attention_span_roofline").read(r),
                        100 * bound_s(*launches["flash_bf16"])[0] / 0.04)
    assert _metric("mamba_scan_span_roofline").read(r) is None      # no such span
    assert _metric("cast_share.decode").read(r) is None             # not a decode
    step_records([])
    assert _metric("gemm_roofline.prefill").read(r) is None         # no step records


def test_the_wkv6_span_roofline_reads_its_own_span(tmp_path):
    r = _reading(tmp_path, prefill_trace("kernel.wkv6"), "rwkv6-prefill-32k")
    launches = r.ctx.work.kernel_launches(r.ctx.cfg, 2, 32768)
    assert math.isclose(_metric("wkv6_span_roofline").read(r),
                        100 * bound_s(*launches["wkv6"])[0] / 0.04)
    assert _metric("flash_attention_span_roofline").read(r) is None


def test_decode_metrics_and_a_model_without_attention(tmp_path):
    events = [e for e in prefill_trace() if e["name"] != "step.prefill"]
    events.append(span("step.decode", 0.01, 0.9))
    r = _reading(tmp_path, events, "hymba-decode-32k-b128", kind="decode")
    s = spans.Spans(events, 0.0, 1.0)
    assert math.isclose(_metric("attn_share.decode").read(r), 100 * 0.29 / s.device_s)
    assert math.isclose(_metric("cast_share.decode").read(r), 100 * 0.05 / s.device_s)
    assert _metric("cast_share.prefill").read(r) is None
    rwkv = [e for e in events if e["name"] not in ("attn", "kernel.flash_attention")]
    r = _reading(tmp_path / "rwkv", rwkv, "hymba-decode-32k-b128", kind="decode")
    assert _metric("attn_share.decode").read(r) is None
    assert _metric("cast_share.decode").read(r) is not None


@pytest.mark.parametrize("what", ["no program spans", "no device", "no trace file"])
def test_a_run_without_spans_or_device_reads_none(tmp_path, step_records, what):
    events = prefill_trace()
    if what == "no program spans":          # the harness's step span alone
        events = [e for e in events if not spans.is_span(e) or e["name"] == "bench.step"]
    elif what == "no device":
        events = [e for e in events if e.get("cat") not in ("kernel", "gpu_memcpy")]
    r = _reading(tmp_path, events, "hymba-prefill-32k")
    if what == "no trace file":
        (tmp_path / harness.OUT / "hymba-prefill-32k.trace.json").unlink()
    step_records([{"name": "step.prefill", "counts": {"gemm.flops": 7e13}}])
    for name in ("cast_share.prefill", "gemm_roofline.prefill", "flash_attention_span_roofline",
                 "mamba_scan_span_roofline"):
        assert _metric(name).read(r) is None, name


def test_the_span_table_command(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": prefill_trace()}))
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "spans.py"), str(path)],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    rows = {line.split()[0]: line.split()[1:] for line in out.stdout.splitlines()[2:]}
    assert rows["gemm"] == ["3.00", "350.000", "350.000", "0.000"]
    assert rows["attn"][:3] == ["1.00", "290.000", "0.000"]
    assert float(rows["step.prefill"][3]) > 0 and spans.NO_SPAN.split()[0] in rows
    assert "aten::mm" not in rows and "record_param_comms" not in rows
    path.write_text(json.dumps({"traceEvents": [e for e in prefill_trace()
                                                if e["name"] != "bench.step"]}))
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "spans.py"), str(path)],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 2 and "bench.step" in out.stderr
