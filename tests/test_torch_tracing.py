"""The port's tracing (``repro_torch/tracing.py``) on the CPU: spans only while a
profiler records, their names and nesting in an LM step's Chrome trace as the
benchmark's reader (``bench/spans.py``) finds them, the weight products'
counter and the weight casts' spans against counts from the shapes, the
kernels' launch counters, the step records, and numerics untouched."""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import registry
from repro_torch.models.params import tree_map
from repro_torch import tracing

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "hymba-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=500, d_inner=128, ssm_state=8, conv_width=4,
                       sliding_window=16, dtype="bfloat16"),
    "rwkv6-3b": dict(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
                     vocab_size=500, dtype="bfloat16"),
}
B, S, POS = 2, 32, 40
# Leaves a bf16 step reads in fp32 as they are (no cast): norms, the scan's
# and the decay's fp32 parameters; the embedding is gathered, then cast.
KEPT = {
    "hymba-1.5b": ("embed", "scale", "dt_bias", "A_log"),
    "rwkv6-3b": ("embed", "scale", "w0", "wA", "wB", "u", "ln_scale"),
}
SPANS = {
    ("hymba-1.5b", "prefill"): {"step.prefill", "embed", "layer", "attn", "attn.core", "ssm",
                                "mlp", "head", "gemm", "cast.weight",
                                "kernel.flash_attention", "kernel.causal_conv",
                                "kernel.mamba_scan"},
    ("hymba-1.5b", "decode"): {"step.decode", "embed", "layer", "attn", "attn.core", "ssm",
                               "mlp", "head", "gemm", "cast.weight"},
    ("rwkv6-3b", "prefill"): {"step.prefill", "embed", "layer", "ssm", "mlp", "head", "gemm",
                              "cast.weight", "kernel.wkv6"},
    ("rwkv6-3b", "decode"): {"step.decode", "embed", "layer", "ssm", "mlp", "head", "gemm",
                             "cast.weight"},
}
CASES = sorted(SPANS)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch, port in TINY.items():
        model = registry.build(dataclasses.replace(get_config(arch), **port))
        out[arch] = (model, model.init(torch.Generator().manual_seed(3), device="cpu"))
    return out


def _run(model, params, kind):
    """One step of the kind, on fixed inputs; returns its output tensors."""
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S), generator=torch.Generator()
                           .manual_seed(5))
    if kind == "prefill":
        return (make_prefill_step(model, use_kernel=True)(params, tokens),)
    cache = model.init_cache(B, 64, device="cpu")
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(7)))
    logits, cache = make_serve_step(model)(params, cache, POS, tokens[:, :1])
    return (logits, *cache.values())


def _trace(tmp_path, fn, record_shapes=False):
    """The complete events of a CPU profile of ``fn()``, read back from its
    exported Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _traced_spans(tmp_path, fn):
    """The spans of a CPU profile of ``fn()`` as the benchmark's reader finds
    them: (start, end, name) sorted by start. Every host range that is not
    an operator (``ns::op``) must be one the reader knows."""
    from bench.spans import is_span

    events = _trace(tmp_path, fn)
    ranges = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
              and "::" not in e["name"]]
    assert all(is_span(e) for e in ranges), {e["name"] for e in ranges if not is_span(e)}
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ranges)


def _ancestors(spans, i):
    """Names of the spans around span ``i``, innermost first."""
    a, b, _ = spans[i]
    around = [s for j, s in enumerate(spans) if j != i and s[0] <= a and b <= s[1]]
    return [n for _, _, n in sorted(around, key=lambda s: s[1] - s[0])]


# ------------------------------------------------------------------ spans
def test_no_profiler_no_record_function(models, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_range", refuse)
    assert tracing.span("gemm") is tracing.span("layer")
    for model, params in models.values():
        for kind in ("prefill", "decode"):
            _run(model, params, kind)


@pytest.mark.parametrize("arch,kind", CASES)
def test_a_step_emits_the_documented_spans_nested(models, tmp_path, arch, kind):
    model, params = models[arch]
    spans = _traced_spans(tmp_path, lambda: _run(model, params, kind))
    assert {n for _, _, n in spans} == SPANS[arch, kind]
    step = f"step.{kind}"
    assert sum(n == step for _, _, n in spans) == 1
    assert sum(n == "layer" for _, _, n in spans) == model.cfg.n_layers
    for i, (_, _, name) in enumerate(spans):
        up = _ancestors(spans, i)
        if name == step:
            assert up == []
            continue
        assert up[-1] == step, (name, up)
        if name in ("layer", "embed", "head"):
            assert up == [step]
        elif name in ("attn", "ssm", "mlp"):
            assert up[0] == "layer"
        elif name == "attn.core":
            assert up[0] == "attn"
        elif name == "kernel.flash_attention":
            assert up[:2] == ["attn.core", "attn"]
        elif name in ("kernel.causal_conv", "kernel.mamba_scan", "kernel.wkv6"):
            assert up[0] == "ssm"
        else:
            assert name in ("gemm", "cast.weight")
            assert {"attn", "ssm", "mlp", "head"} & set(up), (name, up)


@pytest.mark.parametrize("arch,kind", CASES)
def test_outputs_are_bit_identical_under_a_profiler(models, arch, kind):
    model, params = models[arch]
    plain = _run(model, params, kind)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _run(model, params, kind)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


@pytest.mark.cuda
def test_each_mixer_kernel_span_launches_its_kernel_alone_on_the_card(models, tmp_path):
    """On the card, a traced bf16 prefill of the tiny hymba puts exactly one
    device kernel under each ``kernel.causal_conv`` and ``kernel.mamba_scan``
    span, named as the roofline readers look for it: the scan's
    ``mamba_scan_kernel``, the conv's ``causal_conv_silu_kernel``, which is
    never taken for the scan's. Skipped without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch finds no CUDA card)")
    from bench.spans import HOST_CATS
    from bench.trace import DEVICE_CATS

    model, params = models["hymba-1.5b"]
    params = tree_map(lambda t: t.to("cuda"), params)
    tokens = torch.randint(0, model.cfg.vocab_size, (B, S), device="cuda")
    step = make_prefill_step(model, use_kernel=True)
    step(params, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, tokens)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    launched = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in events
                if e.get("cat") in HOST_CATS and "correlation" in e.get("args", {})}
    device = [(launched[e["args"]["correlation"]], e["name"]) for e in events
              if e.get("cat") in DEVICE_CATS and e.get("args", {}).get("correlation") in launched]
    want = {"kernel.causal_conv": "causal_conv_silu_kernel",
            "kernel.mamba_scan": "mamba_scan_kernel"}
    for span, kernel in want.items():
        spans = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == span]
        assert len(spans) == model.cfg.n_layers
        for sp in spans:
            inside = [name for (tid, ts), name in device
                      if tid == sp["tid"] and sp["ts"] <= ts <= sp["ts"] + sp["dur"]]
            assert len(inside) == 1 and kernel in inside[0], (span, inside)
    assert not any("mamba_scan_kernel" in name and "causal_conv" in name for _, name in device)


# --------------------------------------------------------------- counters
def _work_cfg(arch):
    conf = json.loads((ROOT / "bench" / "configs" / f"{arch}.json").read_text())
    return {**conf["port"], **TINY[arch], **conf.get("fixed", {})}


@pytest.mark.parametrize("arch,kind", CASES)
def test_gemm_flops_equal_the_work_count(models, arch, kind):
    """2 x tokens x the blocks' matrix parameters (``bench/work``) and the
    head at the positions whose logits the step returns, at the program's
    padded vocabulary, counted while a profiler records; with none, the
    products count nothing."""
    from bench.work import hymba, rwkv6

    work = {"hymba-1.5b": hymba, "rwkv6-3b": rwkv6}[arch]
    model, params = models[arch]
    cfg = model.cfg
    with profile(activities=[ProfilerActivity.CPU]):
        _run(model, params, kind)
    rec = tracing.steps()[-1]
    assert rec["name"] == f"step.{kind}"
    tokens = B * S if kind == "prefill" else B
    want = (2 * cfg.n_layers * work.matrix_params(_work_cfg(arch)) * tokens
            + 2 * B * cfg.padded_vocab * cfg.d_model)
    assert rec["counts"]["gemm.flops"] == want
    _run(model, params, kind)
    assert "gemm.flops" not in tracing.steps()[-1]["counts"]


def _leaf_numels(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_numels(v, path + (k,))
        else:
            yield path + (k,), v.numel(), v.dtype


@pytest.mark.parametrize("arch,kind", CASES)
def test_weight_cast_bytes_are_two_a_cast_fp32_entry(models, tmp_path, arch, kind):
    """The ``cast.weight`` spans hold every cast of a fp32 leaf and nothing
    else: one a leaf and layer (stacked leaves are cast a layer at a time),
    and the casts inside them, read from the operators' recorded shapes,
    write 2 bytes a cast fp32 entry."""
    model, params = models[arch]
    cast = [(n, d) for path, n, d in _leaf_numels(params) if not set(path) & set(KEPT[arch])]
    assert all(d == torch.float32 for _, d in cast)
    events = _trace(tmp_path, lambda: _run(model, params, kind), record_shapes=True)
    spans = [e for e in events if e["name"] == "cast.weight"]
    layers = sum(1 for path, _, _ in _leaf_numels(params)
                 if path[0] == "layers" and not set(path) & set(KEPT[arch]))
    assert len(spans) == model.cfg.n_layers * layers + 1
    written = 0
    for sp in spans:
        inside = [e for e in events if e["name"] == "aten::to" and e["tid"] == sp["tid"]
                  and sp["ts"] <= e["ts"] and e["ts"] + e["dur"] <= sp["ts"] + sp["dur"]]
        (to,) = [e for e in inside if not any(o is not e and o["ts"] <= e["ts"]
                                              and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
                                              for o in inside)]
        assert to["args"]["Input type"][0] == "float"
        written += 2 * math.prod(to["args"]["Input Dims"][0])
    assert written == 2 * sum(n for n, _ in cast)


def test_a_cast_to_the_same_dtype_counts_nothing_and_opens_no_span(tmp_path):
    from repro_torch.models.layers import weight

    w = torch.randn(4, 8)
    before = tracing.counters()
    spans = _traced_spans(tmp_path, lambda: weight(w, torch.float32))
    assert spans == [] and tracing.counters() == before
    assert weight(w, torch.float32) is w.to(torch.float32)
    assert torch.equal(weight(w, torch.bfloat16), w.to(torch.bfloat16))
    assert [n for _, _, n in _traced_spans(tmp_path, lambda: weight(w, torch.bfloat16))] == \
        ["cast.weight"]


def test_launch_counts_keep_their_keys_and_count_under_threads():
    """``ops.launch_counts()`` reads the ``kernel.<name>.launches`` counters:
    the same seven keys, counts kept by many threads at a short switch
    interval, and a reset that zeroes them."""
    keys = {"matmul", "stencil", "segment_rowmax", "flash_attention", "mamba_scan", "wkv6",
            "causal_conv"}
    before = ops.launch_counts()
    assert set(before) == keys
    n_threads, per_thread = 16, 500
    start = threading.Barrier(n_threads)

    def work():
        start.wait(timeout=30.0)
        for _ in range(per_thread):
            tracing.count("kernel.stencil.launches")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = ops.launch_counts()
    assert after["stencil"] - before["stencil"] == n_threads * per_thread
    assert {k: v for k, v in after.items() if k != "stencil"} == \
        {k: v for k, v in before.items() if k != "stencil"}
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(keys, 0)


def test_step_records_keep_the_last_steps_deltas():
    for i in range(tracing.STEPS_KEPT + 6):
        with tracing.step("step.test"):
            tracing.count("test.units", i)
    recs = tracing.steps()
    assert len(recs) == tracing.STEPS_KEPT
    assert [r["counts"].get("test.units", 0) for r in recs] == \
        list(range(6, tracing.STEPS_KEPT + 6))
    with pytest.raises(ValueError):
        with tracing.step("step.test"):
            tracing.count("test.units", 2)
            raise ValueError
    assert tracing.steps()[-1] == {"name": "step.test", "counts": {"test.units": 2}}
    tracing.reset("test.units")
    assert tracing.counters()["test.units"] == 0
