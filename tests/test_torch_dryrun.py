"""The port's dry run on the CPU against the JAX package's: knobs, specs,
``runnable``, the roofline, the loop-aware count's mechanics and the CLI.

The counts of model cells against ``hlo_cost.analyze`` are in
``tests/test_torch_flops.py``. Everything here is exact: the specs'
shapes and dtypes, ``active_params``, ``model_flops`` and ``terms`` equal
the reference's, and the loops count exactly what they run.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.launch import knobs as jknobs
from repro.launch import roofline as jroofline
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.launch.mesh import small_mesh
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, flops, knobs, roofline, specs, steps
from repro_torch.models import layers, loops, moe, rwkv6
from repro_torch.models.config import SHAPES, ShapeConfig

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------------- knobs
def test_knobs_apply_sets_and_restores_the_port_targets():
    before = (rwkv6.WKV_IMPL, moe.CAPACITY_FACTOR, layers.Q_CHUNK, layers.KV_CHUNK,
              knobs.active())
    k = knobs.Knobs(wkv_impl="chunked", moe_capacity=2.0, attn_chunks=(512, 256),
                    microbatch=4)
    with knobs.apply(k):
        assert (rwkv6.WKV_IMPL, moe.CAPACITY_FACTOR, layers.Q_CHUNK,
                layers.KV_CHUNK) == ("chunked", 2.0, 512, 256)
        assert knobs.active() is k
        assert moe.capacity(1000, 8, 2) == 500          # 1000 * 2 * 2.0 / 8
    assert (rwkv6.WKV_IMPL, moe.CAPACITY_FACTOR, layers.Q_CHUNK, layers.KV_CHUNK,
            knobs.active()) == before


def test_knobs_restore_after_an_error():
    before = rwkv6.WKV_IMPL
    with pytest.raises(RuntimeError):
        with knobs.apply(knobs.Knobs(wkv_impl="chunked")):
            raise RuntimeError("inside")
    assert rwkv6.WKV_IMPL == before and knobs.active() == knobs.Knobs()


def test_attn_chunks_leave_chunked_attention_as_defined():
    """Both packages bind the chunk sizes as defaults when chunked_attention
    is defined, so the knob reaches only the reference's sequence-parallel
    call."""
    with knobs.apply(knobs.Knobs(attn_chunks=(256, 256))):
        defaults = layers.chunked_attention.__kwdefaults__
        assert (defaults["q_chunk"], defaults["kv_chunk"]) == (1024, 1024)


@pytest.mark.parametrize("arch,seq,batch,micro", [
    ("smollm-135m", 4096, 256, 0), ("smollm-135m", 4096, 16, 0), ("qwen2-7b", 4096, 32, 0),
    ("qwen2-moe-a2.7b", 4096, 64, 0), ("hymba-1.5b", 2048, 12, 0), ("pixtral-12b", 4096, 256, 0),
    ("smollm-135m", 4096, 256, 4), ("rwkv6-3b", 4096, 16, 2), ("deepseek-v2-lite-16b", 1000, 4, 1)])
def test_choose_microbatches_reads_the_knob_as_repro_does(arch, seq, batch, micro):
    mesh = small_mesh(("data", "model"), (1, 1))
    shape = ShapeConfig("train", seq, batch, "train")
    with knobs.apply(knobs.Knobs(microbatch=micro)), \
            jknobs.apply(jknobs.Knobs(microbatch=micro)):
        mine = steps.choose_microbatches(get_config(arch), shape)
        assert mine == jsteps.choose_microbatches(jax_config(arch), shape, mesh)
    if micro:
        assert mine == micro


# ---------------------------------------------------------------- runnable
def test_runnable_matrix():
    n_run = n_skip = 0
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            ok, why = specs.runnable(get_config(arch), shape)
            assert (ok, why) == jspecs.runnable(jax_config(arch), JSHAPES[shape.name])
            if ok:
                n_run += 1
            else:
                n_skip += 1
                assert shape.name == "long_500k"
                assert "sub-quadratic" in why
    assert n_run == 33 and n_skip == 7


# ------------------------------------------------------------------- specs
def _same(mine: dict, ref: dict) -> None:
    assert sorted(mine) == sorted(ref)
    for key, t in mine.items():
        s = ref[key]
        if isinstance(t, dict):
            _same(t, s)
            continue
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), key
        assert str(t.dtype).removeprefix("torch.") == str(jnp.dtype(s.dtype)), key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_repro(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        _same(specs.batch_specs(cfg, shape), jspecs.batch_specs(jcfg, jshape))
        _same(specs.prefill_specs(cfg, shape), jspecs.prefill_specs(jcfg, jshape))
        _same(specs.decode_specs(cfg, shape), jspecs.decode_specs(jcfg, jshape))


def test_abstract_params_match_the_schema():
    from repro.models import build as jax_build
    from repro_torch.models import build
    from repro_torch.models.params import abstract_params

    for arch in ("deepseek-v2-lite-16b", "hymba-1.5b"):
        mine = abstract_params(build(get_config(arch)).schema)
        _same(mine, jax_build(jax_config(arch)).abstract())


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_repro(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert roofline.active_params(cfg) == jroofline.active_params(jcfg)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape) == jroofline.model_flops(jcfg, JSHAPES[name])


def test_terms_equal_repro_on_the_same_cost():
    cost = {"flops": 3.5e15, "bytes accessed": 2.25e12}
    for arch, name, coll in (("qwen2-7b", "train_4k", 1.5e9), ("rwkv6-3b", "decode_32k", 0.0),
                             ("smollm-135m", "prefill_32k", 7e12)):
        mine = roofline.terms(arch, SHAPES[name], get_config(arch), "single", 256, cost, coll)
        ref = jroofline.terms(arch, JSHAPES[name], jax_config(arch), "single", 256, cost, coll)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.row() == ref.row()
    assert roofline.HEADER == jroofline.HEADER
    h100 = roofline.terms("qwen2-7b", SHAPES["train_4k"], get_config("qwen2-7b"), "1card", 1,
                          cost, 0.0, **roofline.H100)
    assert h100.compute_s == 3.5e15 / 989e12 and h100.memory_s == 2.25e12 / 3.35e12


# ------------------------------------------------------------------- loops
def test_loop_aware_flops_exact():
    def f(x, w):
        for _ in loops.trips(7, x):
            x = torch.tanh(x @ w)
        return x

    x = torch.empty(64, 64, device="meta")
    assert flops.count(f, x, x).flops == 7 * 2 * 64**3


def test_nested_loop_flops_exact():
    def g(x, w):
        for _ in loops.trips(5, x):
            for _ in loops.trips(3, x):
                x = torch.tanh(x @ w)
        return x

    x = torch.empty(32, 32, device="meta")
    assert flops.count(g, x, x).flops == 15 * 2 * 32**3


def test_loop_aware_backward_counts_every_trip():
    """A carried loop under autograd: the first trip's input needs no
    gradient, so its backward has one product where the others have
    two; the fold counts each trip's backward as its own."""
    w = torch.empty(64, 64, device="meta", requires_grad=True)
    x = torch.empty(8, 64, device="meta")

    def h(x, w):
        for _ in loops.trips(9, x):
            x = torch.tanh(x @ w)
        torch.autograd.grad(x.sum(), [w])

    per = 2 * 8 * 64 * 64
    folded, unrolled = (flops.count(h, x, w, loop_aware=a) for a in (True, False))
    assert folded.flops == unrolled.flops == (9 + 1 + 2 * 8) * per
    assert folded.bytes_unfused == unrolled.bytes_unfused
    assert folded.seconds >= 0


def test_backward_fold_raises_without_the_autograd_internals(monkeypatch):
    """The fold of a backward rests on autograd's private node numbering;
    a torch without it makes the count raise and name the fallback, where
    it would otherwise lose the backward's multipliers."""
    w = torch.empty(16, 16, device="meta", requires_grad=True)
    x = torch.empty(4, 16, device="meta")

    def h(x, w):
        for _ in loops.trips(5, x):
            x = x @ w
        torch.autograd.grad(x.sum(), [w])

    monkeypatch.delattr(torch._C, "_current_autograd_node")
    with pytest.raises(RuntimeError, match="loop_aware=False"):
        flops.count(h, x, w)
    # Five forward products, five to w's gradient, four to the carried x's.
    assert flops.count(h, x, w, loop_aware=False).flops == (5 + 5 + 4) * 2 * 4 * 16 * 16


def test_loops_leave_real_devices_alone():
    """With a count on, a CPU tensor's loop still runs every trip."""
    seen = []

    def f(x):
        for t in loops.trips(6, x):
            seen.append(t)
        return loops.stack([x] * 6, 6)

    flops.count(f, torch.zeros(2))
    assert seen == list(range(6))


def test_stack_after_a_fold_has_the_whole_length():
    a, b, c = (torch.full((2, 3), float(i)) for i in range(3))
    out = loops.stack([a, b, c], 7, dim=1)
    assert out.shape == (2, 7, 3)
    assert out[:, 0].eq(0).all() and out[:, 1:6].eq(1).all() and out[:, 6].eq(2).all()
    assert loops.stack([a], 4).shape == (4, 2, 3)


# ------------------------------------------------------------------ run_cell
def test_run_cell_meta_record():
    rec = dryrun.run_cell("rwkv6-3b", "long_500k", device="meta", verbose=False,
                          knobs=knobs.Knobs(wkv_impl="chunked"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == 1 and rec["collective_bytes"] == 0.0
    assert rec["collectives"] == {"bytes": {}}
    assert rec["flops"] > 0 and rec["bytes_accessed"] == rec["bytes_unfused"] > 0
    rt = rec["roofline"]
    assert rt["compute_s"] == rec["flops"] / 989e12
    assert rt["collective_s"] == 0.0 and rt["bottleneck"] == "memory"
    assert rt["useful_flops_ratio"] == pytest.approx(rt["model_flops"] / rec["flops"])
    assert rec["count_s"] > 0 and rec["run_s"] >= rec["count_s"]
    skip = dryrun.run_cell("qwen2-7b", "long_500k", device="meta", verbose=False)
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]
    with pytest.raises(ValueError):
        dryrun.run_cell("qwen2-7b", "train_4k", device="cpu")


def test_run_cell_cuda_without_a_card_is_an_error_record():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the card cells")
    rec = dryrun.run_cell("smollm-135m", "decode_32k", device="cuda", batch=1, verbose=False,
                          cfg=get_config("smollm-135m").reduced())
    assert rec["status"] == "error"


# --------------------------------------------------------------------- CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(REPO))


def test_cli_meta_single_cell(tmp_path):
    out = tmp_path / "dry.json"
    proc = _cli("--arch", "smollm-135m", "--shape", "train_4k", "--device", "meta",
                "--out", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 ok, 0 skipped, 0 errors" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["device"] == "meta"
    report = subprocess.run([sys.executable, str(REPO / "tools" / "roofline_report.py"),
                             str(out)], capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stderr
    assert "smollm-135m" in report.stdout and "1 cells ok" in report.stdout


def test_cli_refuses_what_it_cannot_do():
    """No card without one; a production mesh counts (``--mesh single``);
    an unknown mesh, and the mesh's switches without a mesh, are refused."""
    if not torch.cuda.is_available():
        proc = _cli("--arch", "smollm-135m", "--shape", "train_4k")
        assert proc.returncode != 0 and "needs an NVIDIA GPU" in proc.stderr
    proc = _cli("--arch", "smollm-135m", "--shape", "decode_32k", "--device", "meta",
                "--mesh", "single")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 ok, 0 skipped, 0 errors" in proc.stdout
    for flags in (("--mesh", "triple"), ("--mode", "tp"), ("--no-seq-shard",)):
        proc = _cli("--arch", "smollm-135m", "--shape", "train_4k", "--device", "meta", *flags)
        assert proc.returncode != 0 and "mesh" in proc.stderr
