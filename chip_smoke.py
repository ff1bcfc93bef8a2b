#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the apps give it (matmul fp32 rtol=atol=1e-4 and bf16 2e-2, the
   JAX package's kernel tolerances; stencil fp32 1e-4), and times both,
   with one library call beside each as a yardstick;
3. drives the main path: all nine paper apps through ``repro_torch.apps``
   at the registry's own problem sizes and default processor counts, each
   checked against its single-device oracle on the card, with the kernels'
   launch counters set to 0 just before and read just after (after one
   uncounted pass at the small validation sizes, so that the per-app times
   are not first-call times);
4. prints one JSON ``kernels`` line, the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without a CUDA card,
or without the rest of the repository beside it, it fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks: dense fp32 on the CUDA cores, dense bf16 on the
# tensor cores, HBM3 bandwidth.
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
KERNELS = {
    "matmul": {"source": "src/repro_torch/kernels/csrc/matmul.cu",
               "replaces": "src/repro/kernels/matmul.py:39"},
    "stencil": {"source": "src/repro_torch/kernels/csrc/stencil.cu",
                "replaces": "src/repro/kernels/stencil.py:36"},
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def app_shapes():
    """Block shapes the apps hand the kernels at their default procs."""
    from repro_torch import apps
    from repro_torch.apps import definitions

    p = definitions.MATMUL_PROBLEM
    mm = []
    for app in apps.iter_apps(kind=apps.MATMUL):
        g = app.tile_grid(app.default_procs)
        batch = 1
        for s in g:
            batch *= s
        if len(g) == 2 or app.name == "solomonik":   # blocks over (x, y)
            shape = (batch, p.m // g[0], p.k // g[1], p.n // g[1])
        else:                              # johnson, cosma: A (x, z), B (z, y)
            shape = (batch, p.m // g[0], p.k // g[2], p.n // g[1])
        if shape not in mm:
            mm.append(shape)
    st = apps.get("stencil")
    gx, gy = st.tile_grid(st.default_procs)
    nx, ny = definitions.STENCIL_LENGTHS
    return mm, (gx * gy, nx // gx + 2, ny // gy + 2), (nx, ny)


def check_close(name: str, out, expect, dtype: str) -> float:
    import torch

    err = float((out.float() - expect.float()).abs().max())
    if not torch.allclose(out.float(), expect.float(), **TOL[dtype]):
        fail(f"{name} disagrees with its plain version: max |diff| {err:.3e} "
             f"beyond rtol/atol {TOL[dtype]}")
    return err


def parity_and_timing(mm_shapes, stencil_block, stencil_field) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil as st_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # ---- matmul: every app block shape in fp32 and bf16, plus a ragged one.
    cases = [(s, dt) for s in mm_shapes for dt in ("float32", "bfloat16")]
    cases += [((3, 1000, 777, 513), "float32"), ((3, 1000, 777, 513), "bfloat16")]
    for (b, m, k, n), dt in cases:
        dtype = getattr(torch, dt)
        a = torch.randn((b, m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((b, k, n), generator=gen, device="cuda").to(dtype)
        err = check_close(f"matmul {dt} {(b, m, k, n)}",
                          mm_mod.matmul_cuda(a, w), ref.matmul(a, w), dt)
        print(f"parity matmul {dt:8s} batch={b} {m}x{k}x{n}: "
              f"max_abs_err={err:.3e}")
        if dt != "float32" or (b, m, k, n) not in mm_shapes:
            continue
        ref.no_tf32()
        ms = time_ms(lambda: mm_mod.matmul_cuda(a, w), reps=10)
        plain = time_ms(lambda: ref.matmul(a, w), reps=10)
        lib = time_ms(lambda: torch.matmul(a, w), reps=10)
        print(f"time   matmul {dt:8s} batch={b} {m}x{k}x{n}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, torch.matmul {lib:.4f} ms")
        if (b, m, k, n) != mm_shapes[0]:
            continue
        bnd, by = bound_ms(2.0 * b * m * n * k, 4.0 * b * (m * k + k * n + m * n), dt)
        rows["matmul"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                          "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
                          "shape": [b, m, k, n], "dtype": dt}

    # ---- stencil: the edge-replicate step on the app's field, and the
    # interior sweep on the app's halo-padded rank blocks (timed).
    field = torch.randn(stencil_field, generator=gen, device="cuda")
    err_step = check_close("stencil step", st_mod.stencil_cuda(field, interior=False),
                           ref.stencil(field), "float32")
    print(f"parity stencil step {stencil_field}: max_abs_err={err_step:.3e}")
    blocks = torch.randn(stencil_block, generator=gen, device="cuda")
    err = check_close("stencil interior", st_mod.stencil_cuda(blocks, interior=True),
                      ref.stencil_interior(blocks), "float32")
    print(f"parity stencil interior {stencil_block}: max_abs_err={err:.3e}")
    weight = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                          device="cuda").reshape(1, 1, 3, 3)
    conv_in = blocks.unsqueeze(1)
    ms = time_ms(lambda: st_mod.stencil_cuda(blocks, interior=True), reps=500)
    plain = time_ms(lambda: ref.stencil_interior(blocks), reps=500)
    lib = time_ms(lambda: F.conv2d(conv_in, weight), reps=500)
    b, h, w = stencil_block
    out_elems = b * (h - 2) * (w - 2)
    bnd, by = bound_ms(5.0 * out_elems, 4.0 * (b * h * w + out_elems), "float32")
    rows["stencil"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by,
                       "max_abs_err": max(err, err_step),
                       "shape": list(stencil_block), "dtype": "float32"}
    return rows


def apps_phase() -> dict[str, int]:
    """The main path: all nine apps at the registry's sizes, kernels on.

    A pass at the small validation sizes comes first, uncounted, so that
    the counted pass does not pay for first-call set-up (lazy loading of
    PyTorch's kernels). ``first ms`` is each app's first run at its full
    size; the steady-state times come from an uncounted pass after it.
    """
    from repro_torch import apps
    from repro_torch.apps import validate
    from repro_torch.kernels import ops

    for app in apps.iter_apps():
        if not validate.run(app, device="cuda")["ok"]:
            fail(f"{app.name} out of tolerance at the validation size")
    print(f"{'app':10s} {'procs':>5s} {'grid':>8s} {'max_err':>10s} "
          f"{'rel_err':>10s} {'first ms':>10s} {'matmul':>6s} {'stencil':>7s} ok")
    ops.reset_launch_counts()
    failures = []
    for app in apps.iter_apps():
        before = ops.launch_counts()
        res = validate.run(app, device="cuda", full=True)
        after = ops.launch_counts()
        raised = {k: after[k] - before[k] for k in after}
        grid = "x".join(str(g) for g in app.tile_grid(app.default_procs))
        rel = f"{res['rel_err']:10.3e}" if "rel_err" in res else f"{'-':>10s}"
        print(f"{app.name:10s} {app.default_procs:5d} {grid:>8s} "
              f"{res['max_err']:10.3e} {rel} {res['ms'][0]:10.3f} "
              f"{raised['matmul']:6d} {raised['stencil']:7d} {res['ok']}")
        if not res["ok"]:
            failures.append(f"{app.name} out of tolerance ({res})")
        if app.kind == apps.MATMUL and raised["matmul"] == 0:
            failures.append(f"{app.name} never launched the matmul kernel")
        if app.name == "stencil" and raised["stencil"] == 0:
            failures.append("stencil never launched the stencil kernel")
    counts = ops.launch_counts()
    if failures:
        fail("; ".join(failures))
    return counts


def steady_times(repeats: int = 6) -> None:
    """Per-app wall time after the first full-size run (uncounted): median,
    min and max of runs 2..``repeats`` on the same inputs."""
    import statistics

    from repro_torch import apps
    from repro_torch.apps import validate

    print(f"{'app':10s} {'median ms':>10s} {'min ms':>10s} {'max ms':>10s} "
          f"(runs 2..{repeats} of {repeats})")
    for app in apps.iter_apps():
        res = validate.run(app, device="cuda", full=True, repeats=repeats)
        if not res["ok"]:
            fail(f"{app.name} out of tolerance in the timing pass ({res})")
        ms = res["ms"][1:]
        print(f"{app.name:10s} {statistics.median(ms):10.3f} {min(ms):10.3f} "
              f"{max(ms):10.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA card; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from repro_torch.kernels import build, ref

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    ref.no_tf32()

    t0 = time.perf_counter()
    lib = build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.seconds:.2f} s) -> {lib.path.relative_to(ROOT)}")
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    mm_shapes, stencil_block, stencil_field = app_shapes()
    rows = parity_and_timing(mm_shapes, stencil_block, stencil_field)
    counts = apps_phase()
    steady_times()

    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": counts[name], **row,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
