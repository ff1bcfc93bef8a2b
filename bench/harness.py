"""The benchmark's driver: a cell's files, one run, its result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to it is found by name: ``bench/workloads/<cell>.json`` (its
sample sizes and the limits of its check), ``bench/configs/<config>.json``
(the model as run, its init rules and its reference),
``bench/traffic/<traffic>.json`` (the mix: a kind and its parameters),
``bench/traffic/<kind>.py`` (the code that drives a kind of mix),
``bench/reference/<family>.py``, ``bench/work/<family>.py`` and
``bench/metrics/<metric>.py`` (one reader a per-layer metric). A later
change adds a cell, a mix, a kind, a configuration or a metric by adding
files and entries.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
OUT = "bench_out"


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole: ``repro_torch`` is not ``repro``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str) -> ModuleType:
    """A module from a file of the benchmark, imported under ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One cell and the files it is made of."""

    name: str
    root: Path
    entry: dict            # its BENCHMARK.json workload
    spec: dict             # bench/workloads/<name>.json
    config: dict           # bench/configs/<config>.json
    mix: dict              # bench/traffic/<traffic>.json
    end_to_end: list
    per_layer: list

    @property
    def bench(self) -> Path:
        return self.root / "bench"

    def model_cfg(self) -> dict:
        """The configuration as the reference and the work count read it:
        the program's settings and the widths the program fixes in code."""
        return {**self.config["port"], **self.config.get("fixed", {})}

    def module(self, folder: str, name: str) -> ModuleType:
        return load_file(self.bench / folder / f"{name}.py", f"bench_{folder}_{name}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[name]
    spec = load_json(root / "bench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: BENCHMARK.json says {key} {entry[key]!r}, "
                             f"bench/workloads/{name}.json says {spec[key]!r}")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(root / conf["file"])
    mix = load_json(root / "bench" / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, root, entry, spec, config, mix,
                [m for m in bench["end_to_end"] if _for_cell(m, name)],
                [m for m in bench["per_layer"] if _for_cell(m, name)])


@dataclasses.dataclass
class Context:
    """What a kind of traffic needs to drive one run of a cell."""

    cell: Cell
    seed: int
    device: object
    model: object          # the program's model
    params: dict           # the benchmark's weights, in the program's layout
    cfg: dict              # Cell.model_cfg()
    ref: ModuleType        # bench/reference/<family>.py
    work: ModuleType       # bench/work/<family>.py

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def build(cell: Cell, seed: int, device) -> Context:
    """The program's model for the cell's configuration and the weights
    drawn from the seed."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.params import abstract_params

    from bench import weights

    model = registry.build(dc.replace(get_config(cell.config["arch"]), **cell.config["port"]))
    if model.n_params != cell.config["n_params"]:
        raise ValueError(f"{cell.name}: the program's {cell.config['arch']} has "
                         f"{model.n_params} parameters, bench/configs says "
                         f"{cell.config['n_params']}")
    params = weights.make_params(abstract_params(model.schema), cell.config["init"], seed,
                                 device)
    return Context(cell, seed, device, model, params, cell.model_cfg(),
                   cell.module("reference", cell.config["reference"]),
                   cell.module("work", cell.config["family"]))


@dataclasses.dataclass
class Number:
    """One number the check compares, with its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Check:
    numbers: list
    failed: int            # readings over their number's limit

    @property
    def correct(self) -> bool:
        return all(n.ok for n in self.numbers) and self.failed == 0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
        control: str | None = None) -> dict:
    """One run: set-up from ``t0`` on, the measured (or traced) window, the
    check. Returns the result line's object; with ``control``, the numbers
    the check compares with the reference in that precision in the
    program's place too, under ``control`` (``bench/calibrate.py``)."""
    import torch

    from repro_torch.kernels import ops

    from bench import trace as tracing

    t_build = time.perf_counter()
    ctx = build(cell, seed, device)
    ctx.sync()
    t_kind = time.perf_counter()
    kind = cell.module("traffic", cell.mix["kind"]).Kind(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s: start and imports {t_build - t0:.3f} s, model and "
          f"weights {t_kind - t_build:.3f} s, inputs and warm-up "
          f"{setup_s - (t_kind - t0):.3f} s", file=sys.stderr)
    launches0 = ops.launch_counts()
    result: dict = {}
    if trace:
        tr = tracing.profile(kind.step, cell.spec["trace_steps"],
                             cell.root / OUT / f"{cell.name}.trace.json", device)
        launched = {k: v - launches0[k] for k, v in ops.launch_counts().items()
                    if v != launches0[k]}
        reading = Reading(ctx, kind, tr, launched)
        metrics = {}
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        kind.start_window()
        t_start = time.perf_counter()
        while True:
            kind.step()
            elapsed = time.perf_counter() - t_start
            if elapsed >= seconds:
                break
        e2e = kind.end_to_end(elapsed)
        e2e["setup_s"] = setup_s
        print("end to end: " + ", ".join(f"{k} {v!r}" for k, v in e2e.items()), file=sys.stderr)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        device_extra = {}
    attempted = kind.attempted()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kind.free_program()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check = kind.check()
    print(f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result.update({
        "correct": check.correct,
        "attempted": attempted,
        "failed": check.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
                   "count": cell.entry["chips"], "memory_peak_bytes": peak, **device_extra},
    })
    if trace:
        result["counts"] = {"kernel_launches": launched, "steps": cell.spec["trace_steps"]}
    if control is not None:
        result["control"] = {n.name: n.value for n in kind.check(control).numbers}
    result["checks"] = {n.name: {"value": n.value, "limit": n.limit} for n in check.numbers}
    return result


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader reads: the cell's context, its
    traffic, the profiled window and the program's kernel counters."""

    ctx: Context
    kind: object
    trace: object
    kernel_launches: dict

    def step_s(self) -> float:
        return self.trace.window_s / self.trace.steps


def check_lines(result: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'OVER'}"
            for name, c in result["checks"].items()]
