"""Device time by program span, read from a traced run's Chrome trace.

The program opens profiler spans at its layer boundaries
(``repro_torch/tracing.py``): each is a ``cpu_op`` event on the host
thread that opened it, among the operators (torch's light range), and is
told from them by its form: torch names its operators ``ns::op`` and the
ranges of its process groups ``backend:op``, and gives its autograd ranges
(a ``Function``'s apply, a backward node) a ``Sequence number``, so any
``cpu_op`` whose name holds no ``:`` and that carries no sequence number is
a span, whatever the name, but for torch's own ``TORCH_RANGES``. A
``user_annotation`` range, such as the harness's step, is a span too. Each device event (a kernel, copy or
fill) is put down to the spans open on its host thread when its runtime
launch call ran: the launch and the device event share ``args.correlation``.
A span's inclusive time is the device time of everything launched anywhere
inside it; its self time, of what was launched with it the innermost span.
Per-layer metrics read ``of_run(r)``; for people,

    python3 bench/spans.py bench_out/<cell>.trace.json

prints, per span name, its calls, inclusive and self device time and the
idle time of the device put down to it (the innermost span open on the host
at each gap's midpoint), each per step.
"""
from __future__ import annotations

import collections
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__" and not __package__:     # run as a script: the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench.harness import OUT  # noqa: E402
from bench.peaks import bound_s  # noqa: E402
from bench.trace import DEVICE_CATS, STEP, Trace  # noqa: E402

PROGRAM_STEPS = ("step.prefill", "step.decode")
TORCH_RANGES = frozenset({"record_param_comms", "detach", "detach_"})   # torch's, with no ``:``
NO_SPAN = "(no span)"
HOST_CATS = ("cuda_runtime", "cuda_driver")


def is_span(e: dict) -> bool:
    """Whether a trace event is a span: a ``user_annotation`` range, or a
    ``cpu_op`` range that is neither an operator, an autograd range nor one
    of torch's own."""
    cat, name = e.get("cat"), e.get("name", "")
    return cat == "user_annotation" or (
        cat == "cpu_op" and ":" not in name and name not in TORCH_RANGES
        and "Sequence number" not in e.get("args", {}))


class Spans:
    """The device time under each span name within ``[start, end]`` (seconds
    on the trace's clock; the whole trace where None)."""

    def __init__(self, events: list, start: float | None = None, end: float | None = None):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = collections.defaultdict(list)          # tid -> (start, end, name)
        for e in xs:
            if is_span(e):
                spans[e["tid"]].append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"]))
        device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        if start is None:
            times = [t for e in device for t in (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)]
            start, end = (min(times), max(times)) if times else (0.0, 0.0)
        self.start, self.end = start, end
        self.calls = collections.Counter(n for per in spans.values() for a, _, n in per
                                         if start <= a <= end)
        launched = {}                                  # correlation -> (tid, time)
        for e in xs:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in HOST_CATS and corr is not None:
                launched[corr] = (e["tid"], e["ts"] * 1e-6)
        at = collections.defaultdict(list)             # tid -> (launch time, seconds)
        self.device_s = self.unlaunched_s = 0.0
        for e in device:
            a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            seconds = min(b, end) - max(a, start)
            if seconds <= 0:
                continue
            self.device_s += seconds
            launch = launched.get(e.get("args", {}).get("correlation"))
            if launch is None:
                self.unlaunched_s += seconds
            else:
                at[launch[0]].append((launch[1], seconds))
        self._incl: dict = collections.Counter()
        self._self: dict = collections.Counter({NO_SPAN: self.unlaunched_s})
        for tid, launches in at.items():
            launches.sort()
            chains = open_at(spans.get(tid, []), [t for t, _ in launches])
            for (_, seconds), chain in zip(launches, chains):
                for name in set(chain):
                    self._incl[name] += seconds
                self._self[chain[-1] if chain else NO_SPAN] += seconds
        self._spans = spans

    @property
    def names(self) -> set:
        return set(self.calls)

    def inclusive(self, name: str) -> float:
        """Device seconds launched anywhere inside a span of this name."""
        return self._incl.get(name, 0.0)

    def self_s(self, name: str) -> float:
        """Device seconds launched with this name the innermost span."""
        return self._self.get(name, 0.0)

    def idle(self, gaps: list) -> dict:
        """Seconds of the device's idle ``gaps`` (``Trace.gaps()``) by the
        innermost span open on the host at each gap's midpoint (on the
        thread that opened the most spans)."""
        host = max(self._spans.values(), key=len, default=[])
        out: dict = collections.Counter()
        for (a, b), chain in zip(gaps, open_at(host, [(a + b) / 2 for a, b in gaps])):
            out[chain[-1] if chain else NO_SPAN] += b - a
        return dict(out)


def open_at(spans: list, times: list) -> list[tuple]:
    """For each of the sorted ``times``, the names of the ``spans`` (start,
    end, name) of one thread open at it, outermost first. Spans of one
    thread nest."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack: list = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] < order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack))
    return out


_CACHE: dict = {}


def of_run(r) -> Spans | None:
    """The spans of a traced run (``harness.Reading``) within its window,
    parsed once per trace file; None where the program opened no step span
    or nothing ran on a device."""
    path = r.ctx.cell.root / OUT / f"{r.ctx.cell.name}.trace.json"
    if not path.is_file():
        return None
    st = os.stat(path)
    key = (str(path), st.st_mtime_ns, st.st_size, r.trace.start, r.trace.end)
    if key not in _CACHE:
        with open(path) as f:
            s = Spans(json.load(f)["traceEvents"], r.trace.start, r.trace.end)
        _CACHE.clear()
        _CACHE[key] = s if s.device_s > 0 and s.names & set(PROGRAM_STEPS) else None
    return _CACHE[key]


def step_counts(r, step: str, counter: str) -> float | None:
    """The program's counter ``counter`` per step over the run's traced
    steps, from its record of the last steps named ``step``; None where the
    program keeps none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    records = [s for s in tracing.steps() if s["name"] == step][-r.trace.steps:]
    if len(records) < r.trace.steps:
        return None
    return sum(s["counts"].get(counter, 0) for s in records) / r.trace.steps


def kernel_roofline(r, kernel: str, span: str) -> float | None:
    """A prefill kernel's share of its roofline from its spans: the bound of
    one launch (``bench/kernels.py`` from the cell's shapes) times the spans
    named ``span`` in the window, over the device time launched under them,
    in %."""
    cfg, mix = r.ctx.cfg, r.ctx.cell.mix
    if mix["kind"] != "prefill":
        return None
    launches = r.ctx.work.kernel_launches(cfg, mix["batch"], mix["prompt"])
    s = of_run(r)
    if kernel not in launches or s is None or s.inclusive(span) == 0:
        return None
    return 100.0 * bound_s(*launches[kernel])[0] * s.calls[span] / s.inclusive(span)


def table(events: list) -> str:
    """The span table of a benchmark trace: the window of its steps, per
    step."""
    n = sum(1 for e in events if e.get("name") == STEP and e.get("ph") == "X"
            and e.get("cat") == "user_annotation")
    if not n:
        raise ValueError(f"the trace holds no {STEP} span")
    t = Trace(events, n)
    s = Spans(events, t.start, t.end)
    idle = s.idle(t.gaps())
    lines = [f"{n} steps, {1e3 * t.window_s / n:.3f} ms a step: device busy "
             f"{1e3 * t.busy_s / n:.3f} ms, device time {1e3 * s.device_s / n:.3f} ms, "
             f"idle {1e3 * sum(idle.values()) / n:.3f} ms (per step)",
             f"{'span':<28s} {'calls':>9s} {'incl_ms':>10s} {'self_ms':>10s} {'idle_ms':>10s}"]
    names = sorted(s.names | {NO_SPAN}, key=lambda k: -s.inclusive(k) - s.self_s(k))
    for name in names:
        lines.append(f"{name:<28s} {s.calls.get(name, 0) / n:9.2f} "
                     f"{1e3 * s.inclusive(name) / n:10.3f} {1e3 * s.self_s(name) / n:10.3f} "
                     f"{1e3 * idle.get(name, 0.0) / n:10.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python3 bench/spans.py <trace.json>", file=sys.stderr)
        return 2
    with open(args[0]) as f:
        events = json.load(f)["traceEvents"]
    try:
        print(table(events))
    except (ValueError, RuntimeError) as e:
        print(f"{args[0]}: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
