"""A fixed count of steps under ``torch.profiler``, written out as a Chrome
trace under the checkout and read back: the device's intervals, the host's
kernel launches and operators, and each step's span."""
from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path

STEP = "bench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10


class Trace:
    """The events of one profiled window; times in seconds on the trace's
    clock."""

    def __init__(self, events: list, steps: int):
        self.steps = steps
        spans = [e for e in events if e.get("name") == STEP and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if len(spans) != steps:
            raise RuntimeError(f"trace holds {len(spans)} step spans, not {steps}")
        self.start = min(e["ts"] for e in spans) * 1e-6
        self.end = max(e["ts"] + e["dur"] for e in spans) * 1e-6
        self.host_tid = spans[0]["tid"]
        inside = [e for e in events if e.get("ph") == "X" and "dur" in e
                  and self.start <= e["ts"] * 1e-6 <= self.end]
        self.device = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                             for e in inside if e.get("cat") in DEVICE_CATS)
        self.launches = sum(1 for e in inside if e.get("name") in LAUNCHES)
        self.host_ops = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6, e["name"])
                               for e in inside if e.get("cat") == "cpu_op"
                               and e.get("tid") == self.host_tid)
        self._host_starts = [a for a, _, _ in self.host_ops]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's intervals, clipped to the window."""
        merged: list[list[float]] = []
        for a, b, _ in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list[tuple[float, float]]:
        edges = [self.start, *(t for iv in self.busy() for t in iv), self.end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def _host_op_at(self, t: float, look_back: int = 64) -> str:
        """The innermost host operator running at ``t``: the latest to
        start of those that have not ended."""
        i = bisect.bisect_right(self._host_starts, t)
        for a, b, name in reversed(self.host_ops[max(0, i - look_back):i]):
            if b >= t:
                return name
        return "(host between operators)"

    def breakdown(self) -> dict:
        ops: dict = collections.Counter()
        for a, b, name in self.device:
            ops[name] += b - a
        idle: dict = collections.Counter()
        for a, b in self.gaps():
            idle[self._host_op_at((a + b) / 2)] += b - a
        return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}


def profile(step, steps: int, out: Path, device) -> Trace:
    """Run ``step()`` ``steps`` times under the profiler, each in a span;
    write the trace to ``out`` and read it back."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            with record_function(STEP):
                step()
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        events = json.load(f)["traceEvents"]
    return Trace(events, steps)
