"""Kernel launches the host makes a decode step: the profiler's runtime
launch calls in the traced window over its steps (a graph launch counts
once)."""


def read(r):
    if r.ctx.cell.mix["kind"] != "decode" or r.trace.launches == 0:
        return None
    return r.trace.launches / r.trace.steps
