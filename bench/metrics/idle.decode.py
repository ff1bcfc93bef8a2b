"""The share of the traced window of decode steps in which nothing ran on
the card: 1 minus the union of the device's intervals over the window, in
%."""


def read(r):
    if r.ctx.cell.mix["kind"] != "decode" or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
