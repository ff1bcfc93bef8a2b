"""The weight products' share of their roofline in a prefill: the program's
``gemm.flops`` counter per traced step (its step records) over the card's
peak in the configuration's dtype times the device seconds a step launched
under its ``gemm`` spans (``bench/spans.py``), in %."""
from bench import spans
from bench.peaks import PEAK_OPS


def read(r):
    if r.ctx.cell.mix["kind"] != "prefill":
        return None
    s = spans.of_run(r)
    flops = spans.step_counts(r, "step.prefill", "gemm.flops")
    if s is None or flops is None or s.inclusive("gemm") == 0:
        return None
    return 100.0 * flops / (PEAK_OPS[r.ctx.cfg["dtype"]] * s.inclusive("gemm") / r.trace.steps)
