"""The share of a decode step's device time that the attention side takes:
the device time launched under the program's ``attn`` spans (q, k, v, the
cache write, the product and ``wo``) over all device time in the traced
window (``bench/spans.py``), in %. None for a model without attention."""
from bench import spans


def read(r):
    if r.ctx.cell.mix["kind"] != "decode":
        return None
    s = spans.of_run(r)
    if s is None or "attn" not in s.names:
        return None
    return 100.0 * s.inclusive("attn") / s.device_s
