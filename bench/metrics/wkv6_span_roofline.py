"""The wkv6 kernel's share of its roofline in a prefill, read from the
program's ``kernel.wkv6`` spans: the least time one launch could take
(``bench/kernels.py`` from the cell's shapes, ``bench/peaks.py``) times the
spans in the traced window, over the device time launched under them,
whichever implementation runs (``bench/spans.py``), in %."""
from bench import spans


def read(r):
    return spans.kernel_roofline(r, "wkv6", "kernel.wkv6")
