"""The port's tracing: spans on the profiler's clock and integer counters.

Spans. ``span(name)`` opens a profiler range named ``name`` while a
profiler records, and is one shared no-op context otherwise (one check of
the profiler's switch). The range is torch's light one
(``torch._C._profiler._RecordFunctionFast``, the one compiled code opens
around its kernels): one record-function event, where
``torch.profiler.record_function`` also runs two profiled operators to
open and close it, at about ten times the cost. The program keeps no clock
of its own: a span's start and end, and the device kernels launched inside
it, come from the profiler's trace, where the spans are ``cpu_op`` events
named as below on the host thread that opened them, among the operators,
and a kernel's runtime launch call carries the same ``correlation`` as the
kernel. A span's parent is the span open around it on that thread. To see
them, run the program inside any
``torch.profiler.profile(activities=[CPU, CUDA])`` and export its Chrome
trace (``prof.export_chrome_trace(path)``): the device time of a span is
that of the kernels whose launches lie inside it. ``profiling()`` is the
switch, for a site that does more for a trace than open a span.

The spans of an LM step, outermost first:

  ``step.prefill``, ``step.decode``  one call of the serving step
                                     (``launch/steps.py``)
  ``embed``                          the token gather and its cast
  ``layer``                          one layer; its self time is the norms,
                                     residual adds and mixing
  ``attn``                           the attention side: q, k, v, the cache
                                     write, the product, ``wo``
  ``attn.core``                      the product itself (``layers.attention``,
                                     ``layers.decode_attention`` with its GQA
                                     repeat)
  ``ssm``                            the recurrent mixer with its projections
                                     (Hymba's Mamba, RWKV-6's time mix)
  ``mlp``                            the MLP (SwiGLU, RWKV-6's channel mix)
  ``head``                           the final norm, the unembed and logits
                                     (twice in a prefill: the norm ends
                                     ``hidden_states``)
  ``gemm``                           one weight product (``sharding.proj``)
  ``cast.weight``                    one parameter cast to another dtype
                                     (``layers.weight``)
  ``kernel.flash_attention``,        one call of a kernel entry point in
  ``kernel.mamba_scan``,             ``kernels/ops.py``, whichever version
  ``kernel.causal_conv``,            runs (CUDA or plain), with its wrapper's
  ``kernel.wkv6``                    layout work; the causal conv and both
                                     scans (plain and gated) open theirs in
                                     ``ssm``

Counters. ``count(name, n)`` adds to an integer counter, safe from any
thread; ``counters()`` reads them all.

  ``gemm.flops``                     2 x rows x D x F of each weight product
                                     made while a profiler records (counted
                                     with its span: its reader is a traced
                                     run)
  ``kernel.<name>.launches``         launches of each hand-written CUDA
                                     kernel (``ops.launch_counts()``)

Steps. ``step(name)`` is a step's span that also keeps the counters' change
over the step: ``steps()`` gives the last ``STEPS_KEPT`` steps, oldest
first, as ``{"name": ..., "counts": {counter: change}}``, so a caller reads
per-step counts without resetting anything.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading

import torch

STEPS_KEPT = 64

profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_COUNTS: dict[str, int] = {}
_STEPS: collections.deque = collections.deque(maxlen=STEPS_KEPT)


def span(name: str):
    """A context manager: a profiler range named ``name`` while a profiler
    records, else a shared no-op."""
    if profiling():
        return _range(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if profiling():
                with _range(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``. Under a lock: the tuning service's
    worker threads launch kernels at once, and ``+=`` on a shared entry is a
    read-modify-write that the interpreter lock does not make atomic."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    with _LOCK:
        return dict(_COUNTS)


def reset(*names: str) -> None:
    """Set the named counters to zero."""
    with _LOCK:
        for name in names:
            _COUNTS[name] = 0


@contextlib.contextmanager
def step(name: str):
    """``span(name)`` around one step, whose counters' change joins
    ``steps()`` when it ends (also when it raises)."""
    before = counters()
    try:
        with span(name):
            yield
    finally:
        after = counters()
        with _LOCK:
            _STEPS.append({"name": name,
                           "counts": {k: v - before.get(k, 0) for k, v in after.items()
                                      if v != before.get(k, 0)}})


def steps() -> list[dict]:
    """The records of the last ``STEPS_KEPT`` steps, oldest first."""
    with _LOCK:
        return list(_STEPS)
