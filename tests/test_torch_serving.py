"""The port's LM serving layer on the CPU: the continuous batcher against
the JAX package's, the serving CLI, and the shared percentile math."""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build as jax_build
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving.stats import latency_summary as jax_latency_summary
from repro.serving.stats import percentile as jax_percentile
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build, params_from_numpy
from repro_torch.serving import (ContinuousBatcher, Request, ServeStats,
                                 latency_summary, percentile)


@pytest.fixture(scope="module")
def served():
    """The reduced smollm on both sides, on the same (JAX-initialized)
    weights."""
    jcfg = jax_config("smollm-135m").reduced()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build(get_config("smollm-135m").reduced())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _requests(cls, vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=int(rng.integers(3, 9))),
                max_new_tokens=int(rng.integers(2, 6))) for i in range(n)]


def test_batcher_gives_the_jax_batchers_tokens(served):
    jm, jp, tm, tp = served
    vocab = tm.cfg.vocab_size
    jreqs, treqs = _requests(JaxRequest, vocab), _requests(Request, vocab)
    jb = JaxBatcher(jm, jp, n_slots=3, max_len=32)
    tb = ContinuousBatcher(tm, tp, n_slots=3, max_len=32, device="cpu")
    for jr, tr in zip(jreqs, treqs):
        jb.submit(jr)
        tb.submit(tr)
    jstats, tstats = jb.run_until_drained(), tb.run_until_drained()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done for r in treqs)
    assert (tstats.completed, tstats.steps, tstats.tokens_out) == (
        jstats.completed, jstats.steps, jstats.tokens_out)
    s = tstats.summary()
    assert s["completed"] == 6 and s["p95_latency_s"] >= s["p50_latency_s"]


def test_slot_reuse_isolation(served):
    """A reused slot is zeroed: the same prompt gives the same completion
    first or after another request held the slot."""
    _, _, tm, tp = served
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tm.cfg.vocab_size, size=6)
    solo = ContinuousBatcher(tm, tp, n_slots=1, max_len=32, device="cpu")
    r1 = Request(uid=0, prompt=prompt, max_new_tokens=4)
    solo.submit(r1)
    solo.run_until_drained()
    shared = ContinuousBatcher(tm, tp, n_slots=1, max_len=32, device="cpu")
    shared.submit(Request(uid=1, prompt=rng.integers(0, tm.cfg.vocab_size, size=10),
                          max_new_tokens=4))
    r2 = Request(uid=2, prompt=prompt, max_new_tokens=4)
    shared.submit(r2)
    shared.run_until_drained()
    assert r1.generated == r2.generated and len(r1.generated) == 4


def test_batcher_serves_hymba():
    tm = build(get_config("hymba-1.5b").reduced())
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    batcher = ContinuousBatcher(tm, tp, n_slots=2, max_len=40, device="cpu")
    reqs = _requests(Request, tm.cfg.vocab_size, n=3, seed=2)
    for r in reqs:
        batcher.submit(r)
    stats = batcher.run_until_drained()
    assert stats.completed == 3
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)


def test_batcher_gives_the_jax_batchers_tokens_for_rwkv6():
    """The recurrent state (WKV and token-shift caches) through the slot
    pool: the same tokens as the JAX batcher on the same weights."""
    jm = jax_build(jax_config("rwkv6-3b").reduced())
    jp = jm.init(jax.random.key(1))
    tm = build(get_config("rwkv6-3b").reduced())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    vocab = tm.cfg.vocab_size
    jreqs, treqs = _requests(JaxRequest, vocab, n=5, seed=3), _requests(Request, vocab,
                                                                         n=5, seed=3)
    jb = JaxBatcher(jm, jp, n_slots=2, max_len=24)
    tb = ContinuousBatcher(tm, tp, n_slots=2, max_len=24, device="cpu")
    for jr, tr in zip(jreqs, treqs):
        jb.submit(jr)
        tb.submit(tr)
    jstats, tstats = jb.run_until_drained(), tb.run_until_drained()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert (tstats.completed, tstats.steps, tstats.tokens_out) == (
        jstats.completed, jstats.steps, jstats.tokens_out)
    assert tstats.completed == 5


def test_batcher_gives_the_jax_batchers_tokens_for_qwen2_moe():
    """The MoE decoder through the slot pool (each step routes one token,
    so at exact capacity): the JAX batcher's tokens on the same weights."""
    jm = jax_build(jax_config("qwen2-moe-a2.7b").reduced())
    jp = jm.init(jax.random.key(2))
    tm = build(get_config("qwen2-moe-a2.7b").reduced())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    vocab = tm.cfg.vocab_size
    jreqs, treqs = _requests(JaxRequest, vocab, n=5, seed=4), _requests(Request, vocab,
                                                                         n=5, seed=4)
    jb = JaxBatcher(jm, jp, n_slots=2, max_len=24)
    tb = ContinuousBatcher(tm, tp, n_slots=2, max_len=24, device="cpu")
    for jr, tr in zip(jreqs, treqs):
        jb.submit(jr)
        tb.submit(tr)
    jstats, tstats = jb.run_until_drained(), tb.run_until_drained()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert (tstats.completed, tstats.steps, tstats.tokens_out) == (
        jstats.completed, jstats.steps, jstats.tokens_out)
    assert tstats.completed == 5


@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b", "rwkv6-3b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_serve_cli_on_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                         "--prompt-len", "5", "--gen", "3"])
    assert rc == 0
    lines = out.getvalue().strip().splitlines()
    assert lines[0].startswith("generated token ids (first row):")
    row = json.loads(lines[-1])
    assert row["arch"] == arch and row["device"] == "cpu"
    assert row["decode_tok_per_s"] > 0 and row["prefill_s"] >= 0


def test_serve_cli_needs_a_card_by_default(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda runs")
    assert serve.main(["--arch", "smollm-135m"]) == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


# ----------------------------------------------------- shared percentile math
@pytest.mark.parametrize("values", [[], [3.0], [2.0, 1.0], [0.3, 0.1, 0.2],
                                    list(np.random.default_rng(4).random(37))])
@pytest.mark.parametrize("q", [0, 1, 50, 95, 99, 100])
def test_percentile_matches_jax(values, q):
    assert percentile(values, q) == jax_percentile(values, q)


def test_percentile_nearest_rank_and_range():
    data = list(range(1, 101))
    assert percentile(data, 50) == 50 and percentile(data, 95) == 95
    assert percentile([5.0, 7.0], 50) == 5.0 and percentile([5.0, 7.0], 95) == 7.0
    with pytest.raises(ValueError):
        percentile([1.0], 101)
    lat = [0.5, 0.1, 0.9, 0.3]
    assert latency_summary(lat, "x_") == jax_latency_summary(lat, "x_")


def test_serve_stats_summary_uses_percentiles():
    s = ServeStats(completed=3, steps=7, tokens_out=9, latencies=[0.3, 0.1, 0.2])
    out = s.summary()
    assert out["p50_latency_s"] == 0.2 and out["p99_latency_s"] == 0.3
    assert (out["completed"], out["steps"], out["tokens_out"]) == (3, 7, 9)
