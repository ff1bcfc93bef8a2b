"""The port's LM stack on the CPU against the JAX package's.

Reduced configs in float32; the JAX parameters are carried across by
``params_from_numpy`` and the inputs drawn from seeded numpy, so both
packages see the same weights and tokens. Tolerances: forward and last
logits 1e-4 (fp32; the two frameworks sum in other orders), decode
against the forward 2e-3 (``tests/test_models.py::
test_decode_matches_forward``). ``use_kernel=True`` runs the kernels'
plain versions here and is held to the JAX package's ``use_pallas=True``
(the Pallas kernels in interpret mode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build as jax_build
from repro.models import layers as jlayers
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build, layers, params_from_numpy

FWD = dict(rtol=1e-4, atol=1e-4)
DECODE = dict(rtol=2e-3, atol=2e-3)
# dense (smollm), QKV bias (qwen2), sliding window (danube), stub frontend
# with codebooks (musicgen), hybrid (hymba).
DENSE = ["smollm-135m", "qwen2-7b", "h2o-danube-1.8b", "musicgen-medium"]


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(out, expect, tol):
    np.testing.assert_allclose(out.detach().to(torch.float32).numpy(),
                               np.asarray(expect, np.float32), **tol)


_PAIRS = {}


def _pair(arch, **widths):
    """(JAX model, JAX params, port model, port params) for the reduced
    fp32 config (with ``widths`` replaced, e.g. a wider d_model); the
    zero-initialized QKV biases (qwen2, qwen2-moe) get random values in
    both, so that the bias path is exercised."""
    key = (arch, tuple(sorted(widths.items())))
    if key not in _PAIRS:
        jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32",
                                   **widths)
        tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                   **widths)
        jm, tm = jax_build(jcfg), build(tcfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        for stack in ("dense_layers", "moe_layers", "layers"):
            attn = tree.get(stack, {}).get("attn", {})
            for i, name in enumerate(("bq", "bk", "bv")):
                if name in attn:
                    attn[name] = _normal(10 + i, attn[name].shape, 0.1)
        jp = jax.tree.map(jnp.asarray, tree)
        _PAIRS[key] = (jm, jp, tm, params_from_numpy(tree, "cpu"))
    return _PAIRS[key]


def _inputs(cfg, B, S, seed=0):
    if cfg.stub_frontend:
        x = _normal(seed, (B, S, cfg.d_model))
        return jnp.asarray(x), _t(x)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S))
    return jnp.asarray(ids, jnp.int32), _t(ids).long()


# ------------------------------------------------------------------- layers
def test_rmsnorm_matches_jax():
    x, s = _normal(0, (2, 5, 64)), _normal(1, (64,))
    _close(layers.rmsnorm({"scale": _t(s)}, _t(x), 1e-5),
           jlayers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-5), FWD)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope_matches_jax(theta):
    x = _normal(2, (2, 64, 3, 16))
    pos = np.arange(64)[None, :]
    _close(layers.apply_rope(_t(x), _t(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), FWD)
    _close(layers.rope_freqs(16, theta), jlayers.rope_freqs(16, theta), FWD)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("H,Kv", [(4, 4), (4, 2), (6, 3)])
def test_naive_and_chunked_attention_match_jax(window, H, Kv):
    B, S, hd = 2, 64, 16
    q, k, v = (_normal(i, (B, S, h, hd)) for i, h in ((3, H), (4, Kv), (5, Kv)))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    expect = jlayers.naive_attention(jq, jk, jv, window=window)
    _close(layers.naive_attention(_t(q), _t(k), _t(v), window=window), expect, FWD)
    chunked = layers.chunked_attention(_t(q), _t(k), _t(v), window=window,
                                       q_chunk=16, kv_chunk=32)
    _close(chunked, jlayers.chunked_attention(jq, jk, jv, window=window,
                                              q_chunk=16, kv_chunk=32), FWD)
    _close(chunked, expect, dict(rtol=3e-5, atol=3e-5))


def test_attention_routes_long_sequences_to_chunks(monkeypatch):
    """Above CHUNK_THRESHOLD the plain path is the chunked one."""
    monkeypatch.setattr(layers, "CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(layers, "Q_CHUNK", 16)
    monkeypatch.setattr(layers, "KV_CHUNK", 16)
    calls = []
    real = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (_t(_normal(i, (1, 64, 2, 16))) for i in range(3))
    out = layers.attention(q, k, v, window=8)
    assert calls == [1]
    _close(out, jlayers.naive_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                        window=8), dict(rtol=3e-5, atol=3e-5))


@pytest.mark.parametrize("window,pos", [(0, 0), (0, 9), (16, 5), (16, 15),
                                        (16, 16), (16, 40)])
def test_decode_attention_matches_jax(window, pos):
    B, C, H, Kv, hd = 2, 16, 4, 2, 16
    q = _normal(6, (B, 1, H, hd))
    kc, vc = _normal(7, (B, C, Kv, hd)), _normal(8, (B, C, Kv, hd))
    out = layers.decode_attention(_t(q), _t(kc), _t(vc), pos, window=window)
    expect = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.int32(pos), window=window)
    _close(out, expect, FWD)


def test_swiglu_and_unembed_match_jax():
    x = _normal(9, (2, 3, 32))
    p = {"w_gate": _normal(10, (32, 48)), "w_up": _normal(11, (32, 48)),
         "w_down": _normal(12, (48, 32))}
    _close(layers.swiglu({k: _t(v) for k, v in p.items()}, _t(x)),
           jlayers.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
           FWD)
    table = _normal(13, (40, 32))
    _close(layers.unembed({"table": _t(table)}, _t(x)),
           jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)), FWD)


# ------------------------------------------------------------------- models
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-7b", "h2o-danube-1.8b",
                                  "granite-3-2b", "musicgen-medium",
                                  "pixtral-12b", "hymba-1.5b", "rwkv6-3b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_param_count_matches_jax_at_full_width(arch):
    assert build(get_config(arch)).n_params == jax_build(jax_config(arch)).n_params


@pytest.mark.parametrize("arch,S", [("smollm-135m", 32), ("qwen2-7b", 32),
                                    ("h2o-danube-1.8b", 96), ("musicgen-medium", 16)])
def test_decoder_logits_match_jax(arch, S):
    jm, jp, tm, tp = _pair(arch)
    jin, tin = _inputs(tm.cfg, 2, S)
    jl, _ = jm.logits(jp, jin, remat=False)
    tl, _ = tm.logits(tp, tin)
    assert tl.shape == jl.shape
    _close(tl, jl, FWD)
    _close(tm.last_logits(tp, tin), jm.last_logits(jp, jin, remat=False), FWD)


@pytest.mark.parametrize("arch", ["granite-3-2b", "pixtral-12b"])
def test_granite_and_pixtral_match_jax(arch):
    """Tied embeddings (granite) and the stub vision frontend with rope
    theta 1e6 (pixtral) at the reduced widths: logits and last logits
    within FWD of repro's, then teacher-forced decode steps within FWD."""
    jm, jp, tm, tp = _pair(arch)
    jin, tin = _inputs(tm.cfg, 2, 32)
    jl, _ = jm.logits(jp, jin, remat=False)
    tl, _ = tm.logits(tp, tin)
    assert tl.shape == jl.shape
    _close(tl, jl, FWD)
    _close(tm.last_logits(tp, tin), jm.last_logits(jp, jin, remat=False), FWD)
    B, S = 2, 6
    jin, tin = _inputs(tm.cfg, B, S, seed=1)
    jdecode = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, 16)
    tcache = tm.init_cache(B, 16, device="cpu")
    step = make_serve_step(tm)
    for t in range(S):
        jl, jcache = jdecode(jp, jcache, jnp.int32(t), jin[:, t:t + 1])
        tl, tcache = step(tp, tcache, t, tin[:, t:t + 1])
        _close(tl, jl, FWD)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_hymba_logits_match_jax(use_kernel):
    """S = 128 exceeds the reduced window (64), so the SWA mask bites;
    use_kernel against use_pallas runs flash and mamba in interpret mode
    on the JAX side and their plain versions here."""
    jm, jp, tm, tp = _pair("hymba-1.5b")
    jin, tin = _inputs(tm.cfg, 2, 128)
    jl, _ = jm.logits(jp, jin, use_pallas=use_kernel, remat=False)
    tl, _ = tm.logits(tp, tin, use_kernel=use_kernel)
    _close(tl, jl, FWD)
    assert ops.launch_counts()["flash_attention"] == 0   # plain on the CPU
    step = make_prefill_step(tm, use_kernel=use_kernel)
    _close(step(tp, tin), jm.last_logits(jp, jin, use_pallas=use_kernel,
                                         remat=False), FWD)


# RWKV-6 reduced: d_model 64 is one head of 64; 128 gives two.
RWKV = [("rwkv6-3b", {}), ("rwkv6-3b", {"d_model": 128})]


@pytest.mark.parametrize("arch,widths", [("smollm-135m", {}), ("qwen2-7b", {}),
                                         ("h2o-danube-1.8b", {}),
                                         ("hymba-1.5b", {}), *RWKV,
                                         ("qwen2-moe-a2.7b", {}),
                                         ("deepseek-v2-lite-16b", {})])
def test_decode_step_matches_jax(arch, widths):
    jm, jp, tm, tp = _pair(arch, **widths)
    B, S = 2, 6
    jin, tin = _inputs(tm.cfg, B, S, seed=1)
    jdecode = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, 16)
    tcache = tm.init_cache(B, 16, device="cpu")
    step = make_serve_step(tm)
    for t in range(S):
        jl, jcache = jdecode(jp, jcache, jnp.int32(t), jin[:, t:t + 1])
        tl, tcache = step(tp, tcache, t, tin[:, t:t + 1])
        _close(tl, jl, FWD)
    for name, buf in tcache.items():
        expect = np.asarray(jcache[name], np.float32)
        if name == "wkv":
            # RWKV-6's state sums k v^T products over the steps; on these
            # weights its entries reach the hundreds while the logits stay
            # O(1), so its atol is FWD's relative to its largest entry.
            _close(buf, expect, dict(rtol=FWD["rtol"],
                                     atol=FWD["atol"] * float(np.abs(expect).max())))
        else:
            _close(buf, expect, FWD)


@pytest.mark.parametrize("arch,S,widths", [
    ("smollm-135m", 12, {}), ("qwen2-7b", 12, {}), ("h2o-danube-1.8b", 80, {}),
    ("hymba-1.5b", 80, {}), ("rwkv6-3b", 40, {}), ("rwkv6-3b", 40, {"d_model": 128}),
    ("qwen2-moe-a2.7b", 12, {}), ("deepseek-v2-lite-16b", 12, {})])
def test_decode_matches_forward(arch, S, widths):
    """Teacher-forced decode reproduces the forward logits (through the
    kernels' plain versions; MLA has none, so deepseek's forward is
    plain); at S = 80 the SWA configs' ring buffers (capacity 64) wrap."""
    _, _, tm, tp = _pair(arch, **widths)
    _, tin = _inputs(tm.cfg, 1, S, seed=2)
    full, _ = tm.logits(tp, tin, use_kernel=not tm.cfg.use_mla)
    cache = tm.init_cache(1, S, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = tm.decode_step(tp, cache, t, tin[:, t:t + 1])
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), DECODE)


def test_hymba_mixer_kernel_path_matches_scan():
    """The mixer's kernel path (zero state) against its scan at the
    tolerance of tests/test_kernels.py::test_mamba_scan_matches_model_mixer,
    and the final states likewise."""
    from repro_torch.models.hymba import mamba_mixer

    _, _, tm, tp = _pair("hymba-1.5b")
    p = {k: v[0] for k, v in tp["layers"]["mamba"].items()}
    x = _t(_normal(14, (2, 64, tm.cfg.d_model)))
    scan_out, scan_state, conv = mamba_mixer(p, x, tm.cfg)
    kern_out, kern_state, conv_k = mamba_mixer(p, x, tm.cfg, use_kernel=True)
    torch.testing.assert_close(kern_out, scan_out, rtol=1e-2, atol=5e-2)
    torch.testing.assert_close(kern_state, scan_state, rtol=1e-2, atol=5e-2)
    torch.testing.assert_close(conv_k, conv, rtol=0, atol=0)


def test_init_params_is_seeded_and_shaped():
    tm = build(get_config("hymba-1.5b").reduced())
    a = tm.init(torch.Generator().manual_seed(3), device="cpu")
    b = tm.init(torch.Generator().manual_seed(3), device="cpu")
    jshapes = jax.tree.map(lambda s: s.shape, jax_build(
        jax_config("hymba-1.5b").reduced()).abstract())
    assert jax.tree.map(lambda t: tuple(t.shape), a) == jshapes
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert torch.all(a["layers"]["mamba"]["D"] == 1)
    assert tm.cfg.sliding_window == 64


# ---------------------------------------------------------------- MoE, MLA
MOE = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("S", [32, 384])
def test_moe_decoder_logits_match_jax(arch, S):
    """Logits, last logits and the summed aux loss of the MoE decoders; at
    B=2, S=384 the 768 tokens pass EXACT_DISPATCH_MAX_TOKENS, so the
    fixed capacity applies."""
    jm, jp, tm, tp = _pair(arch)
    jin, tin = _inputs(tm.cfg, 2, S, seed=5)
    jl, jaux = jm.logits(jp, jin, remat=False)
    tl, taux = tm.logits(tp, tin)
    assert tl.shape == jl.shape
    _close(tl, jl, FWD)
    _close(taux, jaux, FWD)
    _close(tm.last_logits(tp, tin), jm.last_logits(jp, jin, remat=False), FWD)


def test_moe_stacks_follow_the_reference():
    """deepseek: one dense layer then the MoE layers, MLA weights and the
    latent cache; qwen2-moe: MoE layers only, GQA with biases."""
    for arch in MOE:
        jm, _, tm, tp = _pair(arch)
        jshapes = jax.tree.map(lambda s: s.shape, jm.abstract())
        assert jax.tree.map(lambda t: tuple(t.shape), tp) == jshapes
        cache = tm.init_cache(3, 16, device="cpu")
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: tuple(v.shape) for k, v in jm.init_cache(3, 16).items()}
    assert set(_pair("deepseek-v2-lite-16b")[2].schema) >= {"dense_layers", "moe_layers"}
    assert "dense_layers" not in _pair("qwen2-moe-a2.7b")[2].schema
    assert set(_pair("deepseek-v2-lite-16b")[2].init_cache(1, 4, device="cpu")) == {
        "ckv", "krope"}


def test_qwen2_moe_kernel_prefill_matches_pallas():
    """``use_kernel`` (flash's plain version here) against ``use_pallas``
    (the Pallas kernel in interpret mode), through the prefill step."""
    jm, jp, tm, tp = _pair("qwen2-moe-a2.7b")
    jin, tin = _inputs(tm.cfg, 2, 128, seed=6)
    expect = jm.last_logits(jp, jin, use_pallas=True, remat=False)
    _close(make_prefill_step(tm)(tp, tin), expect, FWD)
    jl, _ = jm.logits(jp, jin, use_pallas=True, remat=False)
    _close(tm.logits(tp, tin, use_kernel=True)[0], jl, FWD)
    assert ops.launch_counts()["flash_attention"] == 0     # plain on the CPU


def test_mla_refuses_the_kernel_route():
    """deepseek with ``use_kernel=True`` raises a ValueError naming MLA,
    before any work; the reference's ``use_pallas=True`` fails too (a
    TypeError: its wrapper reshapes v to q's head dim)."""
    jm, jp, tm, tp = _pair("deepseek-v2-lite-16b")
    jin, tin = _inputs(tm.cfg, 2, 32, seed=7)
    with pytest.raises(ValueError, match="MLA"):
        make_prefill_step(tm)(tp, tin)
    with pytest.raises(ValueError, match="MLA"):
        tm.logits(tp, tin, use_kernel=True)
    with pytest.raises(TypeError):
        jm.last_logits(jp, jin, use_pallas=True, remat=False)
    _close(make_prefill_step(tm, use_kernel=False)(tp, tin),
           jm.last_logits(jp, jin, remat=False), FWD)


def test_configs_are_the_jax_packages():
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            jax_config(arch))


# ------------------------------------------------------------------ RWKV-6
@pytest.mark.parametrize("arch,widths", RWKV)
def test_rwkv6_logits_match_jax(arch, widths):
    """The forward through the per-step scan (S = 48, not a multiple of
    the chunk)."""
    jm, jp, tm, tp = _pair(arch, **widths)
    jin, tin = _inputs(tm.cfg, 2, 48)
    jl, _ = jm.logits(jp, jin, remat=False)
    tl, aux = tm.logits(tp, tin)
    assert tl.shape == jl.shape and aux == 0.0
    _close(tl, jl, FWD)


@pytest.mark.parametrize("arch,widths", RWKV)
def test_rwkv6_kernel_prefill_matches_pallas(arch, widths):
    """``use_kernel`` (the wkv6 plain version here) against ``use_pallas``
    (the Pallas kernel in interpret mode), through the prefill step."""
    jm, jp, tm, tp = _pair(arch, **widths)
    jin, tin = _inputs(tm.cfg, 2, 64, seed=3)
    expect = jm.last_logits(jp, jin, use_pallas=True, remat=False)
    _close(make_prefill_step(tm)(tp, tin), expect, FWD)
    _close(tm.last_logits(tp, tin, use_kernel=False), expect, FWD)
    assert ops.launch_counts()["wkv6"] == 0                # plain on the CPU


@pytest.mark.parametrize("S,chunk", [(128, 64), (96, 32)])
def test_rwkv6_chunked_matches_jax_and_scan(S, chunk):
    """The chunk-parallel form against the reference's, and against the
    scan, from a non-zero state."""
    from repro.models.rwkv6 import wkv6_chunked as jax_chunked
    from repro_torch.models.rwkv6 import wkv6_chunked, wkv6_scan

    B, H, N = 2, 2, 16
    rng = np.random.default_rng(20)
    r, k, v = ((0.5 * rng.normal(size=(B, S, H, N))).astype(np.float32)
               for _ in range(3))
    w = (0.5 / (1 + np.exp(-rng.normal(size=(B, S, H, N)))) + 0.4).astype(np.float32)
    u = (0.1 * rng.normal(size=(H, N))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, N, N))).astype(np.float32)
    args = (r, k, v, w, u, s0)
    y, s = wkv6_chunked(*map(_t, args), chunk=chunk)
    y_j, s_j = jax_chunked(*map(jnp.asarray, args), chunk=chunk)
    _close(y, y_j, FWD)
    _close(s, s_j, FWD)
    y_s, s_s = wkv6_scan(*map(_t, args))
    _close(y, y_s.numpy(), FWD)
    _close(s, s_s.numpy(), FWD)


def test_rwkv6_wkv_impl_routes_the_plain_path(monkeypatch):
    """``set_wkv_impl("chunked")`` sends S % 64 == 0, S > 64 to the chunked
    form, which gives the scan's logits; other lengths keep the scan. The
    decays are set near trained ones (w = exp(-exp(-2)) = 0.87): with the
    random low-rank decay, products of 64 decays underflow and the chunked
    form's 1/A overflows, here as in the reference."""
    from repro_torch.models import rwkv6

    _, _, tm, tp = _pair("rwkv6-3b")
    tp = {**tp, "layers": {**tp["layers"], "tm": {
        **tp["layers"]["tm"], "wA": torch.zeros_like(tp["layers"]["tm"]["wA"]),
        "w0": torch.full_like(tp["layers"]["tm"]["w0"], -2.0)}}}
    _, tin = _inputs(tm.cfg, 1, 128, seed=4)
    scan_logits, _ = tm.logits(tp, tin)
    calls = []
    real = rwkv6.wkv6_chunked
    monkeypatch.setattr(rwkv6, "wkv6_chunked",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or real(*a, **kw))
    monkeypatch.setattr(rwkv6, "WKV_IMPL", "scan")
    rwkv6.set_wkv_impl("chunked")
    chunked_logits, _ = tm.logits(tp, tin)
    tm.logits(tp, tin[:, :40])
    assert calls == [128] * tm.cfg.n_layers
    _close(chunked_logits, scan_logits.numpy(), FWD)
    with pytest.raises(AssertionError):
        rwkv6.set_wkv_impl("pallas")


def test_rwkv6_timemix_keeps_a_carried_state_off_the_kernel():
    """With a state given, ``use_kernel`` takes the scan from that state
    (the reference's wrapper would drop it and start from zeros)."""
    from repro_torch.models.rwkv6 import HEAD_DIM, n_rwkv_heads, timemix

    _, _, tm, tp = _pair("rwkv6-3b", d_model=128)
    cfg = tm.cfg
    p = {k: v[0] for k, v in tp["layers"]["tm"].items()}
    x = _t(_normal(21, (2, 5, cfg.d_model)))
    H = n_rwkv_heads(cfg)
    s0 = _t(_normal(22, (2, H, HEAD_DIM, HEAD_DIM), 0.1))
    out_k, s_k, last = timemix(p, x, cfg, state=s0, use_kernel=True)
    out_s, s_s, _ = timemix(p, x, cfg, state=s0)
    torch.testing.assert_close(out_k, out_s, rtol=0, atol=0)
    torch.testing.assert_close(s_k, s_s, rtol=0, atol=0)
    torch.testing.assert_close(last, x[:, -1], rtol=0, atol=0)
    out_0, _, _ = timemix(p, x, cfg, use_kernel=True)
    assert not torch.allclose(out_0, out_k, atol=1e-3)
    assert ops.launch_counts()["wkv6"] == 0


def test_rwkv6_full_width_is_the_published_size():
    tm = build(get_config("rwkv6-3b"))
    assert type(tm).__name__ == "RWKV6LM"
    assert tm.n_params == 3_073_313_280
    spec = tm.cache_spec(4, 2048)
    assert spec["wkv"] == ((32, 4, 40, 64, 64), torch.float32)
    assert spec["tm_prev"] == ((32, 4, 2560), torch.bfloat16)


def test_rwkv6_init_is_seeded_and_shaped():
    tm = build(get_config("rwkv6-3b").reduced())
    a = tm.init(torch.Generator().manual_seed(3), device="cpu")
    b = tm.init(torch.Generator().manual_seed(3), device="cpu")
    jshapes = jax.tree.map(lambda s: s.shape, jax_build(
        jax_config("rwkv6-3b").reduced()).abstract())
    assert jax.tree.map(lambda t: tuple(t.shape), a) == jshapes
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    assert torch.all(a["layers"]["tm_norm"]["scale"] == 1)
    cache = tm.init_cache(3, 16, device="cpu")
    jcache = jax_build(jax_config("rwkv6-3b").reduced()).init_cache(3, 16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
