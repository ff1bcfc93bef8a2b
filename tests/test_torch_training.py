"""The port's training path on the CPU against the JAX package's.

Reduced fp32 configs; the JAX parameters are carried across by
``params_from_numpy`` and the batches drawn from seeded numpy, so both
packages see the same weights and tokens. Tolerances: the optimizer's
arithmetic rtol 1e-6; quantization ``q`` exact and dequantized values
within 1e-7; the loss within 1e-5 and each gradient leaf within 1e-4 of
its largest entry (fp32; the two frameworks sum in other orders); three
train steps' losses and parameters within 1e-4. The port's update works
in place, so every run gets its own copy of the parameters.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import knobs as jknobs
from repro.launch import steps as jsteps
from repro.models import build as jax_build
from repro.models import sharding as jsharding
from repro.runtime import compression as jcomp
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.kernels import ops
from repro_torch.launch import knobs, steps
from repro_torch.models import build, moe, params_from_numpy
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.params import tree_leaves
from repro_torch.runtime import compression
from repro_torch.training import (
    AdamWConfig, TrainLoop, TrainState, init_state, make_train_step,
)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.loop import value_and_grad

OPT = dict(rtol=1e-6, atol=0.0)
STEP = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tree_np(tree):
    return jax.tree.map(_np, tree)


def _assert_trees_close(out, expect, tol, scaled: bool = False):
    """Leaf for leaf, the port's (sorted keys) against the reference's;
    ``scaled``: each leaf's atol relative to its largest entry."""
    out, expect = tree_leaves(out), jax.tree_util.tree_leaves(expect)
    assert len(out) == len(expect)
    for o, e in zip(out, expect):
        e = np.asarray(e)
        atol = tol["atol"] * float(np.abs(e).max()) if scaled else tol["atol"]
        np.testing.assert_allclose(_np(o), e, rtol=tol["rtol"], atol=atol)


# ---------------------------------------------------------------- optimizer
def test_cosine_lr_matches_jax():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    for s in range(0, 121, 3):
        np.testing.assert_allclose(
            _np(opt_mod.cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))),
            np.asarray(jopt.cosine_lr(jcfg, jnp.int32(s))), **OPT)


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt_mod.cosine_lr(cfg, torch.tensor(s))) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=1e-3)
    assert lrs[-1] == pytest.approx(0.1, rel=1e-2)


def _grad_tree(seed, scale=1.0):
    return {"b": {"w": _normal(seed, (7, 33), scale), "s": _normal(seed + 1, (5,), scale)},
            "a": _normal(seed + 2, (2, 3, 4), scale)}


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    g = _grad_tree(0, scale)
    clipped, norm = opt_mod.clip_by_global_norm(params_from_numpy(g, "cpu"), 1.0)
    jclipped, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    np.testing.assert_allclose(_np(norm), np.asarray(jnorm), **OPT)
    _assert_trees_close(clipped, jclipped, dict(rtol=1e-6, atol=1e-9))


def test_clip_by_global_norm():
    clipped, norm = opt_mod.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(opt_mod.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_update_matches_jax():
    """Three AdamW steps from the same parameters and gradients; the port's
    moments and parameters are written in place."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=5.0)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    p0 = _grad_tree(10)
    params = params_from_numpy(p0, "cpu")
    state = opt_mod.init(params)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    for i in range(3):
        g = _grad_tree(20 + i, 0.5)
        params, state, m = opt_mod.update(cfg, params_from_numpy(g, "cpu"), state, params)
        jparams, jstate, jm = jopt.update(jcfg, jax.tree.map(jnp.asarray, g), jstate,
                                          jparams)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]), **OPT)
        assert int(state.step) == int(jstate.step) == i + 1
        assert state.step.dtype == torch.int32
        _assert_trees_close(params, jparams, dict(rtol=1e-6, atol=1e-7))
        # The moments cancel where a gradient changes sign: rtol 1e-6 of
        # each leaf's largest entry.
        _assert_trees_close(state.mu, jstate.mu, dict(rtol=1e-6, atol=1e-6), scaled=True)
        _assert_trees_close(state.nu, jstate.nu, dict(rtol=1e-6, atol=1e-6), scaled=True)


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=300,
                      weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt_mod.init(params)
    for _ in range(200):
        params, state, _ = opt_mod.update(cfg, {"w": 2 * params["w"]}, state, params)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("n", [1000, 256, 3 * 256 + 1])
def test_quantize_matches_jax(n):
    x = _normal(n, (n,), 0.01)
    x[::17] = 0.0
    q, s = compression.quantize(torch.from_numpy(x))
    jq, js = jcomp.quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    deq = compression.dequantize(q, s, (n,), torch.float32)
    np.testing.assert_allclose(_np(deq), np.asarray(jcomp.dequantize(jq, js, (n,),
                                                                     jnp.float32)),
                               rtol=0, atol=1e-7)


def test_quantize_rounds_half_to_even():
    """127 * 2.5 / 127.0 on the block's largest entry: q ties round to even."""
    x = torch.tensor([2.5, 1.5, -0.5, 127.0] + [0.0] * 252)
    q, _ = compression.quantize(x)
    jq, _ = jcomp.quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    assert q[0, :4].tolist() == [2, 2, 0, 127]


def test_compress_tree_matches_jax():
    g = _grad_tree(30, 0.01)
    e = _grad_tree(40, 1e-4)
    comp, err = compression.compress_tree(params_from_numpy(g, "cpu"),
                                          params_from_numpy(e, "cpu"))
    jcomp_, jerr = jcomp.compress_tree(jax.tree.map(jnp.asarray, g),
                                       jax.tree.map(jnp.asarray, e))
    _assert_trees_close(comp, jcomp_, dict(rtol=0, atol=1e-7))
    _assert_trees_close(err, jerr, dict(rtol=0, atol=1e-7))
    zeros = compression.init_error(params_from_numpy(g, "cpu"))
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in tree_leaves(zeros))


def test_int8_compression_error_feedback():
    g = {"w": torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 0.01}
    comp, err2 = compression.compress_tree(g, compression.init_error(g))
    delta = (comp["w"] - g["w"]).abs()
    scale = float(g["w"].abs().max() / 127.0)
    assert float(delta.max()) <= scale * 1.01
    np.testing.assert_allclose(_np(comp["w"] + err2["w"]), _np(g["w"]),
                               rtol=1e-5, atol=1e-7)


# -------------------------------------------------------- loss and gradients
_PAIRS = {}


def _pair(arch):
    """(JAX model, JAX params, port model, numpy params) for the reduced
    fp32 config; the zero-initialized QKV biases get random values."""
    if arch not in _PAIRS:
        jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        jm, tm = jax_build(jcfg), build(tcfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
        for stack in ("dense_layers", "moe_layers", "layers"):
            attn = tree.get(stack, {}).get("attn", {})
            for i, name in enumerate(("bq", "bk", "bv")):
                if name in attn:
                    attn[name] = _normal(10 + i, attn[name].shape, 0.1)
        _PAIRS[arch] = (jm, jax.tree.map(jnp.asarray, tree), tm, tree)
    return _PAIRS[arch]


def _batch(cfg, B, S, seed, masked: bool = True):
    """(JAX batch, port batch): tokens or stub embeddings, and labels (with
    codebooks for musicgen), a few of them masked with -1 if ``masked``."""
    rng = np.random.default_rng(seed)
    if cfg.stub_frontend:
        inputs = _normal(seed, (B, S, cfg.d_model))
    else:
        inputs = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lshape = (B, S, cfg.num_codebooks) if cfg.num_codebooks > 1 else (B, S)
    labels = rng.integers(0, cfg.vocab_size, size=lshape).astype(np.int32)
    if masked:
        labels[0, :3] = -1
    batch = {"inputs": inputs, "labels": labels}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _plain_keep(expert_idx: np.ndarray, C: int) -> np.ndarray:
    """keep (G, Ng*K): a (token, choice) fits when fewer than C earlier
    ones in its group went to its expert, tokens and choices in order."""
    flat = expert_idx.reshape(expert_idx.shape[0], -1)
    keep = np.zeros(flat.shape, bool)
    for g in range(flat.shape[0]):
        seen = {}
        for i, e in enumerate(flat[g]):
            keep[g, i] = seen.get(int(e), 0) < C
            seen[int(e)] = seen.get(int(e), 0) + 1
    return keep


def _check_routing(jm, jp, tm, tp, jb, tb, monkeypatch):
    """The experts each MoE layer chooses, and its keep mask, exactly as
    the reference's (read from its top_k with the scan unrolled)."""
    chosen, mine = [], []
    real_top_k, real_route = jax.lax.top_k, moe.route

    def recording_top_k(operand, k):
        vals, idx = real_top_k(operand, k)
        chosen.append(np.asarray(idx))
        return vals, idx

    def recording_route(params, xg, cfg):
        out = real_route(params, xg, cfg)
        mine.append(out[3])
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    monkeypatch.setattr(moe, "route", recording_route)
    with jax.disable_jit():
        jm.loss(jp, jb, remat=False)
    with torch.no_grad():
        tm.loss(tp, tb, remat=False)
    monkeypatch.undo()
    n_moe = tm.cfg.n_layers - tm.cfg.first_dense_layers
    assert len(chosen) == len(mine) == n_moe
    for j_idx, t_idx in zip(chosen, mine):
        np.testing.assert_array_equal(_np(t_idx), j_idx)
        C = moe.dispatch_capacity(t_idx.shape[1], tm.cfg)
        _, keep = moe.dispatch_slots(t_idx, tm.cfg.padded_experts, C)
        np.testing.assert_array_equal(_np(keep), _plain_keep(j_idx, C))


# dense (smollm), MoE (qwen2-moe), MLA + MoE (deepseek), hybrid (hymba),
# RWKV-6 and the codebook heads of the stub frontend (musicgen).
LOSS_ARCHS = ["smollm-135m", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "hymba-1.5b",
              "rwkv6-3b", "musicgen-medium"]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch, remat, monkeypatch):
    jm, jp, tm, tree = _pair(arch)
    jb, tb = _batch(tm.cfg, 2, 16, seed=len(arch))
    tp = params_from_numpy(tree, "cpu")
    if tm.cfg.n_experts:
        _check_routing(jm, jp, tm, tp, jb, tb, monkeypatch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=remat)))(jp)
    loss, grads = value_and_grad(lambda p: tm.loss(p, tb, remat=remat), tp)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5, atol=1e-5)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for name, g, jg in zip(names, tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg)
        assert g.shape == jg.shape, name
        np.testing.assert_allclose(_np(g), jg, rtol=0,
                                   atol=1e-4 * max(float(np.abs(jg).max()), 1e-30),
                                   err_msg=name)
    assert all(not p.requires_grad or p.grad is None for p in tree_leaves(tp))


def _chunked_attention_every_chunk(q, k, v, *, window, q_chunk, kv_chunk):
    """``layers.chunked_attention`` as the reference loops it: every query
    chunk against every key chunk, none skipped."""
    from repro_torch.models import layers

    B, S, H, hd = q.shape
    groups = H // k.shape[2]
    nq, nk = S // q_chunk, S // kv_chunk
    qr = q.reshape(B, nq, q_chunk, H, hd).permute(1, 0, 3, 2, 4)
    kr = k.reshape(B, nk, kv_chunk, -1, hd).permute(1, 0, 3, 2, 4)
    vr = v.reshape(B, nk, kv_chunk, -1, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        q_pos = qi * q_chunk + torch.arange(q_chunk)
        acc = torch.zeros((B, H, q_chunk, hd))
        m = torch.full((B, H, q_chunk), layers.NEG_INF)
        denom = torch.zeros((B, H, q_chunk))
        for ki in range(nk):
            k_pos = ki * kv_chunk + torch.arange(kv_chunk)
            k_rep = torch.repeat_interleave(kr[ki], groups, dim=1)
            v_rep = torch.repeat_interleave(vr[ki], groups, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qr[qi], k_rep) * hd ** -0.5
            s = s + layers._mask_bias(q_pos, k_pos, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_rep)
            m = m_new
        outs.append(acc / torch.clamp(denom[..., None], min=1e-30))
    return torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(16, 16), (16, 8), (8, 16)])
def test_chunked_attention_skip_is_bit_identical(window, q_chunk, kv_chunk):
    """Skipping the key chunks wholly after a query chunk's last position
    changes no bit of the output or of the gradients of q, k and v."""
    from repro_torch.models import layers

    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, h, 8), dtype=np.float32))
               for h in (4, 2, 2))
    up = torch.from_numpy(rng.standard_normal((2, 64, 4, 8), dtype=np.float32))
    got = []
    for fn in (layers.chunked_attention, _chunked_attention_every_chunk):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
        got.append((out.detach(), *torch.autograd.grad(out, leaves, up)))
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b"])
def test_chunked_attention_training_path(arch, monkeypatch):
    """The long-sequence path (above CHUNK_THRESHOLD, as the card's main
    run at S = 4096), with 32-position chunks so that S = 128 spans 4 x 4
    of them (the port skips the 6 wholly after the diagonal); danube's
    reduced window of 64 masks inside the chunks. The fp32 loss within
    1e-5 of the reference's chunked one; the gradients of a float64 model
    (attention still takes its scores in fp32, in both paths) within 1e-4
    of each leaf's largest of the naive path's, which is held to the
    reference above. (In fp32 at this length each package's gradients sit
    up to 1.2e-4 of a leaf's largest from a float64 reference on these
    weights, so fp32 against fp32 does not resolve 1e-4.)"""
    import functools

    from repro.models import layers as jlayers
    from repro_torch.models import layers

    jm, jp, tm, tree = _pair(arch)
    jb, tb = _batch(tm.cfg, 2, 128, seed=9)
    m64 = build(dataclasses.replace(tm.cfg, dtype="float64"))
    p64 = lambda: jax.tree.map(  # noqa: E731
        lambda a: torch.from_numpy(np.asarray(a, np.float64)), tree)
    naive = value_and_grad(lambda p: m64.loss(p, tb), p64())
    for mod in (jlayers, layers):
        monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(mod, "chunked_attention", functools.partial(
            mod.chunked_attention, q_chunk=32, kv_chunk=32))
    calls = []
    real = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jloss = jax.jit(lambda p: jm.loss(p, jb))(jp)
    loss = tm.loss(params_from_numpy(tree, "cpu"), tb)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5, atol=1e-5)
    chunked = value_and_grad(lambda p: m64.loss(p, tb), p64())
    # A layer each: the fp32 forward, the fp64 forward and remat's recompute.
    assert len(calls) == 3 * tm.cfg.n_layers
    np.testing.assert_allclose(_np(chunked[0]), _np(naive[0]), rtol=1e-12)
    for a, b in zip(tree_leaves(chunked[1]), tree_leaves(naive[1])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_remat_recomputes_and_serving_records_nothing():
    """With remat the forward keeps only the blocks' inputs: the same
    gradients, fewer saved tensors; under no_grad (serving) no graph."""
    _, _, tm, tree = _pair("smollm-135m")
    _, tb = _batch(tm.cfg, 2, 16, seed=3)

    def saved_bytes(remat):
        tp = params_from_numpy(tree, "cpu")
        for p in tree_leaves(tp):
            p.requires_grad_(True)
        total = 0

        def pack(t):
            nonlocal total
            total += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tm.loss(tp, tb, remat=remat)
        return total, loss

    full, l1 = saved_bytes(False)
    rem, l2 = saved_bytes(True)
    assert rem < full
    assert float(l1.detach()) == float(l2.detach())
    tp = params_from_numpy(tree, "cpu")
    assert tm.loss(tp, tb).grad_fn is None          # no parameter requires grad


def test_moe_dispatch_passes_gradcheck():
    """The in-place dispatch and combine (index_put_ with accumulate) under
    autograd, in float64: a zero router makes every token's gates 1/K
    exactly, so the check is free of the fp32 router's rounding."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), d_model=8,
                              moe_d_ff=4, shared_d_ff=4, n_experts=4, topk=2)
    gen = torch.Generator().manual_seed(0)
    p = {k: v[0].to(torch.float64) for k, v in
         build(cfg).init(gen, device="cpu")["moe_layers"]["moe"].items()
         if not isinstance(v, dict)}
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn((1, 6, 8), generator=gen, dtype=torch.float64, requires_grad=True)
    ws = [p[k].clone().requires_grad_(True) for k in ("w_gate", "w_up", "w_down")]

    def fn(x, wg, wu, wd):
        q = dict(p, w_gate=wg, w_up=wu, w_down=wd)
        return moe.moe_apply(q, x, dataclasses.replace(cfg, n_shared_experts=0))[0]

    assert torch.autograd.gradcheck(fn, (x, *ws))


# ------------------------------------------------------------ train steps
def _jax_state(jm, jp, compress):
    return jloop.TrainState(jp, jopt.init(jp),
                            jcomp.init_error(jp) if compress else None)


def _port_state(tree, compress):
    params = params_from_numpy(tree, "cpu")
    return TrainState(params, opt_mod.init(params),
                      compression.init_error(params) if compress else None)


def test_train_steps_match_jax():
    """Three steps of make_train_step against jax.jit of the reference's."""
    jm, jp, tm, tree = _pair("smollm-135m")
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    jstep = jax.jit(jloop.make_train_step(jm, jcfg))
    step = make_train_step(tm, cfg)
    jstate, state = _jax_state(jm, jp, False), _port_state(tree, False)
    for i in range(3):
        jb, tb = _batch(tm.cfg, 4, 16, seed=100 + i)
        jstate, jm_ = jstep(jstate, jb)
        state, m = step(state, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm_[k]), **STEP)
        _assert_trees_close(state.params, jstate.params, STEP)
    assert int(state.opt.step) == 3
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}


class _LinearLoss:
    """loss = sum(w * x) + sum(b * y): its gradient is the batch itself,
    bit for bit in both frameworks, so int8 rounding sees equal inputs."""

    def __init__(self, xp):
        self.xp = xp

    def loss(self, params, batch, **_):
        s = self.xp.sum
        return s(params["w"] * batch["x"]) + s(params["n"]["b"] * batch["y"])


def test_compressed_step_composition_matches_jax():
    """compress_grads on equal gradients: three steps of the port's train
    step (error feedback, then AdamW) against jax.jit of the reference's,
    parameters within the optimizer's 1e-6 and error buffers within 1e-7."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    p0 = {"w": _normal(1, (3, 300)), "n": {"b": _normal(2, (70,))}}
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jloop.TrainState(jp, jopt.init(jp), jcomp.init_error(jp))
    params = params_from_numpy(p0, "cpu")
    state = TrainState(params, opt_mod.init(params), compression.init_error(params))
    jstep = jax.jit(jloop.make_train_step(_LinearLoss(jnp), jcfg, compress_grads=True))
    step = make_train_step(_LinearLoss(torch), cfg, compress_grads=True)
    for i in range(3):
        b = {"x": _normal(10 + i, (3, 300), 0.01), "y": _normal(20 + i, (70,), 0.5)}
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm_[k]), rtol=1e-6)
        _assert_trees_close(state.params, jstate.params, dict(rtol=1e-6, atol=1e-7))
        _assert_trees_close(state.error, jstate.error, dict(rtol=0, atol=1e-7))
    assert float(state.error["w"].abs().max()) > 0


def _error_flip_share(error, jerror) -> float:
    """The share of error-buffer entries more than a tenth of an int8 level
    apart. An entry's error lies within half its block's level of 0, so
    twice a block's largest |error| (the reference's) stands for the level."""
    apart = total = 0
    for t, j in zip(tree_leaves(error), jax.tree_util.tree_leaves(jerror)):
        a, b = np.asarray(j).reshape(-1), _np(t).reshape(-1)
        pad = (-a.size) % compression.BLOCK
        a, b = (np.pad(x, (0, pad)).reshape(-1, compression.BLOCK) for x in (a, b))
        level = 2 * np.abs(a).max(axis=1, keepdims=True)
        apart += int((np.abs(b - a) > 0.1 * level).sum())
        total += a.size - pad
    return apart / total


def test_compressed_train_steps_match_jax():
    """Three compress_grads steps of smollm-135m against jax.jit of the
    reference's: losses within 1e-4. The error buffers and parameters are
    held as shares: int8 rounding turns the frameworks' fp32 gradient
    differences (up to 1e-4 of a leaf's largest entry on these weights)
    into one-level flips of q wherever x / scale falls near a half, and
    error feedback carries them on (as this test prints them: 0.06%, 0.64%
    and 2.1% of the error entries more than a tenth of a level apart after
    steps 1-3; 5 parameters of 102720 beyond 1e-4, none beyond 4.8e-4). An
    error feedback that drops, negates or does not keep the error moves
    most entries. The composition on equal gradients is held exactly
    above."""
    jm, jp, tm, tree = _pair("smollm-135m")
    cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    jstep = jax.jit(jloop.make_train_step(jm, jcfg, compress_grads=True))
    step = make_train_step(tm, cfg, compress_grads=True)
    jstate, state = _jax_state(jm, jp, True), _port_state(tree, True)
    for i in range(3):
        jb, tb = _batch(tm.cfg, 4, 16, seed=100 + i)
        jstate, jm_ = jstep(jstate, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(_np(m["loss"]), np.asarray(jm_["loss"]), **STEP)
        share = _error_flip_share(state.error, jstate.error)
        beyond = n = 0
        worst = 0.0
        for t, j in zip(tree_leaves(state.params), jax.tree_util.tree_leaves(jstate.params)):
            d = np.abs(_np(t) - np.asarray(j))
            worst = max(worst, float(d.max()))
            beyond += int((d > STEP["atol"] + STEP["rtol"] * np.abs(np.asarray(j))).sum())
            n += d.size
        print(f"step {i + 1}: error entries a tenth of a level apart {share:.3%}; "
              f"parameters beyond 1e-4: {beyond} of {n}, largest |diff| {worst:.3e}")
        assert share <= 0.05
        assert worst <= 2 * cfg.lr            # an AdamW sign flip moves an entry 2 lr
        assert beyond <= 1e-3 * n
    assert int(state.opt.step) == 3


@pytest.mark.parametrize("arch,seq,batch", [
    ("smollm-135m", 4096, 16), ("smollm-135m", 4096, 256), ("smollm-135m", 512, 8),
    ("qwen2-7b", 4096, 32), ("qwen2-moe-a2.7b", 4096, 64), ("hymba-1.5b", 2048, 12),
    ("rwkv6-3b", 4096, 16), ("deepseek-v2-lite-16b", 1000, 4)])
def test_choose_microbatches_matches_jax(arch, seq, batch):
    shape = ShapeConfig("train", seq, batch, "train")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    assert steps.choose_microbatches(get_config(arch), shape) == \
        jsteps.choose_microbatches(jax_config(arch), shape, mesh)
    with knobs.apply(knobs.Knobs(microbatch=4)):
        assert steps.choose_microbatches(get_config(arch), shape) == 4


def test_smollm_full_width_accumulates_over_eight():
    """The card's main run: smollm-135m, train_4k's sequence, batch 16."""
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=16)
    assert steps.choose_microbatches(get_config("smollm-135m"), shape) == 8


@pytest.fixture
def jax_cell_globals():
    """make_cell sets the reference's activation-sharding globals; reset."""
    yield
    jsharding.set_sequence_sharding(None)
    jsharding.set_layer_barrier(False)
    jsharding.set_moe_groups(1)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_accumulated_step_matches_jax(arch, jax_cell_globals):
    """launch.steps.make_train_step at n_micro=2 against the train step of
    the reference's make_cell (microbatch knob 2) on a one-device mesh:
    two steps' metrics and parameters within 1e-4. For the dense decoder
    n_micro=1 agrees too; no label is masked, since the accumulated loss is
    the mean of the microbatches' means, which weighs tokens equally only
    when each microbatch counts as many (MoE's aux loss is a product of
    per-microbatch means, so it differs by design)."""
    jm, jp, tm, tree = _pair(arch)
    shape = ShapeConfig("train", 32, 4, "train")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jknobs.apply(jknobs.Knobs(microbatch=2)):
        cell = jsteps.make_cell(arch, jm.cfg, shape, mesh)
        jstep = jax.jit(cell.step_fn)
    step = steps.make_train_step(tm, shape, n_micro=2)
    step1 = steps.make_train_step(tm, shape, n_micro=1)
    jstate, state = _jax_state(jm, jp, False), _port_state(tree, False)
    state1 = _port_state(tree, False)
    for i in range(2):
        jb, tb = _batch(tm.cfg, 4, 32, seed=200 + i, masked=False)
        # Called outside the mesh's context: under one, the reference's
        # MoE layer takes its expert-parallel shard_map path. The same
        # cell under a (data=2, model=2) mesh, the port's on a gloo world
        # of 4 processes, is held to it in tests/test_torch_cells.py.
        jstate, jmet = jstep(jstate, jb)
        state, m = step(state, tb)
        state1, m1 = step1(state1, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jmet[k]), **STEP)
            if not tm.cfg.n_experts:
                np.testing.assert_allclose(_np(m1[k]), _np(m[k]), **STEP)
        _assert_trees_close(state.params, jstate.params, STEP)
        assert state.error is None


# ----------------------------------------------------- the loop, end to end
def test_compressed_training_still_converges():
    cfg = get_config("smollm-135m").reduced()
    model = build(cfg)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    state = init_state(model, torch.Generator().manual_seed(0), opt_cfg,
                       device="cpu", compress_grads=True)
    pipe = make_pipeline(cfg, seq_len=32, global_batch=8, device="cpu")
    step_fn = make_train_step(model, opt_cfg, compress_grads=True)
    state, hist = TrainLoop(step_fn, pipe, backpressure=1).run(state, 0, 25, log_every=0)
    assert [h["step"] for h in hist] == list(range(25))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[0]["loss"] == pytest.approx(math.log(cfg.vocab_size), abs=0.5)


def test_loop_keeps_backpressure_steps_in_flight():
    """Metrics are read when a step leaves the queue: with backpressure 2
    the first is read after the third step is dispatched."""
    cfg = get_config("smollm-135m").reduced()
    model = build(cfg)
    opt_cfg = AdamWConfig(total_steps=10)
    state = init_state(model, torch.Generator().manual_seed(0), opt_cfg, device="cpu")
    pipe = make_pipeline(cfg, seq_len=16, global_batch=2, device="cpu")
    dispatched, read = [], []
    real_step = make_train_step(model, opt_cfg)

    def step_fn(st, batch):
        dispatched.append(len(dispatched))
        return real_step(st, batch)

    TrainLoop(step_fn, pipe, backpressure=2).run(
        state, 0, 5, log_every=0, on_step=lambda s, m: read.append((s, len(dispatched))))
    assert read == [(0, 3), (1, 4), (2, 5), (3, 5), (4, 5)]


# ------------------------------------------------------------ kernel guard
def test_kernel_branches_refuse_autograd():
    """The LM kernels have no backward: off the CPU, an input that requires
    grad makes each of their entry points raise before its wrapper (a
    meta tensor reaches the CUDA branch here); under no_grad the wrapper's
    own device check is reached instead. The CPU plain path still
    differentiates."""
    def meta(*shape):
        return torch.empty(shape, device="meta", requires_grad=True)

    q, x, dt = meta(1, 8, 2, 16), meta(1, 8, 4), meta(1, 8, 4)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "mamba_scan": lambda: ops.mamba_scan(x, dt, meta(1, 8, 2), meta(1, 8, 2),
                                             meta(4, 2)),
        "wkv6": lambda: ops.wkv6(q, q, q, q, meta(2, 16)),
    }
    ops.reset_launch_counts()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}
    _, _, tm, tree = _pair("hymba-1.5b")
    _, tb = _batch(tm.cfg, 1, 8, seed=4)
    loss, grads = value_and_grad(lambda p: tm.loss(p, tb, use_kernel=True),
                                 params_from_numpy(tree, "cpu"))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree_leaves(grads))
