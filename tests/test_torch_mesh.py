"""The port's mesh layer on virtual ranks against the JAX package on 8 fake
devices: the new collectives, ``sp_attention``, ``sp_decode_attention``
and ``_moe_shard_map``.

The JAX side runs once, in a child process with
``--xla_force_host_platform_device_count=8`` (the main process keeps one
device), under a ``(data=2, model=4)`` mesh; it draws the weights and
inputs from seeds and hands them back with its outputs through an
``.npz`` file, and the port runs on the same ones on a ``(2, 4)`` mesh
of virtual ranks on the CPU. Every test also asserts that the path it
names ran (``spmd.counts()``): parity on a path that fell back to the
no-mesh code would prove nothing. fp32 throughout; tolerances 1e-4
(hidden states: 1e-4 of the largest |entry|).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import spmd
from repro_torch.core.spmd import P
from repro_torch.models import build, moe, params_from_numpy
from repro_torch.models import sharding as shd

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)

SNIPPET = r'''
import sys, time, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core.jaxcompat import shard_map
from repro.configs import get_config
from repro.models import build, layers, moe as moe_mod, sharding as shd

out = {}
t0 = time.time()
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
rng = np.random.default_rng(0)

# ---- collectives
x = rng.normal(size=(8, 4, 12)).astype(np.float32)
out["coll/x"] = x
def coll_body(xl):
    a2a = jax.lax.all_to_all(xl.reshape(4, 1, 1, 12), "model", 0, 0, tiled=False)
    a2a_b = jax.lax.all_to_all(xl.reshape(1, 4, 12)[:, :, :8].reshape(1, 4, 8), "model", 1, 2, tiled=False)
    mx = jax.lax.pmax(xl, "model")
    ps = jax.lax.psum(xl, ("data", "model"))
    return a2a.reshape(4, 12), a2a_b, mx, ps
f = shard_map(coll_body, mesh=mesh, in_specs=(P(("data", "model")),),
              out_specs=(P(("data", "model")), P(("data", "model")), P(("data", "model")), P(("data", "model"))), check_vma=False)
r = jax.jit(f)(x)
for k, v in zip(("a2a", "a2a_b", "pmax", "psum"), r):
    out["coll/" + k] = np.asarray(v)
print("collectives", time.time() - t0, flush=True)

# ---- sp_attention
calls = {"sp": 0, "spd": 0}
real_sp, real_spd = layers.sp_attention, layers.sp_decode_attention
def sp(*a, **k):
    calls["sp"] += 1
    return real_sp(*a, **k)
def spd(*a, **k):
    calls["spd"] += 1
    return real_spd(*a, **k)
layers.sp_attention, layers.sp_decode_attention = sp, spd
for arch in ("smollm-135m", "h2o-danube-1.8b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build(cfg)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 512)), jnp.int32)
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[f"{arch}/p/" + "/".join(p.key for p in k)] = np.asarray(v)
    out[f"{arch}/toks"] = np.asarray(toks)
    shd.set_sequence_sharding("model")
    calls["sp"] = 0
    with mesh:
        h, _ = jax.jit(lambda p, t: model.hidden_states(p, t, remat=False))(params, toks)
        ll = jax.jit(lambda p, t: model.last_logits(p, t, remat=False))(params, toks)
    shd.set_sequence_sharding(None)
    out[f"{arch}/hidden"] = np.asarray(h)
    out[f"{arch}/last"] = np.asarray(ll)
    out[f"{arch}/sp_calls"] = np.asarray(calls["sp"])
    print(arch, calls, time.time() - t0, flush=True)

# ---- sp_decode_attention (smollm: kv heads 1)
arch = "smollm-135m"
cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
model = build(cfg)
params = model.init(jax.random.key(0))
dtoks = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(2, 16)), jnp.int32)
out["decode/toks"] = np.asarray(dtoks)
cache = model.init_cache(2, 32)
step = jax.jit(model.decode_step)
logits = []
with mesh:
    for t in range(16):
        lg, cache = step(params, cache, jnp.int32(t), dtoks[:, t:t + 1])
        logits.append(np.asarray(lg))
out["decode/logits"] = np.stack(logits)
out["decode/spd_calls"] = np.asarray(calls["spd"])
print("decode", calls, time.time() - t0, flush=True)

# ---- _moe_shard_map
moe_mod.CAPACITY_FACTOR = 16.0
cfg = get_config("qwen2-moe-a2.7b").reduced()
model = build(cfg)
params = model.init(jax.random.key(0))
layer0 = jax.tree.map(lambda p: p[0], params["moe_layers"])["moe"]
for k, v in jax.tree_util.tree_flatten_with_path(layer0)[0]:
    out["moe/p/" + "/".join(p.key for p in k)] = np.asarray(v)
xm = jax.random.normal(jax.random.key(1), (2, 16, cfg.d_model), jnp.float32)
out["moe/x"] = np.asarray(xm)
ref, aux_ref = moe_mod._moe_dense(layer0, xm, cfg)
chosen = {}
real_top_k = jax.lax.top_k
def rec(idx, d, m):
    chosen[(int(d), int(m))] = np.asarray(idx)
def top_k(operand, k):
    vals, idx = real_top_k(operand, k)
    jax.debug.callback(rec, idx, jax.lax.axis_index("data"), jax.lax.axis_index("model"))
    return vals, idx
jax.lax.top_k = top_k
shd.set_sequence_sharding("model")
with mesh:
    o, aux = jax.jit(lambda p, x: moe_mod.moe_apply(p, x, cfg))(layer0, xm)
    jax.block_until_ready(o)
shd.set_sequence_sharding(None)
jax.lax.top_k = real_top_k
out["moe/ep_idx"] = np.stack([chosen[(d, m)] for d in range(2) for m in range(4)])
out["moe/ep_out"], out["moe/ep_aux"] = np.asarray(o), np.asarray(aux)
out["moe/dense_out"], out["moe/dense_aux"] = np.asarray(ref), np.asarray(aux_ref)
print("moe", float(jnp.abs(o - ref).max()), float(aux), float(aux_ref), time.time() - t0, flush=True)
np.savez(sys.argv[1], **out)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's outputs (and the shared weights and inputs)."""
    path = tmp_path_factory.mktemp("mesh") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-c", SNIPPET, str(path)],
                          capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _mesh():
    return spmd.Mesh(np.arange(8).reshape(2, 4), ("data", "model"), "cpu")


def _tree(ref, prefix):
    """The nested parameter dict saved under ``prefix`` (keys joined by /)."""
    tree = {}
    for k, v in ref.items():
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return params_from_numpy(tree, "cpu")


@contextlib.contextmanager
def _sequence_sharded(mesh):
    shd.set_sequence_sharding("model")
    spmd.reset_counts()
    try:
        with spmd.use_mesh(mesh):
            yield
    finally:
        shd.set_sequence_sharding(None)


def _close(out, expect, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), expect, **tol)


def _close_scaled(out, expect):
    """Within 1e-4 of the largest |entry| (at least 1e-4): the final norm
    puts entries of 4 beside near-zero ones, and fp32 noise of 2e-4 at
    the large ones separates the two frameworks with no mesh as well."""
    _close(out, expect, dict(rtol=TOL["rtol"], atol=TOL["atol"] * max(
        1.0, float(np.abs(expect).max()))))


# ------------------------------------------------------------- collectives
def test_new_collectives_match_jax(ref):
    """all_to_all (tiled=False, two split/concat pairs), pmax, psum over a
    tuple of axes, and a spec entry over two axes, P(("data", "model"))."""
    mesh = _mesh()

    def body(xl):
        a2a = spmd.all_to_all(xl.reshape(*xl.shape[:-3], 4, 1, 1, 12), "model", 0, 0)
        part = xl.reshape(*xl.shape[:-3], 1, 4, 12)[..., :8]
        a2a_b = spmd.all_to_all(part, "model", 1, 2)
        return (a2a.reshape(*a2a.shape[:-4], 4, 12), a2a_b, spmd.pmax(xl, "model"),
                spmd.psum(xl, ("data", "model")))

    spec = P(("data", "model"))
    spmd.reset_counts()
    got = spmd.shard_map(body, mesh, (spec,), (spec,) * 4)(torch.from_numpy(ref["coll/x"]))
    assert spmd.counts() == {"shard_map": 1, "all_to_all": 2, "pmax": 1, "psum": 1}
    for name, g in zip(("a2a", "a2a_b", "pmax", "psum"), got):
        assert tuple(g.shape) == ref["coll/" + name].shape, name
        _close(g, ref["coll/" + name], dict(rtol=1e-6, atol=1e-6))


def test_two_axis_spec_splits_major_to_minor():
    mesh = _mesh()
    x = torch.arange(8 * 3).reshape(8, 3)
    y = spmd.split(x, P(("data", "model")), mesh)
    for d in range(2):
        for m in range(4):
            assert torch.equal(y[d, m], x[d * 4 + m:d * 4 + m + 1])
    z = spmd.split(x, P(("model", "data")), mesh)
    assert torch.equal(z[1, 2], x[2 * 2 + 1:2 * 2 + 2])
    assert torch.equal(spmd.assemble(y, P(("data", "model")), mesh), x)
    assert torch.equal(spmd.assemble(z, P(("model", "data")), mesh), x)
    with pytest.raises(ValueError):
        spmd.split(x, P(("data", "data")), mesh)


def test_mesh_scope_is_apart_from_the_body_context():
    mesh = _mesh()
    assert spmd.current_mesh() is None
    with spmd.use_mesh(mesh):
        assert spmd.current_mesh() is mesh
        with spmd.use_mesh(None):
            assert spmd.current_mesh() is None
    assert spmd.current_mesh() is None
    with pytest.raises(RuntimeError):
        spmd.pmax(torch.zeros(2, 4, 1), "model")    # no body running


# ------------------------------------------------------------ sp_attention
@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-1.8b"])
def test_sp_attention_matches_jax(ref, arch):
    """Every position's hidden states and the last logits, B=2, S=512,
    sequence sharding on (danube: a sliding window)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build(cfg)
    params = _tree(ref, f"{arch}/p/")
    toks = torch.from_numpy(ref[f"{arch}/toks"]).long()
    assert int(ref[f"{arch}/sp_calls"]) >= 1             # the reference's path ran
    with torch.no_grad(), _sequence_sharded(_mesh()):
        h, _ = model.hidden_states(params, toks, remat=False)
        assert spmd.counts()["sp_attention"] == cfg.n_layers
        last = model.last_logits(params, toks, remat=False)
        assert spmd.counts()["sp_attention"] == 2 * cfg.n_layers
    _close_scaled(h, ref[f"{arch}/hidden"])
    _close(last, ref[f"{arch}/last"])


def test_sp_attention_needs_sequence_sharding_and_the_knob(ref):
    from repro_torch.launch import knobs

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype="float32")
    model = build(cfg)
    params = _tree(ref, "smollm-135m/p/")
    toks = torch.from_numpy(ref["smollm-135m/toks"]).long()
    with torch.no_grad(), spmd.use_mesh(_mesh()):
        spmd.reset_counts()
        model.last_logits(params, toks, remat=False)      # no sequence sharding
        with knobs.apply(knobs.Knobs(sp_attention=False)), _sequence_sharded(_mesh()):
            model.last_logits(params, toks, remat=False)
        assert "sp_attention" not in spmd.counts()


# ----------------------------------------------------- sp_decode_attention
def test_sp_decode_attention_matches_jax(ref):
    """16 decode steps of reduced smollm-135m (kv heads 1, so 1 % 4 != 0:
    the cache shards on its sequence dim) under the mesh."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype="float32")
    assert cfg.n_kv_heads % 4 != 0
    model = build(cfg)
    params = _tree(ref, "smollm-135m/p/")
    toks = torch.from_numpy(ref["decode/toks"]).long()
    assert int(ref["decode/spd_calls"]) >= 1
    cache = model.init_cache(2, 32, device="cpu")
    spmd.reset_counts()
    with spmd.use_mesh(_mesh()):
        for t in range(16):
            logits, cache = model.decode_step(params, cache, t, toks[:, t:t + 1])
            _close(logits, ref["decode/logits"][t])
    assert spmd.counts()["sp_decode_attention"] == 16 * cfg.n_layers


# ---------------------------------------------------------- _moe_shard_map
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


def test_moe_shard_map_matches_jax(ref, monkeypatch):
    """qwen2-moe-a2.7b reduced, CAPACITY_FACTOR 16 (no drops), B=2, S=16
    under (2, 4): each rank's chosen experts equal the reference's rank's
    (read in its body), ``keep`` equal to the plain rule, then out and aux
    against the reference's expert-parallel and dense outputs."""
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 16.0)
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = _tree(ref, "moe/p/")
    x = torch.from_numpy(ref["moe/x"])
    routed, real_route = [], moe.route

    def recording(p, xg, c):
        r = real_route(p, xg, c)
        routed.append(r[3])
        return r

    monkeypatch.setattr(moe, "route", recording)
    with torch.no_grad(), _sequence_sharded(_mesh()):
        out, aux = moe.moe_apply(params, x, cfg)
        assert spmd.counts()["moe_shard_map"] == 1
    monkeypatch.setattr(moe, "route", real_route)
    (idx,) = routed                                       # (8 ranks, Nl, K)
    np.testing.assert_array_equal(idx.numpy(), ref["moe/ep_idx"])
    Nl = idx.shape[1]
    C = moe.capacity(Nl, cfg.n_experts, cfg.topk)
    _, keep = moe.dispatch_slots(idx, cfg.padded_experts, C)
    np.testing.assert_array_equal(keep.numpy(), _plain_keep(ref["moe/ep_idx"], C))
    assert bool(keep.all())                               # no drops at factor 16
    _close(out, ref["moe/ep_out"])
    _close(out, ref["moe/dense_out"])
    _close(aux, ref["moe/ep_aux"])
    _close(aux, ref["moe/dense_aux"])
    dense, dense_aux = moe._moe_dense(params, x, cfg)
    _close(out, dense.numpy())
    _close(aux, dense_aux.numpy())
