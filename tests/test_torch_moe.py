"""The port's MoE layer on the CPU against the JAX package's.

Reduced fp32 configs, the JAX parameters carried across by
``params_from_numpy`` and the inputs drawn from seeded numpy. Routing is
discontinuous (a near-tie in the top-k flips a token's experts), so the
chosen experts and the ``keep`` mask are compared exactly first, then
out and aux within 1e-4 (fp32; the two frameworks sum in other orders).
The reference's chosen experts are read from its ``jax.lax.top_k`` call;
its ``keep`` is rebuilt here by a plain loop over the tokens in order.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build as jax_build
from repro.models import moe as jmoe
from repro.models import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.models import build, moe, params_from_numpy, sharding

FWD = dict(rtol=1e-4, atol=1e-4)
MOE_ARCHS = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"]


def _close(out, expect, tol=FWD):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expect, np.float32),
                               **tol)


# ----------------------------------------------------------------- capacity
def test_constants_are_the_jax_packages():
    assert moe.CAPACITY_FACTOR == jmoe.CAPACITY_FACTOR
    assert moe.EXACT_DISPATCH_MAX_TOKENS == jmoe.EXACT_DISPATCH_MAX_TOKENS


@pytest.mark.parametrize("tokens", [1, 3, 64, 511, 512, 513, 768, 8192, 1 << 20])
def test_capacity_matches_jax(tokens):
    for experts in (4, 8, 60, 64):
        for topk in (1, 2, 4, 6):
            assert moe.capacity(tokens, experts, topk) == jmoe.capacity(
                tokens, experts, topk)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("scale", ["full", "reduced"])
def test_moe_schema_matches_jax(arch, scale):
    tcfg, jcfg = get_config(arch), jax_config(arch)
    if scale == "reduced":
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()

    def leaves(schema):
        return {k: leaves(v) if isinstance(v, dict) else (v.shape, v.axes)
                for k, v in schema.items()}

    assert leaves(moe.moe_schema(tcfg)) == leaves(jmoe.moe_schema(jcfg))
    assert tcfg.padded_experts > tcfg.n_experts or scale == "full"


def test_dispatch_capacity_is_exact_up_to_the_bound():
    cfg = get_config("qwen2-moe-a2.7b")
    assert moe.dispatch_capacity(1, cfg) == 1
    assert moe.dispatch_capacity(512, cfg) == 512
    assert moe.dispatch_capacity(513, cfg) == moe.capacity(513, 60, 4)
    assert moe.dispatch_capacity(8192, cfg) == 684
    assert moe.dispatch_capacity(8192, get_config("deepseek-v2-lite-16b")) == 960


# --------------------------------------------------------------- moe_apply
_LAYERS = {}


def _moe_layer(arch):
    """Layer 0 of the reduced fp32 config's MoE stack: (JAX config, JAX
    params, port config, port params), on the same weights."""
    if arch not in _LAYERS:
        jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        tree = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.key(0)))
        layer0 = jax.tree.map(lambda v: v[0], tree["moe_layers"]["moe"])
        _LAYERS[arch] = (jcfg, jax.tree.map(jnp.asarray, layer0), tcfg,
                         params_from_numpy(layer0, "cpu"))
    return _LAYERS[arch]


def _moe_inputs(B, S, D, seed):
    """Tokens around a shared offset, so that the router favours some
    experts and a fixed capacity drops tokens; each token scaled to unit
    RMS, as the block's ``ffn_norm`` hands them to the layer."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)) + 2.0 * rng.normal(size=(1, 1, D))
    return (x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))).astype(np.float32)


def _plain_keep(expert_idx: np.ndarray, C: int) -> np.ndarray:
    """keep (G, Ng*K): a (token, choice) fits when fewer than C earlier
    ones in its group went to its expert, tokens and choices in order."""
    G = expert_idx.shape[0]
    flat = expert_idx.reshape(G, -1)
    keep = np.zeros(flat.shape, bool)
    for g in range(G):
        seen = {}
        for i, e in enumerate(flat[g]):
            keep[g, i] = seen.get(int(e), 0) < C
            seen[int(e)] = seen.get(int(e), 0) + 1
    return keep


@pytest.fixture
def moe_groups():
    """Set the dispatch groups of both packages; restored afterwards."""
    def set_both(g):
        sharding.set_moe_groups(g)
        jsharding.set_moe_groups(g)

    yield set_both
    set_both(1)


# (B, S, groups): exact capacity (N <= 512), fixed capacity with drops
# (N = 768), and two groups of 768 with drops in each.
REGIMES = {"exact": (2, 32, 1), "dropping": (2, 384, 1), "two_groups": (4, 384, 2)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("regime", list(REGIMES))
def test_moe_apply_matches_jax(arch, regime, moe_groups, monkeypatch):
    B, S, G = REGIMES[regime]
    moe_groups(G)
    jcfg, jp, tcfg, tp = _moe_layer(arch)
    x = _moe_inputs(B, S, tcfg.d_model, seed=len(regime))

    chosen = []
    real_top_k = jax.lax.top_k

    def recording_top_k(operand, k):
        vals, idx = real_top_k(operand, k)
        chosen.append(np.asarray(idx))
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    monkeypatch.undo()
    (j_idx,) = chosen

    tx = torch.from_numpy(x)
    Ng = B * S // G
    _, probs, _, t_idx = moe.route(tp, tx.reshape(G, Ng, -1), tcfg)
    C = moe.dispatch_capacity(Ng, tcfg)
    assert C == (Ng if Ng <= 512 else jmoe.capacity(Ng, jcfg.n_experts, jcfg.topk))
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    assert int(t_idx.max()) < tcfg.n_experts          # never a padded expert
    assert float(probs[..., tcfg.n_experts:].abs().max()) == 0.0
    _, keep = moe.dispatch_slots(t_idx, tcfg.padded_experts, C)
    np.testing.assert_array_equal(keep.numpy(), _plain_keep(j_idx, C))
    dropped = int((~keep).sum())
    assert (dropped > 0) == (regime != "exact"), dropped

    out, aux = moe.moe_apply(tp, tx, tcfg)
    assert out.shape == tx.shape
    # Stacked weights take their fan-in from the layer axis (one MoE layer
    # in the reduced deepseek: std 1), so the outputs reach the hundreds;
    # their atol is FWD's relative to the largest, as for RWKV-6's state
    # in tests/test_torch_models.py.
    jout = np.asarray(jout)
    _close(out, jout, dict(rtol=FWD["rtol"], atol=FWD["atol"] * max(
        1.0, float(np.abs(jout).max()))))
    _close(aux, jaux)


def test_moe_groups_fall_back_to_one_when_they_do_not_divide(moe_groups):
    """Three groups of 2 x 32 tokens do not divide: one group, as the
    reference, so the output is the one-group output."""
    _, _, tcfg, tp = _moe_layer("qwen2-moe-a2.7b")
    x = torch.from_numpy(_moe_inputs(2, 32, tcfg.d_model, seed=7))
    one, aux1 = moe.moe_apply(tp, x, tcfg)
    moe_groups(3)
    three, aux3 = moe.moe_apply(tp, x, tcfg)
    torch.testing.assert_close(three, one, rtol=0, atol=0)
    torch.testing.assert_close(aux3, aux1, rtol=0, atol=0)


def test_gates_conserve_mass_and_dropped_tokens_get_only_the_shared_expert():
    """Every kept token's renormalised gates sum to 1; a token all of whose
    choices are dropped gets the shared expert's output alone."""
    from repro_torch.models import layers

    _, _, tcfg, tp = _moe_layer("qwen2-moe-a2.7b")
    x = torch.from_numpy(_moe_inputs(2, 384, tcfg.d_model, seed=1))
    xg = x.reshape(1, -1, tcfg.d_model)
    _, _, gates, idx = moe.route(tp, xg, tcfg)
    torch.testing.assert_close(gates.sum(-1), torch.ones(gates.shape[:2]))
    C = moe.dispatch_capacity(xg.shape[1], tcfg)
    _, keep = moe.dispatch_slots(idx, tcfg.padded_experts, C)
    all_dropped = ~keep.reshape(-1, tcfg.topk).any(-1)
    assert int(all_dropped.sum()) > 0
    out, _ = moe.moe_apply(tp, x, tcfg)
    shared = layers.swiglu(tp["shared"], x).reshape(-1, tcfg.d_model)
    torch.testing.assert_close(out.reshape(-1, tcfg.d_model)[all_dropped],
                               shared[all_dropped], rtol=0, atol=0)


@pytest.mark.parametrize("arch,n_params", [("deepseek-v2-lite-16b", 15_706_484_224),
                                           ("qwen2-moe-a2.7b", 15_146_928_128)])
def test_full_width_is_the_published_size(arch, n_params):
    tm = build(get_config(arch))
    assert tm.n_params == n_params == jax_build(jax_config(arch)).n_params
    cfg = tm.cfg
    n_moe = cfg.n_layers - cfg.first_dense_layers
    expert = 3 * cfg.d_model * cfg.moe_d_ff
    assert math.prod(tm.schema["moe_layers"]["moe"]["w_gate"].shape) * 3 == (
        n_moe * cfg.padded_experts * expert)
    assert ("dense_layers" in tm.schema) == (cfg.first_dense_layers > 0)
