"""The port's sharding rules, policy and production meshes against the
JAX package's.

``ShardingRules``' specs (``param_specs``, ``opt_specs``) are pure logic
and are compared in this process for the ten configs x ``tp``/``fsdp`` x
``fsdp_data``. The plan (``make_plan``: params, optimizer moments,
replicated, batch and cache shardings) and the production meshes' device
layout need the reference's meshes of 8, 256 and 512 devices, so they
come from one child process with
``--xla_force_host_platform_device_count=512`` through a JSON file; the
port builds the same plans on meshes of virtual ranks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import build as jax_build
from repro.models import params as jparams
from repro.launch import policy as jpolicy
from repro_torch.configs import get_config
from repro_torch.core import spmd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import policy
from repro_torch.models import build, params

REPO = Path(__file__).resolve().parent.parent
PERM_SEED = 3


def _entries(spec) -> list:
    """A spec of either package as JSON-able entries (tuples as lists)."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------------ rules, specs
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("fsdp_data", [False, True])
def test_param_and_opt_specs_match_jax(arch, mode, fsdp_data):
    tschema, jschema = build(get_config(arch)).schema, jax_build(jax_config(arch)).schema
    trules = params.ShardingRules(mode=mode, fsdp_data=fsdp_data)
    jrules = jparams.ShardingRules(mode=mode, fsdp_data=fsdp_data)
    for fn, jfn in ((params.param_specs, jparams.param_specs),
                    (params.opt_specs, jparams.opt_specs)):
        mine = {k: _entries(v) for k, v in _flat(fn(tschema, trules)).items()}
        want = {k: _entries(v) for k, v in _flat(jax_tree(jfn(jschema, jrules))).items()}
        assert mine == want


def jax_tree(tree):
    """The reference's spec tree as nested dicts (its leaves are P)."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    assert isinstance(tree, JP)
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_choose_mode_matches_jax(arch):
    assert policy.choose_mode(get_config(arch)) == jpolicy.choose_mode(jax_config(arch))
    assert policy.make_rules(get_config(arch)) == params.ShardingRules(
        **{f: getattr(jpolicy.make_rules(jax_config(arch)), f)
           for f in ("mode", "model_axis", "data_axis", "model_size")})


# ------------------------------------------------------- plan and meshes
SNIPPET = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs import ARCH_IDS, get_config
from repro.launch import mesh as mesh_mod, policy
from repro.models import build

def entries(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: entries(tree)}

perm = np.random.default_rng(int(sys.argv[2])).permutation(512)
ids = lambda m: np.vectorize(lambda d: d.id)(m.devices).tolist()
meshes = {
    "small": Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model")),
    "single": mesh_mod.make_production_mesh(),
    "multi": mesh_mod.make_production_mesh(multi_pod=True),
    "single_perm": mesh_mod.make_production_mesh(permutation=perm[perm < 256]),
    "multi_perm": mesh_mod.make_production_mesh(multi_pod=True, permutation=perm),
}
out = {"layout": {k: ids(m) for k, m in meshes.items()}, "plans": {}}
batch = {"inputs": jax.ShapeDtypeStruct((256, 64), np.int32),
         "labels": jax.ShapeDtypeStruct((256, 64), np.int32),
         "one": jax.ShapeDtypeStruct((1, 64), np.int32)}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    model = build(cfg)
    for mname in ("small", "single", "multi"):
        for mode in (None, "tp", "fsdp"):
            plan = policy.make_plan(cfg, meshes[mname], mode)
            out["plans"][f"{arch}|{mname}|{mode}"] = {
                "mode": plan.mode,
                "params": flat(plan.params(model.schema)),
                "opt": flat(plan.opt_moments(model.schema)),
                "replicated": entries(plan.replicated()),
                "batch": flat(plan.batch_like(batch)),
                "cache128": flat(plan.cache(model.cache_spec(128, 32768))),
                "cache1": flat(plan.cache(model.cache_spec(1, 4096))),
            }
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("policy") / "ref.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["PYTHONPATH"] = str(REPO / "src")
    env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run([sys.executable, "-c", SNIPPET, str(path), str(PERM_SEED)],
                          capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(path.read_text())


def _meshes():
    perm = np.random.default_rng(PERM_SEED).permutation(512)
    return {
        "small": spmd.Mesh(np.arange(8).reshape(2, 4), ("data", "model"), "cpu"),
        "single": tmesh.make_production_mesh(device="cpu"),
        "multi": tmesh.make_production_mesh(multi_pod=True, device="cpu"),
        "single_perm": tmesh.make_production_mesh(permutation=perm[perm < 256],
                                                  device="cpu"),
        "multi_perm": tmesh.make_production_mesh(multi_pod=True, permutation=perm,
                                                 device="cpu"),
    }


def test_production_mesh_layout_matches_jax(ref):
    for name, mesh in _meshes().items():
        assert mesh.device_ids.tolist() == ref["layout"][name], name
        assert mesh.device == torch.device("cpu")
    single = tmesh.make_production_mesh(device="cpu")
    assert single.axis_names == ("data", "model") and single.shape == (16, 16)
    multi = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert multi.axis_names == ("pod", "data", "model") and multi.shape == (2, 16, 16)
    assert tmesh.make_production_mesh(device="meta").device == torch.device("meta")
    with pytest.raises(RuntimeError):
        tmesh.make_production_mesh(devices=range(100), device="cpu")


def test_mesh_defaults_to_the_card():
    """A mesh lives on the card unless the caller names a device (building
    one allocates nothing, so this runs without a card too)."""
    assert tmesh.make_production_mesh().device == torch.device("cuda")
    assert tmesh.small_mesh().device == torch.device("cuda")
    assert tmesh.small_mesh(shape=(2, 4), device="cpu").shape == (2, 4)


def test_mapper_permutation_matches_jax():
    from repro.core import GPU as JGPU
    from repro.core import Machine as JMachine
    from repro.core import cyclic_mapper as jcyclic
    from repro.launch import mesh as jmesh
    from repro_torch.core import GPU, Machine, cyclic_mapper

    mine = tmesh.mapper_permutation(cyclic_mapper(Machine(GPU, shape=(4, 4))), (4, 4))
    want = jmesh.mapper_permutation(jcyclic(JMachine(JGPU, shape=(4, 4))), (4, 4))
    np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_plan_matches_jax(ref, arch):
    """Every spec the plan gives, on the (2, 4) mesh and the two production
    meshes, for the chosen mode and both forced modes."""
    model = build(get_config(arch))
    meshes = _meshes()
    batch = {"inputs": torch.empty(256, 64, device="meta"),
             "labels": torch.empty(256, 64, device="meta"),
             "one": torch.empty(1, 64, device="meta")}
    for mname in ("small", "single", "multi"):
        for mode in (None, "tp", "fsdp"):
            plan = policy.make_plan(model.cfg, meshes[mname], mode)
            flat = lambda tree: {k: _entries(v.spec) for k, v in _flat(tree).items()}
            mine = {
                "mode": plan.mode,
                "params": flat(plan.params(model.schema)),
                "opt": flat(plan.opt_moments(model.schema)),
                "replicated": _entries(plan.replicated().spec),
                "batch": flat(plan.batch_like(batch)),
                "cache128": flat(plan.cache(model.cache_spec(128, 32768))),
                "cache1": flat(plan.cache(model.cache_spec(1, 4096))),
            }
            assert mine == ref["plans"][f"{arch}|{mname}|{mode}"], (mname, mode)


def test_named_sharding_applies_and_checks_divisibility():
    mesh = spmd.Mesh(np.arange(8).reshape(2, 4), ("data", "model"), "cpu")
    plan = policy.make_plan(get_config("smollm-135m"), mesh)
    s = plan.batch_like({"x": torch.empty(4, 6)})["x"]
    assert s.spec == spmd.P(("data",))
    blocks = s.apply(torch.arange(24.0).reshape(4, 6))
    assert tuple(blocks.shape) == (2, 4, 2, 6)
    with pytest.raises(ValueError):
        policy.shard(mesh, spmd.P(None, "model")).apply(torch.zeros(2, 6))
