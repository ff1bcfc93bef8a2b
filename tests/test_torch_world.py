"""The process-group backend of ``core/spmd.py`` against its virtual ranks.

A gloo world of 4 CPU processes (one rank each, spawned once, 120 s
limit) runs every collective of ``spmd``, ``sp_attention``,
``sp_decode_attention``, ``_moe_shard_map`` and the pipeline's forward
on DTensors over a ``(data=2, model=2)`` and a ``(pod=2, data=2)`` mesh
laid out in a Mapple mapper's device order, and the same on the virtual
ranks of one tensor in each process; the same seeded numpy inputs go
into both. Each rank reports the largest difference of each output
(gathered with ``full_tensor``) over the output's largest |entry|, and
that the path ran (``spmd.counts()``); the tests hold each within 1e-5
(fp32). Also: a fake group of 256 ranks gives each spec's local shape
on the meta device, the refused world kinds, and bit-identical model
outputs on plain tensors with and without the constraint call sites.
"""
import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import spmd, world  # noqa: E402
from repro_torch.core.spmd import P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.matmul.common import MatmulGrid  # noqa: E402
from repro_torch.launch import policy  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402

REL_TOL = 1e-5
N_RANKS = 4


def _mapple_ids(shape):
    """A cyclic Mapple mapper's device order for a 2x2 grid of tiles."""
    from repro_torch.core import GPU, Machine, cyclic_mapper

    perm = tmesh.mapper_permutation(cyclic_mapper(Machine(GPU, shape=(2, 2))), (2, 2))
    return np.asarray(perm).reshape(shape)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# --------------------------------------------------------------- the worker
def _cases(mesh_v, mesh_pg):
    """(name, fn(mesh) -> output tensor or tuple of them) for one mesh pair;
    each fn runs the same seeded numbers on either backend."""
    names = mesh_v.axis_names
    a0, a1 = names
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    spec = P(a0, a1, None)

    def coll(body, out_spec=spec, grad=False):
        def run(mesh):
            xs = x.clone().requires_grad_(grad)
            y = spmd.shard_map(body, mesh, (spec,), out_spec)(xs)
            if not grad:
                return (y,)
            w = torch.from_numpy(np.random.default_rng(1).normal(
                size=tuple(y.shape)).astype(np.float32))
            (g,) = torch.autograd.grad((_full(y) * w).sum(), xs)
            return y, g
        return run

    cases = [
        ("all_gather", coll(lambda b: spmd.all_gather(b, a1, dim=1),
                            P(a0, None, None), grad=True)),
        ("all_gather_last", coll(lambda b: spmd.all_gather(b, a0, dim=-1),
                                 P(None, a1, a0), grad=True)),
        ("psum", coll(lambda b: spmd.psum(b, a1), grad=True)),
        ("psum_both", coll(lambda b: spmd.psum(b, (a0, a1)), grad=True)),
        ("pmax", coll(lambda b: spmd.pmax(b, (a0, a1)))),
        ("psum_scatter", coll(lambda b: spmd.psum_scatter(b, a1, 2),
                              P(a0, None, a1), grad=True)),
        ("all_to_all", coll(lambda b: spmd.all_to_all(
            b.reshape(b.shape[:-3] + (3, 2, 8)).transpose(-3, -2), a1, -3, -1),
            P(a0, None, a1), grad=True)),
        ("ppermute", coll(lambda b: spmd.ppermute(b, a0, [(0, 1), (1, 0)]), grad=True)),
        ("ppermute_partial", coll(lambda b: spmd.ppermute(b, a1, [(0, 1)]), grad=True)),
        ("axis_index_where", coll(lambda b: spmd.where(
            spmd.axis_index(a1) == 1, b, 2 * b))),
    ]
    if "model" in names:
        cases += _model_cases()
    else:
        cases += [("pipeline", _pipeline_case())]
    return cases


def _attention_inputs():
    rng = np.random.default_rng(2)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return t(2, 256, 4, 16), t(2, 256, 2, 16), t(2, 256, 2, 16)


def _model_cases():
    from repro_torch.models import layers, moe
    from repro_torch.models.params import layer

    def sp_attention(mesh):
        q, k, v = _attention_inputs()
        with spmd.use_mesh(mesh):
            return (layers.sp_attention(q, k, v, window=96),)

    def sp_decode(mesh):
        rng = np.random.default_rng(3)
        t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
        q, kc, vc = t(2, 1, 4, 16), t(2, 64, 1, 16), t(2, 64, 1, 16)
        with spmd.use_mesh(mesh):
            return (layers.sp_decode_attention(q, kc, vc, 40),
                    layers.sp_decode_attention(q, kc, vc, 70, window=64))

    def moe_case(mesh):
        cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), dtype="float32")
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        p = layer(params["moe_layers"], 0)["moe"]
        x = torch.from_numpy(np.random.default_rng(4).normal(
            size=(2, 32, cfg.d_model)).astype(np.float32))
        routed = []
        real_route = moe.route

        def route(prm, xg, c):
            out = real_route(prm, xg, c)
            routed.append(out[3])
            return out

        saved = moe.CAPACITY_FACTOR
        moe.CAPACITY_FACTOR, moe.route = 16.0, route
        try:
            out, aux = moe._moe_shard_map(p, x, cfg, mesh, ("data",), 2, 2)
        finally:
            moe.CAPACITY_FACTOR, moe.route = saved, real_route
        return out, aux, routed[0]

    return [("sp_attention", sp_attention), ("sp_decode_attention", sp_decode),
            ("moe_shard_map", moe_case)]


def _pipeline_case():
    from repro_torch.training.pipeline import pipelined_apply, split_stages

    def layer(p, h):
        return h + torch.tanh(h @ p["w"])

    def run(mesh):
        rng = np.random.default_rng(5)
        W = torch.from_numpy(rng.normal(scale=0.3, size=(4, 8, 8)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(3, 2, 8)).astype(np.float32))
        y = pipelined_apply(layer, mesh, n_microbatches=3)(split_stages({"w": W}, 2), x)
        return (y,)

    return run


def _worker(rank: int, port: int, out_dir: str) -> None:
    from torch.distributed.tensor.experimental import implicit_replication

    torch.set_num_threads(1)
    report = {}
    with world.world("gloo", N_RANKS, rank=rank, address=f"tcp://127.0.0.1:{port}"):
        for shape, names in (((2, 2), ("data", "model")), ((2, 2), ("pod", "data"))):
            mesh_v = spmd.Mesh(_mapple_ids(shape), names, "cpu")
            mesh_pg = world.on_world(mesh_v, "cpu")
            for name, fn in _cases(mesh_v, mesh_pg):
                key = f"{'x'.join(names)}/{name}"
                want = fn(mesh_v)
                spmd.reset_counts()
                with implicit_replication():      # a plain input is the same everywhere
                    got = fn(mesh_pg)
                ran = spmd.counts()
                if name == "moe_shard_map":
                    # routing first: this rank's group is row-major group `rank`
                    report[key + "/routing_equal"] = bool(torch.equal(
                        got[2][0], want[2][rank]))
                    got, want = got[:2], want[:2]
                report[key] = max(_rel(_full(g), _full(w)) for g, w in zip(got, want))
                report[key + "/ran"] = ran
                report[key + "/local"] = [list(getattr(g, "_local_tensor", g).shape)
                                          for g in got]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))


def _spawn(port: int, out_dir: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(port, out_dir), nprocs=N_RANKS, join=True)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, __file__, str(port), str(out)],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(N_RANKS)]


COLLECTIVES = ["all_gather", "all_gather_last", "psum", "psum_both", "pmax",
               "psum_scatter", "all_to_all", "ppermute", "ppermute_partial",
               "axis_index_where"]


@pytest.mark.parametrize("mesh", ["dataxmodel", "podxdata"])
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_virtual_ranks(gloo, mesh, name):
    """Values (and, where the collective has one, the input gradient of
    a weighted sum) on every rank, within 1e-5 of the largest |entry|."""
    key = f"{mesh}/{name}"
    for rank, report in enumerate(gloo):
        assert report[key] <= REL_TOL, (rank, key, report[key])
        op = {"axis_index_where": "shard_map"}.get(name, name.split("_partial")[0]
                                                   .split("_last")[0].split("_both")[0])
        assert report[key + "/ran"].get(op, 0) >= 1, (key, report[key + "/ran"])


@pytest.mark.parametrize("name", ["sp_attention", "sp_decode_attention", "moe_shard_map"])
def test_mesh_path_matches_virtual_ranks(gloo, name):
    key = f"dataxmodel/{name}"
    for rank, report in enumerate(gloo):
        assert report[key] <= REL_TOL, (rank, key, report[key])
        assert report[key + "/ran"].get(name, 0) >= 1, (key, report[key + "/ran"])
        if name == "moe_shard_map":
            assert report[key + "/routing_equal"], rank
            assert report[key + "/ran"]["all_to_all"] == 2


def test_sp_attention_runs_on_local_blocks(gloo):
    """Each rank's q block is its quarter: (B/2, S/2, H, hd)."""
    for report in gloo:
        assert report["dataxmodel/sp_attention/local"] == [[1, 128, 4, 16]]


def test_pipeline_forward_matches_virtual_ranks(gloo):
    for rank, report in enumerate(gloo):
        assert report["podxdata/pipeline"] <= REL_TOL, (rank, report["podxdata/pipeline"])
        assert report["podxdata/pipeline/ran"]["ppermute"] == 3 + 2 - 1


# ------------------------------------------------------------- fake group
SPECS = [P(("data", "model")), P("data", None), P(None, "model"), P(),
         P(("pod", "data"), "model")]


@pytest.mark.parametrize("multi", [False, True])
def test_fake_group_meta_round_trip_gives_each_specs_local_shape(multi):
    base = tmesh.make_production_mesh(multi_pod=multi, device="meta")
    with world.world("fake", int(base.device_ids.size), rank=world.ORIGIN_RANK):
        mesh = world.on_world(base, "meta", device_type="cuda")
        assert list(mesh.dist.get_coordinate()) == [0] * mesh.ndim
        for spec in SPECS:
            sh = policy.shard(mesh, spec)
            x = torch.empty(512, 96, device="meta")
            d = sh.distribute(x)
            want = list(x.shape)
            for dim, e in enumerate(tuple(sh.spec) + (None,) * 2):
                for a in spmd._names(e):
                    want[dim] //= mesh.axis_size(a)
            assert list(d.to_local().shape) == want, (spec, d.placements)
            assert d.to_local().device.type == "meta" and tuple(d.shape) == (512, 96)
            assert tuple(d.placements) == tuple(sh.placements(2))


def test_world_refuses_nccl_and_a_second_world():
    """NCCL on a host without a card per rank is refused, naming the cards
    and the ranks, before any group is made."""
    with pytest.raises(world.WorldRefused, match="NCCL needs a card per rank.* 2 ranks"):
        with world.world("nccl", 2):
            pass
    with world.world("fake", 4):
        with pytest.raises(RuntimeError, match="already"):
            with world.world("fake", 4):
                pass
    with pytest.raises(ValueError, match="needs the address"):
        with world.world("gloo", 2):
            pass


# --------------------------------------------- binding ranks to devices
def test_bound_device_follows_device_ids_not_the_rank_number(monkeypatch):
    """On a permuted 2x2 mapping with a card per rank, the rank at row-major
    position p drives card ``device_ids.flat[p]``; with fewer cards only
    ``share_card`` puts it on card 0; a CPU world's ranks are CPU ranks."""
    ids = np.array([[2, 0], [3, 1]])
    mesh = spmd.Mesh(ids, ("x", "y"), "cpu")
    got = [world.bound_device(mesh, r, "cuda", n_cards=4) for r in range(4)]
    assert got == [torch.device("cuda", c) for c in (2, 0, 3, 1)]
    assert [world.bound_device(mesh, r, "cuda", n_cards=8) for r in range(4)] == got
    assert {world.bound_device(mesh, r, "cuda", share_card=True, n_cards=1)
            for r in range(4)} == {torch.device("cuda", 0)}
    with pytest.raises(world.WorldRefused, match="share_card"):
        world.bound_device(mesh, 1, "cuda", n_cards=1)
    assert world.bound_device(mesh, 3, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="outside"):
        world.bound_device(mesh, 4, "cpu")
    # a World binds by its own rank, on the cards torch counts
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert world.World("gloo", 4, 1, "cuda").device(mesh) == torch.device("cuda", 0)


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("kind, n, device_type, share, found, refused", [
    ("nccl", 8, "cuda", False, [H100], "NCCL needs a card per rank, and this host "
     "has 1 card\\(s\\) \\(NVIDIA H100 80GB HBM3\\) for 8 ranks"),
    ("nccl", 4, "cuda", True, [H100], "for 4 ranks"),
    ("nccl", 2, "cuda", False, [], "0 card\\(s\\) for 2 ranks"),
    ("gloo", 8, "cuda", False, [H100], "1 card\\(s\\) .* for 8 ranks; every rank would "
     "share card 0, which only share_card"),
    ("gloo", 4, "cuda", True, [], "0 card\\(s\\) for 4 ranks"),
    ("gloo", 8, "cuda", True, [H100], None),
    ("gloo", 4, "cuda", False, [H100] * 4, None),
    ("nccl", 4, "cuda", False, [H100] * 4, None),
    ("nccl", 1, "cuda", False, [H100], None),
    ("gloo", 8, "cpu", False, [], None),
])
def test_check_refuses_worlds_without_a_card_per_rank_or_the_flag(
        kind, n, device_type, share, found, refused):
    """NCCL needs a card per rank, share_card or not; gloo on CUDA needs a
    card per rank or share_card and one card; a CPU world needs none."""
    if refused is None:
        world.check(kind, n, device_type, share_card=share, found=found)
    else:
        with pytest.raises(world.WorldRefused, match=refused):
            world.check(kind, n, device_type, share_card=share, found=found)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_circuit_runs_on_a_rank_of_a_process_group():
    """The circuit body on one rank's blocks (no leading mesh dims): a
    one-rank gloo world's result equals the virtual ranks' and the
    oracle's. (Its charge buffer was sized from the piece count and
    scattered with the local wire indices, which holds only for stacked
    blocks.)"""
    from repro_torch.science import circuit

    cfg = circuit.CircuitConfig(pieces=1, steps=3)
    state = circuit.generate(cfg, seed=2, device="cpu")
    base = spmd.Mesh(np.zeros(1, np.int64), ("x",), "cpu")
    want = circuit.run(state, MatmulGrid(base, ("x",)), cfg)
    with world.world("gloo", 1, address=f"tcp://127.0.0.1:{_free_port()}") as w:
        mesh = w.place(base)
        got = circuit.run(state, MatmulGrid(mesh, ("x",)), cfg)
        assert got.to_local().shape == want.shape
        got = got.full_tensor()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, circuit.reference(state, cfg), rtol=1e-3, atol=1e-3)


def test_max_err_compares_a_process_group_result():
    """``validate._max_err`` takes a process-group result (a DTensor)
    against a plain oracle through its full tensor."""
    from repro_torch.apps import validate

    base = spmd.Mesh(np.zeros((1, 1), np.int64), ("x", "y"), "cpu")
    x = torch.arange(12.0).reshape(3, 4)
    with world.world("gloo", 1, address=f"tcp://127.0.0.1:{_free_port()}") as w:
        out = spmd.shard_map(lambda b: 2 * b, w.place(base), (P("x", "y"),),
                             P("x", "y"))(x)
        assert validate._max_err(out, 2 * x) == 0.0
        assert validate._max_err(out, 2 * x + 0.5) == 0.5


def test_staged_collectives_keep_values_and_count_their_bytes(monkeypatch):
    """A collective that ``world.STAGED`` names for a world's backend and
    the block's device goes through host memory: the same values, its
    bytes (down and back) counted under its name; the others are not."""
    monkeypatch.setitem(world.STAGED, ("gloo", "cpu"), frozenset({"all_gather"}))
    base = spmd.Mesh(np.zeros((1, 1), np.int64), ("x", "y"), "cpu")
    x = torch.arange(24.0).reshape(4, 6)

    def body(b):
        return spmd.psum(spmd.all_gather(b, "y", dim=-1), "x")

    with world.world("gloo", 1, address=f"tcp://127.0.0.1:{_free_port()}") as w:
        world.reset_staged()
        out = spmd.shard_map(body, w.place(base), (P("x", "y"),), P("x", "y"))(x)
        assert torch.equal(out.full_tensor(), x)
        staged = world.staged_bytes()
    world.reset_staged()
    assert staged == {"all_gather": 2 * x.nbytes}


def test_placements_split_an_entry_over_several_axes_major_first():
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_production_mesh(multi_pod=True, device="meta")
    assert spmd.placements(P(("pod", "data"), "model"), mesh, 2) == [
        Shard(0), Shard(0), Shard(1)]
    assert spmd.placements(P(None, "data"), mesh, 3) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        spmd.placements(P(("data", "pod")), mesh, 1)


# ------------------------------------------- constraint call sites, plain
@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b", "hymba-1.5b",
                                  "rwkv6-3b", "musicgen-medium"])
def test_constraint_call_sites_leave_plain_outputs_bit_identical(arch, monkeypatch):
    """Logits and the loss on plain tensors, with a virtual (2, 2) mesh in
    scope and without, equal those with the four constraints and the
    head splits replaced by the identity and a plain reshape."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    shape = (2, 32, cfg.d_model) if cfg.stub_frontend else (2, 32)
    inputs = (torch.randn(shape, generator=g) if cfg.stub_frontend
              else torch.randint(0, cfg.vocab_size, shape, generator=g))

    def outputs():
        outs = []
        for mesh in (None, tmesh.small_mesh(shape=(2, 2), device="cpu")):
            with spmd.use_mesh(mesh):
                logits, _ = model.logits(params, inputs, remat=False)
                outs.append(logits)
        return outs

    with_sites = outputs()
    ident = lambda x, *a, **k: x  # noqa: E731
    for mod in ("transformer", "hymba", "rwkv6"):
        m = importlib.import_module(f"repro_torch.models.{mod}")
        for name in ("constrain", "residual", "logits_sharded", "unshard"):
            if hasattr(m, name):
                monkeypatch.setattr(m, name, ident)
        if hasattr(m, "split_heads"):
            monkeypatch.setattr(m, "split_heads",
                                lambda x, n, d: x.reshape(*x.shape[:-1], n, d))
        if hasattr(m, "merge_heads"):
            monkeypatch.setattr(m, "merge_heads",
                                lambda x: x.reshape(*x.shape[:-2], -1))
    monkeypatch.setattr(shd, "constrain", ident)
    without = outputs()
    for a, b in zip(with_sites, without):
        assert torch.equal(a, b)


# ------------------------------- the staged route on a gloo CPU world
def _staged_worker(rank: int, port: int, out_dir: str) -> None:
    """DTensor's own redistributions and ``spmd``'s collectives on a world
    whose groups stage the all-gather through host memory (``world.STAGED``
    forced for CPU blocks): each case's values against the whole tensor
    every rank knows, and the bytes it staged."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    import torch.distributed._functional_collectives as funcol

    torch.set_num_threads(1)
    world.STAGED[("gloo", "cpu")] = frozenset({"all_gather"})
    x = torch.arange(48.0).reshape(8, 6)
    report = {}
    with world.world("gloo", N_RANKS, rank=rank, address=f"tcp://127.0.0.1:{port}"):
        mesh = world.World("gloo", N_RANKS, rank).place(
            spmd.Mesh(_mapple_ids((2, 2)), ("data", "model"), "cpu"))
        dm = mesh.dist
        report["backend"] = torch.distributed.get_backend()
        me = dm.get_local_rank(1)
        both = distribute_tensor(x, dm, [Shard(0), Shard(1)])
        model = distribute_tensor(x, dm, [Replicate(), Shard(0)])
        part = DTensor.from_local(x * (rank + 1), dm, [Partial(), Partial()], run_check=False)
        total = x * sum(range(1, N_RANKS + 1))
        cases = {
            "shard_to_replicate": lambda: torch.equal(
                model.redistribute(dm, [Replicate(), Replicate()]).to_local(), x),
            "shard_to_shard": lambda: torch.equal(
                model.redistribute(dm, [Replicate(), Shard(1)]).to_local(),
                x.chunk(2, dim=1)[me]),
            "partial_to_replicate": lambda: torch.equal(
                part.redistribute(dm, [Replicate(), Replicate()]).to_local(), total),
            "partial_to_shard": lambda: torch.equal(
                part.redistribute(dm, [Replicate(), Shard(0)]).to_local(),
                total.chunk(2)[me]),
            "distribute_tensor": lambda: torch.equal(
                distribute_tensor(x, dm, [Shard(0), Shard(1)]).to_local(),
                x.chunk(2)[dm.get_local_rank(0)].chunk(2, dim=1)[me]),
            "full_tensor": lambda: torch.equal(both.full_tensor(), x),
            "funcol_all_gather": lambda: funcol.all_gather_tensor(
                torch.full((2,), float(rank)), 0, (dm, 1)).wait().tolist()
            == [float(r) for r in range(N_RANKS) if r // 2 == rank // 2 for _ in range(2)],
            "spmd_all_gather": lambda: torch.equal(spmd.shard_map(
                lambda b: spmd.all_gather(b, "model", dim=1), mesh, (P("data", "model"),),
                P("data", None))(x).full_tensor(), x),
        }
        for name, case in cases.items():
            world.reset_staged()
            report[name] = [bool(case()), world.staged_bytes()]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    out = tmp_path_factory.mktemp("staged")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, __file__, "staged", str(_free_port()), str(out)],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(N_RANKS)]


# Each case's staged bytes on a rank (down and back): an all-gather of b
# bytes over g ranks moves b + g * b; a block of x (8 x 6 fp32) cut in two
# is 96 bytes, in four 48.
STAGED_CASES = {
    "shard_to_replicate": {"all_gather": 96 + 192},
    "shard_to_shard": {"all_gather": 96 + 192},     # CPU: DTensor gathers, then chunks
    "partial_to_replicate": {},
    "partial_to_shard": {},
    "distribute_tensor": {},
    "full_tensor": {"all_gather": (48 + 96) + (96 + 192)},
    "funcol_all_gather": {"all_gather": 8 + 16},
    "spmd_all_gather": {"all_gather": (48 + 96) + (96 + 192)},
}


@pytest.mark.parametrize("case", list(STAGED_CASES))
def test_staged_route_keeps_values_and_counts_each_gather(staged, case):
    """On a world whose groups stage the all-gather (as a gloo world on
    CUDA does), DTensor's own redistributions and ``full_tensor``, funcol's
    and ``spmd``'s gathers give the whole values to the bit on every rank,
    each all-gather's bytes counted (the check's gather of
    ``spmd_all_gather`` too); all-reduce and reduce-scatter stage nothing."""
    for rank, report in enumerate(staged):
        assert report["backend"] == world.STAGED_BACKEND
        ok, nbytes = report[case]
        assert ok, (rank, case)
        assert nbytes == STAGED_CASES[case], (rank, case, nbytes)


if __name__ == "__main__":
    if sys.argv[1] == "staged":
        import torch.multiprocessing as mp

        mp.spawn(_staged_worker, args=(int(sys.argv[2]), sys.argv[3]), nprocs=N_RANKS,
                 join=True)
    else:
        _spawn(int(sys.argv[1]), sys.argv[2])


def test_count_books_each_collective_of_a_body_by_kind():
    """On a fake group of 4, one rank's count of a body that runs each
    collective once books its output bytes under the reference's kind:
    a ppermute is a collective-permute, an all_to_all an all-to-all."""
    from repro_torch.launch import flops

    base = spmd.Mesh(np.arange(4).reshape(2, 2), ("data", "model"), "meta")

    def body(b):                                    # b: (2, 4, 8) fp32 = 256 bytes
        y = spmd.all_gather(b, "model", dim=1)      # 512
        y = spmd.psum(y, "data")                    # 512
        y = spmd.psum_scatter(y, "model", 1)        # 256
        y = spmd.all_to_all(y, "model", 0, 0)       # 256
        return spmd.ppermute(y, "data", [(0, 1), (1, 0)])   # 256

    with world.world("fake", 4):
        mesh = world.on_world(base, "meta", device_type="cuda")
        x = torch.empty(4, 8, 8, device="meta")
        costs = flops.count(spmd.shard_map(body, mesh, (P("data", "model"),),
                                           P("data", "model")), x)
    assert costs.collective_by_kind == {"all-gather": 512, "all-reduce": 512,
                                        "reduce-scatter": 256, "all-to-all": 256,
                                        "collective-permute": 256}
    stats = flops.CollectiveStats.of(costs)
    assert stats.total_bytes == 1792 and stats.count_by_kind["all-reduce"] == 1
    assert "collective-permute" in stats.summary()
    assert flops.dominant_ops(costs, 2)[0][1] == 512
