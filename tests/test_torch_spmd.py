"""The port's single-process SPMD substrate against a plain per-rank loop.

Every collective runs inside ``shard_map`` on the stacked form and is
checked, rank by rank, against what each rank would compute on its own.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import spmd
from repro_torch.core.spmd import Mesh, P

MESHES = [(2, 2), (2, 2, 2), (2, 3, 2)]
NAMES = ("x", "y", "z")


def _mesh(shape):
    ids = np.random.default_rng(0).permutation(int(np.prod(shape)))
    return Mesh(ids.reshape(shape), NAMES[:len(shape)], "cpu")


def _stacked(mesh, block=(4, 6), seed=0):
    """A global tensor whose leading dims split over the mesh axes, and
    its spec (mesh axes beyond the tensor's dims are broadcast)."""
    rng = np.random.default_rng(seed)
    nblock = len(block)
    glob_shape = [s for s in block]
    spec = [None] * nblock
    # Partition the first block dims over the mesh axes, broadcast the rest.
    for i, a in enumerate(mesh.axis_names[:nblock]):
        glob_shape[i] *= mesh.axis_size(a)
        spec[i] = a
    x = torch.from_numpy(rng.normal(size=glob_shape).astype(np.float32))
    return x, P(*spec)


def _run(mesh, fn, block=(4, 6)):
    """Run a collective inside shard_map; return (stacked input, output)."""
    x, spec = _stacked(mesh, block)
    got = {}

    def body(xs):
        got["in"] = xs
        got["out"] = fn(xs)
        return xs

    spmd.shard_map(body, mesh, (spec,), spec)(x)
    return got["in"], got["out"]


def _coords(mesh):
    return list(itertools.product(*[range(s) for s in mesh.shape]))


def _at(c, axis, r):
    c = list(c)
    c[axis] = r
    return tuple(c)


@pytest.mark.parametrize("shape", MESHES)
def test_ppermute_matches_per_rank_loop(shape):
    mesh = _mesh(shape)
    for a, name in enumerate(mesh.axis_names):
        n = mesh.shape[a]
        # A cyclic shift, and a partial permutation (receivers of nothing
        # get zeros, as in JAX).
        for perm in ([(i, (i + 1) % n) for i in range(n)], [(0, n - 1)]):
            xs, out = _run(mesh, lambda x: spmd.ppermute(x, name, perm))
            src_of = {d: s for s, d in perm}
            for c in _coords(mesh):
                s = src_of.get(c[a])
                expect = xs[_at(c, a, s)] if s is not None \
                    else torch.zeros_like(xs[c])
                torch.testing.assert_close(out[c], expect, rtol=0, atol=0)


@pytest.mark.parametrize("shape", MESHES)
def test_psum_matches_per_rank_loop(shape):
    mesh = _mesh(shape)
    for a, name in enumerate(mesh.axis_names):
        xs, out = _run(mesh, lambda x: spmd.psum(x, name))
        for c in _coords(mesh):
            expect = sum(xs[_at(c, a, r)] for r in range(mesh.shape[a]))
            torch.testing.assert_close(out[c], expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_axis_index_and_where_match_per_rank_loop(shape):
    mesh = _mesh(shape)
    for a, name in enumerate(mesh.axis_names):
        # Each rank keeps its block where its coordinate is odd, else zeros.
        xs, out = _run(mesh, lambda x: spmd.where(
            spmd.axis_index(name) % 2 == 1, x, torch.zeros_like(x)))
        for c in _coords(mesh):
            expect = xs[c] if c[a] % 2 == 1 else torch.zeros_like(xs[c])
            torch.testing.assert_close(out[c], expect, rtol=0, atol=0)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dim", [0, -1])
def test_all_gather_matches_per_rank_loop(shape, dim):
    mesh = _mesh(shape)
    for a, name in enumerate(mesh.axis_names):
        xs, out = _run(mesh, lambda x: spmd.all_gather(x, name, dim=dim))
        for c in _coords(mesh):
            expect = torch.cat([xs[_at(c, a, r)] for r in range(mesh.shape[a])],
                               dim=dim)
            torch.testing.assert_close(out[c], expect, rtol=0, atol=0)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dim", [0, -1])
def test_psum_scatter_matches_per_rank_loop(shape, dim):
    mesh = _mesh(shape)
    for a, name in enumerate(mesh.axis_names):
        g = mesh.shape[a]
        block = (4 * g, 6 * g)
        xs, out = _run(mesh, lambda x: spmd.psum_scatter(
            x, name, scatter_dimension=dim), block=block)
        for c in _coords(mesh):
            total = sum(xs[_at(c, a, r)] for r in range(g))
            expect = total.chunk(g, dim=dim)[c[a]]
            torch.testing.assert_close(out[c], expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", [P("x", "z"), P("z", "y"), P("x", "y"),
                                  P(None, "x"), P("y")])
def test_split_assemble_broadcast_spec(spec):
    """An axis a spec does not name is a broadcast dim, and assemble
    inverts split (taking coordinate 0 of broadcast axes)."""
    mesh = _mesh((2, 3, 2))
    glob = torch.arange(12 * 12, dtype=torch.float32).reshape(12, 12)
    st = spmd.split(glob, spec, mesh)
    full = spec + (None,) * (2 - len(spec))
    assert st.shape[:3] == mesh.shape
    for c in _coords(mesh):
        idx = []
        for d, a in enumerate(full):
            if a is None:
                idx.append(slice(None))
            else:
                g = mesh.axis_size(a)
                k = c[mesh.axis(a)]
                n = glob.shape[d] // g
                idx.append(slice(k * n, (k + 1) * n))
        torch.testing.assert_close(st[c], glob[tuple(idx)], rtol=0, atol=0)
    torch.testing.assert_close(spmd.assemble(st, spec, mesh), glob,
                               rtol=0, atol=0)


def test_split_rejects_uneven_and_unknown_axes():
    mesh = _mesh((2, 2))
    with pytest.raises(ValueError):
        spmd.split(torch.zeros(3, 4), P("x", "y"), mesh)
    with pytest.raises(KeyError):
        spmd.split(torch.zeros(4, 4), P("q"), mesh)
    with pytest.raises(RuntimeError):
        spmd.psum(torch.zeros(2, 2), "x")       # outside a shard_map body


def test_shard_map_tuple_outputs():
    mesh = _mesh((2, 2))
    a = torch.arange(16.0).reshape(4, 4)

    def body(x, y):
        return spmd.psum(x, "x"), y * 2

    s, d = spmd.shard_map(body, mesh, (P("x", "y"), P("x", "y")),
                          (P(None, "y"), P("x", "y")))(a, a)
    torch.testing.assert_close(d, 2 * a)
    torch.testing.assert_close(s, a[:2] + a[2:])


def test_shard_map_runs_where_the_mesh_is():
    """Inputs follow the mesh's device: host tensors handed to a program on
    a non-CPU mesh never run the plain CPU path quietly (here the kernel
    wrapper refuses the device instead)."""
    from repro_torch.core import GPU, Machine
    from repro_torch.matmul import cannon

    grid = cannon.grid_for(Machine(GPU, shape=(2, 2)), device="meta")
    a = torch.ones(8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cannon.matmul(a, a, grid, use_kernel=True)
