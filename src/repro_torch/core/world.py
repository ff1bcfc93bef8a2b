"""A process-group world, and the ``DeviceMesh`` of an ``spmd.Mesh`` in it.

``core/spmd.py`` runs a mesh on one of two backends. Virtual ranks
stacked in one tensor need no process group. The process-group backend
needs one: a default group of the mesh's size and a
``torch.distributed.device_mesh.DeviceMesh`` with the mesh's shape and
axis names. The kinds of world:

  * ``"fake"``: n ranks in THIS process, for counts. torch's fake group
    moves no data: a collective returns a tensor of the right shape and
    dtype and leaves its values as they were allocated. This process is
    the rank at the mesh's origin (0, ..., 0), so what it counts is that
    rank's share, which holds the largest block of an uneven split, as
    XLA's padded per-device numbers do;
  * ``"gloo"``: one CPU process per rank, each calling :func:`world` with
    its own rank and one address, for values;
  * ``"nccl"``: refused until the port has a multi-card slice. No kind
    stands in for another.

*Ranks are mesh positions.* A process's rank is its coordinate's
row-major index in the mesh, and the Mapple permutation decides which
device that process drives: ``device_ids`` at its coordinate. The ids
are not the DeviceMesh's ranks because
torch orders a mesh dim's group by rank number, not by position: on a
(2, 2) mesh whose rows are [2, 0] and [3, 1], a gather along 'model' put
rank 0's block first although rank 0 sits at position 1 (gloo, torch
2.13; DTensor's ``Shard`` -> ``Replicate`` did the same), while
``Shard`` cuts blocks by position. So a DeviceMesh over permuted ids
would compute out of order; one over positions computes what the
virtual ranks compute, and the mapping still decides where each block
lives.

The fake group's store lives under ``torch.testing._internal``, a
private path (``FAKE_STORE_CHECKED_ON``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.spmd import Mesh

KINDS = ("fake", "gloo", "nccl")

# Torch versions on which the fake group's store was found at
# torch.testing._internal.distributed.fake_pg.FakeStore.
FAKE_STORE_CHECKED_ON = ("2.11", "2.13")


def _fake_store():
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"the fake process group's store is torch.testing._internal."
            f"distributed.fake_pg.FakeStore, checked on torch "
            f"{', '.join(FAKE_STORE_CHECKED_ON)}; torch {torch.__version__} "
            f"lacks it ({e})") from e
    return FakeStore()


ORIGIN_RANK = 0                 # the rank at mesh position (0, ..., 0)


@contextlib.contextmanager
def world(kind: str, n: int, *, rank: int = 0, address: str | None = None):
    """A default process group of ``n`` ranks for the block, destroyed on
    exit. ``rank`` is this process's rank, its mesh position's row-major
    index (on a fake group: ``ORIGIN_RANK``, the one whose share is
    counted); ``address`` is gloo's
    ``tcp://host:port``, the same for every rank."""
    if kind not in KINDS:
        raise ValueError(f"world kind {kind!r}: one of {KINDS}")
    if kind == "nccl":
        raise NotImplementedError(
            "world('nccl'): NCCL across cards comes with the port's multi-card "
            "slice; this port runs on one card (a fake group counts a mesh's "
            "share, gloo carries values between CPU processes)")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    if kind == "fake":
        dist.init_process_group("fake", store=_fake_store(), rank=rank, world_size=n)
    else:
        if address is None:
            raise ValueError("world('gloo') needs the address every rank meets at")
        dist.init_process_group("gloo", init_method=address, rank=rank, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def device_mesh(mesh: Mesh, device_type: str):
    """The ``DeviceMesh`` of ``mesh``'s shape and axis names (its folded
    axes one dim, named by joining theirs with '+') over the world in
    scope (whose size must be the mesh's), rank = position."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs a world (core/world.py::world)")
    size = int(np.prod(mesh.shape))
    if dist.get_world_size() != size:
        raise ValueError(f"mesh of {size} ranks in a world of {dist.get_world_size()}")
    groups = mesh.dist_axes()
    shape = [int(np.prod([mesh.axis_size(a) for a in g])) for g in groups]
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=tuple("+".join(g) for g in groups))


def on_world(mesh: Mesh, device, device_type: str | None = None,
             fold: tuple[str, ...] = ()) -> Mesh:
    """``mesh`` on the process-group backend: the same ids and axes with a
    ``DeviceMesh`` (``device_type``, default ``device``'s type), this
    rank's blocks on ``device``, ``fold`` one dim of it. A count on the
    meta device passes ``device_type="cuda"``: DTensor reshards a sharded
    dim through an all-to-all on a card's mesh, and through an all-gather
    and a chunk on a CPU one, which would book the wrong collective."""
    device = torch.device(device)
    mesh = Mesh(mesh.device_ids, mesh.axis_names, device, fold=fold)
    return Mesh(mesh.device_ids, mesh.axis_names, device,
                dist=device_mesh(mesh, device_type or device.type), fold=fold)
