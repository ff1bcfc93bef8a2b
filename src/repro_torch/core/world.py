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
  * ``"gloo"``: one process per rank, each calling :func:`world` with
    its own rank and one address, for values. Its blocks live on the CPU,
    or on CUDA cards (``device_type="cuda"``): one card per rank when the
    host has as many cards as ranks, else every rank on card 0, and that
    only when the caller asks for it (``share_card``);
  * ``"nccl"``: one process per rank, each on its own card; refused on a
    host with fewer cards than ranks (NCCL will not put two ranks on one
    card). No kind stands in for another: a world the host cannot give
    is refused (:class:`WorldRefused`), never run on gloo or on fewer
    ranks.

*Ranks are mesh positions.* A process's rank is its coordinate's
row-major index in the mesh, and the Mapple permutation decides which
device that process drives: ``device_ids`` at its coordinate
(:func:`bound_device`; :meth:`World.place` makes it the process's
current card before the DeviceMesh is built, which would otherwise pick
``rank % device_count`` itself). The ids
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
import dataclasses

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


class WorldRefused(RuntimeError):
    """The host cannot give the world asked for (cards, ranks)."""


def cards() -> list[str]:
    """The names of the CUDA cards this process sees."""
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def _default_device_type(kind: str) -> str:
    return "cuda" if kind == "nccl" else "cpu"


def check(kind: str, n: int, device_type: str | None = None, *,
          share_card: bool = False, found: list[str] | None = None) -> None:
    """Raise :class:`WorldRefused` unless this host can give a world of
    ``n`` ranks of ``kind`` with blocks on ``device_type``: NCCL needs a
    card per rank; gloo on CUDA a card per rank, or ``share_card`` and
    one card for all. ``found``: the cards' names (default: :func:`cards`)."""
    device_type = device_type or _default_device_type(kind)
    if kind == "nccl" and device_type != "cuda":
        raise ValueError(f"world('nccl') runs on CUDA cards, not {device_type!r}")
    if device_type != "cuda" or kind == "fake":
        return
    found = cards() if found is None else found
    if len(found) >= n:
        return
    have = (f"this host has {len(found)} card(s)"
            + (f" ({', '.join(found)})" if found else ""))
    if kind == "nccl":
        raise WorldRefused(
            f"world('nccl', {n}): NCCL needs a card per rank, and {have} for "
            f"{n} ranks; it waits for a host with {n} cards")
    if not found:
        raise WorldRefused(f"world('{kind}', {n}) on CUDA: {have} for {n} ranks")
    if not share_card:
        raise WorldRefused(
            f"world('{kind}', {n}) on CUDA: {have} for {n} ranks; every rank "
            f"would share card 0, which only share_card (--share-card) allows")


def bound_device(mesh: Mesh, rank: int, device_type: str, *,
                 share_card: bool = False, n_cards: int | None = None
                 ) -> torch.device:
    """The device of the rank at row-major mesh position ``rank``: on CUDA,
    card ``device_ids`` at that position when the host has a card per
    rank (``n_cards``, default the count torch sees), else card 0 with
    ``share_card``; on another type, that type's device."""
    size = int(mesh.device_ids.size)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a mesh of {size}")
    if device_type != "cuda":
        return torch.device(device_type)
    n_cards = torch.cuda.device_count() if n_cards is None else n_cards
    if n_cards >= size:
        card = int(mesh.device_ids.reshape(-1)[rank])
        if not 0 <= card < n_cards:
            raise ValueError(f"device id {card} at rank {rank} names no card of "
                             f"{n_cards}")
        return torch.device("cuda", card)
    if share_card and n_cards:
        return torch.device("cuda", 0)
    raise WorldRefused(f"rank {rank} of {size} has no card of its own "
                       f"({n_cards} card(s)) and share_card is off")


@dataclasses.dataclass(frozen=True)
class World:
    """The world in scope: its kind, size, this process's rank, where its
    blocks live and whether its ranks share card 0."""

    kind: str
    size: int
    rank: int
    device_type: str = "cpu"
    share_card: bool = False

    def device(self, mesh: Mesh) -> torch.device:
        """This rank's device under ``mesh`` (:func:`bound_device`)."""
        return bound_device(mesh, self.rank, self.device_type,
                            share_card=self.share_card)

    def place(self, mesh: Mesh) -> Mesh:
        """``mesh`` on this world with this rank on its bound device: on
        CUDA that card becomes current before the DeviceMesh is built."""
        device = self.device(mesh)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        placed = on_world(mesh, device)
        if device.type == "cuda" and torch.cuda.current_device() != device.index:
            raise RuntimeError(f"rank {self.rank}: the DeviceMesh moved the "
                               f"current card off its bound {device}")
        return placed


@contextlib.contextmanager
def world(kind: str, n: int, *, rank: int = 0, address: str | None = None,
          device_type: str | None = None, share_card: bool = False):
    """A default process group of ``n`` ranks for the block, destroyed on
    exit; yields its :class:`World`. ``rank`` is this process's rank, its
    mesh position's row-major index (on a fake group: ``ORIGIN_RANK``, the
    one whose share is counted); ``address`` is gloo's or NCCL's
    ``tcp://host:port``, the same for every rank; ``device_type`` where
    the blocks live (default: ``cuda`` for NCCL, else ``cpu``);
    ``share_card`` lets a gloo world on CUDA put every rank on card 0 of
    a host with fewer cards than ranks. A world the host cannot give is
    refused (:func:`check`)."""
    if kind not in KINDS:
        raise ValueError(f"world kind {kind!r}: one of {KINDS}")
    device_type = device_type or _default_device_type(kind)
    check(kind, n, device_type, share_card=share_card)
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    if kind == "fake":
        dist.init_process_group("fake", store=_fake_store(), rank=rank, world_size=n)
    else:
        if address is None:
            raise ValueError(f"world({kind!r}) needs the address every rank meets at")
        dist.init_process_group(kind, init_method=address, rank=rank, world_size=n)
    try:
        yield World(kind, n, rank, device_type, share_card)
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
