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

*Host staging.* Where :data:`STAGED` says gloo does not carry a
collective for the blocks' device type (its all-gather on CUDA tensors
kills the ranks), a gloo world is built of ``StagedGroup``s: Python
process groups over gloo's that take that collective through host
memory and count its bytes (:func:`staged_bytes`), so that every
caller's all-gather is staged (``spmd``'s, DTensor's redistributions
and ``full_tensor``); compute stays on the device.

The fake group's store lives under ``torch.testing._internal``, a
private path (``FAKE_STORE_CHECKED_ON``).
"""
from __future__ import annotations

import collections
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

    def place(self, mesh: Mesh, fold: tuple[str, ...] = ()) -> Mesh:
        """``mesh`` on this world with this rank on its bound device (its
        ``fold`` axes one dim of the DeviceMesh, :func:`on_world`): on
        CUDA that card becomes current before the DeviceMesh is built."""
        device = self.device(mesh)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        placed = on_world(mesh, device, fold=fold)
        if device.type == "cuda" and torch.cuda.current_device() != device.index:
            raise RuntimeError(f"rank {self.rank}: the DeviceMesh moved the "
                               f"current card off its bound {device}")
        return placed


# ------------------------------------------- host staging of a whole world
#: The collectives a backend does not carry for tensors of a device type,
#: by (backend, device type), under the names of :func:`staged_bytes`.
#: ``tools/gloo_cuda_probe.py`` found, on torch 2.11+cu128 (H100), that
#: gloo's all-gather kills both ranks with SIGSEGV on CUDA tensors (funcol's,
#: DTensor's ``Shard -> Replicate`` and ``full_tensor``), while its
#: reduce-scatter, all-reduce (sum, max) and all-to-all (even and uneven)
#: carry them.
STAGED: dict[tuple[str, str], frozenset[str]] = {
    ("gloo", "cuda"): frozenset({"all_gather"}),
}

#: The backend name a gloo world registers when :data:`STAGED` names
#: collectives gloo does not carry for its blocks' device type.
STAGED_BACKEND = "mapple_staged_gloo"

_STAGED_BYTES: collections.Counter = collections.Counter()


def staged_bytes() -> dict[str, int]:
    """Bytes this process moved between its device and host memory to
    stage each collective (down and back), by collective."""
    return dict(_STAGED_BYTES)


def reset_staged() -> None:
    _STAGED_BYTES.clear()


def _staged_group_class():
    """:class:`torch.distributed.ProcessGroup` subclass of a gloo group
    whose staged collectives go through host memory (built on first use:
    the class needs ``torch.distributed`` with gloo)."""
    global _StagedGroup
    if _StagedGroup is not None:
        return _StagedGroup
    from torch.distributed import ProcessGroup, ProcessGroupGloo

    class StagedGroup(ProcessGroup):
        """A gloo group in which each collective that :data:`STAGED` names
        for gloo and its blocks' device type copies its inputs to host
        memory, runs there and copies the result into the caller's
        outputs on their device, counting the bytes
        (:func:`staged_bytes`); every other collective is gloo's own on
        the blocks as they are. All of a world's groups are of this kind,
        so DTensor's own redistributions are staged as well as ``spmd``'s.
        A Python ProcessGroup, as
        ``torch.testing._internal.distributed.multi_threaded_pg``
        registers one."""

        def __init__(self, store, rank, size, timeout):
            super().__init__(rank, size)
            self._gloo = ProcessGroupGloo(store, rank, size, timeout)

        def getBackendName(self):
            return STAGED_BACKEND

        # A Python group keeps its own name (c10d sets it after the
        # creator returns; functional collectives look the group up by it).
        def _set_group_name(self, name):
            self._group_name = name

        @property
        def group_name(self):
            return self._group_name

        def _on_host(self, name, outputs, inputs):
            """(host outputs, host inputs, copy back) for a staged call:
            the inputs copied down, the outputs allocated on the host and
            copied up once the collective has filled them; the bytes
            counted are those (down and back)."""
            outs = [torch.empty_like(o, device="cpu") if o.device.type != "cpu" else o
                    for o in outputs]
            ins = [i.cpu() for i in inputs]

            def back():
                for o, h in zip(outputs, outs):
                    if h is not o:
                        o.copy_(h)
                _STAGED_BYTES[name] += sum(t.nbytes for t in ins + outs)
            return outs, ins, back

        def _wants(self, name, tensors):
            return any(name in STAGED.get(("gloo", t.device.type), ()) for t in tensors)

        # -- all-gather: staged where named
        def allgather(self, output_lists, inputs, opts=None):
            flat = [o for lst in output_lists for o in lst]
            if not self._wants("all_gather", flat + list(inputs)):
                return self._gloo.allgather(output_lists, inputs, *_opt(opts))
            outs, ins, back = self._on_host("all_gather", flat, inputs)
            it = iter(outs)
            work = self._gloo.allgather([[next(it) for _ in lst] for lst in output_lists],
                                        ins, *_opt(opts))
            work.wait()
            back()
            return work

        def _allgather_base(self, output, input, opts=None):
            if not self._wants("all_gather", [output, input]):
                return self._gloo._allgather_base(output, input, *_opt(opts))
            (out,), (inp,), back = self._on_host("all_gather", [output], [input])
            work = self._gloo._allgather_base(out, inp, *_opt(opts))
            work.wait()
            back()
            return work

        all_gather_single = _allgather_base

        def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
            work = None
            for o, i in zip(outputs, inputs):
                work = self._allgather_base(o, i, opts)
                work.wait()
            return work

        all_gather_single_coalesced = allgather_into_tensor_coalesced

        # -- the rest: gloo's own (what DTensor, funcol, spmd and c10d's
        # set-up call; any other collective raises, having no backend)
        def allreduce(self, tensors, opts=None):
            return self._gloo.allreduce(tensors, *_opt(opts))

        def _reduce_scatter_base(self, output, input, opts=None):
            return self._gloo._reduce_scatter_base(output, input, *_opt(opts))

        reduce_scatter_single = _reduce_scatter_base

        def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
            work = None
            for o, i in zip(outputs, inputs):
                work = self._gloo._reduce_scatter_base(o, i, *_opt(opts))
                work.wait()
            return work

        reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

        def alltoall_base(self, output, input, output_split_sizes, input_split_sizes,
                          opts=None):
            return self._gloo.alltoall_base(output, input, output_split_sizes,
                                            input_split_sizes, *_opt(opts))

        all_to_all_single = alltoall_base

        def broadcast(self, tensors, opts=None):
            return self._gloo.broadcast(tensors, *_opt(opts))

        def scatter(self, outputs, input_lists, opts=None):
            return self._gloo.scatter(outputs, input_lists, *_opt(opts))

        def barrier(self, opts=None):
            return self._gloo.barrier(*_opt(opts))

    _StagedGroup = StagedGroup
    return StagedGroup


_StagedGroup = None


def _opt(opts) -> tuple:
    return () if opts is None else (opts,)


def _staged_backend(device_type: str) -> str | None:
    """The backend name a gloo world on ``device_type`` initialises with:
    :data:`STAGED_BACKEND` (registered here on first use) where
    :data:`STAGED` names collectives gloo does not carry for that device
    type, else None (gloo itself)."""
    if not STAGED.get(("gloo", device_type)):
        return None
    if getattr(dist.Backend, STAGED_BACKEND.upper(), None) is None:
        dist.Backend.register_backend(STAGED_BACKEND, _staged_group_class(),
                                      devices=["cpu", "cuda"])
    return STAGED_BACKEND


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
        backend = (_staged_backend(device_type) if kind == "gloo" else None) or kind
        dist.init_process_group(backend, init_method=address, rank=rank, world_size=n)
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


def spawn_ranks(fn, n: int, args: tuple, timeout: float) -> list[dict]:
    """Run ``fn(rank, n, address, out_dir, *args)`` in ``n`` spawned
    processes, one a rank, meeting at a free port of 127.0.0.1; each rank
    writes its report to ``out_dir/rank<r>.json``. Returns the reports in
    rank order; raises ``RuntimeError`` if a rank dies or the world
    outlives ``timeout`` seconds (its processes are then ended)."""
    import json
    import socket
    import tempfile
    import time
    from pathlib import Path

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
    with tempfile.TemporaryDirectory(prefix="world-") as tmp:
        ctx = mp.start_processes(fn, nprocs=n, join=False, start_method="spawn",
                                 args=(n, address, tmp, *args))
        try:
            deadline = time.monotonic() + timeout
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"world of {n} outlived {timeout:.0f} s")
        except ProcessException as e:
            raise RuntimeError(f"a rank of the world of {n} failed: {e}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        return [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(n)]

