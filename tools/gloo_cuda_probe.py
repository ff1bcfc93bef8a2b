"""Which collectives a gloo world carries for CUDA tensors, on this torch.

For each collective that ``core/spmd.py``'s process-group backend and
DTensor run (and, as controls, a DeviceMesh alone and c10d's own
all-reduce): the functional all-gather, reduce-scatter, all-reduce of a
sum and of a max, the even and the uneven all-to-all, a ``full_tensor``
of a sharded DTensor, and DTensor's own redistributions (``Shard ->
Replicate``, ``Shard(0) -> Shard(1)``, ``Partial -> Replicate``,
``Partial -> Shard``, ``distribute_tensor``), it spawns a gloo world of
two processes of its own that both drive ``cuda:0`` (or the CPU, with
``--cpu``) and runs that one case, so that a crash answers for one case
only. The ``staged_`` cases run the same on the port's own world
(``core/world.py::world`` with ``share_card``), whose groups stage what
``world.STAGED`` names through host memory; each also checks that the
bytes were counted where the table stages. Then a one-rank NCCL world's
all-reduce. Prints one line a case and one JSON object: ``"ok"`` (the
values checked), ``"wrong values"``, or the ranks' exit codes (a
negative one is the signal that ended the rank).

    PYTHONPATH=src python3 tools/gloo_cuda_probe.py [--cpu] [case ...]

The answers decide ``world.STAGED``, the collectives staged through host
memory on a gloo world with CUDA blocks.
"""
from __future__ import annotations

import json
import socket
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DTENSOR = ("shard_to_replicate", "shard_to_shard", "partial_to_replicate",
           "partial_to_shard", "distribute_tensor")
RAW = ("mesh_only", "c10d_all_reduce", "all_gather", "reduce_scatter", "all_reduce_sum",
       "all_reduce_max", "all_to_all", "all_to_all_uneven", "full_tensor") + DTENSOR
STAGED = tuple(f"staged_{c}" for c in ("all_gather", "full_tensor") + DTENSOR)
CASES = RAW + STAGED


def _dtensor_case(name: str, mesh, rank: int, n: int, device: str) -> bool:
    """DTensor's own redistributions on a 1-D mesh of ``n`` ranks, each
    against the whole value every rank knows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    whole = torch.arange(4.0 * n * 6, device=device).reshape(4 * n, 6)
    on = lambda y: y.device.type == device  # noqa: E731
    if name == "distribute_tensor":
        y = distribute_tensor(whole, mesh, [Shard(0)]).to_local()
        return on(y) and torch.equal(y, whole.chunk(n)[rank])
    if name.startswith("shard"):
        d = DTensor.from_local(whole.chunk(n)[rank].clone(), mesh, [Shard(0)],
                               run_check=False)
        if name == "shard_to_replicate":
            y = d.redistribute(mesh, [Replicate()]).to_local()
            return on(y) and torch.equal(y, whole)
        y = d.redistribute(mesh, [Shard(1)]).to_local()
        return on(y) and torch.equal(y, whole.chunk(n, dim=1)[rank])
    p = DTensor.from_local(whole * (rank + 1), mesh, [Partial()], run_check=False)
    total = whole * (n * (n + 1) // 2)
    if name == "partial_to_replicate":
        y = p.redistribute(mesh, [Replicate()]).to_local()
        return on(y) and torch.equal(y, total)
    y = p.redistribute(mesh, [Shard(0)]).to_local()
    return on(y) and torch.equal(y, total.chunk(n)[rank])


def _case(name: str, rank: int, n: int, device: str, mesh=None) -> bool:
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    if mesh is None:
        mesh = DeviceMesh("cuda" if device == "cuda" else "cpu", torch.arange(n))
    group = (mesh, 0)
    x = torch.full((4, 3), float(rank + 1), device=device)
    on = lambda y: y.device.type == device  # noqa: E731
    if name in DTENSOR:
        return _dtensor_case(name, mesh, rank, n, device)
    if name == "mesh_only":
        torch.distributed.barrier()
        return True
    if name == "c10d_all_reduce":
        torch.distributed.all_reduce(x)
        return on(x) and bool((x == float(sum(range(1, n + 1)))).all())
    if name == "all_gather":
        y = funcol.all_gather_tensor(x, 0, group).wait()
        return on(y) and torch.equal(y[::4, 0].cpu(),
                                     torch.arange(1, n + 1, dtype=torch.float32))
    if name == "reduce_scatter":
        y = funcol.reduce_scatter_tensor(torch.ones(4 * n, device=device), "sum",
                                         0, group).wait()
        return on(y) and bool((y == n).all())
    if name.startswith("all_reduce"):
        op = name.rsplit("_", 1)[1]
        y = funcol.all_reduce(x, op, group).wait()
        want = float(sum(range(1, n + 1))) if op == "sum" else float(n)
        return on(y) and bool((y == want).all())
    if name == "all_to_all":
        y = funcol.all_to_all_single(torch.arange(n, device=device).float() + 10 * rank,
                                     None, None, group).wait()
        # rank r sends r + 10 * me to rank r, so it receives r + 10 * sender
        return on(y) and torch.equal(y.cpu(), 10 * torch.arange(n, dtype=torch.float32)
                                     + rank)
    if name == "all_to_all_uneven":
        # rank 0 sends 2 values to rank 1, every other pair nothing
        send, recv = [0] * n, [0] * n
        if rank == 0:
            send[1] = 2
        if rank == 1:
            recv[0] = 2
        y = funcol.all_to_all_single(torch.full((sum(send),), 7.0, device=device),
                                     recv, send, group).wait()
        return on(y) and y.numel() == sum(recv) and bool((y == 7).all())
    if name == "full_tensor":
        y = DTensor.from_local(x, mesh, [Shard(0)], run_check=False).full_tensor()
        return on(y) and tuple(y.shape) == (4 * n, 3)
    raise KeyError(name)


def _staged(name: str, rank: int, n: int, port: int, device: str) -> bool:
    """A case on the port's world (``core/world.py``), whose groups stage
    what ``world.STAGED`` names; a staged collective must count its bytes."""
    import numpy as np

    from repro_torch.core import spmd, world

    with world.world("gloo", n, rank=rank, address=f"tcp://127.0.0.1:{port}",
                     device_type=device, share_card=True) as w:
        mesh = w.place(spmd.Mesh(np.arange(n), ("x",), device)).dist
        world.reset_staged()
        ok = _case(name, rank, n, device, mesh)
        if device == "cuda":
            torch.cuda.synchronize()
        gathers = name in ("all_gather", "full_tensor", "shard_to_replicate")
        if gathers and "all_gather" in world.STAGED.get(("gloo", device), ()):
            ok = ok and world.staged_bytes().get("all_gather", 0) > 0
        return ok


def _worker(rank: int, port: int, n: int, name: str, device: str) -> None:
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
    if name.startswith("staged_"):
        try:
            ok = _staged(name[len("staged_"):], rank, n, port, device)
        except Exception as e:  # noqa: BLE001 -- the probe reports every refusal
            print(json.dumps({"rank": rank, name: f"{type(e).__name__}: "
                              f"{str(e).splitlines()[0][:200]}"}), flush=True)
            raise SystemExit(3)
        if not ok:
            raise SystemExit(4)
        return
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)
    try:
        ok = _case(name, rank, n, device)
        if device == "cuda":
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 -- the probe reports every refusal
        print(json.dumps({"rank": rank, name: f"{type(e).__name__}: "
                          f"{str(e).splitlines()[0][:200]}"}), flush=True)
        raise SystemExit(3)
    finally:
        dist.destroy_process_group()
    if not ok:
        raise SystemExit(4)


def _nccl_one_rank() -> str:
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        x = torch.ones(8, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return "ok" if bool((x == 1).all()) else "wrong values"
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp

    device = "cpu" if "--cpu" in sys.argv else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    asked = [a for a in sys.argv[1:] if not a.startswith("--")]
    unknown = sorted(set(asked) - set(CASES))
    if unknown:
        print(f"unknown case(s) {unknown}; cases: {', '.join(CASES)}", file=sys.stderr)
        return 2
    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "device": device}
    for name in asked or CASES:
        ctx = mp.spawn(_worker, args=(_free_port(), 2, name, device), nprocs=2,
                       join=False)
        for p in ctx.processes:
            p.join(120)
        codes = [p.exitcode for p in ctx.processes]
        report[name] = ("ok" if codes == [0, 0] else
                        "wrong values" if 4 in codes else
                        f"exit codes {codes}")
        print(name, report[name], flush=True)
    if device == "cuda":
        report["nccl_one_rank"] = _nccl_one_rank()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
