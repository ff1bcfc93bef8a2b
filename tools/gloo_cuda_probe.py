"""Which collectives a gloo world carries for CUDA tensors, on this torch.

For each collective that ``core/spmd.py``'s process-group backend and
DTensor's ``full_tensor`` run (and, as controls, a DeviceMesh alone and
c10d's own all-reduce): the functional all-gather, reduce-scatter,
all-reduce of a sum and of a max, the even and the uneven all-to-all,
and a ``full_tensor`` of a sharded DTensor, it spawns a gloo world of
two processes of its own that both drive ``cuda:0`` (or the CPU, with
``--cpu``) and runs that one collective, so that a crash answers for one
collective only. Then a one-rank NCCL world's all-reduce. Prints one
line a collective and one JSON object: ``"ok"`` (the values checked),
``"wrong values"``, or the ranks' exit codes (a negative one is the
signal that ended the rank).

    python3 tools/gloo_cuda_probe.py [--cpu]

The answers decide ``spmd.STAGED``, the collectives staged through host
memory on a gloo world with CUDA blocks.
"""
from __future__ import annotations

import json
import socket
import sys

import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CASES = ("mesh_only", "c10d_all_reduce", "all_gather", "reduce_scatter", "all_reduce_sum", "all_reduce_max",
         "all_to_all", "all_to_all_uneven", "full_tensor")


def _case(name: str, rank: int, n: int, device: str) -> bool:
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    mesh = DeviceMesh("cuda" if device == "cuda" else "cpu", torch.arange(n))
    group = (mesh, 0)
    x = torch.full((4, 3), float(rank + 1), device=device)
    on = lambda y: y.device.type == device  # noqa: E731
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


def _worker(rank: int, port: int, n: int, name: str, device: str) -> None:
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(0)
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
    report = {"torch": torch.__version__, "cuda": torch.version.cuda, "device": device}
    for name in CASES:
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
