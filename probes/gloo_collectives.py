"""Which collectives a process group offers on CUDA tensors: a gloo world
of two processes on one card (NCCL refuses two ranks on one device) and an
NCCL world of one, each collective tried on float32, bfloat16 and int64
tensors on the card.  Prints one JSON line a world.

    python3 probes/gloo_collectives.py
"""

import json
import os
import sys
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int64": torch.int64}


def _try(fn):
    try:
        fn()
        torch.cuda.synchronize()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the point is to record what fails
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _ops(rank, world):
    dev = torch.device("cuda", 0)
    out = {}
    for dname, dt in DTYPES.items():
        x = (torch.arange(8, device=dev) + rank).to(dt)
        out[f"all_reduce/{dname}"] = _try(lambda: dist.all_reduce(x.clone()))
        out[f"all_gather_into_tensor/{dname}"] = _try(
            lambda: dist.all_gather_into_tensor(torch.empty(8 * world, dtype=dt, device=dev), x))
        out[f"all_gather/{dname}"] = _try(
            lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x))
        out[f"broadcast/{dname}"] = _try(lambda: dist.broadcast(x.clone(), 0))
        out[f"all_to_all_single/{dname}"] = _try(
            lambda: dist.all_to_all_single(torch.empty_like(x), x))
        out[f"all_to_all_single_uneven/{dname}"] = _try(
            lambda: dist.all_to_all_single(
                torch.empty(4 * world, dtype=dt, device=dev), x[:4 * world],
                [4] * world, [4] * world))
    from torch.distributed.device_mesh import init_device_mesh
    out["device_mesh_cuda"] = _try(lambda: init_device_mesh("cuda", (1, world),
                                                            mesh_dim_names=("data", "model")))
    return out


def _child(rank, world, path, backend, q):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    res = _ops(rank, world)
    dist.destroy_process_group()
    q.put((rank, res))


def main():
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "device": torch.cuda.get_device_name(0)}))
    ctx = mp.get_context("spawn")
    for backend, world in (("gloo", 2), ("nccl", 1)):
        q = ctx.Queue()
        path = os.path.join(tempfile.mkdtemp(), "init")
        procs = [ctx.Process(target=_child, args=(r, world, path, backend, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = dict(q.get(timeout=300) for _ in range(world))
        for p in procs:
            p.join(timeout=60)
        print(json.dumps({"backend": backend, "world": world, "rank0": got[0]}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
