#!/usr/bin/env python3
"""Which collectives a gloo process group carries on CUDA tensors, and in
which dtypes: two ranks on one card (NCCL refuses two ranks on one
device, so tensor parallelism of 2 on one card runs over gloo).

    python3 scripts/gloo_cuda_probe.py [--out chiprun_out/gloo_probe.json]

Both ranks live on ``cuda:0``. Each case runs one collective on CUDA
tensors and checks its result against the value it must give; a case
that raises records the error. The cases are the ``torch.distributed``
calls, the functional collectives DTensor issues
(``torch.distributed._functional_collectives``), and the redistributes
the port's tensor-parallel decode step makes on a ``(1, 2)`` DTensor mesh
(``Partial`` -> ``Replicate`` after a row-parallel product, ``Shard`` ->
``Replicate`` of vocab-sharded logits, the masked lookup of a
vocab-sharded embedding). A case can kill its process (gloo on CUDA
tensors has ended a rank with SIGSEGV): each rank notes a case before it
runs it, and when the ranks die the case rank 0 had started is recorded
as crashed and two new ranks go on from the next case. Rank 0's results
are printed as one JSON object (and written to ``--out``); the script
exits 1 if the cases are not done within ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

DTYPES = ("float32", "bfloat16", "float16", "int64")


def _cases(torch, dist, rank: int) -> list:
    """``(name, fn)`` of every case, the decode step's collectives first;
    a DTensor case makes the (1, 2) mesh at its first call."""
    import torch.distributed._functional_collectives as funcol
    import torch.nn.functional as F
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    dev = torch.device("cuda", 0)
    meshes = []

    def mesh():
        if not meshes:
            from torch.distributed.device_mesh import init_device_mesh
            meshes.append(init_device_mesh(
                "cuda", (1, 2), mesh_dim_names=("data", "model")))
        return meshes[0]

    def val(dtype, n=8):
        return torch.arange(n, device=dev).to(dtype) + rank + 1

    def total(dtype):           # the sum of both ranks' val
        return torch.arange(8, device=dev).to(dtype) * 2 + 3

    def all_reduce(dtype):
        t = val(dtype)
        dist.all_reduce(t)
        return torch.equal(t, total(dtype))

    def all_gather_into_tensor(dtype):
        out = torch.empty(16, device=dev, dtype=dtype)
        dist.all_gather_into_tensor(out, val(dtype))
        return torch.equal(out[8:] - out[:8], torch.ones(8, device=dev,
                                                         dtype=dtype))

    def all_gather(dtype):
        outs = [torch.empty(8, device=dev, dtype=dtype) for _ in range(2)]
        dist.all_gather(outs, val(dtype))
        return torch.equal(outs[1] - outs[0],
                           torch.ones(8, device=dev, dtype=dtype))

    def reduce_scatter_tensor(dtype):
        out = torch.empty(4, device=dev, dtype=dtype)
        dist.reduce_scatter_tensor(out, val(dtype))
        return torch.equal(out, total(dtype)[4 * rank:4 * rank + 4])

    def broadcast(dtype):
        t = val(dtype)
        dist.broadcast(t, src=0)
        return torch.equal(t, torch.arange(8, device=dev).to(dtype) + 1)

    def funcol_all_reduce(dtype):
        t = funcol.all_reduce(val(dtype), "sum", dist.group.WORLD)
        return torch.equal(torch.as_tensor(t), total(dtype))

    def funcol_all_gather(dtype):
        t = funcol.all_gather_tensor(val(dtype), 0, dist.group.WORLD)
        t = torch.as_tensor(t)
        return torch.equal(t[8:] - t[:8], torch.ones(8, device=dev,
                                                     dtype=dtype))

    def dtensor_partial_to_replicate(dtype):
        m = mesh()
        d = DTensor.from_local(val(dtype), m, (Replicate(), Partial()),
                               run_check=False)
        got = d.redistribute(m, (Replicate(), Replicate())).to_local()
        return torch.equal(got, total(dtype))

    def dtensor_shard_to_replicate(dtype):
        full = torch.arange(16, device=dev).to(dtype)
        d = distribute_tensor(full, mesh(), (Replicate(), Shard(0)),
                              src_data_rank=None)
        return torch.equal(d.full_tensor(), full)

    def dtensor_vocab_embedding(dtype):
        table = torch.arange(64, device=dev).to(dtype).reshape(16, 4)
        d = distribute_tensor(table, mesh(), (Replicate(), Shard(0)),
                              src_data_rank=None)
        ids = DTensor.from_local(torch.tensor([[1, 9, 15]], device=dev),
                                 mesh(), (Replicate(), Replicate()),
                                 run_check=False)
        got = F.embedding(ids, d).full_tensor()
        return torch.equal(got, table[torch.tensor([[1, 9, 15]],
                                                   device=dev)])

    out = []
    for fn in (all_reduce, all_gather_into_tensor, funcol_all_reduce,
               funcol_all_gather, dtensor_partial_to_replicate,
               dtensor_shard_to_replicate, all_gather, broadcast,
               reduce_scatter_tensor):
        for dtype in DTYPES:
            out.append((f"{fn.__name__}:{dtype}",
                        lambda fn=fn, dtype=dtype: fn(getattr(torch, dtype))))
    for dtype in ("float32", "bfloat16"):
        out.append((f"dtensor_vocab_embedding:{dtype}",
                    lambda dtype=dtype: dtensor_vocab_embedding(
                        getattr(torch, dtype))))
    return out


def _run(torch, fn) -> str:
    try:
        ok = fn()
        torch.cuda.synchronize()
        return "ok" if ok else "wrong result"
    except Exception as e:      # the probe records what gloo refuses
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _rank(rank: int, init: str, tmp: str, skip: list) -> None:
    import faulthandler
    faulthandler.enable()       # a crashing case prints its stack
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    with open(os.path.join(tmp, f"rank{rank}.log"), "a") as log:
        for name, fn in _cases(torch, dist, rank):
            if name in skip:
                continue
            log.write(f"start\t{name}\n")
            log.flush()
            log.write(f"done\t{name}\t{_run(torch, fn)}\n")
            log.flush()
    dist.barrier()
    dist.destroy_process_group()


def _results(tmp: str) -> tuple:
    """Rank 0's results so far and the case it started and did not end."""
    res, started = {}, None
    path = os.path.join(tmp, "rank0.log")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                kind, name, *rest = line.rstrip("\n").split("\t")
                if kind == "start":
                    started = name
                else:
                    res[name], started = rest[0], None
    return res, started


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/gloo_probe.json")
    ap.add_argument("--timeout", type=float, default=180.0)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    deadline = time.monotonic() + args.timeout
    crashed: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(64):
            res, _ = _results(tmp)
            init = f"file://{os.path.join(tmp, f'rendezvous{attempt}')}"
            ctx = mp.start_processes(
                _rank, args=(init, tmp, sorted(set(res) | set(crashed))),
                nprocs=2, join=False, start_method="spawn")
            try:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > deadline:
                        for p in ctx.processes:
                            p.kill()
                        print(f"gloo_cuda_probe: cases not done after "
                              f"{args.timeout:.0f} s", file=sys.stderr)
                        return 1
                break
            except mp.ProcessExitedException as e:
                res, started = _results(tmp)
                if started is None:
                    raise
                crashed[started] = f"rank died: {str(e).splitlines()[0]}"
        res, _ = _results(tmp)
    res.update(crashed)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, sort_keys=True)
    print(json.dumps({"gloo_on_cuda": res, "torch": torch.__version__,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
