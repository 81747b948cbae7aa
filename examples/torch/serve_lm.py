"""Continuous-batching serving example on the PyTorch port: more requests
than slots, mixed prompt lengths and budgets, on gemma3-4b (its local
and global attention mix exercises both cache kinds). Requests are
admitted as slots free up; the KV slot cache is preallocated once and
written in place by the decode kernel (``flash_decode``, ``csrc/
decode.cu``), the chunk a CUDA-graph replay.

The counterpart of ``examples/serve_lm.py``. On the card it serves
gemma3-4b at its published width (34 layers, random bf16 weights from
seed 0); ``--smoke`` selects the reference's reduced config, the size
``--device cpu`` runs in a test. Without a card it exits 2 unless asked
for the host.

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--smoke] [--device cpu]
Replicated (2 engines behind the round-robin router):
      PYTHONPATH=src python examples/torch/serve_lm.py --replicas 2
Sharded (heads split over TP, one rank a card; rank 0 prints):
      PYTHONPATH=src torchrun --nproc-per-node 2 \\
          examples/torch/serve_lm.py --mesh data,model=1,2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.mesh import make_serve_mesh, rank_device
from repro_torch.models import model as M
from repro_torch.serve import ReplicaRouter, Request, ServeEngine

ARCH = "gemma3-4b"


def requests(vocab: int) -> list:
    """The reference's 6 requests: prompts of 24 or 16 tokens, budgets
    16 + 8 * (i % 3), 144 new tokens in all."""
    rng = np.random.default_rng(0)
    return [Request(rid=f"req{i}",
                    prompt=tuple(rng.integers(0, vocab, 16 if i % 2 else 24)),
                    max_new_tokens=16 + 8 * (i % 3))
            for i in range(6)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="",
                    help="device mesh spec 'data,model=1,N' over the "
                         "world's ranks (torchrun --nproc-per-node N; "
                         "default: single-device, no mesh)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the round-robin router")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of the published "
                         "width")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda; the host "
                         "only when asked with --device cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("serve_lm: no CUDA device; pass --device cpu to serve on "
              "the host", file=sys.stderr)
        return 2

    started = not dist.is_initialized()
    try:
        mesh = make_serve_mesh(args.mesh, device_type=device.type)
    except (ValueError, RuntimeError) as e:     # a bad spec, too few ranks
        print(f"serve_lm: {e}", file=sys.stderr)
        return 2
    try:
        if mesh is not None:
            device = rank_device(device.type)
        return _serve(args, device, mesh)
    finally:
        if mesh is not None and started:
            dist.destroy_process_group()


def _serve(args, device, mesh) -> int:
    """``main`` once the device and the mesh are settled; under a mesh
    every rank serves and rank 0 alone prints."""
    cfg = get_smoke_config(ARCH) if args.smoke else get_config(ARCH)
    place = None
    if mesh is not None:
        # each rank keeps its shard of a leaf as it is made
        from repro_torch.utils import sharding as shd
        place = shd.placer(mesh, M.param_pspecs(
            cfg, shd.SERVE_ENGINE_RULES, shd.mesh_axis_sizes(mesh)))
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device=device, place=place)
    reqs = requests(cfg.vocab_size)
    # a gloo group (two ranks on one card) cannot be captured in a CUDA
    # graph: over one the engines run their chunks eagerly
    graphs = mesh is None or dist.get_backend() != "gloo"
    engines = [ServeEngine(cfg, params, max_slots=2, max_len=64,
                           temperature=0.8, seed=0, mesh=mesh, device=device,
                           cuda_graphs=graphs)
               for _ in range(max(1, args.replicas))]
    eng = engines[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if len(engines) == 1:
        results = eng.run(list(reqs))
    else:
        results = ReplicaRouter(engines, policy="round_robin",
                                max_queue=len(reqs)).run(list(reqs))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.get_rank() != 0:
        return 0
    total = sum(len(v) for v in results.values())
    shard = f", tp={eng.tp}" if mesh is not None else ""
    shard += "" if graphs or device.type != "cuda" else ", eager (gloo)"
    repl = f", {len(engines)} replicas" if len(engines) > 1 else ""
    print(f"served {len(reqs)} requests on {eng.max_slots} slots: "
          f"{total} tokens in {dt:.2f}s — chunk={eng.chunk}, "
          f"{eng.decode_dispatches} decode dispatches, "
          f"{eng.prefill_dispatches} prefills{shard}{repl}")
    for r in reqs:
        print(f"  {r.rid}: {len(results[r.rid])} tokens, "
              f"first 8 = {results[r.rid][:8].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
