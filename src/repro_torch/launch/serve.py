"""Serving entry point on the continuous-batching engine
(``repro_torch.serve``).

The counterpart of ``repro/launch/serve.py``. Prompts are prefilled into
preallocated KV slots (the cache is built once at the full horizon) and
decoded in multi-token chunks, ``ceil(gen / chunk)`` decode dispatches
instead of one a token. It runs on the CUDA card; the host runs it only
when asked with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --batch 4 --prompt-len 64 --gen 32 [--pipeline 2] [--plan-db P]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --smoke --device cpu

Tensor-parallel serving over N cards, one rank a card (rank 0 prints):

  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.serve \\
      --arch yi-9b --mesh data,model=1,N
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine

#: REPRO_DTYPE_POLICY values -> ``torch.set_float32_matmul_precision``:
#: full fp32 matmuls, TF32 tensor cores, or bf16 passes for fp32 matmuls
DTYPE_POLICIES = {"f32": "highest", "tf32": "high", "bf16": "medium"}


def apply_runtime_policy(env: dict | None = None) -> dict:
    """Apply the launch environment's runtime policy to this process.

    ``REPRO_DTYPE_POLICY`` in {f32, tf32, bf16} sets PyTorch's fp32 matmul
    precision (:data:`DTYPE_POLICIES`); an unknown value raises, so that a
    mistyped policy never serves at a precision nobody asked for. Returns
    what was applied, for the launch banner.
    """
    env = os.environ if env is None else env
    applied = {}
    policy = env.get("REPRO_DTYPE_POLICY", "")
    if policy:
        prec = DTYPE_POLICIES.get(policy)
        if prec is None:
            raise ValueError(
                f"REPRO_DTYPE_POLICY={policy!r}: expected one of "
                f"{sorted(DTYPE_POLICIES)}")
        torch.set_float32_matmul_precision(prec)
        applied["dtype_policy"] = f"{policy} -> {prec}"
    return applied


def generate(cfg, params, prompt_tokens, gen_len: int, *,
             temperature: float = 0.0, seed: int = 0,
             chunk: int | None = None, machine: str | None = None,
             replicas: int = 1, engine_out: list | None = None,
             fault_tolerant: bool = False, pipeline: bool | int = 0,
             device="cuda", mesh=None) -> torch.Tensor:
    """Greedy or sampled batched generation; ``prompt_tokens`` (B, S).

    One slot a prompt, the whole batch admitted at once (one batched
    prefill), then decoded in chunks; returns the (B, ``gen_len``) tokens
    on the host. ``chunk=None`` plans the chunk from the port model
    (``serve.planner``, on ``machine``; an installed plan database answers
    first). ``replicas > 1`` splits the batch over N engines behind a
    round-robin ``ReplicaRouter``, and ``fault_tolerant=True`` takes the
    ``FaultTolerantRouter`` (the same results on a healthy fleet).
    ``pipeline`` sets the engines' in-flight decode rounds (the streams
    are the serial ones). ``mesh`` shards every engine over it (every
    rank of the mesh makes the same call). A list passed as
    ``engine_out`` receives the engines.
    """
    b, s = prompt_tokens.shape
    if chunk is None and gen_len > 1:
        from repro_torch.serve.planner import plan_chunk_size
        chunk = plan_chunk_size(cfg, b, s + gen_len, machine=machine,
                                max_chunk=min(32, gen_len - 1)).chunk
    replicas = max(1, int(replicas))
    slots = -(-b // replicas)
    engines = [ServeEngine(cfg, params, max_slots=slots,
                           max_len=s + gen_len,
                           chunk=min(chunk or 1, max(1, gen_len - 1)),
                           temperature=temperature, seed=seed,
                           pipeline=pipeline, device=device, mesh=mesh)
               for _ in range(replicas)]
    prompts = prompt_tokens.tolist()
    reqs = [Request(rid=str(i), prompt=tuple(int(t) for t in prompts[i]),
                    max_new_tokens=gen_len) for i in range(b)]
    if replicas == 1 and not fault_tolerant:
        results = engines[0].run(reqs)
    else:
        from repro_torch.serve import FaultTolerantRouter, ReplicaRouter
        cls = FaultTolerantRouter if fault_tolerant else ReplicaRouter
        results = cls(engines, policy="round_robin",
                      max_queue=max(8, b)).run(reqs)
    if engine_out is not None:
        engine_out.extend(engines)
    return torch.stack([torch.from_numpy(results[str(i)]) for i in range(b)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=0,
                    help="decode tokens per dispatch (0 = plan from the "
                         "port model's tier-resolved step cost)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="device mesh spec 'data,model=1,N' over the "
                         "world's ranks (torchrun --nproc-per-node N; "
                         "default: single-device, no mesh)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the round-robin router "
                         "(default 1: no router)")
    ap.add_argument("--fault-tolerant", action="store_true",
                    help="route through the health-tracking "
                         "FaultTolerantRouter")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="in-flight decode rounds per engine (0 = serial "
                         "dispatch; 2 = double-buffered); the token "
                         "streams are the same either way")
    ap.add_argument("--plan-db", default="",
                    help="a repro_torch.serve.plandb JSON database, "
                         "installed before planning (missing keys are "
                         "planned online, bit-identically)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda; the host "
                         "only when asked with --device cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.serve: no CUDA device; pass --device cpu "
              "to serve on the host", file=sys.stderr)
        return 2
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serve_mesh, rank_device
    started = not dist.is_initialized()
    try:
        mesh = make_serve_mesh(args.mesh, device_type=device.type)
    except (ValueError, RuntimeError) as e:     # a bad spec, too few ranks
        print(f"repro_torch.launch.serve: {e}", file=sys.stderr)
        return 2
    try:
        return _serve(args, device if mesh is None
                      else rank_device(device.type), mesh)
    finally:
        if mesh is not None and started:
            dist.destroy_process_group()


def _serve(args, device, mesh) -> int:
    """``main`` after the device and the mesh are settled; with a mesh
    every rank serves and rank 0 alone prints."""
    lead = mesh is None or mesh.get_rank() == 0

    def say(*a):
        if lead:
            print(*a)

    for k, v in sorted(apply_runtime_policy().items()):
        say(f"runtime policy: {k}: {v}")
    from repro_torch.serve import plandb
    from repro_torch.serve.planner import plan_stats, reset_plan_stats
    if args.plan_db:
        db = plandb.PlanDB.load(args.plan_db)
        plandb.install(db)
        say(f"plan db: {args.plan_db} ({len(db.chunks)} chunk plans, "
              f"{len(db.tiles)} tile plans)")
    reset_plan_stats()
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # params and prompts from independent generators: one stream for both
    # would correlate the prompt ids with the embedding init
    place = None
    if mesh is not None:
        # each rank keeps its shard of a leaf as it is made: the full
        # weights are never held at once
        from repro_torch.utils import sharding as shd
        place = shd.placer(mesh, M.param_pspecs(
            cfg, shd.SERVE_ENGINE_RULES, shd.mesh_axis_sizes(mesh)))
    params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device, place=place)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1))
    eng_out: list = []
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen,
                    temperature=args.temperature, seed=args.seed,
                    chunk=args.chunk or None, replicas=args.replicas,
                    engine_out=eng_out, fault_tolerant=args.fault_tolerant,
                    pipeline=args.pipeline, device=device, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    eng = eng_out[0]
    st = eng.stats()
    repl = f" x{len(eng_out)} replicas" if len(eng_out) > 1 else ""
    repl += f" tp={eng.tp}" if mesh is not None else ""
    pipe = f" pipeline={eng.pipeline}" if eng.pipeline else ""
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "host"
    say(f"generated {tuple(toks.shape)} on {where} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s): "
          f"{eng.decode_dispatches} decode dispatches (chunk={eng.chunk}) + "
          f"{eng.prefill_dispatches} prefill{repl}{pipe} | mean dispatch "
          f"gap {1e3 * st['mean_dispatch_gap_s']:.2f}ms")
    say(f"plan stats: {plan_stats()}")
    say("sample:", toks[0, :16].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
