"""Multi-pod dry run: lower every (architecture x input-shape) cell on the
production meshes and record memory, cost, collective and port-model
metrics (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's jitted step for 256 or 512
placeholder host devices and reads XLA's memory and cost analyses. The
port lowers each cell's step as one rank's program: the mesh stands on a
fake process group (``launch.mesh.start_fake_world``, this process rank
0 of 256 or 512), the state, the cache and the batch are DTensors of
meta tensors laid out by the reference's spec builders, and
``core.trace.lower_call`` records the ATen ops that DTensor dispatches on
the rank's shards, its collectives among them, with the attention's
plain version (``impl="ref"``) and each decode kernel one inline region
(as ``serve/planner.py`` lowers a step). Nothing is compiled
(``compile_s`` is 0) and nothing is materialized.

A record keeps the reference's keys. ``memory``: the local shard bytes
of the step's inputs (``argument_bytes``) and outputs (``output_bytes``,
plus the 8-byte entry of XLA's output tuple a leaf, as the reference's
counts it), what the step writes in place or hands back in its inputs'
stead (``alias_bytes``: the decode cache; the train state), and from the
trace's live-storage tracker (``Trace.memory``, not XLA's temp) the most
bytes the step holds at once beyond its arguments; ``peak_bytes`` is
the arguments plus that. ``cost`` comes from the trace: FLOPs (and the
matrix products' alone), HBM bytes, transcendental elements, each loop
body times its trips. ``collectives``: count and bytes (what each
returns or writes) by kind, with the group sizes. ``portmodel``: the
trace priced by ``portmodel.analyze`` on ``--machine`` (``h100``).
``wa``: ``wa.analyze_trace_stores``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k [--multi-pod] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --both-meshes --out results/dryrun_torch

The mesh's device type is the card's (``--device cuda``, the default:
DTensor picks what NCCL runs; without a card the CLI exits 2), or the
host's (``--device cpu``: gloo has no all-to-all, so DTensor gathers and
cuts instead). Every configuration lowers: the recurrent mixers and the
MoE experts run on each rank's shards (``models.model``), an sLSTM's
steps as one loop body (``utils.loops.repeat``). A cell that fails
writes a ``.err`` and counts as a failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, shapes_for
from repro_torch.kernels import pos_vector
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import serve as serve_lib
from repro_torch.train import step as step_lib
from repro_torch.utils import sharding as S
from repro_torch.utils.loops import repeat

#: the live-storage tracker behind ``temp_bytes`` and ``peak_bytes``
TRACKER = ("core.trace.lower_call(memory=True): storages made during the "
           "step alive at once; not XLA's temp")
#: bytes of one entry of XLA's output tuple, which its output size counts
TUPLE_ENTRY = 8


def input_specs(arch: str, shape_name: str) -> dict:
    """Meta-tensor stand-ins for every model input of a cell."""
    return step_lib.batch_shapes(get_config(arch), SHAPES[shape_name])


def _placed(shapes, specs, mesh):
    """A tree of meta tensors (or ``(shape, dtype)`` leaves) as meta
    DTensors laid out by the matching spec tree."""
    if isinstance(shapes, dict):
        return {k: _placed(v, specs[k], mesh) for k, v in shapes.items()}
    shape, dtype = (tuple(shapes.shape), shapes.dtype) \
        if isinstance(shapes, torch.Tensor) else shapes
    return S.zeros(shape, dtype, mesh, specs, "meta")


def serve_rules(cfg: ModelConfig, mesh_sizes: dict,
                serve_variant: str = "resident2d") -> tuple:
    """``(rules, fsdp)``: the reference's rules table for a serve cell."""
    fsdp = serve_lib.serve_uses_fsdp(cfg, tp=mesh_sizes.get("model", 1))
    if not fsdp:
        return S.SERVE_RULES, False
    if serve_variant == "gather":
        return S.SERVE_FSDP_GATHER_RULES, True
    return S.SERVE_FSDP_RULES, True


def _decode_loop(cfg: ModelConfig, n_tokens: int, gather_logits: bool):
    """``loop(params, cache, batch, pos) -> (toks, cache)``: ``n_tokens``
    greedy decode steps, a :func:`repeat` loop (one body of ``n_tokens``
    trips in a lowering), as the reference's in-graph decode loop."""
    def loop(params, cache, batch, pos):
        tok = batch["tokens"]
        b = tok.shape[0]
        c = {"tok": tok, "pos": pos_vector(pos, b, tok.device)}
        toks = torch.zeros((b, n_tokens), dtype=torch.int64,
                           device=tok.device)

        def step(t):
            logits, _, _ = M.forward(cfg, params, {"tokens": c["tok"]},
                                     mode="decode", cache=cache,
                                     pos=c["pos"], impl="ref",
                                     gather_logits=gather_logits)
            nxt = S.replicated(logits[:, 0]).argmax(-1)
            toks[:, t] = nxt
            c["tok"], c["pos"] = nxt[:, None], c["pos"] + 1
        repeat(n_tokens, step)
        return toks, cache
    return loop


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               oc: OptConfig | None = None, decode_loop: int = 0,
               serve_variant: str = "resident2d", rules: dict | None = None,
               gather_logits: bool = False):
    """``(fn, args, rules, meta)`` of one (arch x shape x mesh) cell:
    the step, its meta-DTensor arguments on ``mesh``, the rules table to
    install and the record's metadata. ``rules`` overrides a serve
    cell's table (the engines' ``SERVE_ENGINE_RULES``);
    ``gather_logits`` gathers a serve step's logits whole on every rank,
    as the engines' sampler takes them (the reference leaves them on
    their layout)."""
    sizes = S.mesh_axis_sizes(mesh)
    if shape.kind == "train":
        rules = S.TRAIN_RULES
        accum = step_lib.default_accum_steps(cfg, shape, sizes)
        oc = oc or OptConfig()
        fn = step_lib.make_train_step(cfg, oc, accum)
        state = _placed(step_lib.train_state_shapes(cfg, oc),
                        step_lib.train_state_pspecs(cfg, rules, sizes, oc),
                        mesh)
        bshapes = step_lib.batch_shapes(cfg, shape)
        batch = _placed(bshapes, step_lib.batch_pspecs(cfg, bshapes, rules,
                                                       sizes), mesh)
        meta = {"accum_steps": accum, "rules": "train",
                "moments": oc.moments_dtype}
        return fn, (state, batch), rules, meta

    fsdp = serve_lib.serve_uses_fsdp(cfg, tp=sizes.get("model", 1))
    if rules is None:
        rules, fsdp = serve_rules(cfg, sizes, serve_variant)
        meta = {"serve_fsdp": fsdp, "rules": "serve_fsdp" if fsdp
                else "serve"}
    else:
        meta = {"serve_fsdp": fsdp, "rules": "given"}
    params = _placed(M.param_shapes(cfg), M.param_pspecs(cfg, rules, sizes),
                     mesh)
    bshapes = step_lib.batch_shapes(cfg, shape)
    batch = _placed(bshapes, step_lib.batch_pspecs(cfg, bshapes, rules,
                                                   sizes), mesh)
    if shape.kind == "prefill":
        def prefill(params, batch):
            logits, _, cache = M.forward(cfg, params, batch, mode="prefill",
                                         gather_logits=gather_logits)
            return logits, cache
        return prefill, (params, batch), rules, meta

    cache = _placed(M.cache_shapes(cfg, shape.global_batch, shape.seq_len),
                    M.cache_pspecs(cfg, rules, sizes, shape.global_batch,
                                   shape.seq_len), mesh)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    if decode_loop and cfg.embed_inputs:
        meta["decode_loop"] = decode_loop
        return (_decode_loop(cfg, decode_loop, gather_logits),
                (params, cache, batch, pos), rules, meta)

    def decode(params, cache, batch, pos):
        logits, _, cache = M.forward(cfg, params, batch, mode="decode",
                                     cache=cache, pos=pos, impl="ref",
                                     gather_logits=gather_logits)
        return logits[:, 0], cache
    return decode, (params, cache, batch, pos), rules, meta


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor of ``tree``."""
    total = 0
    for t in _leaves(tree):
        loc = t.to_local() if S.is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def _ops(region, mult: int = 1, in_kernel: bool = False):
    """``(op, times it runs, inside a kernel region)`` of every op."""
    for op in region.ops:
        if op.kind == "loop" and op.region is not None:
            yield from _ops(op.region, mult * op.trips, in_kernel)
        elif op.kind == "inline" and op.region is not None:
            yield from _ops(op.region, mult, True)
        elif op.kind == "op":
            yield op, mult, in_kernel


def trace_cost(trace) -> dict:
    """FLOPs of the trace, all ops and the matrix products (``mxu``)
    alone, and those outside kernel regions; transcendental elements
    (``xlu``); each loop body times its trips."""
    flops = mm = mm_out = trans = 0.0
    for op, n, in_kernel in _ops(trace.entry):
        flops += op.flops * n
        classes = {c for c, _ in op.uops}
        if "mxu" in classes:
            mm += op.flops * n
            if not in_kernel:
                mm_out += op.flops * n
        elif "xlu" in classes:
            trans += op.flops * n
    return {"flops": flops, "matmul_flops": mm,
            "matmul_flops_outside_kernels": mm_out, "transcendentals": trans}


def collectives_by_kind(trace) -> dict:
    """``{kind: {"count", "bytes", "wire_bytes", "groups"}}`` of a trace's
    collectives, each times the trips of the loops around it: ``bytes``
    what each returns or writes (the reference's sum of result bytes),
    ``wire_bytes`` its ring traffic a rank, ``groups`` the group sizes."""
    out: dict = {}
    for c in trace.collectives:
        rec = out.setdefault(c.kind, {"count": 0, "bytes": 0.0,
                                      "wire_bytes": 0.0, "groups": set()})
        rec["count"] += c.count
        rec["bytes"] += c.payload * c.count
        rec["wire_bytes"] += c.wire * c.count
        rec["groups"].add(c.group)
    for rec in out.values():
        rec["groups"] = sorted(rec["groups"])
    return out


def record_of(trace, args, out, *, kind: str, machine: str = "h100") -> dict:
    """The ``memory``, ``cost``, ``collectives``, ``portmodel``, ``wa``
    and ``wa_ratio`` fields of a lowered step (see the module
    docstring)."""
    from repro_torch.core import portmodel, wa
    from repro_torch.core.machine import MACHINES
    arg_b = local_bytes(args)
    out_leaves = _leaves(out)
    out_b = local_bytes(out) + TUPLE_ENTRY * len(out_leaves)
    if kind == "train":
        alias = local_bytes(out[0])
    elif kind == "decode":
        alias = local_bytes(args[1])
    else:
        alias = 0
    held = trace.memory["peak_bytes"]
    rec = {"memory": {
        "argument_bytes": arg_b, "output_bytes": out_b,
        "temp_bytes": max(0, int(held) - local_bytes(out)),
        "alias_bytes": alias, "peak_bytes": int(arg_b + held),
        "tracker": TRACKER}}
    rec["cost"] = dict(trace_cost(trace))
    rep = portmodel.analyze(trace, MACHINES[machine])
    rec["cost"]["bytes_accessed"] = rep.bytes_hbm
    rec["collectives"] = collectives_by_kind(trace)
    rec["portmodel"] = {
        "machine": machine,
        "tp_cycles": rep.tp_cycles, "cp_cycles": rep.cp_cycles,
        "serial_cycles": rep.serial_cycles, "flops": rep.flops,
        "bytes_hbm": rep.bytes_hbm, "coll_bytes": dict(rep.coll_bytes),
        "bottleneck": rep.bottleneck(), "unknown_ops": rep.unknown_ops,
        "n_instrs": rep.n_instrs,
        "trips": {k: v for k, v in sorted(rep.trips_seen.items())[:16]},
        "top_ports": dict(sorted(rep.port_occupation.items(),
                                 key=lambda kv: -kv[1])[:6]),
        # every loop: the port unrolls the layers, so the attention loops
        # of all of them stand here (the reference keeps its top 12)
        "loop_bytes": {k: list(v) for k, v in sorted(
            rep.loop_bytes.items(), key=lambda kv: -(kv[1][0] * kv[1][1]))},
    }
    rec["wa"] = wa.analyze_trace_stores(trace)
    rec["wa_ratio"] = rec["wa"]["wa_ratio"]
    return rec


def lower(cfg: ModelConfig, shape: ShapeSpec, mesh, **kw):
    """Lower one cell on ``mesh``: ``(trace, args, out, rules, meta,
    seconds)``."""
    from repro_torch.core import trace as trace_lib
    t0 = time.time()
    fn, args, rules, meta = lower_cell(cfg, shape, mesh, **kw)
    with S.use_mesh_rules(mesh, rules):
        tr = trace_lib.lower_call(fn, args, stores=True, memory=True,
                                  keep_result=True)
    return tr, args, tr.result, rules, meta, time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             cfg: ModelConfig | None = None, mesh=None,
             device_type: str = "cuda", machine: str = "h100",
             oc: OptConfig | None = None, decode_loop: int = 0,
             serve_variant: str = "resident2d", shape: ShapeSpec | None = None,
             rules: dict | None = None, gather_logits: bool = False) -> dict:
    """Lower one cell; return its record. ``mesh`` defaults to the
    production mesh on a fake world (``device_type``); ``shape``
    overrides the named shape."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type, fake=True)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mesh.shape)),
           "n_devices": mesh.size(), "device_type": mesh.device_type}
    tr, args, out, _, meta, secs = lower(
        cfg, shape, mesh, oc=oc, decode_loop=decode_loop,
        serve_variant=serve_variant, rules=rules,
        gather_logits=gather_logits)
    rec.update(meta)
    rec["lower_s"] = round(secs, 2)
    rec["compile_s"] = 0.0
    rec["compile"] = "none: the step runs as eager ATen ops"
    rec.update(record_of(tr, args, out, kind=shape.kind, machine=machine))
    rec["n_ops"] = tr.n_ops()
    return rec


def summary(rec: dict) -> str:
    """One line of a record: peak GB a rank, FLOPs a rank, collectives."""
    coll = " ".join(f"{k}={v['count']}x{v['bytes']/1e9:.3f}GB"
                    for k, v in sorted(rec["collectives"].items()))
    return (f"peak {rec['memory']['peak_bytes']/1e9:.2f} GB/dev, "
            f"flops/dev {rec['cost']['flops']:.3e}, lower {rec['lower_s']}s; "
            f"{coll or 'no collectives'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (default; DTensor "
                         "picks NCCL's collectives) or cpu")
    ap.add_argument("--machine", default="h100",
                    help="machine file the port model prices on")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.launch.dryrun: no CUDA device; pass --device "
              "cpu to lower on a host mesh", file=sys.stderr)
        return 2
    if args.all:
        cells = [(arch, sh.name) for arch in ARCH_IDS
                 for sh in shapes_for(get_config(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()
    if args.both_meshes:
        # one fake world a process: each mesh's cells in a child
        failures = sum(_child(argv if argv is not None else sys.argv[1:], mp)
                       for mp in (False, True))
    else:
        failures = sum(_one(args, arch, sh, args.multi_pod)
                       for arch, sh in cells)
    print(f"done; {failures} failures; {time.time() - t_all:.1f} s",
          flush=True)
    return 1 if failures else 0


def _one(args, arch: str, sh: str, mp: bool) -> int:
    tag = f"{arch}_{sh}_{'mp' if mp else 'sp'}"
    path = os.path.join(args.out, tag + ".json")
    if os.path.exists(path):
        print(f"[skip] {tag} (cached)", flush=True)
        return 0
    try:
        rec = run_cell(arch, sh, multi_pod=mp, device_type=args.device,
                       machine=args.machine)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[ok]   {tag}: {summary(rec)}", flush=True)
        return 0
    except Exception as e:  # noqa: BLE001 — the sweep must survive
        print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        with open(os.path.join(args.out, tag + ".err"), "w") as f:
            f.write(traceback.format_exc())
        return 1


def _child(argv: list, mp: bool) -> int:
    """Run this CLI for one mesh in a child process (a process holds one
    fake world); returns its failures."""
    import subprocess
    argv = [a for a in argv if a not in ("--both-meshes", "--multi-pod")]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun"]
                         + argv + (["--multi-pod"] if mp else []),
                         env=dict(os.environ), text=True, stdout=subprocess.PIPE)
    failures = 0
    for line in res.stdout.splitlines():
        if line.startswith("done;"):
            failures = int(line.split()[1])
        else:
            print(line, flush=True)
    return failures if res.returncode in (0, 1) else max(failures, 1)


if __name__ == "__main__":
    sys.exit(main())
