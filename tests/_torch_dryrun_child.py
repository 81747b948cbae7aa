"""Child process of ``test_torch_dryrun.py`` and ``test_torch_mesh_train.py``:
the port's dry run on fake process groups, and its sequence-sharded
decode and sharded train step on 2 gloo ranks on the CPU.

    python tests/_torch_dryrun_child.py CASE OUT [IN]

``CASE``:

* ``cells``: a fake world of 4, the smoke yi-9b's train, prefill and
  decode cells (``ShapeSpec(kind, 64, 4, kind)``) at a (2,2) ``cpu``
  mesh; their records go to ``OUT/<kind>.json``; with ``IN`` a comma
  list of archs, those archs' cells, to ``OUT/<arch>_<kind>.json``
  (yi-9b's as before).
* ``full``: a fake world of 256, one full-width yi-9b layer's
  ``decode_32k`` and ``train_4k`` records at 16x16 (``cpu`` mesh), to
  ``OUT/<shape>.json``.
* ``collectives``: a fake world of 256 on a 2x8x16 mesh; each collective
  kind, functional and c10d, lowered at group sizes 2, 16 and 256; the
  trace's ``CollectiveRecord``s go to ``OUT`` as JSON.
* ``mesh``: 2 gloo ranks, the sequence-sharded decode cases, then the
  sharded train step's; ``IN`` a ``torch.save`` of what the parent made
  (``{"decode": weights and prompts by arch, "train": states, batch and
  options}``), ``OUT`` (``OUT.rank1``) a ``torch.save`` of what rank 0
  (rank 1) saw.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

HORIZON = 48          # cache rows of the decode case (24 a rank)
STEPS = 6             # greedy decode steps


def _cells(out: str, archs: tuple = ("yi-9b",)) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2), device_type="cpu", fake=True)
    for arch in archs:
        cfg = get_smoke_config(arch)
        for kind in ("train", "prefill", "decode"):
            rec = D.run_cell(arch, {"train": "train_4k", "prefill":
                                    "prefill_32k", "decode":
                                    "decode_32k"}[kind],
                             cfg=cfg, mesh=mesh,
                             shape=ShapeSpec(kind, 64, 4, kind))
            name = kind if arch == "yi-9b" else f"{arch}_{kind}"
            if kind == "decode" and arch != "yi-9b":
                rec["xla_differs"] = _xla_differs(cfg, mesh)
            with open(os.path.join(out, f"{name}.json"), "w") as f:
                json.dump(rec, f)


def _xla_differs(cfg, mesh) -> dict:
    """The bytes a rank of two decode arguments whose count XLA's memory
    analysis makes differ from the port's: the position ``pos``, which
    XLA prunes where no layer reads it, and the conv state's cache
    leaves, which the port writes in place (aliased) and the reference
    hands back in the compute dtype as a new buffer (``conv_out``: their
    bytes at that dtype)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    _, args, _, _ = D.lower_cell(cfg, ShapeSpec("decode", 64, 4, "decode"),
                                 mesh)
    conv = [leaf for path, leaf in M._walk(args[1]) if path[-1] == "conv"]
    n = D.local_bytes(conv)
    itemsize = M.DTYPES[cfg.param_dtype].itemsize
    return {"pos": D.local_bytes(args[3]), "conv": n,
            "conv_out": sum(D.local_bytes([c]) // c.element_size()
                            for c in conv) * itemsize}


def _full(out: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(device_type="cpu", fake=True)
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=1)
    for shape in ("decode_32k", "train_4k"):
        rec = D.run_cell("yi-9b", shape, cfg=cfg, mesh=mesh)
        with open(os.path.join(out, f"{shape}.json"), "w") as f:
            json.dump(rec, f)


def _collectives(out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.core import trace as T
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 8, 16), ("pod", "data", "model"),
                          device_type="cpu", fake=True)
    groups = {2: mesh.get_group(0), 16: mesh.get_group(2),
              256: dist.group.WORLD}
    n = 4096

    def step(g, pg):
        x = torch.empty((n,), dtype=torch.float32, device="meta")
        funcol.all_reduce(x, "sum", pg) + 1
        funcol.all_gather_tensor(x, 0, pg) + 1
        funcol.reduce_scatter_tensor(x, "sum", 0, pg) + 1
        funcol.all_to_all_single(x, None, None, pg) + 1
        y = torch.empty((n,), dtype=torch.float32, device="meta")
        dist.all_reduce(y, group=pg)
        big = torch.empty((n * g,), dtype=torch.float32, device="meta")
        dist.all_gather_into_tensor(big, x, group=pg)
        small = torch.empty((n // g,), dtype=torch.float32, device="meta")
        dist.reduce_scatter_tensor(small, x, group=pg)
        z = torch.empty((n,), dtype=torch.float32, device="meta")
        dist.all_to_all_single(z, x, group=pg)
    recs = []
    for g, pg in groups.items():
        tr = T.lower_call(step, (g, pg))
        recs += [dataclasses.asdict(c) for c in tr.collectives]
        recs += [{"op": op.opcode, "uops": [list(u) for u in op.uops],
                  "coll_bytes": op.coll_bytes, "coll_kind": op.coll_kind,
                  "group": g} for op in tr.entry.ops if op.coll_kind]
    with open(out, "w") as f:
        json.dump(recs, f)


def _mesh_rank(rank: int, init: str, path: str, out: str) -> None:
    """One of the 2 ranks: the decode cases, then the train cases."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    case = torch.load(path)
    got = {"decode": _decode(torch, case["decode"]),
           "train": _train(torch, case["train"])}
    torch.save(got, out if rank == 0 else out + ".rank1")
    dist.destroy_process_group()


def _decode(torch, cases: dict) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.train import serve as SV
    from repro_torch.utils import sharding as S
    mesh = make_test_mesh((1, 2), device_type="cpu")
    got = {}
    for arch, case in cases.items():
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  param_dtype="float32")
        with S.use_mesh_rules(mesh, S.SERVE_RULES):
            p = S.distribute(case["params"], mesh, M.param_pspecs(
                cfg, S.SERVE_RULES, S.mesh_axis_sizes(mesh)))
            logits, cache = SV.make_prefill_step(cfg, cache_len=HORIZON)(
                p, {"tokens": case["prompts"]})
            k0 = cache["scan"]["0"]["k"]
            placements = [repr(x) for x in k0.placements]
            tok = logits[:, -1].argmax(-1)[:, None]
            pos = torch.full((tok.shape[0],), case["prompts"].shape[1],
                             dtype=torch.int32)
            toks, lgs = [tok], []
            step = SV.make_decode_step(cfg)
            for _ in range(STEPS):
                lg, cache = step(p, cache, {"tokens": tok}, pos)
                lgs.append(lg)
                tok = lg.argmax(-1)[:, None]
                toks.append(tok)
                pos = pos + 1
            whole = {n: S.replicated(t) for n, t in
                     cache["scan"]["0"].items()}
            # the owner-only write: slot 0 at a row of shard 1, slot 1 at
            # a row of shard 0; every other row of each shard unchanged
            before = [S.local(cache)["scan"]["0"][n].clone()
                      for n in ("k", "v")]
            own_pos = torch.tensor([HORIZON // 2 + 5, 3], dtype=torch.int32)
            step(p, cache, {"tokens": tok}, own_pos)
            after = [S.local(cache)["scan"]["0"][n].clone()
                     for n in ("k", "v")]
            # the same step with non-temporal stores, from the shards as
            # they were before it: the owners' rows alone are written
            for b, n in zip(before, ("k", "v")):
                S.local(cache)["scan"]["0"][n].copy_(b)
            M.forward(cfg, p, {"tokens": tok}, mode="decode", cache=cache,
                      pos=own_pos, store_flavor="nt")
            nt_after = [S.local(cache)["scan"]["0"][n].clone()
                        for n in ("k", "v")]
            got[arch] = {
                "placements": placements,
                "streams": torch.cat(toks, 1), "logits": torch.stack(lgs),
                "cache": whole, "before": before, "after": after,
                "nt_after": nt_after}
    return got


def _train(torch, case: dict) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as ST
    from repro_torch.utils import sharding as S
    cfg = dataclasses.replace(get_smoke_config("yi-9b"),
                              param_dtype="float32")
    got = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_test_mesh(shape, device_type="cpu")
        sizes = S.mesh_axis_sizes(mesh)
        for moments, state in case["states"].items():
            oc = OptConfig(**case["opt"], moments_dtype=moments)
            fn = ST.make_train_step(cfg, oc, case["accum"])
            st = S.distribute(state, mesh, ST.train_state_pspecs(
                cfg, S.TRAIN_RULES, sizes, oc))
            batch = S.distribute(case["batch"], mesh, ST.batch_pspecs(
                cfg, case["batch"], S.TRAIN_RULES, sizes))
            with S.use_mesh_rules(mesh, S.TRAIN_RULES):
                new, met = fn(st, batch)
            whole = {k: S.replicated(v) for k, v in met.items()}
            params = _map(S.replicated, new["params"])
            got[f"{shape[0]}x{shape[1]}_{moments}"] = {
                "metrics": whole, "params": params,
                "step": S.replicated(new["step"])}
    return got


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main() -> int:
    case, out = sys.argv[1], sys.argv[2]
    if case == "cells":
        _cells(out, *([tuple(sys.argv[3].split(","))] if len(sys.argv) > 3
                      else []))
    elif case == "full":
        _full(out)
    elif case == "collectives":
        _collectives(out)
    else:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            init = f"file://{os.path.join(tmp, 'rendezvous')}"
            mp.start_processes(_mesh_rank, args=(init, sys.argv[3], out),
                               nprocs=2, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
