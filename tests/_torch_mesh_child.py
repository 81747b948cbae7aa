"""Child process of ``test_torch_mesh_serve.py``: the port's engines on
2-rank gloo meshes on the CPU.

    python tests/_torch_mesh_child.py CASE PARAMS REQUESTS OUT

``CASE`` is ``dense12``, ``paged12``, ``dense21`` (the layout and the
``(data, model)`` mesh), ``world1`` (a world of one, mesh (1,1)),
``launch`` (``launch.serve.main`` with ``--mesh data,model=1,2``) or
``fig9`` (``bench.run --only fig9`` on the host); the last two take no
other argument and run their ranks as ``torchrun`` would.
``PARAMS`` is a ``torch.save`` of the smoke yi-9b weights (fp32, the
JAX package's, bridged), ``REQUESTS`` a JSON list of ``[rid, prompt,
max_new_tokens]``. Each rank serves the requests with and without the
mesh, greedy and at T=0.8, and records its streams, the first decode
step's logits, whether its local cache shards kept their storage, what
the engine refuses and what it once refused and now runs (a recurrent
config, pipelined dispatch, a snapshot); the ranks' records go to
``OUT`` (JSON) and ``OUT.logits.pt``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

SHAPES = {"dense12": (1, 2), "paged12": (1, 2), "dense21": (2, 1),
          "world1": (1, 1)}
LAUNCH_ARGV = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--batch",
               "2", "--prompt-len", "8", "--gen", "6", "--chunk", "2"]
FIG9_ARGV = ["--only", "fig9", "--device", "cpu"]


def _engine(serve, cfg, params, paged: bool, **kw):
    if paged:
        return serve.PagedServeEngine(cfg, params, page_size=4, max_slots=2,
                                      max_len=24, chunk=3, device="cpu", **kw)
    return serve.ServeEngine(cfg, params, max_slots=2, max_len=24, chunk=3,
                             device="cpu", **kw)


def _refusals(torch, serve, cfg, params, mesh) -> dict:
    """What an engine under ``mesh`` refuses, and what it once refused and
    now runs, by name: ``"ok"`` where the run gave what it should, else
    the exception's type and message (or ``"mismatch"``)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    out = {}

    def attempt(name, fn):
        try:
            out[name] = "ok" if fn() else "mismatch"
        except Exception as e:      # recorded for the parent to assert
            out[name] = f"{type(e).__name__}: {e}"
    attempt("indivisible_heads", lambda: serve.ServeEngine(
        dataclasses.replace(cfg, n_kv_heads=1), params, max_slots=2,
        max_len=24, chunk=3, device="cpu", mesh=mesh) is not None)
    xcfg = dataclasses.replace(get_smoke_config("xlstm-125m"),
                               param_dtype="float32")
    from repro_torch.models import model as M
    xparams = M.init_params(xcfg, torch.Generator().manual_seed(0), "cpu")
    reqs = [serve.Request(str(i), (i + 1, 2 * i + 3, 7), 5) for i in range(3)]

    def xlstm(m):
        return serve.ServeEngine(xcfg, xparams, max_slots=2, max_len=24,
                                 chunk=3, device="cpu", mesh=m).run(reqs)
    # the recurrent config streams as it does unsharded
    attempt("recurrent", lambda: _same(xlstm(mesh), xlstm(None)))
    attempt("pipeline", lambda: _same(
        _engine(serve, cfg, params, False, mesh=mesh, pipeline=2).run(reqs),
        _engine(serve, cfg, params, False, mesh=mesh).run(reqs)))
    eng = _engine(serve, cfg, params, False, mesh=mesh)
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        attempt("snapshot", lambda: eng.snapshot(ck, 0) is True)
        ck.wait()
    out["stage"] = eng.stage(serve.Request("s", (1, 2), 2))
    return out


def _same(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        list(map(int, a[r])) == list(map(int, b[r])) for r in a)


def _first_step_logits(torch, cfg, params, mesh):
    """Logits of one decode step after a batched prefill (2 prompts of 6
    tokens, seed 3), under ``mesh`` when given."""
    import contextlib
    import numpy as np
    from repro_torch.models import model as M
    from repro_torch.train import serve as serve_lib
    from repro_torch.utils import sharding as S
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)))
    ctx = contextlib.nullcontext() if mesh is None else \
        S.use_mesh_rules(mesh, S.SERVE_ENGINE_RULES)
    with ctx:
        if mesh is not None:
            params = S.distribute(params, mesh, M.param_pspecs(
                cfg, S.SERVE_ENGINE_RULES, S.mesh_axis_sizes(mesh)))
        logits, cache = serve_lib.make_prefill_step(cfg, cache_len=16)(
            params, {"tokens": toks})
        tok = logits[:, -1].argmax(-1)[:, None]
        lg, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=cache, pos=torch.full((2,), 6,
                                                         dtype=torch.int32),
                             kv_len=16)
    return logits[:, -1], lg[:, 0]


def _batches(torch, cfg, mesh) -> dict:
    """``device_put_batch`` and ``make_iterator(mesh=)`` against the
    numpy batch sliced by the spec on this rank."""
    import numpy as np
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import pipeline as P
    from repro_torch.train import step as ST
    from repro_torch.utils import sharding as S
    shape = ShapeSpec("t", 8, 4, "train")
    specs = ST.batch_pspecs(cfg, ST.batch_shapes(cfg, shape),
                            S.TRAIN_RULES, S.mesh_axis_sizes(mesh))
    host = P.host_batch(cfg, shape, P.SyntheticLM(cfg.vocab_size, 8, 5), 0)
    placed = P.device_put_batch(host, mesh, specs)
    n = mesh.shape[0]                 # the batch rows split over "data"
    r = mesh.get_coordinate()[0]
    ok = all(np.array_equal(placed[k].to_local().numpy(),
                            np.asarray(v)[r * 4 // n:(r + 1) * 4 // n])
             for k, v in host.items())
    it = next(P.make_iterator(cfg, shape, seed=5, mesh=mesh,
                              batch_specs=specs))
    same = all(np.array_equal(it[k].full_tensor().numpy(), np.asarray(v))
               for k, v in P.host_batch(
                   cfg, shape, P.SyntheticLM(cfg.vocab_size, 8, 5),
                   0).items())
    return {"shards_ok": bool(ok), "iterator_ok": bool(same),
            "specs": {k: list(v) for k, v in specs.items()}}


def _rank(rank: int, world: int, init: str, case: str, params_path: str,
          reqs_path: str, out: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import serve
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_serve_mesh, make_test_mesh
    from repro_torch.utils import sharding as S
    cfg = dataclasses.replace(get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = torch.load(params_path)
    with open(reqs_path) as f:
        reqs = [serve.Request(r, tuple(p), m) for r, p, m in json.load(f)]
    if case == "world1":
        mesh = make_serve_mesh("data,model=1,1", device_type="cpu")
    else:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        mesh = make_test_mesh(SHAPES[case], device_type="cpu")
    paged = case.startswith("paged")
    rec = {"rank": rank, "tp": None, "streams": {}}
    for temp in (0.0, 0.8):
        base = _engine(serve, cfg, params, paged,
                       temperature=temp).run(list(reqs))
        eng = _engine(serve, cfg, params, paged, temperature=temp,
                      mesh=mesh)
        rec["tp"] = eng.tp
        shards = [t.to_local() for _, t in _walk(eng.cache)]
        ptrs = [t.data_ptr() for t in shards]
        got = eng.run(list(reqs))
        rec["in_place"] = [t.to_local().data_ptr() for _, t in
                           _walk(eng.cache)] == ptrs
        rec["written"] = all(bool(t.abs().sum() > 0) for t in shards)
        rec["streams"][str(temp)] = {
            "mesh": {r: np.asarray(t).tolist() for r, t in got.items()},
            "none": {r: np.asarray(t).tolist() for r, t in base.items()}}
    rec["refusals"] = _refusals(torch, serve, cfg, params, mesh)
    if case != "world1":
        rec["batches"] = _batches(torch, cfg, mesh)
    pre, step = _first_step_logits(torch, cfg, params, mesh)
    pre0, step0 = _first_step_logits(torch, cfg, params, None)
    if rank == 0:
        torch.save({"prefill": pre, "step": step, "prefill_none": pre0,
                    "step_none": step0}, out + ".logits.pt")
    with open(f"{out}.rank{rank}", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _walk(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _launch_rank(rank: int, port: int, case: str) -> None:
    """One of two ranks from the environment ``torchrun`` sets, running
    ``launch.serve`` under a (1, 2) mesh or ``bench.run``'s fig9.

    The ranks write to one inherited stdout, which the parent parses: a
    rank's ``rank N exit rc`` line is printed only after a barrier that
    follows every line the run printed (rank 0's flushed first), so it
    never lands inside one of rank 0's lines. The group is made here, so
    the run takes it as it would take ``torchrun``'s."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    if case == "launch":
        from repro_torch.launch import serve
        rc = serve.main(LAUNCH_ARGV + ["--mesh", "data,model=1,2"])
    else:
        from repro_torch.bench import run
        rc = run.main(FIG9_ARGV)
    sys.stdout.flush()
    dist.barrier()
    print(f"rank {rank} exit {rc}", flush=True)
    dist.destroy_process_group()
    if rc:
        raise SystemExit(rc)


def main() -> int:
    import torch.multiprocessing as mp
    case = sys.argv[1]
    if case in ("launch", "fig9"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.start_processes(_launch_rank, args=(port, case), nprocs=2,
                           start_method="spawn")
        return 0
    params_path, reqs_path, out = sys.argv[2:5]
    world = SHAPES[case][0] * SHAPES[case][1]
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.start_processes(_rank, args=(world, init, case, params_path,
                                        reqs_path, out),
                           nprocs=world, start_method="spawn")
    ranks = []
    for r in range(world):
        with open(f"{out}.rank{r}") as f:
            ranks.append(json.load(f))
    with open(out, "w") as f:
        json.dump(ranks, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
