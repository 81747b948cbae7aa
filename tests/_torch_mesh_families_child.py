"""Child process of ``test_torch_mesh_families.py``: the recurrent, MoE
and embedding-input configs, and the engine features, on 2-rank gloo
meshes on the CPU.

    python tests/_torch_mesh_families_child.py CASES DIR

``CASES`` is a comma list of cases that share one mesh, run one after
another by the same two ranks (their start-up paid once): ``<arch>@<data>x
<model>`` (the config's engine streams, its prefill and decode logits
through ``forward``, its train step), or one of ``pipeline``,
``snapshot``, ``paged21`` and ``nt`` (the engine features, each at its
own mesh). ``DIR`` holds what the parent made, a ``torch.save`` an input
(``<arch>.pt``: the weights, requests, inputs and train state; ``nt.pt``);
``DIR/<case>.out`` (``.out.rank1``) gets a ``torch.save`` of what rank 0
(rank 1) saw. The ranks rendezvous through a file and spawn from this
process, so a hang is killed with it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

MAX_SLOTS, MAX_LEN, CHUNK, PAGE = 2, 24, 3, 4
CACHE_LEN = 16          # the forward path's cache rows
STEPS = 4               # the forward path's decode steps
SEQ_HORIZON = 48        # the sequence-sharded cache's rows (24 a rank)
FEATURE_MESH = {"pipeline": (1, 2), "snapshot": (1, 2), "paged21": (2, 1),
                "nt": (1, 2)}


def shape_of(case: str) -> tuple:
    if "@" in case:
        return tuple(int(n) for n in case.split("@")[1].split("x"))
    return FEATURE_MESH[case]


def input_of(case: str) -> str:
    """The name of a case's input file in ``DIR``."""
    if "@" in case:
        return case.split("@")[0] + ".pt"
    return "nt.pt" if case == "nt" else "jamba-v0.1-52b.pt"


def _cfg(arch: str):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32")


def _requests(serve, reqs) -> list:
    return [serve.Request(r, tuple(p), m) for r, p, m in reqs]


def _engine(serve, cfg, params, *, paged=False, **kw):
    if paged:
        return serve.PagedServeEngine(cfg, params, page_size=PAGE,
                                      max_slots=MAX_SLOTS, max_len=MAX_LEN,
                                      chunk=CHUNK, device="cpu", **kw)
    return serve.ServeEngine(cfg, params, max_slots=MAX_SLOTS,
                             max_len=MAX_LEN, chunk=CHUNK, device="cpu", **kw)


def _lists(res: dict) -> dict:
    import numpy as np
    return {r: np.asarray(t).tolist() for r, t in res.items()}


def _forward_stream(torch, cfg, params, inp: dict, mesh):
    """Prefill (``CACHE_LEN`` rows) then ``STEPS`` greedy decode steps
    through ``forward`` under ``mesh``'s engine rules: the logits of the
    prefill's last position and of each step, (1 + STEPS, B, V), and the
    tokens picked. An embedding-input model's steps take the frame
    embeddings ``inp["step_embeds"][t]``."""
    from repro_torch.models import model as M
    from repro_torch.train import serve as SV
    from repro_torch.utils import sharding as S
    batch = {"tokens": inp["prompts"]} if cfg.embed_inputs \
        else {"embeds": inp["embeds"]}
    b, s = batch[next(iter(batch))].shape[:2]
    with S.use_mesh_rules(mesh, S.SERVE_ENGINE_RULES):
        p = S.distribute(params, mesh, M.param_pspecs(
            cfg, S.SERVE_ENGINE_RULES, S.mesh_axis_sizes(mesh)))
        logits, cache = SV.make_prefill_step(cfg, cache_len=CACHE_LEN)(
            p, batch)
        lgs = [S.replicated(logits[:, -1])]
        toks = [lgs[-1].argmax(-1)]
        for t in range(STEPS):
            step = {"tokens": toks[-1][:, None]} if cfg.embed_inputs \
                else {"embeds": inp["step_embeds"][t]}
            lg, _, cache = M.forward(cfg, p, step, mode="decode",
                                     cache=cache,
                                     pos=torch.full((b,), s + t,
                                                    dtype=torch.int32),
                                     kv_len=CACHE_LEN)
            lgs.append(S.replicated(lg[:, 0]))
            toks.append(lgs[-1].argmax(-1))
    return torch.stack(lgs), torch.stack(toks, 1)


def _train(cfg, case: dict, mesh) -> dict:
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as ST
    from repro_torch.utils import sharding as S
    sizes = S.mesh_axis_sizes(mesh)
    oc = OptConfig(**case["opt"])
    st = S.distribute(case["state"], mesh,
                      ST.train_state_pspecs(cfg, S.TRAIN_RULES, sizes, oc))
    batch = S.distribute(case["batch"], mesh, ST.batch_pspecs(
        cfg, case["batch"], S.TRAIN_RULES, sizes))
    with S.use_mesh_rules(mesh, S.TRAIN_RULES):
        new, met = ST.make_train_step(cfg, oc, case["accum"])(st, batch)
    return {"metrics": {k: S.replicated(v) for k, v in met.items()},
            "params": _map(S.replicated, new["params"])}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _arch_case(torch, serve, inp: dict, mesh) -> dict:
    cfg = _cfg(inp["arch"])
    out = {}
    if cfg.embed_inputs:
        eng = _engine(serve, cfg, inp["params"], mesh=mesh)
        out["streams"] = _lists(eng.run(_requests(serve, inp["requests"])))
    out["logits"], out["tokens"] = _forward_stream(torch, cfg, inp["params"],
                                                   inp, mesh)
    out["train"] = _train(cfg, inp["train"], mesh)
    return out


def _pipeline_case(torch, serve, inp: dict, mesh) -> dict:
    """Serial and ``pipeline=2`` engines under the mesh, greedy and at
    T=0.8."""
    cfg = _cfg(inp["arch"])
    out = {}
    for temp in (0.0, 0.8):
        for depth in (0, 2):
            eng = _engine(serve, cfg, inp["params"], mesh=mesh,
                          temperature=temp, pipeline=depth)
            out[(temp, depth)] = _lists(eng.run(_requests(
                serve, inp["requests"])))
            out[(temp, depth, "stats")] = eng.stats()["pipeline"]
    return out


def _snapshot_case(torch, serve, inp: dict, mesh, tmp: str) -> dict:
    """A snapshot of the sharded engine's params; the skip agreed on when
    one rank's checkpointer is busy; the restores at mesh=None and at
    (2,1), and an engine serving from the (2,1) restore."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as S
    cfg = _cfg(inp["arch"])
    rank = mesh.get_rank()
    eng = _engine(serve, cfg, inp["params"], mesh=mesh)
    eng.run(_requests(serve, inp["requests"][:2]))
    ck = Checkpointer(os.path.join(tmp, "ckpt"))
    out = {"took": eng.snapshot(ck, 1)}
    ck.wait()
    torch.distributed.barrier()
    # rank 0 busy (a write in flight): every rank skips, none gathers
    busy = ck.busy
    ck.busy = (lambda: True) if rank == 0 else busy
    out["skipped"] = not eng.snapshot(ck, 2)
    ck.busy = busy
    out["steps"] = ck.all_steps()
    like = {"params": inp["params"]}
    whole = ck.restore(1, like)["params"]
    out["whole_equal"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        M._walk(whole), M._walk(inp["params"])))
    mesh21 = make_test_mesh((2, 1), device_type="cpu")
    specs = M.param_pspecs(cfg, S.SERVE_ENGINE_RULES,
                           S.mesh_axis_sizes(mesh21))
    placed = ck.restore(1, like, mesh21, {"params": specs})["params"]
    want = S.distribute(inp["params"], mesh21, specs)
    out["resharded_equal"] = all(
        tuple(a.placements) == tuple(b.placements)
        and torch.equal(a.to_local(), b.to_local())
        for (_, a), (_, b) in zip(M._walk(placed), M._walk(want)))
    eng21 = _engine(serve, cfg, whole, mesh=mesh21)
    out["streams21"] = _lists(eng21.run(_requests(serve, inp["requests"])))
    return out


def _paged_case(torch, serve, inp: dict, mesh) -> dict:
    """The paged engine with its slots over ``data``: the requests' streams,
    and a fork from a slot of one data shard into a slot of the other
    (the clone's recurrent state copied across the shards, its pages
    shared until its first write copies them), against mesh=None's; each
    rank's replica of every page pool after the run."""
    from repro_torch.models import model as M
    from repro_torch.serve import pages as PG
    cfg = _cfg(inp["arch"])
    reqs = _requests(serve, inp["requests"])
    out = {}
    for name, m in (("mesh", mesh), ("none", None)):
        eng = _engine(serve, cfg, inp["params"], paged=True, mesh=m)
        out[name] = _lists(eng.run(list(reqs)))
        eng = _engine(serve, cfg, inp["params"], paged=True, mesh=m)
        parent = serve.Request("p", reqs[1].prompt, 9)
        eng.admit(parent, 0)
        got = dict(eng.step())
        eng.fork("p", "f", 6)
        while any(s is not None for s in eng.slots):
            got.update(eng.step())
        out[name + "_fork"] = _lists(got)
        if m is not None:
            flags = PG.kv_leaf_flags(cfg)
            out["pools"] = [t.to_local().clone() for (_, f), (_, t) in zip(
                M._walk(flags), M._walk(eng.cache)) if f]
    return out


def _nt_case(torch, inp: dict, mesh) -> dict:
    """The decode cache sharded on its rows (``SERVE_RULES``): greedy
    steps with non-temporal row stores against the standard stores, and
    one step at positions only one rank owns a row of, each rank's shard
    before and after."""
    from repro_torch.models import model as M
    from repro_torch.train import serve as SV
    from repro_torch.utils import sharding as S
    out = {}
    for arch in ("yi-9b", "jamba-v0.1-52b"):
        cfg = _cfg(arch)
        params = inp["params"][arch]
        prompts = inp["seq_prompts"]
        b, s = prompts.shape
        res = {}
        with S.use_mesh_rules(mesh, S.SERVE_RULES):
            p = S.distribute(params, mesh, M.param_pspecs(
                cfg, S.SERVE_RULES, S.mesh_axis_sizes(mesh)))
            for flavor in ("standard", "nt"):
                logits, cache = SV.make_prefill_step(
                    cfg, cache_len=SEQ_HORIZON)(p, {"tokens": prompts})
                tok = logits[:, -1].argmax(-1)[:, None]
                toks, lgs = [tok], []
                for t in range(STEPS):
                    lg, _, cache = M.forward(
                        cfg, p, {"tokens": tok}, mode="decode", cache=cache,
                        pos=torch.full((b,), s + t, dtype=torch.int32),
                        store_flavor=flavor)
                    lgs.append(S.replicated(lg[:, 0]))
                    tok = lgs[-1].argmax(-1)[:, None]
                    toks.append(tok)
                res[flavor] = (torch.cat(toks, 1), torch.stack(lgs))
            kv = [n for n, d in M._walk(M.cache_defs(cfg, 1, 1))
                  if M.is_kv(d)]
            leaves = dict(M._walk(cache))
            before = [leaves[n].to_local().clone() for n in kv]
            own = torch.tensor([SEQ_HORIZON // 2 + 5, 3], dtype=torch.int32)
            M.forward(cfg, p, {"tokens": tok}, mode="decode", cache=cache,
                      pos=own, store_flavor="nt")
            after = [leaves[n].to_local().clone() for n in kv]
        out[arch] = {"streams": {f: r[0] for f, r in res.items()},
                     "logits": {f: r[1] for f, r in res.items()},
                     "before": before, "after": after,
                     "placements": [repr(x) for x in
                                    leaves[kv[0]].placements]}
    return out


def _rank(rank: int, world: int, init: str, cases: list, d: str,
          tmp: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import serve
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_test_mesh(shape_of(cases[0]), device_type="cpu")
    for case in cases:
        inp = torch.load(os.path.join(d, input_of(case)))
        if "@" in case:
            got = _arch_case(torch, serve, inp, mesh)
        elif case == "pipeline":
            got = _pipeline_case(torch, serve, inp, mesh)
        elif case == "snapshot":
            got = _snapshot_case(torch, serve, inp, mesh, tmp)
        elif case == "paged21":
            got = _paged_case(torch, serve, inp, mesh)
        else:
            got = _nt_case(torch, inp, mesh)
        out = os.path.join(d, f"{case}.out")
        torch.save(got, out if rank == 0 else out + ".rank1")
    dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp
    cases, d = sys.argv[1].split(","), sys.argv[2]
    assert len({shape_of(c) for c in cases}) == 1, cases
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.start_processes(_rank, args=(2, init, cases, d, tmp),
                           nprocs=2, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
