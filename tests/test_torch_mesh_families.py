"""The recurrent, MoE and embedding-input configs under a mesh, and the
engine features a mesh used to refuse, on 2-rank gloo meshes on the CPU,
against the JAX package's unsharded engine and steps.

Smoke configs in fp32, one set of weights each shared with the reference
(``_torch_train.shared_params``). The cases run in three
``_torch_mesh_families_child.py`` processes (:data:`GROUPS`, the cases of
one mesh each, so a pair of ranks starts once for several), which spawn
the ranks, under a time limit; every child starts at once, and the JAX
references run while they do. Held, for xlstm-125m, jamba, grok-1,
qwen3-moe and musicgen-large at (1,2) and (2,1): greedy engine streams
identical to the JAX unsharded engine's (musicgen-large, which no engine
serves, its greedy picks through ``forward`` with frame embeddings fed at
each step); the prefill's and first decode step's logits within 1e-5 of
the largest; the train step (2 microbatches, AdamW) as
``test_torch_mesh_train.py`` holds it. Then: ``pipeline=2`` streams equal
to serial ones under the mesh (greedy and sampled); a snapshot of a
(1,2) engine restored at mesh=None and at (2,1) to the same tensors, the
ranks agreeing on a skip; the paged engine with its slots over ``data``
streaming as mesh=None, a fork across the data shards, one pool on
every rank; non-temporal row stores on a sequence-sharded cache writing
their owners' rows alone and streaming as the standard stores.
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.models import model as JM
from repro.optim.adamw import OptConfig as JOpt
from repro.optim.adamw import init_opt_state
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import serve as jax_serve
from repro.train import step as JS
from repro_torch.models import bridge
from repro_torch.models import model as M

from _torch_common import cfg_pair, f32

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_mesh_families_child.py")
sys.path.insert(0, HERE)
import _torch_mesh_families_child as C  # noqa: E402

TIME_LIMIT = 300            # seconds every child (and its ranks) may take
LOGIT_TOL = 1e-5            # of the largest logit, fp32
ARCHS = ("xlstm-125m", "jamba-v0.1-52b", "grok-1-314b",
         "qwen3-moe-235b-a22b", "musicgen-large")
MESHES = ("1x2", "2x1")
B, S, ACCUM = 4, 16, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
# (prompt length, max_new_tokens): 4 requests on 2 slots, later ones
# admitted mid-flight, a 1-token budget among them
SPECS = [(6, 7), (9, 5), (5, 1), (6, 6)]
#: the cases by child process: each child's run one mesh's
GROUPS = ([f"{a}@1x2" for a in ARCHS],
          [f"{a}@2x1" for a in ARCHS] + ["paged21"],
          ["pipeline", "snapshot", "nt"])


def _inputs(arch: str) -> dict:
    """The child's inputs and the JAX side of one config: weights, the
    requests, the forward path's prompts (or frame embeddings), the train
    state and batch."""
    cj, ct = cfg_pair("float32", arch)
    pj, pt = TT.shared_params(ct)
    rng = np.random.default_rng(7)
    reqs = [(str(i), [int(t) for t in rng.integers(0, ct.vocab_size, n)],
             m) for i, (n, m) in enumerate(SPECS)]
    inp = {"arch": arch, "params": pt, "requests": reqs}
    if ct.embed_inputs:
        inp["prompts"] = torch.tensor(rng.integers(0, ct.vocab_size, (2, 6)))
    else:
        inp["embeds"] = torch.tensor(rng.standard_normal(
            (2, 6, ct.d_model)).astype(np.float32))
        inp["step_embeds"] = torch.tensor(rng.standard_normal(
            (C.STEPS, 2, 1, ct.d_model)).astype(np.float32))
    batch = TT.train_batch(cj, B, S, seed=10)
    sj = {"params": pj, "opt": init_opt_state(pj, "float32"),
          "step": jnp.zeros((), jnp.int32)}
    inp["train"] = {"state": bridge.train_state_from_jax(
        jax.tree.map(np.asarray, sj), ct, device="cpu"),
        "batch": TT.torch_batch(batch), "opt": OPT, "accum": ACCUM}
    return inp, (cj, pj, sj, batch)


def _jax_forward(cj, pj, inp: dict) -> tuple:
    """The reference's prefill and greedy decode steps, as the child's
    ``_forward_stream`` runs them."""
    batch = {"tokens": jnp.asarray(inp["prompts"].numpy())} \
        if cj.embed_inputs else {"embeds": jnp.asarray(inp["embeds"].numpy())}
    b, s = next(iter(batch.values())).shape[:2]
    logits, cache = jax.jit(jax_serve.make_prefill_step(
        cj, cache_len=C.CACHE_LEN))(pj, batch)
    step = jax.jit(lambda p, c, x, pos: JM.forward(
        cj, p, x, mode="decode", cache=c, pos=pos, attn_impl="ref"))
    lgs = [np.asarray(logits[:, -1], np.float32)]
    toks = [lgs[-1].argmax(-1)]
    for t in range(C.STEPS):
        x = {"tokens": jnp.asarray(toks[-1][:, None])} if cj.embed_inputs \
            else {"embeds": jnp.asarray(inp["step_embeds"][t].numpy())}
        lg, _, cache = step(pj, cache, x, jnp.full((b,), s + t, jnp.int32))
        lgs.append(np.asarray(lg[:, 0], np.float32))
        toks.append(lgs[-1].argmax(-1))
    return np.stack(lgs), np.stack(toks, 1)


def _jax_streams(cj, pj, reqs) -> dict:
    jreqs = [JRequest(r, tuple(p), m) for r, p, m in reqs]
    eng = JServeEngine(cj, pj, max_slots=C.MAX_SLOTS, max_len=C.MAX_LEN,
                       chunk=C.CHUNK)
    return {r: np.asarray(t).tolist() for r, t in eng.run(jreqs).items()}


def _start(args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("WORLD_SIZE", None)
    return subprocess.Popen([sys.executable, CHILD, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, start_new_session=True)


def _wait(p: subprocess.Popen, deadline: float) -> str:
    """The child's stderr by ``deadline``; on a hang its process group
    (its ranks too) is killed."""
    try:
        _, err = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        return f"ran past {TIME_LIMIT} s"
    return "" if p.returncode == 0 else f"exit {p.returncode}: {err[-3000:]}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every child started at once, then the JAX references; the ranks'
    records by case, and the references by config."""
    d = tmp_path_factory.mktemp("families")
    t0 = time.time()
    inputs, jax_side = {}, {}
    for arch in ARCHS:
        inputs[arch], jax_side[arch] = _inputs(arch)
        torch.save(inputs[arch], d / f"{arch}.pt")
    nt_in = {"params": {a: TT.shared_params(cfg_pair("float32", a)[1])[1]
                        for a in ("yi-9b", "jamba-v0.1-52b")},
             "seq_prompts": torch.tensor(np.random.default_rng(3).integers(
                 0, 512, (2, 20)))}
    torch.save(nt_in, d / "nt.pt")
    procs = {tuple(g): _start([",".join(g), str(d)]) for g in GROUPS}
    deadline = t0 + TIME_LIMIT
    want = {}
    try:
        for arch in ARCHS:
            cj, pj, sj, batch = jax_side[arch]
            w = {"forward": _jax_forward(cj, pj, inputs[arch])}
            if cj.embed_inputs:
                w["streams"] = _jax_streams(cj, pj, inputs[arch]["requests"])
            fj = jax.jit(JS.make_train_step(cj, JOpt(**OPT), ACCUM))
            nj, mj = fj(sj, {k: jnp.asarray(v) for k, v in batch.items()})
            w["train"] = (jax.tree.map(np.asarray, nj["params"]),
                          {k: float(v) for k, v in mj.items()})
            want[arch] = w
    finally:
        errors = {c: err for g, p in procs.items()
                  for err in [_wait(p, deadline)] for c in g}
    return {"dir": d, "errors": errors, "want": want}


def _got(world, case: str) -> tuple:
    err = world["errors"][case]
    assert not err, f"{case}: {err}"
    out = world["dir"] / f"{case}.out"
    return torch.load(out), torch.load(str(out) + ".rank1")


def _rel(got, want) -> float:
    return float(np.abs(f32(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_serves_as_jax_under_a_mesh(world, arch, mesh):
    got, got1 = _got(world, f"{arch}@{mesh}")
    want = world["want"][arch]
    if "streams" in want:
        assert got["streams"] == want["streams"]
        assert got1["streams"] == want["streams"]
    lg, toks = want["forward"]
    # the prefill's and the first step's logits; every greedy pick
    assert _rel(got["logits"][0], lg[0]) <= LOGIT_TOL
    assert _rel(got["logits"][1], lg[1]) <= LOGIT_TOL
    assert got["tokens"].tolist() == toks.tolist()
    assert torch.equal(got["logits"], got1["logits"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_step_as_jax_under_a_mesh(world, arch, mesh):
    got = _got(world, f"{arch}@{mesh}")[0]["train"]
    pj, mj = world["want"][arch]["train"]
    assert sorted(got["metrics"]) == sorted(mj)
    for k, v in mj.items():
        np.testing.assert_allclose(float(got["metrics"][k]), v, err_msg=k,
                                   rtol=1e-6 if k == "lr" else 1e-5,
                                   atol=1e-7)
    for (path, g), (_, w) in zip(M._walk(got["params"]), M._walk(pj)):
        err = np.abs(f32(g) - w)
        tol = 1e-5 * float(np.abs(w).max()) + 0.01 * OPT["lr"]
        # elements whose tiny gradients flipped sign under another order
        assert (err > tol).mean() < 0.01, path
        assert err.max() <= tol + 2 * OPT["lr"], path


def test_pipelined_dispatch_under_a_mesh(world):
    """``pipeline=2`` at (1,2) (jamba: attention, Mamba and MoE layers):
    streams equal to the serial engine's, greedy and sampled, on both
    ranks; greedy equal to the JAX engine's."""
    got, got1 = _got(world, "pipeline")
    for temp in (0.0, 0.8):
        assert got[(temp, 2)] == got[(temp, 0)], temp
        assert got[(temp, 2, "stats")] == 2
        assert got1[(temp, 2)] == got[(temp, 2)]
    assert got[(0.0, 2)] == world["want"]["jamba-v0.1-52b"]["streams"]


def test_sharded_snapshot_restores_anywhere(world):
    """A snapshot of a (1,2) engine: taken on both ranks (the first
    writes), skipped on both when one rank's checkpointer is busy, and
    restored whole at mesh=None and resharded at (2,1) to the very
    tensors; a (2,1) engine on the restore streams as JAX's."""
    for rec in _got(world, "snapshot"):
        assert rec["took"] is True and rec["skipped"] is True
        assert rec["steps"] == [1]
        assert rec["whole_equal"] and rec["resharded_equal"]
        assert rec["streams21"] == world["want"]["jamba-v0.1-52b"]["streams"]


def test_paged_slots_over_data(world):
    """The paged engine at (2,1), its slots over ``data``: streams equal
    to mesh=None's and to the JAX engine's (its paged engine's streams are
    the dense one's; ``test_torch_family.py`` holds the port's paged
    engine to it at mesh=None); a fork from one data
    shard's slot into the other's decodes as mesh=None's; both ranks'
    replicas of every page pool alike."""
    got, got1 = _got(world, "paged21")
    assert got["mesh"] == got["none"] == \
        world["want"]["jamba-v0.1-52b"]["streams"]
    assert got["mesh_fork"] == got["none_fork"]
    fork, parent = got["mesh_fork"]["f"], got["mesh_fork"]["p"]
    assert len(fork) > len(parent) and fork[:len(parent)] == parent
    assert got1["mesh"] == got["mesh"]
    assert len(got["pools"]) == len(got1["pools"]) > 0
    for a, b in zip(got["pools"], got1["pools"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-v0.1-52b"])
def test_nt_stores_on_a_sequence_sharded_cache(world, arch):
    """``store_flavor="nt"`` on the cache sharded on its rows: the greedy
    streams and each step's logits as the standard stores give them; one
    step at positions only one rank owns (slot 0 at row 29: rank 1's row
    5; slot 1 at row 3: rank 0's) changes that row of that slot alone on
    each rank, every other row bit for bit as it was."""
    owned = {0: {(1, 3)}, 1: {(0, C.SEQ_HORIZON // 2 + 5 - C.SEQ_HORIZON
                              // 2)}}
    for rank, rec in enumerate(_got(world, "nt")):
        got = rec[arch]
        # (L, B, S, Hkv, Dh): the rows over model
        assert got["placements"] == ["Replicate()", "Shard(dim=2)"]
        assert torch.equal(got["streams"]["nt"], got["streams"]["standard"])
        assert torch.equal(got["logits"]["nt"], got["logits"]["standard"])
        for before, after in zip(got["before"], got["after"]):
            diff = (before != after).any(-1).any(-1).any(0)
            changed = {(int(b), int(r)) for b, r in diff.nonzero()}
            assert changed == owned[rank], (rank, changed)
