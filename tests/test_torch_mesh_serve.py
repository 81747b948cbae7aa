"""The port's engines on 2-rank gloo meshes on the CPU against the JAX
package's unsharded engine.

Smoke yi-9b in fp32 (4 query heads over 2 KV heads), the JAX package's
weights bridged through numpy. Each case runs ``_torch_mesh_child.py``
in a process of its own, which spawns the ranks (a process group is
process-wide state), under a time limit: a hang fails its test and is
killed with its ranks. Held: greedy streams identical to the JAX
unsharded engine's and to the port's mesh=None engine's, dense and paged
at (1,2) and dense at (2,1); prefill and first decode step logits within
1e-5 of the largest; T=0.8 streams equal to mesh=None's; the two ranks'
streams alike; each rank's local cache shards written in place; what a
sharded engine refuses, and what it once refused and now runs (a
recurrent config, ``pipeline=2``, a snapshot); ``device_put_batch``'s
shards; a world of one; ``launch.serve --mesh``; fig9's replicas sharded
over two ranks.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import serve as jax_serve
from repro.models import model as JM

from _torch_common import bridged_params, cfg_pair

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_mesh_child.py")
TIME_LIMIT = 180            # seconds a child (and its ranks) may take
LOGIT_TOL = 1e-5            # of the largest logit, fp32

# (prompt length, max_new_tokens): 6 requests on 2 slots, later ones
# admitted mid-flight, a 1-token budget among them
SPECS = [(8, 6), (11, 12), (5, 1), (8, 5), (14, 7), (3, 9)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The weights (JAX's, bridged), the requests, their files, and the
    JAX engine's greedy streams and first-step logits."""
    cj, ct = cfg_pair("float32")
    pj, pt = bridged_params(cj, ct)
    rng = np.random.default_rng(0)
    reqs = [(str(i), [int(t) for t in rng.integers(0, ct.vocab_size, n)], m)
            for i, (n, m) in enumerate(SPECS)]
    d = tmp_path_factory.mktemp("mesh")
    torch.save(pt, d / "params.pt")
    (d / "reqs.json").write_text(json.dumps(reqs))
    jreqs = [JRequest(r, tuple(p), m) for r, p, m in reqs]
    want = {"dense": JServeEngine(cj, pj, max_slots=2, max_len=24,
                                  chunk=3).run(list(jreqs)),
            "paged": JPagedServeEngine(cj, pj, page_size=4, max_slots=2,
                                       max_len=24, chunk=3).run(list(jreqs))}
    toks = np.random.default_rng(3).integers(0, ct.vocab_size, (2, 6))
    logits, cache = jax_serve.make_prefill_step(cj, cache_len=16)(
        pj, {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    step, _, _ = JM.forward(cj, pj, {"tokens": tok}, mode="decode",
                            cache=cache, pos=jnp.full((2,), 6, jnp.int32),
                            attn_impl="ref")
    jax_logits = {"prefill": np.asarray(logits[:, -1], np.float32),
                  "step": np.asarray(step[:, 0], np.float32)}
    return {"dir": d, "want": {k: {r: v.tolist() for r, v in s.items()}
                               for k, s in want.items()},
            "logits": jax_logits}


def run_child(args, timeout=TIME_LIMIT) -> subprocess.CompletedProcess:
    """The child under a time limit; on a hang its whole process group
    (its ranks too) is killed and the test fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE,
         os.environ.get("PYTHONPATH", "")]))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen([sys.executable, CHILD, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{args[0]}: the ranks ran past {timeout} s")
    res = subprocess.CompletedProcess(args, proc.returncode, out, err)
    assert res.returncode == 0, err[-3000:]
    return res


def served(world, case):
    d = world["dir"]
    out = d / f"{case}.json"
    run_child([case, str(d / "params.pt"), str(d / "reqs.json"), str(out)])
    ranks = json.loads(out.read_text())
    logits = torch.load(str(out) + ".logits.pt")
    return ranks, logits


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case,tp", [("dense12", 2), ("paged12", 2),
                                     ("dense21", 1)])
def test_two_rank_mesh_serves_as_jax(world, case, tp):
    ranks, logits = served(world, case)
    want = world["want"]["paged" if case.startswith("paged") else "dense"]
    first = ranks[0]
    assert first["tp"] == tp
    for rec in ranks:
        greedy, sampled = rec["streams"]["0.0"], rec["streams"]["0.8"]
        # greedy: the JAX unsharded engine's streams and mesh=None's
        assert greedy["mesh"] == want, rec["rank"]
        assert greedy["none"] == want
        # sampled: mesh=None's streams (torch generators, not jax.random)
        assert sampled["mesh"] == sampled["none"], rec["rank"]
        # every rank picks the same tokens: one cache across the ranks
        assert rec["streams"] == first["streams"]
        assert rec["in_place"] and rec["written"], rec["rank"]
        ref = rec["refusals"]
        assert ref["indivisible_heads"].startswith("ValueError") \
            if tp > 1 else ref["indivisible_heads"] == "ok"
        # once refused under a mesh, now run: xlstm-125m streams as
        # unsharded, pipeline=2 as serial, a snapshot is taken
        for name in ("recurrent", "pipeline", "snapshot"):
            assert ref[name] == "ok", (name, ref[name])
        assert ref["stage"] is False
        assert rec["batches"]["shards_ok"] and rec["batches"]["iterator_ok"]
    assert _rel(logits["prefill"], world["logits"]["prefill"]) <= LOGIT_TOL
    assert _rel(logits["step"], world["logits"]["step"]) <= LOGIT_TOL
    assert _rel(logits["step_none"], world["logits"]["step"]) <= LOGIT_TOL


def test_world_of_one_mesh_equals_mesh_none(world):
    """``make_serve_mesh("data,model=1,1")`` starts a world of one itself;
    its engine streams as mesh=None's, greedy and sampled."""
    ranks, logits = served(world, "world1")
    (rec,) = ranks
    assert rec["tp"] == 1
    for temp in ("0.0", "0.8"):
        assert rec["streams"][temp]["mesh"] == rec["streams"][temp]["none"]
    assert rec["streams"]["0.0"]["mesh"] == world["want"]["dense"]
    assert rec["in_place"] and rec["written"]
    assert torch.equal(logits["step"], logits["step_none"])


def test_launch_serve_mesh_gives_the_unmeshed_tokens(capsys):
    """``launch.serve --mesh data,model=1,2`` under two ranks prints the
    tokens it prints without a mesh (rank 0 alone prints), and exits 2
    with fewer ranks than the spec asks for."""
    sys.path.insert(0, HERE)
    from _torch_mesh_child import LAUNCH_ARGV
    from repro_torch.launch import serve
    assert serve.main(LAUNCH_ARGV) == 0
    alone = capsys.readouterr().out
    assert serve.main(LAUNCH_ARGV + ["--mesh", "data,model=1,2"]) == 2
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err
    res = run_child(["launch"])
    sample = [ln for ln in res.stdout.splitlines() if ln.startswith("sample")]
    assert len(sample) == 1, res.stdout
    assert sample == [ln for ln in alone.splitlines()
                      if ln.startswith("sample")]
    assert "tp=2" in res.stdout
    assert "rank 0 exit 0" in res.stdout and "rank 1 exit 0" in res.stdout


def _fig9_rows(out: str) -> dict:
    """fig9's load lines by name, their derived fields as a dict."""
    return {ln.split(",")[1]: dict(kv.split("=", 1) for kv in
                                   ln.split(",", 3)[3].split(";"))
            for ln in out.splitlines() if ln.startswith("fig9,load.")}


def test_fig9_replicas_shard_over_two_ranks(capsys):
    """``bench.run --only fig9`` under two ranks (as ``torchrun`` runs
    it) shards both replicas over a (1, 2) mesh: every trace and policy
    serves, conserved, the tokens, rounds and per-replica completions of
    the unsharded fleet, at tp=2 on 2 chips; rank 0 alone prints."""
    sys.path.insert(0, HERE)
    from _torch_mesh_child import FIG9_ARGV
    from repro_torch.bench import run as bench_run
    assert bench_run.main(FIG9_ARGV) == 0
    want = _fig9_rows(capsys.readouterr().out)
    res = run_child(["fig9"])
    got = _fig9_rows(res.stdout)
    assert len(want) == 4 and set(got) == set(want)
    for name, row in got.items():
        assert (row["tp"], row["chips"]) == ("2", "2"), name
        assert (want[name]["tp"], want[name]["chips"]) == ("1", "1"), name
        for key in ("n", "replicas", "slots", "rounds", "tokens",
                    "conserved", "r0", "r1"):
            assert row[key] == want[name][key], (name, key)
        assert row["conserved"] == "OK"
    lines = res.stdout.splitlines()
    for head in ("name,us_per_call,derived", "fig9,load.", "_meta,fig9_load"):
        n = sum(ln.startswith(head) for ln in lines)
        assert n == (4 if head == "fig9,load." else 1), (head, res.stdout)
    assert "_meta,fig9_load," in res.stdout and ",ok" in res.stdout
    assert "rank 0 exit 0" in res.stdout and "rank 1 exit 0" in res.stdout
