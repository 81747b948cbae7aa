"""The sequence-sharded decode and the sharded train step on 2 gloo
ranks on the CPU, against the JAX package's unsharded steps on the same
weights (fp32, smoke configs, bridged through numpy).

Each case runs ``_torch_dryrun_child.py`` in a process of its own, which
spawns the ranks, under a time limit. Held: the decode cache sharded on
its rows (``kv_seq`` over ``model``, ``SERVE_RULES``) for yi-9b and
gemma3-4b (a 16-row window): each step's logits within 1e-5 of the
largest, the greedy streams identical, the written cache within 1e-5;
a step writes only the rows its ranks own, the others bit for bit as
they were, with the standard and the non-temporal row stores alike.
The train step under ``TRAIN_RULES`` at (1,2) (TP) and (2,1)
(FSDP), fp32 and int8 moments, 2 microbatches: loss and grad norm
within 1e-5, the parameters after one AdamW step as
``test_torch_train_step.py`` holds them.
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
from repro.train import serve as jax_serve
from repro.train import step as JS
from repro_torch.models import bridge
from repro_torch.models import model as M

from _torch_common import bridged_params, cfg_pair, f32

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_dryrun_child.py")
sys.path.insert(0, HERE)
import _torch_dryrun_child as C  # noqa: E402

TIME_LIMIT = 240
LOGIT_TOL = CACHE_TOL = 1e-5        # of the largest magnitude, fp32
B, S, ACCUM = 4, 16, 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _start(argv) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)


def _wait(p: subprocess.Popen, deadline: float) -> None:
    """The child by ``deadline`` (``time.time()``); on a hang its process
    group (its ranks too) is killed and the test fails."""
    try:
        _, err = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"the mesh child took over {TIME_LIMIT} s")
    assert p.returncode == 0, err[-3000:]


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(f32(got) - want).max() / np.abs(want).max())


def _jax_decode(cj, pj, prompts: np.ndarray) -> dict:
    prefill = jax.jit(jax_serve.make_prefill_step(cj, cache_len=C.HORIZON))
    step = jax.jit(lambda p, c, t, pos: JM.forward(
        cj, p, {"tokens": t}, mode="decode", cache=c, pos=pos,
        attn_impl="ref"))
    logits, cache = prefill(pj, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    toks, lgs = [tok], []
    pos = prompts.shape[1]
    for _ in range(C.STEPS):
        lg, _, cache = step(pj, cache, tok, jnp.full((2,), pos, jnp.int32))
        lgs.append(np.asarray(lg[:, 0]))
        tok = jnp.argmax(lg[:, 0], -1)[:, None]
        toks.append(tok)
        pos += 1
    return {"streams": np.concatenate([np.asarray(t) for t in toks], 1),
            "logits": np.stack(lgs),
            "cache": {n: np.asarray(v) for n, v in cache["scan"]["0"].items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' records (rank 0's, rank 1's) and the JAX references:
    the child starts as soon as its inputs are written and runs while
    the references compile."""
    d = tmp_path_factory.mktemp("meshchild")
    t0 = time.time()
    dec, dec_ref = {}, {}
    for arch in ("yi-9b", "gemma3-4b"):
        cj, ct = cfg_pair("float32", arch)
        pj, pt = bridged_params(cj, ct)
        prompts = np.random.default_rng(3).integers(0, ct.vocab_size, (2, 20))
        dec[arch] = {"params": pt, "prompts": torch.tensor(prompts)}
        dec_ref[arch] = (cj, pj, prompts)
    cj, ct = cfg_pair("float32", "yi-9b")
    pj, _ = TT.shared_params(ct)
    batch = TT.train_batch(cj, B, S, seed=10)
    states, sjs = {}, {}
    for md in ("float32", "int8"):
        sjs[md] = {"params": pj, "opt": init_opt_state(pj, md),
                   "step": jnp.zeros((), jnp.int32)}
        states[md] = bridge.train_state_from_jax(
            jax.tree.map(np.asarray, sjs[md]), ct, device="cpu")
    torch.save({"decode": dec,
                "train": {"states": states, "batch": TT.torch_batch(batch),
                          "opt": OPT, "accum": ACCUM}}, d / "in.pt")
    child = _start([sys.executable, CHILD, "mesh", str(d / "out.pt"),
                    str(d / "in.pt")])
    try:
        want_dec = {a: _jax_decode(*v) for a, v in dec_ref.items()}
        want_train = {}
        for md, sj in sjs.items():
            fj = jax.jit(JS.make_train_step(
                cj, JOpt(**OPT, moments_dtype=md), ACCUM))
            nj, mj = fj(sj, {k: jnp.asarray(v) for k, v in batch.items()})
            want_train[md] = (jax.tree.map(np.asarray, nj["params"]),
                              {k: float(v) for k, v in mj.items()})
    finally:
        _wait(child, t0 + TIME_LIMIT)
    got0, got1 = torch.load(d / "out.pt"), torch.load(d / "out.pt.rank1")
    return {"decode": (got0["decode"], got1["decode"], want_dec),
            "train": (got0["train"], want_train)}


@pytest.fixture(scope="module")
def decode(world):
    return world["decode"]


@pytest.fixture(scope="module")
def train(world):
    return world["train"]


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b"])
def test_seq_sharded_decode_matches_jax(decode, arch):
    got, got1, want = decode[0][arch], decode[1][arch], decode[2][arch]
    # the cache's rows over model: (L, B, S, Hkv, Dh) sharded on dim 2
    assert got["placements"] == ["Replicate()", "Shard(dim=2)"]
    assert _rel(got["logits"], want["logits"]) <= LOGIT_TOL
    assert got["streams"].tolist() == want["streams"].tolist()
    assert got1["streams"].tolist() == want["streams"].tolist()
    for name in ("k", "v"):
        assert _rel(got["cache"][name], want["cache"][name]) <= CACHE_TOL


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b"])
def test_seq_sharded_write_lands_on_its_owner_only(decode, arch):
    """Slot 0 writes row 29 (rank 1's row 5), slot 1 row 3 (rank 0's):
    each rank's shard changes in that row of that slot alone, every
    other row bit for bit as it was (a non-owner's negative or
    past-the-end position is not wrapped or clamped into its rows)."""
    half = C.HORIZON // 2
    owned = {0: {(1, 3)}, 1: {(0, C.HORIZON // 2 + 5 - half)}}
    for rank, got in ((0, decode[0][arch]), (1, decode[1][arch])):
        for before, after in zip(got["before"], got["after"]):
            # (L, B, S_loc, Hkv, Dh): rows that changed, by (slot, row)
            diff = (before != after).any(-1).any(-1).any(0)
            changed = {(int(b), int(r)) for b, r in diff.nonzero()}
            assert changed == owned[rank], (rank, changed)


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b"])
def test_seq_sharded_decode_refuses_nt_stores(decode, arch):
    """Non-temporal row stores on a sequence-sharded cache, once refused,
    now write through the non-temporal row writer on the owned slots
    alone: the step of the owner-only case again with ``store_flavor=
    "nt"``, from the shards as they were, leaves every rank's shard bit
    for bit as the standard stores left it (the owners' rows written, no
    other row touched: the writer's clamp never reaches a non-owner)."""
    half = C.HORIZON // 2
    owned = {0: {(1, 3)}, 1: {(0, C.HORIZON // 2 + 5 - half)}}
    for rank, got in ((0, decode[0][arch]), (1, decode[1][arch])):
        for before, std, nt in zip(got["before"], got["after"],
                                   got["nt_after"]):
            assert torch.equal(nt, std), rank
            diff = (before != nt).any(-1).any(-1).any(0)
            changed = {(int(b), int(r)) for b, r in diff.nonzero()}
            assert changed == owned[rank], (rank, changed)


# --- the sharded train step -------------------------------------------------

@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_sharded_train_step_matches_jax(train, mesh, moments):
    got = train[0][f"{mesh}_{moments}"]
    pj, mj = train[1][moments]
    assert sorted(got["metrics"]) == sorted(mj)
    for k, v in mj.items():
        np.testing.assert_allclose(float(got["metrics"][k]), v, err_msg=k,
                                   rtol=1e-6 if k == "lr" else 1e-5,
                                   atol=1e-7)
    assert int(got["step"]) == 1
    for (path, g), (_, w) in zip(M._walk(got["params"]), M._walk(pj)):
        err = np.abs(f32(g) - w)
        tol = 1e-5 * float(np.abs(w).max()) + 0.01 * OPT["lr"]
        # elements whose tiny gradients flipped sign under another order
        assert (err > tol).mean() < 0.01, path
        assert err.max() <= tol + 2 * OPT["lr"], path
