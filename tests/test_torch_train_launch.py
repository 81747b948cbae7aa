"""The port's fault helpers and training launcher: the helpers against the
JAX package's outputs on the same inputs, ``RestartManager`` recovering
from an injected failure to the bits of an uninterrupted run, the launcher
on the host (losses fall; no card means exit 2), and train checkpoints
crossing between the packages both ways."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import faults as JF
from repro.launch import train as JLT
from repro.train import step as JS
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import faults as F
from repro_torch.launch import train as LT
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import step as TS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_straggler_detector_matches_jax():
    rng = np.random.default_rng(0)
    times = list(0.1 + 0.002 * rng.standard_normal(40))
    times[20] = times[33] = 1.5
    dj, dt = JF.StragglerDetector(warmup=5), F.StragglerDetector(warmup=5)
    for x in times:
        assert dt.observe(x) == dj.observe(x)
        assert (dt.mean, dt.var, dt.n, dt.flags) == \
            (dj.mean, dj.var, dj.n, dj.flags)
    assert dt.flags == 2


def test_heartbeats_match_jax():
    hj, ht = JF.HeartbeatRegistry(5, miss_budget=2), \
        F.HeartbeatRegistry(5, miss_budget=2)
    for h in (hj, ht):
        for host in range(5):
            h.beat(host, t=100.0)
        h.beat(0, t=200.0)
        h.beat(3, t=190.0)
    for now in (205.0, 210.0, 240.0, 260.0):
        assert ht.sweep(timeout=50.0, now=now) == \
            hj.sweep(timeout=50.0, now=now)
        assert ht.misses == hj.misses


def test_elastic_mesh_shape_matches_jax():
    for n in list(range(1, 600)) + [1024, 2048, 4096, 240, 257]:
        for pref in (16, 8):
            assert F.elastic_mesh_shape(n, model_pref=pref) == \
                JF.elastic_mesh_shape(n, model_pref=pref), n


def test_restart_manager_recovers(tmp_path):
    """The reference's own property, on the port's Checkpointer."""
    rm = F.RestartManager(Checkpointer(str(tmp_path)), ckpt_every=2)
    state, end = rm.run({"x": torch.zeros(())},
                        lambda s, i: {"x": s["x"] + 1}, 10,
                        inject_failure_at=5)
    assert rm.restarts == 1 and end == 10 and float(state["x"]) == 10.0


def test_restart_manager_resumes_training_bit_identically(tmp_path):
    """A smoke yi-9b training run with a failure injected at step 3
    restores step 2's checkpoint and ends on the bits of a run without
    the failure (the step's batch is a function of the step index)."""
    cfg = get_smoke_config("yi-9b")
    train = TS.make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=5))
    src = SyntheticLM(cfg.vocab_size, 16, seed=1)

    def step_fn(state, i):
        return train(state, to_device(cfg, src.batch(i, 2), "cpu"))[0]

    def fresh():
        return TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    runs = []
    for inject, sub in ((None, "plain"), (3, "failed")):
        rm = F.RestartManager(Checkpointer(str(tmp_path / sub)),
                              ckpt_every=2)
        state, end = rm.run(fresh(), step_fn, 5, inject_failure_at=inject)
        assert end == 5 and rm.restarts == (inject is not None)
        runs.append(state)
    leaves = [list(M._walk(r)) for r in runs]
    assert len(leaves[0]) == len(leaves[1])
    for (path, a), (_, b) in zip(*leaves):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert int(runs[1]["step"]) == 5


def test_train_launcher_on_the_host_losses_fall(capsys):
    losses = LT.main(["--arch", "yi-9b", "--smoke", "--steps", "16",
                      "--batch", "8", "--seq", "32", "--lr", "3e-3",
                      "--log-every", "5", "--device", "cpu"])
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.05, losses
    out = capsys.readouterr().out
    assert "step    15 loss" in out and "done: first loss" in out


def test_train_launcher_refuses_without_a_card():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--smoke", "--steps", "1"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out
    assert "no CUDA device" in out.stderr and "step" not in out.stdout


def test_compressed_launcher_carries_a_nonzero_residual(tmp_path):
    d = str(tmp_path / "ck")
    LT.main(["--arch", "yi-9b", "--smoke", "--steps", "3", "--batch", "4",
             "--seq", "16", "--compress", "--ckpt-dir", d, "--device",
             "cpu"])
    like = TS.init_train_state(get_smoke_config("yi-9b"),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    like["resid"] = like["params"]
    step, state = Checkpointer(d).restore_latest(like)
    assert step == 3 and int(state["step"]) == 3
    assert all(r.dtype == torch.float32 for _, r in M._walk(state["resid"]))
    assert any(bool(r.abs().sum() > 0) for _, r in M._walk(state["resid"]))


ARGS = ["--arch", "yi-9b", "--smoke", "--batch", "4", "--seq", "32",
        "--ckpt-every", "2", "--log-every", "1"]


def test_port_resumes_the_reference_checkpoint(tmp_path, capsys):
    """The reference writes a smoke checkpoint at step 2; the port's
    launcher resumes it (``--device cpu``) for steps 2-5, and its losses
    match the reference's own resume of a copy of that directory within
    2e-3 relative: the smoke model is bf16, whose params the two packages
    round at different points (logits a few bf16 ulps apart)."""
    d = str(tmp_path / "ref")
    JLT.main(ARGS + ["--steps", "2", "--ckpt-dir", d])
    shutil.copytree(d, str(tmp_path / "port"))
    want = JLT.main(ARGS + ["--steps", "6", "--ckpt-dir", d])
    capsys.readouterr()
    got = LT.main(ARGS + ["--steps", "6", "--ckpt-dir",
                          str(tmp_path / "port"), "--device", "cpu"])
    assert "[restore] resumed from step 2" in capsys.readouterr().out
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_reference_restores_the_port_checkpoint(tmp_path):
    """The port writes a train state (bf16 params, fp32 moments, int32
    step) that the reference's Checkpointer restores bit for bit."""
    d = str(tmp_path / "port")
    LT.main(ARGS + ["--steps", "2", "--ckpt-dir", d, "--device", "cpu"])
    like = TS.init_train_state(get_smoke_config("yi-9b"),
                               torch.Generator().manual_seed(5),
                               device="cpu")
    _, mine = Checkpointer(d).restore_latest(like)
    step, theirs = JCheckpointer(d).restore_latest(
        JS.init_train_state(jax_smoke("yi-9b"), jax.random.PRNGKey(0)))
    assert step == 2 and int(theirs["step"]) == 2
    theirs = jax.tree.map(np.asarray, theirs)
    for (path, a), (_, b) in zip(M._walk(mine), M._walk(theirs)):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16).numpy().view(np.uint16)
            b = b.view(np.uint16)
        else:
            a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_int8_train_states_cross_both_ways(tmp_path):
    """An int8-moment train state with a residual (0-d int32 step, int8
    ``q``, fp32 ``s``, fp32 ``resid``, bf16 params): the reference's
    checkpoint restores in the port as ``train_state_from_jax`` bridges
    it, and the port's back in the reference, bit for bit."""
    from repro.optim.adamw import OptConfig as JOpt
    from repro.optim.compression import init_residual
    from repro_torch.models import bridge
    cj, ct = jax_smoke("yi-9b"), get_smoke_config("yi-9b")
    sj = JS.init_train_state(cj, jax.random.PRNGKey(3),
                             JOpt(moments_dtype="int8"))
    sj["resid"] = init_residual(sj["params"])
    rng = np.random.default_rng(0)
    # nonzero moments, scales, residual and step
    sj = jax.tree.map(lambda a: jax.numpy.asarray(
        (rng.standard_normal(a.shape) * 50).astype(a.dtype)
        if a.dtype != jax.numpy.int8 else
        rng.integers(-127, 128, a.shape).astype(np.int8)), sj)
    sj["step"] = jax.numpy.asarray(7, jax.numpy.int32)
    want = bridge.train_state_from_jax(jax.tree.map(np.asarray, sj), ct,
                                       device="cpu")
    like = TS.init_train_state(ct, torch.Generator().manual_seed(0),
                               OptConfig(moments_dtype="int8"),
                               device="cpu")
    like["resid"] = like["params"]
    JCheckpointer(str(tmp_path / "ref")).save(7, sj, block=True)
    step, got = Checkpointer(str(tmp_path / "ref")).restore_latest(like)
    assert step == 7 and got["step"].shape == ()
    for (path, a), (_, b) in zip(M._walk(got), M._walk(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), path
    Checkpointer(str(tmp_path / "port")).save(7, got, block=True)
    _, back = JCheckpointer(str(tmp_path / "port")).restore_latest(sj)
    for (path, a), (_, b) in zip(M._walk(jax.tree.map(np.asarray, back)),
                                 M._walk(jax.tree.map(np.asarray, sj))):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.name ==
                                      "bfloat16" else a,
                                      b.view(np.uint16) if b.dtype.name ==
                                      "bfloat16" else b, err_msg=str(path))
