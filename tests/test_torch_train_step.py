"""The port's train step against the JAX package's jitted one, three
steps from the same state on the same batches (smoke configs, fp32).

``make_train_step`` at ``accum_steps`` 1 and 2 (qwen2-vl-7b's M-RoPE
positions split on their batch axis, musicgen-large's ``embeds``), int8
moments, and the compress path of ``launch.train.build`` (int8
error-feedback gradients, the residual carried in the state). The state
crosses through ``bridge.train_state_from_jax``.

Tolerances: metrics (loss, ce, aux, grad norm) within 1e-5 relative and
the lr within 1e-6; params within 1e-5 of each leaf's largest magnitude
plus 1 % of lr a step, and for under 1 % of a leaf's elements 2 lr a
step (AdamW moves an element by ~lr whatever its gradient's size, so
where a gradient is as small as the two packages' rounding its sign is
noise); the int8 moments' ``q`` within 1 of each other where ``m``
rounds at a half; residuals within one quantum (the block's scale)
where ``compress_tree`` rounds at a half, and on average within 1e-3 of
it (they carry the gradients' own difference).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.configs.base import ShapeSpec as JShape
from repro.launch import train as JLT
from repro.optim.adamw import OptConfig as JOpt
from repro.train import step as JS
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import train as LT
from repro_torch.models import bridge
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.optim.compression import init_residual
from repro_torch.train import step as TS

from _torch_common import cfg_pair, f32

torch.set_num_threads(1)

B, S, STEPS = 4, 16, 3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)


def _batches(cfg, n):
    return [TT.train_batch(cfg, B, S, seed=10 + i) for i in range(n)]


def _states(arch, moments="float32", compress=False):
    cj, ct = cfg_pair("float32", arch)
    pj, _ = TT.shared_params(ct)
    from repro.optim.adamw import init_opt_state
    sj = {"params": pj, "opt": init_opt_state(pj, moments),
          "step": jnp.zeros((), jnp.int32)}
    if compress:
        from repro.optim.compression import init_residual as j_resid
        sj["resid"] = j_resid(pj)
    st = bridge.train_state_from_jax(jax.tree.map(np.asarray, sj), ct,
                                     device="cpu")
    return cj, ct, sj, st


def _run(arch, *, accum=1, moments="float32", compress=False):
    cj, ct, sj, st = _states(arch, moments, compress)
    if compress:
        fj = JLT.build(cj, JShape("t", S, B, "train"),
                       JOpt(**OPT, moments_dtype=moments), accum, True)
        ft = LT.build(ct, ShapeSpec("t", S, B, "train"),
                      OptConfig(**OPT, moments_dtype=moments), accum, True)
    else:
        fj = JS.make_train_step(cj, JOpt(**OPT, moments_dtype=moments),
                                accum)
        ft = TS.make_train_step(ct, OptConfig(**OPT, moments_dtype=moments),
                                accum)
    fj = jax.jit(fj)
    out = []
    for b in _batches(cj, STEPS):
        sj, mj = fj(sj, {k: jnp.asarray(v) for k, v in b.items()})
        st, mt = ft(st, TT.torch_batch(b))
        out.append((jax.tree.map(np.asarray, mj), mt))
    return jax.tree.map(np.asarray, sj), st, out


def _check_metrics(out):
    for mj, mt in out:
        assert sorted(mj) == sorted(mt)
        for k in mj:
            np.testing.assert_allclose(
                float(mt[k]), float(mj[k]), err_msg=k,
                rtol=1e-6 if k == "lr" else 1e-5, atol=1e-7)


def _check_params(got, want, steps=STEPS, bounded=True):
    """``bounded``: an AdamW step moves an element by ~lr at most, which
    int8 moments break (see the int8 test)."""
    for (path, g), (_, w) in zip(M._walk(got), M._walk(want)):
        g = f32(g)
        err = np.abs(g - w)
        tol = 1e-5 * float(np.abs(w).max()) + 0.01 * OPT["lr"] * steps
        far = err > tol
        # elements whose tiny gradients flipped sign in one step or more
        assert far.mean() < 0.01, (path, far.mean())
        if bounded:
            assert err.max() <= tol + 2 * OPT["lr"] * steps, path


CASES = [("yi-9b", 1), ("yi-9b", 2), ("qwen2-vl-7b", 2),
         ("musicgen-large", 2)]


@pytest.mark.parametrize("arch,accum", CASES)
def test_train_step_matches_jax(arch, accum):
    sj, st, out = _run(arch, accum=accum)
    _check_metrics(out)
    _check_params(st["params"], sj["params"])
    assert int(st["step"]) == int(sj["step"]) == STEPS
    assert st["step"].dtype == torch.int32


def test_int8_moments_step_matches_jax():
    """Three int8-moment steps (yi-9b, ``accum_steps=2``), each from the
    reference's state before it. Run free, the two packages part after
    two steps: a gradient one ulp apart flips an int8 ``q`` at a half, and
    where the row quantization takes ``v`` to 0 AdamW divides ``m`` by
    ~eps, so one flip moves a param by up to ~3 (lr 1e-3) and the third
    loss by 3e-4 relative, in the reference as much as in the port. Even
    within a step such an element's update, ~lr * m / |g|, carries its
    tiny gradient's relative rounding: params are held on all but 1 % of
    each leaf's elements, without the lr bound."""
    cj, ct, sj, _ = _states("yi-9b", "int8")
    oc = dict(OPT, moments_dtype="int8")
    fj = jax.jit(JS.make_train_step(cj, JOpt(**oc), 2))
    ft = TS.make_train_step(ct, OptConfig(**oc), 2)
    for b in _batches(cj, STEPS):
        st = bridge.train_state_from_jax(jax.tree.map(np.asarray, sj), ct,
                                         device="cpu")
        assert st["opt"]["m"]["final_norm"]["q"].dtype == torch.int8
        st, mt = ft(st, TT.torch_batch(b))
        sj, mj = fj(sj, {k: jnp.asarray(v) for k, v in b.items()})
        _check_metrics([(jax.tree.map(np.asarray, mj), mt)])
        _check_params(st["params"], jax.tree.map(np.asarray,
                                                 sj["params"]), steps=1,
                      bounded=False)
        for (path, g), (_, w) in zip(M._walk(st["opt"]),
                                     M._walk(jax.tree.map(np.asarray,
                                                          sj["opt"]))):
            if path[-1] == "q":
                assert g.dtype == torch.int8
                d = np.abs(g.numpy().astype(int) - w.astype(int))
                assert d.max() <= 1 and d.mean() < 0.01, path
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                           err_msg=str(path))


def test_compressed_step_of_launch_build_matches_jax():
    sj, st, out = _run("yi-9b", compress=True)
    _check_metrics(out)
    _check_params(st["params"], sj["params"])
    assert sorted(st) == sorted(sj) == ["opt", "params", "resid", "step"]
    for (path, g), (_, w) in zip(M._walk(st["resid"]),
                                 M._walk(sj["resid"])):
        assert g.dtype == torch.float32 and np.any(w != 0), path
        # a flipped rounding moves one element by one quantum of its
        # block; the rest carry the gradients' own difference
        quantum = np.abs(w).max() * 2.0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=quantum,
                                   err_msg=str(path))
        assert np.abs(g.numpy() - w).mean() < 1e-3 * quantum, path


def test_split_batch_follows_the_reference_rule():
    """Rank >= 2 leaves whose batch divides split on axis 0, others
    repeat, M-RoPE positions (3, B, S) split on axis 1."""
    b = {"tokens": torch.arange(24).reshape(4, 6),
         "positions": torch.arange(72).reshape(3, 4, 6),
         "odd": torch.arange(18).reshape(3, 6),
         "flat": torch.arange(4)}
    mbs = TS.split_batch(b, 2)
    assert len(mbs) == 2
    for i, mb in enumerate(mbs):
        assert torch.equal(mb["tokens"], b["tokens"][2 * i:2 * i + 2])
        assert torch.equal(mb["positions"], b["positions"][:, 2 * i:2 * i + 2])
        assert torch.equal(mb["odd"], b["odd"])
        assert torch.equal(mb["flat"], b["flat"])


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-v0.1-52b"])
def test_default_accum_steps_matches_jax(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for batch, seq in ((8, 4096), (256, 4096), (32, 32768)):
        for mesh in ({}, {"data": 8}, {"pod": 2, "data": 16}):
            assert TS.default_accum_steps(
                get_config(arch), ShapeSpec("t", seq, batch, "train"),
                mesh) == JS.default_accum_steps(
                jget(arch), JShape("t", seq, batch, "train"), mesh)
