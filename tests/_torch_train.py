"""Shared setup of the port's training parity tests: one training batch
made with numpy, the reference's loss and gradients under ``jax.jit``,
the port's through autograd, and the checks both files run."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as JM
from repro.train import step as JS
from repro_torch.models import model as M
from repro_torch.train import step as TS

from _torch_common import cfg_pair, f32

#: fp32 tolerances: logits within 1e-5 of the largest logit, the loss
#: within 1e-5 relative, each gradient leaf within 1e-4 of that leaf's
#: largest magnitude (sums in other orders; the MoE archs' routers and
#: the recurrent scans stack more of them than the attention family)
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4


def train_batch(cfg, b: int, s: int, seed: int = 0) -> dict:
    """numpy training batch: tokens (or embeds), targets, and distinct
    random (3, B, S) positions for an M-RoPE model."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    if cfg.rope_kind == "mrope":
        out["positions"] = rng.integers(0, 4 * s, (3, b, s)).astype(np.int32)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def reference(cj, pj, batch: dict) -> dict:
    """The reference's train logits, aux, loss, parts and gradients."""
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.value_and_grad(JS.make_loss_fn(cj), has_aux=True)

    def both(p, b):     # one compile for the forward and the gradients
        return (JM.forward(cj, p, JS.model_inputs(cj, b), mode="train"),
                grad_fn(p, b))
    (logits, aux), ((loss, parts), grads) = jax.jit(both)(pj, bj)
    return {"logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "ce": float(parts["ce"]),
            "grads": jax.tree.map(np.asarray, grads)}


def shared_params(ct, seed: int = 0):
    """The port's ``init_params`` (fp32, from a seeded generator) and the
    same numbers as a JAX tree for the reference (the trees share names
    and layouts); a fraction of the time of the reference's init."""
    pt = M.init_params(ct, torch.Generator().manual_seed(seed), device="cpu")

    def to_jax(tree):
        return {k: to_jax(v) if isinstance(v, dict) else
                jnp.asarray(v.numpy()) for k, v in tree.items()}
    return to_jax(pt), pt


def case(arch: str, b: int = 2, s: int = 40) -> dict:
    """Everything a parity test of ``arch``'s smoke config needs (fp32):
    S=40 spans two and a half of the smoke configs' 16-row attention, mLSTM
    and Mamba chunks (the padded last one included)."""
    cj, ct = cfg_pair("float32", arch)
    pj, pt = shared_params(ct)
    batch = train_batch(cj, b, s)
    return {"cj": cj, "ct": ct, "pt": pt, "batch": batch,
            "ref": reference(cj, pj, batch)}


def port_grads(ct, pt, batch: dict):
    return TS.value_and_grad(TS.make_loss_fn(ct))(pt, torch_batch(batch))


def assert_grads(got: dict, want: dict, tol: float = GRAD_TOL) -> None:
    gw, ww = list(M._walk(got)), list(M._walk(want))
    assert [p for p, _ in gw] == [p for p, _ in ww]
    for (path, g), (_, w) in zip(gw, ww):
        assert tuple(g.shape) == w.shape, path
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(f32(g), w, rtol=0, atol=tol * scale,
                                   err_msg="/".join(path))


def check_train_forward(c: dict) -> None:
    """Train-mode logits (B, S, V) and aux against the reference's."""
    logits, aux = M.forward(c["ct"], c["pt"], TS.model_inputs(
        c["ct"], torch_batch(c["batch"])), mode="train")
    want = c["ref"]["logits"]
    b, s = c["batch"]["targets"].shape
    assert logits.shape == (b, s, c["ct"].vocab_size) == want.shape
    np.testing.assert_allclose(f32(logits), want, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), c["ref"]["aux"], rtol=LOSS_RTOL,
                               atol=1e-7)


def check_loss_and_grads(c: dict) -> dict:
    (loss, parts), grads = port_grads(c["ct"], c["pt"], c["batch"])
    np.testing.assert_allclose(float(loss), c["ref"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), c["ref"]["ce"],
                               rtol=LOSS_RTOL)
    assert_grads(grads, c["ref"]["grads"])
    return grads


def check_remat_variants(c: dict, monkeypatch) -> None:
    """``"full"`` and ``"dots"`` give the "none" gradients bit for bit, and
    both recompute each scan block in the backward pass (``apply_block``
    runs twice a scan block; once without remat)."""
    calls = {"n": 0}
    real = M.apply_block

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(M, "apply_block", counted)
    n_rep, unit, n_tail = c["ct"].scan_split()
    base = None
    for remat in ("none", "full", "dots"):
        calls["n"] = 0
        ct = dataclasses.replace(c["ct"], remat=remat)
        _, grads = port_grads(ct, c["pt"], c["batch"])
        scan_calls = calls["n"] - n_tail
        assert scan_calls == n_rep * unit * (1 if remat == "none" else 2), \
            (remat, calls["n"])
        if base is None:
            base = grads
            continue
        for (path, g), (_, w) in zip(M._walk(grads), M._walk(base)):
            assert torch.equal(g, w), (remat, path)
