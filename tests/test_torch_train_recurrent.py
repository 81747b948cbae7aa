"""The port's training forward and its gradients against the JAX package,
for the recurrent and MoE families (xlstm-125m, jamba, grok-1,
qwen3-moe; smoke configs, fp32, B=2, S=40), with the checks of
``test_torch_train_forward.py``, and one full-width xLSTM unit.

The full-width unit is an mLSTM block and an sLSTM block at xlstm-125m's
published width (d 768, vocab 50304) in fp32. There the reference's
gradient blows up with the sequence: with this test's weights its global
norm is 512 at S=8, 1.05e4 at S=16 and 2.6e6 at S=32 (B=1), against ~7
for the smoke config. The sLSTM recurrence is what amplifies: in the
reference itself an input perturbed by 1e-7 (relative) moves the sLSTM
block's output by 1.6x a step, to 0.15 on outputs of ~5 by step 32, so
at S=32 no port can be held to the reference's gradient within 1 % (this
one reads 8 % off there, 26 % with the reference's own init). The test
holds S=16, inside the blow-up (norm above 1e3), to 1 % and the five
largest leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.configs import get_config as jax_config
from repro.train import step as JS
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.optim import adamw

torch.set_num_threads(1)

ARCHS = ["xlstm-125m", "jamba-v0.1-52b", "grok-1-314b",
         "qwen3-moe-235b-a22b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return TT.case(request.param)


def test_train_logits_and_aux_match_jax(case):
    TT.check_train_forward(case)


def test_loss_and_every_gradient_match_jax(case):
    TT.check_loss_and_grads(case)


def test_remat_modes_give_the_same_gradients(case, monkeypatch):
    TT.check_remat_variants(case, monkeypatch)


def test_full_width_xlstm_unit_gradient_matches_jax():
    """One mLSTM + sLSTM unit at full width (B=1, S=16, fp32): the global
    grad norm within 1 % of the reference's, in the blow-up regime, and
    the same five largest leaves (by norm) in the same order."""
    cj = dataclasses.replace(jax_config("xlstm-125m"), n_layers=2,
                             param_dtype="float32")
    ct = dataclasses.replace(get_config("xlstm-125m"), n_layers=2,
                             param_dtype="float32")
    pj, pt = TT.shared_params(ct)
    batch = TT.train_batch(cj, 1, 16)
    _, gj = jax.jit(jax.value_and_grad(JS.make_loss_fn(cj), has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    gj = jax.tree.map(np.asarray, gj)
    _, gt = TT.port_grads(ct, pt, batch)
    want = float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                             for _, g in M._walk(gj))))
    got = float(adamw.global_norm(gt))
    assert want > 1e3, want
    assert abs(got / want - 1) < 0.01, (got, want)

    def top(tree, norm):
        return [p for _, p in sorted(((norm(g), "/".join(p))
                                      for p, g in M._walk(tree)),
                                     reverse=True)[:5]]
    assert top(gt, lambda g: float(g.norm())) == \
        top(gj, lambda g: float(np.linalg.norm(g)))
