"""The port's training forward and its gradients against the JAX package,
for the attention family's smoke configs in fp32.

Each arch is held on one batch (B=2, S=40; distinct M-RoPE positions for
qwen2-vl-7b, ``embeds`` for musicgen-large): train-mode logits at every
position and the aux loss against ``repro.models.model.forward(mode=
"train")``, the loss and every gradient leaf against ``jax.value_and_grad
(make_loss_fn(cfg), has_aux=True)``, and the port's remat modes against
each other. Tolerances: ``_torch_train.LOGIT_TOL``, ``LOSS_RTOL``,
``GRAD_TOL``.
"""

import pytest
import torch

import _torch_train as TT

torch.set_num_threads(1)

ARCHS = ["yi-9b", "gemma3-4b", "minitron-8b", "qwen1.5-110b",
         "qwen2-vl-7b", "musicgen-large"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return TT.case(request.param)


def test_train_logits_and_aux_match_jax(case):
    TT.check_train_forward(case)


def test_loss_and_every_gradient_match_jax(case):
    TT.check_loss_and_grads(case)


def test_remat_modes_give_the_same_gradients(case, monkeypatch):
    TT.check_remat_variants(case, monkeypatch)
