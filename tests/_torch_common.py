"""Shared setup of the port's parity tests: the smoke yi-9b config on
both sides and JAX parameters bridged to torch through numpy."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import bridge

# the tests run beside the JAX suite on shared CPUs: one torch thread
torch.set_num_threads(1)


def cfg_pair(dtype: str = "float32", arch: str = "yi-9b"):
    """(JAX config, port config) of the smoke model in ``dtype``."""
    return (dataclasses.replace(jax_smoke_config(arch), param_dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), param_dtype=dtype))


def bridged_params(cj, ct, seed: int = 0):
    """JAX ``init_params`` and the same weights as the port's dict."""
    pj = JM.init_params(cj, jax.random.PRNGKey(seed))
    return pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj), ct,
                                      device="cpu")


def f32(x) -> np.ndarray:
    """A torch tensor or JAX array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)
