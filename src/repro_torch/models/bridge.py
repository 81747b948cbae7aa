"""Weight and cache bridge from the JAX package's trees, through numpy.

The caller turns each JAX leaf into a numpy array (``np.asarray``); this
module takes numpy arrays only and never imports JAX. A bf16 leaf (numpy
dtype named ``bfloat16``) crosses as a ``uint16`` view of its bits and is
reinterpreted with ``.view(torch.bfloat16)``, so no value is rounded on
the way. Every leaf is checked against the port's own table for the
config before it is copied to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def to_tensor(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One numpy leaf as a torch tensor on ``device``, bits preserved."""
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree: dict, expected: dict, device, where: str) -> dict:
    if set(tree) != set(expected):
        raise ValueError(f"{where or 'tree'}: keys {sorted(tree)} != "
                         f"expected {sorted(expected)}")
    out = {}
    for key, exp in expected.items():
        path = f"{where}/{key}" if where else key
        if isinstance(exp, dict):
            out[key] = _convert(tree[key], exp, device, path)
            continue
        t = to_tensor(tree[key], device)
        shape, dtype = exp
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(shape)} {dtype}")
        out[key] = t
    return out


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX ``init_params`` tree (as numpy) as the port's param dict."""
    return _convert(tree, M.param_shapes(cfg), device, "")


def cache_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """A JAX decode cache tree (as numpy) as the port's cache dict.

    The batch and horizon are read from the tree's first KV leaf.
    """
    leaf = tree["scan"]["0"]["k"] if tree.get("scan") \
        else tree["tail"]["0"]["k"]
    batch, seq = leaf.shape[-4], leaf.shape[-3]
    return _convert(tree, M.cache_shapes(cfg, batch, seq), device, "")
