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
from repro_torch.serve import pages
from repro_torch.serve.slots import SLOT_AXIS


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

    Dense slot caches and paged caches alike: the KV leaves' batch (or
    page count) and horizon (or page size) are read from the tree's
    first KV leaf, the slots of the recurrent leaves from its first
    recurrent leaf (a model without attention has no KV leaf, one without
    recurrent blocks no recurrent leaf). Recurrent leaves are fp32, as
    the cache contract has them.
    """
    found: dict = {}
    for (path, d), (_, leaf) in zip(M._walk(M.cache_defs(cfg, 1, 1)),
                                    M._walk(tree)):
        axis = SLOT_AXIS[path[0]]
        if M.is_kv(d):
            found.setdefault("kv", leaf.shape[axis:axis + 2])
        else:
            found.setdefault("slots", leaf.shape[axis])
    kv_batch, seq = found.get("kv", (found.get("slots", 1), 1))
    expected = pages.paged_cache_shapes(cfg, found.get("slots", kv_batch),
                                        kv_batch, seq)
    return _convert(tree, expected, device, "")


def _moment_shapes(ps: dict, int8: bool) -> dict:
    """``(shape, dtype)`` of one moment (or residual) tree shaped as the
    params ``ps``: fp32, or int8 ``{"q", "s"}`` pairs whose fp32 row
    scales keep the leaf's shape with its last axis 1."""
    out = {}
    for key, e in ps.items():
        if isinstance(e, dict):
            out[key] = _moment_shapes(e, int8)
            continue
        shape = tuple(e[0])
        out[key] = {"q": (shape, torch.int8),
                    "s": (shape[:-1] + (1,) if shape else (1,),
                          torch.float32)} if int8 else (shape, torch.float32)
    return out


def train_state_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """A JAX train state (``repro.train.step.init_train_state``, as
    numpy) as the port's: params, fp32 or int8 moments, the int32 step
    and an optional ``resid``; bf16 leaves cross as uint16 views."""
    m = tree["opt"]["m"]
    first = next(iter(M._walk(m)))[1] if m else None
    int8 = first is not None and np.asarray(first).dtype == np.int8
    ps = M.param_shapes(cfg)
    mo = _moment_shapes(ps, int8)
    expected = {"params": ps, "opt": {"m": mo, "v": mo},
                "step": ((), torch.int32)}
    if "resid" in tree:
        expected["resid"] = _moment_shapes(ps, False)
    return _convert(tree, expected, device, "")
