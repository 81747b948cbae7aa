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


def trace_from_jax(tr):
    """A JAX ``core.trace.Trace`` walked into the port's dataclasses, field
    for field (the port lowers ATen, not HLO; this lets both packages'
    backends price one trace)."""
    from repro_torch.core import trace as T

    def region(r):
        return None if r is None else T.TraceRegion(
            r.name, r.boundary, [op_(o) for o in r.ops])

    def op_(o):
        kw = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}
        kw["region"] = region(o.region)
        kw["param_map"] = None if o.param_map is None else dict(o.param_map)
        return T.TraceOp(**kw)

    return T.Trace(tr.module_name, region(tr.entry), tr.n_devices)


def matmul_flops(region, mult: int = 1) -> float:
    """FLOPs of a trace region's matrix products, loop bodies times their
    trips (either package's trace dataclasses)."""
    total = 0.0
    for op in region.ops:
        if op.region is not None:
            trips = op.trips if op.kind == "loop" else 1
            total += matmul_flops(op.region, mult * trips)
        elif any(cls == "mxu" for cls, _ in op.uops):
            total += mult * op.flops
    return total
