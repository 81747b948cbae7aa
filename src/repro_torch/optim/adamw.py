"""AdamW with fp32 or row-quantized int8 moments, global-norm clipping
and a warmup-cosine schedule (counterpart of ``repro/optim/adamw.py``).

The state is a plain dict tree shaped as the parameters: ``{"m": tree,
"v": tree}``, each leaf an fp32 tensor, or with ``moments_dtype="int8"``
a ``{"q": int8 leaf, "s": fp32 scales}`` pair whose scales keep the
leaf's shape with its last axis 1. The schedule and the bias corrections
are fp32 tensors on the step's device, as the reference computes them.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # "int8": rowwise-quantized moments (scales over the last axis), a
    # quarter of the fp32 moments' bytes
    moments_dtype: str = "float32"


def _row_quant(x: torch.Tensor):
    """Rowwise symmetric int8 (scale over the last axis); rounds half to
    even, as ``jnp.round`` does."""
    s = (x.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    return q, s


def _row_dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def lr_schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine down to ``min_lr_frac * lr``;
    an fp32 0-d tensor on ``step``'s device."""
    step = step.float()
    warm = oc.lr * (step + 1.0) / max(1, oc.warmup_steps)
    t = ((step - oc.warmup_steps) /
         max(1, oc.total_steps - oc.warmup_steps)).clamp(0.0, 1.0)
    cos = oc.lr * (oc.min_lr_frac + (1 - oc.min_lr_frac) *
                   0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < oc.warmup_steps, warm, cos)


def _leaves(tree, is_leaf=None) -> list:
    """Leaves of a dict tree, keys sorted (``jax.tree.leaves`` order)."""
    if (is_leaf is not None and is_leaf(tree)) or not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]


def _map(fn, tree):
    """``tree`` with ``fn`` applied to every tensor leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unflatten(like, leaves: list, is_leaf=None):
    it = iter(leaves)

    def build(t):
        if (is_leaf is not None and is_leaf(t)) or not isinstance(t, dict):
            return next(it)
        out = {k: build(t[k]) for k in sorted(t)}
        return {k: out[k] for k in t}
    return build(like)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def init_opt_state(params: dict, moments_dtype: str = "float32") -> dict:
    """Zero moments for ``params``, fp32 or int8 with fp32 row scales."""
    if moments_dtype == "int8":
        def z8(p):
            shape = tuple(p.shape[:-1]) + (1,) if p.ndim else (1,)
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros(shape, dtype=torch.float32,
                                     device=p.device)}
        return {"m": _map(z8, params), "v": _map(z8, params)}
    if moments_dtype != "float32":
        raise ValueError(f"unknown moments_dtype {moments_dtype!r}")

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": _map(zeros32, params), "v": _map(zeros32, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32.

    Leaves that are DTensors are summed over their local shards, each
    shard's sum divided by the ranks that hold the same shard (a leaf
    replicated over a mesh dim is counted once), and the ranks' sums are
    added by one all-reduce over the whole mesh: no leaf is gathered.
    The norm comes back a plain 0-d tensor, the same on every rank."""
    leaves = _leaves(tree)
    meshes = {leaf.device_mesh for leaf in leaves if _is_dtensor(leaf)}
    if not meshes:
        total = 0
        for leaf in leaves:
            total = total + leaf.float().square().sum()
        return torch.sqrt(total)
    if len(meshes) > 1:
        raise ValueError("global_norm takes leaves on one mesh")
    mesh = meshes.pop()
    total = 0
    for leaf in leaves:
        if not _is_dtensor(leaf):
            total = total + leaf.float().square().sum() / mesh.size()
            continue
        if any(p.is_partial() for p in leaf.placements):
            raise ValueError("global_norm takes leaves without partial sums")
        copies = math.prod(n for n, p in zip(mesh.shape, leaf.placements)
                           if not p.is_shard())
        total = total + leaf.to_local().float().square().sum() / copies
    return torch.sqrt(_all_ranks_sum(total, mesh))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _all_ranks_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over every rank of ``mesh``: one all-reduce on the
    world's group when the mesh spans the world, else one a mesh dim."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    if mesh.ndim == 1 or mesh.size() == dist.get_world_size():
        group = mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD
        return funcol.all_reduce(x, "sum", group)
    for m in range(mesh.ndim):
        x = funcol.all_reduce(x, "sum", mesh.get_group(m))
    return x


def adamw_update(oc: OptConfig, params: dict, grads: dict, opt_state: dict,
                 step: torch.Tensor):
    """One AdamW step; returns ``(new_params, new_opt_state, {"grad_norm",
    "lr"})``. Gradients are clipped to ``clip_norm`` by their global norm;
    parameters are updated in fp32 and cast back to their dtype."""
    gnorm = global_norm(grads)
    scale = (oc.clip_norm / (gnorm + 1e-9)).clamp(max=1.0)
    lr = lr_schedule(oc, step)
    t = step.float() + 1.0
    bc1 = 1.0 - oc.b1 ** t
    bc2 = 1.0 - oc.b2 ** t
    q8 = oc.moments_dtype == "int8"

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = _row_dequant(m["q"], m["s"]) if q8 else m
        v32 = _row_dequant(v["q"], v["s"]) if q8 else v
        m_new = oc.b1 * m32 + (1 - oc.b1) * g32
        v_new = oc.b2 * v32 + (1 - oc.b2) * g32.square()
        del g32, m32, v32
        p32 = p.float()
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + oc.eps) + \
            oc.weight_decay * p32
        p_new = (p32 - lr * delta).to(p.dtype)
        del delta, p32
        if q8:
            mq, ms = _row_quant(m_new)
            vq, vs = _row_quant(v_new)
            return p_new, {"q": mq, "s": ms}, {"q": vq, "s": vs}
        return p_new, m_new, v_new

    is_m = _is_q8 if q8 else None
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        _leaves(params), _leaves(grads), _leaves(opt_state["m"], is_m),
        _leaves(opt_state["v"], is_m))]
    new_p = _unflatten(params, [o[0] for o in out])
    new_m = _unflatten(params, [o[1] for o in out])
    new_v = _unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}
