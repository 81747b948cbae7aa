"""Train-step builder: loss, gradients (with microbatch accumulation),
AdamW (counterpart of ``repro/train/step.py``).

The state is a plain dict: ``{"params", "opt": {"m", "v"}, "step"}``
(a 0-d int32 tensor), plus ``"resid"`` under gradient compression
(``launch/train.py``). Gradients come from ``torch.autograd.grad`` over
:func:`repro_torch.models.model.forward` in ``mode="train"``, which runs
each scan unit under ``cfg.remat``. The step's matmuls are
``torch.matmul``, as the reference leaves them to XLA; nothing on this
path is a hand-written kernel.

Under a mesh (``utils.sharding.use_mesh_rules`` with ``TRAIN_RULES``) the
state and the batch are DTensors laid out by :func:`train_state_pspecs`
and :func:`batch_pspecs`; DTensor's autograd differentiates the sharded
forward, each gradient is put on its parameter's layout (its partial
sums reduced) and the update runs shard by shard.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state
from repro_torch.train.losses import cross_entropy
from repro_torch.utils import sharding as shd
from repro_torch.utils.loops import repeat
from repro_torch.utils.sharding import P, spec_for

AUX_COEF = 0.01


def model_inputs(cfg: ModelConfig, batch: dict) -> dict:
    keys = ("tokens", "embeds", "positions")
    return {k: batch[k] for k in keys if k in batch}


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(params, batch) -> (loss, {"ce", "aux"})``: token CE plus
    ``AUX_COEF`` times the MoE load-balance loss."""
    def loss_fn(params, batch):
        logits, aux = M.forward(cfg, params, model_inputs(cfg, batch),
                                mode="train")
        ce = cross_entropy(logits, batch["targets"])
        loss = ce + AUX_COEF * aux
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)``'s counterpart:
    ``grad_fn(params, batch) -> ((loss, parts), grads)``, the gradients a
    tree shaped as ``params`` in each leaf's dtype (zeros for a leaf the
    loss does not reach). ``params`` are not modified."""
    def grad_fn(params, batch):
        flat = adamw._leaves(params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        (loss, parts) = loss_fn(adamw._unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _on_layout(g, p)
                 for p, g in zip(flat, grads)]
        return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
                adamw._unflatten(params, grads))
    return grad_fn


def _on_layout(g, p):
    """A gradient on its parameter's DTensor layout (partial sums
    reduced, shards cut); a plain tensor as it is."""
    if shd.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def split_batch(batch: dict, accum_steps: int, whole: bool = False) -> list:
    """The reference's microbatch rule: a leaf of rank >= 2 whose batch
    divides is split on axis 0, any other leaf is repeated; M-RoPE
    positions (3, B, S) are split on axis 1. A DTensor leaf whose batch is
    sharded is split rank by rank: microbatch ``i`` takes the ``i``-th
    part of every rank's rows (the same rows in all, so the same summed
    gradients, in another grouping), unless ``whole``: microbatch ``i``
    is then the reference's, rows ``i B/n .. (i+1) B/n - 1`` of the whole
    batch, laid out as the batch was (the leaf gathered first). A model
    that routes tokens in groups (MoE) takes the whole rows, since its
    routing and capacity depend on which tokens share a microbatch."""
    def split(name, x):
        axis = 1 if name == "positions" and x.ndim == 3 \
            and x.shape[0] == 3 else 0
        if x.ndim < 2 or x.shape[axis] % accum_steps:
            return [x] * accum_steps
        if shd.is_dtensor(x) and not whole:
            return _split_shards(x, axis, accum_steps)
        if shd.is_dtensor(x):
            mesh, pl = x.device_mesh, tuple(x.placements)
            full = shd.relayout(x, (Replicate(),) * mesh.ndim).to_local()
            return [distribute_tensor(p.contiguous(), mesh, pl,
                                      src_data_rank=None)
                    for p in _split_whole(full, axis, accum_steps)]
        return _split_whole(x, axis, accum_steps)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum_steps)]


def _split_whole(x, axis: int, n: int) -> list:
    """``x`` cut into ``n`` equal parts along ``axis`` (0, or 1 for
    M-RoPE's (3, B, S) positions)."""
    if axis == 1:
        return list(x.reshape(3, n, x.shape[1] // n,
                              x.shape[2]).movedim(1, 0))
    return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]))


def _split_shards(x, axis: int, n: int) -> list:
    """``n`` DTensors, the ``i``-th of each rank's shard of ``x`` along
    ``axis`` (every rank's shard divides)."""
    loc = x.to_local()
    if loc.shape[axis] % n:
        raise ValueError(f"a rank's {loc.shape[axis]} rows do not split "
                         f"into {n} microbatches")
    shape = list(x.shape)
    shape[axis] //= n
    return [shd.from_shard(p.contiguous(), x.device_mesh,
                           tuple(x.placements), tuple(shape))
            for p in loc.chunk(n, axis)]


def make_train_step(cfg: ModelConfig, oc: OptConfig, accum_steps: int = 1):
    """``step(state, batch) -> (new_state, metrics)`` with metrics
    ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` (0-d tensors).

    With ``accum_steps > 1`` the batch is cut by :func:`split_batch`, the
    microbatches' gradients are summed in fp32, and the loss, the aux loss
    and the gradients are divided by the step count; ``ce`` is then the
    mean loss, as in the reference. The microbatch loop is a
    :func:`~repro_torch.utils.loops.repeat` loop (its carry the fp32 sums,
    added to in place), so a trace lowering records one microbatch as a
    loop region of ``accum_steps`` trips, the counterpart of the
    reference's ``lax.scan``.
    """
    grad_fn = value_and_grad(make_loss_fn(cfg))
    routed = any(b.endswith(":moe") for b in cfg.layer_plan())

    def step(state, batch):
        meshed = shd.is_dtensor(state["step"])
        with implicit_replication() if meshed else contextlib.nullcontext():
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        if accum_steps == 1:
            (loss, parts), grads = grad_fn(params, batch)
        else:
            grads = adamw._map(
                lambda x: torch.zeros_like(x, dtype=torch.float32), params)
            loss = torch.zeros_like(state["step"], dtype=torch.float32)
            aux = torch.zeros_like(loss)
            mbs = split_batch(batch, accum_steps, whole=routed)

            def micro(i):
                (l, parts), g = grad_fn(params, mbs[i])
                _add32(grads, g)
                loss.add_(l)
                aux.add_(parts["aux"])
            repeat(accum_steps, micro)
            loss = loss / accum_steps
            parts = {"ce": loss, "aux": aux / accum_steps}
            grads = adamw._map(lambda g: g / accum_steps, grads)
        new_params, new_opt, om = adamw_update(oc, params, grads,
                                               state["opt"], state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, **parts, **om}
        return new_state, {k: shd.reduce_partials(v) if shd.is_dtensor(v)
                           else v for k, v in metrics.items()}

    return step


def _add32(acc: dict, g: dict) -> dict:
    """``acc + g`` leaf by leaf, g cast to fp32; ``acc`` updated in place
    (the reference's scan carry, which it donates)."""
    for k, a in acc.items():
        if isinstance(a, dict):
            _add32(a, g[k])
        else:
            a.add_(g[k].float())
    return acc


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     oc: OptConfig | None = None, device="cuda") -> dict:
    """Fresh parameters from ``generator`` (``models.model.init_params``),
    zero moments and step 0."""
    params = M.init_params(cfg, generator, device=device)
    md = oc.moments_dtype if oc is not None else "float32"
    return {"params": params, "opt": init_opt_state(params, md),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Shapes and shardings of the train state and the batch
# ---------------------------------------------------------------------------

def _meta(shape: tuple, dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no storage (JAX's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def train_state_shapes(cfg: ModelConfig, oc: OptConfig | None = None) -> dict:
    """The train state as meta tensors: params, AdamW moments (fp32, or
    int8 with an fp32 scale a row, the last dim 1) and the int32 step."""
    ps = _map_leaves(lambda sd: _meta(*sd), M.param_shapes(cfg))
    if oc is not None and oc.moments_dtype == "int8":
        def mo(t):
            return {"q": _meta(t.shape, torch.int8),
                    "s": _meta(t.shape[:-1] + (1,), torch.float32)}
    else:
        def mo(t):
            return _meta(t.shape, torch.float32)
    return {"params": ps,
            "opt": {"m": _map_leaves(mo, ps), "v": _map_leaves(mo, ps)},
            "step": _meta((), torch.int32)}


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec, *,
                 with_targets: bool = True) -> dict:
    """One step's batch as meta tensors (a decode shape has one token a
    row)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        s = 1
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = _meta((b, s), torch.int32)
    else:
        out["embeds"] = _meta((b, s, cfg.d_model), M.DTYPES[cfg.param_dtype])
    if cfg.rope_kind == "mrope":
        out["positions"] = _meta((3, b, s), torch.int32)
    if with_targets and shape.kind == "train":
        out["targets"] = _meta((b, s), torch.int32)
    return out


def batch_pspecs(cfg: ModelConfig, shapes: dict, rules: dict,
                 mesh_sizes: dict) -> dict:
    """Specs of :func:`batch_shapes`: rows on ``batch`` (M-RoPE's
    ``positions`` carry the batch second)."""
    def f(name, t):
        if name == "positions" and t.ndim == 3 and t.shape[0] == 3:
            axes = (None, "batch", None)
        else:
            axes = ("batch",) + (None,) * (t.ndim - 1)
        return spec_for(tuple(t.shape), axes, rules, mesh_sizes)
    return {k: f(k, v) for k, v in shapes.items()}


def train_state_pspecs(cfg: ModelConfig, rules: dict, mesh_sizes: dict,
                       oc: OptConfig | None = None) -> dict:
    """Specs of :func:`train_state_shapes`: the moments on their
    params' specs, an int8 moment's scale with its last dim unsharded."""
    pp = M.param_pspecs(cfg, rules, mesh_sizes)
    if oc is not None and oc.moments_dtype == "int8":
        def mo(spec):
            return {"q": spec,
                    "s": P(*(tuple(spec)[:-1] + (None,))) if spec else P()}
        mom = _map_leaves(mo, pp)
        return {"params": pp, "opt": {"m": mom, "v": mom}, "step": P()}
    return {"params": pp, "opt": {"m": pp, "v": pp}, "step": P()}


def default_accum_steps(cfg: ModelConfig, shape: ShapeSpec,
                        mesh_sizes: dict, budget_bytes: float = 2.5e9) -> int:
    """Pick gradient-accumulation steps so the per-device stored scan
    carries (residual stream per layer under full remat) fit the budget."""
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh_sizes.get(ax, 1)
    b_loc = max(1, shape.global_batch // dp)
    carry = b_loc * shape.seq_len * cfg.d_model * 2 * cfg.n_layers
    accum = 1
    while carry / accum > budget_bytes and accum < b_loc:
        accum *= 2
    return accum
