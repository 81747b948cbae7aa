"""Logical-axis sharding rules (MaxText-style) and constraint helpers, on
DTensor.

The counterpart of ``repro/utils/sharding.py``. Parameters, caches and
activations carry *logical* axis names; a rules table maps each logical
name to an ordered list of mesh-axis candidates. :func:`spec_for` assigns
candidates greedily, subject to (a) divisibility of the dim by the
mesh-axis size and (b) no mesh axis used twice in one spec, which is what
lets grok-1's 8 experts fall back from expert-parallel to ffn-dim tensor
parallelism.

A spec is a :class:`P`, a tuple with one entry a dim: ``None``, one mesh
axis, or a tuple of axes (JAX's ``PartitionSpec``, entry for entry).
:func:`placements_for` maps it onto DTensor placements on a
``DeviceMesh`` (``launch/mesh.py``): a named axis becomes ``Shard(dim)``
on its mesh dim, every other mesh dim ``Replicate()``. :func:`distribute`
turns a tree of full tensors, the same on every rank, into DTensors
without a collective (each rank keeps its own shard), and :func:`sc` is
``with_sharding_constraint``: a redistribute to the spec's placements
under the mesh and rules :func:`use_mesh_rules` installs (off the
autograd path through :func:`relayout`, whose gathers are c10d's).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

# Meta mesh-axis groups, expanded against the live mesh's axis names.
FSDP = ("pod", "data")
TP = ("model",)
DATA = ("pod", "data")

TRAIN_RULES = {
    "batch": DATA,
    "act_batch": DATA,      # activation batch dim at block boundaries
    "act_embed": (),        # activation d_model dim at block boundaries
    "embed": FSDP,          # FSDP: weight d_model rows sharded, gathered at use
    "mlp": TP,
    "qheads": TP,
    "kvheads": TP,
    "vocab": TP,
    "expert": TP,
    "emlp": TP,             # fallback when expert-count doesn't divide TP
    "ssm_inner": TP,
    "slstm_h": TP,
    "kv_seq": TP,           # decode KV-cache sequence dim
    "stack": (),            # scan-stacked leading dim: never sharded
    None: (),
}

# Serving: no FSDP on weights by default (pure TP).
SERVE_RULES = dict(TRAIN_RULES, embed=())

# Serve-engine rules: the KV cache shards over *heads* (kvheads -> TP)
# with the sequence dim resident, since the split-KV and paged decode
# kernels tile the sequence themselves.
SERVE_ENGINE_RULES = dict(SERVE_RULES, kv_seq=())

# FSDP-flavored engine rules: same KV layout, activations 2-D sharded.
SERVE_ENGINE_FSDP_RULES = dict(SERVE_ENGINE_RULES, act_batch=(),
                               act_embed=FSDP)

# FSDP serving for models larger than one device's memory: every matmul
# a partial sum over resident 2-D-sharded weights plus an activation
# all-reduce, instead of a weight all-gather a layer.
SERVE_FSDP_RULES = dict(TRAIN_RULES, act_batch=(), act_embed=FSDP)

# The gather baseline: weights FSDP-sharded, activations batch-sharded,
# so every layer's weights are all-gathered a step.
SERVE_FSDP_GATHER_RULES = dict(TRAIN_RULES)


class P(tuple):
    """A partition spec: one entry a dim, ``None``, a mesh axis name or a
    tuple of them (JAX's ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class _MeshState(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = None


_STATE = _MeshState()


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict | None):
    """Install ``mesh`` and ``rules`` for this thread: :func:`sc` and the
    model's sharded paths read them."""
    prev = (_STATE.mesh, _STATE.rules)
    _STATE.mesh, _STATE.rules = mesh, rules
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def current_mesh():
    """The mesh :func:`use_mesh_rules` installed on this thread, or None."""
    return _STATE.mesh if _STATE.rules is not None else None


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def tp_degree(mesh_sizes: dict, rules: dict | None = None) -> int:
    """Tensor-parallel degree of a mesh under ``rules``: the product of
    the mesh-axis sizes the ``kvheads`` logical axis may shard over
    (missing axes count 1, so ``mesh_sizes={}`` has degree 1)."""
    axes = (rules or {}).get("kvheads", TP)
    prod = 1
    for a in axes:
        prod *= int(mesh_sizes.get(a, 1))
    return prod


def rules_fingerprint(rules: dict | None) -> tuple:
    """Stable, hashable identity of a rules table (plan memo keys)."""
    if rules is None:
        return ()
    return tuple(sorted((str(k), tuple(v)) for k, v in rules.items()))


def spec_for(shape: tuple, axes: tuple, rules: dict, mesh_sizes: dict) -> P:
    """Build a :class:`P` for ``shape`` with logical ``axes`` under
    ``rules``."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        picked = []
        prod = 1
        for m in rules.get(ax, ()):
            if m in used or m not in mesh_sizes:
                continue
            if dim % (prod * mesh_sizes[m]) != 0:
                continue
            picked.append(m)
            prod *= mesh_sizes[m]
        used.update(picked)
        if not picked:
            parts.append(None)
        elif len(picked) == 1:
            parts.append(picked[0])
        else:
            parts.append(tuple(picked))
    return P(*parts)


def placements_for(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on the
    mesh dim of each axis a spec entry names, ``Replicate()`` elsewhere.

    A tuple of axes on one dim splits it by each axis in turn, major to
    minor, as JAX's ``NamedSharding`` does; DTensor splits in mesh-dim
    order, so the tuple must name its axes in the mesh's order. A mesh
    dim of size 1 holds the whole dim either way and stays
    ``Replicate()``, so that DTensor's view rules (a matmul flattening a
    batch of one) meet no sharded dim there.
    """
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} splits dim {dim} out of "
                             f"the mesh's axis order {names}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def local_shape(shape: tuple, mesh, placements) -> tuple:
    """The shape of this rank's shard of a ``shape`` tensor (specs from
    :func:`spec_for` divide evenly)."""
    out = list(shape)
    for size, pl in zip(mesh.shape, placements):
        if pl.is_shard():
            out[pl.dim] //= size
    return tuple(out)


def shard_owner(mesh, placements, dim: int, size: int, index: int):
    """Where global ``index`` of dim ``dim`` (``size`` long) lives: its
    index in this rank's shard, or None when another rank's shard holds
    it."""
    off, n = shard_offset(mesh, placements, dim, size)
    return index - off if off <= index < off + n else None


def _own(local: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``local`` not keeping ``full``'s storage alive (a shard is a view)."""
    if local.numel() < full.numel() and \
            local.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr():
        return local.clone()
    return local


def distribute_leaf(t: torch.Tensor, mesh, spec):
    """A full tensor, the same on every rank, as a DTensor laid out by
    ``spec``; each rank keeps its own shard, no collective is made, and
    the shard does not hold the full tensor's storage."""
    pl = placements_for(mesh, spec)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
    d = distribute_tensor(t, mesh, pl, src_data_rank=None)
    return DTensor.from_local(_own(d.to_local(), t), mesh, pl,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def spec_at(specs: dict, path: tuple):
    """The spec at ``path`` of a spec tree."""
    for key in path:
        specs = specs[key]
    return specs


def placer(mesh, specs: dict):
    """``place(path, leaf)`` for ``models.model.init_params``: each leaf,
    made whole and alike on every rank, becomes the DTensor of its spec
    in ``specs`` (:func:`distribute_leaf`), so a rank holds its shards
    and one whole leaf at a time."""
    return lambda path, leaf: distribute_leaf(leaf, mesh,
                                              spec_at(specs, path))


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def distribute(tree, mesh, specs):
    """A tree of full tensors as DTensors laid out by the matching tree of
    specs (:func:`distribute_leaf` a leaf)."""
    return _map2(lambda t, s: distribute_leaf(t, mesh, s), tree, specs)


def from_shard(local: torch.Tensor, mesh, placements, shape: tuple):
    """A DTensor of global ``shape`` (contiguous) from this rank's shard
    ``local``; no collective is made."""
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def as_replicated(t: torch.Tensor, mesh):
    """A plain tensor, the same on every rank, as a replicated DTensor
    (no collective); a DTensor passes through."""
    if is_dtensor(t):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def put(t, mesh, placements):
    """``t`` (a plain tensor counts as replicated) on ``placements``:
    differentiably under autograd (DTensor's redistribute), by
    :func:`relayout` (c10d gathers) otherwise."""
    t = as_replicated(t, mesh)
    if tuple(t.placements) == tuple(placements):
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return t.redistribute(mesh, placements)
    return relayout(t, placements)


def zeros(shape: tuple, dtype, mesh, spec, device):
    """A zero DTensor of global ``shape`` laid out by ``spec``, made shard
    by shard (no rank holds the full tensor)."""
    pl = placements_for(mesh, spec)
    local = torch.zeros(local_shape(shape, mesh, pl), dtype=dtype,
                        device=device)
    return from_shard(local, mesh, pl, tuple(shape))


def local(tree):
    """A tree of DTensors as this rank's shards (views: writes land in
    the DTensors); plain tensors pass through."""
    if isinstance(tree, dict):
        return {k: local(v) for k, v in tree.items()}
    return tree.to_local() if is_dtensor(tree) else tree


def shard_offset(mesh, placements, dim: int, size: int) -> tuple:
    """``(offset, length)`` of this rank's block of dim ``dim`` (``size``
    long) under ``placements`` (even shards, as :func:`spec_for` makes
    them)."""
    block, chunk = size, 0
    coords = mesh.get_coordinate()
    for m, pl in enumerate(placements):
        if pl.is_shard() and pl.dim == dim:
            n = mesh.shape[m]
            block //= n
            chunk = chunk * n + coords[m]
    return chunk * block, block


def relayout(x, placements):
    """``x`` (a DTensor) redistributed to ``placements``, each shard that
    must be gathered gathered by ``torch.distributed.all_gather_into_tensor``
    on its mesh dim's group, minor to major; partial sums are
    all-reduced and shards cut by DTensor (no gather in either). Not
    DTensor's own gather: its functional all-gather kills the rank on a
    gloo group over CUDA tensors (torch 2.11), where the c10d call works
    (``scripts/gloo_cuda_probe.py``), and two ranks on one card run over
    gloo. Not differentiable: the autograd path redistributes with
    DTensor."""
    import torch.distributed as dist
    mesh = x.device_mesh
    want = tuple(placements)
    if tuple(x.placements) == want:
        return x
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    cur = list(x.placements)
    gather = [m for m in range(mesh.ndim)
              if cur[m].is_shard() and want[m] != cur[m]]
    # a dim sharded further by a minor mesh dim that stays: DTensor's
    if any(cur[m2].is_shard() and cur[m2].dim == cur[m].dim
           and m2 not in gather for m in gather
           for m2 in range(m + 1, mesh.ndim)):
        return x.redistribute(mesh, want)
    t = x.to_local()
    for m in reversed(gather):
        d = cur[m].dim
        part = t.movedim(d, 0).contiguous()
        out = part.new_empty((mesh.shape[m] * part.shape[0],)
                             + part.shape[1:])
        dist.all_gather_into_tensor(out, part, group=mesh.get_group(m))
        t = out.movedim(0, d)
        cur[m] = Replicate()
    shape = tuple(x.shape)
    t = from_shard(t.contiguous(), mesh, tuple(cur), shape)
    return t if tuple(cur) == want else t.redistribute(mesh, want)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank, as a plain tensor; a plain tensor passes
    through. Gathered by :func:`relayout` (c10d all-gathers)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    return relayout(x, (Replicate(),) * mesh.ndim).to_local().contiguous()


class _SumOverGroups(torch.autograd.Function):
    """Sum (or average) a local tensor over the ranks of ``groups``, an
    all-reduce a group; the backward pass hands the gradient through
    unchanged (Megatron's ``g``): the caller reads it as the gradient of
    the reduced whole, replicated."""

    @staticmethod
    def forward(ctx, t, groups, mean):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            t = funcol.all_reduce(t, "sum", g)
            if mean:
                t = t / g.size()
        return funcol.wait_tensor(t) if groups else t

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def sum_over(t: torch.Tensor, groups, mean: bool = False) -> torch.Tensor:
    """``t`` summed (``mean``: averaged) over the ranks of each process
    group in ``groups``, differentiably (:class:`_SumOverGroups`)."""
    return _SumOverGroups.apply(t, tuple(groups), mean)


class _SumShared(torch.autograd.Function):
    """Sum a local tensor over the ranks of ``groups`` (an all-reduce a
    group) where each rank then uses the sum in its own way (its own
    channels of a row-parallel product's consumer): the backward pass
    sums the ranks' gradients the same way."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return _all_reduce(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, "sum", g)
    return funcol.wait_tensor(t) if groups else t


def sum_shared(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` summed over the ranks of each process group in ``groups``,
    differentiably, the gradient summed likewise (:class:`_SumShared`)."""
    return _SumShared.apply(t, tuple(groups))


def reduce_partials(x):
    """A DTensor's partial sums or means all-reduced (its ``Partial`` mesh
    dims made ``Replicate``) such that the backward pass takes the
    gradient as replicated: DTensor's own redistribute hands back a
    partial gradient, and a matmul's backward then gathers the other
    operand. Other placements stay; partial maxima and minima are
    DTensor's to reduce."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    mesh = x.device_mesh
    out = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    ops = {p.reduce_op for p in x.placements if p.is_partial()}
    if len(ops) != 1 or ops - {"sum", "avg"}:
        return x.redistribute(mesh, out)
    groups = [mesh.get_group(m) for m, p in enumerate(x.placements)
              if p.is_partial()]
    loc = x.to_local(grad_placements=out)
    return DTensor.from_local(sum_over(loc, groups, ops == {"avg"}), mesh,
                              out, run_check=False, shape=x.shape,
                              stride=x.stride())


def whole_dim(x, dim: int):
    """A DTensor with dim ``dim`` whole on every rank (its partial sums
    reduced, :func:`reduce_partials`; the mesh dims that shard it made
    ``Replicate``, differentiably under autograd, by :func:`relayout`
    otherwise); a plain tensor passes through. Before a view splits the
    dim into pieces its shards may not divide (heads)."""
    if not is_dtensor(x):
        return x
    x = reduce_partials(x)
    d = dim % x.ndim
    return put(x, x.device_mesh,
               tuple(Replicate() if p.is_shard() and p.dim == d else p
                     for p in x.placements))


def gather_fsdp(w):
    """A weight with its FSDP shards gathered for use (the mesh dims the
    installed rules put ``embed`` on made ``Replicate``), where the rules
    keep activations whole on ``d_model`` (``act_embed`` empty: training,
    the FSDP gather baseline). Under the resident-2-D rules the weight
    stays sharded and its products are partial sums. Anything else comes
    back as it is."""
    mesh, rules = _STATE.mesh, _STATE.rules
    if mesh is None or rules is None or not is_dtensor(w) \
            or rules.get("act_embed"):
        return w
    fsdp = set(rules.get("embed", ()))
    names = w.device_mesh.mesh_dim_names
    return put(w, w.device_mesh,
               tuple(Replicate() if p.is_shard() and names[m] in fsdp else p
                     for m, p in enumerate(w.placements)))


def sc(x, *axes):
    """``with_sharding_constraint`` against the installed mesh and rules:
    ``x`` redistributed to the placements of its spec under the rules.
    ``x`` comes back untouched when no mesh is installed or it is not a
    DTensor."""
    mesh, rules = _STATE.mesh, _STATE.rules
    if mesh is None or rules is None or not is_dtensor(x):
        return x
    spec = spec_for(tuple(x.shape), tuple(axes), rules,
                    mesh_axis_sizes(mesh))
    pl = placements_for(mesh, spec)
    if tuple(x.placements) == pl:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return x.redistribute(mesh, pl)     # differentiable
    return relayout(x, pl)
