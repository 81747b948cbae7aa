"""Model assembly (counterpart of ``repro/models/model.py``): parameter
and cache tables, initialization, and the train/prefill/decode forward
pass.

Parameters live in a plain dict with the JAX tree's names and layouts:
``tok_embed (V,d)`` (token-id models only), ``scan/<j>/{ln1, mixer/...,
ln2, ffn/...}`` with a leading layer axis on every ``scan`` leaf,
``tail/<i>/...``, ``final_norm`` and ``lm_head (d,V)``. A mixer is
attention (``wq (d,H,Dh)``, ``wk``/``wv (d,Hkv,Dh)``, ``wo (H,Dh,d)``
[, biases][, q/k norms]), Mamba (``models/ssm.py``), mLSTM or sLSTM
(``models/xlstm.py``); an FFN is dense (``w_gate``, ``w_up (d,F)``,
``w_down (F,d)``) or MoE (``router (d,E)`` and stacked experts,
``models/moe.py``). The cache mirrors the blocks: attention ``{k, v}``
of shape (L, B, S, Hkv, Dh) in the parameter dtype, recurrent state
(Mamba ``{h, conv}``, mLSTM ``{c, n, m}``, sLSTM ``{c, n, h, m}``) in
fp32. The JAX layer scan becomes a loop over the stacked leaves.

Under a mesh (``utils.sharding.use_mesh_rules``, installed by the serve
engines) the parameters and the cache are DTensors laid out by
:func:`param_pspecs` and :func:`cache_pspecs`, and DTensor's sharding
propagation plays GSPMD's part: it all-reduces after the attention
out-projection and the FFN down-projection and makes the vocab-sharded
embedding a masked lookup; the vocab-sharded logits are gathered whole
on every rank before sampling (``sharding.replicated``). :func:`sc`
constrains the layouts at the reference's points. Attention runs on each rank's local head shard through
``local_map`` (:func:`_on_local_heads`), the counterpart of a Pallas
kernel launched per shard: the decode kernels write and read the rank's
cache shard in place. A KV cache sharded on its sequence (``kv_seq``
over ``model``, the ``SERVE_RULES`` and ``TRAIN_RULES`` layouts) is read
by distributed flash-decoding (:func:`_decode_on_seq_shards`): each rank
runs the decode kernel's partials over its own rows and the ranks'
partials merge by log-sum-exp. The recurrent mixers and the MoE experts
run their cores on each rank's shards through ``local_map``, their
placements derived from the input's layout (:func:`_on_shards`): Mamba
on its channels (``ssm_inner``), mLSTM and sLSTM on their heads, the
experts on ``expert`` or on their FFN width (``emlp``), with the
reference's parameter placements; their time loops then run on local
tensors, their states are written into the cache shards in place, and
their collectives are all-reduces. Training runs under a mesh too
(``TRAIN_RULES``: FSDP on ``embed``, TP on ``model``), DTensor's
autograd differentiating it. With no mesh installed no DTensor appears
and the ops are the unsharded path's.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Placement, Replicate, Shard
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import pos_vector
from repro_torch.kernels import stores as stores_lib
from repro_torch.kernels.attention import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.utils import sharding as shd
from repro_torch.utils.sharding import sc, spec_for

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: init kinds whose leaves are fp32 whatever the parameter dtype
FP32_INITS = ("alog", "dtbias")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter leaf: shape, logical axis names, and initializer."""

    shape: tuple
    axes: tuple
    init: str = "normal"     # normal|zeros|ones|embed|alog|dtbias


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
    p = {
        "wq": ParamDef((d, h, dh), ("embed", "qheads", None)),
        "wk": ParamDef((d, hkv, dh), ("embed", "kvheads", None)),
        "wv": ParamDef((d, hkv, dh), ("embed", "kvheads", None)),
        "wo": ParamDef((h, dh, d), ("qheads", None, "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDef((h, dh), ("qheads", None), "zeros")
        p["bk"] = ParamDef((hkv, dh), ("kvheads", None), "zeros")
        p["bv"] = ParamDef((hkv, dh), ("kvheads", None), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((dh,), (None,), "ones")
        p["k_norm"] = ParamDef((dh,), (None,), "ones")
    return p


def _ffn_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": ParamDef((d, f), ("embed", "mlp")),
         "w_down": ParamDef((f, d), ("mlp", "embed"))}
    if cfg.ffn_act == "swiglu":
        p["w_gate"] = ParamDef((d, f), ("embed", "mlp"))
    return p


def _moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": ParamDef((d, e), ("embed", None)),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "emlp")),
        "w_down": ParamDef((e, f, d), ("expert", "emlp", "embed")),
    }
    if cfg.ffn_act == "swiglu":
        p["w_gate"] = ParamDef((e, d, f), ("expert", "embed", "emlp"))
    return p


def _mamba_defs(cfg: ModelConfig) -> dict:
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_d_state,
                      cfg.dt_rank, cfg.ssm_conv_dim)
    return {
        "in_x": ParamDef((d, di), ("embed", "ssm_inner")),
        "in_z": ParamDef((d, di), ("embed", "ssm_inner")),
        "conv_w": ParamDef((k, di), (None, "ssm_inner")),
        "conv_b": ParamDef((di,), ("ssm_inner",), "zeros"),
        "x_dbc": ParamDef((di, r + 2 * n), ("ssm_inner", None)),
        "dt_w": ParamDef((r, di), (None, "ssm_inner")),
        "dt_b": ParamDef((di,), ("ssm_inner",), "dtbias"),
        "a_log": ParamDef((di, n), ("ssm_inner", None), "alog"),
        "d_skip": ParamDef((di,), ("ssm_inner",), "ones"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _mlstm_defs(cfg: ModelConfig) -> dict:
    d, di, h = cfg.d_model, cfg.xlstm_d_inner, cfg.n_heads
    return {
        "up_x": ParamDef((d, di), ("embed", "ssm_inner")),
        "up_z": ParamDef((d, di), ("embed", "ssm_inner")),
        "wq": ParamDef((di, di), ("ssm_inner", None)),
        "wk": ParamDef((di, di), ("ssm_inner", None)),
        "wv": ParamDef((di, di), ("ssm_inner", None)),
        "w_if": ParamDef((di, 2, h), ("ssm_inner", None, None)),
        "b_if": ParamDef((2, h), (None, None), "zeros"),
        "out": ParamDef((di, di), ("ssm_inner", None)),
        "down": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def _slstm_defs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "w": ParamDef((d, 4, d), ("embed", None, "slstm_h")),
        "b": ParamDef((4, d), (None, "slstm_h"), "zeros"),
        "r": ParamDef((h, dh, 4, dh), (None, None, None, None)),
        "out": ParamDef((d, d), ("slstm_h", "embed")),
    }


_MIXER_DEFS = {
    "attn": _attn_defs, "attn_local": _attn_defs,
    "mamba": _mamba_defs, "mlstm": _mlstm_defs, "slstm": _slstm_defs,
}


def block_defs(cfg: ModelConfig, blk: str) -> dict:
    """ParamDef tree of one layer block (``mixer:ffn`` plan entry)."""
    mixer, ffn = blk.split(":")
    p = {"ln1": ParamDef((cfg.d_model,), (None,), "ones"),
         "mixer": _MIXER_DEFS[mixer](cfg)}
    if ffn != "none":
        p["ln2"] = ParamDef((cfg.d_model,), (None,), "ones")
        p["ffn"] = _ffn_defs(cfg) if ffn == "dense" else _moe_defs(cfg)
    return p


def model_defs(cfg: ModelConfig) -> dict:
    """Whole-model ParamDef tree (embeddings, scan stack, tail, head)."""
    plan = cfg.layer_plan()
    n_rep, unit, n_tail = cfg.scan_split()
    defs = {}
    if cfg.embed_inputs:
        defs["tok_embed"] = ParamDef((cfg.vocab_size, cfg.d_model),
                                     ("vocab", "embed"), "embed")
    if n_rep > 0:
        defs["scan"] = {str(j): block_defs(cfg, plan[j]) for j in range(unit)}
    defs["tail"] = {str(i): block_defs(cfg, plan[n_rep * unit + i])
                    for i in range(n_tail)}
    defs["final_norm"] = ParamDef((cfg.d_model,), (None,), "ones")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    return defs


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytic parameter count (the JAX package's ``count_params``, used
    for 6ND). active_only: MoE experts counted as top-k."""
    total = 0
    for blk in cfg.layer_plan():
        for _, d in _walk(block_defs(cfg, blk)):
            n = math.prod(d.shape)
            if active_only and d.shape and d.shape[0] == cfg.n_experts \
                    and len(d.shape) == 3 and cfg.n_experts > 0:
                n = n * cfg.experts_per_token // cfg.n_experts
            total += n
    total += cfg.d_model  # final norm
    if cfg.embed_inputs:
        total += cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    return total


def _walk(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _set(tree: dict, path: tuple, val) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def _stacked(defs: dict, cfg: ModelConfig):
    """(path, ParamDef, stack) over the model's defs; ``stack`` is the
    leading layer count of a ``scan`` leaf, else None."""
    n_rep = cfg.scan_split()[0]
    for path, d in _walk(defs):
        yield path, d, (n_rep if path[0] == "scan" else None)


def param_shapes(cfg: ModelConfig) -> dict:
    """``(shape, dtype)`` for every leaf of the parameter tree."""
    dtype = DTYPES[cfg.param_dtype]
    out: dict = {}
    for path, d, stack in _stacked(model_defs(cfg), cfg):
        _set(out, path, (((stack,) + d.shape) if stack else d.shape,
                         torch.float32 if d.init in FP32_INITS else dtype))
    out.setdefault("tail", {})
    return out


def _pspecs(cfg: ModelConfig, defs: dict, rules: dict,
            mesh_sizes: dict) -> dict:
    """Spec tree of a ParamDef tree, ``scan`` leaves led by ``stack``."""
    n_rep = cfg.scan_split()[0]
    out: dict = {"tail": {}}
    for path, d in _walk(defs):
        stacked = path[0] == "scan"
        shape = ((n_rep,) + d.shape) if stacked else d.shape
        axes = (("stack",) + d.axes) if stacked else d.axes
        _set(out, path, spec_for(shape, axes, rules, mesh_sizes))
    return out


def param_pspecs(cfg: ModelConfig, rules: dict, mesh_sizes: dict) -> dict:
    """Spec tree matching :func:`model_defs` under ``rules``."""
    return _pspecs(cfg, model_defs(cfg), rules, mesh_sizes)


def _init_std(d: ParamDef) -> float:
    """The JAX package's init scale (``model._init_one``)."""
    if d.init == "embed":
        return 0.02
    if len(d.shape) < 2:
        fan = d.shape[0]
    elif d.axes[-1] == "embed":
        fan = math.prod(d.shape[:-1])
    else:
        fan = d.shape[0]
    return 1.0 / math.sqrt(max(1, fan))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", place=None) -> dict:
    """Materialize parameters with the JAX package's init rule.

    Normal leaves are N(0, std^2) with std from the fan-in (0.02 for the
    embedding), ``ln`` and norm leaves are ones, biases zeros; Mamba's
    ``a_log`` is log(1 .. N) in every row (S4D-real) and ``dt_b`` is
    softplus^-1(0.01), both fp32. Numbers
    come from ``generator`` (which must live on ``device``), leaf by leaf
    in sorted tree order and layer by layer, so a seed fixes the weights;
    they are not the JAX package's numbers (use ``bridge.params_from_jax``
    for those). ``place(path, leaf)``, when given, replaces each leaf as
    it is made (a rank keeping its shard, ``utils.sharding.distribute_leaf``),
    so the whole tree is never held at once.
    """
    dtype = DTYPES[cfg.param_dtype]
    out: dict = {"tail": {}}
    for path, d, stack in _stacked(model_defs(cfg), cfg):
        shape = ((stack,) + d.shape) if stack else d.shape
        if d.init in ("ones", "zeros"):
            fill = torch.ones if d.init == "ones" else torch.zeros
            leaf = fill(shape, dtype=dtype, device=device)
        elif d.init == "alog":
            base = torch.log(torch.arange(1, d.shape[-1] + 1,
                                          dtype=torch.float32, device=device))
            leaf = base.expand(shape).contiguous()
        elif d.init == "dtbias":
            leaf = torch.full(shape, math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=device)
        else:
            std = _init_std(d)
            leaf = torch.empty(shape, dtype=dtype, device=device)
            for sl in (leaf if stack else (leaf,)):
                sl.copy_(torch.randn(sl.shape, generator=generator,
                                     device=device) * std)
        _set(out, path, leaf if place is None else place(path, leaf))
    return out


# ---------------------------------------------------------------------------
# Cache tables
# ---------------------------------------------------------------------------

def _cache_defs(cfg: ModelConfig, blk: str, batch: int, seq: int) -> dict:
    """The decode state of one block. A KV leaf's second axis is
    ``kv_seq``; that is how the KV leaves are told from recurrent ones."""
    mixer = blk.split(":")[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
    if mixer in ("attn", "attn_local"):
        # full-length cache for local layers too (the window masks at use)
        kv = ParamDef((batch, seq, hkv, dh),
                      ("batch", "kv_seq", "kvheads", None), "zeros")
        return {"k": kv, "v": kv}
    if mixer == "mamba":
        di, n, k = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_conv_dim
        return {"h": ParamDef((batch, di, n), ("batch", "ssm_inner", None),
                              "zeros"),
                "conv": ParamDef((batch, k - 1, di),
                                 ("batch", None, "ssm_inner"), "zeros")}
    if mixer == "mlstm":
        dh_i = cfg.xlstm_d_inner // h
        return {"c": ParamDef((batch, h, dh_i, dh_i),
                              ("batch", "qheads", None, None), "zeros"),
                "n": ParamDef((batch, h, dh_i), ("batch", "qheads", None),
                              "zeros"),
                "m": ParamDef((batch, h), ("batch", "qheads"), "zeros")}
    if mixer == "slstm":
        d = cfg.d_model
        vec = ParamDef((batch, d), ("batch", "slstm_h"), "zeros")
        return {"c": vec, "n": vec, "h": vec,
                "m": ParamDef((batch, h), ("batch", None), "zeros")}
    raise ValueError(mixer)


def cache_defs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Decode-cache ParamDef tree (KV, SSM or xLSTM state per block)."""
    plan = cfg.layer_plan()
    n_rep, unit, n_tail = cfg.scan_split()
    out: dict = {"tail": {str(i): _cache_defs(cfg, plan[n_rep * unit + i],
                                              batch, seq)
                          for i in range(n_tail)}}
    if n_rep > 0:
        out["scan"] = {str(j): _cache_defs(cfg, plan[j], batch, seq)
                       for j in range(unit)}
    return out


def is_kv(d: ParamDef) -> bool:
    """True for an attention KV cache leaf (paged in a page pool)."""
    return d.axes[1] == "kv_seq"


def has_attention(cfg: ModelConfig) -> bool:
    """Whether any block attends (and so reads a KV cache at decode)."""
    return any(b.split(":")[0] in ("attn", "attn_local")
               for b in cfg.layer_plan())


def state_leaves(cfg: ModelConfig, cache: dict) -> list:
    """The recurrent leaves of a cache (dense or paged): every leaf but
    the attention KV, in the cache's sorted order."""
    return [t for (_, d), (_, t) in zip(_walk(cache_defs(cfg, 1, 1)),
                                        _walk(cache)) if not is_kv(d)]


def cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``(shape, dtype)`` for every leaf of the decode cache: KV leaves in
    the parameter dtype, recurrent state in fp32."""
    n_rep = cfg.scan_split()[0]
    out: dict = {"tail": {}}
    for path, d in _walk(cache_defs(cfg, batch, seq)):
        shape = ((n_rep,) + d.shape) if path[0] == "scan" else d.shape
        _set(out, path, (shape, DTYPES[cfg.param_dtype] if is_kv(d)
                         else torch.float32))
    return out


def cache_pspecs(cfg: ModelConfig, rules: dict, mesh_sizes: dict,
                 batch: int, seq: int) -> dict:
    """Spec tree matching :func:`cache_defs` under ``rules``."""
    return _pspecs(cfg, cache_defs(cfg, batch, seq), rules, mesh_sizes)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device="cuda", mesh=None, specs: dict | None = None) -> dict:
    """Zero-filled decode cache matching :func:`cache_shapes`; with a
    ``mesh``, DTensors laid out by ``specs`` (:func:`cache_pspecs`), each
    rank allocating its shard alone."""
    out: dict = {"tail": {}}
    for path, (shape, dtype) in _walk(cache_shapes(cfg, batch, seq)):
        _set(out, path, torch.zeros(shape, dtype=dtype, device=device)
             if mesh is None else
             shd.zeros(shape, dtype, mesh, shd.spec_at(specs, path), device))
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _project(x, w, b=None):
    """x: (B,S,d) @ w: (d,H,Dh) [+ b: (H,Dh)] -> (B,S,H,Dh).

    The bias is a separate add after the product has been rounded to
    x's dtype, as JAX's einsum then ``+ b`` rounds it (a fused ``addmm``
    would round once)."""
    d, h, dh = w.shape
    y = (x @ w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)
    return y if b is None else y + b


def _attn_mixer(cfg: ModelConfig, p: dict, x, *, local: bool, mode: str,
                rope, cache, pos, cache_len, impl: str, kv_len,
                store_flavor, block_tables):
    b, s, _ = x.shape
    q = _project(x, p["wq"], p.get("bq"))
    k = _project(x, p["wk"], p.get("bk"))
    v = _project(x, p["wv"], p.get("bv"))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope is not None:
        q, k = L.rotate(q, *rope), L.rotate(k, *rope)
    window = cfg.sliding_window if local else None
    new_cache = None
    if mode == "decode":
        # the new K and V rows are written into the cache in place by the
        # decode call itself, then read: a dense slot cache at rows pos ..
        # pos + Sq - 1 (the start clamped as JAX's dynamic_update_slice
        # clamps it), a page pool (P, page, Hkv, Dh) at the page its block
        # table names for the current logical page, as the reference's
        # scatter writes it. The engine has made every page a chunk writes
        # exist and be exclusively held (copy on write done), so the
        # in-place write never reaches a shared page. Attention reads the
        # whole cache bounded by kv_len (no slice, no copy).
        y = _decode_on_local_heads(q, cache["k"], cache["v"], pos, k, v,
                                   block_tables, window=window, impl=impl,
                                   kv_len=kv_len, store_flavor=store_flavor)
        # the cache keeps its layout: page pools pool-resident with heads
        # on TP, slot caches on the slot-cache layout (no-ops unmeshed)
        axes = (None, None, "kvheads", None) if block_tables is not None \
            else ("batch", "kv_seq", "kvheads", None)
        for name in ("k", "v"):
            if sc(cache[name], *axes) is not cache[name]:
                raise RuntimeError(f"decode cache {name!r} is off its "
                                   "layout: the in-place write would not "
                                   "land in it")
        new_cache = cache
    else:
        y = _on_local_heads(
            lambda q, k, v: attn_lib.chunked_causal_attention(
                q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                window=window), q, k, v)
        if mode == "prefill":
            dtype = DTYPES[cfg.param_dtype]
            kd, vd = k.to(dtype), v.to(dtype)
            if cache_len is not None and cache_len > s:
                kd, vd = (_on_local_heads(
                    lambda t: stores_lib.pad_to_horizon(
                        t, cache_len, flavor=store_flavor), t)
                    for t in (kd, vd))
            new_cache = {"k": sc(kd, "batch", "kv_seq", "kvheads", None),
                         "v": sc(vd, "batch", "kv_seq", "kvheads", None)}
    h, dh, d = p["wo"].shape
    out = y.reshape(b, s, h * dh) @ p["wo"].reshape(h * dh, d)
    return out, new_cache


def _on_local_heads(fn, q, *rest):
    """``fn(q, *rest)`` on each rank's local shards when ``q`` is a
    DTensor (``local_map``; ``rest`` are put on ``q``'s placements, the
    result comes back on them), else on the tensors themselves. Attention
    over a head shard needs nothing of the others. KV heads that the
    query heads' shards do not divide (4 over 16 ranks) stay whole on
    every rank, and each rank takes the KV heads of its own query heads
    (:func:`_kv_for_local_heads`)."""
    if not shd.is_dtensor(q):
        return fn(q, *rest)
    pl = tuple(q.placements)
    rest = tuple(_kv_for_local_heads(t, q) for t in rest)
    return local_map(fn, out_placements=list(pl),
                     in_placements=(pl,) * (1 + len(rest)),
                     device_mesh=q.device_mesh)(q, *rest)


def _kv_for_local_heads(t, q):
    """``t`` (B, S, Hkv, Dh) on ``q``'s (B, S, H, Dh) placements, each
    rank's KV heads those its query heads attend with. Where ``q``'s head
    shards split the KV heads evenly that is a redistribute; otherwise
    ``t``'s heads are whole on the head-sharding mesh dims and each rank
    picks head ``h // G`` for each of its query heads ``h``."""
    mesh, pl = q.device_mesh, tuple(q.placements)
    h, hkv = q.shape[2], t.shape[2]
    shards = math.prod(mesh.shape[m] for m, p in enumerate(pl)
                       if p.is_shard() and p.dim == 2)
    if hkv % shards == 0:
        return t.redistribute(q.device_mesh, pl)
    whole = tuple(Replicate() if p.is_shard() and p.dim == 2 else p
                  for p in pl)
    t = t.redistribute(mesh, whole)
    off, n = shd.shard_offset(mesh, pl, 2, h)
    idx = torch.arange(off, off + n, device=t.device) // (h // hkv)
    # a rank's picked heads take the gradient of its own query heads: a
    # sum over the head-sharding dims
    grad_pl = tuple(Partial() if p.is_shard() and p.dim == 2 else w
                    for p, w in zip(pl, whole))
    loc = t.to_local(grad_placements=grad_pl).index_select(2, idx)
    return shd.from_shard(loc, mesh, pl, tuple(t.shape[:2]) + (h,)
                          + tuple(t.shape[3:]))


def _decode_on_local_heads(q, kc, vc, pos, k, v, block_tables, **kw):
    """``attention.decode_attention`` writing the step's rows ``k``/``v``
    into the cache ``kc``/``vc`` and attending, on each rank's shards.

    Under a mesh the cache is a DTensor whose shards the kernel writes in
    place, so it crosses the ``local_map`` boundary on its own placements
    (a redistribute would copy it). The KV heads may be sharded, and a
    slot cache's slots; a slot cache sharded on its rows goes to
    :func:`_decode_on_seq_shards`. q and the new rows are put on the
    cache's placements (q's heads follow their KV groups), ``pos`` and
    the block tables on its slot sharding; the output comes back
    heads-sharded. The plain version on the host crosses the same
    boundary as the kernel on the card.
    """
    def run(q, kc, vc, pos, k, v, bt):
        return attn_lib.decode_attention(q, kc, vc, pos, k_new=k, v_new=v,
                                         block_tables=bt, **kw)
    if not shd.is_dtensor(kc):
        return run(q, kc, vc, pos, k, v, block_tables)
    mesh, pl = kc.device_mesh, tuple(kc.placements)
    if block_tables is None and tuple(vc.placements) == pl and any(
            p.is_shard() and p.dim == 1 for p in pl):
        return _decode_on_seq_shards(q, kc, vc, pos, k, v, **kw)
    ok_dims = (2,) if block_tables is not None else (0, 2)
    if tuple(vc.placements) != pl or any(
            p.is_shard() and p.dim not in ok_dims for p in pl):
        raise ValueError(f"decode under a mesh shards the KV cache on "
                         f"heads (and a slot cache on slots or rows), got "
                         f"{pl} / {tuple(vc.placements)}")
    if block_tables is not None and shd.is_dtensor(q) and any(
            p.is_shard() and p.dim == 0 for p in q.placements):
        return _decode_paged_on_slots(q, kc, vc, pos, k, v, block_tables,
                                      **kw)
    rows = tuple(Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
                 for p in pl)
    q, k, v = (shd.put(t, mesh, pl) for t in (q, k, v))
    pos = shd.put(pos, mesh, rows)
    args = (q, kc, vc, pos, k, v)
    in_pl = (pl, pl, pl, rows, pl, pl)
    if block_tables is not None:
        args, in_pl = args + (shd.put(block_tables, mesh, rows),), \
            in_pl + (rows,)
    else:
        args, in_pl = args + (None,), in_pl + (None,)
    return local_map(run, out_placements=list(pl), in_placements=in_pl,
                     device_mesh=mesh)(*args)


def _decode_paged_on_slots(q, kc, vc, pos, k, v, block_tables, **kw):
    """Paged decode with the slots sharded over the data axis: each rank
    runs the paged decode kernel (its fused row write and attention) on
    its own slots against its replica of the page pool (heads on TP, the
    pool and page dims resident, ``pages.paged_cache_pspecs``).

    The pool is one pool on every data shard, as the reference's layout
    has it: a page a slot of one shard writes may be read by a slot of
    another after a fork or a prefix share. So every replica takes every
    slot's new row: the step's rows, positions and block tables are
    gathered whole over the slot shards (a few KB), and each rank writes
    the other shards' rows with the plain row write
    (``stores.ref_paged_row_update``, the reference's scatter) before
    its kernel writes its own and attends."""
    mesh, pl = kc.device_mesh, tuple(kc.placements)
    slot_dims = {m for m, p in enumerate(q.placements)
                 if p.is_shard() and p.dim == 0}
    if any(m in slot_dims for m, p in enumerate(pl) if p.is_shard()):
        raise ValueError(f"a page pool sharded on the slots' mesh dims: {pl}")
    loc = tuple(Shard(0) if m in slot_dims else p for m, p in enumerate(pl))
    rows = tuple(Shard(0) if m in slot_dims else Replicate()
                 for m in range(mesh.ndim))
    whole = (Replicate(),) * mesh.ndim
    b = q.shape[0]
    off, n = shd.shard_offset(mesh, rows, 0, b)
    other = torch.tensor([i for i in range(b) if not off <= i < off + n],
                         dtype=torch.long)
    args = (shd.put(q, mesh, loc), kc, vc, shd.put(pos, mesh, rows),
            shd.put(k, mesh, loc), shd.put(v, mesh, loc),
            shd.put(block_tables, mesh, rows), shd.put(k, mesh, pl),
            shd.put(v, mesh, pl), shd.put(pos, mesh, whole),
            shd.put(block_tables, mesh, whole))

    def run(q, kc, vc, pos, k, v, bt, k_all, v_all, pos_all, bt_all):
        if other.numel():
            idx = other.to(kc.device)
            stores_lib.ref_paged_row_update(
                kc, vc, bt_all.index_select(0, idx),
                k_all.index_select(0, idx), v_all.index_select(0, idx),
                pos_all.index_select(0, idx))
        return attn_lib.decode_attention(q, kc, vc, pos, k_new=k, v_new=v,
                                         block_tables=bt, **kw)
    return local_map(run, out_placements=list(loc),
                     in_placements=(loc, pl, pl, rows, loc, loc, rows, pl,
                                    pl, whole, whole),
                     device_mesh=mesh)(*args)


def _decode_on_seq_shards(q, kc, vc, pos, k, v, *, window=None,
                          impl: str = "auto", kv_len=None,
                          store_flavor=None):
    """Distributed flash-decoding over a slot cache whose rows are
    sharded over one mesh dim (``kv_seq`` on ``model``; slots may be
    sharded too): the counterpart of the reference's decode over a
    sequence-sharded cache, where XLA turns the softmax and value sums
    into cross-device reductions.

    q and the step's new rows are gathered whole over their heads (a few
    KB a step, the cache GBs). Each rank writes the new row of a slot
    only if the row's position falls in its own rows (its shard of rows
    ``off .. off + S_loc - 1``), then runs the decode kernel's partials
    (``ops.flash_decode_partials``, the split-KV kernel without its
    merge) over its rows at positions ``pos - off``: a rank whose rows
    all lie past a slot's position sees none of them, one whose rows lie
    before it sees them all. The partials ``(o, m, l)`` merge over the
    splits, then over the ranks by log-sum-exp: an all-reduce of the
    max, then one of the rescaled sums. The output comes back whole over
    the heads, on the cache's slot sharding.

    The row write and the merges are not fused into the kernel's launch
    as on an unsharded cache: the standard stores write the rows in plain
    PyTorch, non-temporal ones (``store_flavor="nt"``) with the port's
    non-temporal row writer (``stores.kv_row_update``) on the slots the
    rank owns alone (:func:`_write_owned_rows`).
    """
    mesh, pl = kc.device_mesh, tuple(kc.placements)
    seq = [m for m, p in enumerate(pl) if p.is_shard() and p.dim == 1]
    if len(seq) != 1 or any(p.is_shard() and p.dim not in (0, 1)
                            for p in pl):
        raise ValueError(f"sequence-sharded decode takes a slot cache with "
                         f"its rows over one mesh dim (and slots over "
                         f"others), got {pl}")
    group = mesh.get_group(seq[0])
    off, s_loc = shd.shard_offset(mesh, pl, 1, kc.shape[1])
    rows = tuple(Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
                 for p in pl)
    q, k, v = (shd.put(t, mesh, rows) for t in (q, k, v))
    pos = shd.put(pos, mesh, rows)
    bound = None if kv_len is None else max(1, min(int(kv_len) - off, s_loc))
    writes = stores_lib.writes_rows(k, v, store_flavor)
    flavor = stores_lib.executed_flavor(store_flavor)

    def run(q, kc, vc, pos, k, v):
        q = q.contiguous()
        lpos = pos.to(torch.int32) - off
        if writes:
            _write_owned_rows(kc, vc, k, v, lpos, flavor=flavor, impl=impl)
        o, m, l = kops.flash_decode_partials(q, kc, vc, lpos, window=window,
                                             impl=impl, kv_len=bound)
        m_loc = m.amax(0)
        w = torch.exp(m - m_loc[None])
        l_loc = (l * w).sum(0)
        o_loc = (o * w[..., None]).sum(0)
        m_all = funcol.all_reduce(m_loc, "max", group)
        scale = torch.exp(m_loc - m_all)
        both = torch.cat([o_loc * scale[..., None],
                          (l_loc * scale)[..., None]], -1)
        both = funcol.all_reduce(both, "sum", group)
        out = both[..., :-1] / both[..., -1:].clamp_min(1e-30)
        return out.to(q.dtype)
    return local_map(run, out_placements=list(rows),
                     in_placements=(rows, pl, pl, rows, rows, rows),
                     device_mesh=mesh)(q, kc, vc, pos, k, v)


def _write_owned_rows(kc, vc, k, v, lpos, *, flavor: str = "standard",
                      impl: str = "auto") -> None:
    """Write the step's row of each slot into this rank's rows of the
    cache, in place, where the slot's local position ``lpos`` falls in
    them; no rank writes a row it does not own. k, v: (B, 1, Hkv, Dh).

    Standard stores: every slot's row is written, the others' back as
    they were (bit for bit). Non-temporal stores: the row writer
    (``stores.kv_row_update``) clamps a start into ``[0, S_loc - 1]``, as
    JAX's ``dynamic_update_slice`` does, so a slot the rank does not own
    would overwrite its last or first row; it is given the owned slots
    alone, a contiguous run of slots a launch (the owners are read on the
    host)."""
    s_loc = kc.shape[1]
    own = (lpos >= 0) & (lpos < s_loc)
    if flavor != "standard":
        slots = own.nonzero()[:, 0].tolist()
        runs = [[b] for b in slots[:1]]
        for b in slots[1:]:
            if b == runs[-1][-1] + 1:
                runs[-1].append(b)
            else:
                runs.append([b])
        for run in runs:
            lo, hi = run[0], run[-1] + 1
            stores_lib.kv_row_update(kc[lo:hi], vc[lo:hi], k[lo:hi],
                                     v[lo:hi], lpos[lo:hi], flavor=flavor,
                                     impl=impl)
        return
    at = lpos.clamp(0, s_loc - 1).long()
    slots = torch.arange(kc.shape[0], device=kc.device)
    for cache, new in ((kc, k), (vc, v)):
        keep = cache[slots, at]
        cache[slots, at] = torch.where(own[:, None, None],
                                       new[:, 0].to(cache.dtype), keep)


def _write_state(cache: dict, new: dict) -> dict:
    """Copy a decode step's new recurrent state into the cache tensors, in
    place (cast to their fp32, the counterpart of the reference's pin of
    the decode carry to the cache contract); returns ``cache``. Under a
    mesh each rank writes its own shard of each leaf, the new state put
    on the leaf's placements first (``sharding.relayout``)."""
    for name, val in new.items():
        dst = cache[name]
        if shd.is_dtensor(dst):
            val = shd.relayout(shd.as_replicated(val, dst.device_mesh),
                               tuple(dst.placements)).to_local()
            dst = dst.to_local()
        dst.copy_(val)
    return cache


def _derived(pl: tuple, dims: dict) -> tuple:
    """Placements of a tensor laid out alongside one with placements
    ``pl``: on each mesh dim where ``pl`` shards dim ``k``, this tensor's
    dim ``dims[k]`` (replicated where ``dims`` has no ``k``)."""
    return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                 else Replicate() for p in pl)


def _on_shards(fn, mesh, args, in_pl, out_pl):
    """``fn`` on each rank's local shards of ``args`` put on ``in_pl``
    (``local_map``; None args pass through); its output on ``out_pl``
    (its outputs, one placements tuple each). The computation is split
    over every mesh dim that shards an input, so an input replicated on
    such a dim takes a partial gradient there (each rank's share, summed
    over the ranks); elsewhere its gradient keeps its placements."""
    args = tuple(None if a is None else shd.put(a, mesh, pl)
                 for a, pl in zip(args, in_pl))
    in_pl = tuple(None if a is None else tuple(pl)
                  for a, pl in zip(args, in_pl))
    split = {m for pl in in_pl if pl is not None
             for m, p in enumerate(pl) if p.is_shard()}
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if m in split and not p.is_shard() else p
        for m, p in enumerate(pl)) for pl in in_pl)
    out_pl = list(out_pl) if isinstance(out_pl[0], Placement) \
        else tuple(tuple(o) for o in out_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh)(*args)


def _groups(mesh, pl: tuple, dim: int) -> list:
    """The process groups of the mesh dims that shard tensor dim ``dim``
    under ``pl``."""
    return [mesh.get_group(m) for m, p in enumerate(pl)
            if p.is_shard() and p.dim == dim]


def _summer(groups: list):
    """A sum over the ranks of ``groups`` of partial products that each
    rank then uses in its own way (``sharding.sum_shared``), or None
    where there is nothing to sum."""
    return (lambda t: shd.sum_shared(t, groups)) if groups else None


def _mamba_on_shards(core, args):
    """:func:`ssm_lib.mamba_core` on each rank's channels (``ssm_inner``)
    and slots: the conv, the scan and the gate are channel-local, the
    ``x_dbc`` product is summed over the channel shards (one all-reduce)
    and the state comes back on the channels' layout. Off a mesh the
    core runs as it is."""
    xi, z = args[0], args[1]
    if not shd.is_dtensor(xi):
        return core(*args)
    xi, z = (sc(t, "act_batch", None, "ssm_inner") for t in (xi, z))
    mesh, pl = xi.device_mesh, tuple(xi.placements)
    # per-channel leaves: (di,) and (di, .) on dim 0, (., di) on dim 1
    rows, cols = _derived(pl, {2: 0}), _derived(pl, {2: 1})
    conv_pl, h_pl = _derived(pl, {0: 0, 2: 2}), _derived(pl, {0: 0, 2: 1})
    in_pl = (pl, pl, cols, rows, rows, cols, rows, rows, rows, conv_pl, h_pl)
    fn = functools.partial(core, reduce=_summer(_groups(mesh, pl, 2)))
    return _on_shards(fn, mesh, (xi, z) + tuple(args[2:]), in_pl,
                      (pl, h_pl, conv_pl))


def _mlstm_on_shards(core, args):
    """An mLSTM core (``xlstm.mlstm_*_core``) on each rank's heads
    (``qheads``; replicated where the heads do not divide the mesh
    dims, 4 heads over 16 ranks) and slots: the recurrence is
    head-local."""
    q = args[0]
    if not shd.is_dtensor(q):
        return core(*args)
    q = sc(q, "act_batch", None, "qheads", None)
    mesh, pl = q.device_mesh, tuple(q.placements)
    gate, st = _derived(pl, {0: 0, 2: 2}), _derived(pl, {0: 0, 2: 1})
    in_pl = (pl, pl, pl, gate, gate, st, st, st)
    return _on_shards(core, mesh, (q,) + tuple(args[1:]), in_pl,
                      (pl, st, st, st))


def _slstm_on_shards(core, args):
    """:func:`xlstm_lib.slstm_chunk` on each rank's heads: the input
    projection's columns and bias (``slstm_h``), the recurrent weights
    ``r`` cut to the rank's heads and the state on the channels' layout;
    the chunk's input whole over the channels. Head-local. Where the
    channels' shards split a head (768 channels over 16 ranks: 48 of a
    192-wide head) the chunk runs on the whole heads, replicated: the
    projection's weights and the state are gathered once a chunk, each
    rank runs every head, and the outputs are cut back to their layouts
    where they are used (the parameters keep the reference's
    placement)."""
    x, w, r = args[0], args[1], args[3]
    if not shd.is_dtensor(x) and not shd.is_dtensor(w):
        return core(*args)
    x = sc(shd.as_replicated(x, shd.current_mesh()), "act_batch", None,
           None)
    mesh, xpl = x.device_mesh, tuple(x.placements)
    wpl = tuple(w.placements) if shd.is_dtensor(w) \
        else (Replicate(),) * mesh.ndim
    chan = {m for m, p in enumerate(wpl) if p.is_shard() and p.dim == 2}
    shards = math.prod(mesh.shape[m] for m in chan)
    if (w.shape[2] // shards) % r.shape[1]:
        chan = set()
    # mesh dims: batch where x's slots are sharded, the heads on ``chan``
    pl = tuple(Shard(0) if p.is_shard() and p.dim == 0 else
               Shard(3) if m in chan else Replicate()
               for m, p in enumerate(xpl))
    vec, heads = _derived(pl, {0: 0, 3: 1}), _derived(pl, {3: 0})
    in_pl = (_derived(pl, {0: 0}), _derived(pl, {3: 2}),
             _derived(pl, {3: 1}), heads, vec, vec, vec, vec)
    return _on_shards(core, mesh, (x,) + tuple(args[1:]), in_pl,
                      (_derived(pl, {0: 0, 3: 2}), vec, vec, vec, vec))


def _moe_on_shards(routing, experts, x, p):
    """``moe.route_core`` and ``moe.expert_core`` on each rank's shards.

    The routing runs on each rank's token groups where the data shards
    hold whole groups, and on every group (the tokens gathered over the
    data shards) where they do not, so that routing, capacity and the
    aux loss's sums are those of the global groups, never of a data
    shard's rows; its sums are partial over the data shards. The
    experts: where ``expert`` shards the stacked weights, each rank takes
    its experts' slice of the dispatch and combine one-hots
    (expert-parallel); where ``emlp`` does, every expert on every rank
    with its FFN width sharded and ``w_down`` row-parallel. Either way
    the output is each rank's partial sum, all-reduced where it meets
    the residual. Under the resident 2-D serve rules (d sharded) the
    router and up/gate products are summed over d's shards and the
    output keeps d's layout. Returns ``(out, token sums, prob sums)``."""
    mesh, pl = x.device_mesh, tuple(x.placements)
    g = max(1, x.shape[0] * x.shape[1] // routing.keywords["group_size"])
    n_batch = math.prod(mesh.shape[m] for m, q in enumerate(pl)
                        if q.is_shard() and q.dim == 0)
    if g % n_batch:
        pl = _derived(pl, {2: 2})
    w_up = p["w_up"]
    wpl = tuple(w_up.placements) if shd.is_dtensor(w_up) \
        else (Replicate(),) * mesh.ndim
    embed = {m for m, q in enumerate(pl) if q.is_shard() and q.dim == 2}
    if embed != {m for m, q in enumerate(wpl) if q.is_shard() and q.dim == 1}:
        pl = _derived(pl, {0: 0})
        wpl = tuple(Replicate() if q.is_shard() and q.dim == 1 else q
                    for q in wpl)
        embed = set()
    egroups = [mesh.get_group(m) for m in sorted(embed)]
    grp = _derived(pl, {0: 0})
    part = tuple(Partial() if q.is_shard() and q.dim == 0 else Replicate()
                 for q in pl)
    top_p, top_e, keep, pos, tok_sum, prob_sum = _on_shards(
        functools.partial(routing, reduce=_summer(egroups)), mesh,
        (x, p["router"]), (pl, _derived(pl, {2: 0})),
        (grp, grp, grp, grp, part, part))
    down = tuple(Shard({0: 0, 1: 2, 2: 1}[q.dim]) if q.is_shard()
                 else Replicate() for q in wpl)
    out_pl = tuple(Shard(0) if q.is_shard() and q.dim == 0 else
                   Shard(2) if q.is_shard() and q.dim == 2 else
                   Partial() if wq.is_shard() else Replicate()
                   for q, wq in zip(pl, wpl))
    e0 = shd.shard_offset(mesh, wpl, 0, w_up.shape[0])[0]
    fn = functools.partial(experts, expert0=e0, reduce=_summer(egroups))
    out = _on_shards(fn, mesh, (x, top_p, top_e, keep, pos, w_up,
                                p.get("w_gate"), p["w_down"]),
                     (pl, grp, grp, grp, grp, wpl,
                      wpl if "w_gate" in p else None, down), out_pl)
    return out, tok_sum, prob_sum


def _mixer(cfg: ModelConfig, mixer: str, p: dict, x, *, mode: str, cache,
           **attn_kw):
    """One block's mixer: ``(y, new_cache)``. At decode the new cache is
    ``cache`` itself, updated in place; in training it is None (no state
    is kept). A prefill's new state comes back on the cache's layout."""
    if mixer in ("attn", "attn_local"):
        return _attn_mixer(cfg, p, x, local=(mixer == "attn_local"),
                           mode=mode, cache=cache, **attn_kw)
    state = cache if mode == "decode" else None
    want_state = mode != "train"
    if mixer == "mamba":
        y, st = ssm_lib.mamba_mixer(
            p, x, d_state=cfg.ssm_d_state, conv_dim=cfg.ssm_conv_dim,
            chunk=cfg.ssm_chunk, state=state, want_state=want_state,
            fuse=cfg.ssm_fuse, on_shards=_mamba_on_shards)
    elif mixer == "mlstm":
        z = x @ p["up_z"]
        y, st = xlstm_lib.mlstm_mixer(
            p, x @ p["up_x"], n_heads=cfg.n_heads,
            chunk=max(16, cfg.ssm_chunk // 2), state=state,
            want_state=want_state, on_shards=_mlstm_on_shards)
        y = (shd.reduce_partials(y) * F.silu(z)) @ p["down"]
    elif mixer == "slstm":
        y, st = xlstm_lib.slstm_mixer(p, x, n_heads=cfg.n_heads,
                                      state=state, want_state=want_state,
                                      on_shards=_slstm_on_shards)
    else:
        raise ValueError(mixer)
    if mode == "decode":
        return y, _write_state(cache, st)
    if st is not None:
        defs = _cache_defs(cfg, f"{mixer}:none", 1, 1)
        st = {n: sc(t, *defs[n].axes) for n, t in st.items()}
    return y, st


def apply_block(cfg: ModelConfig, blk: str, p: dict, x, *, mode: str,
                rope, cache, pos, cache_len=None, impl: str = "auto",
                kv_len=None, store_flavor=None, block_tables=None):
    """One ``mixer:ffn`` block; returns (x_out, aux_loss, new_cache).
    Under a mesh its weights' FSDP shards are gathered at use
    (``sharding.gather_fsdp``)."""
    mixer, ffn = blk.split(":")
    if shd.current_mesh() is not None:
        p = _map_tree(shd.gather_fsdp, p)
    hx = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_cache = _mixer(cfg, mixer, p["mixer"], hx, mode=mode, cache=cache,
                          rope=rope, pos=pos, cache_len=cache_len, impl=impl,
                          kv_len=kv_len, store_flavor=store_flavor,
                          block_tables=block_tables)
    x = x + _reduced(y)
    x = sc(x, "act_batch", None, "act_embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        hx = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if ffn == "dense":
            y = L.dense_ffn(p["ffn"], hx, cfg.ffn_act)
        else:
            y, aux = moe_lib.moe_ffn(
                p["ffn"], hx, n_experts=cfg.n_experts,
                top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor,
                group_size=cfg.moe_group_size, act=cfg.ffn_act,
                on_shards=_moe_on_shards if shd.is_dtensor(hx) else None)
        x = x + _reduced(y)
        x = sc(x, "act_batch", None, "act_embed")
    return x, aux, new_cache


def _reduced(y):
    """A row-parallel product's partial sums all-reduced, in training
    such that the gradient flows back replicated
    (``sharding.reduce_partials``); elsewhere DTensor reduces them where
    they meet the residual."""
    return shd.reduce_partials(y) if shd.is_dtensor(y) and y.requires_grad \
        else y


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack(tree: dict, n: int) -> list:
    """A tree of (n, ...) leaves as n trees of views, one per layer."""
    out = [dict() for _ in range(n)]
    for key, val in tree.items():
        parts = _unstack(val, n) if isinstance(val, dict) \
            else torch.unbind(val)
        for i in range(n):
            out[i][key] = parts[i]
    return out


def _sharded_lookup(emb, tokens):
    """Rows ``tokens`` of a DTensor table whose rows (the vocab) may be
    sharded, for training: each rank looks up the tokens its rows hold,
    zero elsewhere, and the ranks' rows are summed over the vocab shards
    (``sharding.sum_over``: the gradient comes back whole to each rank's
    rows). The table's other shards (FSDP's columns) are gathered first.
    DTensor's own lookup marks its result with a mask that its backward
    pass cannot take a partial gradient into."""
    mesh, pl = emb.device_mesh, tuple(emb.placements)
    vocab = [m for m, p in enumerate(pl) if p.is_shard() and p.dim == 0]
    emb_pl = tuple(p if m in vocab else Replicate() for m, p in enumerate(pl))
    tok = shd.as_replicated(tokens, mesh)
    tok_pl = tuple(Replicate() if m in vocab else p
                   for m, p in enumerate(tok.placements))
    off, n = shd.shard_offset(mesh, emb_pl, 0, emb.shape[0])
    groups = [mesh.get_group(m) for m in vocab]

    def pick(e, t):
        t = t.long() - off
        ok = (t >= 0) & (t < n)
        rows = e[t.clamp(0, n - 1)]
        rows = torch.where(ok[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return shd.sum_over(rows, groups)
    # each rank's rows take the gradient of its own tokens only: a sum
    # over the dims that shard the tokens and not the table
    grad_pl = tuple(Partial() if t.is_shard() and not e.is_shard() else e
                    for e, t in zip(emb_pl, tok_pl))
    return local_map(pick, out_placements=list(tok_pl),
                     in_placements=(emb_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh)(
        emb.redistribute(mesh, emb_pl), tok.redistribute(mesh, tok_pl))


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``, as the reference's ``_remat_wrap``
    wraps a scan unit: ``"full"`` saves nothing and recomputes the unit
    in the backward pass; ``"dots"`` saves the weight products' outputs
    (``aten.mm`` / ``aten.addmm``, what ``checkpoint_dots_with_no_batch_dims``
    keeps) and recomputes the rest, the batched attention and expert
    products included; ``"none"`` keeps every activation."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

        def policy(ctx, op, *args, **kwargs):
            return ckpt.CheckpointPolicy.MUST_SAVE if op in saved \
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    policy)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "prefill", cache: dict | None = None, pos=None,
            cache_len: int | None = None, impl: str = "auto",
            kv_len: int | None = None, store_flavor: str | None = None,
            block_tables: torch.Tensor | None = None,
            gather_logits: bool = True):
    """Run the model; returns ``(logits, aux, cache)``, or ``(logits,
    aux)`` in training.

    batch: ``{"tokens": (B, S) integer tensor}``, or ``{"embeds": (B, S,
    d)}`` for a model with ``embed_inputs=False`` (cast to the parameter
    dtype); optionally ``"positions"``, (B, S) integers, or (3, B, S) for
    M-RoPE. Without them a prefill or training pass runs at ``0 .. S-1``
    and a decode step at ``pos``, on every M-RoPE stream alike.
    mode: ``"train"`` returns logits at every position (B, S, V) and
          builds no cache; it is the one mode that records autograd (the
          others run under ``torch.no_grad``), and it runs each scan unit
          (one layer repetition of the block pattern) under ``cfg.remat``
          (:func:`_remat_wrap`), as the reference does;
          ``"prefill"`` builds a fresh cache from the prompt, preallocated
          at ``cache_len`` rows when given, and returns only the last
          position's logits (B, 1, V);
          ``"decode"`` takes S == 1 tokens at per-slot positions ``pos``
          ((B,) int32 tensor, or a scalar), writes their KV rows into
          ``cache`` in place and returns (B, 1, V) logits and the same
          cache. ``kv_len`` bounds the cache rows attention reads.
    ``impl`` routes the decode kernel, which writes the step's KV rows
    and then attends in one launch: ``"auto"`` runs it on a CUDA tensor
    and its plain version (the row write, then the plain decode) on a CPU
    tensor; ``"ref"`` always runs the plain version.
    ``store_flavor`` picks the KV row stores (``kernels.stores``).
    ``block_tables`` ((B, NB) int32) switches decode to the paged cache
    (``serve.pages``): every cache leaf is then a page pool, row ``pos``
    of slot ``b`` lives in page ``block_tables[b, pos // page]``, the KV
    rows are written there and attention runs the paged decode kernel,
    with ``kv_len`` bounding the table columns read.
    Recurrent state (Mamba, mLSTM, sLSTM) is fp32 in the cache: a decode
    step copies its new state into the cache tensors in place, a prefill
    returns it as its mixer made it (Mamba's ``conv`` in the compute
    dtype). ``aux`` is the MoE load-balance loss summed over the layers
    (0-d fp32; zero without MoE blocks).

    Under a mesh (``utils.sharding.use_mesh_rules``) the parameters are
    DTensors. Serving gathers the vocab-sharded logits whole on every
    rank (the sampler's input) unless ``gather_logits=False`` leaves
    them on their layout, as the dry run lowers a step; training leaves
    them sharded for the loss (``train.losses.cross_entropy``).
    """
    kw = dict(cache=cache, pos=pos, cache_len=cache_len, impl=impl,
              kv_len=kv_len, store_flavor=store_flavor,
              block_tables=block_tables, gather_logits=gather_logits)
    if mode == "train":
        if shd.current_mesh() is None:
            logits, aux, _ = _forward(cfg, params, batch, mode=mode, **kw)
            return logits, aux
        with implicit_replication():
            logits, aux, _ = _forward(cfg, params, batch, mode=mode, **kw)
        return logits, aux
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (expected 'train', "
                         "'prefill' or 'decode')")
    with torch.no_grad():
        if shd.current_mesh() is None:
            return _forward(cfg, params, batch, mode=mode, **kw)
        # host-made tensors (tokens, positions, rope tables) count as
        # replicated beside the DTensors
        with implicit_replication():
            return _forward(cfg, params, batch, mode=mode, **kw)


def _forward(cfg: ModelConfig, params: dict, batch: dict, *, mode: str,
             cache, pos, cache_len, impl, kv_len, store_flavor,
             block_tables, gather_logits=True):
    dtype = DTYPES[cfg.param_dtype]
    if cfg.embed_inputs:
        tokens = batch["tokens"]
        b, s = tokens.shape
        emb = params["tok_embed"]
        # a vocab-sharded table is a masked lookup and a sum over shards
        if not shd.is_dtensor(emb):
            x = emb[tokens].to(dtype)
        elif mode == "train":
            x = _sharded_lookup(emb, tokens).to(dtype)
        else:
            x = F.embedding(tokens, emb).to(dtype)
    else:
        x = batch["embeds"].to(dtype)
        b, s, _ = x.shape
        if shd.current_mesh() is not None:
            # frame embeddings, whole on every rank, placed as the
            # token models' lookup comes out (``sc`` below)
            x = shd.as_replicated(x, shd.current_mesh())
    dev = x.device
    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token per slot, got {s}")
        pos = pos_vector(pos, b, dev)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = pos[:, None] if mode == "decode" else \
            torch.arange(s, device=dev)[None, :].expand(b, s)
        if cfg.rope_kind == "mrope":
            positions = positions.expand(3, b, s)
    rope = None
    if cfg.rope_kind == "rope":
        rope = L.rope_tables(positions, cfg.head_dim_eff, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        rope = L.mrope_tables(positions, cfg.head_dim_eff, cfg.rope_theta)
    elif cfg.rope_kind == "sinusoidal":
        pe = L.sinusoidal_embedding(
            positions if positions.ndim == 2 else positions[0], cfg.d_model)
        x = x + pe.to(x.dtype)
    if rope is not None and mode == "train" and shd.is_dtensor(x):
        # the tables meet DTensors in the backward pass too, where no
        # implicit replication is in force (autograd's threads)
        rope = tuple(shd.as_replicated(t, x.device_mesh) for t in rope)

    x = sc(x, "act_batch", None, "act_embed")
    plan = cfg.layer_plan()
    n_rep, unit, n_tail = cfg.scan_split()
    kw = dict(mode=mode, rope=rope, pos=pos, cache_len=cache_len, impl=impl,
              kv_len=kv_len, store_flavor=store_flavor,
              block_tables=block_tables)
    new_cache = None if mode == "train" else {"tail": {}}
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    if n_rep > 0 and mode == "train":
        def unit_body(x, aux, p_r):
            for j in range(unit):
                x, a, _ = apply_block(cfg, plan[j], p_r[str(j)], x,
                                      cache=None, **kw)
                aux = aux + a
            return x, aux
        body = _remat_wrap(cfg, unit_body)
        for p_r in _unstack(params["scan"], n_rep):
            x, aux_total = body(x, aux_total, p_r)
    elif n_rep > 0:
        layer_params = _unstack(params["scan"], n_rep)
        layer_caches = _unstack(cache["scan"], n_rep) \
            if mode == "decode" else [None] * n_rep
        made = []
        for r in range(n_rep):
            slices = {}
            for j in range(unit):
                cj = layer_caches[r][str(j)] if mode == "decode" else None
                x, aux, slices[str(j)] = apply_block(
                    cfg, plan[j], layer_params[r][str(j)], x, cache=cj, **kw)
                aux_total = aux_total + aux
            made.append(slices)
        if mode == "decode":
            new_cache["scan"] = cache["scan"]
        else:
            new_cache["scan"] = {
                str(j): {n: torch.stack([m[str(j)][n] for m in made])
                         for n in made[0][str(j)]} for j in range(unit)}
    for i in range(n_tail):
        ci = cache["tail"][str(i)] if mode == "decode" else None
        x, aux, nc = apply_block(cfg, plan[n_rep * unit + i],
                                 params["tail"][str(i)], x, cache=ci, **kw)
        aux_total = aux_total + aux
        if new_cache is not None:
            new_cache["tail"][str(i)] = nc

    if mode == "prefill":
        x = x[:, -1:]   # serving needs only the last position's logits
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = shd.gather_fsdp(params["tok_embed"].T if cfg.tie_embeddings
                           else params["lm_head"])
    logits = x @ head.to(x.dtype)
    # vocab-sharded under a mesh, then gathered whole for the sampler
    logits = sc(logits, "act_batch", None, "vocab")
    if gather_logits and mode != "train":
        logits = shd.replicated(logits)
    return logits, aux_total, new_cache
