"""Model assembly (counterpart of ``repro/models/model.py``): parameter
and cache tables, initialization, and the prefill/decode forward pass
for attention blocks with dense FFNs.

Parameters live in a plain dict with the JAX tree's names and layouts:
``tok_embed (V,d)``, ``scan/<j>/{ln1, mixer/{wq (d,H,Dh), wk/wv
(d,Hkv,Dh), wo (H,Dh,d)}, ln2, ffn/{w_gate, w_up (d,F), w_down (F,d)}}``
with a leading layer axis on every ``scan`` leaf, ``tail/<i>/...``,
``final_norm`` and ``lm_head (d,V)``. The cache mirrors it:
``scan/<j>/{k, v}`` of shape (L, B, S, Hkv, Dh). The JAX layer scan
becomes a loop over the stacked leaves.

Only ``attn``/``attn_local`` mixers with ``dense`` (or no) FFNs are
ported; other block kinds raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import pos_vector
from repro_torch.kernels import stores as stores_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_NOT_PORTED = {
    "mamba": "ROADMAP queue 1 item 7 (models/ssm.py)",
    "mlstm": "ROADMAP queue 1 item 7 (models/xlstm.py)",
    "slstm": "ROADMAP queue 1 item 7 (models/xlstm.py)",
    "moe": "ROADMAP queue 1 item 7 (models/moe.py)",
}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter leaf: shape, logical axis names, and initializer."""

    shape: tuple
    axes: tuple
    init: str = "normal"     # normal|ones|embed


def _check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    for blk in cfg.layer_plan():
        mixer, ffn = blk.split(":")
        for part in (mixer, ffn):
            if part in _NOT_PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: block {blk!r} is not ported; see "
                    f"{_NOT_PORTED[part]}")
    other = {"qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
             "rope_kind != 'rope'": cfg.rope_kind != "rope",
             "embed_inputs=False": not cfg.embed_inputs}
    for what, on in other.items():
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported; see ROADMAP queue 1 "
                "item 2 (attention-family model)")


# ---------------------------------------------------------------------------
# Parameter tables
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_eff
    return {
        "wq": ParamDef((d, h, dh), ("embed", "qheads", None)),
        "wk": ParamDef((d, hkv, dh), ("embed", "kvheads", None)),
        "wv": ParamDef((d, hkv, dh), ("embed", "kvheads", None)),
        "wo": ParamDef((h, dh, d), ("qheads", None, "embed")),
    }


def _ffn_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": ParamDef((d, f), ("embed", "mlp")),
         "w_down": ParamDef((f, d), ("mlp", "embed"))}
    if cfg.ffn_act == "swiglu":
        p["w_gate"] = ParamDef((d, f), ("embed", "mlp"))
    return p


def block_defs(cfg: ModelConfig, blk: str) -> dict:
    """ParamDef tree of one layer block (``mixer:ffn`` plan entry)."""
    _, ffn = blk.split(":")
    p = {"ln1": ParamDef((cfg.d_model,), (None,), "ones"),
         "mixer": _attn_defs(cfg)}
    if ffn != "none":
        p["ln2"] = ParamDef((cfg.d_model,), (None,), "ones")
        p["ffn"] = _ffn_defs(cfg)
    return p


def model_defs(cfg: ModelConfig) -> dict:
    """Whole-model ParamDef tree (embeddings, scan stack, tail, head)."""
    _check_ported(cfg)
    plan = cfg.layer_plan()
    n_rep, unit, n_tail = cfg.scan_split()
    defs = {"tok_embed": ParamDef((cfg.vocab_size, cfg.d_model),
                                  ("vocab", "embed"), "embed")}
    if n_rep > 0:
        defs["scan"] = {str(j): block_defs(cfg, plan[j]) for j in range(unit)}
    defs["tail"] = {str(i): block_defs(cfg, plan[n_rep * unit + i])
                    for i in range(n_tail)}
    defs["final_norm"] = ParamDef((cfg.d_model,), (None,), "ones")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    return defs


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
        _set(out, path, (((stack,) + d.shape) if stack else d.shape, dtype))
    out.setdefault("tail", {})
    return out


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
                device="cuda") -> dict:
    """Materialize parameters with the JAX package's init rule.

    Normal leaves are N(0, std^2) with std from the fan-in (0.02 for the
    embedding), ``ln`` and norm leaves are ones. Numbers come from
    ``generator`` (which must live on ``device``), leaf by leaf in sorted
    tree order and layer by layer, so a seed fixes the weights; they are
    not the JAX package's numbers (use ``bridge.params_from_jax`` for
    those).
    """
    dtype = DTYPES[cfg.param_dtype]
    out: dict = {"tail": {}}
    for path, d, stack in _stacked(model_defs(cfg), cfg):
        shape = ((stack,) + d.shape) if stack else d.shape
        if d.init == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            std = _init_std(d)
            leaf = torch.empty(shape, dtype=dtype, device=device)
            for sl in (leaf if stack else (leaf,)):
                sl.copy_(torch.randn(sl.shape, generator=generator,
                                     device=device) * std)
        _set(out, path, leaf)
    return out


# ---------------------------------------------------------------------------
# Cache tables
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``(shape, dtype)`` for every leaf of the decode cache."""
    _check_ported(cfg)
    n_rep, unit, n_tail = cfg.scan_split()
    kv = (batch, seq, cfg.n_kv_heads, cfg.head_dim_eff)
    dtype = DTYPES[cfg.param_dtype]
    out: dict = {"tail": {str(i): {"k": (kv, dtype), "v": (kv, dtype)}
                          for i in range(n_tail)}}
    if n_rep > 0:
        stacked = ((n_rep,) + kv, dtype)
        out["scan"] = {str(j): {"k": stacked, "v": stacked}
                       for j in range(unit)}
    return out


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device="cuda") -> dict:
    """Zero-filled decode cache matching :func:`cache_shapes`."""
    out: dict = {"tail": {}}
    for path, (shape, dtype) in _walk(cache_shapes(cfg, batch, seq)):
        _set(out, path, torch.zeros(shape, dtype=dtype, device=device))
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _project(x, w):
    """x: (B,S,d) @ w: (d,H,Dh) -> (B,S,H,Dh)."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)


def _attn_mixer(cfg: ModelConfig, p: dict, x, *, local: bool, mode: str,
                rope, cache, pos, cache_len, impl: str, kv_len,
                store_flavor):
    b, s, _ = x.shape
    q = L.rotate(_project(x, p["wq"]), *rope)
    k = L.rotate(_project(x, p["wk"]), *rope)
    v = _project(x, p["wv"])
    window = cfg.sliding_window if local else None
    new_cache = None
    if mode == "decode":
        # in-place KV row writes through the store door, then attention
        # over the whole cache bounded by kv_len (no slice, no copy)
        stores_lib.kv_row_update(cache["k"], cache["v"], k, v, pos,
                                 flavor=store_flavor, impl=impl)
        y = attn_lib.decode_attention(q, cache["k"], cache["v"], pos,
                                      window=window, impl=impl,
                                      kv_len=kv_len)
        new_cache = cache
    else:
        y = attn_lib.chunked_causal_attention(
            q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            window=window)
        dtype = DTYPES[cfg.param_dtype]
        kd, vd = k.to(dtype), v.to(dtype)
        if cache_len is not None and cache_len > s:
            kd = stores_lib.pad_to_horizon(kd, cache_len, flavor=store_flavor)
            vd = stores_lib.pad_to_horizon(vd, cache_len, flavor=store_flavor)
        new_cache = {"k": kd, "v": vd}
    h, dh, d = p["wo"].shape
    out = y.reshape(b, s, h * dh) @ p["wo"].reshape(h * dh, d)
    return out, new_cache


def apply_block(cfg: ModelConfig, blk: str, p: dict, x, *, mode: str,
                rope, cache, pos, cache_len=None, impl: str = "auto",
                kv_len=None, store_flavor=None):
    """One ``attn:dense`` block; returns (x_out, new_cache)."""
    mixer, ffn = blk.split(":")
    hx = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    y, new_cache = _attn_mixer(cfg, p["mixer"], hx,
                               local=(mixer == "attn_local"), mode=mode,
                               rope=rope, cache=cache, pos=pos,
                               cache_len=cache_len, impl=impl, kv_len=kv_len,
                               store_flavor=store_flavor)
    x = x + y
    if ffn != "none":
        x = x + L.dense_ffn(p["ffn"], L.rms_norm(x, p["ln2"], cfg.norm_eps),
                            cfg.ffn_act)
    return x, new_cache


def _unstack(tree: dict, n: int) -> list:
    """A tree of (n, ...) leaves as n trees of views, one per layer."""
    out = [dict() for _ in range(n)]
    for key, val in tree.items():
        parts = _unstack(val, n) if isinstance(val, dict) \
            else torch.unbind(val)
        for i in range(n):
            out[i][key] = parts[i]
    return out


@torch.no_grad()
def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            mode: str = "prefill", cache: dict | None = None, pos=None,
            cache_len: int | None = None, impl: str = "auto",
            kv_len: int | None = None, store_flavor: str | None = None):
    """Run the model; returns ``(logits, aux, cache)``.

    batch: ``{"tokens": (B, S) integer tensor}``.
    mode: ``"prefill"`` builds a fresh cache from the prompt, preallocated
          at ``cache_len`` rows when given, and returns only the last
          position's logits (B, 1, V);
          ``"decode"`` takes S == 1 tokens at per-slot positions ``pos``
          ((B,) int32 tensor, or a scalar), writes their KV rows into
          ``cache`` in place and returns (B, 1, V) logits and the same
          cache. ``kv_len`` bounds the cache rows attention reads.
    ``impl`` routes both decode kernels (KV row writer and split-KV
    attention): ``"auto"`` runs them on a CUDA tensor and their plain
    versions on a CPU tensor; ``"ref"`` always runs the plain versions.
    ``store_flavor`` picks the KV store path (``kernels.stores``).
    ``aux`` is a zero scalar (no MoE blocks).
    """
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (expected 'prefill' or "
                         "'decode')")
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = params["tok_embed"][tokens].to(DTYPES[cfg.param_dtype])
    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token per slot, got {s}")
        pos = pos_vector(pos, b, dev)
        positions = pos[:, None]
    else:
        positions = torch.arange(s, device=dev)[None, :].expand(b, s)
    rope = L.rope_tables(positions, cfg.head_dim_eff, cfg.rope_theta)

    plan = cfg.layer_plan()
    n_rep, unit, n_tail = cfg.scan_split()
    kw = dict(mode=mode, rope=rope, pos=pos, cache_len=cache_len, impl=impl,
              kv_len=kv_len, store_flavor=store_flavor)
    new_cache: dict = {"tail": {}}
    if n_rep > 0:
        layer_params = _unstack(params["scan"], n_rep)
        layer_caches = _unstack(cache["scan"], n_rep) \
            if mode == "decode" else [None] * n_rep
        made = []
        for r in range(n_rep):
            slices = {}
            for j in range(unit):
                cj = layer_caches[r][str(j)] if mode == "decode" else None
                x, slices[str(j)] = apply_block(
                    cfg, plan[j], layer_params[r][str(j)], x, cache=cj, **kw)
            made.append(slices)
        if mode == "decode":
            new_cache["scan"] = cache["scan"]
        else:
            new_cache["scan"] = {
                str(j): {n: torch.stack([m[str(j)][n] for m in made])
                         for n in ("k", "v")} for j in range(unit)}
    for i in range(n_tail):
        ci = cache["tail"][str(i)] if mode == "decode" else None
        x, new_cache["tail"][str(i)] = apply_block(
            cfg, plan[n_rep * unit + i], params["tail"][str(i)], x,
            cache=ci, **kw)

    if mode == "prefill":
        x = x[:, -1:]   # serving needs only the last position's logits
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    return logits, torch.zeros((), device=dev), new_cache
