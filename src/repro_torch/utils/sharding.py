"""Logical-axis sharding rules: the constants the chunk planner reads.

A copy of the pure-Python part of ``repro/utils/sharding.py`` that
``serve/planner.py`` needs to price a tensor-parallel plan without a
mesh: the rules tables, ``tp_degree`` and ``rules_fingerprint``. The
spec builders, meshes and constraints wait with sharding itself
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

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
