"""Persisted offline plan database for the serve path.

The counterpart of ``repro/serve/plandb.py``. A cold engine construction
pays the full online planning bill: lower the decode step (here to an
ATen trace on meta tensors, ``serve.planner.decode_step_trace``), fan
``portmodel.compare`` across the machine registry, and tune the kernel
tiles. The answer depends only on (machine, model config, sharding), so
:func:`sweep` prices the (chunk x tile x n_splits x store flavor x tp)
space offline under both the analytical ``tp_bound`` backend and the
``mca_sched`` simulator and keeps the winners as versioned JSON; an
installed database (:func:`install`) turns ``plan_chunk_size``,
``decode_tiles`` and ``flash_tiles`` into dictionary hits.

Every key folds content fingerprints of the model config (sha256 of its
frozen dataclass repr) and of every registered machine
(``core.machine.machine_fingerprint``): a changed config or a machine
registered again with other parameters misses, and the planner plans
online, bit-identically, since the database stores the very object
online planning makes (``dataclasses.asdict`` through JSON round-trips
Python floats exactly).

Every key also folds the package, :data:`PACKAGE`. The port's
``ModelConfig`` has the reference's repr and its machine files
fingerprint as the reference's, but the reference prices the step's HLO
and the port an ATen trace of its own step: a database the JAX package
wrote would otherwise hit here and serve plans priced on another
program. With the package in the key it misses and the port plans
online.

``backend_disagreements`` reports every swept point where the two
backends picked different winners.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.core.machine import (machine_fingerprint, registered_names,
                                      registry_fingerprint)
from repro_torch.serve.planner import ChunkPlan

#: JSON format version; loading any other version is an error, not a
#: silent partial read
PLANDB_VERSION = 1

#: the package whose planner priced an entry, folded into every key
PACKAGE = "repro_torch"

#: the process-wide installed database consulted by the planner and tuner
_INSTALLED = None


def config_fingerprint(cfg) -> str:
    """Content fingerprint of a model config (frozen-dataclass repr)."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _digest(material) -> str:
    """Stable hash of key material (its repr)."""
    return hashlib.sha256(repr(material).encode()).hexdigest()


def _chunk_material(cfg, batch, max_len, *, machine, dispatch_overhead_s,
                    overhead_frac, max_chunk, occupancy, backend,
                    store_flavor, page_size, mesh_sizes, rules_fp, tp):
    """Canonical key material for one chunk-plan entry: the planner's
    memo key with content fingerprints in place of the config and the
    registry, and the package."""
    return (PACKAGE, "chunk", config_fingerprint(cfg), batch, max_len,
            str(machine), float(dispatch_overhead_s),
            float(overhead_frac), int(max_chunk), occupancy, backend,
            store_flavor, page_size, tuple(sorted(mesh_sizes.items())),
            tuple(rules_fp), int(tp), registry_fingerprint())


def _tile_material(kind: str, machine: str, kwargs: dict):
    """Canonical key material for one tile-plan entry (flash/decode)."""
    return (PACKAGE, "tile", kind, str(machine), machine_fingerprint(machine),
            tuple(sorted(kwargs.items())))


class PlanDB:
    """A keyed store of finished serve plans, JSON-persistable.

    ``chunks`` and ``tiles`` map key digests to entries of the form
    ``{"plan": <asdict>, "context": <readable provenance>}``. Lookups
    rebuild the frozen dataclass; a miss returns None.
    """

    def __init__(self, chunks: dict | None = None,
                 tiles: dict | None = None, meta: dict | None = None):
        self.chunks = chunks if chunks is not None else {}
        self.tiles = tiles if tiles is not None else {}
        self.meta = meta if meta is not None else {}

    # -- chunk plans --------------------------------------------------------
    def lookup_chunk(self, cfg, batch, max_len, **key) -> ChunkPlan | None:
        """The stored ChunkPlan for one planner key, or None."""
        hit = self.chunks.get(
            _digest(_chunk_material(cfg, batch, max_len, **key)))
        if hit is None:
            return None
        return ChunkPlan(**hit["plan"])

    def record_chunk(self, cfg, batch, max_len, *, plan: ChunkPlan,
                     **key) -> None:
        """Keep one finished chunk plan under its planner key."""
        self.chunks[_digest(_chunk_material(cfg, batch, max_len, **key))] = {
            "plan": dataclasses.asdict(plan),
            "context": {"machine": str(key["machine"]),
                        "backend": key["backend"], "tp": int(key["tp"]),
                        "occupancy": key["occupancy"],
                        "store_flavor": key["store_flavor"],
                        "page_size": key["page_size"],
                        "batch": batch, "max_len": max_len,
                        "chunk": plan.chunk},
        }

    # -- tile plans ---------------------------------------------------------
    def lookup_tiles(self, kind: str, machine: str, kwargs: dict):
        """The stored TilePlan for one tuner key, or None."""
        from repro_torch.kernels.tuning import TilePlan
        hit = self.tiles.get(_digest(_tile_material(kind, machine, kwargs)))
        if hit is None:
            return None
        return TilePlan(**hit["plan"])

    def record_tiles(self, kind: str, machine: str, kwargs: dict,
                     plan) -> None:
        """Keep one tuned tile plan under its tuner key."""
        self.tiles[_digest(_tile_material(kind, machine, kwargs))] = {
            "plan": dataclasses.asdict(plan),
            "context": dict(kwargs, kind=kind, machine=str(machine),
                            bk=plan.bk, n_splits=plan.n_splits),
        }

    # -- persistence --------------------------------------------------------
    def save(self, path) -> None:
        """Write the database as versioned JSON."""
        doc = {"format": "repro-plandb", "version": PLANDB_VERSION,
               "meta": self.meta, "chunks": self.chunks,
               "tiles": self.tiles}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path) -> "PlanDB":
        """Read a versioned JSON database; other versions are errors."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != "repro-plandb":
            raise ValueError(f"{path}: not a repro plan database")
        if doc.get("version") != PLANDB_VERSION:
            raise ValueError(
                f"{path}: plan-DB version {doc.get('version')} != "
                f"supported {PLANDB_VERSION}; run the sweep again")
        return cls(chunks=doc.get("chunks", {}),
                   tiles=doc.get("tiles", {}), meta=doc.get("meta", {}))

    def __len__(self) -> int:
        return len(self.chunks) + len(self.tiles)


def install(db: PlanDB | None) -> None:
    """Make ``db`` the process-wide plan database (None uninstalls).

    Clears the planner's and tuner's memos, so the next plan request
    consults the new database, not an answer memoized under the old one.
    """
    global _INSTALLED
    _INSTALLED = db
    from repro_torch.serve.planner import clear_plan_cache
    clear_plan_cache()


def installed() -> PlanDB | None:
    """The installed plan database, if any."""
    return _INSTALLED


def sweep(cfg, *, batches=(8,), max_lens=(1024,),
          machines=None, backends=("tp_bound", "mca_sched"),
          tps=(1, 2), store_flavors=("auto",),
          occupancies=(None,), page_sizes=(None,),
          dispatch_overhead_s: float = 2e-4, overhead_frac: float = 0.1,
          max_chunk: int = 32, decode_batch: int = 1,
          dtype: str = "bf16") -> PlanDB:
    """Price the serve plan space offline and return the database.

    Chunk plans over (batch x max_len x machine x backend x tp x store
    flavor x occupancy x page size) through the online planner (an
    installed database is uninstalled for the sweep, so it never copies
    itself), and tile plans (flash prefill and split-KV decode) over
    (machine x backend) at the shapes the config serves. ``machines``
    defaults to every registered one.
    """
    from repro_torch.kernels.tuning import decode_tiles, flash_tiles
    from repro_torch.serve.planner import plan_chunk_size
    from repro_torch.utils.sharding import (SERVE_ENGINE_RULES,
                                            rules_fingerprint)
    if machines is None:
        machines = registered_names()
    db = PlanDB(meta={
        "package": PACKAGE,
        "config": {"name": getattr(cfg, "name", "?"),
                   "fingerprint": config_fingerprint(cfg)},
        "registry": dict(registry_fingerprint()),
    })
    prev = _INSTALLED
    install(None)
    try:
        for batch in batches:
            for max_len in max_lens:
                for machine in machines:
                    for backend in backends:
                        for tp in tps:
                            for flavor in store_flavors:
                                for occ in occupancies:
                                    for ps in page_sizes:
                                        _sweep_one(
                                            db, cfg, batch, max_len,
                                            machine=machine,
                                            backend=backend, tp=tp,
                                            store_flavor=flavor,
                                            occupancy=occ, page_size=ps,
                                            dispatch_overhead_s=(
                                                dispatch_overhead_s),
                                            overhead_frac=overhead_frac,
                                            max_chunk=max_chunk,
                                            plan_fn=plan_chunk_size,
                                            rules=SERVE_ENGINE_RULES,
                                            rules_fp=rules_fingerprint)
        dh = cfg.head_dim_eff
        for max_len in max_lens:
            for machine in machines:
                for backend in backends:
                    fkw = dict(s=max_len, dh=dh, h=cfg.n_heads,
                               hkv=cfg.n_kv_heads, dtype=dtype,
                               backend=backend)
                    db.record_tiles("flash", machine, fkw,
                                    flash_tiles(machine, **fkw))
                    dkw = dict(skv=max_len, dh=dh, h=cfg.n_heads,
                               hkv=cfg.n_kv_heads, batch=decode_batch,
                               dtype=dtype, backend=backend)
                    db.record_tiles("decode", machine, dkw,
                                    decode_tiles(machine, **dkw))
    finally:
        install(prev)
    return db


def _sweep_one(db, cfg, batch, max_len, *, machine, backend, tp,
               store_flavor, occupancy, page_size, dispatch_overhead_s,
               overhead_frac, max_chunk, plan_fn, rules, rules_fp):
    """Plan one swept point online and record it under its key."""
    plan = plan_fn(cfg, batch, max_len, machine=machine,
                   dispatch_overhead_s=dispatch_overhead_s,
                   overhead_frac=overhead_frac, max_chunk=max_chunk,
                   occupancy=occupancy, backend=backend,
                   store_flavor=store_flavor, page_size=page_size,
                   tp=tp)
    mesh_sizes = {"data": 1, "model": int(tp)} if tp > 1 else {}
    db.record_chunk(cfg, batch, max_len, plan=plan, machine=machine,
                    dispatch_overhead_s=dispatch_overhead_s,
                    overhead_frac=overhead_frac, max_chunk=max_chunk,
                    occupancy=occupancy, backend=plan.backend,
                    store_flavor=store_flavor, page_size=page_size,
                    mesh_sizes=mesh_sizes,
                    rules_fp=rules_fp(rules if tp > 1 else None),
                    tp=max(1, int(tp)))


def backend_disagreements(db: PlanDB) -> list:
    """Swept points where ``tp_bound`` and ``mca_sched`` picked different
    winners: a different chunk for chunk plans, a different
    ``(bk, n_splits)`` for tile plans; each row carries both winners."""
    rows = []
    by_point: dict = {}
    for ent in db.chunks.values():
        ctx = dict(ent["context"])
        backend = ctx.pop("backend")
        chunk = ctx.pop("chunk")
        by_point.setdefault(tuple(sorted(ctx.items())),
                            {})[backend] = (chunk, ctx)
    for winners in by_point.values():
        picks = {b: w[0] for b, w in winners.items()}
        if len(set(picks.values())) > 1:
            ctx = next(iter(winners.values()))[1]
            rows.append(dict(kind="chunk", picks=picks, **ctx))
    by_point = {}
    for ent in db.tiles.values():
        ctx = dict(ent["context"])
        backend = ctx.pop("backend")
        win = (ctx.pop("bk"), ctx.pop("n_splits"))
        by_point.setdefault(tuple(sorted(ctx.items())),
                            {})[backend] = (win, ctx)
    for winners in by_point.values():
        picks = {b: w[0] for b, w in winners.items()}
        if len(set(picks.values())) > 1:
            ctx = next(iter(winners.values()))[1]
            rows.append(dict(kind="tiles",
                             picks={b: {"bk": w[0], "n_splits": w[1]}
                                    for b, w in picks.items()}, **ctx))
    return rows
