"""The port's plan database (``repro_torch.serve.plandb``) against the
JAX package's (``tests/test_plandb.py``), on the port's planner and
tuner: database hits equal online plans with zero online work, misses
plan online unchanged, content fingerprints invalidate, the JSON is
versioned, tile plans hit, disagreements are reported, a sweep never
copies itself; and a database the JAX package wrote misses in the port,
whose planner prices another program (an ATen trace, not HLO)."""

import dataclasses

import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.serve import plandb as jax_plandb
from repro_torch.configs import get_smoke_config
from repro_torch.core.machine import get_machine, register, registered_names
from repro_torch.kernels import tuning
from repro_torch.serve import plandb
from repro_torch.serve.planner import (clear_plan_cache, plan_chunk_size,
                                       plan_stats, reset_plan_stats)

torch.set_num_threads(1)

BATCH, MAX_LEN = 4, 96


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("yi-9b")


@pytest.fixture(scope="module")
def db(cfg):
    return plandb.sweep(cfg, batches=(BATCH,), max_lens=(MAX_LEN,),
                        tps=(1,))


@pytest.fixture(autouse=True)
def _clean_install():
    prev = plandb.installed()
    yield
    plandb.install(prev)


def _plan_all(cfg, **kw):
    return {m: plan_chunk_size(cfg, BATCH, MAX_LEN, machine=m, **kw)
            for m in registered_names()}


def test_db_hit_bit_identical_zero_online(cfg, db):
    """Every registered machine: the DB plan equals the online plan as a
    dataclass (floats bit for bit through JSON), with no online plan."""
    plandb.install(None)
    ref = _plan_all(cfg)
    plandb.install(db)
    reset_plan_stats()
    hits = _plan_all(cfg)
    stats = plan_stats()
    assert stats["online_plans"] == 0
    assert stats["db_hits"] == len(registered_names())
    for m, p in hits.items():
        assert p == ref[m], f"{m}: DB plan differs from online"


def test_db_miss_falls_back_identically(cfg, db):
    """A key outside the sweep (another batch) misses and is planned
    online: the plan made with no database installed."""
    plandb.install(None)
    ref = plan_chunk_size(cfg, BATCH + 1, MAX_LEN, machine="zen4")
    plandb.install(db)
    reset_plan_stats()
    got = plan_chunk_size(cfg, BATCH + 1, MAX_LEN, machine="zen4")
    stats = plan_stats()
    assert stats["online_plans"] == 1 and stats["db_hits"] == 0
    assert got == ref


def test_memo_and_db_share_one_invalidation(cfg, db):
    """clear_plan_cache() empties the plan memo and the tile memo, so a
    database installed after (install() calls it) is consulted."""
    plandb.install(db)
    reset_plan_stats()
    plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
    plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
    stats = plan_stats()
    assert stats["db_hits"] == 1 and stats["memo_hits"] == 1
    clear_plan_cache()
    reset_plan_stats()
    plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
    assert plan_stats()["db_hits"] == 1


def test_machine_refingerprint_invalidates(cfg, db):
    """register(replace=True) with other parameters changes the registry
    fingerprint: the old key misses and the plan is made online."""
    orig = get_machine("zen4")
    plandb.install(db)
    reset_plan_stats()
    plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
    assert plan_stats()["db_hits"] == 1
    try:
        register(dataclasses.replace(orig, clock_hz=orig.clock_hz * 2),
                 replace=True)
        clear_plan_cache()
        reset_plan_stats()
        plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
        stats = plan_stats()
        assert stats["db_hits"] == 0 and stats["online_plans"] == 1
    finally:
        register(orig, replace=True)
        clear_plan_cache()


def test_config_fingerprint_invalidates(cfg, db):
    """A config change (vocab size) misses every chunk key."""
    plandb.install(db)
    reset_plan_stats()
    other = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
    plan_chunk_size(other, BATCH, MAX_LEN, machine="zen4")
    stats = plan_stats()
    assert stats["db_hits"] == 0 and stats["online_plans"] == 1


def test_save_load_roundtrip_and_version_gate(cfg, db, tmp_path):
    path = tmp_path / "plans.json"
    db.save(path)
    back = plandb.PlanDB.load(path)
    assert len(back) == len(db)
    assert back.meta["package"] == "repro_torch"
    plandb.install(None)
    ref = _plan_all(cfg)
    plandb.install(back)
    reset_plan_stats()
    assert _plan_all(cfg) == ref
    assert plan_stats()["online_plans"] == 0
    import json
    doc = json.loads(path.read_text())
    doc["version"] = plandb.PLANDB_VERSION + 1
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="version"):
        plandb.PlanDB.load(path)
    doc["format"] = "something-else"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="not a repro plan database"):
        plandb.PlanDB.load(path)


def test_tile_db_hits(cfg, db):
    """flash and decode tile lookups resolve from the DB with zero online
    tunes, equal to the online tuner."""
    kw = dict(dh=cfg.head_dim_eff, h=cfg.n_heads, hkv=cfg.n_kv_heads,
              backend="tp_bound")
    plandb.install(None)
    tuning.clear_cache()
    ref_f = tuning.flash_tiles("zen4", s=MAX_LEN, **kw)
    ref_d = tuning.decode_tiles("zen4", skv=MAX_LEN, **kw)
    plandb.install(db)
    tuning.reset_tile_stats()
    got_f = tuning.flash_tiles("zen4", s=MAX_LEN, **kw)
    got_d = tuning.decode_tiles("zen4", skv=MAX_LEN, **kw)
    stats = tuning.tile_stats()
    assert stats["online"] == 0
    assert stats["db_hits"] == 2
    assert got_f == ref_f and got_d == ref_d


def test_backend_disagreement_report(db):
    """The report is well formed; each row names a swept point where the
    two backends picked different winners."""
    rows = plandb.backend_disagreements(db)
    assert isinstance(rows, list)
    for r in rows:
        assert r["kind"] in ("chunk", "tiles")
        assert set(r["picks"]) == {"tp_bound", "mca_sched"}


def test_sweep_never_copies_itself(cfg, db):
    """Sweeping with a DB installed uninstalls it for the sweep: the new
    plans are online answers, then the installation returns."""
    plandb.install(db)
    again = plandb.sweep(cfg, batches=(BATCH,), max_lens=(MAX_LEN,),
                         tps=(1,))
    assert plandb.installed() is db
    assert len(again) == len(db)


def test_jax_written_db_misses_in_the_port(cfg, db, tmp_path):
    """The two packages' configs share a repr and their machine files a
    fingerprint, but a plan the JAX package priced (on HLO) must not be
    served by the port: its database loads and every lookup misses, chunk
    and tile plans alike, and the port plans online."""
    jdb = jax_plandb.sweep(jax_smoke("yi-9b"), batches=(BATCH,),
                           max_lens=(MAX_LEN,), machines=("zen4",),
                           backends=("tp_bound",), tps=(1,))
    path = tmp_path / "jax_plans.json"
    jdb.save(path)
    back = plandb.PlanDB.load(path)
    assert len(back) == len(jdb) > 0
    plandb.install(None)
    ref = plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
    plandb.install(back)
    reset_plan_stats()
    tuning.reset_tile_stats()
    assert plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4") == ref
    tuning.decode_tiles("zen4", skv=MAX_LEN, dh=cfg.head_dim_eff,
                        h=cfg.n_heads, hkv=cfg.n_kv_heads, batch=1,
                        dtype="bf16", backend="tp_bound")
    assert plan_stats()["db_hits"] == 0 and plan_stats()["online_plans"] == 1
    assert tuning.tile_stats()["db_hits"] == 0
    # the port's own sweep of the same point does hit
    plandb.install(db)
    reset_plan_stats()
    plan_chunk_size(cfg, BATCH, MAX_LEN, machine="zen4")
    assert plan_stats()["db_hits"] == 1
