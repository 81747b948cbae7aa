"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

On fake process groups in child processes (``_torch_dryrun_child.py``; a
process holds one default group): the smoke yi-9b's train, prefill and
decode cells at a (2,2) mesh, whose argument, output and alias bytes
must equal those the reference's ``lower_cell`` compiles to on 4 XLA
host devices (a mesh of ``AxisType.Auto`` axes, in its own child); one
full-width yi-9b layer's ``decode_32k`` and ``train_4k`` records at
16x16; the collectives of a trace, each kind at groups of 2, 16 and 256,
priced as the reference's ``isa.decompose`` prices the HLO collective of
the same payload. In this process: a ``repeat`` loop's trip-multiplied
counts against every trip lowered, ``serve_uses_fsdp`` against the
reference's, the benchmarks that read records (``roofline_sweep``,
``make_experiments``, ``perf_iterations --report``,
``h1_flash_substitution``) on records written to ``tmp_path``, and the
CLI's refusals. Exact equality unless a tolerance is named.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import portmodel
from repro_torch.core import trace as T
from repro_torch.launch import dryrun as D
from repro_torch.models import attention as attn_lib
from repro_torch.optim.adamw import OptConfig
from repro_torch.train import serve as SV
from repro_torch.train import step as ST

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHILD = os.path.join(HERE, "_torch_dryrun_child.py")
TIME_LIMIT = 240            # seconds a child may take

#: the reference's (2,2) smoke cells, compiled: (argument, output, alias)
#: bytes a device, XLA's ``memory_analysis`` (what the child prints)
REFERENCE_CELLS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {src!r})
    import jax
    assert len(jax.devices()) == 4    # fixed before dryrun asks for 512
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.launch.dryrun import lower_cell
    from repro.utils.sharding import use_mesh_rules
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    cfg = get_smoke_config("yi-9b")
    out = {{}}
    for kind in ("train", "prefill", "decode"):
        jfn, args, rules, _ = lower_cell(cfg, ShapeSpec(kind, 64, 4, kind),
                                         mesh)
        with mesh, use_mesh_rules(mesh, rules):
            ma = jfn.lower(*args).compile().memory_analysis()
        out[kind] = [ma.argument_size_in_bytes, ma.output_size_in_bytes,
                     ma.alias_size_in_bytes]
    print(json.dumps(out))
""")

#: keys of a reference record (``repro/launch/dryrun.py:run_cell``)
REFERENCE_KEYS = {"arch", "shape", "mesh", "n_devices", "lower_s",
                  "compile_s", "memory", "cost", "collectives", "portmodel",
                  "wa", "wa_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes"}
PORTMODEL_KEYS = {"tp_cycles", "cp_cycles", "serial_cycles", "flops",
                  "bytes_hbm", "coll_bytes", "bottleneck", "unknown_ops",
                  "n_instrs", "trips", "top_ports", "loop_bytes"}


def _start(argv) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)


def _finish(p: subprocess.Popen, deadline: float) -> subprocess.CompletedProcess:
    """A child's result by ``deadline``; on a hang its process group is
    killed and the test fails."""
    try:
        out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"{p.args[1:4]} took over {TIME_LIMIT} s")
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


H34 = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    from repro_torch.bench import perf_iterations as P
    n = P.run_cells("H3", {out!r}, "cpu") + P.run_cells("H4", {out!r}, "cpu")
    print("FAILURES", n)
""")


@pytest.fixture(scope="module")
def kids(tmp_path_factory):
    """Every child of this file, started at once: the port's (2,2) smoke
    records, the reference's compiled cells, the full-width layer's
    records, the collectives, the CLI's refusals and perf_iterations'
    H3/H4. Their results, and the directories they wrote."""
    d = {k: tmp_path_factory.mktemp(k) for k in ("cells", "full", "coll",
                                                 "cli", "h34")}
    src = os.path.join(REPO, "src")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--out", str(d["cli"])]
    argv = {
        "cells": [sys.executable, CHILD, "cells", str(d["cells"])],
        "reference": [sys.executable, "-c", REFERENCE_CELLS.format(src=src)],
        "full": [sys.executable, CHILD, "full", str(d["full"])],
        "coll": [sys.executable, CHILD, "collectives",
                 str(d["coll"] / "coll.json")],
        "cli_7d": cli + ["--arch", "xlstm-125m", "--shape", "decode_32k",
                         "--device", "cpu"],
        "h34": [sys.executable, "-c", H34.format(src=src,
                                                 out=str(d["h34"]))]}
    if not torch.cuda.is_available():
        argv["cli_cuda"] = cli + ["--arch", "yi-9b", "--shape", "decode_32k"]
    deadline = time.time() + TIME_LIMIT
    procs = {k: _start(a) for k, a in argv.items()}
    return {k: _finish(p, deadline) for k, p in procs.items()}, d


@pytest.fixture(scope="module")
def cells(kids):
    """The port's (2,2) smoke records, in a directory of their own."""
    res, d = kids
    assert res["cells"].returncode == 0, res["cells"].stderr[-3000:]
    return {k: json.loads((d["cells"] / f"{k}.json").read_text())
            for k in ("train", "prefill", "decode")}, d["cells"]


def test_reference_cells_memory_equal(kids, cells):
    """Argument, output and alias bytes a device: the port's records at a
    (2,2) fake mesh equal the reference's compiled cells."""
    res = kids[0]["reference"]
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {k: [r["memory"][n] for n in ("argument_bytes", "output_bytes",
                                        "alias_bytes")]
           for k, r in cells[0].items()}
    assert got == want
    # the figures XLA reports for the reference: train, prefill, decode
    assert want == {"train": [1072388, 1071720, 1071364],
                    "prefill": [427776, 33816, 0],
                    "decode": [460044, 33816, 32768]}


def test_smoke_cells_keep_the_reference_keys(cells):
    for kind, rec in cells[0].items():
        assert REFERENCE_KEYS <= set(rec), kind
        assert MEMORY_KEYS <= set(rec["memory"]), kind
        assert PORTMODEL_KEYS <= set(rec["portmodel"]), kind
        assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
        assert rec["compile_s"] == 0.0 and rec["device_type"] == "cpu"
        m = rec["memory"]
        assert m["peak_bytes"] >= m["argument_bytes"] + m["temp_bytes"]
        assert rec["cost"]["flops"] > 0 and rec["wa_ratio"] >= 1.0
        assert rec["portmodel"]["unknown_ops"] == 0, kind
    assert cells[0]["train"]["accum_steps"] == 1
    assert cells[0]["decode"]["rules"] == "serve"
    # the sequence-sharded decode: the ranks' partials merge over model
    coll = cells[0]["decode"]["collectives"]
    assert coll["all-reduce"]["groups"] == [2]
    assert coll["all-reduce"]["count"] == 1 + 2 * 2 + 2 * 2


@pytest.fixture(scope="module")
def full(kids):
    res, d = kids
    assert res["full"].returncode == 0, res["full"].stderr[-3000:]
    return {s: json.loads((d["full"] / f"{s}.json").read_text())
            for s in ("decode_32k", "train_4k")}


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_full_width_layer_at_16x16(full, shape):
    """One full-width yi-9b layer on the 16x16 fake mesh: every reference
    key, collectives on the model axis's groups of 16 (all-reduces: the
    kinds a ``cpu`` and a ``cuda`` mesh both run), the local shards'
    bytes."""
    rec = full[shape]
    assert REFERENCE_KEYS <= set(rec) and rec["mesh"] == "16x16"
    assert rec["n_devices"] == 256
    ar = rec["collectives"]["all-reduce"]
    assert ar["count"] > 0 and ar["bytes"] > 0 and 16 in ar["groups"]
    assert set(rec["portmodel"]["coll_bytes"]) >= {"all-reduce"}
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=1)
    if shape == "train_4k":
        oc = OptConfig()
        from repro_torch.utils import sharding as S
        sizes = {"data": 16, "model": 16}
        specs = ST.train_state_pspecs(cfg, S.TRAIN_RULES, sizes, oc)
        state = ST.train_state_shapes(cfg, oc)
        want = 0
        for (_, t), (_, spec) in zip(_walk(state), _walk(specs)):
            n = t.numel() * t.element_size()
            for part in spec:
                for ax in (part if isinstance(part, tuple) else
                           (part,) if part else ()):
                    n //= sizes[ax]
            want += n
        batch = 2 * (256 // 16) * 4096 * 4          # tokens + targets
        assert rec["memory"]["argument_bytes"] == want + batch
        assert rec["memory"]["alias_bytes"] == want
        assert rec["accum_steps"] == 1
    else:
        # the cache rows over model, the slots over data: 8 slots x 2048
        kv = 2 * 1 * 8 * 2048 * 4 * 128 * 2
        assert rec["memory"]["alias_bytes"] == kv


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# --- collectives ------------------------------------------------------------

def _hlo(kind: str, n: int, g: int, world: int = 256) -> str:
    out = {"all-reduce": n, "all-gather": n * g, "reduce-scatter": n // g,
           "all-to-all": n}[kind]
    return textwrap.dedent(f"""
        HloModule m

        ENTRY %main.1 (p.0: f32[{n}]) -> f32[{out}] {{
          %p.0 = f32[{n}]{{0}} parameter(0)
          ROOT %c.1 = f32[{out}]{{0}} {kind}(f32[{n}]{{0}} %p.0), replica_groups=[{world // g},{g}]<=[{world}], to_apply=%add
        }}
    """)


@pytest.fixture(scope="module")
def collectives(kids):
    res, d = kids
    assert res["coll"].returncode == 0, res["coll"].stderr[-3000:]
    return json.loads((d["coll"] / "coll.json").read_text())


@pytest.mark.parametrize("g", [2, 16, 256])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all"])
def test_collective_priced_as_jax(collectives, kind, g):
    """Each kind, functional and c10d, at group size g: the port's wire
    bytes and µ-ops equal the reference's ``isa.decompose`` of the HLO
    collective with the same payload (4096 f32 in)."""
    from repro.core import hloparse
    from repro.core import isa as jisa
    mod = hloparse.parse_hlo(_hlo(kind, 4096, g))
    shapes_of = {i.name: i.shape for i in mod.entry.instrs}
    instr = mod.entry.instrs[-1]
    want = jisa.decompose(instr, shapes_of, 256)
    ops = [r for r in collectives if "op" in r and r["group"] == g
           and r["coll_kind"] == kind]
    recs = [r for r in collectives if "kind" in r and r["group"] == g
            and r["kind"] == kind]
    assert len(ops) == 2 and len(recs) == 2      # functional and c10d
    for op in ops:
        assert op["coll_bytes"] == want.coll_bytes
        assert [tuple(u) for u in op["uops"]] == [tuple(u)
                                                  for u in want.uops]
    for r in recs:
        assert r["wire"] == want.coll_bytes and r["count"] == 1
        assert r["payload"] == instr.shape.bytes


# --- loops ------------------------------------------------------------------

def _plain_repeat(trips: int, step) -> None:
    for i in range(trips):
        step(i)


def _train_trace(seq: int, accum: int, monkeypatch=None):
    """The smoke yi-9b's train step lowered; with ``monkeypatch`` the
    microbatch loop and the attention's kv walk run as plain loops, so
    the trace holds every trip."""
    cfg = get_smoke_config("yi-9b")
    oc = OptConfig()
    state = ST.train_state_shapes(cfg, oc)
    batch = ST.batch_shapes(cfg, ShapeSpec("t", seq, 4, "train"))
    fn = ST.make_train_step(cfg, oc, accum)
    if monkeypatch is None:
        return T.lower_call(fn, (state, batch))
    with monkeypatch.context() as mp:
        for mod in (ST, attn_lib):
            mp.setattr(mod, "repeat", _plain_repeat)
        return T.lower_call(fn, (state, batch))


def test_microbatch_loop_trips_equal_every_microbatch(monkeypatch):
    """The microbatch loop lowered as one body of 2 trips prices as the
    two microbatches lowered one after the other: FLOPs and HBM bytes
    (the attention walks are one kv chunk long here)."""
    looped = portmodel.analyze(_train_trace(16, 2), "h100")
    flat = portmodel.analyze(_train_trace(16, 2, monkeypatch), "h100")
    assert looped.flops == flat.flops
    assert looped.bytes_hbm == flat.bytes_hbm
    assert looped.trips_seen and not flat.trips_seen


def test_attention_walk_backward_counted_a_trip(monkeypatch):
    """The attention's kv walk (4 chunks) as loop regions: its backward
    pass is a loop of the same trips, so the matrix products' FLOPs equal
    a lowering of every trip; all FLOPs within 1 % (the first trip's
    backward skips the carry products of later ones)."""
    looped = D.trace_cost(_train_trace(64, 1))
    flat = D.trace_cost(_train_trace(64, 1, monkeypatch))
    assert looped["matmul_flops"] == flat["matmul_flops"]
    assert looped["flops"] == pytest.approx(flat["flops"], rel=0.01)


# --- rules, CLI, benchmarks -------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2, 16])
def test_serve_uses_fsdp_equals_jax(tp):
    from repro.configs import get_config as jcfg
    from repro.train import serve as JSV
    for arch in ARCH_IDS:
        assert SV.serve_uses_fsdp(get_config(arch), tp=tp) \
            == JSV.serve_uses_fsdp(jcfg(arch), tp=tp), arch


def test_dryrun_cli_refuses_without_a_card_and_counts_7d(kids):
    """``--device cuda`` without a card exits 2; a recurrent config under
    the mesh writes its ``.err`` naming item 7d and the sweep exits 1."""
    res, d = kids
    if "cli_cuda" in res:
        assert res["cli_cuda"].returncode == 2
        assert "no CUDA device" in res["cli_cuda"].stderr
    r = res["cli_7d"]
    assert r.returncode == 1, r.stderr[-2000:]
    err = (d["cli"] / "xlstm-125m_decode_32k_sp.err").read_text()
    assert "NotImplementedError" in err and "item 7d" in err
    assert "[FAIL] xlstm-125m_decode_32k_sp" in r.stdout


def test_benchmarks_read_the_records(cells, tmp_path, capsys):
    """roofline_sweep prints a row a record; make_experiments fills its
    document's blocks from them; perf_iterations' report and trajectory
    and h1_flash_substitution read iteration records."""
    from repro_torch.bench import (h1_flash_substitution, make_experiments,
                                   perf_iterations, roofline_sweep)
    d = cells[1]
    lines = roofline_sweep.main(pattern=str(d / "*.json"))
    assert len(lines) == 3 and all(ln.startswith("roofline,yi-9b.")
                                   for ln in lines)
    assert all("dom=" in ln for ln in lines)
    doc = tmp_path / "EXPERIMENTS.md"
    text = make_experiments.main(str(doc), str(d), str(tmp_path / "perf"),
                                 str(tmp_path / "none.json"))
    assert doc.read_text() == text
    assert text.count("| yi-9b |") == 6          # dryrun + roofline rows
    perf = tmp_path / "perf"
    perf.mkdir()
    for kind, rec in cells[0].items():
        rec = dict(rec, _terms=perf_iterations.terms(rec))
        (perf / f"H9_{kind}.json").write_text(json.dumps(rec))
    rows = perf_iterations.report(str(perf))
    assert len(rows) == 3 and rows[0].startswith("H9_decode")
    traj = perf_iterations.write_trajectory(str(tmp_path / "t.json"),
                                            str(perf))
    assert traj["n_iterations"] == 3
    out = h1_flash_substitution.main(str(perf / "H9_train.json"), seq=64,
                                     global_batch=4, tp=2)
    assert out["before"] == cells[0]["train"]["portmodel"]["bytes_hbm"]
    capsys.readouterr()


def test_h1_attributes_attention_bytes(full):
    """The full-width layer's train record: the kv walks move more than
    8 MB a trip, and h1 attributes them."""
    import tempfile
    from repro_torch.bench import h1_flash_substitution
    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump(full["train_4k"], f)
        f.flush()
        out = h1_flash_substitution.main(f.name)
    assert out["attn_bytes"] > 0
    assert out["attn_bytes"] < out["before"]


def test_h3_h4_refused_until_7d(kids):
    """perf_iterations' H3 and H4 cells (jamba, qwen3-moe) count as
    failures: a mesh refuses them (item 7d)."""
    res = kids[0]["h34"]
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FAILURES 4" in res.stdout
    assert res.stdout.count("item 7d") == 4
