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
``h1_flash_substitution``) on records written to ``tmp_path``, the
CLI's refusal without a card and its ``--all`` sweep, and
``perf_iterations``' H3 and H4. Exact equality unless a tolerance is named.
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
    out = {{}}
    for arch in {archs!r}:
        cfg = get_smoke_config(arch)
        out[arch] = {{}}
        for kind in ("train", "prefill", "decode"):
            jfn, args, rules, _ = lower_cell(
                cfg, ShapeSpec(kind, 64, 4, kind), mesh)
            with mesh, use_mesh_rules(mesh, rules):
                ma = jfn.lower(*args).compile().memory_analysis()
            out[arch][kind] = [ma.argument_size_in_bytes,
                               ma.output_size_in_bytes,
                               ma.alias_size_in_bytes]
    print(json.dumps(out))
""")

#: the configs a mesh once refused, their (2,2) smoke cells held as
#: yi-9b's (the port's in one child, the reference's in a child each)
FAMILY_CELLS = ("jamba-v0.1-52b", "qwen3-moe-235b-a22b", "xlstm-125m",
                "musicgen-large")

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


#: perf_iterations' H3 and H4 through ``run_cells``, each iteration's
#: config cut to its smoke size (its variant kept) on a (2,2) fake mesh
H34 = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    from repro_torch.bench import perf_iterations as P
    from repro_torch.configs.base import ShapeSpec, smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2), device_type="cpu", fake=True)
    full = P.iterations
    P.iterations = lambda cell: [
        (tag, dict(kw, cfg=smoke_config(kw["cfg"]), mesh=mesh,
                   shape=ShapeSpec("train", 64, 4, "train")))
        for tag, kw in full(cell)]
    n = P.run_cells("H3", {out!r}, "cpu") + P.run_cells("H4", {out!r}, "cpu")
    print("FAILURES", n)
""")

#: ``--all`` over a directory holding a record of every cell but one
#: (a config the mesh once refused): the sweep lowers that one
SWEEP_CELL = ("xlstm-125m", "decode_32k")


@pytest.fixture(scope="module")
def kids(tmp_path_factory):
    """Every child of this file, started at once: the port's (2,2) smoke
    records, the reference's compiled cells, the full-width layer's
    records, the collectives, the CLI's refusals and perf_iterations'
    H3/H4. Their results, and the directories they wrote."""
    d = {k: tmp_path_factory.mktemp(k) for k in ("cells", "cells_fam",
                                                 "full", "coll", "cli",
                                                 "h34")}
    src = os.path.join(REPO, "src")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--out", str(d["cli"])]
    argv = {
        "cells": [sys.executable, CHILD, "cells", str(d["cells"])],
        "cells_fam": [sys.executable, CHILD, "cells", str(d["cells_fam"]),
                      ",".join(FAMILY_CELLS)],
        "reference": [sys.executable, "-c", REFERENCE_CELLS.format(
            src=src, archs=("yi-9b",))],
        **{f"reference_{a}": [sys.executable, "-c", REFERENCE_CELLS.format(
            src=src, archs=(a,))] for a in FAMILY_CELLS},
        "full": [sys.executable, CHILD, "full", str(d["full"])],
        "coll": [sys.executable, CHILD, "collectives",
                 str(d["coll"] / "coll.json")],
        "cli_7d": cli + ["--all", "--device", "cpu"],
        "h34": [sys.executable, "-c", H34.format(src=src,
                                                 out=str(d["h34"]))]}
    if not torch.cuda.is_available():
        argv["cli_cuda"] = cli + ["--arch", "yi-9b", "--shape", "decode_32k"]
    from repro_torch.configs.base import shapes_for
    for arch in ARCH_IDS:
        for sh in shapes_for(get_config(arch)):
            if (arch, sh.name) != SWEEP_CELL:
                (d["cli"] / f"{arch}_{sh.name}_sp.json").write_text("{}")
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
    want = json.loads(res.stdout.strip().splitlines()[-1])["yi-9b"]
    got = {k: [r["memory"][n] for n in ("argument_bytes", "output_bytes",
                                        "alias_bytes")]
           for k, r in cells[0].items()}
    assert got == want
    # the figures XLA reports for the reference: train, prefill, decode
    assert want == {"train": [1072388, 1071720, 1071364],
                    "prefill": [427776, 33816, 0],
                    "decode": [460044, 33816, 32768]}


#: where XLA's memory analysis of a (2,2) smoke decode cell counts other
#: bytes than the port's step holds: the decode step's position, which no
#: layer of an attention-free, position-free model reads, XLA prunes from
#: the arguments (``jit``'s ``keep_unused=False``); a Mamba layer's conv
#: state the port writes in place into its fp32 cache leaf (aliased),
#: where the reference hands it back in bf16 as a new output buffer.
XLA_DIFFERS = {"xlstm-125m": ("pos",), "jamba-v0.1-52b": ("conv",)}


@pytest.mark.parametrize("arch", FAMILY_CELLS)
def test_family_reference_cells_memory_equal(kids, arch):
    """The configs a mesh once refused (Mamba and MoE, MoE, mLSTM and
    sLSTM, embedding inputs): the (2,2) smoke cells' argument, output and
    alias bytes a device equal the reference's compiled cells, but for
    the differences of :data:`XLA_DIFFERS` in the decode cell, whose
    sizes the child reads off the step's own arguments."""
    res, d = kids
    for name in ("cells_fam", f"reference_{arch}"):
        assert res[name].returncode == 0, res[name].stderr[-3000:]
    want = json.loads(res[f"reference_{arch}"].stdout.strip()
                      .splitlines()[-1])
    for kind in ("train", "prefill", "decode"):
        rec = json.loads((d["cells_fam"] / f"{arch}_{kind}.json")
                         .read_text())
        arg, out, alias = [rec["memory"][n] for n in (
            "argument_bytes", "output_bytes", "alias_bytes")]
        differs = XLA_DIFFERS.get(arch, ()) if kind == "decode" else ()
        if "pos" in differs:
            assert rec["xla_differs"]["pos"] > 0
            arg -= rec["xla_differs"]["pos"]
        if "conv" in differs:
            conv, conv_out = (rec["xla_differs"][k]
                              for k in ("conv", "conv_out"))
            assert conv > 0 and conv_out < conv
            alias -= conv
            out += conv_out - conv
        assert [arg, out, alias] == want[arch][kind], kind
        assert rec["portmodel"]["unknown_ops"] == 0, kind


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
    """``--device cuda`` without a card exits 2. ``--all`` now exits 0:
    the recurrent config a mesh once refused lowers (its record written,
    no ``.err``), every other cell read from its record."""
    res, d = kids
    if "cli_cuda" in res:
        assert res["cli_cuda"].returncode == 2
        assert "no CUDA device" in res["cli_cuda"].stderr
    r = res["cli_7d"]
    assert r.returncode == 0, r.stderr[-2000:]
    tag = "_".join(SWEEP_CELL) + "_sp"
    assert f"[ok]   {tag}" in r.stdout and "done; 0 failures" in r.stdout
    assert not list(d["cli"].glob("*.err"))
    rec = json.loads((d["cli"] / f"{tag}.json").read_text())
    assert REFERENCE_KEYS <= set(rec) and rec["n_devices"] == 256
    assert rec["collectives"]["all-reduce"]["count"] > 0


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
    """perf_iterations' H3 (jamba, Mamba unfused and fused) and H4
    (qwen3-moe, fp32 and int8 moments), once refused under a mesh, now
    report: each iteration lowered (at its smoke size on a (2,2) fake
    mesh) and priced, no failure."""
    res = kids[0]["h34"]
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FAILURES 0" in res.stdout
    for tag in ("H3_base_unfused", "H3_it1_fused", "H4_base",
                "H4_it1_int8_moments"):
        assert f"[ok]   {tag}: Tc=" in res.stdout, res.stdout
