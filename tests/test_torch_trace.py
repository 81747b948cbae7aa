"""The port's trace IR and scheduling backends against the JAX package's.

The backends (``core/backends``), the Report and ``portmodel.compare``
are copies: the JAX package's fixture modules, lowered by its
``trace.lower_text`` and walked into the port's dataclasses
(``_torch_common.trace_from_jax``), must price field for field as the
JAX package prices them, on every machine both packages register. The
port's own lowering (``trace.lower_step``, ATen ops) is held to the JAX
HLO trace of the same decode step: no unknown op, and the matmul FLOPs
within 1 %.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.core import backends as JB
from repro.core import baseline as JBL
from repro.core import machine as JM
from repro.core import portmodel as JP
from repro.core import trace as JT
from repro.serve import planner as JPL
from repro_torch.configs import get_smoke_config
from repro_torch.core import backends as TB
from repro_torch.core import baseline as TBL
from repro_torch.core import isa
from repro_torch.core import machine as TM
from repro_torch.core import portmodel as TP
from repro_torch.core import trace as TT
from repro_torch.serve import planner as TPL

from _torch_common import cfg_pair, matmul_flops, trace_from_jax

torch.set_num_threads(1)

SHARED = ("tpu_v5e", "tpu_v5p", "tpu_v4", "zen4", "golden_cove",
          "neoverse_v2")
_DATA = os.path.join(os.path.dirname(__file__), "data")


def _compile_text(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.fixture(scope="module")
def fixture_hlos():
    """The fixture set of ``tests/test_trace_backends.py``: the committed
    golden module, a straight-line and a scanned one."""
    with open(os.path.join(_DATA, "golden.hlo")) as f:
        golden = f.read()

    def scanned(x):
        def body(c, _):
            return jnp.tanh(c @ c.T) @ c * 0.1, None
        y, _ = jax.lax.scan(body, x, None, length=12)
        return y

    return {
        "golden": golden,
        "straight": _compile_text(
            lambda a, b: jax.nn.relu(a @ b) + jnp.exp(a @ b),
            ((256, 256), jnp.float32), ((256, 256), jnp.float32)),
        "scanned": _compile_text(scanned, ((96, 96), jnp.float32)),
    }


def _fields(rep) -> dict:
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("backend", ["tp_bound", "mca_sched"])
@pytest.mark.parametrize("tag", ["golden", "straight", "scanned"])
def test_backends_price_the_jax_trace_as_jax(fixture_hlos, tag, backend):
    jtr = JT.lower_text(fixture_hlos[tag])
    ttr = trace_from_jax(jtr)
    assert ttr.n_ops() == jtr.n_ops()
    for name in SHARED:
        want = JB.get_backend(backend).run(jtr, JM.get_machine(name),
                                           warn=False)
        got = TB.get_backend(backend).run(ttr, TM.get_machine(name),
                                          warn=False)
        assert _fields(got) == _fields(want), (tag, name)
        # resolved through the memory ladder, as compare() resolves them
        JP.resolve_tiers(want, name)
        TP.resolve_tiers(got, name)
        assert _fields(got) == _fields(want), (tag, name)
        assert got.tier_bound_seconds(TM.get_machine(name)) == \
            want.tier_bound_seconds(JM.get_machine(name))


def test_compare_matches_jax_nested(fixture_hlos):
    hlo = fixture_hlos["scanned"]
    want = JP.compare(hlo, machines=SHARED, backends=("tp", "mca"),
                      parallel="serial")
    got = TP.compare(trace_from_jax(JT.lower_text(hlo)), machines=SHARED,
                     backends=("tp", "mca"))
    assert list(got) == list(want)
    for name in SHARED:
        assert list(got[name]) == list(want[name])
        for b in got[name]:
            assert _fields(got[name][b]) == _fields(want[name][b])
    # the flat shape, and the h100 machine beside the shared ones
    flat = TP.compare(trace_from_jax(JT.lower_text(hlo)))
    assert list(flat) == list(SHARED) + ["h100"]


def test_uops_seconds_matches_jax():
    for name in SHARED:
        for uops in ([("mxu", 10)], [("vpu", 300), ("xlu", 7)],
                     [("vdiv", 5), ("gather4", 9), ("vlsu", 40)]):
            for b in ("tp_bound", "mca_sched"):
                assert TB.uops_seconds(name, uops, b) == \
                    JB.uops_seconds(name, uops, b)


def _ops(region):
    for op in region.ops:
        yield op
        if op.region is not None:
            yield from _ops(op.region)


def test_smoke_decode_step_lowers_as_jax_prices_it():
    """The ATen lowering of the smoke dense decode step (2 slots, 64-row
    horizon, fp32) has no unknown op, and its matrix products count the
    FLOPs of the JAX HLO trace's dots at the same shapes, within 1 %."""
    cj, ct = cfg_pair("float32")
    jtr = JT.lower_text(JPL.decode_step_hlo(cj, 2, 64))
    ttr = TPL.decode_step_trace(ct, 2, 64)
    assert not [op.opcode for op in _ops(ttr.entry) if op.unknown]
    want = matmul_flops(jtr.entry)
    got = matmul_flops(ttr.entry)
    assert want > 0 and got == pytest.approx(want, rel=0.01)
    # one inline region a layer: the decode kernel's launch
    kernels = [op for op in ttr.entry.ops if op.kind == "inline"]
    assert [op.opcode for op in kernels] == ["flash_decode"] * ct.n_layers
    assert all(op.dma_bytes > 0 and op.region.ops for op in kernels)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "musicgen-large"])
def test_every_served_family_lowers_without_unknown_ops(arch):
    """The decode step of every token-input smoke config lowers on meta
    tensors: no unknown op, every op's traffic counted, the h100 price
    finite."""
    cfg = get_smoke_config(arch)
    tr = TPL.decode_step_trace(cfg, 2, 32)
    assert not [op.opcode for op in _ops(tr.entry) if op.unknown]
    assert all(op.dma_bytes is not None for op in tr.entry.ops
               if not op.free)
    rep = TP.compare(tr, machines=["h100"])["h100"]
    assert 0 < rep.tier_bound_seconds(TM.get_machine("h100")) < 1.0


def test_lowering_records_views_writes_and_gathers():
    """Views are free and carry no traffic; an in-place write into a slice
    counts the update twice (read, write); a gather reads the rows it
    picks; deps follow the tensors."""
    def fn(table, idx, cache, upd):
        rows = table[idx]                          # gather: 3 rows
        cache[:, 2:4].copy_(upd)                   # write into a slice
        return rows.t().contiguous() + 1.0         # view, copy, add
    tr = TT.lower_step(
        fn, torch.empty(1000, 64, device="meta"),
        torch.empty(3, dtype=torch.int64, device="meta"),
        torch.empty(8, 16, device="meta"), torch.empty(8, 2, device="meta"))
    by = {op.opcode: op for op in tr.entry.ops}
    assert by["index"].dma_bytes == 3 * 8 + 2 * 3 * 64 * 4
    assert by["index"].uops[0][0] == "gather4"
    assert by["copy_"].dma_bytes == 2 * 8 * 2 * 4
    assert by["t"].free and by["t"].dma_bytes is None
    assert by["t"].deps == (by["index"].name,)
    assert by["clone"].deps == (by["t"].name,)
    assert by["add"].deps == (by["clone"].name,)


def test_kernel_region_charges_what_enters_and_leaves():
    """A ``trace.kernel`` function lowers to one inline region whose
    traffic is the outside tensors it reads, the rows it writes into
    them, and what it returns; its body carries no per-op traffic."""
    @TT.kernel
    def fused(x, cache):
        cache[0:2].copy_(x[:2])                 # rows written into cache
        return (cache[:4] * 2.0).sum(0)         # reads 4 rows of cache

    def step(x, cache):
        return fused(x * 1.0, cache) + 1.0
    tr = TT.lower_step(step, torch.empty(8, 32, device="meta"),
                       torch.empty(100, 32, device="meta"))
    ops = tr.entry.ops
    k = next(op for op in ops if op.kind == "inline")
    assert k.opcode == "fused" and k.lat_cls is None
    # reads: x's 2 rows and cache's 4 rows; writes: 2 rows and the result
    assert k.dma_bytes == (2 * 32 + 4 * 32 + 2 * 32 + 32) * 4
    assert all(op.dma_bytes is None for op in k.region.ops)
    mul = next(op for op in ops if op.opcode == "mul")
    assert k.deps == (mul.name,)
    assert k.param_map == {k.region.ops[0].name: mul.name}
    add = ops[-1]
    assert add.opcode == "add" and add.deps == (k.name,)
    for name in TM.registered_names():        # both backends walk it
        for b in ("tp_bound", "mca_sched"):
            rep = TB.get_backend(b).run(tr, name, warn=False)
            assert rep.unknown_ops == 0 and rep.bytes_hbm > 0


def test_isa_units_follow_the_jax_tables():
    mm = isa.decompose("mm", [isa.Operand((8, 4096), 2),
                              isa.Operand((4096, 11008), 2)],
                       [isa.Operand((8, 11008), 2)])
    assert mm.uops == [("mxu", 1 * 1 * 86 * 32)]
    assert mm.flops == 2.0 * 8 * 11008 * 4096
    bmm = isa.decompose("bmm", [isa.Operand((64, 1, 32), 4),
                                isa.Operand((64, 32, 300), 4)],
                        [isa.Operand((64, 1, 300), 4)])
    assert bmm.uops == [("mxu", 64 * 1 * 3 * 1)]
    red = isa.decompose("sum", [isa.Operand((4, 3000), 4)],
                        [isa.Operand((4,), 4)])
    assert red.uops == [("vpu", 2 * 12)]
    assert isa.decompose("exp", [], [isa.Operand((2048,), 4)]).uops == \
        [("xlu", 2)]
    assert isa.decompose("div_", [], [], written=5000).uops == [("vdiv", 5)]
    assert isa.decompose("index_put_", [], [], written=10).uops == \
        [("vlsu", 1)]
    odd = isa.decompose("frobnicate", [], [isa.Operand((9,), 4)])
    assert odd.unknown and odd.uops == [("vpu", 1)]


@pytest.mark.parametrize("name", SHARED + ("h100",))
def test_baseline_matches_jax(name):
    for flops, byts in ((1e12, 3e9), (5e9, 8e10), (0.0, 1.0)):
        got = TBL.predict_from_counts(flops, byts, TM.get_machine(name))
        if name == "h100":
            assert got.t_compute == flops / 989e12
            assert got.t_memory == byts / 3.35e12
            continue
        want = JBL.predict_from_counts(flops, byts, JM.get_machine(name))
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.seconds == want.seconds
        assert got.bottleneck() == want.bottleneck()
    for raw in (None, [], [{"flops": 3.0, "bytes accessed": 7.0}]):
        assert TBL.normalize_cost_analysis(raw) == \
            JBL.normalize_cost_analysis(raw)


def test_baseline_counts_a_torch_function():
    """FLOPs from FlopCounterMode, bytes from the ATen trace."""
    a = torch.empty(256, 512, device="meta")
    b = torch.empty(512, 128, device="meta")
    c = TBL.step_counts(torch.mm, a, b)
    assert c == {"flops": 2.0 * 256 * 512 * 128,
                 "bytes accessed": float((256 * 512 + 512 * 128
                                          + 256 * 128) * 4)}
    rep = TBL.predict(c, TM.get_machine("h100"))
    assert rep.bottleneck() == "memory"
