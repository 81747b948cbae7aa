"""The port's analysis modules against the JAX package's, on the CPU: the
naive baseline's counts (``core/baseline.step_counts`` against XLA's
``cost_analysis``), the write-allocate scan of an ATen trace
(``core/wa.py``), the roofline (``core/roofline.py``), the analyze CLI
(``core/analyze.py``), loop regions (``utils/loops.repeat``) and Fig. 4b's
gate (``repro_torch.bench.fig4b_ntstore``).
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import SHAPES as JSHAPES
from repro.core import baseline as JBL
from repro.core import portmodel as JPM
from repro.core import roofline as JRF
from repro.core import rpe as JR
from repro.core import trace as JT
from repro.models import model as JMM
from repro.serve import planner as JPL
from repro_torch.bench import fig4b_ntstore, run as bench_run
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES
from repro_torch.core import analyze as TA
from repro_torch.core import baseline as TBL
from repro_torch.core import portmodel, trace, wa
from repro_torch.core import roofline as TRF
from repro_torch.core import rpe as TR
from repro_torch.core.machine import get_machine
from repro_torch.kernels.stream import ref as R
from repro_torch.models import model as TMM

from _torch_common import trace_from_jax

torch.set_num_threads(1)

N = 4096
#: where the port's FLOPs differ from XLA's at n = 4096, and why
#: (everything else is equal): PyTorch runs ``4.0 / d`` as ``reciprocal``
#: and ``mul``, one op a point more than XLA's divide; XLA's algebraic
#: simplifier folds the ``0.0 +`` that starts the 27-point sum (the port
#: runs it: 2744 interior points); XLA counts the row loop's counter add
#: and compare in its ``while`` (2), which the port's loop has not
FLOP_DIFFERENCES = {"pi_integration": N, "jacobi_3d27pt": 14 ** 3,
                    "gauss_seidel_2d5pt": -2}


@pytest.mark.parametrize("kernel", R.KERNELS_13)
def test_step_counts_flops_equal_xla(kernel):
    jfn, jargs = JR.build_variant(kernel, "jnp", N)
    ca = JBL.normalize_cost_analysis(
        jfn.lower(*jargs).compile().cost_analysis())
    fn, args = TR.build_variant(kernel, "eager", N, device="meta")
    got = TBL.step_counts(fn, *args)
    want = float(ca.get("flops", 0.0) or 0.0)
    assert got["flops"] - want == FLOP_DIFFERENCES.get(kernel, 0), \
        (kernel, got, want)
    assert "transcendentals" not in got and not ca.get("transcendentals")


def test_step_counts_transcendentals_and_reductions():
    x = torch.empty(64, 64, device="meta")
    c = TBL.step_counts(lambda a: torch.exp(a).sum(1).mean(), x)
    # exp: 4096 transcendentals; row sums 64 x 63; the mean 63 + 1
    assert c["transcendentals"] == 4096.0
    assert c["flops"] == 64 * 63 + 64.0
    jc = JBL.normalize_cost_analysis(jax.jit(
        lambda a: jnp.exp(a).sum(1).mean()).lower(
            jnp.ones((64, 64))).compile().cost_analysis())
    assert c["flops"] == jc["flops"]
    assert c["transcendentals"] == jc["transcendentals"]


def _store_step(x, cache):
    y = torch.tanh(x) * 2.0
    cache[0] = y
    return cache


def test_trace_store_scan_orders_the_paper_cpus():
    """The counterpart of ``test_machine_registry``'s module scan on a
    lowered step: Grace <= SPR <= Zen 4, a full-row write without RMW."""
    tr = trace.lower_call(_store_step, (torch.empty(64, 128, device="meta"),
                                        torch.empty(4, 64, 128,
                                                    device="meta")),
                          stores=True)
    t = {n: wa.machine_store_traffic(tr, n)["traffic_bytes"]
         for n in ("neoverse_v2", "golden_cove", "zen4")}
    assert t["neoverse_v2"] <= t["golden_cove"] <= t["zen4"]
    w = wa.machine_store_traffic(tr, "zen4")
    assert w["traffic_bytes"] >= w["stored_bytes"] > 0
    assert w["wa_mode"] == "explicit_only"
    scan = wa.analyze_trace_stores(tr)
    assert scan["rmw_read_bytes"] == 0.0
    assert scan["stored_bytes"] == 3 * 64 * 128 * 4     # tanh, mul, row
    assert wa.machine_store_traffic(tr, "h100")["traffic_bytes"] == \
        scan["stored_bytes"]


def test_stores_are_recorded_only_when_asked():
    """``lower_step`` records no stores (the planner's decode trace runs
    without them); the scan refuses such a trace."""
    args = (torch.empty(64, 128, device="meta"),
            torch.empty(4, 64, 128, device="meta"))
    assert trace.lower_step(_store_step, *args).stores is None
    with pytest.raises(ValueError, match="stores=True"):
        wa.analyze_trace_stores(trace.lower_step(_store_step, *args))
    assert len(trace.lower_call(_store_step, args, stores=True).stores) == 3


def test_trace_store_scan_partial_minor_write_reads_first():
    def step(x, buf):
        buf[:, 3:8] = x
    tr = trace.lower_call(step, (torch.empty(16, 5, device="meta"),
                                 torch.empty(16, 64, device="meta")),
                          stores=True)
    (st,) = tr.stores
    assert (st.kind, st.dims, st.buffer_dims) == ("write", (16, 5),
                                                 (16, 64))
    scan = wa.analyze_trace_stores(tr)
    prof = wa.store_profile((16, 5), "f32", offset_aligned=False,
                            full_overwrite=False)
    assert scan["stored_bytes"] == prof.stored_bytes
    assert scan["rmw_read_bytes"] == prof.rmw_read_bytes > 0


def test_repeat_lowers_a_loop_region():
    """Gauss-Seidel's row loop: one loop region of rows - 2 trips, its
    stores counted that many times, its bytes times its trips; the plain
    loop outside a lowering computes the same rows."""
    u = torch.empty(10, 64, device="meta")
    tr = trace.lower_call(R.gauss_seidel_2d5pt, (u,), stores=True)
    (loop,) = [op for op in tr.entry.ops if op.kind == "loop"]
    assert loop.trips == 8 and loop.region.boundary
    body = sum(op.dma_bytes for op in loop.region.ops
               if op.dma_bytes is not None)
    rep = portmodel.analyze(tr, "h100")
    clone = 10 * 64 * 4 * 2
    assert rep.bytes_hbm == pytest.approx(clone + 8 * body)
    assert [st.count for st in tr.stores if st.kind == "write"] == [8]
    x = torch.randn(10, 64)
    want = x.clone()
    for i in range(1, 9):
        want[i, 1:-1] = 0.25 * (want[i - 1, 1:-1] + want[i + 1, 1:-1] +
                                want[i, :-2] + want[i, 2:])
    assert torch.equal(R.gauss_seidel_2d5pt(x), want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equals_jax(arch):
    cj, ct = jax_smoke_config(arch), get_smoke_config(arch)
    for active in (False, True):
        assert TMM.count_params(ct, active) == JMM.count_params(cj, active)
    assert TMM.count_params(get_config(arch)) > TMM.count_params(ct)


@pytest.fixture(scope="module")
def smoke_reports():
    """The smoke decode step's JAX report on ``tpu_v5e`` and the port's on
    the same trace (walked into the port's dataclasses)."""
    cj = jax_smoke_config("yi-9b")
    hlo = JPL.decode_step_hlo(cj, 2, 64)
    jrep = JPM.analyze(hlo, "tpu_v5e")
    trep = portmodel.analyze(trace_from_jax(JT.lower_text(hlo)), "tpu_v5e")
    return cj, get_smoke_config("yi-9b"), jrep, trep


def _rec():
    return {"arch": "yi-9b", "shape": "decode_32k", "mesh": "1x1",
            "n_devices": 1, "wa_ratio": 1.25,
            "cost": {"flops": 3.0e9, "bytes_accessed": 7.0e8},
            "collectives": {"all-reduce": {"bytes": 4.0e6}}}


def test_roofline_cells_equal_jax_on_v5e(smoke_reports):
    cj, ct, jrep, trep = smoke_reports
    jm, tm = JRF.MACHINES["tpu_v5e"], get_machine("tpu_v5e")
    for jr, tr_ in ((jrep, trep), (None, None)):
        want = JRF.analyze_cell(_rec(), cj, JSHAPES["decode_32k"],
                                machine=jm, report=jr)
        got = TRF.analyze_cell(_rec(), ct, SHAPES["decode_32k"],
                               machine=tm, report=tr_)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TRF.to_markdown([got]) == JRF.to_markdown([want])


def test_roofline_reads_the_cards_own_rates(smoke_reports):
    _, ct, _, _ = smoke_reports
    cell = TRF.analyze_cell(_rec(), ct, SHAPES["decode_32k"],
                            machine=get_machine("h100"))
    assert cell.t_compute == 3.0e9 / 989e12
    assert cell.t_collective == 4.0e6 / 450e9
    v5p = TRF.analyze_cell(_rec(), ct, SHAPES["decode_32k"],
                           machine=get_machine("tpu_v5p"))
    assert v5p.t_compute == 3.0e9 / get_machine("tpu_v5p").chip.bf16_flops


def test_analyze_cli_prints_compare(capsys):
    argv = ["--config", "yi-9b", "--smoke", "--batch", "2", "--max-len",
            "64", "--machine", "all", "--backend", "tp,mca"]
    assert TA.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    tr = TA.step_trace("yi-9b", smoke=True, batch=2, max_len=64)
    reports = portmodel.compare(tr, backends=("tp_bound", "mca_sched"))
    table = TA.format_table(reports, ("tp_bound", "mca_sched"))
    assert "\n".join(out[1:]) == table
    assert len(out) == 3 + 2 * len(reports)


def test_fig4b_quick_passes_its_gate():
    lines = fig4b_ntstore.main(quick=True, device="cpu")
    gate = [ln for ln in lines if ln.startswith("fig4b,gate,")]
    assert gate and "ordering=ok" in gate[0] and "h100=standard" in gate[0]
    assert "fig4b,nt_kernel_footprint,0,stored_over_payload=1.000" in lines
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_run.main(["--only", "fig4b", "--device", "cpu"]) == 0
    assert buf.getvalue().rstrip().splitlines()[-1].endswith(",ok")
