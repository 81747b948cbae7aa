"""The port's Fig. 3 harness (``repro_torch.core.rpe``) against the JAX
package's ``repro.core.rpe`` on the CPU.

The record arithmetic (summaries, histograms, the JSON cache) must give
the JAX package's results on the same records; every block's callable
must compute what JAX's does on the same numpy inputs (fp32 within 1e-5
of the output's largest magnitude, bf16 within 1e-2); a block run on
the CPU gives finite times; the full grid is the paper's 416 blocks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rpe as JR
from repro_torch.bench import fig3_rpe
from repro_torch.core import rpe as TR
from repro_torch.core import ubench
from repro_torch.kernels.stream.ref import KERNELS_13

torch.set_num_threads(1)

#: the port's variant names beside the JAX package's
VARIANT_PAIRS = tuple(zip(TR.VARIANTS, JR.VARIANTS))
N = 4096


def _records(mod):
    nan = float("nan")
    rows = [("add", "eager", "S", 1e-3, 9e-4, 5e-4, 1.1e-3),
            ("copy", "loop", "L", 2e-3, 5e-3, 1e-3, 2e-3),      # <= -1
            ("init", "bf16", "M", 1e-4, 1e-4, 2e-4, 9.5e-5),
            ("pi_integration", "kernel", "XL", 3e-3, 2.9e-3, 1e-6, nan),
            ("sum_reduction", "chunked", "S", nan, nan, nan, nan),
            ("jacobi_2d5pt", "reversed", "L", 5e-4, 4.4e-4, 4.5e-4, 4e-4)]
    return [mod.RpeRecord(*r) for r in rows]


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def _plain_dict(d):
    if isinstance(d, dict):
        return {k: _plain_dict(v) for k, v in d.items()}
    return "nan" if isinstance(d, float) and math.isnan(d) else d


def test_summary_and_histograms_equal_jax():
    t, j = _records(TR), _records(JR)
    assert _plain_dict(TR.summarize(t)) == _plain_dict(JR.summarize(j))
    for which in ("port", "mca", "naive", "other"):
        assert TR.histogram(t, which) == JR.histogram(j, which)
    assert "<=-1.0" in TR.histogram(t, "port")
    assert len(TR.nan_records(t)) == 2


def test_cache_round_trip_equals_jax(tmp_path):
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    TR.save_records(_records(TR), tp)
    JR.save_records(_records(JR), jp)
    assert open(tp).read() == open(jp).read()
    for a, b in zip(TR.load_records(jp), JR.load_records(tp)):
        assert all(_same(getattr(a, f), getattr(b, f))
                   for f in a.__dataclass_fields__)
    (tmp_path / "bad.json").write_text("[{\"kernel\": 1")
    assert TR.load_records(str(tmp_path / "bad.json")) == []


def _numpy_inputs(kernel, n):
    rng = np.random.default_rng(7)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in TR.input_shapes(kernel, n))


@pytest.mark.parametrize("kernel", KERNELS_13)
def test_block_outputs_equal_jax(kernel, monkeypatch):
    """Every variant's callable against the JAX package's on the same
    numpy inputs. JAX's ``pallas`` pi calls ``ops.pi_integration`` without
    its n and raises; the port's ``kernel`` pi is held against JAX's plain
    pi instead."""
    xs = _numpy_inputs(kernel, N)
    assert tuple(x.shape for x in xs) == tuple(
        a.shape for a in JR.make_inputs(kernel, N) if hasattr(a, "shape"))
    monkeypatch.setattr(JR, "make_inputs", lambda k, n, dtype=None: tuple(
        jnp.asarray(x) for x in xs))
    for tv, jv in VARIANT_PAIRS:
        jfn, jargs = JR.build_variant(kernel, jv, N)
        if kernel == "pi_integration" and jv == "pallas":
            with pytest.raises(TypeError):
                jfn(*jargs)
            jfn, jargs = JR.build_variant(kernel, "jnp", N)
        want = np.asarray(jfn(*jargs), dtype=np.float32)
        args = tuple(torch.from_numpy(x.copy()) for x in xs)
        fn, a = TR.build_variant(kernel, tv, N, device="cpu", args=args)
        got = fn(*a).float().numpy()
        assert got.shape == want.shape, (kernel, tv)
        tol = 1e-2 if tv == "bf16" and kernel not in (
            "init", "pi_integration") else 1e-5
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, (kernel, tv, err)


def test_block_on_the_cpu_is_finite():
    sizes = {"S": 1 << 12}
    for kernel, variant in (("stream_triad", "loop"), ("init", "kernel"),
                            ("gauss_seidel_2d5pt", "eager"),
                            ("update", "inplace"), ("sum_reduction",
                                                    "chunked")):
        r = TR.run_block(kernel, variant, "S", machine="h100",
                         device="cpu", sizes=sizes)
        assert (r.kernel, r.variant, r.size) == (kernel, variant, "S")
        for f in ("t_meas", "t_port", "t_mca", "t_naive"):
            v = getattr(r, f)
            assert math.isfinite(v) and v > 0, (kernel, variant, f, v)


def test_block_on_the_calibrated_host_is_finite():
    try:
        r = TR.run_block("add", "eager", "S", device="cpu",
                         sizes={"S": 1 << 12})
        assert all(math.isfinite(getattr(r, f)) and getattr(r, f) > 0
                   for f in ("t_meas", "t_port", "t_mca", "t_naive"))
    finally:
        ubench.forget("cpu")


def test_loop_lowers_to_one_loop_region():
    """The ``loop`` variant lowers as JAX's ``fori``: one loop region of
    64 trips, priced at 64 times its body."""
    from repro_torch.core import portmodel, trace
    fn, a = TR.build_variant("stream_triad", "loop", 1 << 12, device="meta")
    tr = trace.lower_step(fn, *a)
    loops = [op for op in tr.entry.ops if op.kind == "loop"]
    assert len(loops) == 1 and loops[0].trips == 64
    rep = portmodel.analyze(tr, "h100")
    assert rep.trips_seen == {loops[0].name: 64}


def test_full_grid_is_416_blocks(tmp_path, monkeypatch):
    assert len(KERNELS_13) * len(TR.VARIANTS) * len(TR.SIZES) == 416
    assert TR.CARD_SIZES == {k: 64 * v for k, v in TR.SIZES.items()}
    calls = []

    def fake(kernel, variant, size, machines, device):
        calls.append((kernel, variant, size))
        return [TR.RpeRecord(kernel, variant, size, 1e-3, 9e-4, 8e-4, 9e-4)
                for _ in machines]
    monkeypatch.setattr(TR, "run_block_machines", fake)
    cache = str(tmp_path / "r.json")
    out = fig3_rpe.run(full=True, cache=cache, device="cpu",
                       machines=("zen4",))
    assert len(out["zen4"]) == len(set(calls)) == 416
    again = fig3_rpe.run(full=True, cache=cache, device="cpu",
                         machines=("zen4",))
    assert len(calls) == 416 and len(again["zen4"]) == 416
    quick = fig3_rpe.run(full=False, cache=str(tmp_path / "q.json"),
                         device="cpu", machines=("zen4", "h100"))
    assert [len(v) for v in quick.values()] == [52, 52]
    assert (tmp_path / "q.h100.json").exists()


def test_suite_turns_a_failed_block_into_nan_records(tmp_path, monkeypatch):
    """``run_suite``: a block that raises gives NaN records on every
    machine and the suite goes on; fig3's cache keeps only complete
    blocks, so the next run retries the failed one alone."""
    calls = []

    def fake(kernel, variant, size, machines, device):
        calls.append((kernel, variant, size))
        if calls.count(("add", "eager", "S")) == 1 and calls[-1] == (
                "add", "eager", "S"):
            raise RuntimeError("no launch")
        return [TR.RpeRecord(kernel, variant, size, 1e-3, 9e-4, 8e-4, 9e-4)
                for _ in machines]
    monkeypatch.setattr(TR, "run_block_machines", fake)
    out = TR.run_suite(("add", "copy"), ("eager",), ("S",),
                       machines=("zen4", "h100"), device="cpu")
    for recs in out.values():
        assert [r.kernel for r in recs] == ["add", "copy"]
        assert [len(TR.nan_records(recs)), recs[1].t_meas] == [1, 1e-3]
    calls.clear()           # the first add/eager/S of the run fails
    cache = str(tmp_path / "r.json")
    first = fig3_rpe.run(cache=cache, device="cpu", machines=("zen4",))
    assert len(TR.nan_records(first["zen4"])) == 1
    n_first = len(calls)
    again = fig3_rpe.run(cache=cache, device="cpu", machines=("zen4",))
    assert calls[n_first:] == [("add", "eager", "S")]
    assert not TR.nan_records(again["zen4"]) and len(again["zen4"]) == 52

