"""The stream kernel suite of the PyTorch port against the JAX package.

On the CPU ``repro_torch.kernels.stream.ops`` runs the CUDA kernels'
plain versions (``ref``). They are held against JAX's Pallas kernels in
interpret mode and against JAX's ``ops`` over the reference's matrix
(``tests/test_kernels_stream.py`` and the stream cases of
``tests/test_stores.py``), with inputs made by numpy from a seed. fp32
agrees within 1e-5, as the reference holds its kernels. bf16 is held at
the reference's own 2e-2: XLA rounds ``s * c`` to bf16 before the add,
where the port's plain version (PyTorch) rounds the product too but the
CUDA kernel rounds once.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream import kernels as JK
from repro.kernels.stream import ops as JOPS
from repro.kernels.stream import ref as JR
from repro_torch import kernels as KN
from repro_torch.kernels import stores
from repro_torch.kernels.stream import kernels as K
from repro_torch.kernels.stream import ops
from repro_torch.kernels.stream import ref as R

import _pi_model as PM
from _torch_common import f32

torch.set_num_threads(1)

SHAPES_2D = [(256, 512), (512, 1024), (64, 128)]
NT_SHAPES = [(16, 256), (20, 300), (7, 100)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, n, dtype="float32", seed=0):
    """``n`` standard normal arrays, as (JAX arrays, torch tensors) of
    ``dtype`` holding the same values."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jd) for x in xs],
            [torch.tensor(x).to(td) for x in xs])


# (port op, JAX kernel, number of inputs, extra arguments)
ELEMENTWISE = {
    "copy": (ops.copy, JK.copy, 1, ()),
    "add": (ops.add, JK.add, 2, ()),
    "update": (ops.update, JK.update, 1, (1.5,)),
    "stream_triad": (ops.stream_triad, JK.stream_triad, 2, (2.5,)),
    "schoenauer_triad": (ops.schoenauer_triad, JK.schoenauer_triad, 3, ()),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("name", list(ELEMENTWISE))
def test_elementwise_matches_jax_kernel(name, shape, dtype):
    port, jax_kernel, n, extra = ELEMENTWISE[name]
    js, ts = _inputs(shape, n, dtype)
    KN.reset_launches()
    got = port(*ts, *extra)
    assert KN.LAUNCHES[name] == 0               # the plain version ran
    assert got.dtype == ts[0].dtype and tuple(got.shape) == shape
    want = jax_kernel(*js, *extra, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), **_tol(dtype))


# (port op with flavor="nt", JAX NT kernel, number of inputs)
NT_KERNELS = {
    "copy_nt": (ops.copy, JK.copy_nt, 1),
    "update_nt": (ops.update, JK.update_nt, 1),
    "stream_triad_nt": (ops.stream_triad, JK.stream_triad_nt, 2),
}


@pytest.mark.parametrize("shape", NT_SHAPES + SHAPES_2D[2:])
@pytest.mark.parametrize("name", list(NT_KERNELS))
def test_nt_flavor_matches_jax_nt_kernel(name, shape):
    port, jax_kernel, n = NT_KERNELS[name]
    js, ts = _inputs(shape, n, seed=1)
    got = port(*ts, flavor="nt")
    np.testing.assert_allclose(f32(got), f32(jax_kernel(*js, interpret=True)),
                               rtol=1e-6, atol=1e-6)
    # the same values as the standard flavor (in JAX and here)
    assert torch.equal(got, port(*ts))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_init_variants_match_jax(shape, dtype):
    jd, td = DTYPES[dtype]
    full = ops.init(shape, 3.5, td, device="cpu")
    np.testing.assert_array_equal(f32(full),
                                  f32(JK.init_store(shape, 3.5, jd,
                                                    interpret=True)))
    m, n = shape[0] - 3, shape[1] - 28          # ragged: not 7 x 100 blocks
    part = ops.init_partial((m, n), 2.5, td, device="cpu")
    np.testing.assert_array_equal(f32(part),
                                  f32(JK.init_partial((m, n), 2.5, jd,
                                                      interpret=True)))
    nt = ops.init((m, n), 2.5, td, flavor="nt", device="cpu")
    np.testing.assert_array_equal(f32(nt), f32(JK.init_nt((m, n), 2.5, jd,
                                                          interpret=True)))
    assert nt.shape == (m, n) and nt.dtype == td


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_sum_reduction_matches_jax_kernel(shape):
    js, ts = _inputs(shape, 1, seed=2)
    got = ops.sum_reduction(ts[0])
    want = JK.sum_reduction(js[0], interpret=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    np.testing.assert_allclose(float(got), float(JR.sum_reduction(js[0])),
                               rtol=1e-4)


def test_sum_reduction_bf16_matches_fp32_sum():
    """bf16 input: the plain version keeps bf16 (as ``jnp.sum``) and
    lands within one bf16 rounding of the fp32 sum of the same values,
    which is what the kernel returns."""
    js, ts = _inputs((64, 128), 1, "bfloat16", seed=3)
    got = ops.sum_reduction(ts[0])
    assert got.dtype == torch.bfloat16
    exact = float(ts[0].double().sum())
    np.testing.assert_allclose(float(got), exact, rtol=2 ** -8)
    np.testing.assert_allclose(float(got), float(JR.sum_reduction(js[0])),
                               rtol=2e-2)


@pytest.mark.parametrize("n", [65536, 262144])
def test_pi_matches_jax_kernel(n):
    got = ops.pi_integration(n, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got),
                               float(JK.pi_integration(n, interpret=True)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got), np.pi, rtol=1e-4)


def test_pi_index_is_float32_above_2_24():
    """The index is built in float32, as in both JAX versions: above 2^24
    consecutive points share a value, and the port keeps that."""
    n = 2 ** 24 + 8
    i = torch.arange(n, dtype=torch.float32)
    assert float(i[-1]) != n - 1                     # inexact up there
    np.testing.assert_allclose(float(R.pi_integration(n)),
                               float(JR.pi_integration(n)), rtol=1e-6)


def _rn32(fr: Fraction) -> np.float32:
    """A Fraction rounded to float32, to nearest, ties to even."""
    x = np.float32(float(fr))
    cands = (x, np.nextafter(x, np.float32(np.inf)),
             np.nextafter(x, np.float32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - fr),
                                     int(np.array(v).view(np.uint32)) & 1))


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def test_pi_model_fma_is_exact():
    """The model's float32 FMA rounds a * b + c once, as the card's does:
    held against exact rational arithmetic on random and near-cancelling
    operands, and on sums that float64 leaves on a float32 midpoint,
    where only the lost low bits decide the rounding."""
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(3000) * rng.choice([1e-3, 1, 1e3], 3000)) \
        .astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    near = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(3000)
                                           * 1e-6)).astype(np.float32)
    c = np.where(np.arange(3000) % 2 == 0, c, near)
    t = np.float32(1 + 2.0 ** -12)          # t * t = 1 + 2^-11 + 2^-24
    a = np.append(a, [t, t])
    b = np.append(b, [t, t])
    c = np.append(c, np.float32([2.0 ** -60, -2.0 ** -60]))
    got = PM.fma32(a, b, c)
    want = [_rn32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(_bits(got), _bits(want))
    assert got[-2] == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)   # up
    assert got[-1] == np.float32(1 + 2.0 ** -11)                # down


def _hold_terms(n: int, idx: np.ndarray) -> None:
    """The kernel's index and 4 * its term at ``idx`` against the plain
    version's, bit for bit."""
    want_a = idx.astype(np.float32) + np.float32(0.5)
    assert np.array_equal(_bits(PM.kernel_index(n, idx)), _bits(want_a))
    assert np.array_equal(_bits(np.float32(4) * PM.kernel_terms(n, idx)),
                          _bits(PM.plain_terms(n, idx)))


@pytest.mark.parametrize("n", [4095, 262143, 2 ** 24 + 8])
def test_pi_kernel_terms_bit_identical(n):
    """Every point of ``n``: the kernel's arithmetic (the index from an
    exact chunk offset, the quotient as one FMA correction of a * RN(1/n),
    one reciprocal, the 4 applied at the end) gives the plain version's
    term, two IEEE divisions, bit for bit."""
    assert K.pi_quotient_by_reciprocal(n)
    for s in range(0, n, 1 << 22):
        _hold_terms(n, np.arange(s, min(n, s + (1 << 22)), dtype=np.int64))


def test_pi_kernel_terms_bit_identical_at_2_28():
    """n = 2^28, the main path's: a stride coprime to the 4096-point
    block (every offset in a block is hit), and whole blocks at the edges
    of the kernel's index paths (2^23, 2^24) and at the end."""
    n = 2 ** 28
    edges = [np.arange(e - 4096, e + 4096) for e in (2 ** 23, 2 ** 24)]
    idx = np.unique(np.concatenate([np.arange(0, n, 4099), *edges,
                                    np.arange(n - 8192, n)]))
    _hold_terms(n, idx.astype(np.int64))


def test_pi_plain_terms_are_the_reference_terms():
    """The model's plain terms at chosen points are ``ref.pi_integration``'s
    (its arange values are float32(i))."""
    n = 40000
    i = torch.arange(n, dtype=torch.float32)
    x = (i + 0.5) / n
    want = (4.0 / (1.0 + x * x)).numpy()
    assert np.array_equal(_bits(PM.plain_terms(n, np.arange(n))), _bits(want))


def test_pi_plain_terms_are_ieee_quotients():
    """``ref.pi_terms`` at n = 2^24 - 1 (an n whose RN(i * RN(1/n))
    differs from RN(i / n) on 8,388,607 points) equal numpy's float32
    IEEE quotients 4 / (1 + x^2), x = (i + 0.5) / n, on every point; its
    sum over n is numpy's float32 quotient of the sum."""
    n = 2 ** 24 - 1
    x = (np.arange(n, dtype=np.float32) + np.float32(0.5)) / np.float32(n)
    want = np.float32(4) / (np.float32(1) + x * x)
    got = R.pi_terms(n)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    pi = R.pi_integration(n)
    assert _bits(pi.numpy()) == _bits(torch.sum(got).numpy() / np.float32(n))


def test_pi_quotient_route_rule():
    """The reciprocal route is taken where its proof holds (3 * B < 2^24,
    B the odd part of float32(n)) and nowhere else; at the largest odd
    part the proof admits, every point's quotient is still IEEE's."""
    assert all(map(K.pi_quotient_by_reciprocal,
                   (1, 4095, 262143, 2 ** 22, 2 ** 24 + 8, 3 * 2 ** 20 + 7,
                    5592405, 2 ** 28, 10 ** 9)))
    assert not any(map(K.pi_quotient_by_reciprocal,
                       (5592407, 2 ** 24 - 1, 2 ** 23 - 1)))
    n = 5592405                           # 3 * n = 2^24 - 1
    for s in range(0, n, 1 << 22):
        _hold_terms(n, np.arange(s, min(n, s + (1 << 22)), dtype=np.int64))


def test_pi_plan():
    """A warp a 4096-point block at a time, at most one wave of 4 blocks
    an SM; the route by the rule; n out of range raises."""
    assert K.pi_plan(4095, 132) == (1, True)
    assert K.pi_plan(8 * 4096 + 1, 132) == (2, True)
    assert K.pi_plan(2 ** 28, 132) == (528, True)
    assert K.pi_plan(2 ** 24 - 1, 132) == (512, False)
    assert K.pi_plan(2 ** 28, 114) == (456, True)
    for bad in (0, -1, (2 ** 31 - 1) * 4096 + 1):
        with pytest.raises(ValueError, match="pi_integration kernel takes"):
            K.pi_plan(bad, 132)


@pytest.mark.parametrize("n", [1, 4097, 262143, 2 ** 24 + 8])
def test_pi_kernel_model_matches_plain(n):
    """The kernel's whole sum, modelled in its reduction order on an
    H100's 132 SMs, stays within 1e-5 of the plain version at ragged n
    (the last block masked)."""
    got = PM.kernel_sum(n, 132)
    assert got.dtype == np.float32
    np.testing.assert_allclose(float(got), float(R.pi_integration(n)),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(130, 256), (66, 384), (258, 128)])
def test_jacobi_2d_matches_jax_kernel(shape):
    js, ts = _inputs(shape, 1, seed=4)
    got = ops.jacobi_2d5pt(ts[0])
    assert tuple(got.shape) == (shape[0] - 2, shape[1] - 2)
    np.testing.assert_allclose(f32(got),
                               f32(JK.jacobi_2d5pt(js[0], interpret=True)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(18, 32, 128), (10, 16, 256)])
def test_jacobi_3d_matches_jax_kernel(shape):
    js, ts = _inputs(shape, 1, seed=5)
    got = ops.jacobi_3d7pt(ts[0])
    np.testing.assert_allclose(f32(got),
                               f32(JK.jacobi_3d7pt(js[0], interpret=True)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,sweeps", [((20, 128), 1), ((34, 128), 2),
                                          ((9, 13), 3), ((3, 128), 2),
                                          ((3, 13), 3),
                                          ((5, 16500), 1), ((5, 16500), 2)])
def test_gauss_seidel_matches_jax_kernel(shape, sweeps):
    js, ts = _inputs(shape, 1, seed=6)
    u = ts[0].clone()
    got = ops.gauss_seidel_2d5pt(ts[0], sweeps)
    assert torch.equal(ts[0], u)                     # input untouched
    np.testing.assert_allclose(
        f32(got), f32(JK.gauss_seidel_2d5pt(js[0], sweeps, interpret=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,sweeps,aligned,fused,writes,strips", [
    # chip_smoke's main path: both sweeps fused in one TMA pass of
    # 28-column strips (30 less the 16-byte rounding)
    (4098, 4096, 2, True, (2,), ("out",), (147,)),
    (4098, 4096, 1, True, (1,), ("out",), (128,)),
    (4098, 4096, 2, False, (2,), ("out",), (137,)),  # a view: 4-byte route
    (5, 40002, 1, True, (1,), ("out",), (1251,)),    # W % 4 != 0
    (130, 132, 4, True, (4,), ("out",), (6,)),       # 24 columns a strip
    (130, 130, 4, True, (4,), ("out",), (5,)),       # 26 on the 4-byte route
    (130, 130, 3, True, (3,), ("out",), (5,)),
    # no sweep, or no interior point: one pass of 0, a copy
    (130, 131, 0, True, (0,), ("out",), (5,)),
    (2, 64, 3, True, (0,), ("out",), (2,)),
    (64, 2, 3, True, (0,), ("out",), (1,)),
    # even and odd pass counts: the first pass writes where the last
    # lands in the output; only the first reads a view
    (40, 130, 5, True, (3, 2), ("temp", "out"), (5, 5)),
    (40, 132, 8, False, (4, 4), ("temp", "out"), (6, 6)),
    (40, 131, 9, True, (3, 3, 3), ("out", "temp", "out"), (5, 5, 5)),
    (40, 132, 13, False, (4, 3, 3, 3), ("temp", "out", "temp", "out"),
     (6, 5, 5, 5)),
])
def test_gauss_seidel_plan(h, w, sweeps, aligned, fused, writes, strips):
    plan = K.gauss_seidel_plan(h, w, sweeps, aligned)
    assert plan.fused == fused and plan.writes == writes
    assert plan.strips == strips
    assert plan.tma == tuple(w % 4 == 0 and (aligned or i > 0)
                             for i in range(len(fused)))
    assert plan.temp == (h * w if len(fused) > 1 else 0)
    assert sum(fused) == (sweeps if h >= 3 and w >= 3 else 0)
    assert all(f <= K.GS_MAX_FUSED for f in fused)
    # every strip writes its own columns and together they cover the row;
    # a strip writes no more columns than its lanes compute right
    for f, tma, n in zip(fused, plan.tma, strips):
        cols = K.gs_strip_columns(f, tma)
        assert (n - 1) * cols < w <= n * cols
        assert cols <= 34 - 2 * max(f, 1)
        assert not tma or cols % 4 == 0


@pytest.mark.parametrize("n,elt,sms,blocks", [
    (2 ** 28, 4, 132, 528),      # chip_smoke's 1 GiB: one wave, 4 an SM
    (2 ** 28, 2, 132, 528),      # bf16
    (256 * 8 * 4 * 10, 4, 132, 10),
    (256 * 8 * 4 * 10 + 1, 4, 132, 11),
    (1, 4, 132, 1), (7, 2, 132, 1),
    (2 ** 24, 4, 114, 456),
])
def test_sum_plan(n, elt, sms, blocks):
    """Enough blocks for every thread to keep eight 16-byte loads in
    flight, at most one wave; one block counter."""
    assert K.sum_plan(n, elt, sms) == (blocks, 1)
    assert blocks <= K.SUM_BLOCKS_PER_SM * sms


def test_gauss_seidel_reads_old_left_neighbours():
    """Row i's left neighbour is its value before the sweep: a sweep that
    wrote as it went (updated left neighbours) gives other numbers."""
    u = torch.zeros(3, 5)
    u[1, 1] = 4.0
    got = R.gauss_seidel_2d5pt(u)
    # interior row 1: new[j] = (up + down + old[j-1] + old[j+1]) / 4
    assert got[1].tolist() == [0.0, 0.0, 1.0, 0.0, 0.0]


@pytest.mark.parametrize("name", ["jacobi_3d11pt", "jacobi_3d27pt"])
def test_ref_only_stencils_match_jax(name):
    js, ts = _inputs((12, 14, 16), 1, seed=7)
    np.testing.assert_allclose(f32(getattr(R, name)(ts[0])),
                               f32(getattr(JR, name)(js[0])),
                               rtol=1e-5, atol=1e-5)
    ones = torch.ones(12, 12, 12)
    side = 8 if name == "jacobi_3d11pt" else 10
    np.testing.assert_allclose(f32(getattr(R, name)(ones)),
                               np.ones((side,) * 3), rtol=1e-6)


def _suite_call(pkg, name, xs):
    """One call of a KERNELS_13 entry of ``pkg`` (the JAX or the port's
    ``ops``/``ref``) on inputs ``xs``."""
    if name == "init":
        return pkg.init((32, 48), 1.25)
    if name == "pi_integration":
        return pkg.pi_integration(8192)
    if name in ("jacobi_3d7pt", "jacobi_3d11pt", "jacobi_3d27pt"):
        return getattr(pkg, name)(xs[0].reshape(8, 12, 16))
    if name == "gauss_seidel_2d5pt":
        return pkg.gauss_seidel_2d5pt(xs[0], 2)
    n = {"add": 2, "stream_triad": 2, "schoenauer_triad": 3}.get(name, 1)
    return getattr(pkg, name)(*xs[:n])


@pytest.mark.parametrize("name", list(R.KERNELS_13))
def test_suite_matches_jax_ops(name):
    """The slice as a whole: every kernel of the paper's 13-kernel suite,
    through JAX's ``ops`` (its oracle on the CPU, or ``ref`` for the two
    ref-only stencils) and through the port's (plain versions on CPU
    tensors; ``device="cpu"`` for the tensorless ones)."""
    assert R.KERNELS_13 == JR.KERNELS_13
    js, ts = _inputs((32, 48), 3, seed=8)
    jpkg = JOPS if hasattr(JOPS, name) else JR
    want = _suite_call(jpkg, name, js)

    class _Port:                     # the port's entry points, on the CPU
        def __getattr__(self, attr):
            fn = getattr(ops, attr, None) or getattr(R, attr)
            if attr in ("init", "pi_integration"):
                return lambda *a: fn(*a, device="cpu")
            return fn

    got = _suite_call(_Port(), name, ts)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_ops_flavor_routing():
    """As ``tests/test_stores.py::test_ops_flavor_routing``: "nt" gives the
    standard numbers, "auto" executes the standard path."""
    a = torch.ones(16, 256)
    assert torch.equal(ops.copy(a, flavor="nt"), ops.copy(a))
    assert torch.equal(ops.update(a, flavor="nt"), ops.update(a))
    assert torch.equal(ops.stream_triad(a, a, flavor="nt"),
                       ops.stream_triad(a, a))
    assert torch.equal(ops.init((16, 256), flavor="nt", device="cpu"),
                       ops.init((16, 256), device="cpu"))
    assert torch.equal(ops.copy(a, flavor="auto"), a)
    with pytest.raises(ValueError, match="unknown store flavor"):
        ops.copy(a, flavor="streaming")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.add(a, a, impl="pallas")


@pytest.mark.parametrize("flavor,want", [("nt", "nt"),
                                         ("standard", "standard"),
                                         ("auto", "standard")])
def test_executed_flavor(flavor, want):
    from repro.kernels.stores import executed_flavor as jax_executed
    assert stores.executed_flavor(flavor) == want
    assert jax_executed(flavor) == want        # JAX off the TPU agrees


def test_executed_flavor_rejects_unknown():
    for bad in ("fast", "streaming"):
        with pytest.raises(ValueError, match="unknown store flavor"):
            stores.executed_flavor(bad)


@pytest.mark.parametrize("flavor", [None, "nt", "standard", "auto"])
def test_executed_flavor_is_resolve_flavor(flavor):
    """With no H100 machine model the port executes what it resolves."""
    assert stores.executed_flavor(flavor) == stores.resolve_flavor(flavor)


@pytest.mark.parametrize("call", [
    lambda: ops.init((4, 4)),
    lambda: ops.init((4, 4), impl="ref"),
    lambda: ops.init((4, 4), flavor="nt"),
    lambda: ops.init_partial((4, 4)),
    lambda: ops.pi_integration(4096),
])
def test_tensorless_entry_points_need_a_card(call, monkeypatch):
    """Without a card, leaving ``device`` out raises; nothing runs quietly
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("call", [
    lambda x: ops.copy(x, impl="cuda"),
    lambda x: ops.gauss_seidel_2d5pt(x, impl="cuda"),
    lambda x: ops.init((4, 4), impl="cuda", device="cpu"),
    lambda x: ops.pi_integration(4096, impl="cuda", device="cpu"),
])
def test_impl_cuda_refuses_the_cpu(call):
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        call(torch.zeros(4, 4))


@pytest.mark.parametrize("call", [
    lambda x: K.copy(x), lambda x: K.copy_nt(x), lambda x: K.add(x, x),
    lambda x: K.update(x), lambda x: K.update_nt(x),
    lambda x: K.stream_triad(x, x), lambda x: K.stream_triad_nt(x, x),
    lambda x: K.schoenauer_triad(x, x, x), lambda x: K.sum_reduction(x),
    lambda x: K.jacobi_2d5pt(x), lambda x: K.jacobi_3d7pt(x[None]),
    lambda x: K.gauss_seidel_2d5pt(x),
    lambda x: K.init_store((4, 4), device="cpu"),
    lambda x: K.init_partial((4, 4), device="cpu"),
    lambda x: K.init_nt((4, 4), device="cpu"),
    lambda x: K.pi_integration(4096, device="cpu"),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The kernels' wrappers launch or raise: a CPU tensor raises before
    any build is tried (there is no fallback)."""
    KN.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        call(torch.zeros(4, 4))
    assert not any(KN.LAUNCHES.values())


def test_launch_counters_cover_the_suite():
    names = {"init_store", "init_partial", "init_nt", "copy_nt", "update_nt",
             "stream_triad_nt", "copy", "add", "update", "stream_triad",
             "schoenauer_triad", "sum_reduction", "pi_integration",
             "jacobi_2d5pt", "jacobi_3d7pt", "gauss_seidel_2d5pt"}
    assert names <= set(KN.LAUNCHES)
    assert all(callable(getattr(K, n)) for n in names)
