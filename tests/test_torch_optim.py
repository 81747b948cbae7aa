"""The port's loss, AdamW and int8 error-feedback compression against the
JAX package, on the same numpy inputs.

Tolerances: fp32 results of the same formulas within rtol 1e-6, and a
tree leaf within 1e-6 of that leaf's largest magnitude (a moment's update
``b1 * m + (1 - b1) * g`` cancels near zero, where the one-ulp difference
of the two packages' global norms, summed in other orders, is a large
relative one); int8 quantized values equal; int8 block scales of the
compression within 1 ulp; every bit equal where the norm's sum is exact
in any order (params there within 1 ulp: see that test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st
from hypothesis.extra import numpy as hnp

from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.train import losses as JL
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.train import losses as L

torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=0)
ULP = dict(maxulp=1)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _walk(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _tree(rng, shapes, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict) else
            (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _to(tree, lib):
    return {k: _to(v, lib) if isinstance(v, dict) else
            (torch.from_numpy(v.copy()) if lib == "torch"
             else jnp.asarray(v)) for k, v in tree.items()}


def _assert_trees(got, want, **tol):
    gw, ww = list(_walk(got)), list(_walk(want))
    assert [p for p, _ in gw] == [p for p, _ in ww]
    for (path, g), (_, w) in zip(gw, ww):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, path
        if g.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        elif "maxulp" in tol:
            np.testing.assert_array_max_ulp(g, w, **tol)
        else:
            np.testing.assert_allclose(
                g, w, err_msg=str(path), rtol=tol["rtol"],
                atol=tol["rtol"] * float(np.abs(w).max(initial=0)))


SHAPES = {"w": (6, 40), "norm": (40,), "blk": {"a": (3, 5, 16),
                                               "b": (16,)}}


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6) if masked else None
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                            None if mask is None else jnp.asarray(mask))
    got = L.cross_entropy(torch.from_numpy(logits),
                          torch.from_numpy(targets),
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # an all-false mask divides by the clamped 1
    if masked:
        zero = np.zeros((3, 7), bool)
        assert float(L.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(targets),
                                     torch.from_numpy(zero))) == 0.0


def test_cross_entropy_of_bf16_logits_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32)
    targets = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want = JL.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                            jnp.asarray(targets))
    got = L.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                          torch.from_numpy(targets))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_lr_schedule_matches_jax_over_warmup_and_cosine():
    oc = dict(lr=1e-3, warmup_steps=7, total_steps=40, min_lr_frac=0.1)
    got = [float(A.lr_schedule(A.OptConfig(**oc), torch.tensor(s)))
           for s in range(45)]
    want = [float(JA.lr_schedule(JA.OptConfig(**oc), jnp.int32(s)))
            for s in range(45)]
    np.testing.assert_allclose(got, want, **F32)
    assert got[0] < got[6] and got[-1] == pytest.approx(1e-4, rel=1e-6)
    assert A.lr_schedule(A.OptConfig(), torch.tensor(3)).dtype == \
        torch.float32


def test_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    tree = _tree(rng, SHAPES, 3.0)
    np.testing.assert_allclose(_np(A.global_norm(_to(tree, "torch"))),
                               _np(JA.global_norm(_to(tree, "jax"))), **F32)
    assert float(A.global_norm({"a": torch.tensor([3.0]),
                                "b": torch.tensor([4.0])})) == 5.0


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_three_steps_match_jax(moments):
    """Three updates from the same params and gradients: params, moments
    (int8 ``q`` equal) and metrics. The first step's gradients are
    clipped (norm above ``clip_norm``). The global norm's fp32 sum runs
    in another order in each package (one ulp apart here), so the clip
    scale and everything after it may differ by an ulp: the fp32 leaves
    and int8 scales are held within 1e-6 of each leaf's largest
    magnitude (the bit-equal case is the next test)."""
    rng = np.random.default_rng(3)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moments_dtype=moments)
    ocj, oc_ = JA.OptConfig(**kw), A.OptConfig(**kw)
    p0 = _tree(rng, SHAPES)
    pj, pt = _to(p0, "jax"), _to(p0, "torch")
    sj, st_ = JA.init_opt_state(pj, moments), A.init_opt_state(pt, moments)
    _assert_trees(st_, jax.tree.map(np.asarray, sj), **F32)
    for i in range(3):
        g = _tree(rng, SHAPES, 2.0 if i == 0 else 0.05)
        pj, sj, mj = JA.adamw_update(ocj, pj, _to(g, "jax"), sj,
                                     jnp.int32(i))
        pt, st_, mt = A.adamw_update(oc_, pt, _to(g, "torch"), st_,
                                     torch.tensor(i, dtype=torch.int32))
        _assert_trees(pt, pj, **F32)
        _assert_trees(st_, sj, **F32)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(mt[k]), _np(mj[k]), **F32)
        if i == 0:
            assert float(mt["grad_norm"]) > oc_.clip_norm


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_bit_equal_where_the_norm_is_order_free(moments):
    """Gradients of eighths (|k| <= 64) have a sum of squares that fp32
    holds exactly in any order, so both packages clip by the same norm;
    then three updates give the same bits in the fp32 moments, the int8
    ``q`` and ``s`` and the metrics, and params within 1 ulp (ATen's
    vectorized fp32 ``sqrt`` on the CPU is not correctly rounded: 0.75 %
    of random inputs land an ulp off XLA's, which is)."""
    rng = np.random.default_rng(7)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moments_dtype=moments)
    p0 = _tree(rng, SHAPES)
    pj, pt = _to(p0, "jax"), _to(p0, "torch")
    sj, st_ = JA.init_opt_state(pj, moments), A.init_opt_state(pt, moments)
    for i in range(3):
        g = A._map(lambda a: (np.round(a * 8).clip(-64, 64) / 8).astype(
            np.float32), _tree(rng, SHAPES, 2.0 if i else 20.0))
        pj, sj, mj = JA.adamw_update(JA.OptConfig(**kw), pj, _to(g, "jax"),
                                     sj, jnp.int32(i))
        pt, st_, mt = A.adamw_update(A.OptConfig(**kw), pt, _to(g, "torch"),
                                     st_, torch.tensor(i, dtype=torch.int32))
        _assert_trees(st_, sj, rtol=0)
        _assert_trees(pt, pj, maxulp=1)
        for k in ("grad_norm", "lr"):
            assert _np(mt[k]) == _np(mj[k]), k


def test_adamw_bf16_params_match_jax():
    """bf16 params updated in fp32 and cast back: equal bits, or one
    bf16 ulp where the fp32 update sits at a rounding tie's edge."""
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((8, 32)).astype(np.float32)
    g = rng.standard_normal((8, 32)).astype(np.float32) * 0.1
    pj = {"w": jnp.asarray(p0, jnp.bfloat16)}
    pt = {"w": torch.from_numpy(p0).to(torch.bfloat16)}
    oc = dict(lr=0.05, warmup_steps=1, total_steps=4)
    nj, _, _ = JA.adamw_update(JA.OptConfig(**oc), pj,
                               {"w": jnp.asarray(g, jnp.bfloat16)},
                               JA.init_opt_state(pj), jnp.int32(0))
    nt, _, _ = A.adamw_update(A.OptConfig(**oc), pt,
                              {"w": torch.from_numpy(g).to(torch.bfloat16)},
                              A.init_opt_state(pt), torch.tensor(0))
    assert nt["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(nt["w"].float().numpy(),
                               np.asarray(nj["w"], np.float32),
                               rtol=2.0 ** -7, atol=0)


def test_int8_scales_keep_the_leaf_shape_with_last_axis_one():
    st_ = A.init_opt_state({"w": torch.zeros(3, 4, 5),
                            "n": torch.zeros(7)}, "int8")
    assert st_["m"]["w"]["q"].dtype == torch.int8
    assert st_["m"]["w"]["s"].shape == (3, 4, 1)
    assert st_["v"]["n"]["s"].shape == (1,)
    q, s = A._row_quant(torch.tensor([[0.5, -1.5, 2.5, 127.0]]))
    # half to even, as jnp.round: 0.5 -> 0, -1.5 -> -2, 2.5 -> 2
    assert q.tolist() == [[0, -2, 2, 127]] and float(s) == 1.0
    q0, s0 = A._row_quant(torch.zeros(1, 3))
    assert float(s0) == np.float32(1e-12) and q0.abs().sum() == 0


def test_quantize_dequantize_match_jax():
    rng = np.random.default_rng(5)
    for n in (1, 255, 256, 700):
        x = (rng.standard_normal(n) * 10).astype(np.float32).reshape(-1, 1)
        qj, sj, nj = JC.quantize_int8(jnp.asarray(x))
        qt, stt, nt = C.quantize_int8(torch.from_numpy(x))
        assert nt == nj == n
        np.testing.assert_array_equal(_np(qt), _np(qj))
        np.testing.assert_array_max_ulp(_np(stt), _np(sj), **ULP)
        np.testing.assert_allclose(
            _np(C.dequantize_int8(qt, stt, nt, x.shape)),
            _np(JC.dequantize_int8(qj, sj, nj, x.shape)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_tree_two_steps_match_jax(dtype):
    """Two error-feedback steps: decompressed gradients in the
    gradients' dtype, fp32 residuals."""
    rng = np.random.default_rng(6)
    rj = rt = None
    for _ in range(2):
        g = _tree(rng, SHAPES)
        gj = jax.tree.map(lambda a: a.astype(dtype), _to(g, "jax"))
        gt = {k: v for k, v in _to(g, "torch").items()}
        gt = A._map(lambda t: t.to(getattr(torch, dtype)), gt)
        dj, rj = JC.compress_tree(gj, rj)
        dt, rt = C.compress_tree(gt, rt)
        for (path, a), (_, b) in zip(_walk(dt), _walk(dj)):
            assert a.dtype == getattr(torch, dtype), path
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **F32)
        _assert_trees(rt, rj, **F32)
    assert all(r.dtype == torch.float32 for _, r in _walk(rt))
    assert all(r.dtype == torch.float32
               for _, r in _walk(C.init_residual(gt)))


# -- the reference's own properties (tests/test_optim.py,
#    tests/test_perf_features.py), held on the port ---------------------------

def test_adamw_converges_quadratic():
    oc = A.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                     weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = A.init_opt_state(params)
    step = torch.zeros((), dtype=torch.int32)
    for _ in range(150):
        params, opt, _ = A.adamw_update(oc, params, {"w": 2 * params["w"]},
                                        opt, step)
        step = step + 1
    assert float(params["w"].abs().max()) < 0.15


def test_int8_moments_converge_quadratic():
    oc = A.OptConfig(lr=0.1, warmup_steps=1, total_steps=300,
                     weight_decay=0.0, clip_norm=100.0, moments_dtype="int8")
    params = {"w": torch.tensor([[5.0, -3.0, 2.0]])}
    opt = A.init_opt_state(params, "int8")
    step = torch.zeros((), dtype=torch.int32)
    for _ in range(150):
        params, opt, _ = A.adamw_update(oc, params, {"w": 2 * params["w"]},
                                        opt, step)
        step = step + 1
    assert float(params["w"].abs().max()) < 0.3


def test_lr_schedule_shape():
    oc = A.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(A.lr_schedule(oc, torch.tensor(float(s))))
           for s in range(100)]
    assert lrs[0] < lrs[9]
    assert max(lrs) == pytest.approx(1e-3, rel=0.15)
    assert lrs[-1] < lrs[50]
    assert lrs[-1] >= oc.lr * oc.min_lr_frac * 0.9


def test_grad_clipping_applied():
    oc = A.OptConfig(lr=1e-3, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    p2, _, m = A.adamw_update(oc, params, {"w": torch.full((4,), 1e6)},
                              A.init_opt_state(params),
                              torch.zeros((), dtype=torch.int32))
    assert float(m["grad_norm"]) > 1e5
    assert float(p2["w"].abs().max()) < 1.0


@given(hnp.arrays(np.float32, st.integers(1, 2000),
                  elements=st.floats(-1e3, 1e3, width=32)))
def test_quantize_roundtrip_bounded(x):
    q, s, n = C.quantize_int8(torch.from_numpy(x))
    back = C.dequantize_int8(q, s, n, x.shape).numpy()
    scales = np.repeat(s.numpy().ravel(), C.BLOCK)[:x.size]
    assert np.all(np.abs(back - x) <= scales / 2 + 1e-6)


def test_error_feedback_reinjects():
    g = {"w": torch.tensor([0.3, -0.2, 0.7, 0.01])}
    d1, r1 = C.compress_tree(g, None)
    np.testing.assert_allclose(r1["w"].numpy(), (g["w"] - d1["w"]).numpy(),
                               rtol=1e-6, atol=1e-6)
    d2, r2 = C.compress_tree(g, r1)
    total = d1["w"] + d2["w"] + r2["w"]
    np.testing.assert_allclose(total.numpy(), 2 * g["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
