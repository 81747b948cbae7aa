"""The port's recurrent mixers (``repro_torch.models.ssm`` and
``repro_torch.models.xlstm``) against the JAX package's, and the
recurrent state through the bridge and the serve engine.

Inputs are made from a seed with numpy and cross as the same bits. In
fp32 the mixers agree with JAX within 1e-5 (summation order), or within
1e-4 where a result sums many products (mLSTM's C and what is read from
it, the chunked scans); the chunkwise forms agree with their sequential
oracles within 2e-3 on outputs and 1e-4 on states, the JAX package's own
bounds (``tests/test_recurrent.py``). In bf16 the Mamba mixer's output is
held within 5e-2 of its largest magnitude: each framework rounds its
bf16 elementwise chains at other points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import bridge
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.decode import make_chunked_decode_step
from repro_torch.serve.slots import insert
from repro_torch.train import serve as serve_lib

from _torch_common import f32

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
STATE = dict(rtol=1e-4, atol=1e-4)


def _pair(a, dtype=jnp.float32):
    """A numpy array as the same bits in JAX and in torch (CPU)."""
    j = jnp.asarray(a, dtype)
    return j, bridge.to_tensor(np.asarray(j), "cpu")


def _tree_pair(tree, dtype=jnp.float32):
    pairs = {k: _pair(v, dtype) for k, v in tree.items()}
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [4, 1])
def test_causal_conv1d_matches_jax(k):
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt) = _pair(rng.standard_normal((2, 9, 6))), \
        _pair(rng.standard_normal((k, 6)))
    for cache in (None, rng.standard_normal((2, k - 1, 6))):
        cj, ct = (None, None) if cache is None else _pair(cache)
        yj, nj = JS.causal_conv1d(xj, wj, cj)
        yt, nt = S.causal_conv1d(xt, wt, ct)
        np.testing.assert_allclose(f32(yt), f32(yj), **F32)
        assert tuple(nt.shape) == nj.shape
        np.testing.assert_allclose(f32(nt), f32(nj), **F32)


def _scan_inputs(b, t, d, n, seed):
    rng = np.random.default_rng(seed)
    a_in = 1 / (1 + np.exp(-rng.standard_normal((b, t, d, n)))) * 0.9 + 0.05
    return (_pair(a_in), _pair(rng.standard_normal((b, t, d, n)) * 0.1),
            _pair(rng.standard_normal((b, t, n))),
            _pair(rng.standard_normal((b, d, n)) * 0.1))


@pytest.mark.parametrize("t,chunk", [(32, 8), (50, 16), (64, 64)])
def test_ssm_scans_match_jax(t, chunk):
    """Both chunked scans against JAX's at chunks that do and do not
    divide T; the fused scan against the plain one on the same decay
    and input, so the padded form (T = 50) keeps the final state exact."""
    (aj, at), (uj, ut), (cj, ct), (hj, ht) = _scan_inputs(2, t, 16, 4, 5)
    yj, h_j = JS._ssm_scan_chunked(aj, uj, cj, hj, chunk)
    yt, h_t = S._ssm_scan_chunked(at, ut, ct, ht, chunk)
    np.testing.assert_allclose(f32(yt), f32(yj), **STATE)
    np.testing.assert_allclose(f32(h_t), f32(h_j), **STATE)

    rng = np.random.default_rng(t)
    dt = _pair(np.log1p(np.exp(rng.standard_normal((2, t, 16)))))
    b_mat = _pair(rng.standard_normal((2, t, 4)))
    xif = _pair(rng.standard_normal((2, t, 16)))
    a = _pair(-np.exp(np.log(np.arange(1, 5, dtype=np.float64)))
              * np.ones((16, 1)))
    yj, h_j = JS._ssm_scan_chunked_fused(dt[0], b_mat[0], cj, xif[0], a[0],
                                         hj, chunk)
    yt, h_t = S._ssm_scan_chunked_fused(dt[1], b_mat[1], ct, xif[1], a[1],
                                        ht, chunk)
    np.testing.assert_allclose(f32(yt), f32(yj), **STATE)
    np.testing.assert_allclose(f32(h_t), f32(h_j), **STATE)
    a_bar = torch.exp(dt[1][..., None] * a[1])
    u = (dt[1] * xif[1])[..., None] * b_mat[1][..., None, :]
    y2, h2 = S._ssm_scan_chunked(a_bar, u, ct, ht, chunk)
    np.testing.assert_allclose(f32(yt), f32(y2), **STATE)
    np.testing.assert_allclose(f32(h_t), f32(h2), **STATE)


def _mamba_params(dtype, seed=6):
    cfg = jax_smoke("jamba-v0.1-52b")
    p = JM.init_params(dataclasses.replace(cfg, param_dtype=dtype),
                       jax.random.PRNGKey(seed))["scan"]["0"]["mixer"]
    host = {k: np.asarray(v[0]) for k, v in p.items()}
    return cfg, {k: jnp.asarray(v) for k, v in host.items()}, \
        {k: bridge.to_tensor(v, "cpu") for k, v in host.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse", [True, False])
def test_mamba_mixer_matches_jax(dtype, fuse):
    """A 37-token prefill (chunks of 16, padded) and its state, then one
    decode step from that state (conv carried in fp32, as the cache
    holds it)."""
    cfg, pj, pt = _mamba_params(dtype)
    jd = jnp.dtype(dtype)
    kw = dict(d_state=cfg.ssm_d_state, conv_dim=cfg.ssm_conv_dim,
              chunk=cfg.ssm_chunk)
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 37, cfg.d_model)), jd)
    yj, sj = JS.mamba_mixer(pj, xj, want_state=True, fuse=fuse, **kw)
    yt, st = S.mamba_mixer(pt, xt, want_state=True, fuse=fuse, **kw)

    def close(got, want, tol):
        w = f32(want)
        if dtype == "float32":
            np.testing.assert_allclose(f32(got), w, **tol)
        else:
            assert np.abs(f32(got) - w).max() <= 5e-2 * np.abs(w).max()

    close(yt, yj, F32)
    assert st["h"].dtype == torch.float32 and st["conv"].dtype == xt.dtype
    close(st["h"], sj["h"], STATE)
    close(st["conv"], sj["conv"], F32)
    state = {"h": sj["h"], "conv": sj["conv"].astype(jnp.float32)}
    x1j, x1t = _pair(rng.standard_normal((2, 1, cfg.d_model)), jd)
    yj, sj = JS.mamba_mixer(pj, x1j, state=state, want_state=True, **kw)
    yt, st = S.mamba_mixer(pt, x1t, state={
        k: bridge.to_tensor(np.asarray(v), "cpu") for k, v in state.items()},
        want_state=True, **kw)
    close(yt, yj, F32)
    close(st["h"], sj["h"], STATE)
    close(st["conv"], sj["conv"], F32)


def test_mamba_decode_matches_prefill_tail():
    """One decode step from a 32-token prefill's state equals the 33rd
    position of a 33-token prefill (the counterpart of
    ``tests/test_recurrent.py::test_mamba_decode_matches_prefill_tail``)."""
    cfg, _, pt = _mamba_params("float32")
    kw = dict(d_state=cfg.ssm_d_state, conv_dim=cfg.ssm_conv_dim, chunk=8)
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (2, 33, cfg.d_model)) * 0.5, dtype=torch.float32)
    full, _ = S.mamba_mixer(pt, x, **kw)
    _, st = S.mamba_mixer(pt, x[:, :32], want_state=True, **kw)
    dec, _ = S.mamba_mixer(pt, x[:, 32:], state=st, want_state=True, **kw)
    np.testing.assert_allclose(f32(dec[:, 0]), f32(full[:, 32]), rtol=5e-3,
                               atol=5e-3)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _mlstm_params(di, h, seed=0):
    rng = np.random.default_rng(seed)
    return _tree_pair({
        "wq": rng.standard_normal((di, di)) * 0.1,
        "wk": rng.standard_normal((di, di)) * 0.1,
        "wv": rng.standard_normal((di, di)) * 0.1,
        "w_if": rng.standard_normal((di, 2, h)) * 0.5,
        "b_if": np.zeros((2, h)), "out": np.eye(di)})


@pytest.mark.parametrize("t,chunk", [(64, 16), (100, 16), (37, 8)])
def test_mlstm_matches_jax_and_its_oracle(t, chunk):
    """Chunkwise against sequential in the port (the JAX package's
    bounds), and both against JAX's; then a decode step from the state."""
    di, h = 64, 4
    pj, pt = _mlstm_params(di, h)
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, t, di)))
    y_seq, st_seq = X.mlstm_sequential(pt, xt, n_heads=h, want_state=True)
    y_chk, st_chk = X.mlstm_chunkwise(pt, xt, n_heads=h, chunk=chunk,
                                      want_state=True)
    np.testing.assert_allclose(f32(y_chk), f32(y_seq), rtol=2e-3,
                               atol=2e-3)
    for a, b in zip(st_chk, st_seq):
        np.testing.assert_allclose(f32(a), f32(b), **STATE)
    yj, stj = JX.mlstm_chunkwise(pj, xj, n_heads=h, chunk=chunk,
                                 want_state=True)
    np.testing.assert_allclose(f32(y_chk), f32(yj), **STATE)
    for a, b in zip(st_chk, stj):
        np.testing.assert_allclose(f32(a), f32(b), **STATE)
    yj, stj = JX.mlstm_sequential(pj, xj, n_heads=h, want_state=True)
    np.testing.assert_allclose(f32(y_seq), f32(yj), **STATE)
    for a, b in zip(st_seq, stj):
        np.testing.assert_allclose(f32(a), f32(b), **STATE)
    # the mixer's decode step (sequential) from the chunkwise state
    x1j, x1t = _pair(rng.standard_normal((2, 1, di)))
    state = dict(zip("cnm", stj))
    yj, sj = JX.mlstm_mixer(pj, x1j, n_heads=h, state=state, want_state=True)
    yt, stt = X.mlstm_mixer(pt, x1t, n_heads=h, state={
        k: bridge.to_tensor(np.asarray(v), "cpu") for k, v in state.items()},
        want_state=True)
    np.testing.assert_allclose(f32(yt), f32(yj), **STATE)
    for k in "cnm":
        np.testing.assert_allclose(f32(stt[k]), f32(sj[k]), **STATE)


@pytest.mark.parametrize("chunk", [8, 33])
def test_slstm_matches_jax(chunk):
    """100 steps in chunks of 8 (4 padded steps) and of 33 (32 padded),
    against JAX's at the same chunk and against the port's one-chunk run
    (padding leaves the state as it was); then a decode step."""
    d, h = 64, 4
    rng = np.random.default_rng(4)
    pj, pt = _tree_pair({
        "w": rng.standard_normal((d, 4, d)) * 0.2, "b": np.zeros((4, d)),
        "r": rng.standard_normal((h, d // h, 4, d // h)) * 0.2,
        "out": np.eye(d)})
    xj, xt = _pair(rng.standard_normal((2, 100, d)))
    yj, sj = JX.slstm_mixer(pj, xj, n_heads=h, chunk=chunk, want_state=True)
    yt, st = X.slstm_mixer(pt, xt, n_heads=h, chunk=chunk, want_state=True)
    y1, s1 = X.slstm_mixer(pt, xt, n_heads=h, chunk=100, want_state=True)
    np.testing.assert_allclose(f32(yt), f32(yj), **F32)
    np.testing.assert_allclose(f32(yt), f32(y1), **F32)
    for k in sj:
        np.testing.assert_allclose(f32(st[k]), f32(sj[k]), **F32)
        np.testing.assert_allclose(f32(st[k]), f32(s1[k]), **F32)
    x1j, x1t = _pair(rng.standard_normal((2, 1, d)))
    yj, sj = JX.slstm_mixer(pj, x1j, n_heads=h, state=sj, want_state=True)
    yt, st = X.slstm_mixer(pt, x1t, n_heads=h, state=st, want_state=True)
    np.testing.assert_allclose(f32(yt), f32(yj), **F32)
    for k in sj:
        np.testing.assert_allclose(f32(st[k]), f32(sj[k]), **F32)


# ---------------------------------------------------------------------------
# The state through the bridge and the engine
# ---------------------------------------------------------------------------

def test_xlstm_cache_crosses_the_bridge():
    """An xlstm-125m smoke cache (no KV leaf) from JAX's prefill: every
    leaf crosses with its shape, fp32 dtype and values, and a dense slot
    cache takes it with ``insert``."""
    cj = jax_smoke("xlstm-125m")
    ct = get_smoke_config("xlstm-125m")
    pj = JM.init_params(cj, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cj.vocab_size, (3, 10))
    _, _, cache_j = JM.forward(cj, pj, {"tokens": jnp.asarray(toks)},
                               mode="prefill")
    host = jax.tree.map(np.asarray, cache_j)
    got = bridge.cache_from_jax(host, ct, device="cpu")
    want = dict(M._walk(host))
    assert len(want) == 7 and set(dict(M._walk(got))) == set(want)
    for path, t in M._walk(got):
        assert t.dtype == torch.float32 and tuple(t.shape) \
            == want[path].shape, path
        np.testing.assert_array_equal(t.numpy(), want[path])
    slots = M.init_cache(ct, 5, 1, device="cpu")
    one = {"scan": {j: {n: v[:, 1:2] for n, v in leaves.items()}
                    for j, leaves in got["scan"].items()}, "tail": {}}
    insert(slots, one, 3)
    for (path, s), (_, g) in zip(M._walk(slots), M._walk(got)):
        np.testing.assert_array_equal(s[:, 3].numpy(), g[:, 1].numpy())
        assert not s[:, :3].any() and not s[:, 4:].any(), path


def test_recurrent_state_stays_fp32_after_a_chunk():
    """jamba's Mamba conv state comes back from a bf16 prefill in bf16;
    the slot cache and every decode step keep every recurrent leaf fp32,
    updated in place (the counterpart of
    ``tests/test_serve_engine.py::test_recurrent_state_dtype_stable_in_chunk``)."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)))
    logits, one = serve_lib.make_prefill_step(cfg, cache_len=16)(
        params, {"tokens": prompts})
    assert one["scan"]["0"]["conv"].dtype == torch.bfloat16
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    want = {p: (t.dtype, t.data_ptr()) for p, t in M._walk(cache)}
    for i in range(2):
        insert(cache, {"scan": {j: {n: v[:, i:i + 1] for n, v in c.items()}
                                for j, c in one["scan"].items()},
                       "tail": {}}, i)
    step = make_chunked_decode_step(cfg, 3)
    toks, cache, pos, ok = step(params, cache, logits[:, -1].argmax(-1)[
        :, None], torch.tensor([8, 8], dtype=torch.int32), kv_len=16)
    assert toks.shape == (2, 3) and bool(ok.all())
    assert {p: (t.dtype, t.data_ptr()) for p, t in M._walk(cache)} == want
    assert {t.dtype for p, t in M._walk(cache) if p[-1] in ("h", "conv")} \
        == {torch.float32}


def test_prompt_len_equal_to_heads_serves_like_jax():
    """xlstm-125m with prompts as long as its heads (the shape that broke
    the old ``grow`` helper, ``tests/test_serve_engine.py::
    test_grow_shape_collision_regression``): fp32 greedy streams of the
    port's engine equal the JAX engine's, chunk 2."""
    cj = dataclasses.replace(jax_smoke("xlstm-125m"), param_dtype="float32")
    ct = dataclasses.replace(get_smoke_config("xlstm-125m"),
                             param_dtype="float32")
    pj = JM.init_params(cj, jax.random.PRNGKey(0))
    pt = bridge.params_from_jax(jax.tree.map(np.asarray, pj), ct,
                                device="cpu")
    s = ct.n_heads
    rng = np.random.default_rng(1)
    reqs = [(str(i), tuple(int(t) for t in rng.integers(0, ct.vocab_size,
                                                        s)), 6)
            for i in range(2)]
    kw = dict(max_slots=2, max_len=s + 6, chunk=2)
    want = JServeEngine(cj, pj, **kw).run([JRequest(*r) for r in reqs])
    got = ServeEngine(ct, pt, device="cpu", **kw).run(
        [Request(*r) for r in reqs])
    for rid in want:
        assert got[rid].tolist() == want[rid].tolist(), rid
