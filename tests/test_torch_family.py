"""The port's attention family against the JAX package, at smoke size.

gemma3-4b (5:1 local:global attention, tied head), minitron-8b (squared
ReLU, Hkv=8 at full size), qwen1.5-110b (QKV bias), qwen2-vl-7b (QKV
bias, M-RoPE) and musicgen-large (embedding inputs, sinusoidal
positions, GELU, MHA), plus two variants: gemma3-4b at 8 layers, whose
6-block unit leaves a tail of 2 (``scan_split() == (1, 6, 2)``), and
qwen1.5-110b with q/k RMSNorm switched on (no shipped config uses it).
Weights cross from JAX's ``init_params`` through numpy; the biases and
the q/k norm weights, which JAX initializes to zeros and ones, are
replaced by random values on both sides so that they count.

Prefill and decode logits and caches are held against
``repro.models.model.forward`` at the tolerances of
``test_torch_model.py`` (fp32 within 1e-5, bf16 within 0.06), the
decode through ``impl="auto"`` and ``"ref"``. gemma3's prompts are
longer than its smoke window of 16, so local layers mask. fp32 greedy
streams of the port's dense and paged engines equal JAX's engines'.

The recurrent and MoE families at smoke size: xlstm-125m (mLSTM and
sLSTM), jamba (Mamba, MoE and one attention layer), grok-1 and
qwen3-moe (attention with MoE FFNs). Their prefill and decode logits are
held in fp32 within 1e-4 of the largest logit, with every cache leaf
(recurrent states within 1e-4) and the MoE aux loss, and in bf16 within
5e-2 of the largest logit, logits only: a one-ulp difference of the
activations may flip a near tie of the router, which routes a token to
another expert or drops another one. jamba is held in fp32 only: over
its 8 layers (7 Mamba, 4 MoE) the two frameworks' bf16 roundings part
past 5e-2 of the largest logit, and at decode (capacity 2) a flipped
route moves a row's logits by O(1). Its mixers are held in bf16 one by one
(``test_torch_recurrent.py``, ``test_torch_moe.py``). fp32 greedy
streams of xlstm-125m's and jamba's dense and paged engines equal JAX's,
under the same schedule (a free slot feeds what its last request left,
as in JAX: with MoE its token takes expert capacity too), and a paged
fork decodes as its parent does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, Request, ServeEngine

from _torch_common import f32

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0, atol=0.06)}

#: case -> (arch, config fields replaced on both sides)
CASES = {
    "gemma3-4b": ("gemma3-4b", {}),
    "gemma3-4b-tail": ("gemma3-4b", {"n_layers": 8}),
    "minitron-8b": ("minitron-8b", {}),
    "qwen1.5-110b": ("qwen1.5-110b", {}),
    "qwen1.5-110b-qknorm": ("qwen1.5-110b", {"qk_norm": True}),
    "qwen2-vl-7b": ("qwen2-vl-7b", {}),
    "musicgen-large": ("musicgen-large", {}),
    "xlstm-125m": ("xlstm-125m", {}),
    "jamba-v0.1-52b": ("jamba-v0.1-52b", {}),
    "grok-1-314b": ("grok-1-314b", {}),
    "qwen3-moe-235b-a22b": ("qwen3-moe-235b-a22b", {}),
}
#: the recurrent and MoE families, held by their own forward test
RECURRENT_MOE = ("xlstm-125m", "jamba-v0.1-52b", "grok-1-314b",
                 "qwen3-moe-235b-a22b")
#: leaves JAX initializes to constants: randomized here
_RANDOMIZED = {"bq": 0.5, "bk": 0.5, "bv": 0.5, "q_norm": 0.2,
               "k_norm": 0.2}
B, S, HORIZON = 3, 40, 48            # prompts past the smoke window of 16


def _cfgs(case: str, dtype: str):
    arch, extra = CASES[case]
    kw = dict(extra, param_dtype=dtype)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _randomize(tree, rng, dtype):
    """A numpy copy of a JAX tree with the bias and q/k norm leaves drawn
    at random (norm weights around 1)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _randomize(val, rng, dtype)
        elif key in _RANDOMIZED:
            draw = rng.standard_normal(val.shape) * _RANDOMIZED[key]
            if key.endswith("norm"):
                draw = draw + 1.0
            out[key] = np.asarray(jnp.asarray(draw, dtype))
        else:
            out[key] = np.asarray(val)
    return out


def _params(cj, ct, seed=0):
    """(JAX params, port params): JAX's init with randomized biases and
    norm weights, bridged through numpy."""
    pj = JM.init_params(cj, jax.random.PRNGKey(seed))
    host = _randomize(pj, np.random.default_rng(seed + 100),
                      jnp.dtype(cj.param_dtype))
    return (jax.tree.map(jnp.asarray, host),
            bridge.params_from_jax(host, ct, device="cpu"))


def _inputs(cj, b, s, seed, positions=False):
    """(JAX batch, port batch): token ids, or embeddings for a model
    without a token embedding; for M-RoPE with ``positions``, distinct
    (3, B, S) temporal/height/width ids (a 4-wide image grid)."""
    rng = np.random.default_rng(seed)
    if cj.embed_inputs:
        host = {"tokens": rng.integers(0, cj.vocab_size, (b, s))}
    else:
        host = {"embeds": rng.standard_normal(
            (b, s, cj.d_model)).astype(np.float32)}
    if positions and cj.rope_kind == "mrope":
        t = np.arange(s)
        grid = np.stack([t // 8, (t // 4) % 2 * 3, t % 4 + t // 8])
        host["positions"] = np.broadcast_to(grid[:, None], (3, b, s)) \
            + np.arange(b)[None, :, None]
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.tensor(np.ascontiguousarray(v))
             for k, v in host.items()})


def _check_cache(got: dict, want: dict, tol: dict) -> None:
    pairs = list(zip(M._walk(got), M._walk(jax.tree.map(np.asarray, want))))
    assert pairs and all(pg == pw for (pg, _), (pw, _) in pairs)
    for (path, g), (_, w) in pairs:
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(f32(g), f32(w), err_msg=str(path), **tol)


#: (case, dtype) pairs of the forward test: every case in both dtypes
#: but the 8-layer variant, whose tail is checked in fp32. bf16 results
#: part by a few ulps a layer (XLA fuses elementwise chains and rounds
#: once where PyTorch rounds each op), and over 8 layers one cache
#: element of 9216 reaches 0.07, past the 0.06 the 2-layer models hold.
FORWARD_CASES = [(c, d) for c in sorted(CASES) if c not in RECURRENT_MOE
                 for d in ("float32", "bfloat16")
                 if (c, d) != ("gemma3-4b-tail", "bfloat16")]


@pytest.mark.parametrize("case,dtype", FORWARD_CASES)
def test_forward_matches_jax(case, dtype):
    """Prefill (with distinct 3-D positions for M-RoPE) and one decode
    step at per-slot positions through the bridged JAX cache, both
    impls; the decode updates the cache in place."""
    cj, ct = _cfgs(case, dtype)
    pj, pt = _params(cj, ct)
    if case == "gemma3-4b-tail":
        assert ct.scan_split() == (1, 6, 2)
    bj, bt = _inputs(cj, B, S, 1, positions=True)
    lj, _, cache_j = JM.forward(cj, pj, bj, mode="prefill",
                                cache_len=HORIZON)
    lt, _, cache_t = M.forward(ct, pt, bt, mode="prefill",
                               cache_len=HORIZON)
    assert lt.shape == (B, 1, ct.vocab_size)
    np.testing.assert_allclose(f32(lt), f32(lj), **TOL[dtype])
    _check_cache(cache_t, cache_j, TOL[dtype])

    host = jax.tree.map(np.asarray, cache_j)
    sj, st = _inputs(cj, B, 1, 2)
    pos = np.array([S, 23, HORIZON - 1], np.int32)
    lj, _, new_j = JM.forward(cj, pj, sj, mode="decode", cache=cache_j,
                              pos=jnp.asarray(pos))
    for impl in ("auto", "ref"):
        cache_t = bridge.cache_from_jax(host, ct, device="cpu")
        ptrs = [t.data_ptr() for _, t in M._walk(cache_t)]
        lt, _, new_t = M.forward(ct, pt, st, mode="decode", cache=cache_t,
                                 pos=torch.tensor(pos), impl=impl,
                                 kv_len=HORIZON)
        assert [t.data_ptr() for _, t in M._walk(new_t)] == ptrs
        np.testing.assert_allclose(f32(lt), f32(lj), err_msg=impl,
                                   **TOL[dtype])
        _check_cache(new_t, new_j, TOL[dtype])


#: the recurrent and MoE families' (case, dtype) pairs: jamba in fp32 only
RECURRENT_MOE_CASES = [(c, d) for c in RECURRENT_MOE
                       for d in ("float32", "bfloat16")
                       if (c, d) != ("jamba-v0.1-52b", "bfloat16")]


def _rel(got, want) -> float:
    w = f32(want)
    return float(np.abs(f32(got) - w).max() / np.abs(w).max())


@pytest.mark.parametrize("case,dtype", RECURRENT_MOE_CASES)
def test_recurrent_and_moe_forward_matches_jax(case, dtype):
    """Prefill, then one decode step at per-slot positions from JAX's
    prefill cache pinned to the cache contract (recurrent leaves fp32, as
    the engines hold them), both impls; the decode updates the cache in
    place."""
    cj, ct = _cfgs(case, dtype)
    pj, pt = _params(cj, ct)
    tol = 1e-4 if dtype == "float32" else 5e-2
    bj, bt = _inputs(cj, B, S, 1)
    lj, aj, cache_j = JM.forward(cj, pj, bj, mode="prefill",
                                 cache_len=HORIZON)
    lt, at, cache_t = M.forward(ct, pt, bt, mode="prefill",
                                cache_len=HORIZON)
    assert lt.shape == (B, 1, ct.vocab_size)
    assert _rel(lt, lj) <= tol
    moe = any(blk.endswith(":moe") for blk in ct.layer_plan())
    assert (float(at) > 0) == moe
    if dtype == "float32":
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
        _check_cache(cache_t, cache_j, dict(rtol=1e-4, atol=1e-4))

    host = jax.tree.map(lambda x, s: np.asarray(x.astype(s.dtype)), cache_j,
                        JM.cache_shapes(cj, B, HORIZON))
    sj, st = _inputs(cj, B, 1, 2)
    pos = np.array([S, 23, HORIZON - 1], np.int32)
    lj, aj, new_j = JM.forward(cj, pj, sj, mode="decode",
                               cache=jax.tree.map(jnp.asarray, host),
                               pos=jnp.asarray(pos))
    for impl in ("auto", "ref"):
        cache_t = bridge.cache_from_jax(host, ct, device="cpu")
        ptrs = [t.data_ptr() for _, t in M._walk(cache_t)]
        lt, at, new_t = M.forward(ct, pt, st, mode="decode", cache=cache_t,
                                  pos=torch.tensor(pos), impl=impl,
                                  kv_len=HORIZON)
        assert [t.data_ptr() for _, t in M._walk(new_t)] == ptrs
        assert all(t.dtype == torch.float32 for p, t in M._walk(new_t)
                   if p[-1] not in ("k", "v"))
        assert _rel(lt, lj) <= tol, impl
        if dtype == "float32":
            np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
            _check_cache(new_t, new_j, dict(rtol=1e-4, atol=1e-4))


def test_decode_positions_default_like_jax():
    """M-RoPE and sinusoidal decode steps read ``pos`` (every M-RoPE
    stream alike), not an arange: giving the same positions explicitly
    changes nothing."""
    for case in ("qwen2-vl-7b", "musicgen-large"):
        cj, ct = _cfgs(case, "float32")
        _, pt = _params(cj, ct)
        _, b0 = _inputs(cj, 2, 1, 4)
        pos = torch.tensor([7, 12], dtype=torch.int32)
        given = pos[:, None] if ct.rope_kind != "mrope" \
            else pos[None, :, None].expand(3, 2, 1)
        out = []
        for batch in (b0, dict(b0, positions=given)):
            cache = M.init_cache(ct, 2, 16, device="cpu")
            out.append(M.forward(ct, pt, batch, mode="decode", cache=cache,
                                 pos=pos)[0])
        torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


@pytest.mark.parametrize("dh", [32, 128])
def test_mrope_matches_jax(dh):
    """Sections of 4/6/6 at the smoke Dh=32 and 16/24/24 at Dh=128."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 3000, (3, 2, 5)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.rotate(torch.tensor(x), *L.mrope_tables(torch.tensor(pos), dh,
                                                    1e6))
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


def test_sinusoidal_matches_jax():
    """The frequencies may differ by one fp32 ulp (the two frameworks'
    ``exp``), which a position multiplies: positions up to 1023 keep
    the angles within 1023 * 2^-23 ~ 1.2e-4 of each other."""
    pos = np.array([[0, 1, 17, 511, 1023]], np.int32)
    for dim in (128, 2048):
        want = JL.sinusoidal_embedding(jnp.asarray(pos), dim)
        got = L.sinusoidal_embedding(torch.tensor(pos), dim)
        assert got.dtype == torch.float32 and got.shape == (1, 5, dim)
        np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=1.5e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_size_tables_match_jax(case):
    """Published widths: the parameter and cache tables equal JAX's,
    leaf for leaf, with no allocation."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    arch, extra = CASES[case]
    cj = dataclasses.replace(jax_config(arch), **extra)
    ct = dataclasses.replace(get_config(arch), **extra)
    want = {p: tuple(s.shape) for p, s in M._walk(JM.param_shapes(cj))}
    got = {p: shape for p, (shape, _) in M._walk(M.param_shapes(ct))}
    assert got == want
    want = {p: tuple(s.shape) for p, s in
            M._walk(JM.cache_shapes(cj, 2, 64))}
    assert {p: shape for p, (shape, _) in
            M._walk(M.cache_shapes(ct, 2, 64))} == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == JM.count_params(cj)


# (prompt length, max_new_tokens) on 2 slots and a 48-row horizon:
# prompts past the smoke window, admissions mid-flight, a 1-token budget
SPECS = [(20, 14), (30, 9), (20, 6), (30, 1), (20, 12), (30, 9)]
ENGINE_CASES = ("gemma3-4b", "gemma3-4b-tail", "qwen2-vl-7b", "minitron-8b",
                "xlstm-125m", "jamba-v0.1-52b")


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_streams_match_jax(case, paged):
    """fp32 greedy streams, token for token, of the dense (or paged, page
    4) engine against JAX's, chunk 3."""
    cj, ct = _cfgs(case, "float32")
    pj, pt = _params(cj, ct)
    rng = np.random.default_rng(3)
    reqs = [(str(i), tuple(int(t) for t in rng.integers(0, ct.vocab_size,
                                                        n)), m)
            for i, (n, m) in enumerate(SPECS)]
    kw = dict(max_slots=2, max_len=HORIZON, chunk=3)
    if paged:
        want = JPagedServeEngine(cj, pj, page_size=4, **kw).run(
            [JRequest(*r) for r in reqs])
        eng = PagedServeEngine(ct, pt, page_size=4, device="cpu", **kw)
    else:
        want = JServeEngine(cj, pj, **kw).run([JRequest(*r) for r in reqs])
        eng = ServeEngine(ct, pt, device="cpu", **kw)
    got = eng.run([Request(*r) for r in reqs])
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tolist() == want[rid].tolist(), rid
    if paged:
        eng.check_pool()


@pytest.mark.parametrize("case", ["xlstm-125m", "jamba-v0.1-52b"])
def test_paged_fork_decodes_as_its_parent(case):
    """fp32: a request forked after its first chunk (its recurrent rows
    copied into the clone's slot, its pages shared) emits the parent's
    greedy tokens from there on, in the port and in JAX alike; 2 slots,
    so the two rows' MoE routes fit jamba's decode capacity."""
    cj, ct = _cfgs(case, "float32")
    pj, pt = _params(cj, ct)
    prompt = tuple(int(t) for t in np.random.default_rng(4).integers(
        0, ct.vocab_size, 22))
    kw = dict(max_slots=2, max_len=HORIZON, chunk=3)
    streams = []
    for eng, req in ((PagedServeEngine(ct, pt, page_size=4, device="cpu",
                                       **kw), Request),
                     (JPagedServeEngine(cj, pj, page_size=4, **kw),
                      JRequest)):
        eng.admit(req("p", prompt, 13))
        eng.step()
        eng.fork("p", "c")
        done = {}
        while any(st is not None for st in eng.slots):
            done.update(dict(eng.step()))
        streams.append({r: np.asarray(v).tolist() for r, v in done.items()})
    got, want = streams
    assert got["c"] == got["p"][-len(got["c"]):]
    assert got == want
