"""The chunked decode as the card's graphs replay it, held on the CPU.

Smoke yi-9b in fp32:

* the chunk's sampling noise drawn ahead of the chunk gives the streams
  of the per-token draws it replaced (an inline copy of that loop),
  token for token, and leaves every generator where they left it;
* the engine's 128-row ``kv_len`` bucket gives the unbucketed dense
  chunk's tokens and cache bit for bit;
* the port's ``make_decode_step`` and ``make_decode_loop_step`` against
  the JAX package's (weights bridged through numpy): logits within the
  model tests' fp32 tolerance, greedy tokens equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import serve as jax_serve
from repro_torch.models import model as M
from repro_torch.serve import decode as SD
from repro_torch.serve.engine import KV_BUCKET, kv_bucket
from repro_torch.train import serve as TS

from _torch_common import bridged_params, cfg_pair, f32

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)      # fp32, as tests/test_torch_model.py


@pytest.fixture(scope="module")
def models():
    cj, ct = cfg_pair("float32")
    pj, pt = bridged_params(cj, ct)
    return cj, ct, pj, pt


def _per_token_sample(logits, temperature, generators):
    """The sampling of the chunk before its noise moved ahead: ``V``
    numbers from each row's generator, drawn at the token."""
    noise = torch.stack([
        torch.rand(logits.shape[-1], generator=g, device=logits.device)
        for g in generators])
    gumbel = -torch.log(-torch.log(noise))
    return (logits.float() / temperature + gumbel).argmax(-1)


def _per_token_chunk(cfg, n, temperature, params, cache, tokens, pos,
                     generators, kv_len):
    """The chunk as it ran with per-token draws: ``(toks, pos, ok)``."""
    ok = torch.ones(tokens.shape[0], dtype=torch.bool)
    out, tok = [], tokens
    for _ in range(n):
        logits, _, cache = M.forward(cfg, params, {"tokens": tok},
                                     mode="decode", cache=cache, pos=pos,
                                     kv_len=kv_len)
        lg = logits[:, 0]
        nxt = _per_token_sample(lg, temperature, generators)
        ok &= torch.isfinite(lg).all(-1)
        nxt = torch.where(ok, nxt, 0)
        out.append(nxt)
        tok = nxt[:, None]
        pos = pos + 1
    return torch.stack(out, dim=1), pos, ok


def _random_state(ct, b, horizon, seed):
    """A slot cache of random rows, last tokens and positions."""
    g = torch.Generator().manual_seed(seed)
    cache = M.init_cache(ct, b, horizon, "cpu")
    for part in cache["scan"].values():
        for leaf in part.values():
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    tokens = torch.randint(0, ct.vocab_size, (b, 1), generator=g)
    return cache, tokens


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


def _same_cache(a, b) -> bool:
    return all(torch.equal(a["scan"][j][n], b["scan"][j][n])
               for j in a["scan"] for n in ("k", "v"))


@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_noise_ahead_gives_the_per_token_streams(models, seed, n):
    """Slots 1 and 2 share one generator, as every free slot of an
    engine shares its idle generator, so the draws' order across slots
    matters too."""
    _, ct, _, pt = models

    def gens():
        idle = torch.Generator().manual_seed(1000 + seed)
        return [torch.Generator().manual_seed(seed), idle, idle,
                torch.Generator().manual_seed(500 + seed)]

    cache, tokens = _random_state(ct, 4, 32, seed)
    pos = torch.tensor([3, 9, 0, 20], dtype=torch.int32)
    kv_len = int(pos.max()) + n
    ref_cache, ref_gens = _clone(cache), gens()
    want, wpos, wok = _per_token_chunk(ct, n, 0.8, pt, ref_cache, tokens,
                                       pos, ref_gens, kv_len)
    got_gens = gens()
    got, _, gpos, gok = SD.make_chunked_decode_step(ct, n, 0.8)(
        pt, cache, tokens, pos, got_gens, kv_len)
    assert torch.equal(got, want)
    assert torch.equal(gpos, wpos) and torch.equal(gok, wok)
    assert _same_cache(cache, ref_cache)
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(got_gens, ref_gens))


def test_draw_noise_fills_its_buffer_in_place():
    gens = [torch.Generator().manual_seed(s) for s in (4, 5)]
    out = torch.zeros(3, 2, 7)
    assert SD.draw_noise(gens, 3, 7, "cpu", out=out) is out
    again = [torch.Generator().manual_seed(s) for s in (4, 5)]
    for t in range(3):
        for i, g in enumerate(again):
            assert torch.equal(out[t, i], torch.rand(7, generator=g))


def test_kv_bucket():
    assert KV_BUCKET == 128
    assert [kv_bucket(r, 2048) for r in (1, 128, 129, 1000, 2047, 2048,
                                         2100)] == \
        [128, 128, 256, 1024, 2048, 2048, 2048]
    assert kv_bucket(5, 40) == 40 and kv_bucket(200, 300) == 256
    assert len({kv_bucket(r, 2048) for r in range(1, 2049)}) == 16


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("pos", [(100, 30, 7), (120, 126, 2), (250, 3, 129)])
def test_kv_bucket_keeps_the_dense_streams(models, pos, temperature):
    """A 300-row dense cache, 5-token chunks: the chunk at the bucketed
    bound gives the tokens and the cache of the chunk at max(pos) + 5,
    bit for bit (the dense router rounds both to its 128-row blocks)."""
    _, ct, _, pt = models
    n = 5
    cache, tokens = _random_state(ct, 3, 300, sum(pos))
    p = torch.tensor(pos, dtype=torch.int32)
    step = SD.make_chunked_decode_step(ct, n, temperature)
    outs = []
    for kv_len in (int(p.max()) + n, kv_bucket(int(p.max()) + n, 300)):
        c = _clone(cache)
        gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
        outs.append((step(pt, c, tokens, p, gens, kv_len), c))
    (a, ca), (b, cb) = outs
    assert all(torch.equal(x, y) for x, y in zip((a[0], a[2], a[3]),
                                                  (b[0], b[2], b[3])))
    assert _same_cache(ca, cb)


def _prefilled(cj, ct, pj, pt, horizon):
    toks = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 6))
    _, cache_j = jax_serve.make_prefill_step(cj, cache_len=horizon)(
        pj, {"tokens": jnp.asarray(toks)})
    _, cache_t = TS.make_prefill_step(ct, cache_len=horizon)(
        pt, {"tokens": torch.tensor(toks)})
    return cache_j, cache_t


def test_decode_step_matches_jax(models):
    cj, ct, pj, pt = models
    cache_j, cache_t = _prefilled(cj, ct, pj, pt, 16)
    first = np.array([[3], [77]])
    pos = np.array([6, 6], np.int32)
    lj, new_j = jax_serve.make_decode_step(cj)(
        pj, cache_j, {"tokens": jnp.asarray(first)}, jnp.asarray(pos))
    lt, new_t = TS.make_decode_step(ct)(
        pt, cache_t, {"tokens": torch.tensor(first)}, torch.tensor(pos))
    assert all(new_t["scan"]["0"][n] is cache_t["scan"]["0"][n]
               for n in ("k", "v"))
    np.testing.assert_allclose(f32(lt), f32(lj), **TOL)
    assert lt.argmax(-1).tolist() == np.asarray(lj).argmax(-1).tolist()
    for n in ("k", "v"):
        np.testing.assert_allclose(f32(new_t["scan"]["0"][n]),
                                   f32(new_j["scan"]["0"][n]), **TOL)
    # a scalar position is every slot's
    lt2, _ = TS.make_decode_step(ct)(pt, _prefilled(cj, ct, pj, pt, 16)[1],
                                     {"tokens": torch.tensor(first)}, 6)
    assert torch.equal(lt2, lt)


@pytest.mark.parametrize("n", [1, 4])
def test_decode_loop_step_matches_jax(models, n):
    cj, ct, pj, pt = models
    cache_j, cache_t = _prefilled(cj, ct, pj, pt, 16)
    first = np.array([[3], [77]])
    pos = np.array([6, 6], np.int32)
    want, new_j = jax_serve.make_decode_loop_step(cj, n)(
        pj, cache_j, {"tokens": jnp.asarray(first)}, jnp.asarray(pos))
    got, new_t = TS.make_decode_loop_step(ct, n)(
        pt, cache_t, {"tokens": torch.tensor(first)}, torch.tensor(pos))
    assert got.shape == (2, n)
    assert got.tolist() == np.asarray(want).tolist()
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(new_t["scan"]["0"][name]),
                                   f32(new_j["scan"]["0"][name]), **TOL)
