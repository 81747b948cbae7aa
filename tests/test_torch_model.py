"""The PyTorch port's model against the JAX package on smoke yi-9b.

Weights cross from JAX's ``init_params`` through numpy (bf16 as a uint16
view). Prefill and decode logits, and the caches they build or update,
are held against ``repro.models.model.forward``: in fp32 within 1e-5
(summation order only); in bf16 within 0.06 absolute on logits of
magnitude ~4, i.e. a few bf16 ulps (2^-6 at 4), because the two
frameworks round bf16 intermediates at different points.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ModelConfig as JModelConfig
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import model as M

from _torch_common import bridged_params, cfg_pair, f32

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0, atol=0.06)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b", "minitron-8b",
                                  "qwen1.5-110b", "qwen2-vl-7b",
                                  "qwen3-moe-235b-a22b", "grok-1-314b",
                                  "musicgen-large", "xlstm-125m",
                                  "jamba-v0.1-52b"])
def test_config_fields_match_jax(arch, smoke):
    want = jax_smoke(arch) if smoke else jax_config(arch)
    got = get_smoke_config(arch) if smoke else get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.layer_plan() == want.layer_plan()
    assert got.scan_split() == want.scan_split()
    assert got.head_dim_eff == want.head_dim_eff


def _prompts(ct, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, ct.vocab_size, (b, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    """Prompt of 20 tokens: q/kv chunks of 16 take the padding path."""
    cj, ct = cfg_pair(dtype)
    pj, pt = bridged_params(cj, ct)
    toks = _prompts(ct, 2, 20)
    lj, _, cache_j = JM.forward(cj, pj, {"tokens": jnp.asarray(toks)},
                                mode="prefill", cache_len=32)
    lt, _, cache_t = M.forward(ct, pt, {"tokens": torch.tensor(toks)},
                               mode="prefill", cache_len=32)
    assert lt.shape == (2, 1, ct.vocab_size)
    np.testing.assert_allclose(f32(lt), f32(lj), **TOL[dtype])
    for n in ("k", "v"):
        got, want = cache_t["scan"]["0"][n], cache_j["scan"]["0"][n]
        assert got.shape == want.shape and got.dtype == M.DTYPES[dtype]
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_decode_matches_jax(dtype, impl):
    """Per-slot positions; the JAX cache crosses the bridge, is updated
    in place, and must equal JAX's updated cache."""
    cj, ct = cfg_pair(dtype)
    pj, pt = bridged_params(cj, ct)
    _, _, cache_j = JM.forward(cj, pj, {"tokens": jnp.asarray(
        _prompts(ct, 3, 12))}, mode="prefill", cache_len=24)
    cache_t = bridge.cache_from_jax(jax.tree.map(np.asarray, cache_j), ct,
                                    device="cpu")
    tok = _prompts(ct, 3, 1, seed=2)
    pos = np.array([12, 7, 20], np.int32)
    lj, _, new_j = JM.forward(cj, pj, {"tokens": jnp.asarray(tok)},
                              mode="decode", cache=cache_j,
                              pos=jnp.asarray(pos))
    ptr = cache_t["scan"]["0"]["k"].data_ptr()
    lt, _, new_t = M.forward(ct, pt, {"tokens": torch.tensor(tok)},
                             mode="decode", cache=cache_t,
                             pos=torch.tensor(pos), impl=impl, kv_len=21)
    assert new_t["scan"]["0"]["k"].data_ptr() == ptr
    np.testing.assert_allclose(f32(lt), f32(lj), **TOL[dtype])
    for n in ("k", "v"):
        np.testing.assert_allclose(f32(new_t["scan"]["0"][n]),
                                   f32(new_j["scan"]["0"][n]), **TOL[dtype])


def test_layers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        f32(L.rms_norm(torch.tensor(x), torch.tensor(w))),
        f32(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5,
        atol=1e-5)
    pos = np.array([[0, 3, 9, 100, 2047]] * 2, np.int32)
    np.testing.assert_allclose(
        f32(L.apply_rope(torch.tensor(x), torch.tensor(pos), 5e6)),
        f32(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)),
        rtol=1e-5, atol=1e-5)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.1 for n, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    xs = x[:, :, 0]
    for act in ("swiglu", "gelu", "relu2"):
        np.testing.assert_allclose(
            f32(L.dense_ffn({n: torch.tensor(a) for n, a in p.items()},
                            torch.tensor(xs), act)),
            f32(JL.dense_ffn({n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(xs), act)),
            rtol=1e-5, atol=1e-5, err_msg=act)


@pytest.mark.parametrize("window", [None, 5])
def test_prefill_attention_matches_jax(window):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 13, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    want = JA.chunked_causal_attention(*map(jnp.asarray, (q, k, v)),
                                       q_chunk=4, kv_chunk=6, window=window)
    got = A.chunked_causal_attention(*map(torch.tensor, (q, k, v)),
                                     q_chunk=4, kv_chunk=6, window=window)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    dense = A.dense_causal_attention(*map(torch.tensor, (q, k, v)),
                                     window=window)
    np.testing.assert_allclose(f32(dense), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,q_chunk,kv_chunk", [(13, 8, 16), (21, 8, 12),
                                                 (16, 4, 8), (9, 16, 32)])
def test_prefill_attention_pads_to_whole_chunks(s, q_chunk, kv_chunk):
    """Prompts that are no multiple of the chunks, among them the shape
    of S = 600 with chunks 512 / 1024 (the kv chunk clamps to S, and
    JAX pads to the multiple of both, lcm(8, 13) = 104 rows here): the
    port pads only to the chunks the queries reach, with JAX's result."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, s, 2, 16)).astype(np.float32)
    for window in (None, 5):
        want = JA.chunked_causal_attention(
            *map(jnp.asarray, (q, k, v)), q_chunk=q_chunk,
            kv_chunk=kv_chunk, window=window)
        got = A.chunked_causal_attention(
            *map(torch.tensor, (q, k, v)), q_chunk=q_chunk,
            kv_chunk=kv_chunk, window=window)
        assert got.shape == (1, s, 4, 16)
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5,
                                   atol=1e-5)


def test_init_params_layout_and_scale():
    cj, ct = cfg_pair("bfloat16")
    p = M.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    # the JAX tree's names and shapes
    want = {path: tuple(s.shape) for path, s in
            M._walk(JM.param_shapes(cj))}
    assert {path: shape for path, (shape, _) in
            M._walk(M.param_shapes(ct))} == want
    assert {path: tuple(t.shape) for path, t in M._walk(p)} == want
    # JAX std rule: 1/sqrt(fan-in), 0.02 for the embedding
    wq = p["scan"]["0"]["mixer"]["wq"].float()
    assert abs(wq.std().item() - 128 ** -0.5) < 0.01
    assert abs(p["tok_embed"].float().std().item() - 0.02) < 0.002
    assert torch.all(p["final_norm"] == 1)
    again = M.init_params(ct, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])


@pytest.mark.parametrize("pattern", [("attn", "mamba"), ("attn:moe",),
                                     ("mlstm",), ("slstm",)])
def test_block_patterns_match_jax(pattern):
    """Mamba, MoE, mLSTM and sLSTM blocks (each pattern cycled over 3
    layers, so a tail follows the scan) against JAX in fp32: a 12-token
    prefill and one decode step at per-slot positions, logits and every
    cache leaf, the MoE aux loss summed over the layers. Logits within
    1e-5 as above; the states within 1e-4 (mLSTM's C sums 12 outer
    products in another order than XLA's einsum)."""
    kw = dict(name="hybrid", family="hybrid", n_layers=3, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=64, n_experts=4,
              experts_per_token=2, d_ff_expert=32, moe_group_size=8,
              ssm_d_state=4, ssm_dt_rank=4, ssm_chunk=8, q_chunk=8,
              kv_chunk=8, block_pattern=pattern, param_dtype="float32")
    cj = JModelConfig(**kw)
    ct = ModelConfig(**kw)
    pj, pt = bridged_params(cj, ct)
    toks = _prompts(ct, 2, 12)
    lj, aj, cache_j = JM.forward(cj, pj, {"tokens": jnp.asarray(toks)},
                                 mode="prefill", cache_len=16)
    lt, at, cache_t = M.forward(ct, pt, {"tokens": torch.tensor(toks)},
                                mode="prefill", cache_len=16)
    np.testing.assert_allclose(f32(lt), f32(lj), **TOL["float32"])
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    assert ("moe" in pattern[0]) == (float(at) > 0)
    host = jax.tree.map(np.asarray, cache_j)
    for (path, g), (_, w) in zip(M._walk(cache_t), M._walk(host)):
        np.testing.assert_allclose(f32(g), f32(w), err_msg=str(path),
                                   rtol=1e-4, atol=1e-4)
    tok = _prompts(ct, 2, 1, seed=2)
    pos = np.array([12, 9], np.int32)
    lj, aj, new_j = JM.forward(cj, pj, {"tokens": jnp.asarray(tok)},
                               mode="decode", cache=cache_j,
                               pos=jnp.asarray(pos))
    cache_t = bridge.cache_from_jax(host, ct, device="cpu")
    ptrs = [t.data_ptr() for _, t in M._walk(cache_t)]
    lt, at, new_t = M.forward(ct, pt, {"tokens": torch.tensor(tok)},
                              mode="decode", cache=cache_t,
                              pos=torch.tensor(pos), kv_len=16)
    assert [t.data_ptr() for _, t in M._walk(new_t)] == ptrs
    np.testing.assert_allclose(f32(lt), f32(lj), **TOL["float32"])
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    for (path, g), (_, w) in zip(M._walk(new_t),
                                 M._walk(jax.tree.map(np.asarray, new_j))):
        np.testing.assert_allclose(f32(g), f32(w), err_msg=str(path),
                                   rtol=1e-4, atol=1e-4)


def test_train_mode_raises():
    """What ``forward`` refuses, now that the training forward is ported:
    an unknown mode and a decode step of S != 1 raise ``ValueError``;
    ``mode="train"`` itself returns ``(logits, aux)`` with logits at every
    position (B, S, V), builds no cache and records autograd (prefill
    does not). The test keeps the name it had while train mode raised."""
    ct = get_smoke_config("yi-9b")
    params = M.init_params(ct, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.zeros((2, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown mode"):
        M.forward(ct, params, {"tokens": tokens}, mode="training")
    with pytest.raises(ValueError, match="one token per slot"):
        M.forward(ct, params, {"tokens": tokens}, mode="decode",
                  cache=M.init_cache(ct, 2, 8, device="cpu"), pos=0)
    params["final_norm"].requires_grad_(True)
    out = M.forward(ct, params, {"tokens": tokens}, mode="train")
    assert len(out) == 2
    logits, aux = out
    assert logits.shape == (2, 5, ct.vocab_size)
    assert logits.requires_grad and aux.shape == ()
    pre, _, cache = M.forward(ct, params, {"tokens": tokens}, mode="prefill")
    assert pre.shape == (2, 1, ct.vocab_size) and not pre.requires_grad
    torch.testing.assert_close(pre[:, 0], logits[:, -1].detach(), rtol=0,
                               atol=0)
    assert cache["scan"]["0"]["k"].shape[2] == 5


def test_port_imports_no_jax_and_no_repro():
    """Every repro_torch module imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
