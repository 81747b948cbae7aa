"""KV row writer of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs the CUDA kernel's plain version. It
must write the same bytes as JAX's ``kv_row_update`` (the standard
dynamic-update-slice path and the interpret-mode Pallas ``nt`` kernel),
clamp an overshooting start into ``[0, S - Sq]`` exactly as JAX does,
keep the cache's storage, and leave every other row untouched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stores as JS
from repro_torch import kernels as K
from repro_torch.kernels import stores

torch.set_num_threads(1)

B, S, HKV, DH = 3, 16, 2, 8


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or JAX array (bf16 or f32)."""
    a = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32) \
        .numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not isinstance(x, torch.Tensor):
        a = a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)
    return a


def _inputs(sq, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    arrs = [mk(B, S, HKV, DH), mk(B, S, HKV, DH), mk(B, sq, HKV, DH),
            mk(B, sq, HKV, DH)]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.tensor(a, dtype=td) for a in arrs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,pos", [(1, [0, 7, 15]), (3, [2, 9, 13]),
                                    (1, [3, 16, 40]), (3, [-2, 14, 15])])
def test_kv_row_update_matches_jax_standard(dtype, sq, pos):
    """In-range writes, and starts past S - Sq (overshoot) or below 0,
    which JAX's dynamic_update_slice wraps (negative) and clamps."""
    (jk, jv, jkn, jvn), (tk, tv, tkn, tvn) = _inputs(sq, dtype)
    orig_k = tk.clone()
    jpos = jnp.asarray(pos, jnp.int32)
    want_k = JS.kv_row_update(jk, jkn, jpos, flavor="standard")
    want_v = JS.kv_row_update(jv, jvn, jpos, flavor="standard")
    ptrs = (tk.data_ptr(), tv.data_ptr())
    stores.kv_row_update(tk, tv, tkn, tvn, torch.tensor(pos, dtype=torch.int32))
    assert (tk.data_ptr(), tv.data_ptr()) == ptrs
    np.testing.assert_array_equal(_bits(tk), _bits(want_k))
    np.testing.assert_array_equal(_bits(tv), _bits(want_v))
    # rows outside each slot's clamped window are untouched
    for b, p in enumerate(pos):
        p = min(max(p + S if p < 0 else p, 0), S - sq)
        keep = np.r_[0:p, p + sq:S]
        np.testing.assert_array_equal(_bits(tk[b, keep]),
                                      _bits(orig_k[b, keep]))


@pytest.mark.parametrize("sq,pos", [(1, [0, 7, 15]), (3, [2, 9, 13])])
def test_kv_row_update_matches_jax_nt_kernel(sq, pos):
    """The port's nt flavor against JAX's interpret-mode Pallas writer."""
    (jk, jv, jkn, jvn), (tk, tv, tkn, tvn) = _inputs(sq, "bfloat16", seed=1)
    jpos = jnp.asarray(pos, jnp.int32)
    want_k = JS.kv_row_update(jk, jkn, jpos, flavor="nt")
    want_v = JS.kv_row_update(jv, jvn, jpos, flavor="nt")
    stores.kv_row_update(tk, tv, tkn, tvn, torch.tensor(pos, dtype=torch.int32),
                         flavor="nt")
    np.testing.assert_array_equal(_bits(tk), _bits(want_k))
    np.testing.assert_array_equal(_bits(tv), _bits(want_v))


def test_kv_row_update_scalar_pos_and_cast():
    """A scalar pos writes every slot at that row; an fp32 update lands
    cast to the bf16 cache, as JAX casts it."""
    (jk, _, jkn, _), (tk, tv, tkn, tvn) = _inputs(1, "bfloat16", seed=2)
    up = np.random.default_rng(3).standard_normal((B, 1, HKV, DH)).astype(
        np.float32)
    want = JS.kv_row_update(jk, jnp.asarray(up), jnp.int32(5))
    stores.kv_row_update(tk, tv, torch.tensor(up), torch.tensor(up), 5)
    np.testing.assert_array_equal(_bits(tk), _bits(want))


def test_kv_row_update_routing():
    _, (tk, tv, tkn, tvn) = _inputs(1, "float32")
    pos = torch.tensor([1, 2, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown store flavor"):
        stores.kv_row_update(tk, tv, tkn, tvn, pos, flavor="fast")
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        stores.kv_row_update(tk, tv, tkn, tvn, pos, impl="cuda")
    K.reset_launches()
    stores.kv_row_update(tk, tv, tkn, tvn, pos, impl="auto")
    assert K.LAUNCHES["kv_row_update"] == 0     # the plain version ran


@pytest.mark.parametrize("flavor", ["standard", "nt"])
def test_pad_to_horizon_matches_jax(flavor):
    x = np.random.default_rng(4).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    want = JS.pad_to_horizon(jnp.asarray(x, jnp.bfloat16), 10, flavor=flavor)
    xt = torch.tensor(x, dtype=torch.bfloat16)
    got = stores.pad_to_horizon(xt, 10, flavor=flavor)
    assert got.shape == (2, 10, 2, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert stores.pad_to_horizon(xt, 3, flavor=flavor) is xt


def test_resolve_flavor():
    assert stores.resolve_flavor("auto") == "standard"
    assert stores.resolve_flavor(None) == "standard"
    assert stores.resolve_flavor("nt") == "nt"
    with pytest.raises(ValueError, match="unknown store flavor"):
        stores.resolve_flavor("streaming")
    # the JAX package also executes "standard" for "auto" off the TPU
    assert JS.executed_flavor("auto") == "standard"
