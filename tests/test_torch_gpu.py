"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: they skip on a machine without a CUDA device. This
file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import stores
from repro_torch.kernels.attention import decode as D
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,skv,h,hkv,dh,sq,window,ns", [
    (2, 77, 4, 2, 32, 1, None, 3),      # smoke shapes, ragged, dead splits
    (3, 200, 8, 2, 64, 3, 40, 4),       # Sq=3, window
    (8, 1024, 32, 4, 128, 1, None, None),   # yi-9b heads, default splits
])
def test_decode_kernel_matches_plain(cuda, dtype, b, skv, h, hkv, dh, sq,
                                     window, ns):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, sq, h, dh, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).to(dtype)
    pos = torch.linspace(0, skv - sq, b, device=cuda).round().int()
    bound, split_len, n = D.split_plan(b, hkv, skv, 64, ns, None)
    kw = dict(window=window, split_len=split_len, n_splits=n, bound=bound)
    K.reset_launches()
    got = D.decode_partials(q, k, v, pos, impl="cuda", **kw)
    want = D.decode_partials(q, k, v, pos, impl="ref", **kw)
    assert K.LAUNCHES["flash_decode"] == 1
    torch.testing.assert_close(D.combine_splits(*got),
                               D.combine_splits(*want), rtol=1e-4, atol=1e-4)
    assert torch.equal(got[2] == 0, want[2] == 0)        # dead splits


@pytest.mark.parametrize("kv_len,rounded", [(472, True), (301, True),
                                            (301, False)])
def test_decode_kernel_occupancy_bound(cuda, kv_len, rounded):
    """The serving path's cut: a 2048-row cache read only up to the
    occupancy bound (rounded to 128-row blocks as ops.flash_decode does,
    or ragged inside a block), default splits, yi-9b heads."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, skv, h, hkv, dh = 8, 2048, 32, 4, 128
    q = torch.randn(b, 1, h, dh, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, skv, hkv, dh, generator=g, device=cuda).bfloat16()
    pos = torch.linspace(0, kv_len - 1, b, device=cuda).round().int()
    bound = -(-kv_len // 128) * 128 if rounded else kv_len
    bound, split_len, n = D.split_plan(b, hkv, skv, 128, None, bound)
    kw = dict(window=None, split_len=split_len, n_splits=n, bound=bound)
    got = D.combine_splits(*D.decode_partials(q, k, v, pos, impl="cuda",
                                              **kw))
    want = D.combine_splits(*D.decode_partials(q, k, v, pos, impl="ref",
                                               **kw))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dense = D.ref_decode(q.float(), k.float(), v.float(), pos, kv_len=bound)
    torch.testing.assert_close(got, dense.float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flavor", ["standard", "nt"])
@pytest.mark.parametrize("sq", [1, 3])
def test_kv_writer_matches_plain(cuda, flavor, sq):
    g = torch.Generator(device=cuda).manual_seed(1)
    kc = torch.randn(4, 64, 2, 32, generator=g, device=cuda).bfloat16()
    vc = torch.randn(4, 64, 2, 32, generator=g, device=cuda).bfloat16()
    kn = torch.randn(4, sq, 2, 32, generator=g, device=cuda).bfloat16()
    vn = torch.randn(4, sq, 2, 32, generator=g, device=cuda).bfloat16()
    pos = torch.tensor([0, 17, 63, 70], dtype=torch.int32, device=cuda)
    kr, vr = kc.clone(), vc.clone()
    ptr = kc.data_ptr()
    stores.kv_row_update(kc, vc, kn, vn, pos, flavor=flavor, impl="cuda")
    stores.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor, impl="ref")
    assert kc.data_ptr() == ptr
    assert torch.equal(kc.view(torch.int16), kr.view(torch.int16))
    assert torch.equal(vc.view(torch.int16), vr.view(torch.int16))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.randn(1, 1, 4, 48, device=cuda)            # head_dim 48
    k = torch.randn(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        D.flash_decode(q, k, k, 3, impl="cuda")
    kc = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        stores.kv_row_update(kc[:, :, :, :16], kc[:, :, :, :16],
                             torch.zeros(1, 1, 2, 16, device=cuda),
                             torch.zeros(1, 1, 2, 16, device=cuda), 0,
                             impl="cuda")


def test_engine_on_card_matches_cpu(cuda):
    cfg = dataclasses.replace(get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(3)
    reqs = [Request(str(i), tuple(int(t) for t in
                                  rng.integers(0, cfg.vocab_size, n)), m)
            for i, (n, m) in enumerate([(9, 12), (17, 5), (4, 1), (12, 9)])]
    to = lambda t, d: {k: to(v, d) if isinstance(v, dict) else v.to(d)
                       for k, v in t.items()}
    out = {d: ServeEngine(cfg, to(params, d), max_slots=2, max_len=32,
                          chunk=3, device=d).run(reqs) for d in ("cpu", cuda)}
    for r in reqs:
        assert out["cpu"][r.rid].tolist() == out[cuda][r.rid].tolist()
