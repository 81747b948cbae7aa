"""Causal (optionally windowed) GQA flash attention forward: the CUDA
kernel's wrapper.

The counterpart of ``repro/kernels/attention/flash.py``. The kernel
(``csrc/flash.cu``) replaces the Pallas TPU kernel
``flash.py:flash_attention`` (body ``_flash_kernel``): one thread block
per (query tile, KV head, batch row) packs the ``G = H / Hkv`` query
heads of its KV head, so each K/V tile is read once for all of them,
keeps the online-softmax state and the accumulator in fp32, and visits
only the key tiles the causal mask and the window leave live. Its plain
version is ``ref.attention``. On the H100 the kernel is bound by
operations. In bf16 both products run on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulators, P kept at fp32 precision as
a bf16 hi/lo pair) over K/V tiles that ``cp.async`` loads into a
two-stage ring; fp32 inputs keep a scalar fp32 body, since the tensor
cores would round them to TF32 (see the source).

Unlike the TPU kernel, any ``S`` works: the kernel masks its ragged
query and key tiles itself, where the TPU wrapper asserts
``S % bq == 0``. The tiles are explicit arguments: ``bq`` query
positions per block (``bq * G`` packed rows, at most 128; by default as
many as fit) and ``bk`` keys per tile (32 or 64; by default 64, and 32
for fp32 at Dh=256, the one case whose 64-key tile does not fit shared
memory). Head dims 32, 64, 128 and 256. The MemTier autotuner that picks
the tiles in the JAX package is not ported.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, build, use_kernel
from repro_torch.kernels.attention import ref as R

#: head dims, key tiles and packed query rows the kernel is built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
KERNEL_KEY_TILES = (32, 64)
KERNEL_MAX_ROWS = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                            _I, _I, _I, _I, ctypes.c_float, _P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def default_bq(h: int, hkv: int) -> int:
    """Query positions per block: as many as fill 128 packed rows."""
    return max(1, KERNEL_MAX_ROWS // (h // hkv))


def default_bk(dtype, dh: int) -> int:
    """Keys per tile: 64, or 32 where the fp32 body's 64-key tile does not
    fit shared memory (Dh=256)."""
    return 32 if dtype == torch.float32 and dh > 128 else 64


def _check_kernel_inputs(q, k, v, bq, bk, window) -> None:
    """Raise on anything the CUDA kernel does not take."""
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.shape != (b, hkv, s, dh):
            raise ValueError(f"{name} shape {tuple(x.shape)} does not match "
                             f"(B, Hkv, S, Dh) = {(b, hkv, s, dh)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    if h % hkv or bq < 1 or bq * (h // hkv) > KERNEL_MAX_ROWS:
        raise ValueError(f"flash_attention kernel packs at most "
                         f"{KERNEL_MAX_ROWS} query rows a block "
                         f"(H={h}, Hkv={hkv}, bq={bq})")
    if bk not in KERNEL_KEY_TILES or bk > default_bk(q.dtype, dh):
        raise ValueError(f"flash_attention kernel takes bk in "
                         f"{KERNEL_KEY_TILES} (at most "
                         f"{default_bk(q.dtype, dh)} for {q.dtype} at "
                         f"head_dim {dh}), got {bk}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(x.stride(i) % vec for i in range(3)) \
                or x.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} rows "
                             "contiguous and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, bq: int | None = None,
                    bk: int | None = None,
                    impl: str = "auto") -> torch.Tensor:
    """Flash attention forward: q (B, H, S, Dh); k, v (B, Hkv, S, Dh) ->
    (B, H, S, Dh) in q's dtype, contiguous.

    Query ``i`` attends keys ``<= i`` (``causal``) and ``> i - window``
    (``window``). ``impl`` routes as in ``repro_torch.kernels``: the
    kernel on a CUDA tensor, :func:`ref.attention` on a CPU tensor. The
    inputs may be strided views (rows of Dh elements contiguous).
    """
    if not use_kernel(impl, q):
        return R.attention(q, k, v, causal=causal, window=window)
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    bq = default_bq(h, hkv) if bq is None else bq
    bk = default_bk(q.dtype, dh) if bk is None else bk
    _check_kernel_inputs(q, k, v, bq, bk, window)
    lib = build.load("flash", _SIGNATURES)
    o = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v)
                                        for i in range(3)))
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, hkv, s, dh, strides, bq, bk,
        int(causal), window or 0, 1.0 / math.sqrt(dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
