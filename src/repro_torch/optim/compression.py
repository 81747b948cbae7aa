"""Int8 error-feedback gradient compression (counterpart of
``repro/optim/compression.py``).

Each gradient leaf, plus the residual carried from the last step, is
quantized blockwise to int8 (blocks of 256 over the flattened leaf,
padded) and dequantized: the decompressed gradient (what the wire would
deliver) goes to the optimizer in the gradient's dtype, and the
quantization error stays behind as the fp32 residual, re-injected next
step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_to(x: torch.Tensor, m: int):
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (m - n % m) % m)), n


def quantize_int8(g: torch.Tensor):
    """Blockwise symmetric int8 quantization: ``(q (nb, 256) int8,
    scales (nb, 1) fp32, n)``; rounds half to even."""
    flat, n = _pad_to(g.float(), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = (blocks.abs().amax(1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q, scale, n: int, shape, dtype=torch.float32):
    out = (q.float() * scale).reshape(-1)[:n]
    return out.reshape(shape).to(dtype)


def compress_tree(grads: dict, residual: dict | None):
    """Error-feedback compression of a gradient tree; returns
    ``(decompressed_grads, new_residual)``."""
    if residual is None:
        residual = init_residual(grads)
    out_g, out_r = {}, {}
    for k, g in grads.items():
        if isinstance(g, dict):
            out_g[k], out_r[k] = compress_tree(g, residual[k])
            continue
        v = g.float() + residual[k]
        q, s, n = quantize_int8(v)
        d = dequantize_int8(q, s, n, g.shape)
        out_g[k], out_r[k] = d.to(g.dtype), v - d
    return out_g, out_r


def init_residual(params: dict) -> dict:
    """fp32 zeros shaped as ``params``."""
    return {k: init_residual(v) if isinstance(v, dict) else
            torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}
