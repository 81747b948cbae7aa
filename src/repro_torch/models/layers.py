"""Core neural layers (counterpart of ``repro/models/layers.py``): RMSNorm,
SwiGLU, dense MLPs, rotary embeddings (RoPE and M-RoPE) and sinusoidal
position embeddings, as pure functions over explicit parameter dicts."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, cast back to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU gate: silu(gate) * up."""
    return F.silu(gate) * up


def dense_ffn(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU (llama-family), GELU or squared-ReLU MLP."""
    if act == "swiglu":
        h = swiglu(x @ p["w_gate"], x @ p["w_up"])
    elif act == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    elif act == "relu2":
        h = F.relu(x @ p["w_up"]).square()
    else:
        raise ValueError(f"unknown ffn act {act}")
    return h @ p["w_down"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of shape (..., S, 1, head_dim//2) for ``positions``.

    Computed once per forward and shared by every layer's q and k.
    """
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


#: M-RoPE's temporal:height:width split of the rotary half dimension
MROPE_SECTIONS = (2, 3, 3)


def mrope_tables(positions_3d: torch.Tensor, head_dim: int, theta: float):
    """M-RoPE (Qwen2-VL) (cos, sin) of shape (B, S, 1, head_dim//2).

    ``positions_3d`` (3, B, S) holds the temporal, height and width
    position ids. The half dimension splits into :data:`MROPE_SECTIONS`
    (in 8ths of it, the last section taking the rest) and each section's
    frequencies turn by its own stream of positions.
    """
    half = head_dim // 2
    total = sum(MROPE_SECTIONS)
    sizes = [half * s // total for s in MROPE_SECTIONS]
    sizes[-1] = half - sum(sizes[:-1])
    freqs = rope_freqs(head_dim, theta, positions_3d.device)
    parts, off = [], 0
    for stream, size in zip(positions_3d, sizes):
        parts.append(stream[..., None].float() * freqs[off:off + size])
        off += size
    angles = torch.cat(parts, dim=-1)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate (first half, second half) pairs of ``x`` by the tables."""
    half = x.shape[-1] // 2
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE, half-split (llama) layout.

    x: (..., S, H, Dh); positions: broadcastable to (..., S) integers.
    """
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def sinusoidal_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """Absolute sinusoidal position embedding ``[cos | sin]``, (..., dim)
    fp32, for integer ``positions`` (...) (musicgen-family backbone)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
