"""Core neural layers (counterpart of ``repro/models/layers.py``): RMSNorm,
SwiGLU, dense MLPs and rotary embeddings, as pure functions over explicit
parameter dicts."""

from __future__ import annotations

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
