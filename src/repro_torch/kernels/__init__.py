"""Kernel suite plumbing: ``impl`` routing and launch counters.

Every kernel package under ``repro_torch.kernels`` exposes wrappers whose
``impl`` argument selects between the hand-written Hopper kernel and its
plain PyTorch version (the counterpart of ``repro.kernels``' routing):

* ``impl="ref"``  — always the plain PyTorch version. On a CUDA tensor
  this is for tests and for ``chip_smoke.py``'s comparisons only.
* ``impl="cuda"`` — always the hand-written kernel; a tensor that is not
  on a CUDA device raises.
* ``impl="auto"`` — the kernel for a CUDA tensor, the plain version for
  a CPU tensor. There is no fallback: a CUDA tensor that the kernel
  cannot take raises, as does a kernel that fails to build or launch.

``LAUNCHES`` counts kernel launches by kernel name. A wrapper adds one
exactly where it launches its kernel, so a caller can zero the counts,
drive a path, and read back which kernels that path went through.
"""

from __future__ import annotations

import torch

IMPLS = ("ref", "cuda", "auto")

#: kernel launches since the last :func:`reset_launches`, by kernel name
LAUNCHES = {"flash_decode": 0, "kv_row_update": 0}


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Resolve ``impl`` for a tensor to "launch the hand-written kernel?".

    Unknown impl strings raise, so typos fail loudly.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} "
                         "(expected 'ref', 'cuda', or 'auto')")
    if impl == "ref":
        return False
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on "
                         f"{x.device}")
    return x.is_cuda


def pos_vector(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or (B,)) as a contiguous (B,) int32 tensor on
    ``device``; a tensor already in that form is returned as is."""
    p = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    if p.numel() == 1 and b != 1:
        p = p.expand(b)
    if p.shape != (b,):
        raise ValueError(f"pos must be a scalar or ({b},), got "
                         f"{tuple(p.shape)}")
    return p.contiguous()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
