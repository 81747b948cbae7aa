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
LAUNCHES = {"flash_decode": 0, "kv_row_update": 0, "flash_decode_paged": 0,
            "flash_attention": 0,
            # decode launches that also wrote the step's KV rows (counted
            # under flash_decode or flash_decode_paged as well)
            "kv_rows_in_decode": 0,
            # the stream suite (kernels/stream)
            "init_store": 0, "init_partial": 0, "init_nt": 0, "copy_nt": 0,
            "update_nt": 0, "stream_triad_nt": 0, "copy": 0, "add": 0,
            "update": 0, "stream_triad": 0, "schoenauer_triad": 0,
            "sum_reduction": 0, "pi_integration": 0, "jacobi_2d5pt": 0,
            "jacobi_3d7pt": 0, "gauss_seidel_2d5pt": 0}


def use_kernel(impl: str, x) -> bool:
    """Resolve ``impl`` for a tensor to "launch the hand-written kernel?".

    ``x`` is the tensor, or the device the output goes to for an entry
    point that takes no tensor. Unknown impl strings raise, so typos fail
    loudly.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} "
                         "(expected 'ref', 'cuda', or 'auto')")
    if impl == "ref":
        return False
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got one on "
                         f"{dev}")
    return dev.type == "cuda"


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
