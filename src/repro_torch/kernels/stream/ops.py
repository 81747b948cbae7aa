"""Public wrappers of the stream kernel suite: ``impl`` and store-flavor
routing.

The counterpart of ``repro/kernels/stream/ops.py``, with its names and
arguments. ``impl`` follows ``repro_torch.kernels``: ``"ref"`` runs the
plain version (``ref``), ``"cuda"`` the hand-written kernel
(``kernels``), ``"auto"`` the kernel on a CUDA tensor and the plain
version on a CPU tensor.

The store-heavy wrappers (INIT, COPY, UPDATE, STREAM triad) also take
``flavor`` (``"standard" | "nt" | "auto"``), resolved by
``stores.executed_flavor``: ``"nt"`` runs the streaming-store kernel,
``"standard"`` and ``"auto"`` the plain-store one. On the plain path both
flavors compute the same values, so the flavor is validated and then
has nothing to pick. (JAX runs its NT Pallas kernel in interpret mode
even under ``impl="ref"``; here ``impl="ref"`` always means the plain
version.)

``init``, ``init_partial`` and ``pi_integration`` take no input tensor,
so their output's ``device`` is an argument, ``"cuda"`` by default; on a
machine without a CUDA device that default raises, and the plain
version runs only where the caller asks for ``device="cpu"``.
``init_partial`` has no wrapper in the JAX package's ``ops`` (its
callers reach ``kernels.init_partial`` directly); here it is routed like
``init``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.stores import executed_flavor
from repro_torch.kernels.stream import kernels as K
from repro_torch.kernels.stream import ref as R


def _on_device(impl: str, device) -> bool:
    """``use_kernel`` for an entry point that makes its output on
    ``device``. Making a tensor on a CUDA device without one raises on
    either route anyway; the check exists for the clearer message."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the stream kernels run on one; "
                           "pass device='cpu' for the plain version")
    return use_kernel(impl, dev)


def _nt_route(nt_fn, kernel_fn, ref_fn, impl, flavor, x, *args):
    """The kernel of the executed store flavor, or the plain version."""
    run = executed_flavor(flavor)
    if not use_kernel(impl, x):
        return ref_fn(*args)
    return (nt_fn if run == "nt" else kernel_fn)(*args)


def init(shape, scalar=3.0, dtype=torch.float32, impl="auto",
         flavor="standard", device="cuda"):
    """INIT a[:] = s; ``flavor`` picks the store path (see module doc)."""
    run = executed_flavor(flavor)
    if not _on_device(impl, device):
        return R.init(shape, scalar, dtype, device)
    fn = K.init_nt if run == "nt" else K.init_store
    return fn(shape, scalar, dtype, device=device)


def init_partial(shape, scalar=3.0, dtype=torch.float32, impl="auto",
                 device="cuda"):
    """INIT a[:] = s through the misaligned 7 x 100 block kernel."""
    if not _on_device(impl, device):
        return R.init(shape, scalar, dtype, device)
    return K.init_partial(shape, scalar, dtype, device=device)


def copy(b, impl="auto", flavor="standard"):
    """COPY o = b through the selected store path."""
    return _nt_route(K.copy_nt, K.copy, R.copy, impl, flavor, b, b)


def add(b, c, impl="auto"):
    """ADD o = b + c."""
    return K.add(b, c) if use_kernel(impl, b) else R.add(b, c)


def update(a, s=2.0, impl="auto", flavor="standard"):
    """UPDATE o = s * a through the selected store path."""
    return _nt_route(K.update_nt, K.update, R.update, impl, flavor, a, a, s)


def stream_triad(b, c, s=2.0, impl="auto", flavor="standard"):
    """STREAM triad o = b + s * c through the selected store path."""
    return _nt_route(K.stream_triad_nt, K.stream_triad, R.stream_triad,
                     impl, flavor, b, b, c, s)


def schoenauer_triad(b, c, d, impl="auto"):
    """Schoenauer triad o = b + c * d."""
    if use_kernel(impl, b):
        return K.schoenauer_triad(b, c, d)
    return R.schoenauer_triad(b, c, d)


def sum_reduction(a, impl="auto"):
    """Full sum reduction of a (fp32 on the kernel path)."""
    return K.sum_reduction(a) if use_kernel(impl, a) else R.sum_reduction(a)


def pi_integration(n, impl="auto", device="cuda"):
    """Midpoint quadrature of 4/(1+x^2) with n points."""
    if not _on_device(impl, device):
        return R.pi_integration(n, device=device)
    return K.pi_integration(n, device=device)


def jacobi_2d5pt(u, impl="auto"):
    """2-D 5-point Jacobi sweep over the interior of u."""
    return K.jacobi_2d5pt(u) if use_kernel(impl, u) else R.jacobi_2d5pt(u)


def jacobi_3d7pt(u, impl="auto"):
    """3-D 7-point Jacobi sweep over the interior of u."""
    return K.jacobi_3d7pt(u) if use_kernel(impl, u) else R.jacobi_3d7pt(u)


def gauss_seidel_2d5pt(u, sweeps=1, impl="auto"):
    """Row-wavefront 2-D Gauss-Seidel, `sweeps` iterations."""
    if use_kernel(impl, u):
        return K.gauss_seidel_2d5pt(u, sweeps)
    return R.gauss_seidel_2d5pt(u, sweeps)
