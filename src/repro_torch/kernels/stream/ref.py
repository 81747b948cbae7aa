"""Plain PyTorch versions of the paper's 13 streaming validation kernels
(paper §II: Jacobi stencils, ADD, COPY, Gauss-Seidel, pi, INIT,
Schoenauer triad, sum reduction, STREAM triad, UPDATE).

The counterpart of ``repro/kernels/stream/ref.py``. These are the CUDA
kernels' plain versions (``ops`` runs them on CPU tensors, tests and
``chip_smoke.py`` hold the kernels against them on the card) and the
store-traffic subjects of the write-allocate study (paper Fig. 4).
``jacobi_3d11pt`` and ``jacobi_3d27pt`` have no kernel, as in the JAX
package.
"""

from __future__ import annotations

import torch

from repro_torch.utils.loops import repeat


def init(shape, scalar=3.0, dtype=torch.float32, device="cpu"):
    """a[:] = s — the paper's store-only write-allocate benchmark."""
    return torch.full(tuple(shape), scalar, dtype=dtype, device=device)


def copy(b):
    """COPY: o = b (materialized)."""
    return b.clone()


def add(b, c):
    """ADD: o = b + c."""
    return b + c


def update(a, s=2.0):
    """UPDATE: o = s * a."""
    return a * s


def stream_triad(b, c, s=2.0):
    """STREAM triad: o = b + s * c."""
    return b + s * c


def schoenauer_triad(b, c, d):
    """Schoenauer triad: o = b + c * d."""
    return b + c * d


def sum_reduction(a):
    """Full sum reduction (in ``a``'s dtype, as ``jnp.sum``)."""
    return torch.sum(a)


def pi_terms(n: int, dtype=torch.float32, device="cpu"):
    """The n terms 4/(1+x^2) of :func:`pi_integration`, x = (i + 0.5) / n.

    The index is built in ``dtype`` (float32 by default, as in both JAX
    versions), so ``i`` is inexact above 2^24. Each quotient is the
    correctly rounded one on any device: ``n`` enters as a 0-d tensor on
    ``device``, since PyTorch's CUDA division by a Python number is a
    product with RN(1/n), which differs from RN(i/n) on up to half the
    points. ``4 / d`` is ``4 * RN(1/d)`` on both devices.
    """
    fn = torch.tensor(n, dtype=dtype, device=device)
    i = torch.arange(n, dtype=dtype, device=device)
    x = (i + 0.5) / fn
    return 4.0 / (1.0 + x * x)


def pi_integration(n: int, dtype=torch.float32, device="cpu"):
    """pi by midpoint integration of 4/(1+x^2) on [0,1]: the sum of
    :func:`pi_terms` over n, divided as they are."""
    fn = torch.tensor(n, dtype=dtype, device=device)
    return torch.sum(pi_terms(n, dtype, device)) / fn


def jacobi_2d5pt(u):
    """(H, W) -> interior 5-point average."""
    return 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:])


def jacobi_3d7pt(u):
    """(D, H, W) -> interior 7-point average."""
    c = 1.0 / 6.0
    return c * (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1] +
                u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1] +
                u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:])


def jacobi_3d11pt(u):
    """7pt + second-neighbour along the two minor axes (r=2 star, 11 pts)."""
    c = 1.0 / 10.0
    return c * (u[1:-3, 2:-2, 2:-2] + u[3:-1, 2:-2, 2:-2] +
                u[2:-2, 1:-3, 2:-2] + u[2:-2, 3:-1, 2:-2] +
                u[2:-2, 2:-2, 1:-3] + u[2:-2, 2:-2, 3:-1] +
                u[2:-2, 2:-2, :-4] + u[2:-2, 2:-2, 4:] +
                u[2:-2, :-4, 2:-2] + u[2:-2, 4:, 2:-2])


def jacobi_3d27pt(u):
    """(D, H, W) -> interior 27-point (full 3x3x3 box) average."""
    acc = 0.0
    for dz in (0, 1, 2):
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                acc = acc + u[dz:dz + u.shape[0] - 2,
                              dy:dy + u.shape[1] - 2,
                              dx:dx + u.shape[2] - 2]
    return acc / 27.0


def gauss_seidel_2d5pt(u, sweeps: int = 1):
    """Row-wavefront Gauss-Seidel: row i uses the already-updated row i-1,
    the old row i+1 and the old left and right neighbours of row i.

    Sequential over rows (``utils.loops.repeat``, a Python loop that a
    lowering records as one loop region, in place of JAX's ``lax.scan``):
    the paper's latency-bound, loop-carried-dependency case. The
    boundary rows and columns are copied unchanged; ``u`` is not
    modified.
    """
    u = u.clone()

    def row(i):
        # the right side is evaluated in full before the write, so the
        # left neighbours it reads are row i's old values
        i += 1
        u[i, 1:-1] = 0.25 * (u[i - 1, 1:-1] + u[i + 1, 1:-1] +
                             u[i, :-2] + u[i, 2:])
    for _ in range(sweeps):
        repeat(u.shape[0] - 2, row)
    return u


KERNELS_13 = (
    "init", "copy", "add", "update", "stream_triad", "schoenauer_triad",
    "sum_reduction", "pi_integration", "jacobi_2d5pt", "jacobi_3d7pt",
    "jacobi_3d11pt", "jacobi_3d27pt", "gauss_seidel_2d5pt",
)
