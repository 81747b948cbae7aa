"""The stream suite's CUDA kernels: ctypes wrappers, one for each Pallas
TPU kernel of ``repro/kernels/stream/kernels.py``.

Sources: ``csrc/stream.cu`` (the elementwise family with standard and
streaming stores, the misaligned INIT and the two reductions) and
``csrc/stencil.cu`` (Jacobi 2-D and 3-D, Gauss-Seidel); their notes say
what bounds each kernel on the H100 and how it is built. Each wrapper
launches its kernel on PyTorch's current stream, adds one to
``LAUNCHES[<its name>]`` and returns a new tensor. It raises on what its
kernel does not take: a tensor that is not on a CUDA device, another
dtype, mismatched shapes, a non-contiguous tensor, or, for the
elementwise kernels and the sum, which load and store 16 bytes a thread,
one whose data do not start 16-byte aligned (a view at an odd offset;
PyTorch's allocations are aligned). The plain versions are in ``ref``;
``ops`` routes between the two.

Unlike the TPU kernels, any shape works: the standard kernels need no
exact (256, 512) block tiling, and the NT kernels write the ``(m, n)``
output directly where the TPU's ``_nt_call`` pads every operand to whole
(8, 128) tiles and slices the result (on the H100 what makes a store
streaming is the instruction, ``st.global.cs``; padding would cost two
more passes over device memory).

Elementwise kernels and ``sum_reduction`` take float32 and bfloat16 and
compute in fp32, rounding once to the output dtype (``sum_reduction``
returns its fp32 sum, where JAX's ``jnp.sum`` of a bfloat16 array keeps
bfloat16); the stencils and Gauss-Seidel take float32.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_STREAM_SIGNATURES = {
    "stream_elementwise": [_I, _I, _I, _P, _P, _P, _P, _L, _F, _P],
    "stream_init_partial": [_I, _P, _L, _L, _F, _P],
    "stream_sum": [_I, _P, _L, _P, _I, _P, _P, _P],
    "stream_pi": [_L, _I, _P, _I, _P, _P, _P],
}
_STENCIL_SIGNATURES = {
    "stencil_jacobi_2d5pt": [_P, _P, _I, _I, _P],
    "stencil_jacobi_3d7pt": [_P, _P, _I, _I, _I, _P],
    "stencil_gauss_seidel_pass": [_P, _P, _I, _I, _I, _P],
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# operation codes of csrc/stream.cu
_FILL, _COPY, _SCALE, _ADD, _TRIAD, _SCHOENAUER = range(6)

#: points a pi_integration warp takes at a time (the TPU kernel's ``bn``)
PI_BLOCK = 4096
#: resident pi_integration blocks an SM and warps a block (kPiBlocksPerSm,
#: kThreads / 32)
PI_BLOCKS_PER_SM, PI_WARPS = 4, 8
#: sweeps one Gauss-Seidel pass fuses (csrc/stencil.cu kGsMaxFused)
GS_MAX_FUSED = 4
#: resident sum_reduction blocks an SM, threads a block and 16-byte loads
#: a thread keeps in flight (kSumBlocksPerSm, kThreads, kSumLoads)
SUM_BLOCKS_PER_SM, SUM_THREADS, SUM_LOADS = 4, 256, 8
_INT_MAX = 2 ** 31 - 1
#: zeroed device buffers made once: (name, device) -> tensor
_SCRATCH: dict = {}


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the stream kernels run on a CUDA device, got "
                         f"{dev}")
    return dev


def _check_inputs(name: str, xs, dtypes=tuple(_DTYPE_CODES), *,
                  aligned: bool = True) -> None:
    """Raise unless ``xs`` are contiguous CUDA tensors of one shape, one
    device and one of ``dtypes``, their data 16-byte aligned where
    ``aligned`` (the vectorised kernels)."""
    x0 = xs[0]
    _cuda_device(x0.device)
    if x0.dtype not in dtypes:
        raise ValueError(f"{name} kernel takes {dtypes}, got {x0.dtype}")
    for x in xs:
        if x.device != x0.device or x.dtype != x0.dtype \
                or x.shape != x0.shape:
            raise ValueError(f"{name} kernel takes operands of one device, "
                             f"dtype and shape, got {x.device}/{x.dtype}/"
                             f"{tuple(x.shape)} beside {x0.device}/"
                             f"{x0.dtype}/{tuple(x0.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")
        if aligned and x.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes tensors whose data start "
                             "16-byte aligned")


def _elementwise(name: str, op: int, nt: bool, xs, scalar: float = 0.0, *,
                 shape=None, dtype=None, device=None) -> torch.Tensor:
    """Launch the elementwise kernel: o = op(*xs, scalar), o shaped like
    ``xs[0]`` or, for a fill, ``shape``/``dtype`` on ``device``."""
    if xs:
        _check_inputs(name, xs)
        shape, dtype, device = xs[0].shape, xs[0].dtype, xs[0].device
    elif dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes {tuple(_DTYPE_CODES)}, got "
                         f"{dtype}")
    device = _cuda_device(device)
    o = torch.empty(tuple(shape), dtype=dtype, device=device)
    if o.numel() == 0:
        return o
    lib = build.load("stream", _STREAM_SIGNATURES)
    ptrs = [x.data_ptr() for x in xs] + [None] * (3 - len(xs))
    rc = lib.stream_elementwise(op, int(nt), _DTYPE_CODES[dtype], *ptrs,
                                o.data_ptr(), o.numel(), float(scalar),
                                _stream(device))
    build.check(lib, rc, name)
    LAUNCHES[name] += 1
    return o


# --- the elementwise family -----------------------------------------------

def init_store(shape, scalar=3.0, dtype=torch.float32, *, device="cuda"):
    """a[:] = s with plain stores, 16 bytes a thread (the aligned INIT)."""
    return _elementwise("init_store", _FILL, False, (), scalar, shape=shape,
                        dtype=dtype, device=device)


def init_partial(shape, scalar=3.0, dtype=torch.float32, *, device="cuda"):
    """a[:] = s written in 7 x 100 blocks, a warp a block, each row of a
    block with its own stores: rows of 400 bytes (f32) that start in the
    middle of a 32-byte sector every other block (the full write-allocate
    subject)."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"init_partial kernel takes {tuple(_DTYPE_CODES)}, "
                         f"got {dtype}")
    if len(shape) != 2:
        raise ValueError(f"init_partial kernel takes a 2-D shape, got "
                         f"{tuple(shape)}")
    device = _cuda_device(device)
    m, n = shape
    o = torch.empty((m, n), dtype=dtype, device=device)
    if o.numel() == 0:
        return o
    lib = build.load("stream", _STREAM_SIGNATURES)
    rc = lib.stream_init_partial(_DTYPE_CODES[dtype], o.data_ptr(), m, n,
                                 float(scalar), _stream(device))
    build.check(lib, rc, "init_partial")
    LAUNCHES["init_partial"] += 1
    return o


def init_nt(shape, scalar=3.0, dtype=torch.float32, *, device="cuda"):
    """INIT with streaming stores (``st.global.cs``), any shape."""
    return _elementwise("init_nt", _FILL, True, (), scalar, shape=shape,
                        dtype=dtype, device=device)


def copy(x):
    """COPY: o = x, plain stores."""
    return _elementwise("copy", _COPY, False, (x,))


def copy_nt(x):
    """COPY with streaming stores."""
    return _elementwise("copy_nt", _COPY, True, (x,))


def add(a, b):
    """ADD: o = a + b."""
    return _elementwise("add", _ADD, False, (a, b))


def update(a, s=2.0):
    """UPDATE: o = s * a, plain stores."""
    return _elementwise("update", _SCALE, False, (a,), s)


def update_nt(a, s=2.0):
    """UPDATE with streaming stores."""
    return _elementwise("update_nt", _SCALE, True, (a,), s)


def stream_triad(b, c, s=2.0):
    """STREAM triad: o = b + s * c, plain stores."""
    return _elementwise("stream_triad", _TRIAD, False, (b, c), s)


def stream_triad_nt(b, c, s=2.0):
    """STREAM triad with streaming stores."""
    return _elementwise("stream_triad_nt", _TRIAD, True, (b, c), s)


def schoenauer_triad(b, c, d):
    """Schoenauer triad: o = b + c * d (three loads, one store)."""
    return _elementwise("schoenauer_triad", _SCHOENAUER, False, (b, c, d))


# --- reductions -----------------------------------------------------------

def sum_plan(n: int, element_size: int, sms: int) -> tuple:
    """``(blocks, counters)`` of one ``sum_reduction`` launch over ``n``
    elements of ``element_size`` bytes on a card of ``sms`` SMs: enough
    blocks for every thread to keep ``SUM_LOADS`` 16-byte loads in flight,
    at most one wave of ``SUM_BLOCKS_PER_SM`` blocks an SM; one counter."""
    vec = 16 // element_size
    work = n // vec + n % vec
    per_block = SUM_THREADS * SUM_LOADS
    return max(1, min(SUM_BLOCKS_PER_SM * sms, -(-work // per_block))), 1


def _scratch(name: str, device, numel: int, dtype) -> torch.Tensor:
    """A zeroed buffer of ``numel`` elements on ``device``, made at the
    first call for ``name`` and the same tensor at every later one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _SCRATCH.get((name, device))
    if t is None:
        t = _SCRATCH[(name, device)] = torch.zeros(numel, dtype=dtype,
                                                    device=device)
    return t


def sum_counter(device) -> torch.Tensor:
    """The int32 block counter of ``sum_reduction`` on ``device``.

    It is zeroed once, when made; the kernel's last block sets it back to
    0, so calls need no memset between them. One counter serves one
    stream at a time: calls in flight on two streams at once would share
    it.
    """
    return _scratch("sum_counter", device, 1, torch.int32)


def sum_reduction(x, blocks: int | None = None):
    """The fp32 sum of ``x`` in one launch: each block's fp32 partial,
    then the last block to finish (found by a device counter) sums the
    partials in a fixed order and writes the result, so repeats are
    bit-identical. (The JAX package sums its partials outside Pallas; the
    port fuses that step.) Returns a 0-d float32 tensor.

    ``blocks`` fixes the grid (any count from 1; the blocks stride over
    the input), for the card's calibration (``core/ubench.py`` reads one
    block's streaming rate); None takes :func:`sum_plan`'s."""
    _check_inputs("sum_reduction", (x,))
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    if blocks is None:
        blocks, _ = sum_plan(x.numel(), x.element_size(), torch.cuda
                             .get_device_properties(x.device)
                             .multi_processor_count)
    elif blocks < 1:
        raise ValueError(f"sum_reduction takes blocks >= 1, got {blocks}")
    parts = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib = build.load("stream", _STREAM_SIGNATURES)
    rc = lib.stream_sum(_DTYPE_CODES[x.dtype], x.data_ptr(), x.numel(),
                        parts.data_ptr(), blocks,
                        sum_counter(x.device).data_ptr(), out.data_ptr(),
                        _stream(x.device))
    build.check(lib, rc, "sum_reduction")
    LAUNCHES["sum_reduction"] += 1
    return out


def pi_quotient_by_reciprocal(n: int) -> bool:
    """Whether ``pi_integration``'s kernel takes each point's RN(a / fn),
    fn = float32(n), as q0 = RN(a * y), y = RN(1 / fn), corrected once:
    RN(q0 + RN(a - fn * q0) * y), two FMAs. That is correctly rounded
    wherever the odd part B of fn has 3 * B < 2^24 (every n up to 2^22,
    every power of two); other n take IEEE division.

    Why (a > 0 and fn floats, u = 2^-24, q = a / fn in [2^e, 2^(e+1))):
    y = (1 / fn)(1 + d) with |d| <= u, so |q - q0| < 1.5 * 2^(e-23).
    Then r = a - fn * q0 is a float (below 3B units of fn's and q0's
    lowest bits, or below 3 units of a's), so the FMA takes it exactly,
    and q0 + r * y = q + (q - q0) * d lies within E < 1.5 * 2^(e-47) of
    q. A midpoint m = M * 2^(e-24) (M odd, 2^24 <= M < 2^25) is never q
    (a's odd part is below 2^24 < M * B's), so a - fn * m is a nonzero
    multiple of 2^(e-24) * fn / B or of a's lowest bit, and |q - m| is
    at least 2^(e-24) / B > E (where 3 * B < 2^24) or at least that bit
    / fn > E (always). No midpoint lies within E of q: RN(q + E) = RN(q).
    """
    fn = int(struct.unpack("f", struct.pack("f", float(n)))[0])
    return 3 * (fn >> ((fn & -fn).bit_length() - 1)) < 2 ** 24


def pi_plan(n: int, sms: int) -> tuple:
    """``(blocks, reciprocal)`` of one ``pi_integration`` launch over
    ``n`` points on a card of ``sms`` SMs: a warp a ``PI_BLOCK``-point
    block at a time, at most one wave of ``PI_BLOCKS_PER_SM`` blocks an
    SM; ``reciprocal`` is :func:`pi_quotient_by_reciprocal`. Raises
    unless 1 <= n <= (2^31 - 1) * ``PI_BLOCK``."""
    n = int(n)
    if n < 1 or -(-n // PI_BLOCK) > _INT_MAX:
        raise ValueError(f"pi_integration kernel takes 1 <= n <= "
                         f"{_INT_MAX * PI_BLOCK}, got {n}")
    warps = -(-n // PI_BLOCK)
    return (min(PI_BLOCKS_PER_SM * sms, -(-warps // PI_WARPS)),
            pi_quotient_by_reciprocal(n))


def pi_scratch(device) -> tuple:
    """``(counter, parts)`` of ``pi_integration`` on ``device``: its int32
    block counter and a float32 partial for each block of the largest
    grid, made and zeroed once; the kernel's last block sets the counter
    back to 0, so calls need no memset and allocate only their output."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (_scratch("pi_counter", device, 1, torch.int32),
            _scratch("pi_parts", device, PI_BLOCKS_PER_SM * sms,
                     torch.float32))


def pi_integration(n: int, *, device="cuda"):
    """Midpoint-rule quadrature of 4/(1+x^2) on [0,1) with ``n`` points
    in one launch: each warp sums the TPU kernel's ``PI_BLOCK``-point
    blocks (the last one masked, so any ``n`` works where the TPU wrapper
    asserts ``n % 4096 == 0``), and the last block to finish sums the
    block partials in a fixed order and divides by ``n`` (repeats are
    bit-identical). Each point's term is IEEE division's bit for bit, as
    in the TPU kernel and the plain version on CPU tensors (on the card,
    PyTorch divides by the Python number n through its reciprocal).
    Returns a 0-d float32 tensor."""
    device = _cuda_device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks, recip = pi_plan(n, sms)
    counter, parts = pi_scratch(device)
    out = torch.empty((), dtype=torch.float32, device=device)
    lib = build.load("stream", _STREAM_SIGNATURES)
    rc = lib.stream_pi(int(n), int(recip), parts.data_ptr(), blocks,
                       counter.data_ptr(), out.data_ptr(), _stream(device))
    build.check(lib, rc, "pi_integration")
    LAUNCHES["pi_integration"] += 1
    return out


# --- stencils -------------------------------------------------------------

def _check_grid(name: str, u, ndim: int) -> None:
    _check_inputs(name, (u,), (torch.float32,), aligned=False)
    if u.dim() != ndim or min(u.shape) < 3:
        raise ValueError(f"{name} kernel takes a {ndim}-D grid at least 3 "
                         f"points on a side, got {tuple(u.shape)}")
    if max(u.shape) > _INT_MAX:
        raise ValueError(f"{name} kernel: a side above 2^31 - 1")


def jacobi_2d5pt(u):
    """(H, W) -> (H-2, W-2) interior 5-point mean, any H, W >= 3."""
    _check_grid("jacobi_2d5pt", u, 2)
    h, w = u.shape
    if (h - 2) * -(-(w - 2) // 256) > _INT_MAX:
        raise ValueError(f"jacobi_2d5pt kernel: {tuple(u.shape)} needs "
                         "more than 2^31 - 1 blocks")
    o = torch.empty((h - 2, w - 2), dtype=u.dtype, device=u.device)
    lib = build.load("stencil", _STENCIL_SIGNATURES)
    rc = lib.stencil_jacobi_2d5pt(u.data_ptr(), o.data_ptr(), h, w,
                                  _stream(u.device))
    build.check(lib, rc, "jacobi_2d5pt")
    LAUNCHES["jacobi_2d5pt"] += 1
    return o


def jacobi_3d7pt(u):
    """(D, H, W) -> (D-2, H-2, W-2) interior 7-point mean, any D, H, W
    >= 3: a block a tile of output columns marching down a chunk of
    planes, one launch."""
    _check_grid("jacobi_3d7pt", u, 3)
    d, h, w = u.shape
    # a grid of more than 2^31 - 1 tiles is refused by check_grid in
    # csrc/stencil.cu, and build.check raises
    o = torch.empty((d - 2, h - 2, w - 2), dtype=u.dtype, device=u.device)
    lib = build.load("stencil", _STENCIL_SIGNATURES)
    rc = lib.stencil_jacobi_3d7pt(u.data_ptr(), o.data_ptr(), d, h, w,
                                  _stream(u.device))
    build.check(lib, rc, "jacobi_3d7pt")
    LAUNCHES["jacobi_3d7pt"] += 1
    return o


class GaussSeidelPlan(NamedTuple):
    """The launches of one ``gauss_seidel_2d5pt`` call, in order."""
    fused: tuple    # sweeps each pass fuses (0: a copy)
    writes: tuple   # the grid each pass writes, "out" or "temp"
    tma: tuple      # whether each pass takes the tensor-copy (TMA) route
    strips: tuple   # warps of each pass, one strip of columns each
    temp: int       # floats of the temporary grid (0: none)


def gs_strip_columns(fused: int, tma: bool) -> int:
    """Columns a strip of a pass of ``fused`` sweeps writes: its 32 lanes
    less the halo column each fused sweep past the first spends on each
    side, and on the TMA route a multiple of 4 (whole 16-byte rows)."""
    if tma:
        return 32 if fused <= 1 else 28 if fused <= 3 else 24
    return 34 - 2 * max(fused, 1)


def gauss_seidel_plan(h: int, w: int, sweeps: int,
                      aligned: bool = True) -> GaussSeidelPlan:
    """The passes ``gauss_seidel_2d5pt`` launches on an (h, w) grid whose
    data start 16-byte aligned or not (``aligned``).

    ``sweeps`` are split as evenly as they go into the fewest passes of at
    most ``GS_MAX_FUSED``; no sweep, or a grid with no interior point,
    is one pass of 0 (a copy). The first pass reads the input, each other
    pass the grid its predecessor wrote, and the passes alternate between
    the output and one temporary grid of h * w floats, the first choosing
    so that the last lands in the output: no copy at the end, and no
    temporary for one pass. A pass takes the TMA route (one tensor copy a
    stage of rows each way) where its rows are 16-byte aligned: W % 4 == 0
    and, for the first pass, an aligned input (the output and temporary
    grids always are); else the 4-byte copy route, which takes any width
    and offset.
    """
    if sweeps == 0 or h < 3 or w < 3:
        fused = (0,)
    else:
        n = -(-sweeps // GS_MAX_FUSED)
        fused = tuple(sweeps // n + (i < sweeps % n) for i in range(n))
    p = len(fused)
    tma = tuple(w % 4 == 0 and (aligned or i > 0) for i in range(p))
    return GaussSeidelPlan(
        fused, tuple("out" if (p - 1 - i) % 2 == 0 else "temp"
                     for i in range(p)), tma,
        tuple(-(-w // gs_strip_columns(f, t)) for f, t in zip(fused, tma)),
        h * w if p > 1 else 0)


def gauss_seidel_2d5pt(u, sweeps: int = 1):
    """``sweeps`` Gauss-Seidel sweeps of ``u`` (H, W); returns a new (H, W)
    tensor, ``u`` is not modified. Any H and W (below 2^31 - 64 each).

    One warp a strip of columns walks the rows, each lane a column's
    recurrence, streaming its strip through shared memory by TMA tensor
    copies (16-byte aligned rows) or 4-byte ``cp.async`` copies (any
    other); a launch is one pass of up to ``GS_MAX_FUSED`` sweeps
    pipelined down the rows, and the passes of ``gauss_seidel_plan``
    ping-pong between the output and a temporary grid allocated here.
    ``LAUNCHES`` counts each pass.
    """
    _check_inputs("gauss_seidel_2d5pt", (u,), (torch.float32,),
                  aligned=False)
    if u.dim() != 2 or u.numel() == 0:
        raise ValueError(f"gauss_seidel_2d5pt kernel takes a non-empty 2-D "
                         f"grid, got {tuple(u.shape)}")
    h, w = u.shape
    if max(h, w) > _INT_MAX - 64:
        raise ValueError("gauss_seidel_2d5pt kernel: a side above 2^31 - 65")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")
    plan = gauss_seidel_plan(h, w, int(sweeps), u.data_ptr() % 16 == 0)
    grids = {"out": torch.empty_like(u)}
    if plan.temp:
        grids["temp"] = torch.empty_like(u)
    lib = build.load("stencil", _STENCIL_SIGNATURES)
    src = u
    for fused, dst in zip(plan.fused, plan.writes):
        rc = lib.stencil_gauss_seidel_pass(src.data_ptr(),
                                           grids[dst].data_ptr(), h, w,
                                           fused, _stream(u.device))
        build.check(lib, rc, "gauss_seidel_2d5pt")
        LAUNCHES["gauss_seidel_2d5pt"] += 1
        src = grids[dst]
    return grids["out"]
