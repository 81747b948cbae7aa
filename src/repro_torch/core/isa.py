"""ATen op -> µ-op decomposition (the paper's instruction tables).

The counterpart of ``repro/core/isa.py``, which decomposes HLO opcodes.
Here each ATen op that a decode step dispatches (``core/trace.py``
records them) becomes a list of (µ-op class, units) pairs against the
machine model's port table, plus flop side accounting. The classes and
their units are the JAX package's, so one trace prices across vendors:
a `vpu`/`vlsu` unit is an (8,128) f32 block, an `mxu` unit one 128^3
pass counted as ``_dot_mnkb`` counts them. An unknown op degrades to
VPU-class elementwise work, flagged ``unknown`` — never a crash.

A collective (``_c10d_functional.all_reduce`` and its kin, or the c10d
forms ``c10d.allreduce_``...) is priced as the JAX package prices its
HLO counterpart: ``ici`` wire bytes from the payload (what the op
returns or writes) and its group's size ``g``, 2(g-1)/g of it for an
all-reduce and (g-1)/g for an all-gather, a reduce-scatter or an
all-to-all, plus the reduction's ``vpu`` pass; waiting on one is free.
"""

from __future__ import annotations

import dataclasses
import math

VPU_BLOCK = 8 * 128      # elements per (8,128) vector register block

# Every machine file must provide an OpEntry for each of these classes —
# repro_torch.core.machine.register() validates completeness against this
# tuple.
UOP_CLASSES = ("mxu", "vpu", "xlu", "vdiv", "vlsu", "gather4", "sc",
               "dma", "ici")

#: matrix products: (B, M, N, K) from the operands, as ``_dot_mnkb``
MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "linear", "matmul", "dot",
              "mv", "addmv"}
#: transcendentals and random draws (XLA's ``rng`` is an XLU op too)
XLU_OPS = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "silu", "gelu", "rsqrt", "sqrt", "pow", "sin", "cos", "tan",
    "sinh", "cosh", "asin", "acos", "atan", "atan2", "erf", "erfc",
    "erfinv", "softplus", "mish", "elu", "selu", "logit", "uniform",
    "normal", "bernoulli", "rand", "randn", "randint", "random",
    "exponential", "log_sigmoid", "log_sigmoid_forward",
    # backward passes that recompute a transcendental
    "silu_backward", "gelu_backward", "softplus_backward",
    "log_sigmoid_backward", "elu_backward",
}
#: exp of every element plus its max and sum reductions
SOFTMAX_OPS = {"_softmax", "_log_softmax", "softmax", "log_softmax",
               "_safe_softmax"}
DIV_OPS = {"div", "remainder", "fmod", "reciprocal", "floor_divide"}
CHEAP_EW = {
    "add", "sub", "rsub", "mul", "neg", "abs", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "masked_fill", "sign",
    "sgn", "floor", "ceil", "round", "trunc", "frac", "isfinite", "isnan",
    "isinf", "lerp", "addcmul", "addcdiv", "relu", "threshold", "hardtanh",
    "copysign", "square", "_to_copy", "to", "nan_to_num", "fmax", "fmin",
    "tril", "triu", "heaviside", "__or__", "__and__", "__xor__",
    "__invert__", "tanh_backward", "sigmoid_backward", "threshold_backward",
    "hardtanh_backward", "_softmax_backward_data",
    "_log_softmax_backward_data",
}
#: reductions: two VPU passes over the input (JAX's ``reduce``)
REDUCE_OPS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "var", "std", "var_mean", "std_mean", "all", "any",
    "logsumexp", "norm", "linalg_vector_norm", "cumsum", "cumprod",
    "count_nonzero", "nansum", "aminmax", "topk", "sort", "argsort",
}
#: reads of rows picked by an index: random-index gathers
GATHER_OPS = {"embedding", "index_select", "gather", "index", "take"}
#: writes and data movement: `vlsu` of the elements written
WRITE_OPS = {
    "copy", "index_copy", "index_put", "_index_put_impl", "scatter",
    "scatter_add", "scatter_reduce", "index_add", "index_fill", "cat",
    "stack", "clone", "contiguous", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter", "constant_pad_nd", "pad",
    "repeat", "flip", "roll", "fill", "zero", "zeros", "ones", "full",
    "zeros_like", "ones_like", "full_like", "arange", "linspace",
    "masked_scatter", "scalar_tensor", "new_zeros", "new_ones", "new_full",
    # backward passes that write a slice's gradient into zeros
    "slice_backward", "select_backward", "index_select_backward",
    "embedding_dense_backward", "unbind_backward",
}
#: allocations: no work and no traffic
ALLOC_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "lift_fresh"}
#: collectives, functional and c10d, by the HLO kind they lower to
COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base": "all-gather", "allgather": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base": "all-to-all",
    "alltoall": "all-to-all",
}
#: waiting on a collective: no work (the HLO ``-done``)
WAIT_OPS = {"wait_tensor", "_wrap_tensor_autograd"}
#: writes whose mutated operand is overwritten, not read
OVERWRITE_OPS = {"copy", "index_copy", "index_put", "_index_put_impl",
                 "scatter", "index_fill", "slice_scatter", "fill", "zero",
                 "uniform", "normal", "bernoulli", "random", "exponential",
                 "masked_scatter", "_allgather_base", "allgather",
                 "_reduce_scatter_base", "reduce_scatter", "alltoall_base",
                 "alltoall", "allgather_into_tensor_coalesced"}


@dataclasses.dataclass(frozen=True)
class Operand:
    """Shape and element size of one tensor an op reads or writes."""

    shape: tuple
    itemsize: int

    @property
    def elems(self) -> int:
        """Elements of the tensor (1 for a 0-d tensor)."""
        return math.prod(self.shape)

    @property
    def bytes(self) -> int:
        """Bytes of the tensor as the op sees it (a view's own extent)."""
        return self.elems * self.itemsize


@dataclasses.dataclass
class Uops:
    """Decomposition result + side accounting for one op."""
    uops: list            # [(class, units)]
    flops: float = 0.0
    bytes_hbm: float = 0.0
    coll_bytes: float = 0.0
    coll_kind: str = ""
    unknown: bool = False


def base_name(op: str) -> str:
    """An ATen op's name without its in-place underscore (``add_`` ->
    ``add``; ``_softmax`` keeps its leading one)."""
    return op[:-1] if op.endswith("_") and not op.endswith("__") else op


def _dot_mnkb(op: str, ins: list, outs: list) -> tuple:
    """(B, M, N, K) of a matrix product from its tensor operands, with
    XLA's ``dot`` semantics: dims both operands carry are batch dims."""
    if op in ("addmm", "baddbmm", "addmv"):
        ins = ins[1:]
    if len(ins) < 2:
        e = sum(o.elems for o in outs) or 1
        s = max(1.0, e ** 0.5)
        return 1, s, s, s
    a, b = ins[0].shape, ins[1].shape
    if op == "linear":                      # x (..., K) @ w (N, K)^T
        return 1, max(1, math.prod(a[:-1])), b[0], a[-1]
    k = a[-1] if a else 1
    if len(b) <= 2:                         # no batch dims on rhs
        n = b[-1] if len(b) == 2 else 1
        return 1, max(1, math.prod(a[:-1])), n, k
    m = a[-2] if len(a) >= 2 else 1
    bsz = math.prod(outs[0].shape[:-2]) if outs else math.prod(b[:-2])
    return max(1, bsz), max(1, m), b[-1], k


def _vpu_blocks(elems: int) -> float:
    return max(1.0, math.ceil(elems / VPU_BLOCK))


def decompose(op: str, ins: list, outs: list,
              written: int | None = None) -> Uops:
    """µ-ops of one non-view ATen op.

    ``op`` is the op's name (``mm``, ``index_put_``...); ``ins`` the
    :class:`Operand` of each tensor it takes, in argument order; ``outs``
    those it returns fresh; ``written`` the elements an in-place op
    writes into an operand (the update, for a write into a slice).
    """
    name = base_name(op)
    e = written if written is not None else sum(o.elems for o in outs)
    if name in ALLOC_OPS or name in WAIT_OPS:
        return Uops([("sc", 1)])
    if name in MATMUL_OPS:
        bsz, m, n, k = _dot_mnkb(name, ins, outs)
        passes = bsz * math.ceil(m / 128) * math.ceil(n / 128) * \
            math.ceil(k / 128)
        return Uops([("mxu", passes)], flops=2.0 * bsz * m * n * k)
    if name in SOFTMAX_OPS:
        return Uops([("xlu", _vpu_blocks(e)), ("vpu", 2 * _vpu_blocks(e))],
                    flops=3.0 * e)
    if name in REDUCE_OPS and ins and ins[0].elems > e:
        n_in = ins[0].elems
        return Uops([("vpu", 2 * _vpu_blocks(n_in))], flops=float(n_in))
    if name in XLU_OPS:
        return Uops([("xlu", _vpu_blocks(e))], flops=float(e))
    if name in DIV_OPS:
        return Uops([("vdiv", _vpu_blocks(e))], flops=float(e))
    if name in CHEAP_EW or name in REDUCE_OPS:
        return Uops([("vpu", _vpu_blocks(e))], flops=float(e))
    if name in GATHER_OPS:
        return Uops([("gather4", _vpu_blocks(e))])
    if name in WRITE_OPS:
        return Uops([("vlsu", _vpu_blocks(e))])
    # unknown op: degrade to elementwise
    return Uops([("vpu", _vpu_blocks(e))], flops=float(e), unknown=True)


def collective(kind: str, payload: float, elems: int, g: int) -> Uops:
    """µ-ops of one collective of HLO kind ``kind`` (``"all-reduce"``,
    ``"all-gather"``, ``"reduce-scatter"``, ``"all-to-all"``) over a
    group of ``g`` ranks: ``payload`` the bytes it returns or writes
    (the gathered whole, the scattered shard), ``elems`` their elements.
    The wire bytes are the JAX package's (``repro/core/isa.py``)."""
    g = max(1, int(g))
    if kind == "all-reduce":
        wire = 2.0 * (g - 1) / g * payload
    elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
        wire = (g - 1) / g * payload
    else:                      # collective-permute
        wire = float(payload)
    u = [("ici", wire)]
    if kind in ("all-reduce", "reduce-scatter"):
        u.append(("vpu", _vpu_blocks(elems)))
    return Uops(u, coll_bytes=wire, coll_kind=kind)


def latency_class(op: str) -> str:
    """The machine-file class whose latency gates this op's consumers."""
    name = base_name(op)
    return ("mxu" if name in MATMUL_OPS else
            "xlu" if name in XLU_OPS or name in SOFTMAX_OPS else
            "vdiv" if name in DIV_OPS else "vpu")
