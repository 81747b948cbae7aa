"""A numpy model of ``pi_integration``'s CUDA kernel (``csrc/stream.cu``
``pi_kernel``): each point's arithmetic as the kernel does it, float32
operation by float32 operation, and its reduction order, from the lanes'
accumulators to the last block's sum. The CPU tests hold the model's
terms bit for bit against the plain version's; on the card the kernel is
held bit for bit against the model. Imports neither JAX nor the card.

Only the reciprocal of d = 1 + x^2 stands in for the kernel's: the model
takes float32 division, RN(1 / d), which ``pi_rcp`` (MUFU.RCP and one
Newton step) matches on every float in [1, 2] (``scripts/pi_probe.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.stream import kernels as K

F32, F64 = np.float32, np.float64
BN = K.PI_BLOCK              # the TPU kernel's bn
LANE = BN // 32              # contiguous points a lane of a block
CHUNK, ACC, THREADS = 32, 4, 256


def fma32(a, b, c) -> np.ndarray:
    """RN(a * b + c) in float32 with one rounding, exactly (Python 3.12
    has no ``math.fma``): the product is exact in float64, the sum is
    float64's s plus an exact TwoSum error e, and RN32(s + e) is RN32(s)
    but where s is a float32 midpoint, which e then breaks."""
    a, b, c = (np.asarray(v, F32) for v in (a, b, c))
    p = a.astype(F64) * b.astype(F64)
    c64 = c.astype(F64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.astype(F32)
    r64 = r.astype(F64)
    other = np.nextafter(r, np.where(s > r64, np.inf, -np.inf).astype(F32))
    tie = (s == (r64 + other.astype(F64)) / 2) & (e != 0)
    return np.where(tie & ((e > 0) == (other.astype(F64) > r64)), other, r)


def kernel_index(n: int, idx: np.ndarray) -> np.ndarray:
    """The float32 index a of each point ``idx`` as the kernel derives
    it: one add of an exact chunk offset below 2^23 and from 2^24 to
    2^29, else (and in the last, masked block) the TPU's
    RN(RN(float32(j * bn) + k) + 0.5)."""
    j0 = idx // BN * BN
    k = idx - j0
    lane, q, u = k // LANE, k % LANE // CHUNK * CHUNK, k % CHUNK
    base, k0 = j0.astype(F32), (lane * LANE).astype(F32)
    qf, uf = q.astype(F32), u.astype(F32)
    whole = j0 + BN <= n
    small = whole & (j0 + BN <= 2 ** 23)
    big = whole & (j0 >= 2 ** 24) & (j0 + BN <= 2 ** 29)
    a_small = (base + (k0 + F32(0.5)) + qf) + uf
    a_big = (base + k0 + qf) + uf
    a_general = (base + ((k0 + qf) + uf)) + F32(0.5)
    return np.where(small, a_small, np.where(big, a_big, a_general))


def kernel_terms(n: int, idx: np.ndarray) -> np.ndarray:
    """RN(1 / (1 + x^2)) of each point ``idx``, the kernel's quotient x
    (one FMA correction of a * RN(1/fn) where ``pi_quotient_by_reciprocal``
    says so, else IEEE division). 4 times this is the plain term."""
    fn = F32(n)
    a = kernel_index(n, np.asarray(idx, np.int64))
    if K.pi_quotient_by_reciprocal(n):
        y = F32(1) / fn
        q0 = a * y
        x = fma32(fma32(-q0, fn, a), y, q0)
    else:
        x = a / fn
    return F32(1) / (F32(1) + x * x)


def plain_terms(n: int, idx: np.ndarray) -> np.ndarray:
    """The plain version's terms 4 / (1 + x^2) at the points ``idx``, by
    its expression on CPU tensors (IEEE division), as float32."""
    i = torch.from_numpy(np.asarray(idx, np.int64)).to(torch.float32)
    x = (i + 0.5) / n
    return (4.0 / (1.0 + x * x)).numpy()


def _shfl_down_tree(v: np.ndarray) -> np.ndarray:
    """Lane 0 of ``v += __shfl_down_sync(v, off)`` for off 16 .. 1 over
    the last axis (32 lanes); a lane past the end reads its own value."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., np.where(lanes + off < 32, lanes + off, lanes)]
    return v[..., 0]


def kernel_sum(n: int, sms: int, chunk: int = 1 << 22) -> np.float32:
    """The kernel's result for ``n`` points on a card of ``sms`` SMs, in
    its order: each lane's 128 points of a block into ``ACC``
    accumulators (point m into m % ACC), their tree, the lanes' xor
    butterfly, each
    warp's blocks in turn, each block's 8 warps in turn, then the last
    block's sum of the partials (thread t takes t, t + 256, ... in turn,
    then a shuffle-down tree in each warp and over the warps), 4 times it
    over fn."""
    blocks, _ = K.pi_plan(n, sms)
    nb = -(-n // BN)
    t = np.zeros(nb * BN, F32)          # masked points add nothing
    for s in range(0, n, chunk):
        idx = np.arange(s, min(n, s + chunk), dtype=np.int64)
        t[s:s + len(idx)] = kernel_terms(n, idx)
    t = t.reshape(nb, 32, LANE)
    acc = np.zeros((ACC, nb, 32), F32)
    for m in range(LANE):
        acc[m % ACC] = acc[m % ACC] + t[:, :, m]
    s = ACC // 2
    while s:
        acc[:s] = acc[:s] + acc[s:2 * s]
        s //= 2
    v = acc[0]
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ off]
    block_total = v[:, 0]
    warps = blocks * (THREADS // 32)
    wsum = np.zeros(warps, F32)
    for j0 in range(0, nb, warps):
        part = block_total[j0:j0 + warps]
        wsum[:len(part)] = wsum[:len(part)] + part
    wsum = wsum.reshape(blocks, THREADS // 32)
    parts = wsum[:, 0].copy()
    for w in range(1, THREADS // 32):
        parts = parts + wsum[:, w]
    per_thread = np.zeros(THREADS, F32)
    for b0 in range(0, blocks, THREADS):
        p = parts[b0:b0 + THREADS]
        per_thread[:len(p)] = per_thread[:len(p)] + p
    warp_sums = _shfl_down_tree(per_thread.reshape(THREADS // 32, 32))
    lanes = np.zeros(32, F32)
    lanes[:THREADS // 32] = warp_sums
    total = _shfl_down_tree(lanes)
    return (F32(4) * total) / F32(n)
