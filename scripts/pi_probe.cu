// Checks of pi_integration's arithmetic on Hopper (sm_90a), for
// scripts/pi_probe.py. Not part of the port. It includes the port's
// csrc/stream.cu, so the checks run the shipped device functions
// (pi_quotient, pi_rcp) and nothing copied from them.
//
//   probe_pi_rcp    pi_rcp(d) against __frcp_rn(d) for every float d in
//                   [1, 2]: the number that differ;
//   probe_pi_terms  every point i < n of the kernel's arithmetic against
//                   the IEEE divisions of the TPU kernel and the plain
//                   version: the points whose index a, quotient x (q0 =
//                   RN(a * y) alone, and pi_quotient<true>) or term
//                   (4 * pi_rcp(1 + x * x) against
//                   __fdiv_rn(4, 1 + x * x)) differ, and the float64 sum
//                   of the IEEE terms.

#include "../src/repro_torch/kernels/csrc/stream.cu"

namespace {

// the index a of point i as pi_kernel derives it, by its block's path
__device__ float kernel_index(long long i, long long n) {
  const long long j0 = i / kPiBlock * kPiBlock;
  const int k = static_cast<int>(i - j0);
  const int lane = k / kPiLane, q = k % kPiLane / kPiChunk * kPiChunk, u = k % kPiChunk;
  const float base = static_cast<float>(j0), k0 = static_cast<float>(lane * kPiLane);
  const bool whole = j0 + kPiBlock <= n;
  if (whole && j0 + kPiBlock <= (1LL << 23))
    return __fadd_rn(__fadd_rn(__fadd_rn(base, __fadd_rn(k0, 0.5f)), static_cast<float>(q)),
                     static_cast<float>(u));
  if (whole && j0 >= (1LL << 24) && j0 + kPiBlock <= (1LL << 29))
    return __fadd_rn(__fadd_rn(__fadd_rn(base, k0), static_cast<float>(q)),
                     static_cast<float>(u));
  return __fadd_rn(
      __fadd_rn(base, __fadd_rn(__fadd_rn(k0, static_cast<float>(q)), static_cast<float>(u))),
      0.5f);
}

__global__ void rcp_kernel(unsigned long long* bad) {
  const unsigned lo = 0x3f800000u, hi = 0x40000000u;  // 1.0f and 2.0f
  unsigned long long mine = 0;
  for (unsigned b = lo + blockIdx.x * blockDim.x + threadIdx.x; b <= hi;
       b += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(b);
    mine += __float_as_uint(pi_rcp(d)) != __float_as_uint(__frcp_rn(d));
  }
  atomicAdd(bad, mine);
}

// counts: [index, q0 alone, quotient, term] points that differ; *sum64:
// the float64 sum of the IEEE terms
__global__ void terms_kernel(long long n, float fn, unsigned long long* counts,
                             double* sum64) {
  const float y = __frcp_rn(fn);
  unsigned long long c[4] = {};
  double s = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long j0 = i / kPiBlock * kPiBlock;
    const float want_a = __fadd_rn(
        __fadd_rn(static_cast<float>(j0), static_cast<float>(i - j0)), 0.5f);
    const float a = kernel_index(i, n);
    const float want_x = __fdiv_rn(want_a, fn);
    const float x = pi_quotient<true>(want_a, fn, y);
    const float want_d = __fadd_rn(1.0f, __fmul_rn(want_x, want_x));
    const float want_t = __fdiv_rn(4.0f, want_d);
    const float t = __fmul_rn(4.0f, pi_rcp(__fadd_rn(1.0f, __fmul_rn(x, x))));
    c[0] += __float_as_uint(a) != __float_as_uint(want_a);
    c[1] += __float_as_uint(__fmul_rn(want_a, y)) != __float_as_uint(want_x);
    c[2] += __float_as_uint(x) != __float_as_uint(want_x);
    c[3] += __float_as_uint(t) != __float_as_uint(want_t);
    s += static_cast<double>(want_t);
  }
  for (int k = 0; k < 4; ++k) atomicAdd(counts + k, c[k]);
  atomicAdd(sum64, s);
}

}  // namespace

extern "C" {

int probe_pi_rcp(void* bad, void* stream) {
  rcp_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return int(cudaGetLastError());
}

int probe_pi_terms(long long n, void* counts, void* sum64, void* stream) {
  terms_kernel<<<4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<float>(n), static_cast<unsigned long long*>(counts),
      static_cast<double*>(sum64));
  return int(cudaGetLastError());
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
