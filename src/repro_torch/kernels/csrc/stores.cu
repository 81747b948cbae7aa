// In-place KV row writer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/stores.py:_kv_write_nt
// (body _kv_row_kernel). One launch writes the K and the V rows of one
// layer: block (j, b) copies update row (b, j) -- Hkv*Dh elements, 1 KiB
// at yi-9b's shapes in bf16 -- into cache row pos[b] + j of both caches.
// The caches are written in place (the torch analogue of the TPU
// kernel's input_output_aliases): rows the grid does not visit are
// neither read nor written.
//
// The start pos[b] is clamped into [0, S - Sq] exactly as JAX's
// dynamic_update_slice clamps it (a negative start counts from the end
// first), so a decode chunk that runs past a slot's budget overwrites the
// last rows of the slot instead of writing out of bounds.
//
// Bound on the H100: launch latency. A launch moves 2*B*Sq rows
// (16 KiB read and 16 KiB written at B=8, Sq=1, bf16), a few nanoseconds
// of the card's memory rate. flavor "nt" issues streaming stores
// (st.global.cs, evict-first: the rows are not read again before the
// next layer's traffic evicts them); "standard" issues plain stores. The
// bytes written are identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store_cs(uint4* dst, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <bool NT>
__global__ void kv_rows_kernel(const uint4* __restrict__ k_new,
                               const uint4* __restrict__ v_new, uint4* k_cache,
                               uint4* v_cache, const int* __restrict__ pos, int Sq,
                               int S, int row_vecs, long long kc_sb, long long kc_ss,
                               long long vc_sb, long long vc_ss) {
  const int j = blockIdx.x, b = blockIdx.y;
  int p = pos[b];
  if (p < 0) p += S;   // JAX counts a negative start from the end
  p = min(max(p, 0), S - Sq) + j;
  const long long src = (static_cast<long long>(b) * Sq + j) * row_vecs;
  uint4* kd = k_cache + b * kc_sb + p * kc_ss;
  uint4* vd = v_cache + b * vc_sb + p * vc_ss;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    const uint4 a = k_new[src + i];
    const uint4 c = v_new[src + i];
    if (NT) {
      store_cs(kd + i, a);
      store_cs(vd + i, c);
    } else {
      kd[i] = a;
      vd[i] = c;
    }
  }
}

}  // namespace

extern "C" {

// Rows are row_bytes long; strides are in bytes and must be multiples of
// 16, as must every pointer. Returns a CUDA error code (0 on success).
int kv_row_update(const void* k_new, const void* v_new, void* k_cache,
                  void* v_cache, const void* pos, int B, int Sq, int S,
                  int row_bytes, long long kc_sb, long long kc_ss, long long vc_sb,
                  long long vc_ss, int nt, void* stream) {
  if (row_bytes % 16 || kc_sb % 16 || kc_ss % 16 || vc_sb % 16 || vc_ss % 16 ||
      Sq > S || B < 1 || Sq < 1)
    return int(cudaErrorInvalidValue);
  const int row_vecs = row_bytes / 16;
  const int threads = row_vecs >= 128 ? 128 : ((row_vecs + 31) / 32) * 32;
  const dim3 grid(Sq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* kn = static_cast<const uint4*>(k_new);
  const auto* vn = static_cast<const uint4*>(v_new);
  auto* kc = static_cast<uint4*>(k_cache);
  auto* vc = static_cast<uint4*>(v_cache);
  const auto* ps = static_cast<const int*>(pos);
  if (nt)
    kv_rows_kernel<true><<<grid, threads, 0, st>>>(kn, vn, kc, vc, ps, Sq, S, row_vecs,
                                                   kc_sb / 16, kc_ss / 16, vc_sb / 16,
                                                   vc_ss / 16);
  else
    kv_rows_kernel<false><<<grid, threads, 0, st>>>(kn, vn, kc, vc, ps, Sq, S, row_vecs,
                                                    kc_sb / 16, kc_ss / 16, vc_sb / 16,
                                                    vc_ss / 16);
  return int(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
