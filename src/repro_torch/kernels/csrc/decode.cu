// Split-KV flash decode for Hopper (sm_90a), GQA heads packed per KV head.
//
// Replaces the Pallas TPU kernel repro/kernels/attention/decode.py:
// flash_decode (body _decode_kernel). One thread block per
// (kv_head, split, batch row). The TPU grid's sequential KV dimension
// becomes a loop inside the block over the split's live rows: the block
// reads pos[b] itself (the TPU kernel's scalar prefetch) and visits only
// rows in [max(split_lo, pos-window+1), min(split_hi, bound, pos+Sq)),
// so rows past the last query position, rows before the sliding window
// and rows past the occupancy bound are never read. The cache is taken
// whole, with explicit batch and sequence strides: no copy or padding
// of the horizon is ever made.
//
// Bound on the H100: device-memory bytes. At decode each KV row is read
// once and used by all G*Sq query rows of its KV head, which is far below
// the ~295 flop/byte ridge of the card, so the design goal is coalesced
// 16-byte row loads and enough blocks (B*Hkv*n_splits) to cover the 132
// SMs. The G*Sq packed query rows and the online-softmax state (m, l)
// stay in shared memory; each thread keeps its output column of the
// accumulator in registers, in fp32. The partials (o, m, l) per split are
// merged by combine_splits outside the kernel. A split with no live row
// writes m = -1e30, l = 0, o = 0 and weighs exactly zero in the merge.
//
// Tile: DH keys per step, DH threads; thread t scores key t against all
// packed rows (K staged in shared memory with rows padded by 16 bytes so
// the per-thread row reads are free of bank conflicts) and owns output
// column t in the value product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInit = -1e30f;   // running max of a row with no live key

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;        // elements in 16 bytes
  __device__ static float get(float x) { return x; }
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// shared memory layout, in bytes: q (R*DH f32) | p (R*DH f32) | m, l, alpha
// (R f32 each) | K tile (DH rows of DH+VEC elements) | V tile (DH*DH)
template <typename T, int DH>
__host__ __device__ inline size_t kv_offset(int R) {
  return align16(sizeof(float) * (size_t(R) * DH * 2 + 3 * size_t(R)));
}

template <typename T, int DH>
__host__ __device__ inline size_t smem_bytes(int R) {
  constexpr int KSTR = DH + Vec<T>::N;
  return kv_offset<T, DH>(R) + sizeof(T) * size_t(DH) * (KSTR + DH);
}

template <typename T, int DH, int MAXR>
__global__ void __launch_bounds__(DH)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int B, int Sq, int H,
                       int Hkv, long long k_sb, long long k_ss, long long v_sb,
                       long long v_ss, int split_len, int bound, int window,
                       float scale) {
  constexpr int NT = DH;             // threads per block
  constexpr int BK = DH;             // keys per tile
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = DH / VEC;      // 16-byte vectors per row
  constexpr int KSTR = DH + VEC;     // padded K row, in elements
  const int kvh = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int G = H / Hkv, R = G * Sq;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + R * DH;
  float* m_s = p_s + R * BK;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  T* k_s = reinterpret_cast<T*>(smem + kv_offset<T, DH>(R));
  T* v_s = k_s + BK * KSTR;

  const int p0 = pos[b];
  const int lo = s * split_len;
  const int hi = min(lo + split_len, bound);
  const int start = window > 0 ? max(lo, p0 - window + 1) : lo;
  const int end = min(hi, p0 + Sq);

  // packed query rows r = j*G + g (query token j, head kvh*G + g), scaled
  for (int i = t; i < R * DH; i += NT) {
    const int r = i / DH, d = i - r * DH;
    const int j = r / G, g = r - j * G;
    const size_t src = ((size_t(b) * Sq + j) * H + kvh * G + g) * DH + d;
    q_s[i] = Vec<T>::get(q[src]) * scale;
  }
  for (int r = t; r < R; r += NT) {
    m_s[r] = kNegInit;
    l_s[r] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  __syncthreads();

  const T* kb = k + b * k_sb + size_t(kvh) * DH;
  const T* vb = v + b * v_sb + size_t(kvh) * DH;
  const int warp = t >> 5, lane = t & 31;
  constexpr int NWARPS = NT / 32;

  for (int t0 = start; t0 < end; t0 += BK) {
    const int n = min(BK, end - t0);
    // stage the tile's K and V rows, 16 bytes a thread per step
    for (int i = t; i < n * VPR; i += NT) {
      const int row = i / VPR, c = i - row * VPR;
      const uint4 kv = *reinterpret_cast<const uint4*>(kb + (t0 + row) * k_ss + c * VEC);
      const uint4 vv = *reinterpret_cast<const uint4*>(vb + (t0 + row) * v_ss + c * VEC);
      *reinterpret_cast<uint4*>(k_s + row * KSTR + c * VEC) = kv;
      *reinterpret_cast<uint4*>(v_s + row * DH + c * VEC) = vv;
    }
    __syncthreads();

    // scores: thread t takes key t0 + t against every packed row
    {
      float sc[MAXR];
#pragma unroll
      for (int r = 0; r < MAXR; ++r) sc[r] = 0.f;
      if (t < n) {
        for (int c = 0; c < VPR; ++c) {
          float kf[VEC];
          Vec<T>::unpack(*reinterpret_cast<const uint4*>(k_s + t * KSTR + c * VEC), kf);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            if (r < R) {
              const float4* qr = reinterpret_cast<const float4*>(q_s + r * DH + c * VEC);
#pragma unroll
              for (int e4 = 0; e4 < VEC / 4; ++e4) {
                const float4 qv = qr[e4];
                sc[r] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] +
                         qv.z * kf[4 * e4 + 2] + qv.w * kf[4 * e4 + 3];
              }
            }
          }
        }
      }
      const int kp = t0 + t;
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const int qp = p0 + r / G;
          const bool live = t < n && kp <= qp && (window <= 0 || kp > qp - window);
          p_s[r * BK + t] = live ? sc[r] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per packed row; masked keys weigh exactly 0
    for (int r = warp; r < R; r += NWARPS) {
      float mx = -INFINITY;
      for (int i = lane; i < BK; i += 32) mx = fmaxf(mx, p_s[r * BK + i]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < BK; i += 32) {
        const float e = expf(p_s[r * BK + i] - m_new);
        p_s[r * BK + i] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // values: thread t accumulates output column t
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < R) acc[r] *= a_s[r];
    int i = 0;
    for (; i + 4 <= n; i += 4) {
      const float v0 = Vec<T>::get(v_s[(i + 0) * DH + t]);
      const float v1 = Vec<T>::get(v_s[(i + 1) * DH + t]);
      const float v2 = Vec<T>::get(v_s[(i + 2) * DH + t]);
      const float v3 = Vec<T>::get(v_s[(i + 3) * DH + t]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r < R) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + r * BK + i);
          acc[r] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
        }
      }
    }
    for (; i < n; ++i) {
      const float vv = Vec<T>::get(v_s[i * DH + t]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < R) acc[r] += p_s[r * BK + i] * vv;
    }
    __syncthreads();
  }

  // partials: o (S,B,Sq,H,DH), m and l (S,B,Sq,H)
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      const int j = r / G, g = r - j * G;
      const size_t row = ((size_t(s) * B + b) * Sq + j) * H + kvh * G + g;
      o_part[row * DH + t] = acc[r];
      if (t == 0) {
        m_part[row] = m_s[r];
        l_part[row] = l_s[r];
      }
    }
  }
}

template <typename T, int DH, int MAXR>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* o, void* m, void* l, int B, int Sq, int H, int Hkv,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss,
           int n_splits, int split_len, int bound, int window, float scale,
           cudaStream_t stream) {
  auto kern = decode_partials_kernel<T, DH, MAXR>;
  const int R = (H / Hkv) * Sq;
  const size_t shm = smem_bytes<T, DH>(R);
  static bool configured = false;   // once per instantiation
  if (!configured) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const dim3 grid(Hkv, n_splits, B);
  kern<<<grid, DH, shm, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), B, Sq, H, Hkv, k_sb, k_ss, v_sb, v_ss, split_len,
      bound, window, scale);
  return int(cudaGetLastError());
}

template <typename T, int DH>
int launch_rows(int R, const void* q, const void* k, const void* v, const void* pos,
                void* o, void* m, void* l, int B, int Sq, int H, int Hkv,
                long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                int n_splits, int split_len, int bound, int window, float scale,
                cudaStream_t st) {
  if (R <= 8)
    return launch<T, DH, 8>(q, k, v, pos, o, m, l, B, Sq, H, Hkv, k_sb, k_ss, v_sb,
                            v_ss, n_splits, split_len, bound, window, scale, st);
  if (R <= 16)
    return launch<T, DH, 16>(q, k, v, pos, o, m, l, B, Sq, H, Hkv, k_sb, k_ss, v_sb,
                             v_ss, n_splits, split_len, bound, window, scale, st);
  if (R <= 32)
    return launch<T, DH, 32>(q, k, v, pos, o, m, l, B, Sq, H, Hkv, k_sb, k_ss, v_sb,
                             v_ss, n_splits, split_len, bound, window, scale, st);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch_dh(int Dh, int R, const void* q, const void* k, const void* v,
              const void* pos, void* o, void* m, void* l, int B, int Sq, int H,
              int Hkv, long long k_sb, long long k_ss, long long v_sb,
              long long v_ss, int n_splits, int split_len, int bound, int window,
              float scale, cudaStream_t st) {
  switch (Dh) {
    case 32:
      return launch_rows<T, 32>(R, q, k, v, pos, o, m, l, B, Sq, H, Hkv, k_sb, k_ss,
                                v_sb, v_ss, n_splits, split_len, bound, window, scale, st);
    case 64:
      return launch_rows<T, 64>(R, q, k, v, pos, o, m, l, B, Sq, H, Hkv, k_sb, k_ss,
                                v_sb, v_ss, n_splits, split_len, bound, window, scale, st);
    case 128:
      return launch_rows<T, 128>(R, q, k, v, pos, o, m, l, B, Sq, H, Hkv, k_sb, k_ss,
                                 v_sb, v_ss, n_splits, split_len, bound, window, scale, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. window <= 0
// means no sliding window. Returns a CUDA error code (0 on success).
int flash_decode_partials(const void* q, const void* k, const void* v,
                          const void* pos, void* o_part, void* m_part,
                          void* l_part, int dtype, int B, int Sq, int H, int Hkv,
                          int Dh, long long k_sb, long long k_ss, long long v_sb,
                          long long v_ss, int n_splits, int split_len, int bound,
                          int window, float scale, void* stream) {
  const int R = (H / Hkv) * Sq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(Dh, R, q, k, v, pos, o_part, m_part, l_part, B, Sq, H,
                            Hkv, k_sb, k_ss, v_sb, v_ss, n_splits, split_len, bound,
                            window, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(Dh, R, q, k, v, pos, o_part, m_part, l_part, B,
                                    Sq, H, Hkv, k_sb, k_ss, v_sb, v_ss, n_splits,
                                    split_len, bound, window, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
