// Split-KV flash decode for Hopper (sm_90a), GQA heads packed per KV head,
// over a dense slot cache or a paged KV pool.
//
// Replaces the Pallas TPU kernels repro/kernels/attention/decode.py:
// flash_decode (body _decode_kernel) and flash_decode_paged (body
// _paged_decode_kernel). One kernel body serves both, templated on its
// row-addressing rule (PAGED); the load, score, softmax and value code is
// shared. One thread block per
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
//
// Paged pool. On the TPU the KV block equals the page and a BlockSpec
// index map fetches one page per grid step. Here a page of 8 or 16 rows
// would leave a 128-row tile nearly empty, so the tile stays 128 rows and
// spans 128/page pages: before staging a tile, thread t looks up the
// physical page of the tile's row t (table[b, row / page], clipped into
// [0, P-1] as the TPU wrapper's jnp.clip does) and leaves the row's
// element offsets in shared memory, so any page size works. Masking stays
// in logical row coordinates, so the block still visits only the live
// rows [max(split_lo, pos-window+1), min(split_hi, bound, pos+Sq)): table
// columns past pos (dead, or garbage page ids) are never read, and
// out-of-order tables cost nothing but the scattered 256-byte row loads.
// The paged kernel reads bound/page table columns at most (4 bytes each).

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
// (R f32 each) | K tile (DH rows of DH+VEC elements) | V tile (DH*DH) |
// paged only: K and V row offsets of the tile (DH long long each)
template <typename T, int DH>
__host__ __device__ inline size_t kv_offset(int R) {
  return align16(sizeof(float) * (size_t(R) * DH * 2 + 3 * size_t(R)));
}

template <typename T, int DH>
__host__ __device__ inline size_t off_offset(int R) {
  constexpr int KSTR = DH + Vec<T>::N;
  return kv_offset<T, DH>(R) + sizeof(T) * size_t(DH) * (KSTR + DH);
}

template <typename T, int DH, bool PAGED>
__host__ __device__ inline size_t smem_bytes(int R) {
  return off_offset<T, DH>(R) + (PAGED ? 2 * sizeof(long long) * DH : 0);
}

// Row addressing. Dense cache (B, S, Hkv, DH): row r of slot b sits at
// b * s0 + r * s1 elements (batch and sequence strides). Paged pool (P,
// page, Hkv, DH): logical row r of slot b sits in page p = table[b, r /
// page] (clipped into [0, n_pages - 1]) at p * s0 + (r % page) * s1 (page
// and row strides); before staging a tile, thread t looks up row t's page
// and leaves the row's K and V offsets in shared memory. The dense
// instantiation reads no table and adds no barrier.
template <typename T, int DH, int MAXR, bool PAGED>
__global__ void __launch_bounds__(DH)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ pos,
                       float* __restrict__ o_part, float* __restrict__ m_part,
                       float* __restrict__ l_part, int B, int Sq, int H,
                       int Hkv, long long k_s0, long long k_s1, long long v_s0,
                       long long v_s1, int split_len, int bound, int window,
                       float scale, const int* __restrict__ table, int t_stride,
                       int n_pages, int ps) {
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
  long long* ko_s = reinterpret_cast<long long*>(smem + off_offset<T, DH>(R));
  long long* vo_s = ko_s + BK;

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

  const T* kb = k + (PAGED ? 0 : b * k_s0) + size_t(kvh) * DH;
  const T* vb = v + (PAGED ? 0 : b * v_s0) + size_t(kvh) * DH;
  const int warp = t >> 5, lane = t & 31;
  constexpr int NWARPS = NT / 32;

  for (int t0 = start; t0 < end; t0 += BK) {
    const int n = min(BK, end - t0);
    if constexpr (PAGED) {
      if (t < n) {
        const int row = t0 + t;
        int p = __ldg(table + size_t(b) * t_stride + row / ps);
        p = min(max(p, 0), n_pages - 1);
        const int in_page = row - (row / ps) * ps;
        ko_s[t] = p * k_s0 + in_page * k_s1;
        vo_s[t] = p * v_s0 + in_page * v_s1;
      }
      __syncthreads();
    }
    // stage the tile's K and V rows, 16 bytes a thread per step
    for (int i = t; i < n * VPR; i += NT) {
      const int row = i / VPR, c = i - row * VPR;
      const long long ko = PAGED ? ko_s[row] : (t0 + row) * k_s1;
      const long long vo = PAGED ? vo_s[row] : (t0 + row) * v_s1;
      const uint4 kv = *reinterpret_cast<const uint4*>(kb + ko + c * VEC);
      const uint4 vv = *reinterpret_cast<const uint4*>(vb + vo + c * VEC);
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

// Kernel arguments after the query/cache/output pointers, passed through
// the launch helpers unchanged.
struct Args {
  int B, Sq, H, Hkv;
  long long k_s0, k_s1, v_s0, v_s1;
  int n_splits, split_len, bound, window;
  float scale;
  const int* table;
  int t_stride, n_pages, ps;
};

template <typename T, int DH, int MAXR, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* pos, void* o,
           void* m, void* l, const Args& a, cudaStream_t stream) {
  auto kern = decode_partials_kernel<T, DH, MAXR, PAGED>;
  const int R = (a.H / a.Hkv) * a.Sq;
  const size_t shm = smem_bytes<T, DH, PAGED>(R);
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
  const dim3 grid(a.Hkv, a.n_splits, a.B);
  kern<<<grid, DH, shm, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), a.B, a.Sq, a.H, a.Hkv, a.k_s0, a.k_s1, a.v_s0, a.v_s1,
      a.split_len, a.bound, a.window, a.scale, a.table, a.t_stride, a.n_pages, a.ps);
  return int(cudaGetLastError());
}

template <typename T, int DH, bool PAGED>
int launch_rows(const void* q, const void* k, const void* v, const void* pos, void* o,
                void* m, void* l, const Args& a, cudaStream_t st) {
  const int R = (a.H / a.Hkv) * a.Sq;
  if (R <= 8) return launch<T, DH, 8, PAGED>(q, k, v, pos, o, m, l, a, st);
  if (R <= 16) return launch<T, DH, 16, PAGED>(q, k, v, pos, o, m, l, a, st);
  if (R <= 32) return launch<T, DH, 32, PAGED>(q, k, v, pos, o, m, l, a, st);
  return int(cudaErrorInvalidValue);
}

template <typename T, bool PAGED>
int launch_dh(int Dh, const void* q, const void* k, const void* v, const void* pos,
              void* o, void* m, void* l, const Args& a, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_rows<T, 32, PAGED>(q, k, v, pos, o, m, l, a, st);
    case 64: return launch_rows<T, 64, PAGED>(q, k, v, pos, o, m, l, a, st);
    case 128: return launch_rows<T, 128, PAGED>(q, k, v, pos, o, m, l, a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int launch_dtype(int dtype, int Dh, const void* q, const void* k, const void* v,
                 const void* pos, void* o, void* m, void* l, const Args& a,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float, PAGED>(Dh, q, k, v, pos, o, m, l, a, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16, PAGED>(Dh, q, k, v, pos, o, m, l, a, st);
  return int(cudaErrorInvalidValue);
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
  const Args a{B, Sq, H, Hkv, k_sb, k_ss, v_sb, v_ss, n_splits, split_len, bound,
               window, scale, nullptr, 0, 0, 1};
  return launch_dtype<false>(dtype, Dh, q, k, v, pos, o_part, m_part, l_part, a, stream);
}

// The same over page pools k, v (P, page, Hkv, Dh) through the (B, NB)
// int32 block table `table` (row stride t_stride). Page and row strides
// are in elements; bound is the number of logical rows that may be read
// (at most the table's columns times page_size).
int flash_decode_paged_partials(const void* q, const void* k, const void* v,
                                const void* table, const void* pos, void* o_part,
                                void* m_part, void* l_part, int dtype, int B, int Sq,
                                int H, int Hkv, int Dh, int t_stride, int n_pages,
                                int page_size, long long k_ps, long long k_rs,
                                long long v_ps, long long v_rs, int n_splits,
                                int split_len, int bound, int window, float scale,
                                void* stream) {
  const Args a{B, Sq, H, Hkv, k_ps, k_rs, v_ps, v_rs, n_splits, split_len, bound,
               window, scale, static_cast<const int*>(table), t_stride, n_pages,
               page_size};
  return launch_dtype<true>(dtype, Dh, q, k, v, pos, o_part, m_part, l_part, a, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
