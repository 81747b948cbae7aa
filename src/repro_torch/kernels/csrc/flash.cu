// Causal (optionally windowed) GQA flash-attention forward for Hopper
// (sm_90a), the G = H / Hkv query heads of a KV head packed into one tile.
//
// Replaces the Pallas TPU kernel repro/kernels/attention/flash.py:
// flash_attention (body _flash_kernel). The TPU grid (B, H, nq, nk) runs
// its KV axis innermost and in order, carrying (m, l, acc) in VMEM scratch
// from one grid step to the next. Blocks on Hopper run in parallel and
// carry nothing, so the KV axis becomes a loop inside one block per
// (query tile, KV head, batch row), and the G query heads that share a KV
// head are packed into that block: each K/V tile is loaded from device
// memory once for all G heads instead of once per head.
//
// Bound on the H100: at prefill lengths the work is 4*S*S/2*H*Dh flops
// against O(S*H*Dh) bytes, far above the card's ridge, so operations
// bound it. This first version runs them as scalar fp32 FMAs out of
// shared memory (the tensor cores, wgmma and TMA are later work), which
// caps it near the 67 TFLOP/s fp32 rate rather than the 989 TFLOP/s bf16
// tensor-core rate its bound is taken against.
//
// Block: 256 threads as a 16x16 grid (ty, tx). Packed rows r = i*G + g
// (query position q0+i, head kvh*G+g), R = bq*G <= 128. Per KV tile of
// BK = 32 or 64 keys (64 by default):
//   * K and V rows are staged in shared memory as fp32 (K rows padded by
//     4 floats so the float4 row reads of a warp spread over the banks);
//   * scores: thread (ty, tx) computes rows ty+16i (i < 8) x keys tx+16j
//     (j < BK/16), float4 along DH; masked keys (causal, window, past S) get
//     -inf, so they weigh exactly 0;
//   * online softmax: one warp per row, fp32 running max m and sum l;
//   * values: thread (ty, tx) owns rows ty+16i x output columns tx+16j
//     (j < DH/16) of the fp32 accumulator, in registers.
// The tile range is the reference's causal and window block skip made
// exact: keys [max(0, q_lo-window+1), q_hi] (causal) are the only ones
// loaded. The output is acc / max(l, 1e-30), written in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAXR = 128;        // packed query rows per block
constexpr int RPT = MAXR / 16;   // rows per thread
constexpr float kNegInit = -1e30f;

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;    // elements in 16 bytes
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  __device__ static float out(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

// shared memory, in floats: q (MAXR x DH+4) | k (BK x DH+4) | v (BK x DH)
// | p (MAXR x BK+4) | m, l, alpha (MAXR each)
template <int DH, int BK>
__host__ __device__ constexpr size_t smem_floats() {
  return size_t(MAXR) * (DH + 4) + size_t(BK) * (DH + 4) + size_t(BK) * DH +
         size_t(MAXR) * (BK + 4) + 3 * size_t(MAXR);
}

// Stage a KV tile: BK rows of DH elements, row r at src + r * stride, into
// shared memory as fp32 rows of `dst_stride` floats. Rows past `valid` are
// zero-filled without a read, so masked keys add exactly 0 to the values.
template <typename T, int DH, int BK>
__device__ void stage_tile(const T* __restrict__ src, long long stride, int valid,
                           float* dst, int dst_stride, int t) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = DH / VEC;
  for (int i = t; i < BK * VPR; i += NT) {
    const int r = i / VPR, c = i - r * VPR;
    float f[VEC];
    if (r < valid) {
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(src + r * stride + c * VEC), f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
    float* d = dst + r * dst_stride + c * VEC;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int S,
                 long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                 long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss, int bq, int causal, int window, float scale) {
  constexpr int QSTR = DH + 4, KSTR = DH + 4, PSTR = BK + 4;
  constexpr int CO = DH / 16;      // output columns per thread
  constexpr int CPT = BK / 16;     // score columns per thread
  // the longest query tiles (most keys under the causal mask) go first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int warp = t / 32, lane = t % 32;
  const int G = H / Hkv, R = bq * G;
  const int q0 = qt * bq;
  const int q_hi = min(q0 + bq, S) - 1;

  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;
  float* k_s = q_s + MAXR * QSTR;
  float* v_s = k_s + BK * KSTR;
  float* p_s = v_s + BK * DH;
  float* m_s = p_s + MAXR * PSTR;
  float* l_s = m_s + MAXR;
  float* a_s = l_s + MAXR;

  // packed query rows, scaled; rows past R or past S are zero
  {
    constexpr int VEC = Vec<T>::N, VPR = DH / VEC;
    for (int idx = t; idx < MAXR * VPR; idx += NT) {
      const int r = idx / VPR, c = idx - r * VPR;
      const int i = r / G, g = r - i * G;
      float f[VEC];
      if (r < R && q0 + i < S) {
        const T* src = q + b * q_sb + (kvh * G + g) * q_sh + (q0 + i) * q_ss + c * VEC;
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(src), f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
      float* d = q_s + r * QSTR + c * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(
            f[e] * scale, f[e + 1] * scale, f[e + 2] * scale, f[e + 3] * scale);
    }
  }
  for (int r = t; r < MAXR; r += NT) {
    m_s[r] = kNegInit;
    l_s[r] = 0.f;
  }
  float acc[RPT][CO];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;

  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_hi + 1 : S;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  __syncthreads();

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    const int n = min(BK, k_end - t0);
    stage_tile<T, DH, BK>(kb + t0 * k_ss, k_ss, n, k_s, KSTR, t);
    stage_tile<T, DH, BK>(vb + t0 * v_ss, v_ss, n, v_s, DH, t);
    __syncthreads();

    // scores of rows ty+16i against keys tx+16j
    {
      float sc[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
      for (int d = 0; d < DH; d += 4) {
        float4 qv[RPT], kv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QSTR + d);
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * KSTR + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            sc[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                        qv[i].w * kv[j].w;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + 16 * i;
        const int qp = q0 + r / G;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 16 * j, kp = t0 + c;
          const bool live = c < n && (!causal || kp <= qp) &&
                            (window <= 0 || kp > qp - window);
          p_s[r * PSTR + c] = live ? sc[i][j] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per packed row
    for (int r = warp; r < R; r += NT / 32) {
      float* pr = p_s + r * PSTR;
      float mx = -INFINITY;
#pragma unroll
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = lane; c < BK; c += 32) {
        const float e = expf(pr[c] - m_new);
        pr[c] = e;
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

    // values: rows ty+16i x output columns tx+16j
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BK; c += 4) {
      float vv[4][CO];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < CO; ++j) vv[e][j] = v_s[(c + e) * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * PSTR + c);
#pragma unroll
        for (int j = 0; j < CO; ++j)
          acc[i][j] += p.x * vv[0][j] + p.y * vv[1][j] + p.z * vv[2][j] + p.w * vv[3][j];
      }
    }
    __syncthreads();
  }

  // o (B, H, S, DH), contiguous
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    const int qi = r / G, g = r - qi * G;
    if (r < R && q0 + qi < S) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      T* dst = o + ((size_t(b) * H + kvh * G + g) * S + q0 + qi) * DH;
#pragma unroll
      for (int j = 0; j < CO; ++j) dst[tx + 16 * j] = Vec<T>::out(acc[i][j] * inv);
    }
  }
}

template <typename T, int DH, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int S, const long long* st, int bq, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DH, BK>;
  const size_t shm = sizeof(float) * smem_floats<DH, BK>();
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shm));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const dim3 grid((S + bq - 1) / bq, Hkv, B);
  kern<<<grid, NT, shm, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], bq, causal, window, scale);
  return int(cudaGetLastError());
}

template <typename T, int BK>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int B, int H,
              int Hkv, int S, const long long* st, int bq, int causal, int window,
              float scale, cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch<T, 32, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                               stream);
    case 64:
      return launch<T, 64, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                               stream);
    case 128:
      return launch<T, 128, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                                stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bk(int bk, int Dh, const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int S, const long long* st, int bq, int causal, int window,
              float scale, cudaStream_t stream) {
  if (bk == 32)
    return launch_dh<T, 32>(Dh, q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                            stream);
  if (bk == 64)
    return launch_dh<T, 64>(Dh, q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                            stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, H, S, Dh), k and v (B, Hkv, S, Dh), each with its own batch, head
// and sequence strides (in elements, 9 in all: q, k, v) and unit stride
// along Dh; o (B, H, S, Dh) contiguous. dtype: 0 = float32, 1 = bfloat16.
// bq query positions per block, bq * H / Hkv <= 128; bk keys per tile, 32
// or 64. window <= 0 means no window. Returns a CUDA error code (0 on
// success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int H, int Hkv, int S, int Dh, const long long* strides,
                        int bq, int bk, int causal, int window, float scale,
                        void* stream) {
  if (bq < 1 || bq * (H / Hkv) > MAXR) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bk<float>(bk, Dh, q, k, v, o, B, H, Hkv, S, strides, bq, causal, window,
                            scale, st);
  if (dtype == 1)
    return launch_bk<__nv_bfloat16>(bk, Dh, q, k, v, o, B, H, Hkv, S, strides, bq, causal,
                                    window, scale, st);
  return int(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
