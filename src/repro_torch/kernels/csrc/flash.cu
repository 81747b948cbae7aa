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
// memory once for all G heads instead of once per head. Packed rows
// r = i*G + g (query position q0+i, head kvh*G+g), R = bq*G <= 128. The
// tile range is the reference's causal and window block skip made exact:
// keys [max(0, q0-window+1), q_hi] (causal) are the only ones loaded.
// Masked keys (causal, window, past S) get -inf and weigh exactly 0. The
// output is acc / max(l, 1e-30), written in q's dtype.
//
// Bound on the H100: at prefill lengths the work is 4*S*S/2*H*Dh flops
// against O(S*H*Dh) bytes, far above the card's ridge, so the tensor
// cores' rate bounds it. Two bodies:
//
// bf16 (the served dtype): both products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands from shared
// memory by ldmatrix (.trans for V), the FlashAttention-2 layout. 8
// warps, each owning 16 packed rows (two 16-row tiles a warp, 4 warps,
// measured no faster). S = Q.K^T stays in registers; the online softmax
// (running max and sum, fp32, base-2 exponent, the scale folded in)
// works on the accumulator fragments with quad shuffles, masking only the tiles the causal or
// window edge crosses; the fragments become P's A operand in registers,
// with no round trip through shared memory. P is carried as a bf16 pair
// hi = bf16(P), lo = bf16(P - hi) and multiplied by V twice, so the value
// product keeps P at fp32 precision (about 2^-16 relative, as the TPU
// kernel's f32 P) at 1.5x the tensor work of one product. The 1/sqrt(Dh)
// scale is applied to the fp32 scores, not to q. K and V stay bf16 in
// shared memory, rows padded by 16 bytes so ldmatrix is free of bank
// conflicts, in a ring of two stages filled by 16-byte cp.async copies:
// tile j+1 loads while tile j is multiplied. Q is loaded once. Shared
// memory is 102 KB at Dh=128 and 64-key tiles (198 KB at Dh=256); one
// block an SM, whose registers then need no spill. At Dh=256 a warp's
// accumulators take 128 of its registers a thread, so Dh=256 keeps the
// same body at up to 255 registers a thread, again one block an SM. Rows
// and keys past S are zero-filled by the copies.
//
// fp32: the scalar body. The tensor cores would run fp32 as TF32, whose
// 10-bit mantissa fails the 1e-4 the fp32 path is held to, so fp32 keeps
// scalar fp32 FMAs out of shared memory (256 threads as a 16x16 grid; per
// 32- or 64-key tile: K and V staged as fp32, scores, a warp a row for the
// online softmax, the values into a register accumulator), capped near
// the 67 TFLOP/s fp32 rate. At Dh=256 only 32-key tiles fit (214 KB of
// shared memory; 64-key tiles would need 294 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAXR = 128;        // packed query rows per block
constexpr int RPT = MAXR / 16;   // rows per thread (fp32 body)
constexpr float kNegInit = -1e30f;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory a block, H100

// ---------------------------------------------------------------------------
// fp32: the scalar body
// ---------------------------------------------------------------------------

// shared memory, in floats: q (MAXR x DH+4) | k (BK x DH+4) | v (BK x DH)
// | p (MAXR x BK+4) | m, l, alpha (MAXR each)
template <int DH, int BK>
__host__ __device__ constexpr size_t smem_floats() {
  return size_t(MAXR) * (DH + 4) + size_t(BK) * (DH + 4) + size_t(BK) * DH +
         size_t(MAXR) * (BK + 4) + 3 * size_t(MAXR);
}

// Stage a KV tile: BK rows of DH floats, row r at src + r * stride, into
// shared memory rows of `dst_stride` floats. Rows past `valid` are
// zero-filled without a read, so masked keys add exactly 0 to the values.
template <int DH, int BK>
__device__ void stage_tile(const float* __restrict__ src, long long stride, int valid,
                           float* dst, int dst_stride, int t) {
  constexpr int VPR = DH / 4;
  for (int i = t; i < BK * VPR; i += NT) {
    const int r = i / VPR, c = i - r * VPR;
    const float4 f = r < valid
        ? *reinterpret_cast<const float4*>(src + r * stride + c * 4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * dst_stride + c * 4) = f;
  }
}

template <int DH, int BK>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int Hkv,
                 int S, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
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
  for (int idx = t; idx < MAXR * DH / 4; idx += NT) {
    const int r = idx / (DH / 4), c = idx - r * (DH / 4);
    const int i = r / G, g = r - i * G;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R && q0 + i < S)
      f = *reinterpret_cast<const float4*>(q + b * q_sb + (kvh * G + g) * q_sh +
                                           (q0 + i) * q_ss + c * 4);
    *reinterpret_cast<float4*>(q_s + r * QSTR + c * 4) =
        make_float4(f.x * scale, f.y * scale, f.z * scale, f.w * scale);
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
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;
  __syncthreads();

  for (int t0 = k_begin; t0 < k_end; t0 += BK) {
    const int n = min(BK, k_end - t0);
    stage_tile<DH, BK>(kb + t0 * k_ss, k_ss, n, k_s, KSTR, t);
    stage_tile<DH, BK>(vb + t0 * v_ss, v_ss, n, v_s, DH, t);
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
      float* dst = o + ((size_t(b) * H + kvh * G + g) * S + q0 + qi) * DH;
#pragma unroll
      for (int j = 0; j < CO; ++j) dst[tx + 16 * j] = acc[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------

// shared memory, in bf16 elements: q (MAXR rows) | k (2 stages of BK
// rows) | v (2 stages of BK rows), every row DH + 8 elements long. Three
// or four stages ran no faster on the H100, where the body is bound by
// the latency of its own math, not by its loads.
template <int DH, int BK>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t(MAXR) + 4 * size_t(BK)) * (DH + 8);
}

// One block an SM: the body then keeps its ~190 registers a thread with no
// spill, which ran faster on the H100 than two blocks an SM held to 128
// registers (and spilling) at Dh=128.
template <int DH, int BK>
__global__ void __launch_bounds__(NT, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  int H, int Hkv, int S, long long q_sb, long long q_sh, long long q_ss,
                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                  long long v_sh, long long v_ss, int bq, int causal, int window,
                  float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int STR = DH + 8;      // shared-memory row, in elements
  constexpr int CPR = DH / 8;      // 16-byte chunks a row
  constexpr int NB = BK / 8;       // score fragments of 8 keys
  constexpr int ND = DH / 8;       // output fragments of 8 columns
  static_assert(NT / 32 * 16 == MAXR, "a warp a 16-row tile covers the packed rows");
  // the longest query tiles (most keys under the causal mask) go first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int G = H / Hkv, R = bq * G;
  const int q0 = qt * bq;
  const int q_hi = min(q0 + bq, S) - 1;
  const float sl2 = scale * 1.4426950408889634f;   // scores to base-2 exponents

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + MAXR * STR;
  bf16* v_s = k_s + 2 * BK * STR;

  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_hi + 1 : S;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  // issue tile j's K and V rows into stage j % 2; keys past k_end are
  // zero-filled, so their (masked) weights multiply zeros
  auto load_tile = [&](int j) {
    const int t0 = k_begin + j * BK, n = min(BK, k_end - t0);
    bf16* ks = k_s + (j & 1) * BK * STR;
    bf16* vs = v_s + (j & 1) * BK * STR;
    for (int i = t; i < BK * CPR; i += NT) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const bool ok = r < n;
      const long long row = ok ? t0 + r : 0;
      cp16(ks + r * STR + c, kb + row * k_ss + c, ok);
      cp16(vs + r * STR + c, vb + row * v_ss + c, ok);
    }
  };

  // packed query rows, once; rows past R or past S are zero
  for (int i = t; i < MAXR * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    const int qi = r / G, g = r - qi * G;
    const bool ok = r < R && q0 + qi < S;
    const bf16* src = ok ? q + b * q_sb + (kvh * G + g) * q_sh + (q0 + qi) * q_ss + c : q;
    cp16(q_s + r * STR + c, src, ok);
  }
  load_tile(0);
  cp_commit();

  // warp w owns packed rows 16w..16w+15; this thread holds rows 16w +
  // lane/4 (h = 0) and that + 8 (h = 1), columns 2*(lane%4) + {0, 1} of
  // every fragment
  const bool active = warp * 16 < R;
  const int g8 = lane >> 2, tig = lane & 3;
  int qp[2];
  float m[2], l[2];
  float acc[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qp[h] = q0 + (warp * 16 + g8 + 8 * h) / G;
    m[h] = kNegInit;
    l[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<0>();
    __syncthreads();             // tile j is in; stage (j + 1) % 2 is free
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_commit();
    if (!active) continue;
    const int t0 = k_begin + j * BK, n = min(BK, k_end - t0);
    const bf16* ks = k_s + (j & 1) * BK * STR;
    const bf16* vs = v_s + (j & 1) * BK * STR;

    // S = Q K^T, fp32 in registers
    float sc[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + kk * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + (nb * 8 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[nb], a, bb[0], bb[1]);
        mma_bf16(sc[nb + 1], a, bb[2], bb[3]);
      }
    }

    // mask (only the tiles the causal or window edge crosses, or past
    // k_end), then the online softmax on the fragments, the scale folded
    // into the exponent: p = 2^(s * scale * log2(e) - m)
    const bool full = n == BK && (!causal || t0 + BK - 1 <= q0) &&
                      (window <= 0 || t0 > q_hi - window);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = i * 8 + tig * 2 + e, kp = t0 + c;
          if (!full && !(c < n && (!causal || kp <= qp[h]) &&
                         (window <= 0 || kp > qp[h] - window)))
            sc[i][2 * h + e] = -INFINITY;
          mx = fmaxf(mx, sc[i][2 * h + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx * sl2);
      const float al = exp2f(m[h] - mn);
      m[h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[i][2 * h + e] = exp2f(fmaf(sc[i][2 * h + e], sl2, -mn));
          sum += sc[i][2 * h + e];
        }
      }
      l[h] = l[h] * al + sum;    // this thread's columns; a quad sums at the end
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][2 * h] *= al;
        acc[i][2 * h + 1] *= al;
      }
    }

    // O += P V, P as the bf16 pair hi + lo straight from the S fragments
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
      split_bf16(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
      split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                              nd * 8 + (lane >> 4) * 8);
        mma_bf16(acc[nd], ph, bb[0], bb[1]);
        mma_bf16(acc[nd], pl, bb[0], bb[1]);
        mma_bf16(acc[nd + 1], ph, bb[2], bb[3]);
        mma_bf16(acc[nd + 1], pl, bb[2], bb[3]);
      }
    }
  }
  if (!active) return;

  // o (B, H, S, DH), contiguous; a quad holds a row's partial sums of l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = warp * 16 + g8 + 8 * h;
    if (r >= R || qp[h] >= S) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int g = r - (r / G) * G;
    bf16* dst = o + ((size_t(b) * H + kvh * G + g) * S + qp[h]) * DH + tig * 2;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + i * 8) =
          __floats2bfloat162_rn(acc[i][2 * h] * inv, acc[i][2 * h + 1] * inv);
  }
}

// the body and its shared memory for each dtype
template <typename T, int DH, int BK> struct Body;

template <int DH, int BK> struct Body<float, DH, BK> {
  static constexpr auto kern = flash_f32_kernel<DH, BK>;
  static constexpr size_t smem = sizeof(float) * smem_floats<DH, BK>();
};

template <int DH, int BK> struct Body<__nv_bfloat16, DH, BK> {
  static constexpr auto kern = flash_bf16_kernel<DH, BK>;
  static constexpr size_t smem = bf16_smem_bytes<DH, BK>();
};

template <typename T, int DH, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int S, const long long* st, int bq, int causal, int window, float scale,
           cudaStream_t stream) {
  auto kern = Body<T, DH, BK>::kern;
  const size_t shm = Body<T, DH, BK>::smem;
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
    case 256:
      // built only where the tile fits shared memory (not fp32 at BK=64)
      if constexpr (sizeof(T) == 2 || sizeof(float) * smem_floats<256, BK>() <= kMaxSmem)
        return launch<T, 256, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                                  stream);
      else
        return int(cudaErrorInvalidValue);
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
