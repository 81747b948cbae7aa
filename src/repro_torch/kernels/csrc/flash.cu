// Causal (optionally windowed) GQA flash-attention forward for Hopper
// (sm_90a), the G = H / Hkv query heads of a KV head packed into one tile.
//
// Replaces the Pallas TPU kernel repro/kernels/attention/flash.py:
// flash_attention (body _flash_kernel, pl.pallas_call at :115). The TPU
// grid (B, H, nq, nk) runs its KV axis innermost and in order, carrying
// (m, l, acc) in VMEM scratch from one grid step to the next. Blocks on
// Hopper run in parallel and carry nothing, so the KV axis becomes a loop
// inside one block per (query tile, KV head, batch row), and the G query
// heads that share a KV head are packed into that block: each K/V tile is
// loaded once for all G heads instead of once per head. Packed rows r =
// i*G + g (query position q0+i, head kvh*G+g), R = bq*G <= 128. The tile
// range is the reference's causal and window block skip made exact: keys
// [max(0, q0-window+1), q_hi] (causal) are the only ones loaded. Masked
// keys (causal, window, past S) get -inf and weigh exactly 0. The output
// is acc / max(l, 1e-30), written in q's dtype.
//
// Bound on the H100: at prefill lengths the work is 4*S*S/2*H*Dh flops
// against O(S*H*Dh) bytes, far above the card's ridge, so the tensor
// cores' 989 TFLOP/s bound it (34.76 us at yi-9b's heads, B=1, S=2048;
// 17.38 us at gemma3-4b's). Two bodies:
//
// bf16 (the served dtype): warp-specialised, on Hopper's own instructions.
// A block is three warpgroups and one block an SM. Warpgroup 2 is the
// producer: after setmaxnreg gives its registers away (40 a thread), one
// of its threads loads the 128 packed query rows once and keeps K and V
// tiles of BK keys in flight by TMA (cp.async.bulk.tensor, a 4-D map of
// (Dh, heads, S, B) over the views' own strides, built on the host each
// call) into two K and two V stages, completing on mbarriers (full: the
// bytes landed; empty: both consumers are done). Keys and query rows past
// S are zero-filled by the copy. Warpgroups 0 and 1 are the consumers
// (232 registers a thread), each owning 64 packed rows. S = Q K^T is a
// wgmma with both operands in shared memory (K-major, 128-byte swizzle,
// which the TMA boxes of 64 columns write; 64-byte at Dh = 32), fp32
// accumulators; the online softmax (running max and sum, fp32, base-2
// exponent by ex2.approx, the scale folded in) works on the accumulator
// fragments, both rows of a thread at once over 4 partial maxima and sums,
// so that no chain of dependent operations runs the length of the tile,
// with the masking in a branch of its own for the tiles the causal or
// window edge crosses, so that the others evaluate no mask; P goes to O += P V as the register A operand of a wgmma
// whose B is V in shared memory, read MN-major, one product per 64
// output columns, and O is rescaled only where a row's max moved. P goes
// once, in bf16: the hi/lo pair of the earlier body (1.5x the tensor
// work) is dropped, since the output's own bf16 rounding dominates the
// error and the 2^-6 bf16 budget holds without it
// (tests/test_torch_flash.py models both roundings). A consumer overlaps
// tile j's softmax with tile j - 1's value products: it issues tile j's
// scores and tile j - 1's values, waits for the scores alone, runs the
// softmax while the values run on the tensor cores, then rescales O. The
// two consumers take turns to issue (named barriers), so that one's
// softmax runs while the other's products hold the tensor cores.
//
// Balance. A causal call's query tiles differ in key range up to S / BK
// tiles, and at gemma3-4b's heads (B=1, S=2048) the 128 blocks of one
// wave would wait on the longest. So the host plans the blocks
// (flash.py:block_plan): the longest tiles, where that shortens a
// modelled greedy schedule, run as two blocks of half their key tiles
// each, the half that finishes second merging the first's (o, m, l) by
// log-sum-exp in a fixed order (bit-identical from run to run), and
// blocks go out longest first across every KV head and batch row, in
// the order the host lists. Shared memory: the 128 query rows and four
// tiles (160 KB at Dh = 128 and 128-key tiles; 192 KB at Dh = 256 and
// 64-key tiles, the largest that fit there). No instance spills.
//
// fp32: the scalar body. The tensor cores would run fp32 as TF32, whose
// 10-bit mantissa fails the 1e-4 that the fp32 path is held to, so fp32
// keeps scalar fp32 FMAs out of shared memory (256 threads as a 16x16
// grid; per 32- or 64-key tile: K and V staged as fp32, scores, a warp a
// row for the online softmax, the values into a register accumulator),
// capped near the 67 TFLOP/s fp32 rate. At Dh=256 only 32-key tiles fit
// (214 KB of shared memory; 64-key tiles would need 294 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async.cuh"
#include "wgmma.cuh"

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
// bf16: the warp-specialised wgmma body
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                 // threads a warpgroup
constexpr int kBf16Threads = 3 * kWG;    // consumers: warpgroups 0 and 1; producer: 2
constexpr int kProducerRegs = 40;        // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;       // 128 * 40 + 256 * 232 <= 65536

// Shared memory of the bf16 body, every region 1024-byte aligned: the 128
// packed query rows, then the K and the V stages of BK keys. A row of
// DH bf16 is cut into column blocks of CB = SWB / 2 columns, one swizzled
// SWB-byte row each (SWB = 128, or 64 at DH = 32), each block its own
// region: what a TMA box of CB columns writes, and what a wgmma
// descriptor with that swizzle reads.
template <int DH, int BK>
struct Bf16Geom {
  static constexpr int SWB = DH >= 64 ? 128 : 64;
  static constexpr int CB = SWB / 2;
  static constexpr int NCB = DH / CB;
  static constexpr int KPB = SWB / 32;           // 16-deep steps of K a column block
  static constexpr unsigned SWIZZLE = SWB == 128 ? 1 : 2;   // the descriptor's code
  static constexpr int Q_BYTES = MAXR * DH * 2;
  static constexpr int TILE_BYTES = BK * DH * 2;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  // K and V stages each (three, where they fit, ran no faster on the H100)
  static constexpr int STAGES = 2;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr size_t SMEM = BAR_OFF + 128 + 1024;   // barriers; alignment slack
};

// 2^x by the special function unit (ex2.approx, flush to zero: 2^-22
// relative), without exp2f's handling of results below the normal range.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sync the 128 threads of consumer warpgroup wg (named barriers 1 and 2;
// barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The partial result of half an item, one consumer warpgroup's: thread
// tw's accumulators in its own fragment order, then its rows' m and l, as
// float4s [i][tw] (coalesced).
template <int DH>
__host__ __device__ constexpr int part_float4s() {
  return (DH / 8 + 1) * kWG;
}

// One block an SM: 3 warpgroups, up to 197 KB of shared memory.
//
// A block is one (query tile, KV head, batch row), or half of one: the
// query tiles from qs on are split in two halves of their key tiles, each
// half a block. Blocks go out in groups of Hkv * B (every KV head and
// batch row of one tile or half), the groups in the host's `order`, each
// entry qt * 3 + half + 1 (half -1 for a whole tile), longest first: the
// block scheduler hands blocks to the SMs that free first in that order.
// Each consumer warpgroup of the half that finishes first publishes its
// (o, m, l) in `part` and flags it in `flags` (2 ints: arrivals,
// published); the other merges them by log-sum-exp, writes the output and
// sets both back to 0, so the next call needs no memset.
template <int DH, int BK>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  const int* __restrict__ order, float4* __restrict__ part,
                  int* __restrict__ flags, int H, int Hkv, int S, int B, int bq, int qs,
                  int causal, int window, float scale) {
  using Geo = Bf16Geom<DH, BK>;
  constexpr int SWB = Geo::SWB, CB = Geo::CB, NCB = Geo::NCB, KPB = Geo::KPB;
  const int per = Hkv * B;
  const int code = order[static_cast<int>(blockIdx.x) / per];
  const int qt = code / 3, half = code % 3 - 1;   // half -1: a whole tile
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int kvh = rem % Hkv, b = rem / Hkv;
  const int pair = (qt - qs) * per + rem;   // a split tile's index
  const int G = H / Hkv, R = bq * G;
  const int q0 = qt * bq;
  const int q_hi = min(q0 + bq, S) - 1;
  const int k_end = causal ? q_hi + 1 : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int all_tiles = (k_end - k_first + BK - 1) / BK;
  // this block's key tiles: all, or a half
  const int j0 = half == 1 ? all_tiles / 2 : 0;
  const int n_tiles = half == 0 ? all_tiles / 2 : all_tiles - j0;
  const int k_begin = k_first + j0 * BK;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* q_s = sm;
  unsigned char* k_s = sm + Geo::K_OFF;
  unsigned char* v_s = sm + Geo::V_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + Geo::BAR_OFF);
  constexpr int NS = Geo::STAGES;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;        // [NS]: the stage's tile has landed
  uint64_t* v_full = k_full + NS;
  uint64_t* k_empty = v_full + NS;    // [NS]: both consumers are done with it
  uint64_t* v_empty = k_empty + NS;

  const int t = threadIdx.x, wg = t / kWG;
  if (t == 0) {
    mbar_init(q_full);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&k_full[s]);
      mbar_init(&v_full[s]);
      mbar_init(&k_empty[s], 2);
      mbar_init(&v_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the K and V stages filled by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == 2 * kWG) {
      // the G heads of bq positions: box (CB, G, bq) lands as packed rows
      // r = i * G + g; rows past S are zero-filled
      mbar_expect(q_full, R * DH * 2);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tensor_load_4d(q_s + cb * MAXR * SWB, &tq, cb * CB, kvh * G, q0, b, q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS, t0 = k_begin + j * BK;
        const unsigned par = ((j / NS) & 1) ^ 1;   // the first round finds the stage free
        mbar_wait(&k_empty[s], par);
        mbar_expect(&k_full[s], Geo::TILE_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tensor_load_4d(k_s + s * Geo::TILE_BYTES + cb * BK * SWB, &tk, cb * CB, kvh, t0, b,
                         &k_full[s]);
        mbar_wait(&v_empty[s], par);
        mbar_expect(&v_full[s], Geo::TILE_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tensor_load_4d(v_s + s * Geo::TILE_BYTES + cb * BK * SWB, &tv, cb * CB, kvh, t0, b,
                         &v_full[s]);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns packed rows 64 wg .. 64 wg + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tw = t % kWG, warp = tw >> 5, lane = t & 31;
  const int g8 = lane >> 2, tig = lane & 3;
  const int rb = wg * 64;
  const bool lead = tw == 0;   // arrives on the empty barriers for its warpgroup
  if (!(rb < R && q0 + rb / G < S)) {
    // no row of this warpgroup is real: release each stage once it lands
    if (lead)
      for (int j = 0; j < n_tiles; ++j) {
        const unsigned par = (j / NS) & 1;
        mbar_wait(&k_full[j % NS], par);
        mbar_arrive(&k_empty[j % NS]);
        mbar_wait(&v_full[j % NS], par);
        mbar_arrive(&v_empty[j % NS]);
      }
    return;
  }
  // this thread holds rows r0 (h = 0) and r0 + 8 (h = 1) of the tile
  const int r0 = rb + warp * 16 + g8;
  const int qp[2] = {q0 + r0 / G, q0 + (r0 + 8) / G};
  const int wg_lo = q0 + rb / G;                      // its rows' first position
  const int wg_hi = q0 + min(rb + 63, R - 1) / G;    // and last
  const float sl2 = scale * 1.4426950408889634f;     // scores to base-2 exponents

  float sacc[BK / 2];            // S = Q K^T of one tile
  uint32_t pf[BK / 16][4];       // P as the A operand, bf16 pairs
  float oacc[NCB][CB / 2];       // O by column block
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, al[2];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int i = 0; i < CB / 2; ++i) oacc[cb][i] = 0.f;

  // descriptor words: Q's rows of this warpgroup and stage 0 of K (K-major),
  // stage 0 of V (MN-major: column blocks BK rows apart); one hi word
  constexpr uint32_t hi = desc_hi(8 * SWB, Geo::SWIZZLE);
  const uint32_t q_lo = desc_lo(q_s + rb * SWB, 16);
  const uint32_t k_lo = desc_lo(k_s, 16);
  const uint32_t v_lo = desc_lo(v_s, BK * SWB);
  auto issue_scores = [&](int s) {
    const uint32_t qb = opaque(q_lo), kb = opaque(k_lo + s * (Geo::TILE_BYTES >> 4));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int cb = kk / KPB, k32 = (kk % KPB) * 32;
      wgmma_ss<BK>(sacc, desc(qb + ((cb * MAXR * SWB + k32) >> 4), hi),
                   desc(kb + ((cb * BK * SWB + k32) >> 4), hi), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_values = [&](int s) {
    const uint32_t vb = opaque(v_lo + s * (Geo::TILE_BYTES >> 4));
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        wgmma_rs<CB>(oacc[cb], pf[kc], desc(vb + ((cb * BK * SWB + kc * 16 * SWB) >> 4), hi));
    wgmma_commit();
  };
  // mask tile j (only where the causal or window edge or S crosses this
  // warpgroup's rows), then the online softmax on the fragments, the scale
  // folded into the exponent: p = 2^(s * scale * log2(e) - m)
  auto softmax = [&](int j) {
    const int t0 = k_begin + j * BK, n = min(BK, k_end - t0);
    const bool full = n == BK && (!causal || t0 + BK - 1 <= wg_lo) &&
                      (window <= 0 || t0 > wg_hi - window);
    if (!full)   // a branch for the whole tile: the unmasked tiles pay nothing
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + tig * 2 + (e & 1), kp = t0 + c, qpos = qp[e >> 1];
          if (!(c < n && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window)))
            sacc[4 * i + e] = -INFINITY;
        }
    // both rows at once, each over 4 partial maxima and sums, so that no
    // chain of dependent operations runs the length of the tile
    float mx[2][4], sm[2][4], mn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mx[h][u] = -INFINITY;
        sm[h][u] = 0.f;
      }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1][i & 3] = fmaxf(mx[e >> 1][i & 3], sacc[4 * i + e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      mn[h] = fmaxf(m[h], v * sl2);
      al[h] = mn[h] == m[h] ? 1.f : ex2(m[h] - mn[h]);
      m[h] = mn[h];
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sacc[4 * i + e];
        x = ex2(fmaf(x, sl2, -mn[e >> 1]));
        sm[e >> 1][i & 3] += x;
      }
    // this thread's columns; a quad sums at the end
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * al[h] + ((sm[h][0] + sm[h][1]) + (sm[h][2] + sm[h][3]));
  };
  // P in bf16, one product: the 16 keys of step kc are the 8-column
  // blocks 2 kc and 2 kc + 1 of S
  auto to_p = [&]() {
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      pf[kc][0] = pack_bf16(sacc[8 * kc + 0], sacc[8 * kc + 1]);
      pf[kc][1] = pack_bf16(sacc[8 * kc + 2], sacc[8 * kc + 3]);
      pf[kc][2] = pack_bf16(sacc[8 * kc + 4], sacc[8 * kc + 5]);
      pf[kc][3] = pack_bf16(sacc[8 * kc + 6], sacc[8 * kc + 7]);
    }
  };
  auto fence_scores = [&]() {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) reg_fence(sacc[i]);
  };
  auto fence_values = [&]() {
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) reg_fence(oacc[cb][i]);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(pf[kc][e]);
  };

  // Where both warpgroups hold real rows they take turns to issue their
  // products (named barriers 3 and 4, warpgroup 0 first), so that one's
  // softmax runs while the other's products hold the tensor cores. Each
  // issues at n_tiles + 1 points; warpgroup 1 hands the turn over once
  // before its first and not after its last, so every barrier completes.
  const bool turns = R > 64 && q0 + 64 / G < S;
  auto my_turn = [&]() {
    if (turns) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
  };
  auto your_turn = [&](bool last) {
    if (turns && !(last && wg == 1))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
  };
  if (wg == 1) your_turn(false);

  mbar_wait(q_full, 0);
  mbar_wait(&k_full[0], 0);
  my_turn();
  issue_scores(0);
  your_turn(false);
  wgmma_wait<0>();
  fence_scores();
  if (lead) mbar_arrive(&k_empty[0]);
  softmax(0);
  to_p();
  // tile j's scores run beside tile j - 1's values; tile j's softmax
  // overlaps the values' products on the tensor cores
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % NS, sp = (j - 1) % NS;
    mbar_wait(&k_full[s], (j / NS) & 1);
    mbar_wait(&v_full[sp], ((j - 1) / NS) & 1);
    my_turn();
    issue_scores(s);
    issue_values(sp);
    your_turn(false);
    wgmma_wait<1>();             // the scores are in
    fence_scores();
    if (lead) mbar_arrive(&k_empty[s]);
    softmax(j);
    wgmma_wait<0>();             // and the values
    fence_values();
    if (lead) mbar_arrive(&v_empty[sp]);
    // O to the new running max, where a row of this warp has a new one
    if (__any_sync(0xffffffffu, al[0] != 1.f || al[1] != 1.f))
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int i = 0; i < CB / 2; ++i) oacc[cb][i] *= al[(i >> 1) & 1];
    to_p();
  }
  const int sl = (n_tiles - 1) % NS;
  mbar_wait(&v_full[sl], ((n_tiles - 1) / NS) & 1);
  my_turn();
  issue_values(sl);
  your_turn(true);
  wgmma_wait<0>();
  fence_values();

  // a quad holds a row's partial sums of l
  float lt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lt[h] = l[h];
    lt[h] += __shfl_xor_sync(0xffffffffu, lt[h], 1);
    lt[h] += __shfl_xor_sync(0xffffffffu, lt[h], 2);
  }
  if (half >= 0) {
    // half a split tile: the first of the two to get here publishes its
    // partial result, the second merges it into its own
    __shared__ int ticket[2];
    float4* slot = part + size_t(pair * 2 + wg) * part_float4s<DH>() + tw;
    int* arrived = flags + 4 * pair + 2 * wg;
    int* published = arrived + 1;
    if (lead) ticket[wg] = atomicAdd(arrived, 1);
    wg_sync(wg);
    const int first = ticket[wg] == 0;
    wg_sync(wg);   // every thread has read its ticket before it is reused
    if (first) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
        for (int i = 0; i < CB / 8; ++i)
          slot[(cb * CB / 8 + i) * kWG] = make_float4(oacc[cb][4 * i], oacc[cb][4 * i + 1],
                                                      oacc[cb][4 * i + 2], oacc[cb][4 * i + 3]);
      slot[(DH / 8) * kWG] = make_float4(m[0], m[1], lt[0], lt[1]);
      __threadfence();
      wg_sync(wg);
      if (lead) atomicExch(published, 1);
      return;
    }
    if (lead)
      while (atomicAdd(published, 0) == 0) {
      }
    wg_sync(wg);
    __threadfence();
    // merged in the halves' order, whichever finished first: the output
    // is the same from run to run
    const float4 ml = __ldcg(slot + (DH / 8) * kWG);
    const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
    float a[2], c[2];   // weights of half 0's and half 1's partials
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m0 = half == 0 ? m[h] : mo[h], m1 = half == 0 ? mo[h] : m[h];
      const float l0 = half == 0 ? lt[h] : lo[h], l1 = half == 0 ? lo[h] : lt[h];
      const float mm = fmaxf(m0, m1);
      a[h] = ex2(m0 - mm);
      c[h] = ex2(m1 - mm);
      lt[h] = fmaf(l0, a[h], l1 * c[h]);
    }
    auto merge = [&](float& x, float y, int h) {
      x = half == 0 ? fmaf(x, a[h], y * c[h]) : fmaf(y, a[h], x * c[h]);
    };
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < CB / 8; ++i) {
        const float4 v = __ldcg(slot + (cb * CB / 8 + i) * kWG);
        merge(oacc[cb][4 * i], v.x, 0);
        merge(oacc[cb][4 * i + 1], v.y, 0);
        merge(oacc[cb][4 * i + 2], v.z, 1);
        merge(oacc[cb][4 * i + 3], v.w, 1);
      }
    wg_sync(wg);   // every thread has read the partial
    if (lead) {
      *arrived = 0;
      *published = 0;
    }
  }

  // o (B, H, S, DH), contiguous
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= R || qp[h] >= S) continue;
    const float inv = 1.f / fmaxf(lt[h], 1e-30f);
    const int g = r - (r / G) * G;
    __nv_bfloat16* dst = o + ((size_t(b) * H + kvh * G + g) * S + qp[h]) * DH + tig * 2;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int i = 0; i < CB / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + cb * CB + i * 8) = __floats2bfloat162_rn(
            oacc[cb][4 * i + 2 * h] * inv, oacc[cb][4 * i + 2 * h + 1] * inv);
  }
}

// whether a body is built for (DH, BK): the fp32 body takes 32- and 64-key
// tiles, the bf16 body 32, 64 and 128, each where its shared memory fits
template <typename T, int DH, int BK>
constexpr bool built() {
  if constexpr (sizeof(T) == 4)
    return BK <= 64 && sizeof(float) * smem_floats<DH, BK>() <= kMaxSmem;
  else
    return Bf16Geom<DH, BK>::SMEM <= kMaxSmem;
}

template <int DH, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
               int S, const long long* st, int bq, int causal, int window, float scale,
               cudaStream_t stream) {
  auto kern = flash_f32_kernel<DH, BK>;
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
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], bq, causal, window, scale);
  return int(cudaGetLastError());
}

// A bf16 map of x (B, heads, S, DH) with element strides s3 = (batch,
// head, sequence), dims fastest first (DH, heads, S, B), boxes of (CB,
// box_h, box_s, 1), swizzled as the wgmma descriptors read them, zeros
// outside. A dim of extent 1 takes a stride of DH elements (its stride is
// never used, and the encoder checks it).
template <int DH, int BK>
bool bf16_map(CUtensorMap* map, const void* x, int heads, int S, int B, const long long* s3,
              cuuint32_t box_h, cuuint32_t box_s) {
  using Geo = Bf16Geom<DH, BK>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(DH), cuuint64_t(heads), cuuint64_t(S), cuuint64_t(B)};
  const long long el[3] = {s3[1], s3[2], s3[0]};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = cuuint64_t(dims[i + 1] == 1 ? DH : el[i]) * 2;
  const cuuint32_t box[4] = {cuuint32_t(Geo::CB), box_h, box_s, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            Geo::SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                int S, const long long* st, int bq, int causal, int window, float scale,
                int qs, const int* order, void* part, int* flags, cudaStream_t stream) {
  using Geo = Bf16Geom<DH, BK>;
  CUtensorMap tq, tk, tv;
  if (!bf16_map<DH, BK>(&tq, q, H, S, B, st, H / Hkv, bq) ||
      !bf16_map<DH, BK>(&tk, k, Hkv, S, B, st + 3, 1, BK) ||
      !bf16_map<DH, BK>(&tv, v, Hkv, S, B, st + 6, 1, BK))
    return int(cudaErrorInvalidValue);
  auto kern = flash_bf16_kernel<DH, BK>;
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Geo::SMEM));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const long long n_qt = (S + bq - 1) / bq, per = static_cast<long long>(Hkv) * B;
  if (qs < 0 || qs > n_qt || order == nullptr ||
      (qs < n_qt && (part == nullptr || flags == nullptr)))
    return int(cudaErrorInvalidValue);
  const long long blocks = (2 * (n_qt - qs) + qs) * per;
  if (blocks > 0x7fffffffll) return int(cudaErrorInvalidValue);
  kern<<<unsigned(blocks), kBf16Threads, Geo::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), order, static_cast<float4*>(part), flags,
      H, Hkv, S, B, bq, qs, causal, window, scale);
  return int(cudaGetLastError());
}

template <typename T, int DH, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           const long long* st, int bq, int causal, int window, float scale, int qs,
           const int* order, void* part, int* flags, cudaStream_t stream) {
  if constexpr (!built<T, DH, BK>())
    return int(cudaErrorInvalidValue);
  else if constexpr (sizeof(T) == 4)
    return launch_f32<DH, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale, stream);
  else
    return launch_bf16<DH, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale, qs,
                               order, part, flags, stream);
}

template <typename T, int BK>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* o, int B, int H,
              int Hkv, int S, const long long* st, int bq, int causal, int window,
              float scale, int qs, const int* order, void* part, int* flags,
              cudaStream_t stream) {
  switch (Dh) {
    case 32:
      return launch<T, 32, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                               qs, order, part, flags, stream);
    case 64:
      return launch<T, 64, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                               qs, order, part, flags, stream);
    case 128:
      return launch<T, 128, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                                qs, order, part, flags, stream);
    case 256:
      return launch<T, 256, BK>(q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                                qs, order, part, flags, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bk(int bk, int Dh, const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int S, const long long* st, int bq, int causal, int window,
              float scale, int qs, const int* order, void* part, int* flags,
              cudaStream_t stream) {
  if (bk == 32)
    return launch_dh<T, 32>(Dh, q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                            qs, order, part, flags, stream);
  if (bk == 64)
    return launch_dh<T, 64>(Dh, q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                            qs, order, part, flags, stream);
  if (bk == 128)
    return launch_dh<T, 128>(Dh, q, k, v, o, B, H, Hkv, S, st, bq, causal, window, scale,
                             qs, order, part, flags, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, H, S, Dh), k and v (B, Hkv, S, Dh), each with its own batch, head
// and sequence strides (in elements, 9 in all: q, k, v) and unit stride
// along Dh; o (B, H, S, Dh) contiguous. dtype: 0 = float32, 1 = bfloat16.
// bq query positions per block, bq * H / Hkv <= 128; bk keys per tile, 32
// or 64 (fp32), 32, 64 or 128 (bf16; not 128 at Dh = 256). window <= 0
// means no window. bf16 only: `order` (device memory) lists the launch
// groups, one per query tile not split and two per split one, as
// qt * 3 + half + 1 (half -1 for a whole tile), in launch order; the query
// tiles from split_from on (of ceil(S / bq)) are the split ones, merged
// through `part` (flash_split_floats floats for each, 16-byte aligned)
// and `flags` (4 ints each, zero before the call and left zero by it);
// with split_from = ceil(S / bq) both may be null. Returns a CUDA error
// code (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int H, int Hkv, int S, int Dh, const long long* strides,
                        int bq, int bk, int causal, int window, float scale, int split_from,
                        const int* order, void* part, int* flags, void* stream) {
  if (bq < 1 || bq * (H / Hkv) > MAXR) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bk<float>(bk, Dh, q, k, v, o, B, H, Hkv, S, strides, bq, causal, window,
                            scale, split_from, order, part, flags, st);
  if (dtype == 1)
    return launch_bk<__nv_bfloat16>(bk, Dh, q, k, v, o, B, H, Hkv, S, strides, bq, causal,
                                    window, scale, split_from, order, part, flags, st);
  return int(cudaErrorInvalidValue);
}

// floats of `part` one split tile takes at head dim Dh: two consumer
// warpgroups' partial (o, m, l)
int flash_split_floats(int Dh) {
  return 2 * 4 * (Dh / 8 + 1) * kWG;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
