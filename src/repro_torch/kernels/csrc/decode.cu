// Split-KV flash decode for Hopper (sm_90a), GQA heads packed per KV head,
// over a dense slot cache or a paged KV pool.
//
// Replaces the Pallas TPU kernels repro/kernels/attention/decode.py:
// flash_decode (body _decode_kernel) and flash_decode_paged (body
// _paged_decode_kernel). One kernel body serves both, templated on its
// row-addressing rule (PAGED); the load, score, softmax and value code is
// shared. One thread block per (kv_head, row group, split, batch row). The TPU
// grid's sequential KV dimension becomes a loop inside the block over the
// split's live rows: the block reads pos[b] itself (the TPU kernel's
// scalar prefetch) and visits only rows in [max(split_lo, pos-window+1),
// min(split_hi, bound, pos+Sq)), so rows past the last query position,
// rows before the sliding window and rows past the occupancy bound are
// never read. The cache is taken whole, with explicit batch and sequence
// strides: no copy or padding of the horizon is ever made.
//
// The split combine (the TPU wrappers' combine_splits, which XLA fuses into
// the same program) is fused here too, so one launch returns the finished
// (B, Sq, H, DH) output in q's dtype. Each block writes its fp32 partial
// (o, m, l) to scratch, fences, and counts itself on the counter of its
// (KV head, row group, slot); the block that takes the count to n_splits
// reads every split's partials of its rows from L2, in split order 0 ..
// S-1 (so the output is bit-identical from run to run, whatever order the
// blocks finish in), merges them by log-sum-exp as combine_splits does,
// writes the output, and sets the counter back to 0, so the next call (or
// a graph replay) needs no memset. A split with no live row writes m = -1e30, l = 0, o = 0
// and weighs exactly zero in the merge; every block reaches the counter.
// With one split the block writes the output itself and touches neither
// scratch nor counter (but the fp32 body at DH = 256, whose registers are
// full, writes its partials and merges them back even then). Called
// without an output the kernel writes the partials alone (the split-level
// checks use that).
//
// Bound on the H100: device-memory bytes. Each KV row is read once and
// used by all G*Sq query rows of its KV head, far below the card's ridge.
// At the served shape the grid is only ~1.2 blocks an SM and most splits
// cover one 128-row block, so the time is the latency of a block's loads
// and of its math, and the design keeps many bytes in flight (Little's
// law asks ~2 MB across the card at 3.35 TB/s) and little math in the
// way. 8 warps a block; every 16-byte chunk of a pass's K and V rows is
// issued at once as a cp.async copy before the block waits on any. Two
// bodies:
//
// bf16 (the served dtype): a pass is 128 keys (64 KB of K and V at
// DH=128, a whole split at the served shape), one 16-key chunk a warp.
// Each warp runs its own online softmax over its chunks with both
// products on the tensor cores (mma.sync.m16n8k16, fp32 accumulators),
// FlashAttention-2 style: q is loaded unscaled in bf16, so the products
// are exact, and the scale goes on the fp32 scores; P is carried as the
// bf16 pair hi + lo into the value product, so it keeps fp32 precision.
// The warps' (m, l, acc) are merged once, at the end of the split,
// through shared memory where K and V were. Up to 16 packed rows share
// one row block of the mma tiles (R <= 16); R <= 32 takes two, each
// served by 4 warps.
//
// Packed rows past 32 (G * Sq > 32, e.g. G = 16 at Sq = 4): the grid's x
// dimension runs over (KV head, group of 32 packed rows), and each group's
// block reads its split's K and V rows itself. A call of at most 32
// packed rows is one group, so the served shape (G * Sq = 8) is
// unchanged; wider calls pay one more read of the rows a group.
//
// Head dims 32, 64, 128 and 256. At DH <= 128 both bodies run two blocks
// an SM. At DH = 256 a bf16 warp keeps 16 rows x 256 fp32 accumulators
// (128 registers a thread) and the fp32 body 32 rows' state a thread, so
// both take one block an SM (up to 255 registers a thread, no spill);
// their shared memory (150 KB bf16, 168 KB fp32) fits one block an SM in
// any case.
//
// fp32: the tensor cores would round fp32 to TF32, so the arithmetic
// stays on the CUDA cores: 32-key tiles in a two-stage ring (the next
// tile loads while this one is scored); scores with warp w taking 4 keys
// of the tile, 8 lanes a key splitting DH (reduced by shuffles), each warp
// keeping its own max and sum per row; values with thread t owning output
// column t % DH of every (NT/DH)-th packed row, merging the warps' states
// once a tile by the factors exp(m_w - m_new). Two barriers a tile.
//
// Paged pool. On the TPU the KV block equals the page and a BlockSpec
// index map fetches one page per grid step. Here a pass or tile spans
// many pages: the thread that copies a row looks up its
// physical page (table[b, row / page], clipped into [0, P-1] as the TPU
// wrapper's jnp.clip does) and takes the copy's source from it, so any
// page size works. Masking stays in logical row coordinates, so the block
// still visits only the live rows: table columns past pos (dead, or
// garbage page ids) are never read, and out-of-order tables cost nothing
// but scattered row loads. The paged kernel reads bound/page table
// columns at most (4 bytes each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async.cuh"

namespace {

constexpr float kNegInit = -1e30f;   // running max of a row with no live key

constexpr int NT = 256;              // threads per block
constexpr int NW = NT / 32;          // warps per block

// Row addressing. Dense cache (B, S, Hkv, DH): row `row` of slot b sits
// at b * s0 + row * s1 elements (batch and sequence strides). Paged pool
// (P, page, Hkv, DH): logical row `row` of slot b sits in physical page
// p = table[b, row / page], clipped into [0, n_pages - 1] as the TPU
// wrapper's jnp.clip does, at p * s0 + (row % page) * s1 (page and row
// strides). The dense instantiation reads no table.
__device__ __forceinline__ int page_at(int col, int b, const int* __restrict__ table,
                                       int t_stride, int n_pages) {
  return min(max(__ldg(table + size_t(b) * t_stride + col), 0), n_pages - 1);
}

// offset of a row in elements: `in_page` is its row within `page` (paged)
template <bool PAGED>
__device__ __forceinline__ long long row_offset(int row, int page, int in_page, int b,
                                                long long s0, long long s1) {
  if constexpr (PAGED) return page * s0 + in_page * s1;
  return b * s0 + row * s1;
}

// Store output elements in q's dtype: fp32 as is, bf16 rounded to nearest
// even, as torch's .to(torch.bfloat16) rounds; one element, or four
// consecutive ones (16-byte aligned in fp32, 8-byte in bf16).
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_out4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store_out4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

// splits whose partials the merge loads at once, predicated
constexpr int MERGE_CHUNK = 8;

// The fused split combine, run by every block of a call with an output
// once its partials are written (all NT threads, no block returns
// before). The block that counts last on the counter of its (KV head, row
// group, slot) merges packed rows r0 .. r0 + R - 1 of KV head kvh in slot
// b over all S = gridDim.y splits, as combine_splits does: m_max = max_s
// m_s, w_s = exp(m_s - m_max), o = sum_s w_s o_s / max(sum_s w_s l_s,
// 1e-30), summed in split order. With one split the block is the last
// without a counter. The partials are read with __ldcg (L2, never a stale
// L1 line). The merge is a chain of L2 round trips after the block's own
// work, so each step issues all its loads at once: a thread a 4-column
// slice (a float4 of o) loads m, l and o of MERGE_CHUNK splits before it
// sums them. Up to MERGE_CHUNK splits it takes m_max from the m it loaded
// (one round trip in all: the served shape's 8 rows of 128 are one slice
// a thread); past that a thread a row first takes each row's m_max into
// `mx_s`, R floats of shared memory no thread reads any more. It runs
// after the body's accumulators are dead, so it adds no register to the
// key loop.
template <int DH, typename T>
__device__ __forceinline__ void merge_if_last(const float* __restrict__ o_part,
                                              const float* __restrict__ m_part,
                                              const float* __restrict__ l_part,
                                              T* __restrict__ out, int* __restrict__ counters,
                                              float* mx_s, int B, int Sq, int H, int G,
                                              int kvh, int r0, int R, int b) {
  constexpr int V4 = DH / 4;         // 4-column slices of a row
  __shared__ int last_s;
  const int t = threadIdx.x, S = gridDim.y;
  // The cooperative-groups grid barrier's pattern: after the block
  // barrier, one thread's fence is cumulative over every partial the block
  // wrote (all threads fencing cost more on the card), then the count; the
  // last block's second fence orders its loads after the other blocks'
  // partials.
  __syncthreads();
  if (t == 0 && S == 1) {
    last_s = true;
  } else if (t == 0) {
    __threadfence();
    int* cnt = counters + size_t(b) * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(cnt, 1) == S - 1;
    if (last) *cnt = 0;              // every block of its counter has counted
    __threadfence();
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  const size_t rows = size_t(B) * Sq * H;   // rows of one split's partials
  const bool one_chunk = S <= MERGE_CHUNK;
  if (!one_chunk && t < R) {
    const int j = (r0 + t) / G, g = r0 + t - j * G;
    const float* mp = m_part + (size_t(b) * Sq + j) * H + kvh * G + g;
    float mx = -INFINITY;
    for (int s0 = 0; s0 < S; s0 += MERGE_CHUNK) {
      float mv[MERGE_CHUNK];
#pragma unroll
      for (int u = 0; u < MERGE_CHUNK; ++u)
        mv[u] = s0 + u < S ? __ldcg(mp + (s0 + u) * rows) : -INFINITY;
#pragma unroll
      for (int u = 0; u < MERGE_CHUNK; ++u) mx = fmaxf(mx, mv[u]);
    }
    mx_s[t] = mx;
  }
  if (!one_chunk) __syncthreads();
  for (int i = t; i < R * V4; i += NT) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const size_t base = (size_t(b) * Sq + j) * H + kvh * G + g;
    float mx = one_chunk ? -INFINITY : mx_s[r];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int s0 = 0; s0 < S; s0 += MERGE_CHUNK) {
      float mv[MERGE_CHUNK], lv[MERGE_CHUNK];
      float4 ov[MERGE_CHUNK];
#pragma unroll
      for (int u = 0; u < MERGE_CHUNK; ++u) {
        const size_t row = (s0 + u) * rows + base;
        const bool ok = s0 + u < S;
        mv[u] = ok ? __ldcg(m_part + row) : 0.f;
        lv[u] = ok ? __ldcg(l_part + row) : 0.f;
        ov[u] = ok ? __ldcg(reinterpret_cast<const float4*>(o_part + row * DH + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (one_chunk) {
#pragma unroll
        for (int u = 0; u < MERGE_CHUNK; ++u)
          if (u < S) mx = fmaxf(mx, mv[u]);
      }
#pragma unroll
      for (int u = 0; u < MERGE_CHUNK; ++u) {
        if (s0 + u >= S) break;
        const float w = expf(mv[u] - mx);
        l += lv[u] * w;
        o.x += ov[u].x * w;
        o.y += ov[u].y * w;
        o.z += ov[u].z * w;
        o.w += ov[u].w * w;
      }
    }
    const float d = fmaxf(l, 1e-30f);
    store_out4(out + base * DH + c, make_float4(o.x / d, o.y / d, o.z / d, o.w / d));
  }
}

// The same, called rather than inlined: the fp32 body at DH = 256 sits at
// 255 registers, and only a merge compiled apart from it leaves ptxas's
// allocation of its key loop (and its spills) as they were without one.
template <int DH, typename T>
__device__ __noinline__ void merge_if_last_apart(const float* o_part, const float* m_part,
                                                 const float* l_part, T* out, int* counters,
                                                 float* mx_s, int B, int Sq, int H, int G,
                                                 int kvh, int r0, int R, int b) {
  merge_if_last<DH>(o_part, m_part, l_part, out, counters, mx_s, B, Sq, H, G, kvh, r0, R,
                    b);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core body
// ---------------------------------------------------------------------------

// BK = 32 keys a tile (16 KB of K and of V at DH=128), KPW = 4 keys a warp
// in the score phase, each scored by PARTS = 8 lanes that split DH; K rows
// padded by 8 floats, so the 16-byte reads of a quarter warp (4 keys x 2
// parts) hit distinct banks.
constexpr int F_BK = 32, F_KPW = F_BK / NW, F_PARTS = 32 / F_KPW;

// shared memory layout, in bytes: q (MAXR x DH) | p (MAXR x BK) | per-warp
// max and sum (NW x MAXR each) | K (2 stages of BK x DH+8) | V (2 stages
// of BK x DH), all f32
template <int DH, int MAXR>
__host__ __device__ constexpr size_t f32_kv_offset() {
  return sizeof(float) * (size_t(MAXR) * (DH + F_BK) + 2 * NW * MAXR);
}

template <int DH, int MAXR>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  return f32_kv_offset<DH, MAXR>() + sizeof(float) * 2 * size_t(F_BK) * (2 * DH + 8);
}

template <int DH, int MAXR, bool PAGED>
__global__ void __launch_bounds__(NT, (DH > 128 ? 1 : 2))
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ pos,
                  float* __restrict__ o_part, float* __restrict__ m_part,
                  float* __restrict__ l_part, float* __restrict__ out,
                  int* __restrict__ counters, int B, int Sq, int H, int Hkv,
                  long long k_s0, long long k_s1, long long v_s0, long long v_s1,
                  int split_len, int bound, int window, float scale,
                  const int* __restrict__ table, int t_stride, int n_pages, int ps) {
  constexpr int VEC = 4, CPR = DH / VEC, BK = F_BK, KPW = F_KPW, PARTS = F_PARTS;
  constexpr int UPL = CPR / PARTS;   // 16-byte chunks a lane
  constexpr int KSTR = DH + 8;       // padded K row, in floats
  constexpr int RG = NT / DH;        // row groups of the value phase
  constexpr int RPT = MAXR / RG;     // packed rows a thread in the value phase
  // packed rows r0 .. r0 + R - 1 of KV head kvh (r0 + r = j*G + g)
  const int kvh = blockIdx.x % Hkv, r0 = (blockIdx.x / Hkv) * MAXR;
  const int s = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int G = H / Hkv, R = min(G * Sq - r0, MAXR);

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + MAXR * DH;
  float* mw_s = p_s + MAXR * BK;
  float* lw_s = mw_s + NW * MAXR;
  float* k_s = reinterpret_cast<float*>(smem + f32_kv_offset<DH, MAXR>());
  float* v_s = k_s + 2 * BK * KSTR;

  const int p0 = pos[b];
  const int lo = s * split_len;
  const int hi = min(lo + split_len, bound);
  const int start = window > 0 ? max(lo, p0 - window + 1) : lo;
  const int end = min(hi, p0 + Sq);
  const int n_tiles = end > start ? (end - start + BK - 1) / BK : 0;
  const float* kb = k + size_t(kvh) * DH;
  const float* vb = v + size_t(kvh) * DH;

  // issue tile j's K and V rows, every 16-byte chunk at once, into stage
  // j % 2; rows past `end` are zero-filled without a read
  auto load_tile = [&](int j) {
    const int t0 = start + j * BK, n = min(BK, end - t0);
    float* ks = k_s + (j & 1) * BK * KSTR;
    float* vs = v_s + (j & 1) * BK * DH;
#pragma unroll
    for (int it = 0; it < BK * CPR / NT; ++it) {
      const int i = t + it * NT;
      const int r = i / CPR, c = (i - r * CPR) * VEC;
      const bool ok = r < n;
      long long ko = 0, vo = 0;
      if (ok) {
        const int row = t0 + r, col = PAGED ? row / ps : 0;
        const int pg = PAGED ? page_at(col, b, table, t_stride, n_pages) : 0;
        ko = row_offset<PAGED>(row, pg, row - col * ps, b, k_s0, k_s1);
        vo = row_offset<PAGED>(row, pg, row - col * ps, b, v_s0, v_s1);
      }
      cp16(ks + r * KSTR + c, kb + ko + c, ok);
      cp16(vs + r * DH + c, vb + vo + c, ok);
    }
  };
  if (n_tiles > 0) load_tile(0);
  cp_commit();
  if (n_tiles > 1) load_tile(1);
  cp_commit();

  // packed query rows r0 + r = j*G + g (query token j, head kvh*G + g),
  // scaled, read while the tiles are in flight
  for (int i = t; i < R * DH; i += NT) {
    const int r = i / DH, d = i - r * DH;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    q_s[i] = q[((size_t(b) * Sq + j) * H + kvh * G + g) * DH + d] * scale;
  }

  // value phase: thread t owns output column c of packed rows rg + RG*i
  const int c = t % DH, rg = t / DH;
  float m[RPT], l[RPT], acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
    acc[i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j == 0) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();   // tile j is in; the last value phase is done
    if (j >= 1 && j + 1 < n_tiles) load_tile(j + 1);
    cp_commit();
    const int t0 = start + j * BK, n = min(BK, end - t0);
    const float* ks = k_s + (j & 1) * BK * KSTR;
    const float* vs = v_s + (j & 1) * BK * DH;

    // scores: warp w takes keys w*KPW .. w*KPW+KPW-1 of the tile against
    // every packed row; lane = part*KPW + key, each part a slice of DH.
    // The warp's own max and sum per row go to shared memory.
    {
      const int kk = lane % KPW, part = lane / KPW;
      const int key = warp * KPW + kk, kp = t0 + key;
      float kf[UPL * VEC];
#pragma unroll
      for (int u = 0; u < UPL; ++u)
        *reinterpret_cast<float4*>(kf + u * VEC) = *reinterpret_cast<const float4*>(
            ks + key * KSTR + (part + PARTS * u) * VEC);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= R) break;
        float sc = 0.f;
#pragma unroll
        for (int u = 0; u < UPL; ++u) {
          const float4* qr =
              reinterpret_cast<const float4*>(q_s + r * DH + (part + PARTS * u) * VEC);
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = qr[e4];
            const float* kv = kf + u * VEC + 4 * e4;
            sc += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
          }
        }
#pragma unroll
        for (int off = KPW; off < 32; off <<= 1) sc += __shfl_xor_sync(0xffffffffu, sc, off);
        const int qp = p0 + (r0 + r) / G;
        const bool live = key < n && kp <= qp && (window <= 0 || kp > qp - window);
        sc = live ? sc : -INFINITY;
        float mx = sc;
#pragma unroll
        for (int off = 1; off < KPW; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        mx = fmaxf(mx, kNegInit);    // a warp with no live key weighs 0
        const float e = expf(sc - mx);
        float sum = e;
#pragma unroll
        for (int off = 1; off < KPW; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (part == 0) p_s[r * BK + key] = e;
        if (lane == 0) {
          mw_s[warp * MAXR + r] = mx;
          lw_s[warp * MAXR + r] = sum;
        }
      }
    }
    __syncthreads();

    // values: merge the warps' softmax states once, then accumulate
    // each warp's keys under its factor exp(m_w - m_new)
    float m_new[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      float mt = m[i];
      if (r < R) {
#pragma unroll
        for (int w = 0; w < NW; ++w) mt = fmaxf(mt, mw_s[w * MAXR + r]);
        const float alpha = expf(m[i] - mt);
        acc[i] *= alpha;
        l[i] *= alpha;
      }
      m_new[i] = mt;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float part[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) part[i] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < KPW; k4 += 4) {
        const int key = w * KPW + k4;
        const float v0 = vs[(key + 0) * DH + c];
        const float v1 = vs[(key + 1) * DH + c];
        const float v2 = vs[(key + 2) * DH + c];
        const float v3 = vs[(key + 3) * DH + c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + RG * i;
          if (r < R) {
            const float4 pp = *reinterpret_cast<const float4*>(p_s + r * BK + key);
            part[i] += pp.x * v0 + pp.y * v1 + pp.z * v2 + pp.w * v3;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + RG * i;
        if (r < R) {
          const float cw = expf(mw_s[w * MAXR + r] - m_new[i]);
          acc[i] += cw * part[i];
          l[i] += cw * lw_s[w * MAXR + r];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) m[i] = m_new[i];
  }

  // partials o (S,B,Sq,H,DH), m and l (S,B,Sq,H), merged by the last
  // block if asked. DH = 256 always writes them and merges apart, even at
  // one split (see merge_if_last_apart); else one split with an output
  // writes the finished o / l itself.
  if constexpr (DH == 256) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i;
      if (r < R) {
        const int j = (r0 + r) / G, g = r0 + r - j * G;
        const size_t row = ((size_t(s) * B + b) * Sq + j) * H + kvh * G + g;
        o_part[row * DH + c] = acc[i];
        if (c == 0) {
          m_part[row] = m[i];
          l_part[row] = l[i];
        }
      }
    }
    if (out != nullptr)
      merge_if_last_apart<DH>(o_part, m_part, l_part, out, counters, mw_s, B, Sq, H, G, kvh,
                              r0, R, b);
    return;
  }
  const bool direct = out != nullptr && gridDim.y == 1;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r < R) {
      const int j = (r0 + r) / G, g = r0 + r - j * G;
      const size_t row = ((size_t(s) * B + b) * Sq + j) * H + kvh * G + g;
      if (direct) {
        store_out(out + row * DH + c, acc[i] / fmaxf(l[i], 1e-30f));
      } else {
        o_part[row * DH + c] = acc[i];
        if (c == 0) {
          m_part[row] = m[i];
          l_part[row] = l[i];
        }
      }
    }
  }
  if (out != nullptr && gridDim.y > 1)
    merge_if_last<DH>(o_part, m_part, l_part, out, counters, mw_s, B, Sq, H, G, kvh, r0,
                      R, b);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

constexpr int H_BK = 128;            // keys a pass: a 16-key chunk a warp

// shared memory layout, in bytes: q (MAXR x DH+8 bf16) | K and V (H_BK x
// DH+8 bf16 each; after the last pass, the warps' fp32 accumulators, NW x
// 16 x DH) | per-warp max, sum and merge weight (NW x 16 f32 each) | the
// merged max and sum (MAXR f32 each)
template <int DH, int MAXR>
__host__ __device__ constexpr size_t bf16_kv_offset() {
  return sizeof(__nv_bfloat16) * size_t(MAXR) * (DH + 8);
}

template <int DH, int MAXR>
__host__ __device__ constexpr size_t bf16_stats_offset() {
  return bf16_kv_offset<DH, MAXR>() + sizeof(__nv_bfloat16) * 2 * size_t(H_BK) * (DH + 8);
}

template <int DH, int MAXR>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return bf16_stats_offset<DH, MAXR>() + sizeof(float) * (3 * NW * 16 + 2 * MAXR);
}

template <int DH, int MAXR, bool PAGED>
__global__ void __launch_bounds__(NT, (DH > 128 ? 1 : 2))
decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
              float* __restrict__ o_part, float* __restrict__ m_part,
              float* __restrict__ l_part, __nv_bfloat16* __restrict__ out,
              int* __restrict__ counters, int B, int Sq, int H, int Hkv,
              long long k_s0, long long k_s1, long long v_s0, long long v_s1,
              int split_len, int bound, int window, float scale,
              const int* __restrict__ table, int t_stride, int n_pages, int ps) {
  using bf16 = __nv_bfloat16;
  constexpr int STR = DH + 8;        // shared-memory row, in elements
  constexpr int CPR = DH / 8;        // 16-byte chunks a row
  constexpr int ND = DH / 8;         // output fragments of 8 columns
  constexpr int NRB = MAXR / 16;     // row blocks of 16 packed rows
  constexpr int WPG = NW / NRB;      // warps a row block
  static_assert(size_t(NW) * 16 * DH * sizeof(float) <=
                    2 * size_t(H_BK) * STR * sizeof(bf16),
                "the warps' accumulators must fit where K and V were");
  // packed rows r0 .. r0 + R - 1 of KV head kvh (r0 + r = j*G + g)
  const int kvh = blockIdx.x % Hkv, r0 = (blockIdx.x / Hkv) * MAXR;
  const int s = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int G = H / Hkv, R = min(G * Sq - r0, MAXR);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + bf16_kv_offset<DH, MAXR>());
  bf16* v_s = k_s + H_BK * STR;
  float* o_s = reinterpret_cast<float*>(k_s);    // after the last pass
  float* mw_s = reinterpret_cast<float*>(smem + bf16_stats_offset<DH, MAXR>());
  float* lw_s = mw_s + NW * 16;
  float* f_s = lw_s + NW * 16;
  float* ml_s = f_s + NW * 16;

  const int lo = s * split_len;
  const int hi = min(lo + split_len, bound);
  const bf16* kb = k + size_t(kvh) * DH;
  const bf16* vb = v + size_t(kvh) * DH;

  // Passes of H_BK rows start at lo. Thread t copies 16-byte chunk t % CPR
  // of pass rows t / CPR + RS * i, i < RPT. For a paged pool the first
  // pass's table lookups (rows clipped to the split's, which lie within
  // the table) are issued before pos[b] arrives.
  constexpr int RS = NT / CPR, RPT = H_BK / RS;
  const int c_cp = (t % CPR) * 8, r_cp = t / CPR;
  int pg[RPT], in_pg[RPT];
  auto lookup = [&](int t0) {
    if constexpr (PAGED) {
      // one division, then steps of RS rows; table columns clipped to
      // the split's last one
      const int last = (hi - 1) / ps;
      int col = (t0 + r_cp) / ps, in = t0 + r_cp - col * ps;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pg[i] = page_at(min(col, last), b, table, t_stride, n_pages);
        in_pg[i] = in;
        for (in += RS; in >= ps; in -= ps) ++col;
      }
    }
  };
  if (lo < hi) lookup(lo);
  const int p0 = pos[b];
  const int start = window > 0 ? max(lo, p0 - window + 1) : lo;
  const int end = min(hi, p0 + Sq);

  // packed query rows r0 + r = j*G + g (query token j, head kvh*G + g),
  // bf16 and unscaled, so the tensor cores' products are exact; rows past
  // R are zero
  for (int i = t; i < MAXR * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const bool ok = r < R;
    cp16(q_s + r * STR + c, ok ? q + ((size_t(b) * Sq + j) * H + kvh * G + g) * DH + c : q,
         ok);
  }

  // warp w serves row block w / WPG and takes every WPG-th 16-key chunk
  // of a pass, with its own online softmax; this thread holds rows
  // 16*rb + lane/4 (_lo) and that + 8 (_hi) of every fragment
  const int rb = warp / WPG, wi = warp - rb * WPG;
  const int g8 = lane >> 2, tig = lane & 3;
  const int qp_lo = p0 + (r0 + rb * 16 + g8) / G, qp_hi = p0 + (r0 + rb * 16 + g8 + 8) / G;
  float m_lo = kNegInit, m_hi = kNegInit, l_lo = 0.f, l_hi = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t0 = lo; t0 < end; t0 += H_BK) {
    if (t0 + H_BK <= start) continue;   // a pass wholly before the window
    if (t0 > lo) {
      __syncthreads();                  // the last pass is done with K and V
      lookup(t0);
    }
    // every 16-byte chunk of the pass's K and V rows at once; rows outside
    // [start, end) are zero-filled without a read
    const int n = min(H_BK, end - t0);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r_cp + RS * i, row = t0 + r;
      const bool ok = r < n && row >= start;
      const long long ko = ok ? row_offset<PAGED>(row, pg[i], in_pg[i], b, k_s0, k_s1) : 0;
      const long long vo = ok ? row_offset<PAGED>(row, pg[i], in_pg[i], b, v_s0, v_s1) : 0;
      cp16(k_s + r * STR + c_cp, kb + ko + c_cp, ok);
      cp16(v_s + r * STR + c_cp, vb + vo + c_cp, ok);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    for (int ch = wi; ch * 16 < n; ch += WPG) {
      if (t0 + ch * 16 + 16 <= start) continue;   // a chunk wholly before the window
      // S = Q K^T for 16 rows x 16 keys
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, q_s + (rb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + kk * 16 +
                       (lane >> 4) * 8);
        ldsm_x4(bb, k_s + (ch * 16 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[0], a, bb[0], bb[1]);
        mma_bf16(sc[1], a, bb[2], bb[3]);
      }
      // scale the fp32 scores, mask, online softmax on the fragments
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ch * 16 + i * 8 + tig * 2 + e, kp = t0 + c;
          const bool lo_ok = c < n && kp <= qp_lo && (window <= 0 || kp > qp_lo - window);
          const bool hi_ok = c < n && kp <= qp_hi && (window <= 0 || kp > qp_hi - window);
          sc[i][e] = lo_ok ? sc[i][e] * scale : -INFINITY;
          sc[i][2 + e] = hi_ok ? sc[i][2 + e] * scale : -INFINITY;
          mx_lo = fmaxf(mx_lo, sc[i][e]);
          mx_hi = fmaxf(mx_hi, sc[i][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= al_lo;
      l_hi *= al_hi;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= al_lo; acc[i][1] *= al_lo;
        acc[i][2] *= al_hi; acc[i][3] *= al_hi;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sc[i][0] = expf(sc[i][0] - mn_lo); sc[i][1] = expf(sc[i][1] - mn_lo);
        sc[i][2] = expf(sc[i][2] - mn_hi); sc[i][3] = expf(sc[i][3] - mn_hi);
        l_lo += sc[i][0] + sc[i][1];
        l_hi += sc[i][2] + sc[i][3];
      }
      // O += P V, P as the bf16 pair hi + lo (fp32 precision)
      uint32_t ph[4], pl[4];
      split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
      split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
      split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
      split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, v_s + (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                              nd * 8 + (lane >> 4) * 8);
        mma_bf16(acc[nd], ph, bb[0], bb[1]);
        mma_bf16(acc[nd], pl, bb[0], bb[1]);
        mma_bf16(acc[nd + 1], ph, bb[2], bb[3]);
        mma_bf16(acc[nd + 1], pl, bb[2], bb[3]);
      }
    }
  }

  // merge the warps of each row block once: their (m, l, acc) through
  // shared memory, acc where K and V were
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = g8 + 8 * h;       // row within the row block
    if (rb * 16 + rr >= R) continue;
    float* dst = o_s + (warp * 16 + rr) * DH + tig * 2;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<float2*>(dst + i * 8) = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    if (tig == 0) {
      mw_s[warp * 16 + rr] = h ? m_hi : m_lo;
      lw_s[warp * 16 + rr] = h ? l_hi : l_lo;
    }
  }
  __syncthreads();
  if (t < MAXR * WPG) {
    // thread r*WPG + i weighs warp i of packed row r's row block; the WPG
    // lanes of a row reduce by shuffles
    const int r = t / WPG, w = (r / 16) * WPG + t % WPG, rr = r % 16;
    const float mw = r < R ? mw_s[w * 16 + rr] : kNegInit;
    float mt = mw;
#pragma unroll
    for (int off = 1; off < WPG; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float f = expf(mw - mt);
    float lt = r < R ? f * lw_s[w * 16 + rr] : 0.f;
#pragma unroll
    for (int off = 1; off < WPG; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (r < R) {
      f_s[w * 16 + rr] = f;
      if (t % WPG == 0) {
        ml_s[r] = mt;
        ml_s[MAXR + r] = lt;
      }
    }
  }
  __syncthreads();

  // one split with an output: the finished o / l in bf16; else the
  // partials o (S,B,Sq,H,DH), m and l (S,B,Sq,H), merged by the last block
  // if asked
  const bool direct = out != nullptr && gridDim.y == 1;
  for (int i = t; i < R * DH; i += NT) {
    const int r = i / DH, c = i - r * DH;
    const int w0 = (r / 16) * WPG, rr = r % 16;
    float o = 0.f;
    for (int w = w0; w < w0 + WPG; ++w) o += f_s[w * 16 + rr] * o_s[(w * 16 + rr) * DH + c];
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const size_t row = ((size_t(s) * B + b) * Sq + j) * H + kvh * G + g;
    if (direct) {
      store_out(out + row * DH + c, o / fmaxf(ml_s[MAXR + r], 1e-30f));
      continue;
    }
    o_part[row * DH + c] = o;
    if (c == 0) {
      m_part[row] = ml_s[r];
      l_part[row] = ml_s[MAXR + r];
    }
  }
  if (out != nullptr && gridDim.y > 1)
    merge_if_last<DH>(o_part, m_part, l_part, out, counters, ml_s, B, Sq, H, G, kvh, r0,
                      R, b);
}

// What a launch reads and writes, and its scalar arguments, passed through
// the launch helpers unchanged. `out` is null for the partials alone;
// counters (and o, m, l but in fp32 at DH = 256) may be null when out is
// set and n_splits == 1.
struct Args {
  const void *q, *k, *v, *pos;
  void *o, *m, *l, *out;
  int* counters;
  int B, Sq, H, Hkv;
  long long k_s0, k_s1, v_s0, v_s1;
  int n_splits, split_len, bound, window;
  float scale;
  const int* table;
  int t_stride, n_pages, ps;
};

// the body and its shared memory for each dtype
template <typename T, int DH, int MAXR, bool PAGED> struct Body;

template <int DH, int MAXR, bool PAGED> struct Body<float, DH, MAXR, PAGED> {
  static constexpr auto kern = decode_f32_kernel<DH, MAXR, PAGED>;
  static constexpr size_t smem = f32_smem_bytes<DH, MAXR>();
};

template <int DH, int MAXR, bool PAGED> struct Body<__nv_bfloat16, DH, MAXR, PAGED> {
  static constexpr auto kern = decode_kernel<DH, MAXR, PAGED>;
  static constexpr size_t smem = bf16_smem_bytes<DH, MAXR>();
};

template <typename T, int DH, int MAXR, bool PAGED>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = Body<T, DH, MAXR, PAGED>::kern;
  constexpr size_t shm = Body<T, DH, MAXR, PAGED>::smem;
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shm));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const int groups = ((a.H / a.Hkv) * a.Sq + MAXR - 1) / MAXR;
  const dim3 grid(a.Hkv * groups, a.n_splits, a.B);
  kern<<<grid, NT, shm, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.pos), static_cast<float*>(a.o), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<T*>(a.out), a.counters, a.B, a.Sq, a.H, a.Hkv,
      a.k_s0, a.k_s1, a.v_s0, a.v_s1, a.split_len, a.bound, a.window, a.scale, a.table,
      a.t_stride, a.n_pages, a.ps);
  return int(cudaGetLastError());
}

// packed rows a block: the fp32 body is built for 8, 16 and 32, the bf16
// body for one or two row blocks of 16; more than 32 packed rows take
// groups of 32 (a counter per group, KV head and slot)
template <typename T, int DH, bool PAGED>
int launch_rows(const Args& a, cudaStream_t st) {
  const int R = (a.H / a.Hkv) * a.Sq;
  if constexpr (sizeof(T) == 4)
    if (R <= 8) return launch<T, DH, 8, PAGED>(a, st);
  if (R <= 16) return launch<T, DH, 16, PAGED>(a, st);
  return launch<T, DH, 32, PAGED>(a, st);
}

template <typename T, bool PAGED>
int launch_dh(int Dh, const Args& a, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_rows<T, 32, PAGED>(a, st);
    case 64: return launch_rows<T, 64, PAGED>(a, st);
    case 128: return launch_rows<T, 128, PAGED>(a, st);
    case 256: return launch_rows<T, 256, PAGED>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int launch_dtype(int dtype, int Dh, const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float, PAGED>(Dh, a, st);
  if (dtype == 1) return launch_dh<__nv_bfloat16, PAGED>(Dh, a, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Split-KV decode of q (B, Sq, H, Dh) against slot caches k, v (B, S, Hkv,
// Dh). dtype: 0 = float32, 1 = bfloat16. Strides are in elements. window
// <= 0 means no sliding window. o_part, m_part, l_part: fp32 scratch of
// (n_splits, B, Sq, H, Dh), (n_splits, B, Sq, H) and (n_splits, B, Sq, H).
// out: the finished (B, Sq, H, Dh) output in q's dtype, or NULL for the
// partials alone. With out and n_splits > 1, counters is Hkv *
// ceil(G * Sq / 32) * B int32 zeros, zeros again when the kernel ends;
// with out and n_splits == 1 the counters are not touched, nor the
// scratch but in fp32 at Dh = 256.
// Returns a CUDA error code (0 on success).
int flash_decode(const void* q, const void* k, const void* v, const void* pos,
                 void* o_part, void* m_part, void* l_part, void* out, void* counters,
                 int dtype, int B, int Sq, int H, int Hkv, int Dh, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, int n_splits,
                 int split_len, int bound, int window, float scale, void* stream) {
  const Args a{q, k, v, pos, o_part, m_part, l_part, out, static_cast<int*>(counters),
               B, Sq, H, Hkv, k_sb, k_ss, v_sb, v_ss, n_splits, split_len, bound,
               window, scale, nullptr, 0, 0, 1};
  return launch_dtype<false>(dtype, Dh, a, stream);
}

// The same over page pools k, v (P, page, Hkv, Dh) through the (B, NB)
// int32 block table `table` (row stride t_stride). Page and row strides
// are in elements; bound is the number of logical rows that may be read
// (at most the table's columns times page_size).
int flash_decode_paged(const void* q, const void* k, const void* v, const void* table,
                       const void* pos, void* o_part, void* m_part, void* l_part,
                       void* out, void* counters, int dtype, int B, int Sq, int H,
                       int Hkv, int Dh, int t_stride, int n_pages, int page_size,
                       long long k_ps, long long k_rs, long long v_ps, long long v_rs,
                       int n_splits, int split_len, int bound, int window, float scale,
                       void* stream) {
  const Args a{q, k, v, pos, o_part, m_part, l_part, out, static_cast<int*>(counters),
               B, Sq, H, Hkv, k_ps, k_rs, v_ps, v_rs, n_splits, split_len, bound,
               window, scale, static_cast<const int*>(table), t_stride, n_pages,
               page_size};
  return launch_dtype<true>(dtype, Dh, a, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
