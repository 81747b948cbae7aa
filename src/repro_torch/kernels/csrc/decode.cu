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
// Bound on the H100: device-memory bytes. Each KV row is read once and
// used by all G*Sq query rows of its KV head, far below the card's ridge.
// At the served shape the grid is about one block an SM and a split is one
// or a few 64-row tiles, so the time is the latency of a block's chain:
// its first loads, its math, and the merge of the splits. The design
// (Hopper's own means, each chosen for one link of that chain):
//
// 1. A TMA ring of key tiles. The split's live rows go through a ring of
//    stages in shared memory, each stage a tile of K rows and of V rows,
//    each on its own mbarrier that expects the tile's bytes. A tile is
//    copied by TMA tensor copies (cp.async.bulk.tensor, 4-D tensor maps
//    over the cache that the host encodes at each launch: dense (Dh, Hkv,
//    S, B), paged (Dh, Hkv, page, P)), one box of 128 bytes of a row (64
//    bf16, 32 fp32; 64 bytes at bf16 Dh 32) by the tile's rows a column
//    chunk, written with the 128-byte (64-byte) swizzle that keeps
//    ldmatrix and the fp32 body's reads free of bank conflicts. Dense: a
//    box of the whole tile a chunk. Paged: boxes of gcd(page, tile) rows,
//    each within one page (the page looked up in the table by the lane
//    that issues it): a split starts on a page and its tiles a tile
//    apart, so no box crosses a page, whatever the page size. A box must
//    start 128-byte aligned in shared memory; at bf16 Dh 32 (64-byte
//    rows) an odd page would break that, and its tiles come in 16-byte
//    cp.async.bulk copies, one a swizzled unit. A copy a row is no choice
//    where a box serves: on an H100 the TMA unit took ~60 cycles a
//    256-byte row, 8 GB/s a block (PERF.md). Tiles start at the split's
//    first row, rounded down to the tile; rows of a tile outside [start,
//    end) are loaded but
//    masked, and their V rows zeroed in shared memory before the value
//    product (a masked key weighs 0, and 0 * NaN would not). Bf16 tiles
//    are 64 keys (32 at Dh 256) in 3 stages (2 at Dh 256); fp32 tiles 32
//    keys in 2 stages. A tile's consumers score and accumulate it while
//    the next tiles load.
//
//    bf16 (the served dtype): 256 threads, eight warps. The warps take
//    16-key chunks of the tiles in turn, each with its own online
//    softmax, merged once at the end of the split through shared memory
//    where the ring was. No warp is set aside to copy: the first warp
//    issues the first tiles, and after that the last warp done with a
//    stage (a count in shared memory) issues the tile that refills it.
//    Both products run on mma.sync (m16n8k16, fp32 accumulators),
//    transposed: keys (or head columns) on the tile's 16 rows and the
//    packed query rows on its 8 columns, S^T = K Q^T and O^T += V^T P^T,
//    P^T moved into place by movmatrix. At the served G*Sq = 8 packed
//    rows that leaves no padding (a row-major tile would be half padding,
//    a 64-row wgmma tile 7/8), halves both products, and keeps a warp's
//    accumulators at 8 rows x Dh over its lanes: 32 registers at Dh 128,
//    64 at Dh 256, so that a thread fits the 128 registers of two blocks
//    an SM (a block's chain is latency, so a second block on the SM
//    overlaps it). The body is bound by bytes, not
//    operations. q is loaded unscaled in bf16, so the products are exact,
//    and the scale goes on the fp32 scores; P is carried as the bf16 pair
//    hi + lo into the value product, so it keeps fp32 precision. Blocks
//    of 16 or 32 packed rows run 2 or 4 column tiles of 8 rows; where a
//    warp's accumulators then pass 32 registers (Dh x rows > 1024) the
//    block runs alone on its SM, with 255 registers; at Dh 256 a block
//    takes 16 packed rows at most (the warps' accumulators fill the
//    shared memory).
//
//    fp32: the tensor cores would round fp32 to TF32, which the
//    tolerance does not allow, so the arithmetic stays on the CUDA cores,
//    256 threads, on the same ring (a block barrier a tile frees the last
//    tile's stage, so its first warp issues the next tile after that
//    barrier, and no empty barrier is needed): scores with warp w taking
//    4 keys of the tile, 8 lanes a key splitting DH (reduced by shuffles),
//    each warp keeping its own max and sum per row; values with thread t
//    owning output column t % DH of every (NT/DH)-th packed row, merging
//    the warps' states once a tile by the factors exp(m_w - m_new). Two
//    blocks an SM where Dh x packed rows < 2048, else one; at Dh >= 128 a
//    block takes 16 packed rows at most (a thread keeps up to 16 rows'
//    state).
//
// 2. The split merge through L2. Every block of a finished launch of more
//    than one split leaves its merged (m, l, acc) as fp32 partials in a
//    workspace, fences them and counts itself in its (KV head, row group,
//    slot) counter; the last block to count reads every split's partials
//    from L2 in split order 0 .. S-1 (at most MAX_MERGE = 8, loaded at
//    once), merges them by log-sum-exp as combine_splits does (m_max =
//    max_s m_s, w_s = exp(m_s - m_max), o = sum_s w_s o_s / max(sum_s w_s
//    l_s, 1e-30)), writes the finished output and sets the counter back
//    to 0, so the counters are zeroed once, when made. The order is
//    fixed, so outputs repeat bit for bit. A split with no live row
//    carries m = -1e30, l = 0, o = 0 and weighs exactly zero. One split
//    writes its output itself. Called without an output the kernel writes
//    the partials of every split and merges nothing (the sequence-sharded
//    decode merges them across ranks; the split-level checks use them),
//    at any split count.
//
//    A thread-block cluster was built first: the splits of a row group
//    one cluster, block 0 reading the others' states through distributed
//    shared memory between two cluster barriers, with no scratch and no
//    counter. On an H100 it lost: the merge itself was about as long as
//    through L2, and launching the grid in clusters cost the whole kernel
//    more than that (yi-9b's served shape 10.20 us in clusters against
//    9.74 through L2 with no cluster, and 11.05 through L2 in clusters;
//    the spread scheduling policy moved nothing; PERF.md).
//    scripts/decode_probe.py keeps it as its `cluster` variant.
//
// 3. The launch. A programmatic dependent launch
//    (cudaLaunchAttributeProgrammaticStreamSerialization, griddepcontrol.
//    wait in the kernel) would let the launch and the block's set-up, or
//    also its reads of pos, the page table and the first old cache rows,
//    overlap the tail of the kernel before it. scripts/decode_probe.py
//    builds both (pdl1, pdl2); on an H100 a CUDA graph of the decode chunk
//    keeps the programmatic edges, outputs stay bit for bit, and the
//    kernel times and the steps' times moved by no more than their noise
//    (PERF.md), so the launch is a plain one. (The early reads would also
//    race a kernel just before that writes pos or the cache, as a row
//    writer followed by a decode does.)
//
// Packed rows past 32 (G * Sq > 32, e.g. G = 16 at Sq = 4; past 16 in
// fp32 at Dh >= 128): the grid's x dimension runs over (KV head, group of
// 32 (16) packed rows), and each group's block reads its split's K and V
// rows itself. A call of at most 32 packed rows is one group, so the
// served shape (G * Sq = 8) is unchanged; wider calls pay one more read of
// the rows a group.
//
// Head dims 32, 64, 128 and 256.
//
// The step's KV rows (WRITE). The decode step writes its new K and V rows
// into the cache and then reads the cache; on the TPU they are two
// programs (repro/kernels/stores.py:_kv_write_nt, or XLA's update slice,
// then this kernel). Here a launch called with k_new and v_new does both,
// so the write costs no launch of its own (a launch's floor is ~1.3 us, the
// write moves 16 KiB). Block (row group 0, split 0) of each (KV head, slot)
// stores that head's new rows into the cache while its first tiles are in
// flight, with st.global.cs under "nt"; split 0 exists in every launch, so
// the rows are written whether or not they are live. Dense: rows w0 .. w0 + Sq - 1 of the slot, w0 = pos[b] clamped into
// [0, S - Sq] (a negative pos counted from the end first), as JAX's
// dynamic_update_slice clamps it. Paged: row pos % page of page table[b,
// min(pos / page, NB - 1)], NB the table's columns, from k_new[b, 0] (the
// reference model's scatter); that is logical row w0 = min(pos / page, NB -
// 1) * page + pos % page. Every block whose tile holds a row of that
// window overwrites the row in shared memory with k_new and v_new after
// the tile lands, before any use, so no value read from a cache row the
// launch writes is used: the launch needs no ordering inside it, the next
// launch sees the rows in stream order, and the outputs are those of the
// write followed by the read, bit for bit (the same bf16 or fp32 words).
// That holds if no physical row the launch writes is read in the
// same launch through any other (slot, table column): neither another
// slot's live rows nor another column of the writing slot. The engines
// keep it for every served slot (the paged engine copies a shared page
// before its holder writes it). The known exception is the scratch page
// that every table column of a free or retired slot names: such a slot
// writes one scratch row while its own and other free slots' blocks read
// the page, a race that leaves those slots' outputs (which the engine
// discards) undefined. The caches k and v carry no __restrict__, since
// the writer stores through them. A paged write at a negative pos wraps to
// the table's last columns, as the plain version
// (stores.ref_paged_row_update, the reference model's scatter) does: row
// pos mod page of column floor(pos / page) + NB (column 0 below pos =
// -NB * page, where the plain version's index raises).
//
// Paged pool. On the TPU the KV block equals the page and a BlockSpec
// index map fetches one page per grid step. Here a tile spans one or more
// pages (or a page several tiles): the lane that issues a box looks up its
// physical page (table[b, row / page], clipped into [0, P-1] as the TPU
// wrapper's jnp.clip does) and takes the box's page coordinate from it.
// Masking stays in logical row coordinates, so the block still uses only
// the live rows: table columns past the split's last are never read, and
// out-of-order tables cost nothing but scattered boxes. The paged kernel
// reads bound/page table columns at most (4 bytes each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async.cuh"

namespace {

constexpr float kNegInit = -1e30f;   // running max of a row with no live key

constexpr int MAX_MERGE = 8;         // splits a finished launch merges
constexpr size_t kMaxSmem = 232448;  // shared memory a block can have

// What a launch reads and writes, and its scalar arguments. km and vm are
// the K and V caches' tensor maps (encoded by the launch). `out` is null
// for the partials alone, when o, m and l are the (S, B, Sq, H, DH) and
// (S, B, Sq, H) fp32 partials; with `out` they are null. k_new and v_new
// (B, Sq, Hkv, DH), or null: the rows to write first (WRITE); S is the
// dense cache's rows, t_cols the block table's columns, nt the streaming
// stores.
struct alignas(64) Params {
  CUtensorMap km, vm;
  const void *q, *k, *v;
  const int* pos;
  float *o, *m, *l;
  void* out;
  int* counters;
  int B, Sq, H, Hkv;
  long long k_s0, k_s1, v_s0, v_s1;
  int split_len, bound, window;
  float scale;
  const int* table;
  int t_stride, n_pages, ps;
  const void *k_new, *v_new;
  int S, t_cols, nt;
};

// A tile of the ring for dtype T at head dim DH: BK keys, STAGES stages,
// each K and V tile NCH column chunks of BK rows x CB bytes (CW elements),
// written by TMA with a CB-byte swizzle.
template <typename T, int DH>
struct Tile {
  static constexpr int BK = sizeof(T) == 4 ? 32 : (DH > 128 ? 32 : 64);
  static constexpr int STAGES = sizeof(T) == 4 ? 2 : (DH > 128 ? 2 : 3);
  static constexpr int CB = DH * int(sizeof(T)) < 128 ? DH * int(sizeof(T)) : 128;
  static constexpr int CW = CB / int(sizeof(T));
  static constexpr int NCH = DH / CW;
  static constexpr size_t BYTES = size_t(BK) * DH * sizeof(T);   // a K (or V) tile
};

// Byte offset of 16-byte unit `col` / 16 of row `row` (col a byte column of
// the row, a multiple of 16) in a tile of `rows` rows written with a
// CB-byte swizzle: column chunk col / CB, then the unit's index XORed with
// the row's (128 bytes: row mod 8; 64 bytes: row / 2 mod 4).
template <int CB>
__device__ __forceinline__ int swz(int row, int col, int rows) {
  const int u = (col % CB) >> 4;
  const int x = CB == 128 ? (row & 7) : ((row >> 1) & 3);
  return ((col / CB) * rows + row) * CB + ((u ^ x) << 4);
}

// Row addressing for the fused write. Dense cache (B, S, Hkv, DH): row
// `row` of slot b sits at b * s0 + row * s1 elements (batch and sequence
// strides). Paged pool (P, page, Hkv, DH): logical row `row` of slot b
// sits in physical page p = table[b, row / page], clipped into [0,
// n_pages - 1] as the TPU wrapper's jnp.clip does, at p * s0 + (row %
// page) * s1 (page and row strides). The dense instantiation reads no
// table.
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

// First row of the window a WRITE launch writes, in the slot's (logical)
// rows: dense, pos clamped into [0, S - Sq] after a negative pos is counted
// from the end; paged, row pos mod ps of page column floor(pos / ps),
// clamped to t_cols - 1 above and, when negative, counted from the
// table's end (clipped to column 0 below -t_cols), as Python indexing
// does in the reference's scatter.
template <bool PAGED>
__device__ __forceinline__ int write_start(int p0, int S, int Sq, int ps, int t_cols) {
  if constexpr (PAGED) {
    const int q = p0 >= 0 ? p0 / ps : (p0 + 1) / ps - 1;
    const int col = q < 0 ? max(q + t_cols, 0) : min(q, t_cols - 1);
    return col * ps + (p0 - q * ps);
  }
  return min(max(p0 < 0 ? p0 + S : p0, 0), S - Sq);
}

// The fused write of a WRITE launch, by `NTH` threads of a writer block:
// KV head kvh's new rows of slot b (Sq rows dense, k_new[b, 0] paged) into
// the caches at window row w0, 16 bytes a thread, streaming under `nt`.
template <int DH, bool PAGED, typename T, int NTH>
__device__ __forceinline__ void write_rows(const Params& p, int w0, int b, int kvh) {
  constexpr int VEC = 16 / sizeof(T), CPR = DH / VEC;
  const T* k_new = static_cast<const T*>(p.k_new);
  const T* v_new = static_cast<const T*>(p.v_new);
  T* k = const_cast<T*>(static_cast<const T*>(p.k));
  T* v = const_cast<T*>(static_cast<const T*>(p.v));
  const int n = PAGED ? 1 : p.Sq;
  const int col = PAGED ? w0 / p.ps : 0;
  const int pg = PAGED ? page_at(col, b, p.table, p.t_stride, p.n_pages) : 0;
  for (int i = threadIdx.x; i < n * CPR; i += NTH) {
    const int j = i / CPR, c = (i - j * CPR) * VEC;
    const long long src = ((static_cast<long long>(b) * p.Sq + j) * p.Hkv + kvh) * DH + c;
    const int row = w0 + j;
    const long long kd = row_offset<PAGED>(row, pg, row - col * p.ps, b, p.k_s0, p.k_s1);
    const long long vd = row_offset<PAGED>(row, pg, row - col * p.ps, b, p.v_s0, p.v_s1);
    const size_t hd = size_t(kvh) * DH + c;
    store16(k + kd + hd, *reinterpret_cast<const uint4*>(k_new + src), p.nt != 0);
    store16(v + vd + hd, *reinterpret_cast<const uint4*>(v_new + src), p.nt != 0);
  }
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

// The split's live rows [start, end), and its tiles of BK rows from
// `first` (lo plus a multiple of BK: none wholly before the window), from
// pos; w0 and nw the rows a WRITE launch writes ([w0, w0 + nw), nw = 0
// without a write).
struct Span {
  int start, end, first, n_tiles, w0, nw;
};

template <int BK, bool PAGED, bool WRITE>
__device__ __forceinline__ Span split_span(const Params& p, int p0, int s) {
  const int lo = s * p.split_len;
  const int hi = min(lo + p.split_len, p.bound);
  const int start = p.window > 0 ? max(lo, p0 - p.window + 1) : lo;
  const int end = min(hi, p0 + p.Sq);
  const int first = lo + (start - lo) / BK * BK;
  return {start, end, first, end > start ? (end - first + BK - 1) / BK : 0,
          WRITE ? write_start<PAGED>(p0, p.S, p.Sq, p.ps, p.t_cols) : 0,
          WRITE ? (PAGED ? 1 : p.Sq) : 0};
}

// Rows a paged box: gcd(page, BK), so that no box crosses a page (a
// split starts on a page and its tiles BK rows apart) whatever the page.
template <int BK>
__host__ __device__ __forceinline__ int page_box_rows(int ps) {
  int a = ps, c = BK;
  while (c != 0) {
    const int t = a % c;
    a = c;
    c = t;
  }
  return a;
}

// Issue tile j's K and V boxes into stage `st` (ks, vs), completing on
// `bar`, by the lanes of one warp (lane 0 has announced the bytes):
// dense, one box a column chunk; paged, boxes of page_box_rows rows, each
// in one page, looked up by the lane that issues it (table columns clipped
// to the split's last, `last_col`). A box must start 128-byte aligned in
// shared memory, which a box of an odd number of 64-byte rows (bf16 at
// Dh 32, an odd page) does not: such tiles come in 16-byte bulk copies,
// one a swizzled unit.
template <typename T, int DH, bool PAGED>
__device__ __forceinline__ void issue_tile(const Params& p, unsigned char* ks, unsigned char* vs,
                                           uint64_t* bar, int t0, int last_col, int kvh, int b,
                                           int lane) {
  using TT = Tile<T, DH>;
  const int br = PAGED ? page_box_rows<TT::BK>(p.ps) : TT::BK;
  if constexpr (PAGED && TT::CB < 128) {
    if (br & 1) {
      constexpr int UNITS = TT::CB / 16;
      for (int i = lane; i < TT::BK * UNITS; i += 32) {
        const int r = i / UNITS, u = i - r * UNITS, row = t0 + r, col = row / p.ps;
        const int pg = page_at(min(col, last_col), b, p.table, p.t_stride, p.n_pages);
        const int off = swz<TT::CB>(r, u * 16, TT::BK);
        const long long e = size_t(kvh) * DH + u * (16 / int(sizeof(T)));
        const int in_page = row - col * p.ps;
        bulk_load(ks + off,
                  static_cast<const T*>(p.k) + row_offset<true>(row, pg, in_page, b, p.k_s0, p.k_s1) + e,
                  16, bar);
        bulk_load(vs + off,
                  static_cast<const T*>(p.v) + row_offset<true>(row, pg, in_page, b, p.v_s0, p.v_s1) + e,
                  16, bar);
      }
      return;
    }
  }
  for (int pc = lane; pc * br < TT::BK; pc += 32) {
    const int row = t0 + pc * br;
    int c2 = row, c3 = b;
    if constexpr (PAGED) {
      const int col = row / p.ps;
      c2 = row - col * p.ps;
      c3 = page_at(min(col, last_col), b, p.table, p.t_stride, p.n_pages);
    }
#pragma unroll
    for (int ch = 0; ch < TT::NCH; ++ch) {
      const int off = (ch * TT::BK + pc * br) * TT::CB;
      tensor_load_4d(ks + off, &p.km, ch * TT::CW, kvh, c2, c3, bar);
      tensor_load_4d(vs + off, &p.vm, ch * TT::CW, kvh, c2, c3, bar);
    }
  }
}

// Rows r of a landed tile (rows t0 + r, r in [r_lo, r_hi)) made fit for
// use, by `nth` threads from thread `tid`: a V row outside [start, end)
// zeroed, a row of the written window overwritten (K and V) with its
// k_new / v_new row. Returns whether this thread wrote (it then fences
// the generic writes before the stage goes back to the TMA).
template <typename T, int DH, bool PAGED, bool WRITE>
__device__ __forceinline__ bool fix_rows(const Params& p, const Span& sp, unsigned char* ks,
                                         unsigned char* vs, int t0, int r_lo, int r_hi,
                                         int tid, int nth, int b, int kvh) {
  using TT = Tile<T, DH>;
  constexpr int UNITS = DH * int(sizeof(T)) / 16;   // 16-byte units a row
  bool wrote = false;
  for (int i = tid; i < (r_hi - r_lo) * UNITS; i += nth) {
    const int r = r_lo + i / UNITS, u = i % UNITS, row = t0 + r;
    const int off = swz<TT::CB>(r, u * 16, TT::BK);
    if (row < sp.start || row >= sp.end) {
      *reinterpret_cast<uint4*>(vs + off) = make_uint4(0, 0, 0, 0);
      wrote = true;
    } else if (WRITE && row - sp.w0 >= 0 && row - sp.w0 < sp.nw) {
      const size_t src = (((size_t(b) * p.Sq + (row - sp.w0)) * p.Hkv + kvh) * DH) +
                         u * (16 / sizeof(T));
      *reinterpret_cast<uint4*>(ks + off) =
          *reinterpret_cast<const uint4*>(static_cast<const T*>(p.k_new) + src);
      *reinterpret_cast<uint4*>(vs + off) =
          *reinterpret_cast<const uint4*>(static_cast<const T*>(p.v_new) + src);
      wrote = true;
    }
  }
  return wrote;
}

// Whether any row of [a, a + n) needs fix_rows: outside [start, end) or
// in the written window.
__device__ __forceinline__ bool needs_fix(const Span& sp, int a, int n) {
  return a < sp.start || a + n > sp.end || (sp.nw > 0 && a < sp.w0 + sp.nw && sp.w0 < a + n);
}

// The split merge, at the end of every block of a finished launch of
// more than one split (all NTH threads call it): the block's (acc, m, l),
// in shared memory (row r's accumulators at o_s + r * DH, its max and sum
// at ml_s[r] and ml_s[MAXR + r]), go to the fp32 partials o (S, B, Sq, H,
// DH), m and l (S, B, Sq, H); one thread fences them and counts the block
// in its row group's counter (the cooperative-groups grid barrier's
// pattern: after the block barrier one thread's fence is cumulative over
// every partial the block wrote); the last block of the row group reads
// every split's partials from L2, a 4-column slice a thread, all S splits
// at once, sums them in split order 0 .. S-1 and writes the finished
// output, and sets the counter back to 0 for the next launch. `flag` is an
// int of shared memory no thread reads or writes in the meantime.
template <int DH, int MAXR, int NTH, typename T>
__device__ __forceinline__ void split_merge_end(const float* o_s, const float* ml_s, int* flag,
                                                const Params& p, int G, int kvh, int r0, int R,
                                                int b) {
  constexpr int V4 = DH / 4;
  const int S = gridDim.y;
  const size_t rows = size_t(p.B) * p.Sq * p.H;   // rows of one split's partials
  for (int i = threadIdx.x; i < R * V4; i += NTH) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const size_t row = blockIdx.y * rows + (size_t(b) * p.Sq + j) * p.H + kvh * G + g;
    *reinterpret_cast<float4*>(p.o + row * DH + c) =
        *reinterpret_cast<const float4*>(o_s + r * DH + c);
    if (c == 0) {
      p.m[row] = ml_s[r];
      p.l[row] = ml_s[MAXR + r];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    int* cnt = p.counters + size_t(b) * gridDim.x + blockIdx.x;
    const bool last = atomicAdd(cnt, 1) == S - 1;
    if (last) *cnt = 0;              // every block of its row group has counted
    __threadfence();
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < R * V4; i += NTH) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const size_t base = (size_t(b) * p.Sq + j) * p.H + kvh * G + g;
    float mv[MAX_MERGE], lv[MAX_MERGE];
    float4 ov[MAX_MERGE];
#pragma unroll
    for (int u = 0; u < MAX_MERGE; ++u) {
      if (u < S) {
        const size_t row = u * rows + base;
        mv[u] = __ldcg(p.m + row);
        lv[u] = __ldcg(p.l + row);
        ov[u] = __ldcg(reinterpret_cast<const float4*>(p.o + row * DH + c));
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < MAX_MERGE; ++u)
      if (u < S) mx = fmaxf(mx, mv[u]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_MERGE; ++u) {
      if (u >= S) break;
      const float w = expf(mv[u] - mx);
      l += lv[u] * w;
      o.x += ov[u].x * w;
      o.y += ov[u].y * w;
      o.z += ov[u].z * w;
      o.w += ov[u].w * w;
    }
    const float d = fmaxf(l, 1e-30f);
    store_out4(out + base * DH + c, make_float4(o.x / d, o.y / d, o.z / d, o.w / d));
  }
}

__host__ __device__ constexpr size_t round_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

// ---------------------------------------------------------------------------
// fp32: CUDA-core body
// ---------------------------------------------------------------------------

constexpr int F_NT = 256;            // threads per block
constexpr int F_NW = F_NT / 32;      // warps per block
// KPW = 4 keys of a 32-key tile a warp in the score phase, each scored by
// PARTS = 8 lanes that split DH
constexpr int F_KPW = 32 / F_NW, F_PARTS = 32 / F_KPW;

// shared memory layout, in bytes: q (MAXR x DH) | p (MAXR x BK) | per-warp
// max and sum (NW x MAXR each; after the loop the block's max and sum) |
// the ring: STAGES stages of a K and a V tile, 1024-byte aligned (after
// the loop the block's accumulators, MAXR x DH) | the stages' mbarriers;
// all f32, and 1024 bytes of slack to align the base
template <int DH, int MAXR>
struct F32Layout {
  using TT = Tile<float, DH>;
  static constexpr size_t ring =
      round_up(sizeof(float) * (size_t(MAXR) * (DH + TT::BK) + 2 * F_NW * MAXR), 1024);
  static constexpr size_t stage = 2 * TT::BYTES;
  static constexpr size_t bars = ring + TT::STAGES * stage;
  static constexpr size_t bytes = bars + 8 * TT::STAGES + 1024;
  static_assert(size_t(MAXR) * DH * sizeof(float) <= TT::STAGES * stage,
                "the accumulators fit where the ring was");
  static_assert(bytes <= kMaxSmem, "shared memory");
};

template <int DH, int MAXR, bool PAGED, bool WRITE>
__global__ void __launch_bounds__(F_NT, (DH * MAXR < 2048 ? 2 : 1))
decode_f32_kernel(const __grid_constant__ Params p) {
  using TT = Tile<float, DH>;
  using L = F32Layout<DH, MAXR>;
  constexpr int VEC = 4, CPR = DH / VEC, BK = TT::BK, KPW = F_KPW, PARTS = F_PARTS;
  constexpr int NW = F_NW, NT = F_NT, ST = TT::STAGES;
  constexpr int UPL = CPR / PARTS;   // 16-byte chunks a lane
  constexpr int RG = NT / DH;        // row groups of the value phase
  constexpr int RPT = MAXR / RG;     // packed rows a thread in the value phase
  // packed rows r0 .. r0 + R - 1 of KV head kvh (r0 + r = j*G + g)
  const int kvh = blockIdx.x % p.Hkv, r0 = (blockIdx.x / p.Hkv) * MAXR;
  const int s = blockIdx.y, b = blockIdx.z, S = gridDim.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int G = p.H / p.Hkv, R = min(G * p.Sq - r0, MAXR);
  const bool merged = p.out != nullptr && S > 1;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + MAXR * DH;
  float* mw_s = p_s + MAXR * BK;
  float* lw_s = mw_s + NW * MAXR;
  unsigned char* ring = smem + L::ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);

  if (t == 0) {
    for (int i = 0; i < ST; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int p0 = __ldg(p.pos + b);
  const Span sp = split_span<BK, PAGED, WRITE>(p, p0, s);
  const int last_col = PAGED ? (min(s * p.split_len + p.split_len, p.bound) - 1) / p.ps : 0;
  __syncthreads();   // the barriers are made

  // tile j into stage j % ST, by the first warp
  auto issue = [&](int j) {
    const int st = j % ST;
    unsigned char* ks = ring + st * L::stage;
    if (lane == 0) mbar_expect(&full[st], unsigned(L::stage));
    __syncwarp();
    issue_tile<float, DH, PAGED>(p, ks, ks + TT::BYTES, &full[st], sp.first + j * BK, last_col,
                                 kvh, b, lane);
  };
  if (warp == 0)
    for (int j = 0; j < min(ST, sp.n_tiles); ++j) issue(j);

  // a writer block (WRITE: split 0, row group 0) writes the new rows while
  // its first tiles are in flight
  if (WRITE && s == 0 && blockIdx.x < p.Hkv)
    write_rows<DH, PAGED, float, NT>(p, sp.w0, b, kvh);

  // packed query rows r0 + r = j*G + g (query token j, head kvh*G + g),
  // scaled, read while the tiles are in flight
  const float* q = static_cast<const float*>(p.q);
  for (int i = t; i < R * DH; i += NT) {
    const int r = i / DH, d = i - r * DH;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    q_s[i] = q[((size_t(b) * p.Sq + j) * p.H + kvh * G + g) * DH + d] * p.scale;
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

  for (int j = 0; j < sp.n_tiles; ++j) {
    __syncthreads();   // q is in; the last value phase is done with its stage
    if (warp == 0 && j >= 1 && j - 1 + ST < sp.n_tiles) issue(j - 1 + ST);
    const int t0 = sp.first + j * BK;
    unsigned char* ks = ring + (j % ST) * L::stage;
    unsigned char* vs = ks + TT::BYTES;
    mbar_wait(&full[j % ST], (j / ST) & 1);
    if (needs_fix(sp, t0, BK)) {
      if (fix_rows<float, DH, PAGED, WRITE>(p, sp, ks, vs, t0, 0, BK, t, NT, b, kvh))
        fence_async_smem();
      __syncthreads();
    }

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
            ks + swz<TT::CB>(key, (part + PARTS * u) * 16, BK));
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        if (r >= R) break;
        float sc = 0.f;
#pragma unroll
        for (int u = 0; u < UPL; ++u) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_s + r * DH + (part + PARTS * u) * VEC);
          const float* kv = kf + u * VEC;
          sc += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
        }
#pragma unroll
        for (int off = KPW; off < 32; off <<= 1) sc += __shfl_xor_sync(0xffffffffu, sc, off);
        const int qp = p0 + (r0 + r) / G;
        const bool live = kp >= sp.start && kp < sp.end && kp <= qp &&
                          (p.window <= 0 || kp > qp - p.window);
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
        float vv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[e] = *reinterpret_cast<const float*>(
              vs + swz<TT::CB>(key + e, (c * 4) & ~15, BK) + ((c * 4) & 15));
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + RG * i;
          if (r < R) {
            const float4 pp = *reinterpret_cast<const float4*>(p_s + r * BK + key);
            part[i] += pp.x * vv[0] + pp.y * vv[1] + pp.z * vv[2] + pp.w * vv[3];
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

  // one split with an output: the finished o / l; more: (m, l, acc) into
  // shared memory (acc where the ring was, m and l where the warps' were)
  // for the split merge; no output: the partials o (S,B,Sq,H,DH), m and l
  // (S,B,Sq,H)
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(ring);
  float* ml_s = mw_s;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r < R) {
      const int j = (r0 + r) / G, g = r0 + r - j * G;
      const size_t row = ((size_t(s) * p.B + b) * p.Sq + j) * p.H + kvh * G + g;
      if (merged) {
        o_s[r * DH + c] = acc[i];
        if (c == 0) {
          ml_s[r] = m[i];
          ml_s[MAXR + r] = l[i];
        }
      } else if (p.out != nullptr) {
        store_out(static_cast<float*>(p.out) + row * DH + c, acc[i] / fmaxf(l[i], 1e-30f));
      } else {
        p.o[row * DH + c] = acc[i];
        if (c == 0) {
          p.m[row] = m[i];
          p.l[row] = l[i];
        }
      }
    }
  }
  if (merged)
    split_merge_end<DH, MAXR, NT, float>(o_s, ml_s, reinterpret_cast<int*>(ml_s + 2 * MAXR), p,
                                         G, kvh, r0, R, b);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

constexpr int H_NT = 256;            // threads per block: eight warps
constexpr int H_NW = H_NT / 32;

// Blocks an SM of the bf16 body: two where a warp's accumulators (MAXR
// rows x DH fp32 over 32 lanes) leave room under 128 registers a thread
// (8 packed rows at any head dim, or DH x MAXR <= 1024), else one.
template <int DH, int MAXR>
struct Bf16Blocks {
  static constexpr int N = MAXR == 8 || DH * MAXR <= 1024 ? 2 : 1;
};

// shared memory layout, in bytes: q (MAXR x DH+8 bf16) | the ring: STAGES
// stages of a K and a V tile, 1024-byte aligned (after the last tile, the
// warps' fp32 accumulators, NW x MAXR x DH) | per-warp max, sum and merge
// weight (NW x MAXR f32 each) | the merged max and sum (MAXR f32 each) |
// the stages' mbarriers and release counts; and 1024 bytes of slack to
// align the base
template <int DH, int MAXR>
struct Bf16Layout {
  using TT = Tile<__nv_bfloat16, DH>;
  static constexpr size_t q = round_up(sizeof(__nv_bfloat16) * size_t(MAXR) * (DH + 8), 1024);
  static constexpr size_t stage = 2 * TT::BYTES;
  static constexpr size_t acc = sizeof(float) * size_t(H_NW) * MAXR * DH;
  static constexpr size_t ring_size =
      TT::STAGES * stage > acc ? TT::STAGES * stage : acc;
  static constexpr size_t stats = q + ring_size;
  static constexpr size_t bars = stats + round_up(sizeof(float) * (3 * H_NW + 2) * MAXR, 16);
  static constexpr size_t bytes = bars + 16 * TT::STAGES + 1024;
  static_assert(Bf16Blocks<DH, MAXR>::N == 1 || 2 * (bytes + 1024) <= 233472,
                "two blocks an SM");
  static_assert(bytes <= kMaxSmem, "shared memory");
};

template <int DH, int MAXR, bool PAGED, bool WRITE>
__global__ void __launch_bounds__(H_NT, (Bf16Blocks<DH, MAXR>::N))
decode_kernel(const __grid_constant__ Params p) {
  using bf16 = __nv_bfloat16;
  using TT = Tile<bf16, DH>;
  using L = Bf16Layout<DH, MAXR>;
  constexpr int NW = H_NW, NT = H_NT;
  constexpr int STR = DH + 8;        // q's shared-memory row, in elements
  constexpr int CPR = DH / 8;        // 16-byte chunks a row
  constexpr int NRT = MAXR / 8;      // 8-row tiles of packed rows
  constexpr int NDT = DH / 16;       // 16-column tiles of the head dim
  constexpr int BK = TT::BK, CPT = BK / 16, ST = TT::STAGES;
  // packed rows r0 .. r0 + R - 1 of KV head kvh (r0 + r = j*G + g)
  const int kvh = blockIdx.x % p.Hkv, r0 = (blockIdx.x / p.Hkv) * MAXR;
  const int s = blockIdx.y, b = blockIdx.z, S = gridDim.y;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int G = p.H / p.Hkv, R = min(G * p.Sq - r0, MAXR);
  const bool merged = p.out != nullptr && S > 1;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + L::q;
  float* o_s = reinterpret_cast<float*>(ring);    // after the last tile
  float* mw_s = reinterpret_cast<float*>(smem + L::stats);
  float* lw_s = mw_s + NW * MAXR;
  float* f_s = lw_s + NW * MAXR;
  float* ml_s = f_s + NW * MAXR;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  int* done = reinterpret_cast<int*>(full + ST);   // warps done with a stage

  // tile j into stage j % ST, by the lanes of one warp
  const int last_col = PAGED ? (min(s * p.split_len + p.split_len, p.bound) - 1) / p.ps : 0;
  const int p0 = __ldg(p.pos + b);
  const Span sp = split_span<BK, PAGED, WRITE>(p, p0, s);
  auto issue = [&](int j) {
    const int st = j % ST;
    unsigned char* ks = ring + st * L::stage;
    if (lane == 0) mbar_expect(&full[st], unsigned(L::stage));
    __syncwarp();
    issue_tile<bf16, DH, PAGED>(p, ks, ks + TT::BYTES, &full[st], sp.first + j * BK, last_col,
                                kvh, b, lane);
  };
  // the first warp makes the barriers and issues the first tiles; the
  // others meet them at the block barrier below
  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < ST; ++i) {
        mbar_init(&full[i]);
        done[i] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int j = 0; j < min(ST, sp.n_tiles); ++j) issue(j);
  }

  // packed query rows r0 + r = j*G + g (query token j, head kvh*G + g),
  // bf16 and unscaled, so the tensor cores' products are exact; rows past
  // R are zero
  const bf16* q = static_cast<const bf16*>(p.q);
  for (int i = t; i < MAXR * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    *reinterpret_cast<uint4*>(q_s + r * STR + c) =
        r < R ? *reinterpret_cast<const uint4*>(q + ((size_t(b) * p.Sq + j) * p.H + kvh * G + g) *
                                                        DH + c)
              : make_uint4(0, 0, 0, 0);
  }
  // a writer block (WRITE: split 0, row group 0) writes the new rows while
  // its first tiles are in flight
  if (WRITE && s == 0 && blockIdx.x < p.Hkv) write_rows<DH, PAGED, bf16, NT>(p, sp.w0, b, kvh);
  __syncthreads();   // q is in, the barriers are made

  // Warp w takes chunk c of the split (16 keys, c = j * CPT + i for chunk
  // i of tile j) when c % NW == w, with its own online softmax. The
  // products run transposed, keys and head columns on the mma tiles' 16
  // rows and the packed rows on their 8 columns (no padding at 8 packed
  // rows): S^T = K Q^T, then O^T += V^T P^T. Lane (g8, tig) holds keys (or
  // columns) g8 and g8 + 8 of packed rows 2 tig and 2 tig + 1 of each
  // 8-row tile.
  const int g8 = lane >> 2, tig = lane & 3;
  int qp[NRT][2];
#pragma unroll
  for (int nt = 0; nt < NRT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) qp[nt][e] = p0 + (r0 + nt * 8 + 2 * tig + e) / G;
  float m[NRT][2], l[NRT][2];
  float acc[NDT][NRT][4];
#pragma unroll
  for (int nt = 0; nt < NRT; ++nt) {
    m[nt][0] = m[nt][1] = kNegInit;
    l[nt][0] = l[nt][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) acc[dt][nt][0] = acc[dt][nt][1] = acc[dt][nt][2] =
        acc[dt][nt][3] = 0.f;
  }

  for (int j = 0; j < sp.n_tiles; ++j) {
    const int st = j % ST, t0 = sp.first + j * BK, n = min(BK, sp.end - t0);
    unsigned char* ks = ring + st * L::stage;
    unsigned char* vs = ks + TT::BYTES;
    // every warp waits on every tile and counts itself done with it
    mbar_wait(&full[st], (j / ST) & 1);
    bool wrote = false;
    for (int ch = ((warp - j * CPT) % NW + NW) % NW; ch < CPT; ch += NW) {
      if (ch * 16 >= n) break;
      if (t0 + ch * 16 + 16 <= sp.start) continue;   // a chunk wholly before the window
      if (needs_fix(sp, t0 + ch * 16, 16)) {
        wrote |= fix_rows<bf16, DH, PAGED, WRITE>(p, sp, ks, vs, t0, ch * 16, ch * 16 + 16, lane,
                                                  32, b, kvh);
        __syncwarp();
      }
      // S^T = K Q^T for 16 keys x 8 packed rows a tile
      float sc[NRT][4];
#pragma unroll
      for (int nt = 0; nt < NRT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const int kr = ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < NDT; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, ks + swz<TT::CB>(kr, (kk * 16 + (lane >> 4) * 8) * 2, BK));
#pragma unroll
        for (int nt = 0; nt < NRT; ++nt) {
          uint32_t bq[2];
          ldsm_x2(bq, q_s + (nt * 8 + (lane & 7)) * STR + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[nt], a, bq[0], bq[1]);
        }
      }
      // scale the fp32 scores, mask, online softmax per packed row over
      // the chunk's keys (the lanes of one tig)
      const int k_lo = t0 + ch * 16 + g8;
      const bool lo_live = k_lo >= sp.start && k_lo < sp.end;
      const bool hi_live = k_lo + 8 >= sp.start && k_lo + 8 < sp.end;
      uint32_t ph[NRT][2], pl[NRT][2];
#pragma unroll
      for (int nt = 0; nt < NRT; ++nt) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qpe = qp[nt][e];
          const bool lo_ok = lo_live && k_lo <= qpe && (p.window <= 0 || k_lo > qpe - p.window);
          const bool hi_ok =
              hi_live && k_lo + 8 <= qpe && (p.window <= 0 || k_lo + 8 > qpe - p.window);
          const float s_lo = lo_ok ? sc[nt][e] * p.scale : -INFINITY;
          const float s_hi = hi_ok ? sc[nt][2 + e] * p.scale : -INFINITY;
          float mx = fmaxf(s_lo, s_hi);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m[nt][e], mx);
          const float al = expf(m[nt][e] - mn);
          m[nt][e] = mn;
          pe[e] = expf(s_lo - mn);
          pe[2 + e] = expf(s_hi - mn);
          l[nt][e] = l[nt][e] * al + pe[e] + pe[2 + e];
#pragma unroll
          for (int dt = 0; dt < NDT; ++dt) {
            acc[dt][nt][e] *= al;
            acc[dt][nt][2 + e] *= al;
          }
        }
        // P^T as the value product's B operand, as the bf16 pair hi + lo
        // (fp32 precision): each 8x8 half moved to (key, row) lanes
        uint32_t h0, l0, h1, l1;
        split_bf16(pe[0], pe[1], h0, l0);
        split_bf16(pe[2], pe[3], h1, l1);
        ph[nt][0] = movmatrix_trans(h0);
        pl[nt][0] = movmatrix_trans(l0);
        ph[nt][1] = movmatrix_trans(h1);
        pl[nt][1] = movmatrix_trans(l1);
      }
      // O^T += V^T P^T for 16 head columns x 8 packed rows a tile
      const int vr = ch * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        uint32_t a[4];
        ldsm_x4_trans(a, vs + swz<TT::CB>(vr, (dt * 16 + ((lane >> 3) & 1) * 8) * 2, BK));
#pragma unroll
        for (int nt = 0; nt < NRT; ++nt) {
          mma_bf16(acc[dt][nt], a, ph[nt][0], ph[nt][1]);
          mma_bf16(acc[dt][nt], a, pl[nt][0], pl[nt][1]);
        }
      }
    }
    if (wrote) fence_async_smem();   // generic writes before the stage's next TMA
    // the last warp done with the stage (its count, which only grows,
    // reaching a multiple of NW) refills it with tile j + ST
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = (atomicAdd(&done[st], 1) + 1) % NW == 0;
      if (last) {
        __threadfence_block();
        fence_async_smem();
      }
    }
    if (__shfl_sync(0xffffffffu, last, 0) && j + ST < sp.n_tiles) issue(j + ST);
  }

  // merge the warps once: their (m, l, acc) through shared memory, acc
  // where the ring was (every tile has landed and been read by then)
#pragma unroll
  for (int nt = 0; nt < NRT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[nt][e] += __shfl_xor_sync(0xffffffffu, l[nt][e], off);
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NRT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tig + e;
      float* dst = o_s + (warp * MAXR + r) * DH + g8;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        dst[dt * 16] = acc[dt][nt][e];
        dst[dt * 16 + 8] = acc[dt][nt][2 + e];
      }
      if (g8 == 0) {
        mw_s[warp * MAXR + r] = m[nt][e];
        lw_s[warp * MAXR + r] = l[nt][e];
      }
    }
  }
  __syncthreads();
  if (t < MAXR * NW) {
    // thread r*NW + w weighs warp w of packed row r; the NW lanes of a row
    // reduce by shuffles
    const int r = t / NW, w = t % NW;
    const float mw = r < R ? mw_s[w * MAXR + r] : kNegInit;
    float mt = mw;
#pragma unroll
    for (int off = 1; off < NW; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float f = expf(mw - mt);
    float lt = r < R ? f * lw_s[w * MAXR + r] : 0.f;
#pragma unroll
    for (int off = 1; off < NW; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (r < R) {
      f_s[w * MAXR + r] = f;
      if (w == 0) {
        ml_s[r] = mt;
        ml_s[MAXR + r] = lt;
      }
    }
  }
  __syncthreads();

  // one split with an output: the finished o / l in bf16; more: the
  // block's o in place of warp 0's, for the split merge; no output: the
  // partials o (S,B,Sq,H,DH), m and l (S,B,Sq,H)
  for (int i = t; i < R * DH; i += NT) {
    const int r = i / DH, c = i - r * DH;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) o += f_s[w * MAXR + r] * o_s[(w * MAXR + r) * DH + c];
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const size_t row = ((size_t(s) * p.B + b) * p.Sq + j) * p.H + kvh * G + g;
    if (merged) {
      o_s[r * DH + c] = o;
    } else if (p.out != nullptr) {
      store_out(static_cast<bf16*>(p.out) + row * DH + c, o / fmaxf(ml_s[MAXR + r], 1e-30f));
    } else {
      p.o[row * DH + c] = o;
      if (c == 0) {
        p.m[row] = ml_s[r];
        p.l[row] = ml_s[MAXR + r];
      }
    }
  }
  if (merged)
    split_merge_end<DH, MAXR, NT, bf16>(o_s, ml_s, reinterpret_cast<int*>(mw_s), p, G, kvh, r0,
                                        R, b);
}

// the body, its threads and its shared memory for each dtype
template <typename T, int DH, int MAXR, bool PAGED, bool WRITE> struct Body;

template <int DH, int MAXR, bool PAGED, bool WRITE> struct Body<float, DH, MAXR, PAGED, WRITE> {
  static constexpr auto kern = decode_f32_kernel<DH, MAXR, PAGED, WRITE>;
  static constexpr int threads = F_NT;
  static constexpr size_t smem = F32Layout<DH, MAXR>::bytes;
};

template <int DH, int MAXR, bool PAGED, bool WRITE>
struct Body<__nv_bfloat16, DH, MAXR, PAGED, WRITE> {
  static constexpr auto kern = decode_kernel<DH, MAXR, PAGED, WRITE>;
  static constexpr int threads = H_NT;
  static constexpr size_t smem = Bf16Layout<DH, MAXR>::bytes;
};

// A tensor map of a K or V cache for dtype T at head dim DH: dims, fastest
// first, (DH, Hkv, rows, outer) with element strides (DH, s_row, s_outer);
// dense, rows = S and outer = B; paged, rows = the page and outer = the
// pages. Boxes of one column chunk (Tile::CW) by box_rows rows, swizzled
// as the bodies read them. A dim of extent 1 takes a stride of DH elements
// (its stride is never used, and the encoder checks it).
template <typename T, int DH>
bool kv_map(CUtensorMap* map, const void* x, int hkv, long long rows, long long outer,
            long long s_row, long long s_outer, int box_rows) {
  using TT = Tile<T, DH>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(DH), cuuint64_t(hkv), cuuint64_t(rows),
                              cuuint64_t(outer)};
  const long long el[3] = {DH, s_row, s_outer};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) strides[i] = cuuint64_t(dims[i + 1] == 1 ? DH : el[i]) * sizeof(T);
  const cuuint32_t box[4] = {cuuint32_t(TT::CW), 1, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            TT::CB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch: the caches' tensor maps, then grid (Hkv * groups, n_splits,
// B). A launch the card refuses returns its error.
template <typename T, int DH, int MAXR, bool PAGED, bool WRITE>
int launch(Params a, int n_splits, cudaStream_t stream) {
  using Bd = Body<T, DH, MAXR, PAGED, WRITE>;
  using TT = Tile<T, DH>;
  const int box_rows = PAGED ? page_box_rows<TT::BK>(a.ps) : TT::BK;
  const long long rows = PAGED ? a.ps : a.S, outer = PAGED ? a.n_pages : a.B;
  if (!kv_map<T, DH>(&a.km, a.k, a.Hkv, rows, outer, a.k_s1, a.k_s0, box_rows) ||
      !kv_map<T, DH>(&a.vm, a.v, a.Hkv, rows, outer, a.v_s1, a.v_s0, box_rows))
    return int(cudaErrorInvalidValue);
  static bool configured = false;   // once per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        Bd::kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Bd::smem));
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const int groups = ((a.H / a.Hkv) * a.Sq + MAXR - 1) / MAXR;
  Bd::kern<<<dim3(a.Hkv * groups, n_splits, a.B), Bd::threads, Bd::smem, stream>>>(a);
  return int(cudaGetLastError());
}

// the body with the fused row write when the launch has rows to write
template <typename T, int DH, int MAXR, bool PAGED>
int launch_write(const Params& a, int ns, cudaStream_t st) {
  if (a.k_new != nullptr) return launch<T, DH, MAXR, PAGED, true>(a, ns, st);
  return launch<T, DH, MAXR, PAGED, false>(a, ns, st);
}

// packed rows a block: 8, 16 and 32 (16 at most where a block's state
// would not fit: fp32 at Dh >= 128, a thread's registers; bf16 at Dh 256,
// the warps' accumulators in shared memory); more packed rows take groups
// of that many
template <typename T, int DH, bool PAGED>
int launch_rows(const Params& a, int ns, cudaStream_t st) {
  constexpr bool upto16 = sizeof(T) == 4 ? DH >= 128 : DH > 128;
  const int R = (a.H / a.Hkv) * a.Sq;
  if (R <= 8) return launch_write<T, DH, 8, PAGED>(a, ns, st);
  if (R <= 16 || upto16) return launch_write<T, DH, 16, PAGED>(a, ns, st);
  if constexpr (!upto16) return launch_write<T, DH, 32, PAGED>(a, ns, st);
  return int(cudaErrorInvalidValue);
}

template <typename T, bool PAGED>
int launch_dh(int Dh, const Params& a, int ns, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_rows<T, 32, PAGED>(a, ns, st);
    case 64: return launch_rows<T, 64, PAGED>(a, ns, st);
    case 128: return launch_rows<T, 128, PAGED>(a, ns, st);
    case 256: return launch_rows<T, 256, PAGED>(a, ns, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <bool PAGED>
int launch_dtype(int dtype, int Dh, const Params& a, int ns, void* stream) {
  // a finished call merges at most MAX_MERGE splits (the wrapper plans no
  // more), through the partials and the counters; the partials alone take
  // any count
  const bool parts = a.o != nullptr && a.m != nullptr && a.l != nullptr;
  if (ns < 1 || (a.out != nullptr && ns > 1 && (ns > MAX_MERGE || !parts || !a.counters)) ||
      (a.out == nullptr && !parts))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float, PAGED>(Dh, a, ns, st);
  if (dtype == 1) return launch_dh<__nv_bfloat16, PAGED>(Dh, a, ns, st);
  return int(cudaErrorInvalidValue);
}

// The scalar and pointer arguments of a launch (the tensor maps are
// encoded by `launch`).
Params make_params(const void* q, const void* k, const void* v, const void* pos, void* o_part,
                   void* m_part, void* l_part, void* out, void* counters, int B, int Sq, int H, int Hkv,
                   long long k_s0, long long k_s1, long long v_s0, long long v_s1, int split_len,
                   int bound, int window, float scale, const void* table, int t_stride,
                   int n_pages, int ps, const void* k_new, const void* v_new, int S, int t_cols,
                   int nt) {
  Params a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.pos = static_cast<const int*>(pos);
  a.o = static_cast<float*>(o_part);
  a.m = static_cast<float*>(m_part);
  a.l = static_cast<float*>(l_part);
  a.out = out;
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.Sq = Sq;
  a.H = H;
  a.Hkv = Hkv;
  a.k_s0 = k_s0;
  a.k_s1 = k_s1;
  a.v_s0 = v_s0;
  a.v_s1 = v_s1;
  a.split_len = split_len;
  a.bound = bound;
  a.window = window;
  a.scale = scale;
  a.table = static_cast<const int*>(table);
  a.t_stride = t_stride;
  a.n_pages = n_pages;
  a.ps = ps;
  a.k_new = k_new;
  a.v_new = v_new;
  a.S = S;
  a.t_cols = t_cols;
  a.nt = nt;
  return a;
}

}  // namespace

extern "C" {

// Split-KV decode of q (B, Sq, H, Dh) against slot caches k, v (B, S, Hkv,
// Dh). dtype: 0 = float32, 1 = bfloat16. Strides are in elements. window
// <= 0 means no sliding window. out: the finished (B, Sq, H, Dh) output in
// q's dtype (n_splits at most 8; with more than one split o_part, m_part
// and l_part as below are the merge's scratch, and counters the int32
// split counters, one a KV head, row group and slot, zero before the
// launch and left zero by it), or NULL for the partials alone: fp32
// o_part (n_splits, B, Sq, H, Dh), m_part and l_part (n_splits, B, Sq,
// H). k_new, v_new: (B, Sq, Hkv, Dh) rows in q's dtype,
// contiguous and 16-byte aligned, written into the caches (rows pos[b] ..
// pos[b] + Sq - 1 of slot b, the start clamped into [0, S - Sq] after a
// negative pos is counted from the end; S the caches' rows) before they
// are read, in the same launch, with streaming stores if nt; or NULL (no
// write). Returns a CUDA error code (0 on success).
int flash_decode(const void* q, const void* k, const void* v, const void* pos, void* o_part,
                 void* m_part, void* l_part, void* out, void* counters, const void* k_new, const void* v_new,
                 int dtype, int B, int Sq, int H, int Hkv, int Dh, long long k_sb,
                 long long k_ss, long long v_sb, long long v_ss, int S, int nt, int n_splits,
                 int split_len, int bound, int window, float scale, void* stream) {
  if ((k_new == nullptr) != (v_new == nullptr) || (k_new != nullptr && Sq > S))
    return int(cudaErrorInvalidValue);
  const Params a = make_params(q, k, v, pos, o_part, m_part, l_part, out, counters, B, Sq, H, Hkv, k_sb,
                               k_ss, v_sb, v_ss, split_len, bound, window, scale, nullptr, 0, 0,
                               1, k_new, v_new, S, 0, nt);
  return launch_dtype<false>(dtype, Dh, a, n_splits, stream);
}

// The same over page pools k, v (P, page, Hkv, Dh) through the (B, NB)
// int32 block table `table` (row stride t_stride, t_cols = NB columns).
// Page and row strides are in elements; bound is the number of logical
// rows that may be read (at most the table's columns times page_size); any
// page size. With k_new, v_new, row 0 of each
// slot's new rows is written first to row pos[b] % page_size of page
// table[b, min(pos[b] / page_size, NB - 1)] (a negative pos counted from
// the table's end); no physical row written may be read through another
// column of any slot in the same launch (see the WRITE paragraph above).
int flash_decode_paged(const void* q, const void* k, const void* v, const void* table,
                       const void* pos, void* o_part, void* m_part, void* l_part, void* out,
                       void* counters, const void* k_new, const void* v_new, int dtype, int B, int Sq, int H,
                       int Hkv, int Dh, int t_stride, int t_cols, int n_pages, int page_size,
                       long long k_ps, long long k_rs, long long v_ps, long long v_rs, int nt,
                       int n_splits, int split_len, int bound, int window, float scale,
                       void* stream) {
  if ((k_new == nullptr) != (v_new == nullptr)) return int(cudaErrorInvalidValue);
  const Params a = make_params(q, k, v, pos, o_part, m_part, l_part, out, counters, B, Sq, H, Hkv, k_ps,
                               k_rs, v_ps, v_rs, split_len, bound, window, scale, table,
                               t_stride, n_pages, page_size, k_new, v_new, 0, t_cols, nt);
  return launch_dtype<true>(dtype, Dh, a, n_splits, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
