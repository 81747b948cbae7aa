// The paper's stencil kernels for Hopper (sm_90a): 2-D 5-point and 3-D
// 7-point Jacobi sweeps and 2-D 5-point Gauss-Seidel sweeps, all in fp32.
//
// Replaces the Pallas TPU kernels of repro/kernels/stream/kernels.py:
//   jacobi2d_kernel      <- jacobi_2d5pt (_jacobi2d_kernel);
//   jacobi3d_kernel      <- jacobi_3d7pt (_jacobi3d_kernel);
//   gauss_seidel_kernel  <- gauss_seidel_2d5pt (_gs_kernel).
//
// Bound on the H100. The Jacobi sweeps are bound by bytes: the input read
// once and the interior written once over 3.35 TB/s, ~0.64 ms at
// (16386, 16384) and at (514, 512, 1024) (reckoned). Gauss-Seidel too is
// bound by bytes, ~0.04 ms at (4098, 4096): the grid read once and
// written once.
//
// Design. Jacobi 2-D: one thread an output point, a block a 256-point run
// of one output row; the block's id names the row and the run, so any
// shape works (the TPU wrapper asserts (H-2) % bm == 0). Each thread reads
// its neighbours from global memory; the runs of neighbouring rows are
// read by blocks scheduled together, so the halo rows come from L1 or L2
// and device memory sees each input byte about once.
//
// Jacobi 3-D: one thread a point reading its six neighbours from global
// memory took 2.03x the time of a copy of the same bytes on the H100
// (1440.7 against 711 us at (514, 512, 1024)): every input word crossed
// from L2 to an SM about six times. Here a block owns a tile of 16 x 128
// output columns (rows x columns) and marches down z through a chunk of
// planes; any shape works (the TPU wrapper asserts (D-2) % bz == 0). Each
// input plane's box of the tile and its halo, 18 x 132 floats (whole
// 16-byte rows, 9.4 KB), comes into a ring of 8 shared-memory slots 6
// planes ahead (77 KB of dynamic shared memory, two blocks an SM): one TMA
// tensor copy a plane where rows are 16-byte aligned (W % 4 == 0, an
// aligned input), 4-byte cp.async copies (10 a thread a plane) otherwise.
// A thread owns one column of the tile in 8 rows, keeps the centre of the
// planes below and at its point in registers, reads the plane above's
// centre and its four in-plane neighbours from the ring, and stores its
// outputs 4 bytes at a time, a warp a 128-byte run (output rows are W - 2
// floats, not whole 16-byte rows in general). z is cut into
// chunks so that ~16384 blocks run (64 chunks of 8 planes at (514, 512,
// 1024)): each block then has most of its chunk in flight at once, and a
// chunk's two extra planes are read while the neighbouring chunk's blocks,
// launched beside it, read them too, so they mostly hit L2. Narrower or
// shorter tiles, fewer planes ahead and longer chunks all ran slower on
// the H100 (scripts/jacobi3d_probe.py times them).
//
// Both Jacobi sweeps sum in the plain version's order with the _rn
// intrinsics: the outputs are bit-identical to PyTorch's.
//
// Gauss-Seidel: new[i][j] = 0.25 * (((new[i-1][j] + old[i+1][j]) +
// old[i][j-1]) + old[i][j+1]) for the interior, row after row, the
// boundary unchanged. The left and right neighbours are old values, so
// within a sweep column j depends only on its own row above: the 4094
// interior columns of (4098, 4096) are independent recurrences down the
// rows. One warp owns a strip of columns, one column a lane, and walks
// the rows in order, carrying new[i-1][j] in a register: a row step is a
// chain of four dependent fp32 operations (~16 cycles). A pass reads grid
// x and writes another grid y, so strips share nothing they write and
// need no synchronisation; the wrapper ping-pongs passes between the
// output and one temporary grid so that the last pass lands in the
// output, and the first reads the input, which stays untouched. A pass
// writes every point of y, the boundary rows and columns copied through,
// so no copy is ever made apart from the pass.
//
// A pass fuses F <= kGsMaxFused sweeps, pipelined down the rows in one
// warp: at row step t the lane computes sweep 1 at row t and sweep f at
// row t - 2 (f - 1). Sweep f takes its row below and its own row from
// sweep f - 1 as it stood after the two steps before, and that row's left
// and right neighbours from the neighbouring lanes (__shfl_up/down_sync);
// sweep 1 takes them from the ring. So the F sweeps of a step depend on
// nothing of each other and their chains overlap (a skew of one row a
// sweep would chain them within the step). Each fused sweep past the
// first spends one column of halo on each side, so a strip of 32 lanes
// writes at most 34 - 2F columns (32 for F <= 1) and recomputes its
// neighbours' edge columns. A pass of F sweeps costs one read and one
// write of the grid. F = 0 is the copy (no sweep, or no interior point).
//
// Memory. A pass has about one warp an SM (128 strips of 32 columns at
// (4098, 4096) with F = 1, 147 of 28 with F = 2), and on the H100 a
// warp's global memory requests cost it dearly to issue, whatever their
// size: 72-75 cycles a row step for the 4-byte route's ~1.06 cp.async
// copies a row (scripts/gs_sum_probe.py clocks), against a row step of
// ~16 cycles of arithmetic. So a warp makes one request a stage of rows
// each way, where it can:
//   tensor route (w % 4 == 0, x and y 16-byte aligned): one TMA tensor
//   copy loads a stage's box of 64 rows x 40 columns (the strip, its
//   halo, 16-byte aligned; outside the grid zero-filled) into a ring of 3
//   stages, completing on the stage's mbarrier, 2 stages ahead; the lanes
//   stage the output rows in shared memory and one tensor copy stores the
//   box (kGsBoxes - 1 in flight; rows and columns past the grid not
//   written). Strips are then 32, 28 or 24 columns, so the boxes stay
//   whole 16-byte rows. The first box starts above row 0 for F >= 1,
//   where a tensor store may not start (an illegal instruction on the
//   H100): its rows are stored a lane a column.
//   4-byte route (any width, alignment and 4-byte-offset view): 4-byte
//   cp.async copies of a flat run of 32 rows x 34 floats spread over the
//   lanes (~1.06 copies a lane a row), 4 stages of 6 ahead, and a 4-byte
//   store a lane a row: about 3x the tensor route's cycles a row step.
// A stage's output rows are held in registers and written at its end, so
// no store stands between two steps' shared-memory loads.
//
// Every value is the plain version's sum in its order with the _rn
// intrinsics, computed once from the same operands whatever the strip or
// the fusion: the output is bit-identical to the plain version's.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    jacobi2d_kernel(const float* __restrict__ u, float* __restrict__ o, int w,
                    int runs) {
  const long long row = blockIdx.x / runs;
  const int x = (blockIdx.x % runs) * kThreads + threadIdx.x;
  const int ow = w - 2;
  if (x >= ow) return;
  const long long c = (row + 1) * w + x + 1;
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(u[c - w], u[c + w]), u[c - 1]), u[c + 1]);
  o[row * ow + x] = __fmul_rn(0.25f, s);
}

// --- Gauss-Seidel ----------------------------------------------------------

constexpr int kGsMaxFused = 4;  // sweeps one pass fuses
constexpr int kGsBoxes = 2;     // staged output boxes of the tensor route, kGsBoxes - 1 in flight

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The 4-byte route: cp.async.ca of 4 bytes; with `valid` false nothing
// is read and 0 is written.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tensor route (TMA): one copy a stage, completed on an mbarrier
// (loads) or in a bulk group (stores).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One box of a 2-D tensor map into shared memory at coordinates
// (column, row), completing on `bar`; elements outside the tensor are
// zero-filled.
__device__ __forceinline__ void tensor_load(float* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// One box from shared memory into a 2-D tensor map at (column, row), in
// the current bulk group; elements outside the tensor are not written.
__device__ __forceinline__ void tensor_store(const CUtensorMap* map, int col, int row,
                                             const float* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy accesses to shared memory ordered before the bulk
// copies' (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The geometry of a pass of F fused sweeps: G halo columns a side; a
// strip writes W columns (the tensor route keeps them a multiple of 4, so
// its boxes stay whole 16-byte rows); a ring row holds RC columns (34 = 32
// lanes and a halo column a side; the tensor route's boxes start at a
// column that is a multiple of 4 and hold up to 3 columns more); a ring
// of STAGES stages of ROWS rows. The tensor route's 64-row stages beat 48
// and 32 rows at two fused sweeps on the H100 (74.3, 79.4 and 91.2 us at
// (4098, 4096), scripts/gs_sum_probe.py stages; 48 rows is ahead at four
// sweeps); the 4-byte route keeps 32 rows, its registers full.
template <int F, bool TMA>
struct GsGeom {
  static constexpr int G = F > 1 ? F : 1;
  static constexpr int W = TMA ? (F <= 1 ? 32 : F <= 3 ? 28 : 24) : 34 - 2 * G;
  static constexpr int RC = TMA ? 40 : 34;
  static constexpr int ROWS = TMA ? 64 : 32;
  static constexpr int STAGES = TMA ? 3 : 6;
  static constexpr int kStage = ROWS * RC;
  static constexpr int PER = kStage / 32;  // 4-byte copies a lane a stage
  static_assert(TMA || (kStage % 32 == 0 && PER <= 64), "whole warp copies, one mask bit each");
};

// Rows a pass's output trails the row that arrives: 0 for the copy, 1
// for one sweep, and two more for each fused sweep past the first.
template <int F>
__host__ __device__ constexpr int gs_delay() {
  return F == 0 ? 0 : 2 * F - 1;
}

// The row steps of one ring stage. Row d = d0 + j arrives at step j and
// closes row t = d - 1, whose neighbours are now all in the ring: sweep 1
// computes row t, sweep f row t - 2 (f - 1). Sweep f takes its row below
// and its own row from sweep f - 1 as it stood before the step (cur and
// prv), so the F sweeps of a step depend on nothing of each other and
// their chains overlap. `slot` is the stage's rows, `prev_last` the row
// before the stage (the previous stage's last), both at this warp's
// column c_ring. cur[f] and prv[f] hold sweep f's last two rows at this
// lane's column, `above` the input's row t. With CHECK, rows outside the
// interior keep the value the sweep before left there (the boundary,
// copied through) and output rows outside the grid are not stored;
// without it, every row of the stage is interior. The stage's output rows
// (row d - gs_delay<F>() at step j) are held in registers and written at
// its end, to ob[j * W] (the tensor route's staged box) or to yc (y at
// this lane's column), so no store stands between two steps' loads.
template <int F, int RC, int W, int ROWS, bool CHECK, bool TMA>
__device__ __forceinline__ void gs_stage(const float* slot, const float* prev_last, float* ob,
                                         float* yc, float (&cur)[F + 1], float (&prv)[F + 1],
                                         float& above, int d0, int h, int w, int lane,
                                         bool inner_col, bool store_lane) {
  float res[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int t = d0 + j - 1;
    const float* tp = j == 0 ? prev_last : slot + (j - 1) * RC;  // row t
    const float down = slot[j * RC + lane + 1];
    float nv[F + 1];
#pragma unroll
    for (int f = 1; f <= F; ++f) {
      // sweep f - 1 at rows r + 1 (lower) and r (old, and its neighbours)
      float lower, old, left, right;
      if (f == 1) {
        lower = down, old = above, left = tp[lane], right = tp[lane + 2];
      } else {
        lower = cur[f - 1], old = prv[f - 1];
        left = __shfl_up_sync(0xffffffffu, old, 1);
        right = __shfl_down_sync(0xffffffffu, old, 1);
      }
      const int r = t - 2 * (f - 1);
      const bool inner = inner_col && (!CHECK || (r >= 1 && r <= h - 2));
      const float s = __fadd_rn(__fadd_rn(__fadd_rn(cur[f], lower), left), right);
      nv[f] = inner ? __fmul_rn(0.25f, s) : old;
    }
#pragma unroll
    for (int f = 1; f <= F; ++f) {
      prv[f] = cur[f];
      cur[f] = nv[f];
    }
    above = down;
    res[j] = F == 0 ? down : cur[F];
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int row = d0 + j - gs_delay<F>();
    if (TMA) {
      if (store_lane) ob[j * W] = res[j];
    } else if (store_lane && (!CHECK || (row >= 0 && row < h))) {
      yc[static_cast<long long>(row) * w] = res[j];
    }
  }
}

// y (h, w) = x after F fused sweeps (a copy for F = 0). One warp a block,
// block b the strip of columns [b W, b W + W). x and y are distinct. TMA:
// tmx and tmy map x and y (w % 4 == 0, both 16-byte aligned), boxes of
// RC x ROWS and W x ROWS; else they are unused.
template <int F, bool TMA>
__global__ void __launch_bounds__(32)
    gauss_seidel_kernel(const float* __restrict__ x, float* __restrict__ y, int h, int w,
                        const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmy) {
  using Geo = GsGeom<F, TMA>;
  constexpr int G = Geo::G, W = Geo::W, RC = Geo::RC, kStage = Geo::kStage;
  constexpr int ROWS = Geo::ROWS, STAGES = Geo::STAGES;
  __shared__ __align__(128) float ring[STAGES * kStage];
  __shared__ __align__(128) float staged[TMA ? kGsBoxes * ROWS * W : 1];  // output boxes
  __shared__ uint64_t full[STAGES];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * W;       // the strip's first output column
  const int c_ring = c0 - G;           // the column left of lane 0's
  const int cs = TMA ? (c_ring & ~3) : c_ring;  // column of ring column 0
  const int c = c_ring + 1 + lane;     // this lane's column
  const bool inner_col = c >= 1 && c <= w - 2;
  const bool store_lane = lane >= G - 1 && lane < G - 1 + W && c < w;
  constexpr int D = gs_delay<F>();
  const int n_stages = (h + D + ROWS - 1) / ROWS;  // rows 0 .. h - 1 + D arrive
  // the 4-byte route: this lane's copies of a stage, element e = lane + 32 k
  // of its flat ROWS x RC run, at offset src[k] from the stage's first row
  long long src[TMA ? 1 : Geo::PER];
  unsigned long long col_ok = 0;
  if constexpr (TMA) {
    if (lane < STAGES) mbar_init(&full[lane]);
    fence_async_smem();
    __syncwarp();
  } else {
#pragma unroll
    for (int k = 0; k < Geo::PER; ++k) {
      const int e = lane + 32 * k, col = cs + e % RC;
      const bool ok = col >= 0 && col < w;
      col_ok |= static_cast<unsigned long long>(ok) << k;
      src[k] = ok ? static_cast<long long>(e / RC) * w + col : 0;
    }
  }
  auto issue = [&](int s) {
    if constexpr (TMA) {
      if (s < n_stages && lane == 0) {
        uint64_t* bar = &full[s % STAGES];
        fence_async_smem();  // the slot's last reads before the copy's writes
        mbar_expect(bar, kStage * 4);
        tensor_load(ring + (s % STAGES) * kStage, &tmx, cs, s * ROWS, bar);
      }
    } else {
      if (s < n_stages) {
        float* dst = ring + (s % STAGES) * kStage;
        const long long r0 = static_cast<long long>(s) * ROWS;
        const float* base = x + r0 * w;
        const bool all_rows = r0 + ROWS <= h;
#pragma unroll
        for (int k = 0; k < Geo::PER; ++k) {
          const bool ok =
              ((col_ok >> k) & 1) && (all_rows || r0 + (lane + 32 * k) / RC < h);
          cp4(dst + lane + 32 * k, ok ? base + src[k] : x, ok);
        }
      }
      cp_commit();  // empty past the last stage: the group count stays in step
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  float cur[F + 1], prv[F + 1];
#pragma unroll
  for (int f = 0; f <= F; ++f) cur[f] = prv[f] = 0.f;
  float above = 0.f;
  float* yc = y + (store_lane ? c : 0);
  const int off = c_ring - cs;  // ring column of column c_ring
  for (int s = 0; s < n_stages; ++s) {
    if constexpr (TMA)
      mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
    else
      cp_wait<STAGES - 2>();  // stage s has landed
    __syncwarp();
    const float* slot = ring + (s % STAGES) * kStage + off;
    const float* prev_last = ring + ((s + STAGES - 1) % STAGES) * kStage + kStage - RC + off;
    float* box = staged + (s % kGsBoxes) * ROWS * W;
    float* ob = box + (lane - (G - 1));
    const int d0 = s * ROWS;
    if (d0 >= 2 * F && d0 + ROWS - 2 <= h - 2)  // every row step interior
      gs_stage<F, RC, W, ROWS, false, TMA>(slot, prev_last, ob, yc, cur, prv, above, d0, h, w,
                                           lane, inner_col, store_lane);
    else
      gs_stage<F, RC, W, ROWS, true, TMA>(slot, prev_last, ob, yc, cur, prv, above, d0, h, w,
                                          lane, inner_col, store_lane);
    if constexpr (TMA) {
      if (d0 < D) {
        // the first box starts above row 0, where a tensor store may not
        // start: its rows 0 .. ROWS - 1 - D are stored a lane a column
        for (int j = D; j < ROWS; ++j)
          if (store_lane && j - D < h) yc[static_cast<long long>(j - D) * w] = ob[j * W];
      } else {
        // the stage's output box in one copy (rows and columns past the
        // grid are not written); a staged box is written again kGsBoxes
        // stages on, once its copy has read it
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          tensor_store(&tmy, c0, d0 - D, box);
          bulk_commit();
          bulk_wait_read<kGsBoxes - 1>();
        }
      }
    }
    __syncwarp();  // every lane has read the slot of stage s - 1
    issue(s + STAGES - 1);
  }
  if constexpr (TMA)
    if (lane == 0) bulk_wait_all();
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no libcuda
// link); null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                            12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A row-major fp32 map of `rank` (2 or 3) dims, dims[0] the fastest, with
// boxes of box[0] x box[1] (x box[2]), no swizzle, zeros outside. Returns
// false where it cannot be made.
bool tensor_map(CUtensorMap* map, const float* base, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[2], stride = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor route where every row of x and y starts 16-byte aligned (a
// map's base and row stride must be), else the 4-byte route.
template <int F>
int launch_gauss_seidel(const float* x, float* y, int h, int w, cudaStream_t st) {
  CUtensorMap tmx{}, tmy{};
  const bool tma = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  using Geo = GsGeom<F, true>;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h)};
  const cuuint32_t box_x[2] = {Geo::RC, Geo::ROWS}, box_y[2] = {Geo::W, Geo::ROWS};
  if (tma && !(tensor_map(&tmx, x, 2, dims, box_x) && tensor_map(&tmy, y, 2, dims, box_y)))
    return int(cudaErrorInvalidValue);
  const int W = tma ? GsGeom<F, true>::W : GsGeom<F, false>::W;
  const unsigned strips = static_cast<unsigned>((static_cast<long long>(w) + W - 1) / W);
  if (tma)
    gauss_seidel_kernel<F, true><<<strips, 32, 0, st>>>(x, y, h, w, tmx, tmy);
  else
    gauss_seidel_kernel<F, false><<<strips, 32, 0, st>>>(x, y, h, w, tmx, tmy);
  return int(cudaGetLastError());
}

int check_grid(long long blocks) {
  return blocks < 1 || blocks > 0x7fffffffLL ? int(cudaErrorInvalidValue) : 0;
}

// --- Jacobi 3-D --------------------------------------------------------------

constexpr int kJ3Threads = 256;
constexpr int kJ3X = 128, kJ3Y = 16;                   // output columns and rows a block
constexpr int kJ3BoxW = kJ3X + 4, kJ3BoxH = kJ3Y + 2;  // a plane's box: tile and halo
constexpr int kJ3Box = kJ3BoxW * kJ3BoxH;
constexpr int kJ3Stage = (kJ3Box + 31) / 32 * 32;     // a ring slot, a multiple of 128 bytes
constexpr int kJ3Stages = 8;                           // ring slots, kJ3Stages - 2 planes ahead
// dynamic shared memory a block: the ring, then a barrier a slot
constexpr int kJ3Smem = kJ3Stages * (kJ3Stage * 4 + 8);
constexpr int kJ3RowStep = kJ3Threads / kJ3X;          // rows between a thread's outputs
constexpr int kJ3Rows = kJ3Y / kJ3RowStep;             // output rows a thread
constexpr int kJ3Copies = (kJ3Box + kJ3Threads - 1) / kJ3Threads;  // 4-byte copies a thread a plane
constexpr long long kJ3Blocks = 16384;                 // blocks the chunks of z aim for

// One box of a 3-D tensor map into shared memory at coordinates (column,
// row, plane), completing on `bar`; elements outside the tensor are
// zero-filled.
__device__ __forceinline__ void tensor_load_3d(float* dst, const CUtensorMap* map, int col,
                                               int row, int plane, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(plane), "r"(smem_u32(bar))
      : "memory");
}

// o (d-2, h-2, w-2) = the 7-point mean of u (d, h, w)'s interior. Block
// (tile, chunk): output rows [y0, y0 + kJ3Y) and columns [x0, x0 + kJ3X)
// of output planes [z0, z0 + chunk), reading input planes z0 .. z0 + chunk
// + 1, each as the box of input rows [y0, y0 + kJ3BoxH) and columns [x0,
// x0 + kJ3BoxW) in ring slot (plane - z0) % kJ3Stages. TMA: tmu maps u (w
// % 4 == 0, 16-byte aligned) with boxes of one plane's box; else unused.
// Box elements outside u are zeros and feed only outputs outside o, which
// are not stored.
template <bool TMA>
__global__ void __launch_bounds__(kJ3Threads)
    jacobi3d_kernel(const float* __restrict__ u, float* __restrict__ o, int d, int h, int w,
                    int tiles_x, int chunk, const __grid_constant__ CUtensorMap tmu) {
  extern __shared__ __align__(128) unsigned char j3_smem[];
  float* ring = reinterpret_cast<float*>(j3_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kJ3Stages * kJ3Stage);
  const int t = threadIdx.x, tx = t % kJ3X, ty = t / kJ3X;
  const int x0 = (blockIdx.x % tiles_x) * kJ3X, y0 = (blockIdx.x / tiles_x) * kJ3Y;
  const int z0 = blockIdx.y * chunk;
  const int n_in = min(chunk, d - 2 - z0) + 2;  // input planes the chunk reads
  const long long plane = static_cast<long long>(h) * w;
  // the 4-byte route: this thread's copies of a box, element e = t +
  // kJ3Threads k at offset src[k] from its plane's first element
  long long src[TMA ? 1 : kJ3Copies];
  unsigned ok = 0;
  if constexpr (TMA) {
    if (t < kJ3Stages) mbar_init(&full[t]);
    fence_async_smem();
  } else {
#pragma unroll
    for (int k = 0; k < kJ3Copies; ++k) {
      const int e = t + kJ3Threads * k, r = e / kJ3BoxW, c = e - r * kJ3BoxW;
      const bool in = e < kJ3Box && y0 + r < h && x0 + c < w;
      ok |= unsigned(in) << k;
      src[k] = in ? static_cast<long long>(y0 + r) * w + x0 + c : 0;
    }
  }
  __syncthreads();
  // input plane z0 + p into its slot; past the chunk nothing (the 4-byte
  // route still commits a group, so the group count stays in step)
  auto issue = [&](int p) {
    float* dst = ring + (p % kJ3Stages) * kJ3Stage;
    if constexpr (TMA) {
      if (p < n_in && t == 0) {
        uint64_t* bar = &full[p % kJ3Stages];
        fence_async_smem();  // the slot's last reads before the copy's writes
        mbar_expect(bar, kJ3Box * 4);
        tensor_load_3d(dst, &tmu, x0, y0, z0 + p, bar);
      }
    } else {
      if (p < n_in) {
        const float* base = u + (z0 + p) * plane;
#pragma unroll
        for (int k = 0; k < kJ3Copies; ++k) {
          const int e = t + kJ3Threads * k;
          const bool in = (ok >> k) & 1;
          if (e < kJ3Box) cp4(dst + e, in ? base + src[k] : u, in);
        }
      }
      cp_commit();
    }
  };
  for (int p = 0; p < kJ3Stages - 2; ++p) issue(p);
  // centre of this thread's output row i (tile row ty + kJ3RowStep i) in a
  // slot, and its output at the chunk's first plane
  const int c0 = (ty + 1) * kJ3BoxW + tx + 1;
  const long long ow = w - 2;
  float* oc = o + (static_cast<long long>(z0) * (h - 2) + y0 + ty) * ow + x0 + tx;
  const bool col_ok = x0 + tx < w - 2;
  float below[kJ3Rows] = {}, at[kJ3Rows] = {};  // centres of planes p - 2 and p - 1
  for (int p = 0; p < n_in; ++p) {
    if constexpr (TMA)
      mbar_wait(&full[p % kJ3Stages], (p / kJ3Stages) & 1);
    else
      cp_wait<kJ3Stages - 3>();
    __syncthreads();  // plane p is in; no thread reads plane p - 2's slot any more
    issue(p + kJ3Stages - 2);
    const float* above_s = ring + (p % kJ3Stages) * kJ3Stage;
    const float* at_s = ring + ((p + kJ3Stages - 1) % kJ3Stages) * kJ3Stage;
#pragma unroll
    for (int i = 0; i < kJ3Rows; ++i) {
      const int ci = c0 + i * kJ3RowStep * kJ3BoxW;
      const float above = above_s[ci];
      if (p >= 2) {
        // output plane z0 + p - 2 (centre plane p - 1), the plain version's order
        float sum = __fadd_rn(below[i], above);
        sum = __fadd_rn(sum, at_s[ci - kJ3BoxW]);
        sum = __fadd_rn(sum, at_s[ci + kJ3BoxW]);
        sum = __fadd_rn(sum, at_s[ci - 1]);
        sum = __fadd_rn(sum, at_s[ci + 1]);
        if (col_ok && y0 + ty + i * kJ3RowStep < h - 2)
          oc[(static_cast<long long>(p - 2) * (h - 2) + i * kJ3RowStep) * ow] =
              __fmul_rn(static_cast<float>(1.0 / 6.0), sum);
      }
      below[i] = at[i];
      at[i] = above;
    }
  }
}

// The 3-D Jacobi grid: tiles of kJ3Y x kJ3X output points, and the d - 2
// output planes cut into chunks of `chunk` planes so that about kJ3Blocks
// blocks run.
struct Jacobi3dGrid {
  long long tiles;
  int tiles_x, chunks, chunk;
};

Jacobi3dGrid jacobi3d_grid(int d, int h, int w) {
  Jacobi3dGrid g;
  g.tiles_x = (w - 2 + kJ3X - 1) / kJ3X;
  g.tiles = static_cast<long long>(g.tiles_x) * ((h - 2 + kJ3Y - 1) / kJ3Y);
  const long long want = (kJ3Blocks + g.tiles - 1) / g.tiles;
  const int chunks = static_cast<int>(want < d - 2 ? want : d - 2);
  g.chunk = (d - 2 + chunks - 1) / chunks;
  g.chunks = (d - 2 + g.chunk - 1) / g.chunk;
  return g;
}

// The tensor route where u's rows start 16-byte aligned, else the 4-byte
// route.
int launch_jacobi3d(const float* u, float* o, int d, int h, int w, cudaStream_t st) {
  const Jacobi3dGrid g = jacobi3d_grid(d, h, w);
  if (int rc = check_grid(g.tiles)) return rc;
  CUtensorMap tmu{};
  const bool tma = w % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(d)};
  const cuuint32_t box[3] = {kJ3BoxW, kJ3BoxH, 1};
  if (tma && !tensor_map(&tmu, u, 3, dims, box)) return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(g.tiles), static_cast<unsigned>(g.chunks));
  auto kern = tma ? jacobi3d_kernel<true> : jacobi3d_kernel<false>;
  static bool configured[2] = {false, false};  // once per route
  if (!configured[tma]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kJ3Smem);
    if (e != cudaSuccess) return int(e);
    configured[tma] = true;
  }
  kern<<<grid, kJ3Threads, kJ3Smem, st>>>(u, o, d, h, w, g.tiles_x, g.chunk, tmu);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// o (h-2, w-2) = 5-point mean of the interior of u (h, w). Returns a CUDA
// error code (0 on success).
int stencil_jacobi_2d5pt(const void* u, void* o, int h, int w, void* stream) {
  if (h < 3 || w < 3) return int(cudaErrorInvalidValue);
  const int runs = (w - 2 + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(h - 2) * runs;
  if (int rc = check_grid(blocks)) return rc;
  jacobi2d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(o), w, runs);
  return int(cudaGetLastError());
}

// o (d-2, h-2, w-2) = 7-point mean of the interior of u (d, h, w).
int stencil_jacobi_3d7pt(const void* u, void* o, int d, int h, int w, void* stream) {
  if (d < 3 || h < 3 || w < 3) return int(cudaErrorInvalidValue);
  return launch_jacobi3d(static_cast<const float*>(u), static_cast<float*>(o), d, h, w,
                         static_cast<cudaStream_t>(stream));
}

// y (h, w) = x after `sweeps` Gauss-Seidel sweeps fused in one pass,
// 0 <= sweeps <= 4 (0 copies); x and y are distinct. Returns a CUDA error
// code.
int stencil_gauss_seidel_pass(const void* x, void* y, int h, int w, int sweeps,
                              void* stream) {
  if (h < 1 || w < 1 || h > 0x7fffffff - 64 || sweeps < 0 || sweeps > kGsMaxFused)
    return int(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sweeps) {
    case 0: return launch_gauss_seidel<0>(xf, yf, h, w, st);
    case 1: return launch_gauss_seidel<1>(xf, yf, h, w, st);
    case 2: return launch_gauss_seidel<2>(xf, yf, h, w, st);
    case 3: return launch_gauss_seidel<3>(xf, yf, h, w, st);
    default: return launch_gauss_seidel<4>(xf, yf, h, w, st);
  }
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
