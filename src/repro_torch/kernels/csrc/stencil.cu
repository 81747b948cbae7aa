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
// Design. Jacobi: one thread an output point, a block a 256-point run of
// one output row; the block's id names the row (and plane) and the run,
// so any shape works (the TPU wrapper asserts (H-2) % bm == 0 and
// (D-2) % bz == 0). Each thread reads its neighbours from global memory;
// the runs of neighbouring rows are read by blocks scheduled together, so
// the halo rows come from L1 or L2 and device memory sees each input byte
// about once. The sums run in the plain version's order with the _rn
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

__global__ void __launch_bounds__(kThreads)
    jacobi3d_kernel(const float* __restrict__ u, float* __restrict__ o, int h, int w,
                    int runs) {
  const long long row = blockIdx.x / runs;  // (z, y) of the output
  const int x = (blockIdx.x % runs) * kThreads + threadIdx.x;
  const int oh = h - 2, ow = w - 2;
  if (x >= ow) return;
  const long long z = row / oh, y = row % oh;
  const long long plane = static_cast<long long>(h) * w;
  const long long c = (z + 1) * plane + (y + 1) * w + x + 1;
  float s = __fadd_rn(u[c - plane], u[c + plane]);
  s = __fadd_rn(s, u[c - w]);
  s = __fadd_rn(s, u[c + w]);
  s = __fadd_rn(s, u[c - 1]);
  s = __fadd_rn(s, u[c + 1]);
  o[row * ow + x] = __fmul_rn(static_cast<float>(1.0 / 6.0), s);
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

// A row-major (h, w) fp32 map with boxes of box_w x box_h, no swizzle,
// zeros outside. Returns false where it cannot be made.
bool tensor_map(CUtensorMap* map, const float* base, int h, int w, int box_w, int box_h) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(w) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
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
  if (tma && !(tensor_map(&tmx, x, h, w, Geo::RC, Geo::ROWS) &&
               tensor_map(&tmy, y, h, w, Geo::W, Geo::ROWS)))
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
  const int runs = (w - 2 + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(d - 2) * (h - 2) * runs;
  if (int rc = check_grid(blocks)) return rc;
  jacobi3d_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(o), h, w, runs);
  return int(cudaGetLastError());
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
