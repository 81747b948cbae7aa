// The paper's stencil kernels for Hopper (sm_90a): 2-D 5-point and 3-D
// 7-point Jacobi sweeps and the 2-D 5-point Gauss-Seidel row wavefront,
// all in fp32.
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
// written once. Its dependency across rows is only column j's new value
// of row i-1, which a thread can carry in a register, and the sweeps
// pipeline, so its chain is only about (rows + sweeps) x 4 dependent
// fp32 operations. This one-block design pays a barrier and an L2 round
// trip a row instead of that register hop.
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
// Gauss-Seidel: one block of 1024 threads walks the rows in order,
// sweeps times; thread t owns columns 1 + t + 1024 k, any number of them.
// For row i a thread reads, for each of its columns, the row above after
// its update (its own write of the step before), the row below before its
// update, and the left and right neighbours of row i BEFORE its update,
// and computes the new value; it waits at the barrier until every thread
// has read row i, and only then writes them. (A sweep that wrote as it
// went would read updated left neighbours: not the TPU kernel's semantics,
// which reads row i whole before writing it.) Between read and write the
// new values are staged: the first 16 of a thread's columns (interior
// widths up to 16,384) in registers, the rest in a scratch row of w floats
// that the wrapper allocates. Column j's slot of the scratch row is
// written and read back by the thread that owns column j only, so it
// needs no barrier of its own, and any width works; a width within the
// registers never touches the scratch row. The first sweep reads the old
// values from the input and writes the output, so the copy of the input
// is folded into it: the boundary rows and columns are copied unchanged
// and nothing else is copied. A barrier ends each sweep: with one interior
// row (h == 3) the next sweep reads that row's neighbours, which other
// threads wrote after the row's barrier.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGsThreads = 1024;
constexpr int kGsCols = 16;  // columns a Gauss-Seidel thread stages in registers

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

// u and o are distinct; o is read back, so neither is __restrict__.
// scratch holds w floats; it is read only where w - 2 > kGsThreads * kGsCols.
__global__ void __launch_bounds__(kGsThreads)
    gauss_seidel_kernel(const float* u, float* o, float* scratch, int h, int w,
                        int sweeps) {
  const int t = threadIdx.x;
  const long long hw = static_cast<long long>(h) * w;
  if (sweeps < 1 || h < 3 || w < 3) {  // no interior point changes
    for (long long e = t; e < hw; e += kGsThreads) o[e] = u[e];
    return;
  }
  const long long last = static_cast<long long>(h - 1) * w;
  for (int j = t; j < w; j += kGsThreads) {  // boundary rows
    o[j] = u[j];
    o[last + j] = u[last + j];
  }
  for (int i = 1 + t; i < h - 1; i += kGsThreads) {  // boundary columns
    const long long r = static_cast<long long>(i) * w;
    o[r] = u[r];
    o[r + w - 1] = u[r + w - 1];
  }
  __syncthreads();
  // the first column past the registers' (the scratch row's first)
  const int j_spill = 1 + t + kGsCols * kGsThreads;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    const float* old = sweep == 0 ? u : o;  // values before this sweep
    for (int i = 1; i < h - 1; ++i) {
      const long long r = static_cast<long long>(i) * w;
      // row i-1 updated, row i+1 and row i's neighbours old
      auto point = [&](int j) {
        const float up = o[r - w + j];
        const float s = __fadd_rn(__fadd_rn(__fadd_rn(up, old[r + w + j]), old[r + j - 1]),
                                  old[r + j + 1]);
        return __fmul_rn(0.25f, s);
      };
      float nv[kGsCols];
#pragma unroll
      for (int k = 0; k < kGsCols; ++k) {
        const int j = 1 + t + k * kGsThreads;
        if (j < w - 1) nv[k] = point(j);
      }
      for (int j = j_spill; j < w - 1; j += kGsThreads) scratch[j] = point(j);
      __syncthreads();  // every thread has read row i's old values
#pragma unroll
      for (int k = 0; k < kGsCols; ++k) {
        const int j = 1 + t + k * kGsThreads;
        if (j < w - 1) o[r + j] = nv[k];
      }
      for (int j = j_spill; j < w - 1; j += kGsThreads) o[r + j] = scratch[j];
    }
    __syncthreads();  // this sweep's writes before the next sweep's reads
  }
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

// o (h, w) = u after `sweeps` Gauss-Seidel sweeps; scratch holds w
// floats (unused where w - 2 <= 16384).
int stencil_gauss_seidel_2d5pt(const void* u, void* o, void* scratch, int h, int w,
                               int sweeps, void* stream) {
  if (h < 1 || w < 1 || sweeps < 0 || (w - 2 > kGsThreads * kGsCols && scratch == nullptr))
    return int(cudaErrorInvalidValue);
  gauss_seidel_kernel<<<1, kGsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(o), static_cast<float*>(scratch),
      h, w, sweeps);
  return int(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
