// Design probes for the stream suite's elementwise body and its
// misaligned INIT on Hopper (sm_90a). Not part of the port: the variants
// here are what scripts/stream_probe.py times against each other to pick
// the design of src/repro_torch/kernels/csrc/stream.cu.
//
//   probe_elementwise  COPY, STREAM triad or Schoenauer triad in f32, with
//                      U 16-byte loads a thread in flight before its
//                      stores (U = 1 is the one-load grid-stride body),
//                      plain or ld.global.nc.L1::no_allocate loads, the
//                      tiles walked in turn by the grid or as one
//                      contiguous chunk a block, plain or st.global.cs
//                      stores, on a grid the caller sizes;
//   probe_tma_copy     COPY as TMA bulk copies: a ring of shared-memory
//                      stages, each filled by cp.async.bulk under an
//                      mbarrier and written back by a bulk store;
//   probe_init_partial INIT in 7 x COLS blocks (COLS = 100 is the
//                      misaligned subject, 104 is 416-byte rows, whole
//                      32-byte sectors): a warp a block on a resident grid
//                      or in one pass, a warp a row, or the parent's
//                      (32, 7) block of 4-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Op { COPY = 1, TRIAD = 4, SCHOENAUER = 5 };

template <int OP>
__host__ __device__ constexpr int n_inputs() {
  return OP == SCHOENAUER ? 3 : OP == TRIAD ? 2 : 1;
}

template <bool NC>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  if constexpr (NC) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  } else {
    return *p;
  }
}

template <bool NT>
__device__ __forceinline__ void store16(uint4* p, const uint4& v) {
  if constexpr (NT)
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x),
                 "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  else
    *p = v;
}

template <int OP>
__device__ __forceinline__ uint4 apply16(const uint4& a, const uint4& b, const uint4& c,
                                         float s) {
  if constexpr (OP == COPY) return a;
  const float* fa = reinterpret_cast<const float*>(&a);
  const float* fb = reinterpret_cast<const float*>(&b);
  const float* fc = reinterpret_cast<const float*>(&c);
  uint4 r;
  float* fo = reinterpret_cast<float*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    fo[k] = OP == TRIAD ? __fadd_rn(fa[k], __fmul_rn(s, fb[k]))
                        : __fadd_rn(fa[k], __fmul_rn(fb[k], fc[k]));
  return r;
}

template <int OP, bool NT, int U, bool NC, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
    elementwise_probe(const uint4* __restrict__ a, const uint4* __restrict__ b,
                      const uint4* __restrict__ c, uint4* __restrict__ o, long long nvec,
                      float s) {
  constexpr int IN = n_inputs<OP>();
  const int nt = blockDim.x;  // 128 or 256 threads
  const long long TILE = static_cast<long long>(nt) * U;
  const long long tiles = nvec / TILE;
  long long t0 = blockIdx.x, t1 = tiles, step = gridDim.x;
  if constexpr (CHUNKED) {  // tiles [t0, t1) of this block, in order
    const long long per = (tiles + gridDim.x - 1) / gridDim.x;
    t0 = blockIdx.x * per;
    t1 = t0 + per < tiles ? t0 + per : tiles;
    step = 1;
  }
  for (long long tt = t0; tt < t1; tt += step) {
    const long long i0 = tt * TILE + threadIdx.x;
    uint4 ra[U] = {}, rb[U] = {}, rc[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ra[u] = load16<NC>(a + i0 + u * nt);
      if constexpr (IN >= 2) rb[u] = load16<NC>(b + i0 + u * nt);
      if constexpr (IN >= 3) rc[u] = load16<NC>(c + i0 + u * nt);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) store16<NT>(o + i0 + u * nt, apply16<OP>(ra[u], rb[u], rc[u], s));
  }
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tiles * TILE + tid; i < nvec; i += stride) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    store16<NT>(o + i, apply16<OP>(load16<NC>(a + i), IN >= 2 ? load16<NC>(b + i) : z,
                                   IN >= 3 ? load16<NC>(c + i) : z, s));
  }
}

template <int OP, bool NT, int U, bool NC, bool CHUNKED>
int run(int grid, int threads, int* occupancy, const void* a, const void* b, const void* c,
        void* o, long long nvec, float s, cudaStream_t st) {
  const auto kern = elementwise_probe<OP, NT, U, NC, CHUNKED>;
  if (occupancy)
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kern, threads, 0));
  kern<<<grid, threads, 0, st>>>(static_cast<const uint4*>(a), static_cast<const uint4*>(b),
                                  static_cast<const uint4*>(c), static_cast<uint4*>(o), nvec,
                                  s);
  return int(cudaGetLastError());
}

template <int OP, bool NT, int U, bool NC>
int by_chunked(int chunked, int grid, int threads, int* occ, const void* a, const void* b, const void* c,
               void* o, long long nvec, float s, cudaStream_t st) {
  return chunked ? run<OP, NT, U, NC, true>(grid, threads, occ, a, b, c, o, nvec, s, st)
                 : run<OP, NT, U, NC, false>(grid, threads, occ, a, b, c, o, nvec, s, st);
}

template <int OP, bool NT, int U>
int by_nc(int nc, int chunked, int grid, int threads, int* occ, const void* a, const void* b,
          const void* c, void* o, long long nvec, float s, cudaStream_t st) {
  return nc ? by_chunked<OP, NT, U, true>(chunked, grid, threads, occ, a, b, c, o, nvec, s, st)
            : by_chunked<OP, NT, U, false>(chunked, grid, threads, occ, a, b, c, o, nvec, s, st);
}

template <int OP, bool NT>
int by_u(int u, int nc, int chunked, int grid, int threads, int* occ, const void* a, const void* b,
         const void* c, void* o, long long nvec, float s, cudaStream_t st) {
  switch (u) {
    case 1: return by_nc<OP, NT, 1>(nc, chunked, grid, threads, occ, a, b, c, o, nvec, s, st);
    case 2: return by_nc<OP, NT, 2>(nc, chunked, grid, threads, occ, a, b, c, o, nvec, s, st);
    case 4: return by_nc<OP, NT, 4>(nc, chunked, grid, threads, occ, a, b, c, o, nvec, s, st);
    case 8: return by_nc<OP, NT, 8>(nc, chunked, grid, threads, occ, a, b, c, o, nvec, s, st);
  }
  return int(cudaErrorInvalidValue);
}

template <int OP>
int by_nt(int nt, int u, int nc, int chunked, int grid, int threads, int* occ, const void* a,
          const void* b, const void* c, void* o, long long nvec, float s, cudaStream_t st) {
  return nt ? by_u<OP, true>(u, nc, chunked, grid, threads, occ, a, b, c, o, nvec, s, st)
            : by_u<OP, false>(u, nc, chunked, grid, threads, occ, a, b, c, o, nvec, s, st);
}

// --- TMA bulk copy ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread of the block drives a ring of `stages` chunks of `chunk`
// bytes: chunk i of the block loads into stage i % stages under its
// mbarrier; when it has arrived, a bulk store writes it back; a stage is
// loaded again once the store of its last chunk has read it, one store
// behind, so a store and stages - 1 loads stay in flight.
__global__ void __launch_bounds__(32)
    tma_copy_probe(const char* __restrict__ src, char* __restrict__ dst, long long nbytes,
                   int chunk, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long bar[16];
  if (threadIdx.x != 0) return;
  for (int i = 0; i < stages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar + i)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const long long n_chunks = nbytes / chunk;
  // this block's chunks: blockIdx.x + k * gridDim.x
  const long long mine = n_chunks > blockIdx.x ? (n_chunks - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto issue_load = [&](long long k) {
    const int st = static_cast<int>(k % stages);
    const long long off = (blockIdx.x + k * gridDim.x) * chunk;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_u32(bar + st)),
                 "r"(chunk)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_u32(ring + static_cast<size_t>(st) * chunk)),
        "l"(src + off), "r"(chunk), "r"(smem_u32(bar + st))
        : "memory");
  };
  for (long long k = 0; k < mine && k < stages; ++k) issue_load(k);
  for (long long k = 0; k < mine; ++k) {
    const int st = static_cast<int>(k % stages);
    const unsigned parity = static_cast<unsigned>((k / stages) & 1);
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, "
          "1, 0, p; }"
          : "=r"(done)
          : "r"(smem_u32(bar + st)), "r"(parity)
          : "memory");
    const long long off = (blockIdx.x + k * gridDim.x) * chunk;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst + off),
                 "r"(smem_u32(ring + static_cast<size_t>(st) * chunk)), "r"(chunk)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (k >= 1 && k - 1 + stages < mine) {
      // refill the stage of chunk k - 1 once its store has read it (the
      // store of chunk k may still be reading)
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue_load(k - 1 + stages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// --- INIT in 7 x COLS blocks -----------------------------------------------

// One row of a block, [0, len) at p, by the lanes of one warp: 16-byte
// stores where the row is aligned, one element a lane at head and tail.
__device__ __forceinline__ void fill_row16(float* p, int len, float s, const uint4& v16,
                                           int lane) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15) / 4;
  const int head = len < (mis ? 4 - mis : 0) ? len : (mis ? 4 - mis : 0);
  const int nvec = (len - head) / 4, tail0 = head + nvec * 4;
  for (int i = lane; i < nvec; i += 32) reinterpret_cast<uint4*>(p + head)[i] = v16;
  const int e = 31 - lane;
  if (e < head)
    p[e] = s;
  else if (e - head < len - tail0)
    p[tail0 + e - head] = s;
}

// MODE 0: a warp a block, the resident warps walking the blocks in turn;
// 1: a warp a block, one pass (a grid of blocks / 8 blocks of 256);
// 2: a thread block of 7 warps a block, warp r writing row r;
// 3: the parent's kernel: a (32, 7) thread block a block, 4-byte stores.
// Modes 0-2 write with 16-byte stores.
template <int COLS, int MODE>
__global__ void init_partial_probe(float* __restrict__ o, long long m, long long n,
                                   long long gm, long long gn, float s) {
  const uint4 v16 = make_uint4(__float_as_uint(s), __float_as_uint(s), __float_as_uint(s),
                               __float_as_uint(s));
  if constexpr (MODE == 2 || MODE == 3) {
    const long long blk = blockIdx.x;
    const long long bi = blk / gn, bj = blk - bi * gn;
    const int warp = MODE == 2 ? threadIdx.x / 32 : threadIdx.y;
    const int lane = MODE == 2 ? threadIdx.x & 31 : threadIdx.x;
    const long long r = bi * 7 + warp;
    if (r >= m) return;
    const long long c0 = bj * COLS;
    const int len = static_cast<int>(n - c0 < COLS ? n - c0 : COLS);
    float* p = o + r * n + c0;
    if constexpr (MODE == 2)
      fill_row16(p, len, s, v16, lane);
    else
      for (int j = lane; j < len; j += 32) p[j] = s;
  } else {
    const int lane = threadIdx.x & 31;
    const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
    for (long long blk = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
         blk < gm * gn; blk += warps) {
      const long long bi = blk / gn, bj = blk - bi * gn;
      const long long r0 = bi * 7, c0 = bj * COLS;
      const int len = static_cast<int>(n - c0 < COLS ? n - c0 : COLS);
      const int rows = static_cast<int>(m - r0 < 7 ? m - r0 : 7);
      for (int r = 0; r < rows; ++r) fill_row16(o + (r0 + r) * n + c0, len, s, v16, lane);
      if constexpr (MODE == 1) break;
    }
  }
}

template <int COLS, int MODE>
int run_init(int* occ, void* o, long long m, long long n, float s, cudaStream_t st) {
  const auto kern = init_partial_probe<COLS, MODE>;
  const long long gm = (m + 6) / 7, gn = (n + COLS - 1) / COLS;
  if constexpr (MODE == 0) {
    return occ ? int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, 0))
               : int(cudaErrorInvalidValue);  // runs on its grid
  } else if constexpr (MODE == 1) {
    kern<<<static_cast<unsigned>((gm * gn + 7) / 8), kThreads, 0, st>>>(
        static_cast<float*>(o), m, n, gm, gn, s);
  } else if constexpr (MODE == 2) {
    kern<<<static_cast<unsigned>(gm * gn), 7 * 32, 0, st>>>(static_cast<float*>(o), m, n, gm,
                                                           gn, s);
  } else {
    kern<<<static_cast<unsigned>(gm * gn), dim3(32, 7), 0, st>>>(static_cast<float*>(o), m, n,
                                                                gm, gn, s);
  }
  return int(cudaGetLastError());
}

template <int COLS>
int run_init_resident(int grid, void* o, long long m, long long n, float s, cudaStream_t st) {
  const long long gm = (m + 6) / 7, gn = (n + COLS - 1) / COLS;
  init_partial_probe<COLS, 0><<<grid, kThreads, 0, st>>>(static_cast<float*>(o), m, n, gm, gn, s);
  return int(cudaGetLastError());
}

template <int COLS>
int by_mode(int mode, int grid, int* occ, void* o, long long m, long long n, float s,
            cudaStream_t st) {
  switch (mode) {
    case 0: return occ ? run_init<COLS, 0>(occ, o, m, n, s, st)
                       : run_init_resident<COLS>(grid, o, m, n, s, st);
    case 1: return run_init<COLS, 1>(occ, o, m, n, s, st);
    case 2: return run_init<COLS, 2>(occ, o, m, n, s, st);
    case 3: return run_init<COLS, 3>(occ, o, m, n, s, st);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// o = op(a, b, c) over nvec 16-byte vectors of f32 (op 1 = COPY, 4 =
// STREAM triad, 5 = Schoenauer) on `grid` blocks of `threads`. With
// `occupancy` non-null, writes the variant's resident blocks an SM there
// instead of launching.
int probe_elementwise(int op, int nt, int u, int nc, int chunked, int grid, int threads,
                      int* occupancy, const void* a, const void* b, const void* c, void* o,
                      long long nvec, float s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case COPY:
      return by_nt<COPY>(nt, u, nc, chunked, grid, threads, occupancy, a, b, c, o, nvec, s, st);
    case TRIAD:
      return by_nt<TRIAD>(nt, u, nc, chunked, grid, threads, occupancy, a, b, c, o, nvec, s, st);
    case SCHOENAUER:
      return by_nt<SCHOENAUER>(nt, u, nc, chunked, grid, threads, occupancy, a, b, c, o, nvec,
                               s, st);
  }
  return int(cudaErrorInvalidValue);
}

// dst = src, nbytes (a multiple of chunk, chunk a multiple of 16) as TMA
// bulk copies through `stages` shared-memory stages a block.
int probe_tma_copy(const void* src, void* dst, long long nbytes, int chunk, int stages,
                   int grid, void* stream) {
  if (stages < 1 || stages > 16 || chunk % 16 || nbytes % chunk) return int(cudaErrorInvalidValue);
  const int shm = chunk * stages;
  cudaError_t e = cudaFuncSetAttribute(tma_copy_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, shm);
  if (e != cudaSuccess) return int(e);
  tma_copy_probe<<<grid, 32, shm, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), nbytes, chunk, stages);
  return int(cudaGetLastError());
}

// o[:m, :n] = s in 7 x cols blocks (cols 100 or 104) by mode 0-3 (see
// init_partial_probe); mode 0 runs on `grid` blocks, and with `occupancy`
// non-null writes its resident blocks an SM there instead.
int probe_init_partial(int cols, int mode, int grid, int* occupancy, void* o, long long m,
                       long long n, float s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols == 100) return by_mode<100>(mode, grid, occupancy, o, m, n, s, st);
  if (cols == 104) return by_mode<104>(mode, grid, occupancy, o, m, n, s, st);
  return int(cudaErrorInvalidValue);
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
