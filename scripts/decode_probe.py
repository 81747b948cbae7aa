#!/usr/bin/env python3
"""Design variants of the decode kernels (``csrc/decode.cu``), timed in
turns on one card at the three served shapes, kernel by kernel and as a
decode step.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/decode_probe.py [--kernels-only] [<variant> ...]

Each variant is ``csrc/decode.cu`` with a few lines replaced (see
``VARIANTS``; a replacement that no longer matches fails loudly), built
for bf16 at Dh 128 and 256 only (the served instances), all at once, each
into a directory of its own under the build directory, and driven
through the same wrappers by swapping which library ``build.load`` hands
them. ``base`` is the source as it stands, built the same way. Printed:

- each variant's registers and spills (ptxas) by instance;
- kernel µs (device time by profiler, ``chip_smoke.timed``), the mean of
  two windows taken in turns (variants in order, then in reverse), at
  yi-9b's served shape dense and paged (B 8, H 32, Hkv 4, Dh 128, 2904
  live rows, the step's row written in the launch) and gemma3-4b's
  served shape (H 8, Hkv 4, Dh 256, the 1792-row bucket, 12261 live
  rows), each at the serving path's split plan;
- ms a decode step: yi-9b (48 layers) dense and paged and gemma3-4b (34
  layers) dense at full width with random weights, 8 slots, one 8-token
  chunk captured as a CUDA graph at its ``kv_len`` bucket (one capture a
  variant) and replayed; the best of 5 windows of 10 replays by CUDA
  events, divided by 8, the mean of two rounds taken in turns as above;
- for the programmatic-launch variants (launched through
  cudaLaunchKernelEx, after which the profiler may lose events of later
  windows: their kernel times are retaken windows), the graph's
  programmatic edges
  (a capture of the chunk kept as a graph, its edges counted by type
  with ``cudaGraphGetEdges_v2`` from a helper compiled beside the
  variants), and whether the chunk's tokens and cache rows equal the
  eager chunk's.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: the programmatic dependent launch: the attribute on the launch, and
#: griddepcontrol.wait before every read (pdl1) or after pos, the page
#: table and the first tiles of old rows (pdl2)
PDL_LAUNCH = (
    r"  Bd::kern<<<dim3\(a\.Hkv \* groups, n_splits, a\.B\), Bd::threads, "
    r"Bd::smem, stream>>>\(a\);\n",
    "  cudaLaunchConfig_t cfg = {};\n"
    "  cfg.gridDim = dim3(a.Hkv * groups, n_splits, a.B);\n"
    "  cfg.blockDim = dim3(Bd::threads);\n"
    "  cfg.dynamicSmemBytes = Bd::smem;\n"
    "  cfg.stream = stream;\n"
    "  cudaLaunchAttribute at[1];\n"
    "  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
    "  at[0].val.programmaticStreamSerializationAllowed = 1;\n"
    "  cfg.attrs = at;\n"
    "  cfg.numAttrs = 1;\n"
    "  const cudaError_t le = cudaLaunchKernelEx(&cfg, Bd::kern, a);\n"
    "  if (le != cudaSuccess) return int(le);\n")
POS_READ = (r"  const int p0 = __ldg\(p\.pos \+ b\);\n"
            r"  const Span sp = split_span<BK, PAGED, WRITE>\(p, p0, s\);\n")
PDL1 = [(POS_READ + r"  const int last_col", "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
         "  const int p0 = __ldg(p.pos + b);\n"
         "  const Span sp = split_span<BK, PAGED, WRITE>(p, p0, s);\n"
         "  const int last_col"),
        (POS_READ + r"  auto issue", "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
         "  const int p0 = __ldg(p.pos + b);\n"
         "  const Span sp = split_span<BK, PAGED, WRITE>(p, p0, s);\n"
         "  auto issue"),
        PDL_LAUNCH]
PDL2 = [(r"  // packed query rows r0 \+ r = j\*G \+ g \(query token j, head "
         r"kvh\*G \+ g\),\n  // bf16",
         "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n  // packed query rows r0 + r = j*G + g "
         "(query token j, head kvh*G + g),\n  // bf16"),
        (r"  // a writer block \(WRITE: split 0, row group 0\) writes the new "
         r"rows while\n  // its first tiles are in flight\n  if \(WRITE && s "
         r"== 0 && blockIdx\.x < p\.Hkv\)\n    write_rows<DH, PAGED, float",
         "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n  // a writer block (WRITE: split 0, row "
         "group 0) writes the new rows while\n  // its first tiles are in "
         "flight\n  if (WRITE && s == 0 && blockIdx.x < p.Hkv)\n    "
         "write_rows<DH, PAGED, float"),
        PDL_LAUNCH]
STAGES_LINE = (r"static constexpr int STAGES = sizeof\(T\) == 4 \? 2 : "
               r"\(DH > 128 \? 2 : 3\);")
TILE_LINE = (r"static constexpr int BK = sizeof\(T\) == 4 \? 32 : "
             r"\(DH > 128 \? 32 : 64\);")
TWO_BLOCKS = r"static constexpr int N = MAXR == 8 \|\| DH \* MAXR <= 1024 \? 2 : 1;"

#: the merge the design had first, for the ``cluster`` variant: the
#: splits of a row group one thread-block cluster (the function's required
#: cluster shape, set before a plain launch); each block's (m, l, acc)
#: stays in its shared memory, and block 0 reads the others' through
#: distributed shared memory between two cluster barriers, in split
#: order, with no scratch and no counter
CLUSTER_MERGE = r'''
// The address of shared-memory object `p` in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_map(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// Loads from another block's shared memory (an address from cluster_map).
__device__ __forceinline__ float cluster_ld(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 cluster_ld4(unsigned a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// The cluster barrier, in two halves: arrive (release: this thread's
// writes to shared memory become visible to the cluster) and wait
// (acquire). Every thread of every block of the cluster takes part; the
// warps of a block may reach it from different places (no .aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <int DH, int MAXR, int NTH, typename T>
__device__ __forceinline__ void split_merge_end(const float* o_s, const float* ml_s, int* flag,
                                                const Params& p, int G, int kvh, int r0, int R,
                                                int b) {
  constexpr int V4 = DH / 4;
  const int S = gridDim.y;
  T* out = static_cast<T*>(p.out);
  cluster_arrive();
  cluster_wait();
  for (int i = threadIdx.x; blockIdx.y == 0 && i < R * V4; i += NTH) {
    const int r = i / V4, c = (i - r * V4) * 4;
    float mv[MAX_MERGE], lv[MAX_MERGE];
    float4 ov[MAX_MERGE];
#pragma unroll
    for (int u = 0; u < MAX_MERGE; ++u) {
      if (u < S) {
        mv[u] = cluster_ld(cluster_map(ml_s + r, u));
        lv[u] = cluster_ld(cluster_map(ml_s + MAXR + r, u));
        ov[u] = cluster_ld4(cluster_map(o_s + r * DH + c, u));
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
    const int j = (r0 + r) / G, g = r0 + r - j * G;
    const size_t base = (size_t(b) * p.Sq + j) * p.H + kvh * G + g;
    store_out4(out + base * DH + c, make_float4(o.x / d, o.y / d, o.z / d, o.w / d));
  }
  cluster_arrive();
  cluster_wait();
}
'''
#: the cluster shape, set on the function before its plain launch
CLUSTER_LAUNCH = (
    r"  Bd::kern<<<",
    "  const int cy = a.out != nullptr && n_splits > 1 ? n_splits : 0;\n"
    "  static int cluster = 0;\n"
    "  if (cy != cluster) {\n"
    "    cudaError_t e = cudaFuncSetAttribute(Bd::kern, "
    "cudaFuncAttributeRequiredClusterWidth, cy ? 1 : 0);\n"
    "    if (e == cudaSuccess)\n"
    "      e = cudaFuncSetAttribute(Bd::kern, "
    "cudaFuncAttributeRequiredClusterHeight, cy);\n"
    "    if (e == cudaSuccess)\n"
    "      e = cudaFuncSetAttribute(Bd::kern, "
    "cudaFuncAttributeRequiredClusterDepth, cy ? 1 : 0);\n"
    "    if (e != cudaSuccess) return int(e);\n"
    "    cluster = cy;\n"
    "  }\n"
    "  Bd::kern<<<")

#: name: (what it changes, [(regex, replacement), ...] in csrc/decode.cu)
VARIANTS = {
    "base": ("the source as it stands", []),
    "stages1": ("one ring stage (bf16)", [(
        STAGES_LINE, "static constexpr int STAGES = sizeof(T) == 4 ? 2 : 1;")]),
    "stages2": ("two ring stages (bf16)", [(
        STAGES_LINE, "static constexpr int STAGES = sizeof(T) == 4 ? 2 : 2;")]),
    "tile128": ("bf16 tiles of twice the keys (128, 64 at Dh 256) in two "
                "stages, one block an SM", [
        (TILE_LINE, "static constexpr int BK = sizeof(T) == 4 ? 32 : "
                    "(DH > 128 ? 64 : 128);"),
        (STAGES_LINE, "static constexpr int STAGES = sizeof(T) == 4 ? 2 : 2;"),
        (TWO_BLOCKS, "static constexpr int N = 1;")]),
    "pdl1": ("programmatic launch, every read after the wait", PDL1),
    "pdl2": ("programmatic launch, pos, the table and the first old tiles "
             "before the wait", PDL2),
    "cluster": ("the splits of a row group one thread-block cluster, "
                "merged through distributed shared memory", [
        (r"(?s)// The split merge, at the end of every block.*?\n}\n",
         CLUSTER_MERGE.replace("\\", "\\\\")),
        CLUSTER_LAUNCH]),
}

#: only the served instances: bf16 at Dh 128 and 256
TRIM = [(r"    case 32: return launch_rows<T, 32, PAGED>\(a, ns, st\);\n", ""),
        (r"    case 64: return launch_rows<T, 64, PAGED>\(a, ns, st\);\n", ""),
        (r"  if \(dtype == 0\) return launch_dh<float, PAGED>\(Dh, a, ns, st\);\n",
         "")]

EDGES_CU = r'''
#include <cuda_runtime.h>
#include <vector>
// programmatic edges of a CUDA graph, and all its edges in *total
extern "C" int programmatic_edges(void* graph, int* total) {
  size_t n = 0;
  if (cudaGraphGetEdges_v2(static_cast<cudaGraph_t>(graph), nullptr, nullptr, nullptr, &n))
    return -1;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
  if (cudaGraphGetEdges_v2(static_cast<cudaGraph_t>(graph), from.data(), to.data(),
                           data.data(), &n))
    return -2;
  int k = 0;
  for (const auto& d : data) k += d.type == cudaGraphDependencyTypeProgrammatic;
  *total = int(n);
  return k;
}
'''


def replaced(src: str, pairs, name: str) -> str:
    for old, new in pairs:
        src, n = re.subn(old, new, src, count=1)
        if n != 1:
            raise ValueError(f"variant {name}: {old!r} not in decode.cu")
    return src


def build_variants(build, chip_smoke, names) -> tuple:
    """Every named variant compiled at once, and the edge helper;
    ``({name: library}, helper)``."""
    from torch._C import _demangle

    from repro_torch.kernels.attention import decode as D
    src = (build.CSRC / "decode.cu").read_text()
    jobs = {}
    for name in names:
        text = replaced(replaced(src, VARIANTS[name][1], name), TRIM, name)
        d = build.BUILD_DIR / f"decode_probe_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode.cu").write_text(text)
        jobs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(d / "lib.so"), str(d / "decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    edges_dir = build.BUILD_DIR / "decode_probe_edges"
    edges_dir.mkdir(parents=True, exist_ok=True)
    (edges_dir / "edges.cu").write_text(EDGES_CU)
    helper = subprocess.run(
        [build.nvcc(), "-std=c++17", "-O2", "-shared", "-Xcompiler", "-fPIC",
         "-o", str(edges_dir / "lib.so"), str(edges_dir / "edges.cu")],
        capture_output=True, text=True)
    edges = None
    if helper.returncode == 0:
        edges = ctypes.CDLL(str(edges_dir / "lib.so"))
        edges.programmatic_edges.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_int)]
        edges.programmatic_edges.restype = ctypes.c_int
    else:
        print(f"decode_probe: the edge helper did not build: "
              f"{helper.stderr[-800:]}")
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log[-4000:]}")
        regs = {re.search(r"decode\w*<[^>]*>", _demangle(k)).group(0): r
                for k, r in chip_smoke.ptxas_kernels(log).items()}
        print(f"variant {name} ({VARIANTS[name][0]}): " + "; ".join(
            f"{k} {r[0]} regs, {r[1]}/{r[2]} spill"
            for k, r in sorted(regs.items())))
        lib = libs[name] = ctypes.CDLL(
            str(build.BUILD_DIR / f"decode_probe_{name}" / "lib.so"))
        for fn, argtypes in D._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return libs, edges


def kernel_cases(torch, chip_smoke, D) -> dict:
    """label: a call of the finished kernel with the step's row write at
    a served shape, cycling through layers' caches."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, n_layers = 8, 16
    lens = [300, 410, 180, 471, 350, 260, 500, 433]
    pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kc = torch.randn(n_layers, b, 2048, 4, 128, generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn_like(kc)
    q = torch.randn(b, 1, 32, 128, generator=gen, device="cuda").bfloat16()
    kn = torch.randn(b, 1, 4, 128, generator=gen, device="cuda").bfloat16()
    vn = torch.randn_like(kn)
    ps = 16
    kp = kc.view(n_layers, -1, ps, 4, 128)
    vp = vc.view(n_layers, -1, ps, 4, 128)
    nb = -(-(max(lens) + 1) // ps)
    bt = torch.randperm(kp.shape[1] - 1, generator=torch.Generator(
        ).manual_seed(13))[:b * nb].reshape(b, nb).int().cuda()
    gk = torch.randn(n_layers, b, 2048, 4, 256, generator=gen,
                     device="cuda").bfloat16()
    gv = torch.randn_like(gk)
    gq = torch.randn(b, 1, 8, 256, generator=gen, device="cuda").bfloat16()
    gkn = torch.randn(b, 1, 4, 256, generator=gen, device="cuda").bfloat16()
    gpos = torch.randint(*chip_smoke.GEMMA_PROMPT_LENS, (b,),
                         generator=torch.Generator().manual_seed(23),
                         dtype=torch.int32).cuda() + 32
    gbound = min(-(-(int(gpos.max()) + 1) // 128) * 128, 2048)
    layer = [0]

    def nxt():
        layer[0] = (layer[0] + 1) % n_layers
        return layer[0]

    return {
        "yi-9b dense": lambda: D.flash_decode(
            q, kc[nxt()], vc[layer[0]], pos, kv_len=512, impl="cuda",
            k_new=kn, v_new=vn),
        "yi-9b paged": lambda: D.flash_decode_paged(
            q, kp[nxt()], vp[layer[0]], bt, pos, impl="cuda", k_new=kn,
            v_new=vn),
        "gemma3-4b served": lambda: D.flash_decode(
            gq, gk[nxt()], gv[layer[0]], gpos, kv_len=gbound, impl="cuda",
            k_new=gkn, v_new=gkn),
    }


def step_cells(torch, chip_smoke) -> dict:
    """label: (cfg, params, cache, tokens, pos, tables, kv_len) of a decode
    chunk at full width: yi-9b dense and paged (one set of weights) and
    gemma3-4b dense."""
    from repro_torch.bench._common import model
    from repro_torch.models import model as M
    from repro_torch.serve.pages import init_paged_cache
    gen = torch.Generator(device="cuda").manual_seed(31)
    cells = {}
    for arch, lens in (("yi-9b", [300, 410, 180, 471, 350, 260, 500, 433]),
                       ("gemma3-4b", None)):
        cfg, params = model(arch, "cuda", seed=41, dtype="bfloat16")
        if lens is None:
            lens = (torch.randint(*chip_smoke.GEMMA_PROMPT_LENS, (8,),
                                  generator=torch.Generator().manual_seed(
                                      23)) + 32).tolist()
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        kv_len = -(-(max(lens) + 8) // 128) * 128
        tok = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen,
                            device="cuda")
        cache = M.init_cache(cfg, 8, 2048, "cuda")
        for leaf in chip_smoke._leaves(cache):
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
        cells[f"{arch} dense"] = (cfg, params, cache, tok, pos, None, kv_len)
        if arch == "yi-9b":
            ps, per = 16, 2048 // 16
            pcache = init_paged_cache(cfg, 8, 8 * per + 1, ps, "cuda")
            for leaf in chip_smoke._leaves(pcache):
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device="cuda"))
            tables = torch.randperm(8 * per, generator=torch.Generator(
                ).manual_seed(17)).int().reshape(8, per).cuda()
            cells[f"{arch} paged"] = (cfg, params, pcache, tok, pos, tables,
                                      kv_len)
    return cells


def step_ms(torch, SD, cell, edges) -> tuple:
    """(ms a step of the chunk's graph replays by CUDA events, the
    captured graph's programmatic edges / all edges, tokens equal to the
    eager chunk's)."""
    cfg, params, cache, tok, pos, tables, kv_len = cell
    n = 8
    body = SD.make_chunk_body(cfg, n)
    graphs = SD.ChunkGraphs(body, cfg, params, cache, batch=8, n_tokens=n,
                            sampled=False, device="cuda",
                            table_cols=None if tables is None
                            else tables.shape[1])
    graphs.load(tok, pos, tables)
    graphs.capture(kv_len)
    graph, out, _ = graphs.graphs[kv_len]
    for _ in range(3):
        graph.replay()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps, windows = [], 5
    for _ in range(windows):
        t0.record()
        for _ in range(10):
            graph.replay()
        t1.record()
        torch.cuda.synchronize()
        reps.append(t0.elapsed_time(t1) / 10 / n)
    ms = min(reps)
    toks = out[0].clone()
    eager = body(params, cache, tok, pos, None, kv_len, tables)[0]
    same = bool(torch.equal(toks, eager))
    pe = None
    if edges is not None:
        try:
            kept = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:        # a torch that keeps no captured graph
            kept = None
        if kept is not None:
            with torch.cuda.graph(kept, pool=graphs.pool,
                                  stream=graphs.stream):
                body(params, cache, graphs.tok, graphs.pos, None, kv_len,
                     graphs.tables)
            total = ctypes.c_int(0)
            k = edges.programmatic_edges(kept.raw_cuda_graph(),
                                         ctypes.byref(total))
            pe = (k, total.value)
            del kept
    del graphs, graph, out
    torch.cuda.synchronize()
    return ms, pe, same


def main() -> int:
    import torch
    args = sys.argv[1:]
    steps = "--kernels-only" not in args
    names = [a for a in args if a != "--kernels-only"] or list(VARIANTS)
    if not torch.cuda.is_available() or any(n not in VARIANTS for n in names):
        print(__doc__, file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import decode as D
    from repro_torch.serve import decode as SD

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    libs, edges = build_variants(build, chip_smoke, names)
    order = names + names[::-1]
    cases = kernel_cases(torch, chip_smoke, D)
    for label, fn in cases.items():
        us = {n: 0.0 for n in names}
        for name in order:
            build._LIBS["decode"] = libs[name]
            us[name] += chip_smoke.timed(torch, fn, 480) * 1e3 / 2
        print(f"decode_probe: kernel {label} (finished, the step's row "
              f"written): " + ", ".join(f"{n} {t:.2f} us"
                                        for n, t in us.items())
              + " (device time by profiler)")
    del cases
    torch.cuda.empty_cache()
    cells = step_cells(torch, chip_smoke) if steps else {}
    for label, cell in cells.items():
        ms = {n: 0.0 for n in names}
        notes = {}
        for name in order:
            build._LIBS["decode"] = libs[name]
            got, pe, same = step_ms(torch, SD, cell, edges)
            ms[name] += got / 2
            notes[name] = (pe, same)
        print(f"decode_probe: step {label} ({cell[0].n_layers} layers, 8 "
              f"slots, kv_len {cell[6]}): " + ", ".join(
                  f"{n} {t:.4f} ms" for n, t in ms.items())
              + " (an 8-token chunk's graph replays by CUDA events, a "
              "step)")
        print(f"decode_probe: step {label}: programmatic edges / edges of "
              f"the captured chunk, tokens equal to the eager chunk's: "
              + ", ".join(f"{n} {pe} {same}" for n, (pe, same)
                          in notes.items()))
    build._LIBS.pop("decode", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
