#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the ``repro`` package and builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc`` itself.
Phases, each printed on its own line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the five kernel sources compiled in parallel with ``nvcc``,
   one line of ptxas's register and spill report for each;
2a. the stream suite (``repro_torch.kernels.stream.ops``, impl="auto"):
   each of its 16 kernels against its plain version at an aligned and a
   ragged shape (the elementwise family in f32, bit for bit, and in
   bf16, within one bf16 ulp of the plain version computed in fp32; the
   NT flavors through ``flavor="nt"``); then its main path, every kernel
   once at HBM-resident sizes (2^28 f32 an array, pi at n = 2^28, Jacobi
   at (16386, 16384) and (514, 512, 1024), Gauss-Seidel at (4098, 4096)
   with 2 sweeps; its checks also run Gauss-Seidel on rows of 20000 and
   40002 columns), launch counts zeroed before and read after, each
   output held against its plain version; ``sum_reduction`` and
   ``pi_integration`` each one kernel event a call, their block counters
   back at 0 and repeats bit-identical; then each kernel's time beside
   its bound, its plain version's and one PyTorch call's (pi's also
   beside its reckoned SFU and issue floors at the SM clock
   ``nvidia-smi`` reads, and its distance from the float64 sum of its
   terms), the three INITs' GB/s, standard against NT stores, and copy,
   add and triad at 2^21 f32 an array (L2-resident). Its buffers are
   freed before the serving phases;
3. the split-KV decode kernel against its plain PyTorch version at
   yi-9b's head shapes (B=8, H=32, Hkv=4, Dh=128, bf16): Skv 4096 and
   4095, per-slot positions spread over the cache, Sq 1 and 4, no window
   and a 256-row window, one split and the default split count; and a
   2048-row cache read up to the serving path's occupancy bounds (kv_len
   472 and 301, rounded up to 128-row blocks, and 301 unrounded); and
   in bf16 and fp32 gemma3-4b's heads (H=8, Hkv=4, Dh=256) and G=16 at
   Sq 1 and 4 (16 and 64 packed rows: one and two row groups). At each
   shape both the per-split partials (merged by ``combine_splits``) and
   the finished output (splits merged inside the kernel, in q's dtype)
   against the plain partials merged and cast (:func:`finished_ok`); in
   bf16 at Sq 1 the attention family's shapes (qwen2-vl-7b's G=7,
   musicgen-large's G=1 at Dh=64, gemma3-4b's heads with its 1024-row
   window over a 2048-row cache, positions on both sides of it); the
   split counters all 0 after each call, a repeated call bit-identical,
   and one ``ops.flash_decode`` call one kernel event in a profiler
   window;
3a. the paged decode kernel against its plain version at the same head
   shapes: pages of 8, 16 and 256 rows under a randomly permuted table,
   dead table columns naming a NaN scratch page, Sq 1 and 4, no window
   and 256, one and the default split count, a kv_len cut below the
   horizon; against the dense kernel on the same logical cache; and the
   Dh=256 and 64-packed-row shapes of phase 3 and its family shapes
   (pages of 16, also against the dense kernel); partials and finished
   output, counters, repeats and one ``ops.flash_decode_paged`` event as
   in phase 3;
3b. the flash-attention kernel against its plain version at yi-9b
   prefill shapes (B=1, H=32, Hkv=4, Dh=128), S 512, 2048 and 509,
   causal and causal with a 256-row window, in fp32 and bf16, and at
   gemma3-4b's heads (H=8, Hkv=4, Dh=256), S 509 and 2048;
3c. the decode step's row write inside the decode launch: the decode
   kernels given the step's new K and V rows against the unfused pair
   (dense: the standalone writer, then the decode kernel; paged: the
   plain index write, then the paged kernel), outputs bit for bit and
   both caches byte for byte, at yi-9b's heads, Dh=256 and 64 packed
   rows, bf16 and fp32, Sq 1 and 4, both store flavors, one and the
   default split count, a negative, an overshooting and a clamped
   position, a kv_len cut below the written page; one fused call one
   kernel event;
4. the standalone KV row writer (which the decode step no longer
   launches) against its plain version, both store flavors, byte for
   byte, with a clamped overshoot row, in place, launch counts zeroed
   before its calls and read after;
5. the full-width 48-layer yi-9b ``ServeEngine`` (random weights from a
   seeded generator on the card): 16 greedy requests, prompts of 128 to
   512 tokens, 64 new tokens each, 8 slots, a 2048-row horizon, 8-token
   chunks, each chunk one CUDA-graph replay: the 16 graphs (one a
   128-row ``kv_len`` bucket) are captured before the run, their number,
   capture time and pool bytes printed, and no dispatch captures one.
   Kernel launch counts are zeroed just before the run and read
   just after (a replay counts its kernels as the eager chunk's calls
   do): every decode launch writes the step's rows
   (``kv_rows_in_decode``), the standalone writer never runs. One decode
   step's logits through the kernels are held
   against the same step with ``impl="ref"`` for four prompt sets, and a
   smoke-size fp32 engine's greedy streams on the card against the same
   engine on the CPU;
5b. the flash-attention entry point (``ops.flash_attention_bshd``) on
   layer 0's queries, keys and values of a 2048-token prompt, launch
   counts zeroed before and read after;
5c. the full-width ``PagedServeEngine`` with the same weights: page 16,
   320 pages, 16 greedy requests sharing a 256-token prefix (plus 0-256
   tokens each, 64 new), one forked after its first chunk and one
   cancelled. Launch counts zeroed before and read after (every paged
   decode launch writes the step's row), the pool checked after every
   round, its 16 graphs captured first as in phase 5; then one decode
   step through the paged
   kernel against the dense kernel on the same prompts, and a smoke-size
   fp32 paged engine's greedy streams on the card against the CPU and
   against the dense engine;
5d. graphs against the eager chunk at full width: 8 requests of 24 new
   tokens through an engine with ``cuda_graphs=False`` and one with the
   graphs (the same ``kv_len`` buckets), dense and paged, greedy and
   sampled at temperature 0.8, a cancel on both schedules and a fork on
   the paged one: the token streams byte-identical;
6. per kernel its time at the path's shapes, its bound, its plain
   version's time and a library call's time (none for the paged kernel:
   no single PyTorch call reads a paged cache), with the achieved GB/s
   (decode) or TFLOP/s (flash attention) and their share of the card's
   peak. The decode rows time the finished ``ops.flash_decode`` and
   ``ops.flash_decode_paged`` (one launch each, a finished output as
   sdpa's), with the partials-only launch and the call that also writes
   the step's rows (as the decode step makes it) beside them, and the paged
   kernel at 4 splits (one block an SM) beside its default 5; their
   bound counts the finished output's bytes (:func:`decode_bound`). The
   three attention kernels at gemma3-4b's heads (Dh=256) beside their
   bounds and sdpa; then, for the dense and the paged engine, two
   full-width decode dispatches of the same 8 requests timed once on the
   wall clock and once under the profiler: the device's busy time, its
   kernels per step and the host API calls a step that launched them
   (kernel and graph launches, copies), its idle share and where the
   time goes (the phase fails unless the window's ``LAUNCHES`` decode
   count is layers times steps and the profile holds as many decode
   kernel events, bar the profiler's known drops); the
   ``kernels`` JSON line (all 20 kernels, phase 2a's among them) comes
   last but one.
6a. planning and pricing on the ``h100`` machine file (PR 24): after
   each served config's trace phase (yi-9b dense and paged, gemma3-4b,
   xlstm-125m, the jamba period) a ``plan`` JSON line
   (:func:`phase_plan`): the decode step's ATen trace priced by
   ``serve.planner.plan_chunk_size`` under ``tp_bound`` and
   ``mca_sched``, full horizon and re-priced at the trace phase's
   occupancy, beside that phase's measured ms a step, with the trace's
   op count and unknown ops and the engine's planned chunk and store
   flavor; a decode split sweep (:func:`phase_split_sweep`:
   ``split_sweep`` lines, the tile tuner's modeled µs beside the
   measured, and at each shape the guard: the tuner's pick against the
   sweep's fastest count); one planned ``ServeEngine(chunk=None,
   machine="h100")`` beside a chunk-8 engine
   (:func:`phase_planned_engine`). The phases' seconds are summed and
   printed.
6b. the analysis half (:func:`phase_analysis`, after the split sweep,
   the yi-9b engines freed): the card's calibration
   (``core/ubench.py``: chained-op times by class, the measured L2 and
   HBM3 tiers, one block's read rate at each block count, registered as
   ``h100_measured``); Fig. 3's quick grid (``core/rpe.py``: 13 kernels
   x ``eager``, ``loop`` x sizes S, L at the card's sizes, each block
   measured once and predicted on ``h100_measured`` and ``h100``),
   summarised per machine, failing on any NaN record; the ``kernel``
   variant of each suite kernel held against its plain version and its
   launch counted; the Fig. 4b gate and its measured triad rows
   (``repro_torch.bench.fig4b_ntstore``) and Fig. 4's measured INIT row
   (``bench.fig4_wa``).
5e. (after phase 6's trace phases, the yi-9b engines freed) gemma3-4b
   at its published width and depth (34 layers, 5 x 6 + a tail of 4,
   a 1024-row window in 29 of them, Dh=256, a tied 262144-row head;
   random weights from a seeded generator on the card) through the
   dense ``ServeEngine``: 8 slots, a 2048-row horizon, 8-token chunks,
   its 16 graphs captured first; 16 greedy requests of 1100-1900-token
   prompts, 32-64 new tokens each. Prints tok/s, prefill s, ms a step
   beside the step's bound (weights and the run's live K and V rows
   over the HBM rate), and fails unless every decode launch is a
   ``flash_decode`` writing the step's rows (34 x steps) and the
   standalone writer never ran. One decode step's logits through the
   kernels against ``impl="ref"`` at positions past the window, and 4
   requests of 16 tokens graphed against eager, byte-identical;
5f. one gemma3-4b decode step through ``flash_decode_paged`` (page 16)
   against the dense kernel on the same prompts past the window; then
   a trace phase of the gemma3-4b engine (device busy, idle share,
   time by kernel group) as phase 6's;
5g. qwen2-vl-7b (QKV bias, M-RoPE with distinct 3-D prefill positions,
   G=7), minitron-8b (squared ReLU, Hkv=8) and musicgen-large (random
   frame embeddings, sinusoidal positions, G=1, Dh=64) at full width
   and depth: 8 slots prefilled, then 4 decode steps through the
   kernels against their plain versions on a copy of the cache, logits
   held as in phase 5 and the decode launches counted.
5h. xlstm-125m at its published width and depth (12 layers, 6 mLSTM and
   6 sLSTM, d_model 768; random weights from seed 23) through the dense
   ``ServeEngine``: 8 slots, a 2048-row horizon, 8-token chunks, one
   graph captured first (it reads no KV rows, so no ``kv_len`` bucket);
   16 greedy requests of 128-512-token prompts, 64 new tokens each.
   Prints tok/s, prefill s, ms a step beside its bound (the weights and
   the recurrent state read and written, over the HBM rate); holds the
   logits of greedy decode step 8 against a prefill of the prompt and
   the 8 tokens decoded (4 slots), and 4 graphed against eager streams
   byte-identical; then a trace phase as phase 6's;
5i. one xlstm-125m ``PagedServeEngine`` round: 7 requests, the first
   forked after its first chunk, its recurrent rows copied into the
   clone's slot on the card (held equal) and the clone's greedy stream
   equal to its parent's;
5j. one jamba period at full width (8 layers: 7 Mamba and 1 attention,
   4 MoE FFNs of 16 experts top-2 and 4 dense; 26.6 GB of bf16; the
   published 32 layers do not fit one card): 16 greedy requests of
   256-1024-token prompts, 32 new each, through the dense engine (16
   graphs captured first; ``flash_decode`` launches = steps); ms a step
   beside its bound; one decode step's kernel logits against
   ``impl="ref"``; graphed against eager; a paged round with a fork and
   a cancel, and one paged decode step against dense; a trace phase.
   MoE logits are held over the slots whose route (experts and drops,
   recorded in every MoE layer of both runs, :class:`RouteLog`) is the
   same in both runs; slots a router near tie sends apart are counted
   and printed, and half of them or more fail;
5k. grok-1 (G=6) and qwen3-moe (G=16, q/k norm) at full width, one
   layer each, through ``forward`` as phase 5g: 4 decode steps, kernels
   against their plain versions, over the slots routed alike.
7. the serving benchmarks at full width (``repro_torch.bench``), after
   every other phase's engines are freed, each path's launch counts
   zeroed before and read after:
   7a. fig7 at yi-9b (B=8, a 4096-row horizon, occupancy 1/8, 1/4, 1/2,
       1): ``flash_decode`` over the full horizon against bounded by the
       occupancy, each chunk a CUDA-graph replay, the decode kernel's µs
       a step (profiler) and the chunk's ms a step; gated: the bounded
       kernel grows with occupancy and beats the full horizon at <= 1/4;
   7b. fig8 at yi-9b in fp32 (8 slots, 2048 rows, pages of 16): priced
       and measured peak KV bytes, dense and paged streams byte-identical
       over a shared prefix with a fork, shared-prefix admission, the
       gather counter, a diverging fork's copy on write;
   7c. fig9 at gemma3-4b: 2 replicas of 8 slots over one copy of the
       weights, a 16-request Poisson and a bursty trace under both
       policies; p50/p95/p99, tokens a chip, token conservation; each
       engine's graphs and graph pool;
   7d. fig10 at xlstm-125m in fp32, 2 replicas planned on ``h100``,
       the reference's baseline and chaos runs: a stuck replica ejected
       and rescued, a NaN poison of the graph-replayed recurrent state
       quarantined and rescued, an admission error, a pool exhaustion
       whose priced decision replans the chunk through ``set_chunk``
       (its graph captured); gated: no request lost, rescued streams
       identical to the baseline, p99 within the planned budget, every
       fault and rescue path run, a replan landed.
8. the runtime around the engine (:func:`phase_runtime`, after phase
   7's engines are freed):
   8a. yi-9b at its published width (16 of its 48 layers,
       ``RUNTIME_LAYERS``, bf16, seed 81), a dense
       and a paged (page 16) engine of 8 slots, a 2048-row horizon and
       8-token chunks, greedy and at T=0.8, their graphs captured first;
       phase 5's 16 requests served once unmeasured, then serially, then
       with ``pipeline=2`` (set between the runs, nothing in flight):
       streams and dispatch counts byte-identical, decode launches
       attention layers x steps in each mode, tok/s and
       ``mean_dispatch_gap_s`` printed; for the greedy engines two traced
       rounds in each mode from nothing in flight (:func:`trace_rounds`:
       idle share on the wall clock and inside the device's span, its
       largest gap, and the host-blocking calls between the two
       enqueues, which must be none pipelined);
   8b. the 16 requests through the router's ``submit`` to the pipelined
       dense engine: staging hits (misses at most the first batch),
       streams as 8a's; one prompt's prefill logits staged and unstaged
       bit for bit;
   8c. xlstm-125m at its published width (bf16, seed 82), pipelined,
       served without snapshots and then with one offered every round
       (``skip_if_busy``): each round's wall time with a write in flight
       and without, the last snapshot restored bit for bit, and in a
       profiled round the params' device-to-host copies on a stream
       other than the kernels';
   8d. ``python -m repro_torch.bench.run --only fig11`` in process, its
       gates on the card;
   8e. ``repro_torch.launch.serve.main`` on xlstm-125m at its published
       width with ``--pipeline 2`` and a ``--plan-db`` swept here for
       ``h100``: DB hits and no online plan.
   The ``kernels`` line's ``flash_decode`` and ``flash_decode_paged``
   rows sum their launches over the main paths (``launches_by_path``),
   phases 7's and 8's among them.
9. training on the card (:func:`phase_training`, after phase 8's engines
   are freed; TF32 off as everywhere). The training path launches none
   of the port's hand-written kernels (its attention is the plain
   chunked attention, as the reference's is): the launch counts are
   zeroed before it and must read 0 after.
   9a. yi-9b at its published width, 4 of its 48 layers (1.216 B
       params, bf16, remat ``"full"``), ``make_train_step`` with
       ``accum_steps=2`` on ``SyntheticLM`` batches of 8 x 2048 tokens:
       6 steps with fp32 moments, then 3 from a fresh state with int8
       moments. Every loss and grad norm finite, the mean of the last 3
       fp32-moment losses under the first; ms a step (median from step
       2), tokens/s, ``max_memory_allocated``, the model FLOPs a step
       (6 x matmul params x tokens + causal attention) and their share
       of the bf16 dense peak; ``adamw_update`` alone (CUDA events)
       against its byte bound (every param, gradient and moment read
       once, every param and moment written once, over the HBM rate);
   9b. ``repro_torch.launch.train.main`` on the card: the smoke yi-9b
       for 8 steps with a checkpoint every 4, then resumed to 10 (the
       resume printed, steps 8-9 run); ``--compress`` for 4 steps into a
       fresh directory (its residual nonzero); xlstm-125m at its
       published width and depth at ``examples/train_lm.py``'s batch,
       sequence and lr for 2 steps (the recurrent backward on the card;
       losses and grad norms printed, not checked: the reference's
       gradient blows up there too);
   9c. the card against the host: each of the ten configs' smoke models
       in fp32 from one state and batch, one ``make_train_step`` step
       (``accum_steps=2`` for yi-9b and qwen2-vl-7b): loss and grad norm
       within 1e-5 relative, each gradient leaf of ``make_loss_fn``
       within 1e-4 of that leaf's largest magnitude.
10. meshes and tensor-parallel serving (:func:`phase_mesh`, after phase
    9): yi-9b at its published width, 8 slots, 8 requests of 128-256
    token prompts and 32 new tokens, chunk 8 (``MESH_CELL``).
    10a. a world of one NCCL rank, mesh (1,1) (``launch.mesh``), bf16,
         16 layers (``MESH_BF16_LAYERS``), dense and paged, CUDA graphs
         on: greedy streams
         identical to the mesh=None engine's on the same weights, ms a
         step beside mesh=None's, collectives a step as ``CommDebugMode``
         counts them over one eager chunk; its launches join
         ``launches_by_path``;
    10b. TP=2 as two ranks on the one card over gloo (NCCL refuses two
         ranks on one device; ``scripts/gloo_cuda_probe.py`` records what
         gloo carries on CUDA tensors), eager, spawned with a time limit
         (``MESH_TP_TIMEOUT``), each rank making its shard of every
         weight leaf by leaf: bf16 at 16 layers (first decode step's
         logits within ``MESH_BF16_REL_TOL`` of the unsharded step's,
         streams counted) and fp32 at 4 layers, dense and paged (logits
         within ``MESH_FP32_REL_TOL``, streams identical); the two ranks'
         streams identical; rank 0's launches join ``launches_by_path``.
11. The dry run (``launch/dryrun.py``) on fake process groups, its
    lowerings in child processes started together before phase 10 (CPU
    work beside phase 10's; their times count under load):
    11a. full-width records (``DRYRUN_CELLS``: yi-9b ``train_4k``,
         ``prefill_32k``, ``decode_32k`` on 16x16, qwen1.5-110b
         ``decode_32k`` under ``gather`` and ``resident2d``, yi-9b
         ``train_4k`` on 2x16x16, jamba ``train_4k`` and qwen3-moe
         ``decode_32k`` on 16x16), each with its lowering time, peak GB
         a rank against the card's 80 GB, FLOPs a rank, collectives by
         kind and bytes, and its ``h100`` roofline terms;
    11b. yi-9b's decode step (8 slots, 2048 rows) lowered at mesh (1,1)
         and run on the card: ``argument_bytes`` against the allocator's
         growth from placing the arguments, the matrix products' FLOPs
         outside the kernel regions against ``FlopCounterMode`` over the
         step (the kernels are ctypes calls it does not see), its peak
         against ``max_memory_allocated``; 10b's TP=2 step lowered at
         (1,2): 97 all-reduces and 1 all-gather, 10b's count;
    11c. two gloo ranks on ``cuda:0``, eager, once the decode kernel's
         partials at a rank's shape are held against their plain version
         at the local positions and bounds a rank gets (below, inside
         and past its rows; its bound clipped): the decode cache sharded
         on its rows (``SERVE_RULES``), the decode kernel's partials over
         each rank's half merged across the ranks (fp32 at 4 layers:
         every step's logits fed the same tokens, streams identical to
         mesh=None but at a tie; bf16 at 16 layers: the first step's
         logits), its launches a path of ``launches_by_path``; and
         yi-9b's train step at (1,2) (2 layers, fp32) against
         mesh=None's: loss, grad norm, parameters.

12. What a mesh once refused (:func:`phase_mesh_families`, after phase
    11), two gloo ranks on ``cuda:0`` spawned under
    ``FAMILY_MESH_TIMEOUT`` as 10b's, each job against mesh=None on the
    same card, weights and inputs (``PHASE12_SEED``): the recurrent, MoE
    and embedding-input configs at their published widths at (1,2)
    (``FAMILY_MESH_JOBS``: jamba's period in bf16 and 5 layers in fp32,
    xlstm-125m whole in fp32 and bf16, musicgen-large's 48 layers in
    bf16, grok-1 and qwen3-moe at one layer, expert-parallel, in fp32),
    8 slots of 128-token prompts (or frames) then greedy decode steps
    through ``forward``: the first step's and the prefill's max
    |dlogit| / max |logit| over the slots routed alike (held under
    ``MESH_BF16_REL_TOL`` / ``MESH_FP32_REL_TOL``), fp32 streams
    identical but at a tie (:func:`stream_partings`), bf16 streams
    counted, collectives a step by op, ms a step, ``flash_decode``
    launches a rank (xlstm-125m's own prefill and streams printed, its
    fp32 prefill and first step held at prompts of up to
    ``AMPLIFIED_HELD`` tokens, ``ROUNDING_AMPLIFIED``); then yi-9b fp32
    at 4 layers: ``pipeline=2`` at
    (1,2) streaming as serial, a snapshot of the (1,2) engine restored at
    mesh=None to its leaves, the paged engine at (2,1) (slots over
    ``data``) streaming as mesh=None with its ``flash_decode_paged``
    launches a rank, and 11c's sequence-sharded decode with
    ``store_flavor="nt"``: streams equal to the standard stores', one
    step at rows one rank owns writing those rows alone.

13. the entry points (:func:`phase_examples`, last): the five scripts
    of ``examples/torch`` through their ``main(argv)`` in-process, each
    timed and its output echoed: ``compare_arch`` (every machine's row,
    the ordering line OK), ``analyze_arch`` (jamba's smoke train step,
    no unknown op), ``quickstart`` (the ``stream_triad`` kernel at 2^28
    f32 an array held against the plain triad and timed by CUDA events
    in the script itself; every figure finite and positive, the RPEs
    printed), ``serve_lm`` at gemma3-4b's published width alone and
    with ``--replicas 2`` (144 tokens each, tok/s printed,
    ``flash_decode`` a whole number of steps), ``train_lm --steps 2``
    into a temporary directory (both steps' losses and the committed
    checkpoint); and ``serve_lm --smoke --mesh data,model=1,2`` as two
    gloo ranks on ``cuda:0`` spawned as 10b's under
    ``EXAMPLES_MESH_TIMEOUT``, overlapping the pricing-only scripts
    (rank 0 prints its 144 tokens). The launches of ``flash_decode`` and
    ``stream_triad`` join ``launches_by_path``.

Every timing is device time from ``torch.profiler``, but phase 13's,
which are the scripts' own (CUDA events, the wall clock). A profiler
window that reads a call under a bound that is a true floor (the bytes
of an HBM-resident working set, or any operation count;
``under_bound``) is taken again and named, as an empty window is; the L2
rung and the decode kernels, whose working sets fit the 50 MB L2, are
not held to their byte bounds.

TF32 is switched off for matmuls and cuDNN, so fp32 references on the
card run in full fp32. Any failed phase raises and the script exits
non-zero; so does a machine without a CUDA device, or a directory
without the repository's ``src/repro_torch``. The last line of standard
output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")


def _h100_spec():
    """The card's published figures: the port's ``h100`` machine file's
    ``GpuSpec`` (``repro_torch/utils/hw.py``: NVIDIA's H100 SXM data
    sheet, whitepaper and CUDA programming guide)."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.core.machine import get_machine
    return get_machine("h100").chip


_H100 = _h100_spec()
#: HBM bytes/s, FP32 FLOP/s outside the tensor cores, dense bf16 FLOP/s
#: on them
HBM_BYTES_PER_S, FP32_FLOPS, BF16_FLOPS = (_H100.hbm_bw, _H100.fp32_flops,
                                           _H100.bf16_flops)

# yi-9b head shapes of the serving path
B, H, HKV, DH = 8, 32, 4, 128
# tolerances. The decode kernel and its plain version both compute in
# fp32 from the same bf16 inputs; they differ only in summation order and
# exp rounding, so the normalized fp32 outputs agree to ~1e-6.
DECODE_TOL = 1e-4
# the router's bf16 output against the fp32 dense oracle: one bf16
# rounding (half an ulp, at most 2**-6 for the magnitudes below 8 that
# softmax-weighted unit normals take)
BF16_OUT_TOL = 2 ** -6
# one decode step at full width, kernels vs impl="ref" (their plain
# versions): both attention paths sum in fp32 in different orders, so a
# layer's bf16 attention output can differ by one ulp where the sums
# straddle a rounding boundary, and 48 random-weight layers amplify such
# flips. Held as max |diff| over max |logit|, for each of four prompt
# sets. On an H100 the served prompts read 0.0204 and 0.0236 in two
# runs; the limit leaves twice that room for other prompt sets (their
# spread is recorded in PERF.md). A wrong occupancy bound or split is
# caught at 1e-4 by the kernel cases of phase 3, not here.
LOGITS_REL_TOL = 5e-2
LOGITS_SEEDS = (11, 12, 13)       # prompt sets beside the served prompts
# flash attention in fp32 against its plain version: both sum the same
# products in fp32 in different orders over up to 2048 keys; the outputs
# (weighted means of unit normals) agree to ~1e-6
FLASH_F32_TOL = 1e-4
PROFILE_ATTEMPTS = 3              # windows read under a bound before a
                                  # timing fails
#: profiler windows with no device event at all before a phase fails: a
#: loss of the profiler's, not a reading (seen for up to 3 windows in a
#: row at the fused-write phase's first window on an H100)
EMPTY_WINDOWS = 8
#: kinds of bound under which no reading can fall: the bytes of a working
#: set that lives in device memory (far larger than the 50 MB L2), and
#: any operation count. A bound of kind "l2" (the bytes of a working set
#: that can stay in L2 between timed calls: the L2 rung, the decode
#: kernels' ~6 MB of live rows) is no floor and is not checked.
FLOOR_KINDS = ("hbm", "operations")
#: host API calls that put work on the card, by kind (name prefixes of
#: the profiler's runtime and driver events)
HOST_CALLS = {"kernel": ("cudaLaunchKernel", "cuLaunchKernel"),
              "graph": ("cudaGraphLaunch", "cuGraphLaunch"),
              "copy": ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")}
#: the parity phase: new tokens a request, and the sampled engines'
#: temperature
PARITY_NEW = 24
PARITY_TEMPERATURE = 0.8


class PhaseError(RuntimeError):
    """A smoke phase failed."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def device_us(prof, counts: dict | None = None) -> dict:
    """Device microseconds by name: every kernel, copy and fill the
    profile saw on the card (host-side operator rows are left out, so
    no kernel is counted twice). ``counts``, when given, gets the number
    of events by name.

    Read from the profiler's raw Kineto events, filtered and named as
    ``prof.events()`` names them: building that Python event tree costs
    seconds for a window of tens of thousands of launches, and these
    sums need none of it."""
    from torch._C import _demangle
    from torch.autograd import DeviceType
    out, names = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA \
                or getattr(ev, "is_hidden_event", lambda: False)():
            continue
        raw = ev.name()
        if raw not in names:
            names[raw] = _demangle(raw)
        out[names[raw]] = out.get(names[raw], 0.0) + ev.duration_ns() / 1e3
        if counts is not None:
            counts[names[raw]] = counts.get(names[raw], 0) + 1
    return out


def runtime_calls(prof) -> dict:
    """Host-side events of a profile whose names are host API calls that
    put work on the card (:data:`HOST_CALLS`), counted by name."""
    from torch.autograd import DeviceType
    prefixes = sum(HOST_CALLS.values(), ())
    out = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != DeviceType.CUDA and name.startswith(prefixes):
            out[name] = out.get(name, 0) + 1
    return out


#: the share of a window's kernel events the profiler may drop on the
#: H100 (seen: 3 of 480 decode launches, every window)
PROFILER_DROPS = 0.01


def profiler_drops(events: int) -> int:
    """Events of ``events`` the profiler may miss: :data:`PROFILER_DROPS`
    of them, at least 3."""
    return max(3, int(events * PROFILER_DROPS))


def host_launches(calls: dict) -> dict:
    """Host API calls by kind of :data:`HOST_CALLS` ("kernel", "graph",
    "copy"), from counts by call name; other names are not counted."""
    out = dict.fromkeys(HOST_CALLS, 0)
    for name, n in calls.items():
        for kind, prefixes in HOST_CALLS.items():
            if name.startswith(prefixes):
                out[kind] += n
    return out


def under_bound(by_name_us: dict, bounds_us: dict) -> list:
    """The readings that fall under a bound that is a true floor.

    ``by_name_us`` maps a kernel (or call) to its reading in µs;
    ``bounds_us`` maps it to ``(bound µs, kind)``, kind one of
    :data:`FLOOR_KINDS` or ``"l2"``. Returns ``[(name, reading, bound)]``
    for every name read under a bound of a kind in :data:`FLOOR_KINDS`,
    in the order of ``bounds_us``; a name without a reading is skipped.
    """
    return [(name, by_name_us[name], bound)
            for name, (bound, kind) in bounds_us.items()
            if kind in FLOOR_KINDS and name in by_name_us
            and by_name_us[name] < bound]


def profiled(torch, run, what: str, setup=None, counts=None,
             faults=None, host=None) -> dict:
    """Device microseconds by name over one ``run()``, under
    ``torch.profiler``; ``setup()``, when given, runs before each window,
    outside it. ``counts``, when given, gets the window's events by name;
    ``host`` its host API calls that put work on the card
    (:func:`runtime_calls`).

    Now and then a profile on the card records no device event at all;
    such a window is taken again, up to ``EMPTY_WINDOWS`` of them, and
    said so. So is a window for which ``faults(by_name, counts)``, when
    given, returns a non-empty list of what is wrong with it (a reading
    under its bound; see :func:`timed`), each named, up to
    ``PROFILE_ATTEMPTS`` of them (see :func:`timed`). Past either count
    the phase fails:
    there is no fallback to another clock.
    """
    from torch.profiler import ProfilerActivity, profile
    empty = faulty = 0
    while empty < EMPTY_WINDOWS and faulty < PROFILE_ATTEMPTS:
        attempt = empty + faulty + 1
        if setup is not None:
            setup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if counts is not None:
            counts.clear()
        by_name = device_us(prof, counts)
        if host is not None:
            host.clear()
            host.update(runtime_calls(prof))
        if sum(by_name.values()) <= 0:
            print(f"{what}: the profiler saw no device time in window "
                  f"{attempt}")
            empty += 1
            continue
        wrong = faults(by_name, counts) if faults is not None else []
        if wrong:
            print(f"{what}: window {attempt} taken again: "
                  + "; ".join(wrong))
            faulty += 1
            continue
        if attempt > 1:
            print(f"{what}: measured in window {attempt}")
        return by_name
    raise PhaseError(f"{what}: no usable profiler window ({empty} saw no "
                     f"device time, {faulty} read under a bound or lost "
                     f"most of a kernel's events)")


def timed(torch, fn, iters: int, warmup: int = 3, bound=None) -> float:
    """Milliseconds of device work per ``fn()`` call.

    The device time of every kernel, copy and fill that ``iters`` calls
    launch, from ``torch.profiler`` (see :func:`profiled`): host launch
    overhead between calls does not count. The profiler on the H100
    misses some of a window's events (seen: 477 of 480 decode launches in
    every window, 4 of 5 of one elementwise kernel, three 1 GiB copies
    summing to one copy's time), so each name counts its mean event time
    times its events a call (its count over ``iters``, rounded, at least
    1), not its sum over ``iters``. A name that misses more than a tenth
    of its events is said so. A window in which the name with the most
    device time misses half its events or more (seen once: 20 of 480
    decode launches) is taken again, as an empty one is.

    ``bound``, when given, is ``(name, µs, kind)`` for the work of one
    call (see :func:`under_bound`): a window that reads the call under a
    bound that is a true floor is taken again too, and named with its
    reading; if every window is taken again, the phase fails.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    def per_call_us(by_name, counts, say=False):
        us = 0.0
        for name, total in by_name.items():
            a_call = max(1, round(counts[name] / iters))
            if say and counts[name] < 0.9 * a_call * iters:
                print(f"timing: the profiler recorded {counts[name]} of "
                      f"{a_call * iters} events of {name[:60]}")
            us += total / counts[name] * a_call
        return us

    def faults(by_name, counts):
        top = max(by_name, key=by_name.get)
        want = max(1, round(counts[top] / iters)) * iters
        wrong = [] if 2 * counts[top] > want else [
            f"the profiler recorded {counts[top]} of {want} events of "
            f"{top[:60]}"]
        if bound is not None:
            name, bound_us, kind = bound
            wrong += [f"{n} read {r:.2f} us, under its {kind} bound "
                      f"{b:.2f} us" for n, r, b in under_bound(
                          {name: per_call_us(by_name, counts)},
                          {name: (bound_us, kind)})]
        return wrong

    counts = {}
    by_name = profiled(torch, run, "timing", counts=counts, faults=faults)
    return per_call_us(by_name, counts, say=True) / 1e3


# --- phase 1: device -------------------------------------------------------

def phase_device(torch) -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(line)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


# --- phase 2: build --------------------------------------------------------

def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    dt = time.perf_counter() - t0
    print(f"build: compiled {built or 'nothing (up to date)'} in {dt:.1f} s"
          + "".join(f"; {n} {build.BUILD_SECONDS[n]:.1f} s" for n in built))
    for name in build.SOURCES:
        log = build.library_path(name).with_name(
            build.library_path(name).name + ".log").read_text()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)] or [0]
        print(f"build: {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {spills} bytes of spill stores and loads, at most "
              f"{max(smem)} bytes of static shared memory (ptxas -v)")


# --- phase 2a: the stream suite --------------------------------------------

STREAM_CHECK_SHAPES = ((256, 512), (253, 484))   # aligned and ragged
STREAM_HBM_SHAPE = (16384, 16384)    # 2^28 f32 = 1 GiB an array, >> L2
STREAM_L2_SHAPE = (2048, 1024)       # 2^21 f32 = 8 MiB an array, in L2
JACOBI_2D_SHAPE = (16386, 16384)
JACOBI_3D_SHAPE = (514, 512, 1024)
GS_SHAPE, GS_SWEEPS = (4098, 4096), 2
PI_N = 2 ** 28
STREAM_S = 2.0                       # the UPDATE and triad scalar
STREAM_SUM_RTOL = 1e-5
STENCIL_TOL = 1e-6
PI_OPS_PER_POINT = 6                 # +0.5, /n, x*x, 1+, 4/, the sum
#: Hopper's rates behind pi_integration's reckoned floors: MUFU.RCP
#: results an SM a clock (16 SFU lanes), and thread instructions an SM
#: issues a clock (4 schedulers, a warp instruction each)
SFU_RCP_PER_SM_CLOCK = _H100.sfu_per_sm
ISSUE_PER_SM_CLOCK = _H100.issue_per_sm
STREAM_KPY = "src/repro/kernels/stream/kernels.py"
# name: (line of its pallas_call or function in STREAM_KPY, CUDA source)
STREAM_KERNELS = {
    "init_store": (94, "stream"), "init_partial": (112, "stream"),
    "init_nt": (120, "stream"), "copy_nt": (136, "stream"),
    "update_nt": (170, "stream"), "stream_triad_nt": (191, "stream"),
    "copy": (146, "stream"), "add": (160, "stream"),
    "update": (180, "stream"), "stream_triad": (202, "stream"),
    "schoenauer_triad": (218, "stream"), "sum_reduction": (233, "stream"),
    "pi_integration": (252, "stream"), "jacobi_2d5pt": (283, "stencil"),
    "jacobi_3d7pt": (313, "stencil"), "gauss_seidel_2d5pt": (347, "stencil"),
}


def bf16_ulp(torch, x):
    """The bf16 ulp at |x|, for bf16 values held in fp32."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_ulps(torch, got, want_f32) -> float:
    """max |got - want| in bf16 ulps at |want|, ``want`` the fp32 result
    rounded once to bf16."""
    want = want_f32.bfloat16().float()
    return ((got.float() - want).abs() / bf16_ulp(torch, want)).max().item()


#: the PyTorch call timed beside each elementwise kernel (NT and standard)
STREAM_LIBRARY = {"copy": "copy_", "add": "torch.add(out=)",
                  "update": "torch.mul(out=)",
                  "stream_triad": "torch.add(alpha=, out=)",
                  "schoenauer_triad": "torch.addcmul(out=)"}


def stream_elementwise(torch, SO, SR) -> dict:
    """name: (inputs, call through ``ops``, plain version, library call
    into ``out``, fp32 operations an element) for the elementwise family
    with tensor inputs."""
    s = STREAM_S
    return {
        "copy": (1, lambda x: SO.copy(x[0]), lambda x: SR.copy(x[0]),
                 lambda x, o: o.copy_(x[0]), 0),
        "copy_nt": (1, lambda x: SO.copy(x[0], flavor="nt"),
                    lambda x: SR.copy(x[0]), lambda x, o: o.copy_(x[0]), 0),
        "add": (2, lambda x: SO.add(x[0], x[1]),
                lambda x: SR.add(x[0], x[1]),
                lambda x, o: torch.add(x[0], x[1], out=o), 1),
        "update": (1, lambda x: SO.update(x[0], s),
                   lambda x: SR.update(x[0], s),
                   lambda x, o: torch.mul(x[0], s, out=o), 1),
        "update_nt": (1, lambda x: SO.update(x[0], s, flavor="nt"),
                      lambda x: SR.update(x[0], s),
                      lambda x, o: torch.mul(x[0], s, out=o), 1),
        "stream_triad": (2, lambda x: SO.stream_triad(x[0], x[1], s),
                         lambda x: SR.stream_triad(x[0], x[1], s),
                         lambda x, o: torch.add(x[0], x[1], alpha=s, out=o),
                         2),
        "stream_triad_nt": (2, lambda x: SO.stream_triad(x[0], x[1], s,
                                                         flavor="nt"),
                            lambda x: SR.stream_triad(x[0], x[1], s),
                            lambda x, o: torch.add(x[0], x[1], alpha=s,
                                                   out=o), 2),
        "schoenauer_triad": (3, lambda x: SO.schoenauer_triad(*x[:3]),
                             lambda x: SR.schoenauer_triad(*x[:3]),
                             lambda x, o: torch.addcmul(x[0], x[1], x[2],
                                                        out=o), 2),
    }


def stream_inits(SO) -> dict:
    """name: call (shape, dtype) through ``ops`` for the three INITs."""
    return {
        "init_store": lambda sh, dt: SO.init(sh, STREAM_S, dt,
                                             device="cuda"),
        "init_partial": lambda sh, dt: SO.init_partial(sh, STREAM_S, dt,
                                                       device="cuda"),
        "init_nt": lambda sh, dt: SO.init(sh, STREAM_S, dt, flavor="nt",
                                          device="cuda"),
    }


#: the stencils held bit for bit to their plain versions (their kernels
#: sum in the plain version's order with the _rn intrinsics)
BIT_IDENTICAL_STENCILS = ("jacobi_3d7pt", "gauss_seidel_2d5pt")


def phase_stream_check(torch, K, SO, SR, SK) -> dict:
    """Every stream kernel through ``ops`` (impl="auto") on CUDA tensors
    at an aligned and a ragged shape, against its plain version: f32
    elementwise bit for bit, bf16 within one bf16 ulp of the plain
    version computed in fp32 from the same bf16 inputs (the kernels round
    once), sums at rtol 1e-5 (bf16 against the fp32-accumulated plain
    sum), stencils at 1e-6, each also on a view whose data start 4 bytes
    past a 16-byte boundary; the 3-D Jacobi sweep also bit for bit (its
    TMA route at a width of 4k columns, its 4-byte route at any other and
    on the views, (3, 3, 3) a single point); Gauss-Seidel also bit for
    bit, with one interior row, widths of 32k + 2 and 32k + 3 columns
    (its 4-byte route) and of 4k columns (its TMA route, but for the
    views' first pass), 20000 and 40002 columns, no sweep, and sweeps
    that take one, two and three passes (the ping-pong through the
    temporary grid both ways). Launch counts zeroed before, read after.
    Returns the largest absolute error by kernel."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(20)
    errs = {}

    def note(name, err, ok, what):
        check(ok, f"stream: {name} {what}: error {err:.3g}")
        errs[name] = max(errs.get(name, 0.0), err)

    K.reset_launches()
    elementwise = stream_elementwise(torch, SO, SR)
    for shape in STREAM_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for _ in range(3)]
            for name, (n, call, plain, _, _) in elementwise.items():
                got = call(xs[:n])
                check(got.dtype == dtype and tuple(got.shape) == shape,
                      f"stream: {name} returned {got.dtype} {got.shape}")
                if dtype == torch.float32:
                    want = plain(xs[:n])
                    err = (got - want).abs().max().item()
                    note(name, err, torch.equal(got, want),
                         f"f32 {shape} not bit-identical to plain")
                else:
                    want = plain([x.float() for x in xs[:n]])
                    ulps = bf16_ulps(torch, got, want)
                    note(name, (got.float() - want).abs().max().item(),
                         ulps <= 1.0, f"bf16 {shape} {ulps:.2f} ulp")
            for name, call in stream_inits(SO).items():
                got = call(shape, dtype)
                want = SR.init(shape, STREAM_S, dtype, "cuda")
                note(name, (got.float() - want.float()).abs().max().item(),
                     torch.equal(got, want), f"{dtype} {shape} differs")
            got = SO.sum_reduction(xs[0])
            want = SR.sum_reduction(xs[0].float())
            err = (got - want).abs().item()
            note("sum_reduction", err, got.dtype == torch.float32 and
                 err <= STREAM_SUM_RTOL * want.abs().item(),
                 f"{dtype} {shape}")
    for n in (262144, 262143):
        got = SO.pi_integration(n, device="cuda")
        want = SR.pi_integration(n, device="cuda")
        err = (got - want).abs().item()
        note("pi_integration", err, err <= STREAM_SUM_RTOL * want.item()
             and abs(got.item() - math.pi) < 1e-4 * math.pi, f"n={n}")
    check_one_launch_calls(torch, lambda: SO.pi_integration(262143,
                                                             device="cuda"),
                           SK.pi_scratch("cuda")[0],
                           "stream: pi_integration", PI_KERNEL)
    for name, shape, args in (
            ("jacobi_2d5pt", (258, 514), ()), ("jacobi_2d5pt", (253, 484), ()),
            ("jacobi_3d7pt", (18, 34, 130), ()),
            ("jacobi_3d7pt", (17, 29, 101), ()),
            ("jacobi_3d7pt", (18, 34, 132), ()),
            ("jacobi_3d7pt", (3, 3, 3), ()),
            ("gauss_seidel_2d5pt", (34, 128), (2,)),
            ("gauss_seidel_2d5pt", (33, 101), (1,)),
            ("gauss_seidel_2d5pt", (3, 2500), (2,)),   # one interior row
            ("gauss_seidel_2d5pt", (3, 101), (3,)),
            ("gauss_seidel_2d5pt", (6, 20000), (2,)),
            ("gauss_seidel_2d5pt", (5, 40002), (1,)),
            ("gauss_seidel_2d5pt", (37, 130), (2,)),
            ("gauss_seidel_2d5pt", (37, 131), (2,)),
            ("gauss_seidel_2d5pt", (37, 132), (0,)),
            ("gauss_seidel_2d5pt", (37, 132), (4,)),   # one pass of 4
            ("gauss_seidel_2d5pt", (70, 132), (8,)),   # two passes
            ("gauss_seidel_2d5pt", (70, 132), (9,))):  # three passes
        # the grid itself, then a contiguous view 4 bytes past a 16-byte
        # boundary (the stencils load one float at a time)
        n = math.prod(shape)
        base = torch.randn(n + 4, generator=gen, device="cuda")
        for u, what in ((base[:n].view(shape), f"{shape}"),
                        (base[1:n + 1].view(shape),
                         f"{shape} view at a 4-byte offset")):
            got = getattr(SO, name)(u, *args)
            want = getattr(SR, name)(u, *args)
            err = (got - want).abs().max().item()
            note(name, err, got.shape == want.shape and err <= STENCIL_TOL
                 and (name not in BIT_IDENTICAL_STENCILS
                      or torch.equal(got, want)), what)
    torch.cuda.synchronize()
    moved = {n: K.LAUNCHES[n] for n in STREAM_KERNELS}
    check(all(moved.values()), f"stream: kernels never launched: "
          f"{[n for n, c in moved.items() if not c]}")
    print(f"stream kernels: 16 kernels through ops (impl='auto') vs plain "
          f"at {STREAM_CHECK_SHAPES[0]} and {STREAM_CHECK_SHAPES[1]} "
          f"(stencils and pi at their own aligned and ragged sizes): f32 "
          f"elementwise bit-identical, bf16 within 1 ulp of the fp32 plain "
          f"result, sums rtol {STREAM_SUM_RTOL}, stencils {STENCIL_TOL} "
          f"(gauss-seidel bit-identical); "
          f"launches {moved}")
    print("stream kernels: max abs err " + ", ".join(
        f"{n} {e:.3g}" for n, e in errs.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    return errs


def pi_reference64(torch, n: int) -> float:
    """The float64 sum of the fp32 terms RN(4 / RN(1 + RN(x * x))), x =
    RN((i + 0.5) / n) by IEEE division (the TPU kernel's and the CPU
    plain version's terms), over n: the exact sum's pi for those terms.
    The divisor is a tensor, since PyTorch on the card divides by a
    Python number as a product with its reciprocal."""
    i = torch.arange(n, dtype=torch.float32, device="cuda")
    x = (i + 0.5) / torch.full_like(i, float(n))
    return (4.0 / (1.0 + x * x)).double().sum().item() / n


def check_one_launch_calls(torch, call, counter, what: str, kernel) -> None:
    """``call()``, a one-launch reduction (``sum_reduction``,
    ``pi_integration``): its block ``counter`` back at 0 after each call,
    two calls bit-identical, and one call one kernel event."""
    got = call()
    torch.cuda.synchronize()
    check(not counter.any(), f"{what} counter not 0 after a call")
    again = call()
    torch.cuda.synchronize()
    check(not counter.any(), f"{what} counter not 0 after a call")
    check(same_bits(torch, got.reshape(1), again.reshape(1)),
          f"{what}: two calls differ")
    one_kernel_event(torch, call, what, kernel)


def sass_loops(sass: str, function: str) -> list:
    """``(instructions, MUFU.RCP instructions)`` of each loop of the first
    function in ``cuobjdump -sass`` output whose name holds ``function``:
    a loop is the span from a backward branch's target to the branch."""
    body = None
    for part in sass.split("Function : ")[1:]:
        if function in part.split("\n", 1)[0]:
            body = part
            break
    if body is None:
        return []
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", body)]
    loops = []
    for addr, op, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            span = [o for a, o, _ in ins if int(m.group(1), 16) <= a <= addr]
            loops.append((len(span),
                          sum(o.startswith("MUFU.RCP") for o in span)))
    return loops


#: SASS opcodes that show a body runs on Hopper's own instructions: the
#: warpgroup products (``wgmma``) and the TMA tensor loads
HOPPER_OPS = ("HGMMA", "UTMALDG")

_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_kernels(log: str) -> dict:
    """mangled kernel name: (registers, spill stores, spill loads, stack)
    from a ``ptxas -v`` report."""
    out, name, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if m := _PTXAS_ENTRY.search(line):
            name, frame = m.group(1), (0, 0, 0)
        elif (m := _PTXAS_SPILL.search(line)) and name:
            frame = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        elif (m := _PTXAS_REGS.search(line)) and name:
            out[name] = (int(m.group(1)), *frame)
            name = None
    return out


def sass_op_counts(sass: str, ops=HOPPER_OPS) -> dict:
    """{mangled function name: {opcode: instructions}} of every function
    in ``cuobjdump -sass`` output."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = {op: len(re.findall(rf"\b{op}\b", body))
                             for op in ops}
    return out


def library_sass(build, name: str) -> str | None:
    """``cuobjdump -sass`` of the built library ``name``; None without
    ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(build.library_path(name))],
                          check=True, capture_output=True, text=True).stdout


def flash_bodies(build) -> list:
    """``(demangled name, registers, spill bytes, {opcode: count})`` of each
    bf16 body of the flash library, from its ``ptxas -v`` report and its
    SASS (counts None without ``cuobjdump``)."""
    lib = build.library_path("flash")
    regs = ptxas_kernels(lib.with_name(lib.name + ".log").read_text())
    sass = library_sass(build, "flash")
    ops = sass_op_counts(sass) if sass is not None else {}
    from torch._C import _demangle
    named = ((re.search(r"flash_bf16_kernel<[^>]*>", _demangle(k)), k, r)
             for k, r in sorted(regs.items()))
    return [(m.group(0), r[0], r[1] + r[2], ops.get(k))
            for m, k, r in named if m]


def phase_flash_sass(build) -> None:
    """The bf16 flash bodies are Hopper's: each instance's SASS holds
    ``HGMMA`` and ``UTMALDG`` instructions, and none spills."""
    bodies = flash_bodies(build)
    check(bool(bodies), "flash: no bf16 body in the library's ptxas report")
    for name, regs, spill, ops in bodies:
        print(f"flash sass: {name}: {regs} registers, {spill} bytes of "
              f"spill, " + (", ".join(f"{op} {n}" for op, n in ops.items())
                            if ops is not None else "no cuobjdump"))
        check(spill == 0, f"flash: {name} spills {spill} bytes")
        check(ops is None or all(ops.values()),
              f"flash: {name} lacks {HOPPER_OPS} in its SASS: {ops}")


def pi_issue_per_point(build) -> float | None:
    """Instructions a point in ``pi_kernel<true>``'s fast loop (its loop
    with the fewest instructions a MUFU.RCP among those of a whole chunk
    of points), from the stream library's SASS; None without
    ``cuobjdump``."""
    sass = library_sass(build, "stream")
    if sass is None:
        return None
    loops = [n / r for n, r in sass_loops(sass, "pi_kernelILb1E") if r >= 16]
    return min(loops) if loops else None


def sm_clocks_mhz() -> tuple:
    """The SM clock ``nvidia-smi`` reads now, and its maximum, in MHz."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    now, top = (float(v) for v in line.split(","))
    return now, top


def pi_floors_us(n: int, sms: int, mhz: float, per_point) -> tuple:
    """pi_integration's reckoned floors at an SM clock of ``mhz``: one
    MUFU.RCP a point over the SFUs, and ``per_point`` instructions a
    point over the schedulers' issue (None where it is not known)."""
    hz = mhz * 1e6
    sfu = n / (sms * SFU_RCP_PER_SM_CLOCK * hz) * 1e6
    issue = None if per_point is None else \
        n * per_point / (sms * ISSUE_PER_SM_CLOCK * hz) * 1e6
    return sfu, issue


def print_pi_floors(torch, build, ms: float) -> None:
    """pi_integration's reckoned SFU and issue floors at n = ``PI_N``,
    at the SM clock ``nvidia-smi`` reads right after its timing and at
    the card's maximum, beside its time ``ms`` and its operation bound."""
    now, top = sm_clocks_mhz()
    per_point = pi_issue_per_point(build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    what = []
    for mhz in (now, top):
        sfu, issue = pi_floors_us(PI_N, sms, mhz, per_point)
        what.append(f"at {mhz:.0f} MHz: SFU {sfu:.1f} us, issue "
                    + ("not measured" if issue is None else f"{issue:.1f} us"))
    ops = PI_N * PI_OPS_PER_POINT / FP32_FLOPS * 1e6
    print(f"timing: pi_integration {ms * 1e3:.1f} us against reckoned "
          f"floors (one MUFU.RCP a point, {SFU_RCP_PER_SM_CLOCK} an SM a "
          f"clock; "
          + ("instructions a point not measured" if per_point is None else
             f"{per_point:.2f} instructions a point in the hot loop's SASS")
          + f", {ISSUE_PER_SM_CLOCK} an SM a clock) {'; '.join(what)} "
          f"(SM clock read now, then its maximum); bound {ops:.1f} us "
          f"({PI_OPS_PER_POINT} fp32 operations a point at "
          f"{FP32_FLOPS / 1e12:.0f} TFLOP/s)")


def phase_stream(torch, K, SO, SR, SK, errs) -> list:
    """The suite's main path at HBM-resident sizes: each of the 16
    kernels once through ``ops`` (impl="auto"), launch counts zeroed
    before and read after, each output held against its plain version;
    then each kernel's device time beside its bound, its plain version's
    and one PyTorch call's, the three INITs' GB/s, standard against NT
    stores, and copy, add and triad at an L2-resident size."""
    t0 = time.perf_counter()
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(21)
    xs = [torch.randn(STREAM_HBM_SHAPE, generator=gen, device="cuda")
          for _ in range(3)]
    n_el = xs[0].numel()
    j2 = torch.randn(JACOBI_2D_SHAPE, generator=gen, device="cuda")
    j3 = torch.randn(JACOBI_3D_SHAPE, generator=gen, device="cuda")
    gs = torch.randn(GS_SHAPE, generator=gen, device="cuda")
    elementwise = stream_elementwise(torch, SO, SR)
    inits = stream_inits(SO)
    stencils = {"jacobi_2d5pt": (j2, ()), "jacobi_3d7pt": (j3, ()),
                "gauss_seidel_2d5pt": (gs, (GS_SWEEPS,))}

    # the main path: every kernel once, launch counts zeroed before
    K.reset_launches()
    outs = {n: call(xs[:k]) for n, (k, call, _, _, _) in elementwise.items()}
    outs.update((n, call(STREAM_HBM_SHAPE, torch.float32))
                for n, call in inits.items())
    outs["sum_reduction"] = SO.sum_reduction(xs[0])
    outs["pi_integration"] = SO.pi_integration(PI_N, device="cuda")
    outs.update((n, getattr(SO, n)(u, *a)) for n, (u, a) in stencils.items())
    torch.cuda.synchronize()
    launches = {n: K.LAUNCHES[n] for n in STREAM_KERNELS}
    gs_plan = SK.gauss_seidel_plan(*GS_SHAPE, GS_SWEEPS)
    want_launches = dict.fromkeys(STREAM_KERNELS, 1)
    want_launches["gauss_seidel_2d5pt"] = len(gs_plan.fused)
    check(launches == want_launches, f"stream: main path launches "
          f"{launches}, expected {want_launches} (a launch a Gauss-Seidel "
          f"pass)")
    for n, (k, _, plain, _, _) in elementwise.items():
        check(torch.equal(outs.pop(n), plain(xs[:k])),
              f"stream: {n} at {STREAM_HBM_SHAPE} not bit-identical")
    full = SR.init(STREAM_HBM_SHAPE, STREAM_S, torch.float32, "cuda")
    for n in inits:
        check(torch.equal(outs.pop(n), full), f"stream: {n} at "
              f"{STREAM_HBM_SHAPE} differs")
    del full
    for n, want in (("sum_reduction", SR.sum_reduction(xs[0])),
                    ("pi_integration", SR.pi_integration(PI_N,
                                                         device="cuda"))):
        got = outs.pop(n)
        err = (got - want).abs().item()
        check(err <= STREAM_SUM_RTOL * abs(want.item()),
              f"stream: {n} main path error {err:.3g}")
        if n == "pi_integration":
            ref = pi_reference64(torch, PI_N)
            print(f"stream: pi_integration n=2^{int(math.log2(PI_N))}: "
                  f"kernel {got.item()!r}, plain {want.item()!r}; against "
                  f"the float64 sum of the IEEE fp32 terms ({ref!r}) the "
                  f"kernel is off by {abs(got.item() - ref):.3g}, the plain "
                  f"version by {abs(want.item() - ref):.3g}")
    for n, (u, a) in stencils.items():
        got, want = outs.pop(n), getattr(SR, n)(u, *a)
        err = (got - want).abs().max().item()
        check(err <= STENCIL_TOL, f"stream: {n} main path error {err:.3g}")
        check(n not in BIT_IDENTICAL_STENCILS or torch.equal(got, want),
              f"stream: {n} main path not bit-identical to plain")
        errs[n] = max(errs[n], err)
    check_one_launch_calls(torch, lambda: SO.sum_reduction(xs[0]),
                           SK.sum_counter(xs[0].device),
                           "stream: sum_reduction", SUM_KERNEL)
    print(f"stream main path: 16 kernels through ops (impl='auto') at "
          f"2^{int(math.log2(n_el))} f32 an array {STREAM_HBM_SHAPE}, pi "
          f"n=2^{int(math.log2(PI_N))}, jacobi "
          f"{JACOBI_2D_SHAPE} and {JACOBI_3D_SHAPE}, gauss-seidel "
          f"{GS_SHAPE} x {GS_SWEEPS} sweeps: every output held against its "
          f"plain version; launches {launches}")

    # timings
    o = torch.empty_like(xs[0])
    rows, ms_of = [], {}

    def row(name, kern, plain, library, lib_name, n_bytes, n_ops, *,
            iters=10, plain_iters=3, plain_warmup=3, what=""):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / FP32_FLOPS * 1e3
        # every array here lives in device memory (>> L2): the bound is a
        # floor for the kernel, its plain version and the library call
        bound = (name, max(t_bytes, t_ops) * 1e3,
                 "hbm" if t_bytes >= t_ops else "operations")
        ms = timed(torch, kern, iters, bound=bound)
        plain_ms = timed(torch, plain, plain_iters, warmup=plain_warmup,
                         bound=bound)
        lib_ms = None if library is None else timed(torch, library, iters,
                                                    bound=bound)
        line, src = STREAM_KERNELS[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"{STREAM_KPY}:{line}", "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
        ms_of[name] = ms
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.1f} us"
        rate = (f"{n_bytes / ms / 1e6:.0f} GB/s" if t_bytes >= t_ops else
                f"{n_ops / ms / 1e9:.0f} GFLOP/s")
        print(f"timing: {name} {what}: {ms * 1e3:.1f} us = {rate}, bound "
              f"{rows[-1]['bound_ms'] * 1e3:.1f} us "
              f"({rows[-1]['bound_by']}), plain {plain_ms * 1e3:.1f} us, "
              f"{lib_name} {lib} (device time by profiler)")

    for name, call in inits.items():
        row(name, lambda c=call: c(STREAM_HBM_SHAPE, torch.float32),
            lambda: SR.init(STREAM_HBM_SHAPE, STREAM_S, torch.float32,
                            "cuda"), lambda: o.fill_(STREAM_S), "fill_",
            n_el * 4, 0, what=f"f32 {STREAM_HBM_SHAPE}")
    for name, (k, call, plain, lib, flops) in elementwise.items():
        row(name, lambda c=call, k=k: c(xs[:k]),
            lambda p=plain, k=k: p(xs[:k]),
            lambda f=lib, k=k: f(xs[:k], o),
            STREAM_LIBRARY[name.removesuffix("_nt")],
            n_el * 4 * (k + 1), n_el * flops, what=f"f32 {STREAM_HBM_SHAPE}")
    row("sum_reduction", lambda: SO.sum_reduction(xs[0]),
        lambda: SR.sum_reduction(xs[0]), lambda: torch.sum(xs[0]),
        "torch.sum", n_el * 4, n_el, what=f"f32 {STREAM_HBM_SHAPE}")
    row("pi_integration", lambda: SO.pi_integration(PI_N, device="cuda"),
        lambda: SR.pi_integration(PI_N, device="cuda"), None,
        "no single PyTorch call:", 4,   # its output
        PI_N * PI_OPS_PER_POINT, what=f"n={PI_N} ({PI_OPS_PER_POINT} fp32 "
        f"operations a point)")
    print_pi_floors(torch, SK.build, ms_of["pi_integration"])
    w2 = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                       [0.0, 0.25, 0.0]], device="cuda")[None, None]
    w3 = torch.zeros(1, 1, 3, 3, 3, device="cuda")
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w3[(0, 0) + idx] = 1.0 / 6.0
    h, w = JACOBI_2D_SHAPE
    row("jacobi_2d5pt", lambda: SO.jacobi_2d5pt(j2),
        lambda: SR.jacobi_2d5pt(j2), lambda: F.conv2d(j2[None, None], w2),
        "conv2d", (h * w + (h - 2) * (w - 2)) * 4, (h - 2) * (w - 2) * 4,
        what=f"{JACOBI_2D_SHAPE}")
    d, h, w = JACOBI_3D_SHAPE
    row("jacobi_3d7pt", lambda: SO.jacobi_3d7pt(j3),
        lambda: SR.jacobi_3d7pt(j3), lambda: F.conv3d(j3[None, None], w3),
        "conv3d", (d * h * w + (d - 2) * (h - 2) * (w - 2)) * 4,
        (d - 2) * (h - 2) * (w - 2) * 6, iters=5,
        what=f"{JACOBI_3D_SHAPE}")
    h, w = GS_SHAPE
    row("gauss_seidel_2d5pt", lambda: SO.gauss_seidel_2d5pt(gs, GS_SWEEPS),
        lambda: SR.gauss_seidel_2d5pt(gs, GS_SWEEPS), None,
        "no single PyTorch call:", h * w * 4 * 2,
        (h - 2) * (w - 2) * 4 * GS_SWEEPS, plain_iters=1,
        plain_warmup=0,   # its ~41,000 launches ran once in the check above
        what=f"{GS_SHAPE} x {GS_SWEEPS} sweeps")
    moved = len(gs_plan.fused) * 2 * h * w * 4
    print(f"timing: gauss_seidel_2d5pt: {len(gs_plan.fused)} pass(es) of "
          f"{gs_plan.fused} fused sweeps, {gs_plan.strips} warps: "
          f"{moved / ms_of['gauss_seidel_2d5pt'] / 1e6:.0f} GB/s of the "
          f"{moved / 1e6:.1f} MB the passes move (a read and a write of the "
          f"grid each), {rows[-1]['bound_ms'] / ms_of['gauss_seidel_2d5pt']:.1%}"
          f" of the bound's speed ({rows[-1]['bound_ms'] * 1e3:.1f} us)")
    plan4 = SK.gauss_seidel_plan(h, w, 2 * GS_SWEEPS)
    ms4 = timed(torch, lambda: SO.gauss_seidel_2d5pt(gs, 2 * GS_SWEEPS), 10)
    print(f"timing: gauss_seidel_2d5pt x {2 * GS_SWEEPS} sweeps in "
          f"{len(plan4.fused)} pass(es) of {plan4.fused}: {ms4 * 1e3:.1f} us "
          f"= {ms4 * 1e3 / (2 * GS_SWEEPS):.1f} us a sweep, against "
          f"{ms_of['gauss_seidel_2d5pt'] * 1e3 / GS_SWEEPS:.1f} at "
          f"{GS_SWEEPS} sweeps")

    gbs = {n: n_el * 4 / ms_of[n] / 1e6 for n in inits}
    print(f"stream: INIT at {n_el} f32 ({n_el * 4 / 2**30:g} GiB "
          f"written), effective GB/s: "
          f"init_store {gbs['init_store']:.0f}, init_partial "
          f"{gbs['init_partial']:.0f} (7 x 100 blocks, half of them "
          f"sector-misaligned), init_nt {gbs['init_nt']:.0f}; bound "
          f"{HBM_BYTES_PER_S / 1e9:.0f}")
    print("stream: standard vs NT (st.global.cs) stores, device us: "
          + ", ".join(f"{n} {ms_of[n] * 1e3:.1f} vs {ms_of[nt] * 1e3:.1f}"
                      for n, nt in (("init_store", "init_nt"),
                                    ("copy", "copy_nt"),
                                    ("update", "update_nt"),
                                    ("stream_triad", "stream_triad_nt"))))
    del o, j2, j3, gs
    ls = [x[:STREAM_L2_SHAPE[0] * STREAM_L2_SHAPE[1]].reshape(
        STREAM_L2_SHAPE).clone() for x in (xs[0].view(-1), xs[1].view(-1))]
    del xs
    lo = torch.empty_like(ls[0])
    n_l2 = ls[0].numel()
    rung = []
    for name, k, lib in (("copy", 1, lambda: lo.copy_(ls[0])),
                         ("add", 2, lambda: torch.add(ls[0], ls[1], out=lo)),
                         ("stream_triad", 2, lambda: torch.add(
                             ls[0], ls[1], alpha=STREAM_S, out=lo))):
        call = elementwise[name][1]
        ms = timed(torch, lambda c=call, k=k: c(ls[:k]), 200)
        lib_ms = timed(torch, lib, 200)
        b = n_l2 * 4 * (k + 1)
        rung.append(f"{name} {ms * 1e3:.2f} us = {b / ms / 1e6:.0f} GB/s "
                    f"(library {lib_ms * 1e3:.2f} us = "
                    f"{b / lib_ms / 1e6:.0f} GB/s)")
    print(f"stream: L2 rung, {n_l2} f32 ({n_l2 * 4 / 2**20:g} MiB) an "
          f"array, back to back: "
          + "; ".join(rung))
    del ls, lo
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"stream phase: {time.perf_counter() - t0:.1f} s")
    return rows


# --- phase 3: decode kernel ------------------------------------------------

# (B, H, Hkv, Dh, Sq values) checked beside yi-9b's heads: gemma3-4b's
# head_dim 256, and G = 16 (qwen3-moe-235b) at Sq = 4, 64 packed rows
WIDE_DECODE_SHAPES = ((4, 8, 4, 256, (1, 4)), (2, 64, 4, 128, (1, 4)))
#: the model families' decode shapes at Sq = 1 in bf16, (B, H, Hkv, Dh,
#: Skv, window): qwen2-vl-7b's G = 7, musicgen-large's MHA (G = 1) at
#: Dh = 64, gemma3-4b's heads with its 1024-row window over a 2048-row
#: cache (slots' positions spread on both sides of the window), jamba's
#: attention layer (H 32, Hkv 8, no RoPE), grok-1's G = 6 and
#: qwen3-moe's G = 16
FAMILY_DECODE_SHAPES = ((8, 28, 4, 128, 2048, None),
                        (8, 32, 32, 64, 2048, None),
                        (8, 8, 4, 256, 2048, 1024),
                        (8, 32, 8, 128, 2048, None),
                        (8, 48, 8, 128, 2048, None),
                        (8, 64, 4, 128, 2048, None))


def finished_ok(torch, got, want_f32) -> tuple:
    """``(ok, max abs err)`` of a finished decode output in q's dtype
    against the plain version's fp32 output (partials merged by
    ``combine_splits``). fp32: within DECODE_TOL, as the partials. bf16:
    within one bf16 ulp of the plain output rounded to bf16 (what
    ``.to(torch.bfloat16)`` gives), plus DECODE_TOL: both sides round an
    fp32 value once, and the two fp32 values, their sums taken in other
    orders, differ by up to DECODE_TOL."""
    want = want_f32.to(got.dtype).float()
    err = (got.float() - want).abs()
    lim = DECODE_TOL
    if got.dtype == torch.bfloat16:
        lim = bf16_ulp(torch, want) + DECODE_TOL
    return bool((err <= lim).all()), err.max().item()


def same_bits(torch, a, b) -> bool:
    """Whether two tensors of one dtype and shape hold the same bits."""
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def check_finished(torch, D, call, want_f32, what: str) -> float:
    """The finished output of ``call()`` (one kernel launch) against the
    plain version's fp32 output (:func:`finished_ok`), a second call's
    bits against the first's, and the split counters all 0 after each;
    returns the max abs err."""
    got = call()
    torch.cuda.synchronize()
    counters = D.split_counters(got.device)
    check(not counters.any(), f"{what}: split counters not 0 after a call")
    again = call()
    torch.cuda.synchronize()
    check(not counters.any(), f"{what}: split counters not 0 after a call")
    check(same_bits(torch, got, again), f"{what}: two calls differ")
    ok, err = finished_ok(torch, got, want_f32)
    check(ok, f"{what}: finished output err {err:.3g} over one "
          f"{'bf16 ulp + ' if got.dtype == torch.bfloat16 else ''}"
          f"{DECODE_TOL}")
    return err


#: the decode kernels' names as the profiler demangles them (the bf16 and
#: fp32 bodies, each with PAGED = false and true; also their former names,
#: decode_partials_*, so a trace of an older checkout groups them alike)
DECODE_KERNEL = re.compile(r"\bdecode_(partials_)?(f32_)?kernel<")
#: the decode kernels' instantiations over a page pool: the third
#: template argument is PAGED (a fourth, WRITE, may follow)
DECODE_PAGED = re.compile(r"kernel<\d+, \d+, true\b")
#: sum_reduction's and pi_integration's kernels as the profiler
#: demangles them
SUM_KERNEL = re.compile(r"\bsum_kernel<")
PI_KERNEL = re.compile(r"\bpi_kernel<")


def one_kernel_event(torch, call, what: str, kernel=DECODE_KERNEL) -> None:
    """One ``call()`` (warm, its counters made) puts exactly one device
    event, the kernel whose name ``kernel`` matches, in a profiler
    window."""
    call()
    torch.cuda.synchronize()
    counts = {}
    profiled(torch, call, what, counts=counts)
    check(sum(counts.values()) == 1 and all(
        kernel.search(n) for n in counts),
        f"{what}: one call put {counts} on the card, not one "
        f"{kernel.pattern} kernel")
    print(f"{what}: one call is one kernel event ({next(iter(counts))[:60]})")


def decode_bound(b: int, h: int, hkv: int, dh: int, live: int, elt: int,
                 table_entries: int = 0) -> tuple:
    """``(bound ms, "bytes" or "operations", bytes)`` of one finished
    decode call at Sq = 1: q read once (``elt`` bytes an element), K and
    V of each of the ``live`` rows its slots read once, pos and the block
    table's entries read (4 bytes each), and the (B, 1, H, Dh) output
    written once in q's dtype; against 4 * Dh operations for each (query
    head, live row) pair at the fp32 rate."""
    n_bytes = (2 * b * h * dh * elt + live * hkv * dh * 2 * elt + b * 4
               + table_entries * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = live * h * dh * 4 / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes)


def phase_decode(torch, D, ops) -> float:
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = worst_fin = 0.0
    cases = 0

    def case(q, k, v, pos, window, bound, split_len, n, what):
        nonlocal worst, worst_fin, cases
        dense = D.ref_decode(q.float(), k.float(), v.float(), pos,
                             window=window, kv_len=bound)
        kw = dict(window=window, split_len=split_len, n_splits=n,
                  bound=bound)
        ok_, mk, lk = D.decode_partials(q, k, v, pos, impl="cuda", **kw)
        orf, mr, lr = D.decode_partials(q, k, v, pos, impl="ref", **kw)
        torch.cuda.synchronize()
        got = D.combine_splits(ok_, mk, lk)
        ref = D.combine_splits(orf, mr, lr)
        err = (got - ref).abs().max().item()
        err_dense = (got - dense.float()).abs().max().item()
        where = f"{what} bound={bound} n_splits={n}"
        check(torch.equal(lk == 0, lr == 0), f"decode: dead splits differ "
              f"({where})")
        check(err <= DECODE_TOL and err_dense <= DECODE_TOL,
              f"decode: max err {err:.3g} (dense {err_dense:.3g}) > "
              f"{DECODE_TOL} at {where}")
        fin = check_finished(torch, D, lambda: D.decode_finished(
            q, k, v, pos, impl="cuda", **kw), ref, f"decode {where}")
        worst = max(worst, err)
        worst_fin = max(worst_fin, fin)
        cases += 1

    for skv in (4096, 4095):
        k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
        for sq in (1, 4):
            # per-slot positions spread over the whole cache
            pos = torch.linspace(0, skv - sq, B, device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen, device="cuda").bfloat16()
            for window in (None, 256):
                for ns in (1, None):
                    bound, split_len, n = D.split_plan(B, HKV, skv, 128, ns,
                                                       None)
                    case(q, k, v, pos, window, bound, split_len, n,
                         f"skv={skv} sq={sq} window={window}")
    # the served path's cut: a 2048-row horizon read only up to the
    # occupancy bound, as ops.flash_decode rounds it (472 -> 512 and
    # 301 -> 384), and one bound left ragged inside a 128-row block
    skv = 2048
    k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    for kv_len, rounded in ((472, True), (301, True), (301, False)):
        bound = min(-(-kv_len // 128) * 128, skv) if rounded else kv_len
        for sq in (1, 4):
            pos = torch.linspace(0, kv_len - sq, B, device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen, device="cuda").bfloat16()
            bound_, split_len, n = D.split_plan(B, HKV, skv, 128, None, bound)
            check(bound_ == bound, f"decode: split_plan bound {bound_}")
            case(q, k, v, pos, None, bound, split_len, n,
                 f"skv={skv} kv_len={kv_len} sq={sq}")
            if rounded:
                # the router's own rounding reaches the same bound
                got = ops.flash_decode(q, k, v, pos, kv_len=kv_len,
                                       impl="cuda").float()
                want = D.ref_decode(q.float(), k.float(), v.float(), pos,
                                    kv_len=bound)
                err = (got - want).abs().max().item()
                check(err <= BF16_OUT_TOL, f"decode: ops.flash_decode err "
                      f"{err:.3g} > {BF16_OUT_TOL} at kv_len={kv_len}")
    one_kernel_event(torch, lambda: ops.flash_decode(
        q, k, v, pos, kv_len=kv_len, impl="cuda"), "decode: ops.flash_decode")
    # the head shapes past yi-9b's: gemma3-4b's Dh = 256 (8 heads over 4
    # KV heads) and qwen3-moe-235b's G = 16 at Sq = 4 (64 packed rows, two
    # row groups), in bf16 and fp32
    for b, h, hkv, dh, sqs in WIDE_DECODE_SHAPES:
        skv = 1000
        for dtype in (torch.bfloat16, torch.float32):
            k = torch.randn(b, skv, hkv, dh, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(b, skv, hkv, dh, generator=gen,
                            device="cuda").to(dtype)
            for sq in sqs:
                pos = torch.linspace(0, skv - sq, b,
                                     device="cuda").round().int()
                q = torch.randn(b, sq, h, dh, generator=gen,
                                device="cuda").to(dtype)
                for window in (None, 256):
                    for ns in (1, None):
                        bound, split_len, n = D.split_plan(b, hkv, skv, 128,
                                                           ns, None)
                        case(q, k, v, pos, window, bound, split_len, n,
                             f"H={h} Hkv={hkv} Dh={dh} {dtype} sq={sq} "
                             f"window={window}")
    for b, h, hkv, dh, skv, window in FAMILY_DECODE_SHAPES:
        k = torch.randn(b, skv, hkv, dh, generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn(b, skv, hkv, dh, generator=gen,
                        device="cuda").bfloat16()
        pos = torch.linspace(0, skv - 1, b, device="cuda").round().int()
        q = torch.randn(b, 1, h, dh, generator=gen, device="cuda").bfloat16()
        for ns in (1, None):
            bound, split_len, n = D.split_plan(b, hkv, skv, 128, ns, None)
            case(q, k, v, pos, window, bound, split_len, n,
                 f"family H={h} Hkv={hkv} Dh={dh} sq=1 window={window}")
    print(f"decode kernel: {cases} cases vs plain version, max abs err "
          f"{worst:.3g} (tol {DECODE_TOL}, partials merged in fp32), "
          f"finished output {worst_fin:.3g} (fp32 within {DECODE_TOL}, "
          f"bf16 within one ulp + {DECODE_TOL}; counters 0 after every "
          f"call, repeats bit-identical), incl. occupancy bounds 512, 384 "
          f"and 301 of a 2048-row cache, Dh=256 and G*Sq=64 packed rows in "
          f"bf16 and fp32, and in bf16 G=7 (H=28 Hkv=4 Dh=128), G=1 "
          f"(H=Hkv=32 Dh=64), a 1024-row window over 2048 rows at "
          f"Dh=256, G=4 (H=32 Hkv=8, jamba), G=6 (H=48 Hkv=8, grok-1) and "
          f"G=16 (H=64 Hkv=4, qwen3-moe) at Dh=128")
    return worst_fin


# --- phase 4: KV row writer ------------------------------------------------

def phase_stores(torch, S_, K) -> int:
    """The standalone writer's calls, its launches counted from zero;
    returns them."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    s = 2048
    K.reset_launches()
    for sq in (1, 4):
        # slot 7 overshoots the horizon: its start clamps to s - sq
        pos = torch.tensor([0, 5, 100, 1000, 2047 - sq, s - sq, 2046, 2047 + 3],
                           dtype=torch.int32, device="cuda")
        kn = torch.randn(B, sq, HKV, DH, generator=gen, device="cuda").bfloat16()
        vn = torch.randn(B, sq, HKV, DH, generator=gen, device="cuda").bfloat16()
        for flavor in ("standard", "nt"):
            kc = torch.randn(B, s, HKV, DH, generator=gen, device="cuda").bfloat16()
            vc = torch.randn(B, s, HKV, DH, generator=gen, device="cuda").bfloat16()
            kr, vr = kc.clone(), vc.clone()
            ptrs = (kc.data_ptr(), vc.data_ptr())
            S_.kv_row_update(kc, vc, kn, vn, pos, flavor=flavor, impl="cuda")
            S_.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor, impl="ref")
            torch.cuda.synchronize()
            check((kc.data_ptr(), vc.data_ptr()) == ptrs,
                  "stores: cache storage moved")
            check(torch.equal(kc.view(torch.int16), kr.view(torch.int16))
                  and torch.equal(vc.view(torch.int16), vr.view(torch.int16)),
                  f"stores: {flavor} sq={sq} not byte-identical to plain")
            check(torch.equal(kc[7, s - sq:].view(torch.int16),
                              kn[7].view(torch.int16)),
                  "stores: overshoot row not clamped to the last rows")
    launches = K.LAUNCHES["kv_row_update"]
    check(launches == 4, f"stores: {launches} writer launches, expected 4")
    print(f"kv writer: standard and nt byte-identical to plain version "
          f"(sq 1 and 4, clamped overshoot, in place); {launches} launches")
    return launches


# --- phase 3c: the step's row write inside the decode launch ---------------

def phase_fused_write(torch, D, ops, S_, K) -> None:
    """The decode kernels given the decode step's new rows against the
    unfused pair, bit for bit, dense and paged."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    cases = 0

    def same(a, b, what):
        check(same_bits(torch, a, b), f"fused write: {what}")

    for b, h, hkv, dh, sqs in ((B, H, HKV, DH, (1, 4)),) + WIDE_DECODE_SHAPES:
        skv, ps = 1008, 16
        nb = skv // ps
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen,
                                   device="cuda").to(dtype)
            k, v = rnd(b, skv, hkv, dh), rnd(b, skv, hkv, dh)
            kp, vp, bt = _paged_pools(torch, k, v, ps, gen)
            for sq in sqs:
                q, kn, vn = rnd(b, sq, h, dh), rnd(b, sq, hkv, dh), \
                    rnd(b, sq, hkv, dh)
                # dense: slot 0 counted from the end, the last clamped
                pos = torch.linspace(0, skv - sq, b,
                                     device="cuda").round().int()
                pos[0], pos[-1] = -2, skv + 3
                # paged: slot 0's negative position wraps to its table's
                # last column, the last slot overshoots the table onto its
                # last column, a kv_len cut reads below that column
                ppos = torch.linspace(0, skv - 64, b,
                                      device="cuda").round().int()
                ppos[0], ppos[-1] = -3, skv + 5
                cut = -(-(int(ppos[:-1].max()) + sq) // ps)
                for flavor in ("standard", "nt"):
                    for ns in (1, None):
                        bound, split_len, n = D.split_plan(b, hkv, skv, 128,
                                                           ns, None)
                        kw = dict(window=None, split_len=split_len,
                                  n_splits=n, bound=bound)
                        kc, vc, kr, vr = k.clone(), v.clone(), k.clone(), \
                            v.clone()
                        S_.kv_row_update(kr, vr, kn, vn, pos, flavor=flavor,
                                         impl="cuda")
                        want = D.decode_finished(q, kr, vr, pos, impl="cuda",
                                                 **kw)
                        got = D.decode_finished(q, kc, vc, pos, impl="cuda",
                                                k_new=kn, v_new=vn,
                                                store_flavor=flavor, **kw)
                        torch.cuda.synchronize()
                        what = (f"dense H={h} Dh={dh} {dtype} sq={sq} "
                                f"{flavor} n_splits={n}")
                        same(got, want, f"{what}: output")
                        same(kc, kr, f"{what}: k cache")
                        same(vc, vr, f"{what}: v cache")
                        cases += 1
                    for n_blocks, ns in ((nb, 1), (nb, None), (cut, None)):
                        bound, split_len, n = D.paged_split_plan(
                            b, hkv, ps, n_blocks, ns)
                        kw = dict(window=None, split_len=split_len,
                                  n_splits=n, bound=bound)
                        kc, vc, kr, vr = kp.clone(), vp.clone(), \
                            kp.clone(), vp.clone()
                        S_.ref_paged_row_update(kr, vr, bt, kn, vn, ppos)
                        want = D.decode_paged_finished(q, kr, vr, bt, ppos,
                                                       impl="cuda", **kw)
                        got = D.decode_paged_finished(
                            q, kc, vc, bt, ppos, impl="cuda", k_new=kn,
                            v_new=vn, store_flavor=flavor, **kw)
                        torch.cuda.synchronize()
                        what = (f"paged H={h} Dh={dh} {dtype} sq={sq} "
                                f"{flavor} n_splits={n} columns={n_blocks}")
                        same(got, want, f"{what}: output")
                        same(kc, kr, f"{what}: k pool")
                        same(vc, vr, f"{what}: v pool")
                        cases += 1
    # one fused call is one kernel event, and counts as a decode launch
    # that wrote rows
    q, kn, vn = (torch.randn(B, 1, n_h, DH, generator=gen,
                             device="cuda").bfloat16()
                 for n_h in (H, HKV, HKV))
    k = torch.randn(B, 2048, HKV, DH, generator=gen, device="cuda").bfloat16()
    v = torch.randn_like(k)
    pos = torch.linspace(0, 500, B, device="cuda").round().int()
    kp, vp, bt = _paged_pools(torch, k, v, 16, gen)
    for name, call in (
            ("flash_decode", lambda: ops.flash_decode(
                q, k, v, pos, kv_len=512, impl="cuda", k_new=kn, v_new=vn)),
            ("flash_decode_paged", lambda: ops.flash_decode_paged(
                q, kp, vp, bt, pos, kv_len=512, impl="cuda", k_new=kn,
                v_new=vn))):
        K.reset_launches()
        call()
        check(K.LAUNCHES[name] == 1 and K.LAUNCHES["kv_rows_in_decode"] == 1
              and K.LAUNCHES["kv_row_update"] == 0,
              f"fused write: ops.{name} counted {K.LAUNCHES}")
        one_kernel_event(torch, call, f"fused write: ops.{name}")
    print(f"fused write: {cases} cases, decode launches given the step's "
          f"rows bit-identical to the unfused pair (writer or index write, "
          f"then decode), caches byte-identical (yi-9b heads, Dh=256 and "
          f"G*Sq=64; bf16 and fp32; Sq 1/4; standard and nt; one/default "
          f"splits; negative (dense and paged), overshooting and clamped "
          f"positions; a kv_len cut below the written page)")


# --- phase 5: full-width serving -------------------------------------------

def attention_layers(cfg) -> int:
    """Layers of ``cfg`` whose mixer attends: one decode launch each a
    step (0 for xlstm-125m, 1 a jamba period)."""
    return sum(b.split(":")[0] in ("attn", "attn_local")
               for b in cfg.layer_plan())


def serve_dense(torch, K, serve, cfg, params, reqs, label: str) -> tuple:
    """Serve ``reqs`` through a dense 8-slot ``ServeEngine`` (a 2048-row
    horizon, 8-token chunks, its graphs captured first: one a ``kv_len``
    bucket, one for a model without attention), launch counts zeroed
    just before the run and read just after. Fails unless every request
    got its tokens, in vocab, no dispatch captured a graph, no slot was
    quarantined, and every decode launch was a ``flash_decode`` writing
    the step's rows (attention layers x steps) with no paged kernel and
    no standalone writer. Prints tok/s, prefill s and ms a step. Returns
    (engine, launches)."""
    from repro_torch.serve.engine import kv_buckets
    eng = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048, chunk=8,
                            device="cuda")
    capture_graphs(torch, eng, label)
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = eng.stats()
    steps = st["decode_tokens"]
    n_tok = sum(len(v) for v in res.values())
    check(sorted(res) == sorted(r.rid for r in reqs)
          and all(len(res[r.rid]) == r.max_new_tokens for r in reqs),
          f"{label}: not every request got its tokens")
    check(all(int(v.min()) >= 0 and int(v.max()) < cfg.vocab_size
              for v in res.values()), f"{label}: token id out of vocab")
    check(len(eng.graphs.graphs) == len(kv_buckets(cfg, eng.max_len)),
          f"{label}: a dispatch captured a graph")
    check(st["quarantined"] == 0, f"{label}: non-finite logits quarantined")
    print(f"{label}: {len(res)} requests, {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tok/s; prefill {st['prefill_s']:.2f} s "
          f"({st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.2f} s ({st['decode_dispatches']} dispatches, "
          f"{steps} steps, {st['decode_s'] / steps * 1e3:.2f} ms/step)")
    attn = attention_layers(cfg)
    want = attn * steps
    print(f"{label}: launches {launches} (expected flash_decode == "
          f"kv_rows_in_decode == {attn} attention layers x {steps} = {want}, "
          f"kv_row_update 0)")
    print_step_launches(label, launches, steps)
    check(launches["flash_decode"] == launches["kv_rows_in_decode"] == want
          and (want > 0 or attn == 0) and launches["kv_row_update"] == 0
          and launches["flash_decode_paged"] == 0,
          f"{label}: launches {launches}, expected flash_decode and "
          f"kv_rows_in_decode {want} each, no paged kernel and no "
          f"standalone writer")
    return eng, launches


def phase_engine(torch, np, cfg_mod, M, K, serve):
    cfg = cfg_mod.get_config("yi-9b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"engine: yi-9b {cfg.n_layers} layers d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    lens = rng.integers(128, 513, size=16)
    reqs = [serve.Request(f"r{i}", tuple(int(t) for t in
                                         rng.integers(0, cfg.vocab_size, n)), 64)
            for i, n in enumerate(lens)]
    eng, launches = serve_dense(torch, K, serve, cfg, params, reqs, "engine")

    # one decode step through the kernels against impl="ref", from the
    # served requests' first 8 prompts and from three more prompt sets
    sets = [[r.prompt for r in reqs[:8]]]
    for seed in LOGITS_SEEDS:
        g = np.random.default_rng(seed)
        sets.append([tuple(int(t) for t in g.integers(0, cfg.vocab_size, n))
                     for n in g.integers(128, 513, size=8)])
    readings = [_one_step_logits(torch, cfg, M, params, p) for p in sets]
    print("engine: one decode step, kernels vs impl='ref', max |diff| / "
          "max |logit| (greedy argmax agreement) per prompt set: "
          + ", ".join(f"{rel:.4g} ({agree:.3f})" for rel, agree, _ in readings)
          + f"; tol {LOGITS_REL_TOL}")
    worst = max(rel for rel, _, _ in readings)
    check(worst <= LOGITS_REL_TOL, f"engine: kernel logits vs impl='ref' "
          f"rel err {worst:.3g} > {LOGITS_REL_TOL}")
    _small_engine_check(torch, np, cfg_mod, M, serve)
    return eng, reqs, launches


def graph_pool_bytes(torch, pool) -> int | None:
    """Bytes of the allocator's segments in the graph memory pool
    ``pool``; None where its snapshot names no segment of it."""
    segs = [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool)]
    return sum(seg["total_size"] for seg in segs) if segs else None


def capture_graphs(torch, eng, label: str) -> None:
    """Capture the decode chunk's graph of every ``kv_len`` bucket of
    ``eng`` (before any timed window), and print how many, the time it
    took and the graph pool's bytes."""
    from repro_torch.serve.engine import KV_BUCKET
    check(eng.graphs is not None, f"{label}: the engine runs no graphs")
    t0 = time.perf_counter()
    n = eng.capture_graphs()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    pool = graph_pool_bytes(torch, eng.graphs.pool)
    each = (f"one a {KV_BUCKET}-row kv_len bucket to {eng.max_len} rows"
            if attention_layers(eng.cfg) else
            "one for every chunk: the model reads no KV rows")
    print(f"{label}: {n} CUDA graphs captured in {sec:.2f} s ({each}, "
          f"{len(eng.graphs.graphs)} held; warm-up and capture "
          f"{eng.graphs.capture_s:.2f} s in all); graph pool "
          + ("not in the allocator's snapshot" if pool is None
             else f"{pool / 2 ** 20:.1f} MiB"))


def print_step_launches(label: str, launches: dict, steps: int) -> None:
    """The port's kernel launches a decode step, by kernel (counts of
    the run over its decode steps; the prefill launches none)."""
    ran = {n: c / steps for n, c in launches.items() if c}
    print(f"{label}: the port's kernel launches a decode step: "
          + ", ".join(f"{n} {c:g}" for n, c in ran.items())
          + " (kv_rows_in_decode: decode launches that wrote the step's "
          "rows; the trace phase counts every kernel)")


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


class RouteLog:
    """The MoE routes a block of code makes: ``(top_e, keep)`` of every
    ``moe.route`` call, recorded by wrapping that function for the
    ``with`` block (``moe_ffn`` looks it up at each call)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self._route = route = self.moe.route

        def recording(*args, **kw):
            out = route(*args, **kw)
            self.calls.append((out[2], out[3]))
            return out

        self.moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self._route


def routed_alike(torch, a: RouteLog, b: RouteLog, slots: int):
    """(slots,) bool: the slots of two decode steps' logs sent to the same
    experts, and kept or dropped alike, in every MoE layer (all True
    without MoE layers)."""
    check(len(a.calls) == len(b.calls), "MoE route logs of unequal length")
    same = torch.ones(slots, dtype=torch.bool, device="cuda")
    for (ea, ka), (eb, kb) in zip(a.calls, b.calls):
        k = ea.shape[-1]
        same &= (ea.reshape(slots, k) == eb.reshape(slots, k)).all(-1)
        same &= (ka.reshape(slots, k) == kb.reshape(slots, k)).all(-1)
    return same


def logits_rel(torch, lk, lr, same, label: str) -> tuple:
    """``(max |diff| / max |logit|, argmax agreement, slots routed apart)``
    of two decode steps' logits (B, 1, V), over the slots routed alike.
    A slot whose MoE route differs (a near tie of the router, flipped by
    the bf16 rounding of another path, or a drop it moved) is left out
    and counted; fails if it is half the slots or more."""
    lk, lr = lk[:, 0].float(), lr[:, 0].float()
    check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
    apart = int((~same).sum())
    check(2 * apart < same.numel(), f"{label}: {apart} of {same.numel()} "
          f"slots routed apart")
    rel = ((lk - lr)[same].abs().max() / lr.abs().max()).item()
    agree = (lk.argmax(-1) == lr.argmax(-1))[same].float().mean().item()
    return rel, agree, apart


def _one_step_logits(torch, cfg, M, params, prompts,
                     label: str = "engine") -> tuple:
    """Prefill ``prompts`` into 8 slots of a 2048-row cache, then one
    decode step through the kernels and one with ``impl="ref"`` on a copy
    of the cache. Returns :func:`logits_rel`'s reading."""
    from repro_torch.serve.slots import insert
    from repro_torch.train.serve import make_prefill_step
    fresh = M.init_cache(cfg, 8, 2048, "cuda")
    prefill = make_prefill_step(cfg, cache_len=2048)
    toks = []
    for i, p in enumerate(prompts):
        lg, one = prefill(params, {"tokens": torch.tensor(
            [p], dtype=torch.int64, device="cuda")})
        insert(fresh, one, i)
        toks.append(int(lg[0, -1].argmax()))
    del one
    tok = torch.tensor(toks, dtype=torch.int64, device="cuda")[:, None]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    kv_len = int(pos.max()) + 1
    ref_cache = _clone(fresh)
    with RouteLog() as rk:
        lk, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=fresh, pos=pos, impl="auto",
                             kv_len=kv_len)
    del fresh
    with RouteLog() as rr:
        lr, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=ref_cache, pos=pos, impl="ref",
                             kv_len=kv_len)
    return logits_rel(torch, lk, lr, routed_alike(torch, rk, rr, 8), label)


def _small_engine_check(torch, np, cfg_mod, M, serve) -> None:
    """Smoke-size fp32 engine: greedy streams on the card == on the CPU."""
    cfg = dataclasses.replace(cfg_mod.get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [serve.Request(str(i), tuple(int(t) for t in
                                        rng.integers(0, cfg.vocab_size, n)), m)
            for i, (n, m) in enumerate([(9, 12), (17, 5), (4, 1), (12, 9),
                                        (30, 7)])]
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        eng = serve.ServeEngine(cfg, p, max_slots=2, max_len=40, chunk=3,
                                device=dev)
        out[dev] = eng.run(reqs)
    check(all(out["cpu"][r.rid].tolist() == out["cuda"][r.rid].tolist()
              for r in reqs), "engine: smoke fp32 streams differ card vs CPU")
    print("engine: smoke-size fp32 greedy streams identical on the card and "
          "the CPU (5 requests, 2 slots, chunk 3)")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# --- phase 6: kernel timings -----------------------------------------------

def phase_timings(torch, np, D, ops, S_, eng, reqs, launches,
                  decode_err, writer_launches) -> list:
    F = torch.nn.functional
    cache = eng.cache["scan"]["0"]
    n_layers, skv = cache["k"].shape[0], cache["k"].shape[2]
    # mid-decode positions of the first 8 requests: prompt + 32 tokens
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:B]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    # the split plan ops.flash_decode makes of kv_len (rounded up to 128)
    bound, split_len, n_splits = D.split_plan(
        B, HKV, skv, 128, None, min(-(-kv_len // 128) * 128, skv))
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(B, 1, H, DH, generator=gen, device="cuda").bfloat16()
    kn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    kw = dict(window=None, split_len=split_len, n_splits=n_splits,
              bound=bound)
    # cycle over the 48 layers' caches so every call reads cold KV rows,
    # as the decode step does
    layer = [0]

    def next_kv():
        i = layer[0] = (layer[0] + 1) % n_layers
        return cache["k"][i], cache["v"][i]

    def kern():
        # the router's finished output, as the decode step calls it: one
        # launch, the splits merged inside the kernel
        k, v = next_kv()
        ops.flash_decode(q, k, v, pos, kv_len=kv_len, impl="cuda")

    def partials():
        k, v = next_kv()
        D.decode_partials(q, k, v, pos, impl="cuda", **kw)

    def fused():
        # as the decode step calls it: the step's rows written first, in
        # the same launch
        k, v = next_kv()
        ops.flash_decode(q, k, v, pos, kv_len=kv_len, impl="cuda", k_new=kn,
                         v_new=vn)

    def pair():
        # the same work as the standalone writer and then the decode
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="cuda")
        ops.flash_decode(q, k, v, pos, kv_len=kv_len, impl="cuda")

    def plain():
        k, v = next_kv()
        D.decode_finished(q, k, v, pos, impl="ref", **kw)

    mask = (torch.arange(bound, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]          # (B, 1, 1, bound)
    qt = q.transpose(1, 2)

    def library():
        k, v = next_kv()
        F.scaled_dot_product_attention(
            qt, k[:, :bound].transpose(1, 2), v[:, :bound].transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    ms = timed(torch, kern, 480)
    part_ms = timed(torch, partials, 480)
    fused_ms = timed(torch, fused, 480)
    pair_ms = timed(torch, pair, 480)
    plain_ms = timed(torch, plain, 48)
    lib_ms = timed(torch, library, 480)
    live = (pos + 1).clamp(max=bound).sum().item()       # KV rows read
    bound_ms, bound_by, n_bytes = decode_bound(B, H, HKV, DH, live, 2)
    w_bytes = 2 * 2 * B * HKV * DH * 2                   # rows read, written
    decode_row = {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/attention/decode.py:179",
        "launches": launches["flash_decode"], "max_abs_err": decode_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms,
        "fused_write_ms": fused_ms,
        "fused_write_bound_ms": max(bound_ms, (n_bytes + w_bytes)
                                    / HBM_BYTES_PER_S * 1e3)}
    print(f"timing: flash_decode (ops.flash_decode, finished output, one "
          f"launch) at B={B} Sq=1 kv_len={kv_len} n_splits={n_splits} "
          f"({live} live rows): {ms * 1e3:.2f} us = "
          f"{n_bytes / ms / 1e6:.0f} GB/s ({bound_ms / ms:.3f} of the "
          f"{bound_by} bound {bound_ms * 1e3:.2f} us), plain (partials + "
          f"combine_splits + cast) {plain_ms * 1e3:.1f} us, sdpa "
          f"{lib_ms * 1e3:.2f} us; the partials alone (no merge) "
          f"{part_ms * 1e3:.2f} us; with the step's row write in the same "
          f"launch, as the decode step calls it, {fused_ms * 1e3:.2f} us, "
          f"against {pair_ms * 1e3:.2f} us for kv_row_update and then the "
          f"decode (device time by profiler)")

    # KV writer: one layer's K and V rows per launch, at a decode position
    flat = [c.view(n_layers, -1, HKV, DH) for c in (cache["k"], cache["v"])]
    rows = (torch.arange(B, device="cuda") * cache["k"].shape[2]
            + pos).long()

    def wkern():
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="cuda")

    def wplain():
        k, v = next_kv()
        S_.kv_row_update(k, v, kn, vn, pos, impl="ref")

    def wlib():
        i = layer[0] = (layer[0] + 1) % n_layers
        flat[0][i].index_copy_(0, rows, kn[:, 0])
        flat[1][i].index_copy_(0, rows, vn[:, 0])

    wms = timed(torch, wkern, 960)
    wplain_ms = timed(torch, wplain, 96)
    wlib_ms = timed(torch, wlib, 960)
    # On the decode path the rows are written inside the decode launch (the
    # WRITE bodies of csrc/decode.cu, counted as kv_rows_in_decode), so the
    # row takes that kernel's launches from the engine run and its time is
    # what the write adds to the decode launch; the standalone writer
    # (csrc/stores.cu) is held against its plain version in phase 4.
    add_ms = fused_ms - ms
    writer_row = {
        "name": "kv_row_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/stores.py:235",
        "launches": launches["kv_rows_in_decode"], "max_abs_err": 0.0,
        "ms": add_ms, "plain_ms": wplain_ms,
        "bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": wlib_ms,
        "standalone_source": "src/repro_torch/kernels/csrc/stores.cu",
        "standalone_ms": wms,
        "standalone_launches": launches["kv_row_update"],
        "check_launches": writer_launches,
        "note": "launches: decode launches of the engine run that wrote the "
                "step's rows (kv_rows_in_decode); ms: the fused decode "
                "launch less the same launch without the write; the "
                "standalone kernel's own time is standalone_ms, its launches "
                "on the path standalone_launches, in phase 4 check_launches"}
    print(f"timing: kv_row_update at B={B} Sq=1: inside the decode launch "
          f"+{add_ms * 1e3:.2f} us ({launches['kv_rows_in_decode']} launches "
          f"on the path), standalone kernel {wms * 1e3:.2f} us "
          f"({launches['kv_row_update']} launches on the path, "
          f"{writer_launches} in phase 4), bound "
          f"{writer_row['bound_ms'] * 1e3:.4f} us, plain "
          f"{wplain_ms * 1e3:.1f} us, index_copy_ x2 {wlib_ms * 1e3:.2f} us "
          f"(device time by profiler)")
    return [decode_row, writer_row]


# --- phase 3a: paged decode kernel ----------------------------------------

def _paged_pools(torch, k, v, ps, gen):
    """The slot caches k, v (B, S, Hkv, Dh) as page pools under a randomly
    permuted block table, plus a scratch page of NaN at the end (the page
    dead table columns name; never read)."""
    b, skv, hkv, dh = k.shape
    nb = -(-skv // ps)
    perm = torch.randperm(b * nb, generator=gen, device="cuda")
    pad = (0, 0, 0, 0, 0, nb * ps - skv)
    pools = []
    for x in (k, v):
        pool = torch.full((b * nb + 1, ps, hkv, dh), float("nan"),
                          dtype=x.dtype, device="cuda")
        pool[perm] = torch.nn.functional.pad(x, pad).reshape(b * nb, ps, hkv,
                                                             dh)
        pools.append(pool)
    return pools[0], pools[1], perm.reshape(b, nb).int()


def phase_paged_decode(torch, D, ops) -> float:
    gen = torch.Generator(device="cuda").manual_seed(8)
    skv = 2048
    k = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, skv, HKV, DH, generator=gen, device="cuda").bfloat16()
    worst, worst_dense, worst_fin, cases = 0.0, 0.0, 0.0, 0
    for ps in (8, 16, 256):
        kp, vp, table = _paged_pools(torch, k, v, ps, gen)
        for sq in (1, 4):
            pos = torch.linspace(0, skv - 600 - sq, B,
                                 device="cuda").round().int()
            q = torch.randn(B, sq, H, DH, generator=gen,
                            device="cuda").bfloat16()
            # dead columns past each slot's last live row name the scratch
            bt = table.clone()
            for i, last in enumerate((pos + sq - 1).tolist()):
                bt[i, last // ps + 1:] = kp.shape[0] - 1
            full = bt.shape[1]
            cut = -(-(int(pos.max()) + sq) // ps)         # a kv_len bound
            for window in (None, 256):
                for ns, n_blocks in ((1, full), (None, full), (None, cut)):
                    bound, split_len, n = D.paged_split_plan(
                        B, HKV, ps, n_blocks, ns)
                    kw = dict(window=window, split_len=split_len,
                              n_splits=n, bound=bound)
                    ok_, mk, lk = D.decode_paged_partials(
                        q, kp, vp, bt, pos, impl="cuda", **kw)
                    orf, mr, lr = D.decode_paged_partials(
                        q, kp, vp, bt, pos, impl="ref", **kw)
                    torch.cuda.synchronize()
                    got = D.combine_splits(ok_, mk, lk)
                    ref = D.combine_splits(orf, mr, lr)
                    err = (got - ref).abs().max()
                    what = (f"page={ps} sq={sq} window={window} "
                            f"n_splits={n} bound={bound}")
                    check(torch.equal(lk == 0, lr == 0),
                          f"paged decode: dead splits differ ({what})")
                    check(err.item() <= DECODE_TOL, f"paged decode: max err "
                          f"{err.item():.3g} > {DECODE_TOL} at {what}")
                    worst_fin = max(worst_fin, check_finished(
                        torch, D, lambda: D.decode_paged_finished(
                            q, kp, vp, bt, pos, impl="cuda", **kw), ref,
                        f"paged decode {what}"))
                    worst = max(worst, err.item())
                    cases += 1
                # the same logical cache through the dense kernel
                b_, sl, nd = D.split_plan(B, HKV, skv, 128, None, None)
                dense = D.combine_splits(*D.decode_partials(
                    q, k, v, pos, window=window, split_len=sl, n_splits=nd,
                    bound=b_, impl="cuda"))
                paged = D.combine_splits(*D.decode_paged_partials(
                    q, kp, vp, bt, pos, impl="cuda", window=window,
                    **dict(zip(("bound", "split_len", "n_splits"),
                               D.paged_split_plan(B, HKV, ps, full,
                                                  None)))))
                err = (paged - dense).abs().max().item()
                check(err <= DECODE_TOL, f"paged decode vs dense kernel: "
                      f"{err:.3g} > {DECODE_TOL} at page={ps} sq={sq}")
                worst_dense = max(worst_dense, err)
        # the router's page bound reaches the same result
        got = ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=cut * ps - 3,
                                     impl="cuda").float()
        want = D.ref_decode(q.float(), k.float(), v.float(), pos)
        err = (got - want).abs().max().item()
        check(err <= BF16_OUT_TOL, f"paged decode: ops.flash_decode_paged "
              f"err {err:.3g} > {BF16_OUT_TOL} at page={ps}")
    one_kernel_event(torch, lambda: ops.flash_decode_paged(
        q, kp, vp, bt, pos, kv_len=cut * ps - 3, impl="cuda"),
        "paged decode: ops.flash_decode_paged")
    # Dh = 256 and 64 packed rows, pages of 16, in bf16 and fp32
    for b, h, hkv, dh, sqs in WIDE_DECODE_SHAPES:
        skv, ps = 1000, 16
        for dtype in (torch.bfloat16, torch.float32):
            kd = torch.randn(b, skv, hkv, dh, generator=gen,
                             device="cuda").to(dtype)
            vd = torch.randn(b, skv, hkv, dh, generator=gen,
                             device="cuda").to(dtype)
            kp, vp, table = _paged_pools(torch, kd, vd, ps, gen)
            for sq in sqs:
                pos = torch.linspace(0, skv - sq, b,
                                     device="cuda").round().int()
                q = torch.randn(b, sq, h, dh, generator=gen,
                                device="cuda").to(dtype)
                for window in (None, 256):
                    bound, split_len, n = D.paged_split_plan(
                        b, hkv, ps, table.shape[1], None)
                    kw = dict(window=window, split_len=split_len,
                              n_splits=n, bound=bound)
                    got = D.combine_splits(*D.decode_paged_partials(
                        q, kp, vp, table, pos, impl="cuda", **kw))
                    want = D.combine_splits(*D.decode_paged_partials(
                        q, kp, vp, table, pos, impl="ref", **kw))
                    err = (got - want).abs().max().item()
                    what = (f"H={h} Hkv={hkv} Dh={dh} {dtype} sq={sq} "
                            f"window={window}")
                    check(err <= DECODE_TOL, f"paged decode: max err "
                          f"{err:.3g} > {DECODE_TOL} at {what}")
                    worst_fin = max(worst_fin, check_finished(
                        torch, D, lambda: D.decode_paged_finished(
                            q, kp, vp, table, pos, impl="cuda", **kw), want,
                        f"paged decode {what}"))
                    worst = max(worst, err)
                    cases += 1
    # the attention family's shapes, pages of 16, against the plain
    # version and against the dense kernel on the same logical cache
    for b, h, hkv, dh, skv, window in FAMILY_DECODE_SHAPES:
        ps = 16
        kd = torch.randn(b, skv, hkv, dh, generator=gen,
                         device="cuda").bfloat16()
        vd = torch.randn(b, skv, hkv, dh, generator=gen,
                         device="cuda").bfloat16()
        kp, vp, table = _paged_pools(torch, kd, vd, ps, gen)
        pos = torch.linspace(0, skv - 1, b, device="cuda").round().int()
        q = torch.randn(b, 1, h, dh, generator=gen, device="cuda").bfloat16()
        what = f"family H={h} Hkv={hkv} Dh={dh} sq=1 window={window}"
        for ns in (1, None):
            bound, split_len, n = D.paged_split_plan(b, hkv, ps,
                                                     table.shape[1], ns)
            kw = dict(window=window, split_len=split_len, n_splits=n,
                      bound=bound)
            got = D.combine_splits(*D.decode_paged_partials(
                q, kp, vp, table, pos, impl="cuda", **kw))
            want = D.combine_splits(*D.decode_paged_partials(
                q, kp, vp, table, pos, impl="ref", **kw))
            err = (got - want).abs().max().item()
            check(err <= DECODE_TOL, f"paged decode: max err {err:.3g} > "
                  f"{DECODE_TOL} at {what} n_splits={n}")
            worst_fin = max(worst_fin, check_finished(
                torch, D, lambda: D.decode_paged_finished(
                    q, kp, vp, table, pos, impl="cuda", **kw), want,
                f"paged decode {what} n_splits={n}"))
            worst = max(worst, err)
            cases += 1
        b_, sl, nd = D.split_plan(b, hkv, skv, 128, None, None)
        dense = D.combine_splits(*D.decode_partials(
            q, kd, vd, pos, window=window, split_len=sl, n_splits=nd,
            bound=b_, impl="cuda"))
        err = (got - dense).abs().max().item()
        check(err <= DECODE_TOL, f"paged decode vs dense kernel: {err:.3g} "
              f"> {DECODE_TOL} at {what}")
        worst_dense = max(worst_dense, err)
    print(f"paged decode kernel: {cases} cases vs plain version (pages 8, "
          f"16, 256; permuted tables, dead columns on a NaN scratch page; "
          f"Sq 1/4; window none/256; one/default splits; a kv_len cut; "
          f"Dh=256 and G*Sq=64 in bf16 and fp32; in bf16 G=7, G=1 at "
          f"Dh=64 and a 1024-row window over 2048 rows at Dh=256), max "
          f"abs err {worst:.3g}; vs the dense kernel on the same logical "
          f"cache {worst_dense:.3g} (tol {DECODE_TOL}, partials merged in "
          f"fp32); finished output {worst_fin:.3g} (fp32 within "
          f"{DECODE_TOL}, bf16 within one ulp + {DECODE_TOL}; counters 0 "
          f"after every call, repeats bit-identical)")
    return worst_fin


# --- phase 3b: flash attention kernel --------------------------------------

def phase_flash(torch, ops, R) -> float:
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for s in (512, 2048, 509):
        q = torch.randn(1, H, s, DH, generator=gen, device="cuda")
        k = torch.randn(1, HKV, s, DH, generator=gen, device="cuda")
        v = torch.randn(1, HKV, s, DH, generator=gen, device="cuda")
        for window in (None, 256):
            want = R.attention(q, k, v, window=window)
            got = ops.flash_attention(q, k, v, window=window, impl="cuda")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= FLASH_F32_TOL, f"flash: fp32 err {err:.3g} > "
                  f"{FLASH_F32_TOL} at S={s} window={window}")
            worst = max(worst, err)
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            want = R.attention(qb.float(), kb.float(), vb.float(),
                               window=window)
            got = ops.flash_attention(qb, kb, vb, window=window,
                                      impl="cuda").float()
            err = (got - want).abs().max().item()
            check(err <= BF16_OUT_TOL, f"flash: bf16 err {err:.3g} > "
                  f"{BF16_OUT_TOL} at S={s} window={window}")
    # gemma3-4b's heads: 8 over 4 KV heads, Dh = 256
    for s in (509, 2048):
        q = torch.randn(1, 8, s, 256, generator=gen, device="cuda")
        k = torch.randn(1, 4, s, 256, generator=gen, device="cuda")
        v = torch.randn(1, 4, s, 256, generator=gen, device="cuda")
        for window in (None, 256):
            want = R.attention(q, k, v, window=window)
            got = ops.flash_attention(q, k, v, window=window, impl="cuda")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= FLASH_F32_TOL, f"flash: fp32 err {err:.3g} > "
                  f"{FLASH_F32_TOL} at Dh=256 S={s} window={window}")
            worst = max(worst, err)
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            want = R.attention(qb.float(), kb.float(), vb.float(),
                               window=window)
            got = ops.flash_attention(qb, kb, vb, window=window,
                                      impl="cuda").float()
            err = (got - want).abs().max().item()
            check(err <= BF16_OUT_TOL, f"flash: bf16 err {err:.3g} > "
                  f"{BF16_OUT_TOL} at Dh=256 S={s} window={window}")
    print(f"flash attention kernel: S 512/2048/509, causal and window 256, "
          f"B=1 H={H} Hkv={HKV} Dh={DH}, and S 509/2048 at H=8 Hkv=4 "
          f"Dh=256: fp32 max abs err {worst:.3g} (tol "
          f"{FLASH_F32_TOL}); bf16 within {BF16_OUT_TOL} of the fp32 plain "
          f"result")
    return worst


# --- phase 5b: prefill attention through the flash entry point -------------

def phase_prefill_attention(torch, np, cfg, M, L, K, ops, R, params) -> dict:
    """Layer 0's queries, keys and values of a 2048-token prompt on the
    full-width model, in the model's (B, S, H, Dh) layout, through
    ``ops.flash_attention_bshd``: the kernel's own entry point (the
    model's prefill keeps ``chunked_causal_attention``, as the
    reference's does). Launch counts are zeroed before and read after."""
    s = 2048
    toks = torch.tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (1, s)), device="cuda")
    p = {n: t[0] for n, t in params["scan"]["0"].items()
         if not isinstance(t, dict)}
    mix = {n: t[0] for n, t in params["scan"]["0"]["mixer"].items()}
    x = L.rms_norm(params["tok_embed"][toks], p["ln1"], cfg.norm_eps)
    rope = L.rope_tables(torch.arange(s, device="cuda")[None],
                         cfg.head_dim_eff, cfg.rope_theta)
    q = L.rotate(M._project(x, mix["wq"]), *rope)
    k = L.rotate(M._project(x, mix["wk"]), *rope)
    v = M._project(x, mix["wv"])
    K.reset_launches()
    out = ops.flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches["flash_attention"] == 1, f"prefill attention: "
          f"flash_attention launched {launches['flash_attention']} times")
    check(tuple(out.shape) == tuple(q.shape) and out.dtype == q.dtype
          and bool(torch.isfinite(out).all()),
          "prefill attention: bad output")
    want = R.attention(*(t.transpose(1, 2).float() for t in (q, k, v)))
    err = (out.transpose(1, 2).float() - want).abs().max().item()
    check(err <= BF16_OUT_TOL, f"prefill attention: err {err:.3g} > "
          f"{BF16_OUT_TOL}")
    print(f"prefill attention: yi-9b layer 0, S={s}, through "
          f"ops.flash_attention_bshd: launches {launches['flash_attention']}"
          f", max abs err {err:.3g} vs fp32 plain (tol {BF16_OUT_TOL})")
    return launches


# --- phase 5c: full-width paged serving -------------------------------------

def serve_schedule(eng, reqs, *, fork: bool, cancel_after: int,
                   on_round=None) -> dict:
    """Serve ``reqs``: all but one slot admitted, one chunk, then (paged
    engines, ``fork``) the first request forked into the free slot;
    admissions as slots free; ``reqs[1]`` cancelled after
    ``cancel_after`` more dispatches. Returns {rid: token list}, the
    cancelled stream included. ``on_round(eng)`` runs after every
    admission round and dispatch."""
    pending = list(reqs)
    out = {}
    for _ in range(eng.max_slots - 1):
        eng.admit(pending.pop(0))
    if on_round:
        on_round(eng)
    out.update((r, t.tolist()) for r, t in eng.step())
    if fork:
        eng.fork(reqs[0].rid, f"{reqs[0].rid}-fork")
    rounds = 0
    while pending or any(s is not None for s in eng.slots):
        for slot in eng.free_slots():
            if pending:
                eng.admit(pending.pop(0), slot)
        if on_round:
            on_round(eng)
        out.update((r, t.tolist()) for r, t in eng.step())
        if on_round:
            on_round(eng)
        rounds += 1
        if rounds == cancel_after:
            got = eng.cancel(reqs[1].rid)
            check(got is not None, "serve: the request to cancel retired")
            out[reqs[1].rid] = got.tolist()
    return out


def paged_requests(np, serve, vocab: int, n: int, seed: int, system: int,
                   suffix: int, new: int) -> list:
    """``n`` requests sharing a ``system``-token prefix, each with its own
    0..``suffix``-token tail and ``new`` tokens to generate."""
    rng = np.random.default_rng(seed)
    prefix = tuple(int(t) for t in rng.integers(0, vocab, system))
    return [serve.Request(f"p{i}", prefix + tuple(
        int(t) for t in rng.integers(0, vocab, m)), new)
        for i, m in enumerate(rng.integers(0, suffix + 1, n))]


def phase_paged_engine(torch, np, cfg_mod, M, K, serve, PG, params,
                       dense_st):
    cfg = cfg_mod.get_config("yi-9b")
    n_pages, ps = 320, 16
    reqs = paged_requests(np, serve, cfg.vocab_size, 16, 5, 256, 256, 64)
    eng = serve.PagedServeEngine(cfg, params, page_size=ps, n_pages=n_pages,
                                 max_slots=8, max_len=2048, chunk=8,
                                 device="cuda")
    capture_graphs(torch, eng, "paged engine")
    peak = [0]

    def held(e):
        peak[0] = max(peak[0], sum(1 for rc in e.pool.refcount if rc))
        e.check_pool()

    K.reset_launches()
    t0 = time.perf_counter()
    res = serve_schedule(eng, reqs, fork=True, cancel_after=4,
                         on_round=held)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st, pool = eng.stats(), dict(eng.pool.stats)
    steps = st["decode_tokens"]
    eng.check_pool()
    done = [r for r in res if r != reqs[1].rid]
    check(len(res) == 17 and all(len(res[r]) == 64 for r in done)
          and len(res[reqs[1].rid]) < 64,
          "paged engine: not every request got its tokens")
    check(all(0 <= min(t) and max(t) < cfg.vocab_size for t in res.values()),
          "paged engine: token id out of vocab")
    check(res[reqs[0].rid] == res[f"{reqs[0].rid}-fork"],
          "paged engine: the greedy fork diverged from its parent")
    check(launches["flash_decode_paged"] == launches["kv_rows_in_decode"]
          == cfg.n_layers * steps > 0
          and launches["flash_decode"] == 0
          and launches["kv_row_update"] == 0,
          f"paged engine: launches {launches}, expected flash_decode_paged "
          f"and kv_rows_in_decode {cfg.n_layers} x {steps} and no dense "
          f"kernel or standalone writer")
    check(pool["shared_maps"] > 0 and pool["cow_copies"] >= 1
          and pool["recycled_allocs"] > 0,
          f"paged engine: pool stats {pool}")
    check(st["quarantined"] == 0, "paged engine: non-finite logits")
    check(len(eng.graphs.graphs) == 16,
          "paged engine: a dispatch captured a graph")
    n_tok = sum(len(v) for v in res.values())
    page_bytes = PG.paged_kv_bytes(cfg, 1, ps)
    print(f"paged engine: yi-9b, page {ps}, {n_pages} + 1 pages "
          f"({PG.paged_kv_bytes(cfg, n_pages + 1, ps) / 2**20:.1f} MiB pool "
          f"vs {PG.dense_kv_bytes(cfg, 8, 2048) / 2**20:.1f} MiB dense 8 x "
          f"2048 cache); 16 requests of a shared 256-token prefix + 0-256 "
          f"tokens, 64 new each, one forked after its first chunk, one "
          f"cancelled")
    print(f"paged engine: peak pages held {peak[0]} = "
          f"{peak[0] * page_bytes / 2**20:.1f} MiB (dense_kv_bytes "
          f"{PG.dense_kv_bytes(cfg, 8, 2048) / 2**20:.1f} MiB); pool stats "
          f"{pool}; gather_pages {eng.gather_pages}")
    print(f"paged engine: {n_tok} tokens in {wall:.2f} s = "
          f"{n_tok / wall:.1f} tok/s; prefill {st['prefill_s']:.2f} s "
          f"({st['prefill_dispatches']} dispatches), decode "
          f"{st['decode_s']:.2f} s ({st['decode_dispatches']} dispatches, "
          f"{steps} steps, {st['decode_s'] / steps * 1e3:.2f} ms/step) vs "
          f"dense {dense_st['decode_s'] / dense_st['decode_tokens'] * 1e3:.2f}"
          f" ms/step")
    print(f"paged engine: launches {launches} (expected flash_decode_paged "
          f"== kv_rows_in_decode == {cfg.n_layers} x {steps} = "
          f"{cfg.n_layers * steps})")
    print_step_launches("paged engine", launches, steps)
    rel, agree, _ = _paged_vs_dense_logits(torch, cfg, M, PG, params,
                                        [r.prompt for r in reqs[:8]])
    print(f"paged engine: one decode step, paged kernel vs dense kernel on "
          f"the same prompts, max |diff| / max |logit| {rel:.4g} (greedy "
          f"argmax agreement {agree:.3f}); tol {LOGITS_REL_TOL}")
    check(rel <= LOGITS_REL_TOL, f"paged engine: paged vs dense logits "
          f"{rel:.3g} > {LOGITS_REL_TOL}")
    _small_paged_check(torch, np, cfg_mod, M, serve)
    return eng, launches


def _paged_vs_dense_logits(torch, cfg, M, PG, params, prompts) -> tuple:
    """The prompts prefilled into a dense 8 x 2048 cache and into page
    pools under a shuffled table (recurrent leaves in their slot rows),
    then one decode step through each layout's kernels. Returns
    :func:`logits_rel`'s reading."""
    from repro_torch.serve.slots import insert
    from repro_torch.train.serve import make_prefill_step
    ps = 16
    nb = 2048 // ps
    dense = M.init_cache(cfg, 8, 2048, "cuda")
    pools = PG.init_paged_cache(cfg, 8, 8 * nb + 1, ps, "cuda")
    perm = torch.randperm(8 * nb, generator=torch.Generator().manual_seed(12))
    bt = perm.reshape(8, nb).int().cuda()
    pre_dense = make_prefill_step(cfg, cache_len=2048)
    pre_exact = make_prefill_step(cfg, cache_len=None)
    toks = []
    for i, p in enumerate(prompts):
        t = torch.tensor([p], dtype=torch.int64, device="cuda")
        lg, one = pre_dense(params, {"tokens": t})
        insert(dense, one, i)
        _, one = pre_exact(params, {"tokens": t})
        npg = -(-len(p) // ps)
        PG.paged_insert(cfg, pools, one, i, bt[i, :npg].long(),
                        torch.arange(npg, device="cuda"))
        toks.append(int(lg[0, -1].argmax()))
    del one
    tok = torch.tensor(toks, dtype=torch.int64, device="cuda")[:, None]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    kv_len = int(pos.max()) + 1
    with RouteLog() as rd:
        ld, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=dense, pos=pos, kv_len=kv_len)
    with RouteLog() as rp:
        lp, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=pools, pos=pos, kv_len=kv_len,
                             block_tables=bt)
    return logits_rel(torch, lp, ld, routed_alike(torch, rp, rd, 8),
                      f"{cfg.name} paged")


def _small_paged_check(torch, np, cfg_mod, M, serve) -> None:
    """Smoke-size fp32 paged engine on the card: greedy streams equal to
    the paged engine on the CPU (fork and cancel on the way) and to the
    dense engine on the card (the same schedule without the fork)."""
    cfg = dataclasses.replace(cfg_mod.get_smoke_config("yi-9b"),
                              param_dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    reqs = paged_requests(np, serve, cfg.vocab_size, 6, 7, 8, 12, 12)
    kw = dict(max_slots=3, max_len=40, chunk=3)

    def paged(dev, fork):
        eng = serve.PagedServeEngine(cfg, _to(params, dev), page_size=4,
                                     device=dev, **kw)
        out = serve_schedule(eng, reqs, fork=fork, cancel_after=2)
        eng.check_pool()
        check(eng.pool.stats["shared_maps"] > 0,
              "paged engine: smoke run shared no prefix")
        return out

    card = paged("cuda", True)
    check(card == paged("cpu", True),
          "paged engine: smoke fp32 streams differ card vs CPU")
    dense = serve_schedule(serve.ServeEngine(cfg, _to(params, "cuda"),
                                             device="cuda", **kw),
                           reqs, fork=False, cancel_after=2)
    check(paged("cuda", False) == dense,
          "paged engine: smoke fp32 paged streams differ from dense")
    print("paged engine: smoke-size fp32 greedy streams identical on the "
          "card and the CPU (6 requests sharing a prefix, 3 slots, chunk 3, "
          "a fork and a cancel) and paged == dense on the card")


def phase_graph_parity(torch, np, serve, cfg, params) -> None:
    """The graphed chunk against the eager one at full width: the same
    requests through an engine with ``cuda_graphs=False`` and one with
    the graphs, which compute the same ``kv_len`` buckets, dense and
    paged, greedy and sampled. The paged schedule forks a request after
    the first chunk and both cancel one (``serve_schedule``). The token
    streams must be identical, byte for byte as int32."""
    rng = np.random.default_rng(9)
    reqs = {False: [serve.Request(f"g{i}", tuple(
        int(t) for t in rng.integers(0, cfg.vocab_size, n)), PARITY_NEW)
        for i, n in enumerate(rng.integers(128, 513, size=8))],
        True: paged_requests(np, serve, cfg.vocab_size, 8, 9, 256, 256,
                             PARITY_NEW)}
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        for temperature in (0.0, PARITY_TEMPERATURE):
            out, buckets = {}, None
            for graphs in (False, True):
                kw = dict(max_slots=8, max_len=2048, chunk=8,
                          temperature=temperature, device="cuda",
                          cuda_graphs=graphs)
                eng = serve.PagedServeEngine(cfg, params, page_size=16,
                                             n_pages=320, **kw) \
                    if paged else serve.ServeEngine(cfg, params, **kw)
                got = serve_schedule(eng, reqs[paged], fork=paged,
                                     cancel_after=1)
                out[graphs] = {r: np.asarray(t, np.int32).tobytes()
                               for r, t in got.items()}
                if graphs:
                    buckets = sorted(eng.graphs.graphs)
                del eng
                torch.cuda.empty_cache()
            n_tok = sum(len(t) for t in out[False].values()) // 4
            differ = [r for r, t in out[False].items()
                      if out[True].get(r) != t]
            check(not differ and out[True].keys() == out[False].keys(),
                  f"parity: {kind} T={temperature}: graphed streams differ "
                  f"from eager: {differ}")
            print(f"parity: {kind} T={temperature}: {len(out[True])} streams"
                  f" ({n_tok} tokens{', a fork' if paged else ''} and a "
                  f"cancel) byte-identical, graphed vs eager, kv_len "
                  f"buckets {buckets}")


# --- phases 5e-5g: the attention family at full width ----------------------

#: gemma3-4b's served requests: prompt lengths (past its 1024-row window,
#: so that its 29 local layers mask at decode) and new tokens a request,
#: as [low, high) ranges
GEMMA_PROMPT_LENS = (1100, 1901)
GEMMA_NEW = (32, 65)
#: graphed against eager: requests and new tokens each
GEMMA_PARITY = (4, 16)
#: phase 5g: the configs held at full width through ``forward``, the
#: decode steps each takes, its slots and horizon, and its prompt lengths
FAMILY_FORWARD = ("qwen2-vl-7b", "minitron-8b", "musicgen-large")
FAMILY_STEPS = 4
FAMILY_SLOTS, FAMILY_HORIZON = 8, 1024
FAMILY_PROMPT_LENS = (300, 901)


def kv_read_bytes(cfg, pos: int) -> int:
    """Bytes of K and V one slot's decode step at ``pos`` needs: rows
    ``0 .. pos`` of a global layer, the last ``sliding_window`` of them
    in a local one."""
    row = 2 * cfg.n_kv_heads * cfg.head_dim_eff * 2        # K and V, bf16
    return row * sum(min(pos + 1, cfg.sliding_window)
                     if blk.startswith("attn_local:") else pos + 1
                     for blk in cfg.layer_plan())


def phase_gemma_engine(torch, np, cfg_mod, M, K, serve):
    """5e: gemma3-4b at its published width and depth through the dense
    ``ServeEngine`` with its graphs captured first; then one decode step
    through the kernels against ``impl="ref"`` past the window, and
    graphed against eager streams. Returns (engine, requests)."""
    cfg = cfg_mod.get_config("gemma3-4b")
    label = "gemma3-4b engine"
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                           device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_rep, unit, n_tail = cfg.scan_split()
    n_local = sum(b.startswith("attn_local:") for b in cfg.layer_plan())
    print(f"{label}: {cfg.n_layers} layers ({n_rep} x {unit} + a tail of "
          f"{n_tail}), d_model {cfg.d_model}, H {cfg.n_heads} Hkv "
          f"{cfg.n_kv_heads} Dh {cfg.head_dim_eff}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} tied, a {cfg.sliding_window}-row window in "
          f"{n_local} layers; {n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(22)
    lens = rng.integers(*GEMMA_PROMPT_LENS, size=16)
    news = rng.integers(*GEMMA_NEW, size=16)
    reqs = [serve.Request(f"m{i}", tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, n)), int(m)) for i, (n, m) in
        enumerate(zip(lens, news))]
    eng, launches = serve_dense(torch, K, serve, cfg, params, reqs, label)
    st = eng.stats()
    steps = st["decode_tokens"]
    ms_step = st["decode_s"] / steps * 1e3
    w_bytes = n_params * 2
    kv_bytes = sum(kv_read_bytes(cfg, p) for r in reqs for p in range(
        len(r.prompt), len(r.prompt) + r.max_new_tokens - 1)) / steps
    bound_ms = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"{label}: prompts of {lens.min()}-{lens.max()} tokens, "
          f"{news.min()}-{news.max()} new each; bound {bound_ms:.2f} "
          f"ms/step ({w_bytes / 1e9:.2f} GB of weights and "
          f"{kv_bytes / 1e9:.3f} GB of live K and V rows a step, the run's "
          f"mean, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); the step takes "
          f"{ms_step / bound_ms:.2f}x its bound")
    # one decode step through the kernels against impl="ref", every slot
    # past the window
    prompts = [r.prompt for r in reqs[:8]]
    check(min(map(len, prompts)) > cfg.sliding_window,
          f"{label}: a prompt inside the window")
    rel, agree, _ = _one_step_logits(torch, cfg, M, params, prompts, label)
    print(f"{label}: one decode step at positions {min(map(len, prompts))}"
          f"-{max(map(len, prompts))} (past the {cfg.sliding_window}-row "
          f"window), kernels vs impl='ref', max |diff| / max |logit| "
          f"{rel:.4g} (greedy argmax agreement {agree:.3f}); tol "
          f"{LOGITS_REL_TOL}")
    check(rel <= LOGITS_REL_TOL, f"{label}: kernel logits vs impl='ref' "
          f"rel err {rel:.3g} > {LOGITS_REL_TOL}")
    # the graphed chunk against the eager one
    n, new = GEMMA_PARITY
    par = [serve.Request(f"q{i}", r.prompt, new)
           for i, r in enumerate(reqs[:n])]
    got = eng.run(par)
    eager = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048,
                              chunk=8, device="cuda", cuda_graphs=False)
    want_ = eager.run(par)
    del eager
    torch.cuda.empty_cache()
    same = got.keys() == want_.keys() and all(
        np.asarray(got[r], np.int32).tobytes()
        == np.asarray(want_[r], np.int32).tobytes() for r in got)
    check(same, f"{label}: graphed streams differ from eager")
    check(len(eng.graphs.graphs) == 16, f"{label}: a dispatch captured a "
          f"graph")
    print(f"{label}: parity: {n} greedy streams of {new} tokens "
          f"byte-identical, graphed vs eager")
    return eng, reqs, launches["flash_decode"]


def phase_gemma_paged(torch, M, K, PG, eng, reqs) -> None:
    """5f: one gemma3-4b decode step through ``flash_decode_paged`` (page
    16, a shuffled table) against the dense kernel, on 8 of the served
    prompts, past the window."""
    cfg = eng.cfg
    K.reset_launches()
    rel, agree, _ = _paged_vs_dense_logits(torch, cfg, M, PG, eng.params,
                                        [r.prompt for r in reqs[:8]])
    launches = dict(K.LAUNCHES)
    check(launches["flash_decode_paged"] == launches["flash_decode"]
          == cfg.n_layers and launches["kv_rows_in_decode"]
          == 2 * cfg.n_layers,
          f"gemma3-4b paged: launches {launches}, expected "
          f"{cfg.n_layers} of each decode kernel")
    print(f"gemma3-4b paged: one decode step, paged kernel (page 16) vs "
          f"dense kernel on the same 8 prompts past the window, max |diff| "
          f"/ max |logit| {rel:.4g} (greedy argmax agreement {agree:.3f}); "
          f"tol {LOGITS_REL_TOL}; launches flash_decode_paged "
          f"{launches['flash_decode_paged']}, flash_decode "
          f"{launches['flash_decode']}")
    check(rel <= LOGITS_REL_TOL, f"gemma3-4b paged: paged vs dense logits "
          f"{rel:.3g} > {LOGITS_REL_TOL}")


def family_batch(torch, np, cfg, rng, b: int, s: int,
                 positions: bool = False) -> dict:
    """A forward's inputs on the card: token ids, or unit-normal
    embeddings for a model without a token embedding; with
    ``positions``, an M-RoPE model's distinct (3, B, S) temporal, height
    and width ids (a 16-wide grid)."""
    if cfg.embed_inputs:
        batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                     (b, s)), device="cuda")}
    else:
        batch = {"embeds": torch.tensor(rng.standard_normal(
            (b, s, cfg.d_model)), dtype=torch.float32, device="cuda")}
    if positions and cfg.rope_kind == "mrope":
        t = np.arange(s)
        grid = np.stack([t, t // 16, t % 16])
        batch["positions"] = torch.tensor(
            np.broadcast_to(grid[:, None], (3, b, s)).copy(),
            dtype=torch.int32, device="cuda")
    return batch


def phase_family_forward(torch, np, cfg_mod, M, K) -> None:
    """5g: qwen2-vl-7b, minitron-8b and musicgen-large at full width and
    depth: 8 slots prefilled one by one (qwen2-vl with distinct 3-D
    positions, musicgen from random embeddings), then ``FAMILY_STEPS``
    decode steps through the kernels (``impl="auto"``) and through their
    plain versions (``impl="ref"``) on a copy of the cache, on the same
    inputs; logits held as in phase 5. Returns the decode launches by
    config."""
    from repro_torch.serve.slots import insert
    out = {}
    for i, arch in enumerate(FAMILY_FORWARD):
        cfg = cfg_mod.get_config(arch)
        t0 = time.perf_counter()
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(30 + i), "cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        rng = np.random.default_rng(40 + i)
        lens = rng.integers(*FAMILY_PROMPT_LENS, size=FAMILY_SLOTS)
        cache = M.init_cache(cfg, FAMILY_SLOTS, FAMILY_HORIZON, "cuda")
        for slot, n in enumerate(lens):
            _, _, one = M.forward(cfg, params, family_batch(
                torch, np, cfg, rng, 1, int(n), positions=True),
                mode="prefill", cache_len=FAMILY_HORIZON)
            insert(cache, one, slot)
        del one
        ref = _clone(cache)
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        K.reset_launches()
        worst, agree = 0.0, []
        for _ in range(FAMILY_STEPS):
            batch = family_batch(torch, np, cfg, rng, FAMILY_SLOTS, 1)
            kv_len = int(pos.max()) + 1
            lk = M.forward(cfg, params, batch, mode="decode", cache=cache,
                           pos=pos, impl="auto", kv_len=kv_len)[0].float()
            lr = M.forward(cfg, params, batch, mode="decode", cache=ref,
                           pos=pos, impl="ref", kv_len=kv_len)[0].float()
            check(bool(torch.isfinite(lk).all()), f"{arch}: non-finite "
                  f"logits")
            worst = max(worst, ((lk - lr).abs().max()
                                / lr.abs().max()).item())
            agree.append((lk.argmax(-1) == lr.argmax(-1)).float().mean())
            pos = pos + 1
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        want = cfg.n_layers * FAMILY_STEPS
        check(launches["flash_decode"] == launches["kv_rows_in_decode"]
              == want, f"{arch}: launches {launches}, expected flash_decode "
              f"{want}")
        g = cfg.n_heads // cfg.n_kv_heads
        inputs = "token ids" if cfg.embed_inputs else "embeddings"
        print(f"family: {arch} at full width and depth ({cfg.n_layers} "
              f"layers, d_model {cfg.d_model}, H {cfg.n_heads} Hkv "
              f"{cfg.n_kv_heads} (G={g}) Dh {cfg.head_dim_eff}, ffn "
              f"{cfg.ffn_act}, rope {cfg.rope_kind}, qkv_bias "
              f"{cfg.qkv_bias}, {inputs}"
              f"; {n_params / 1e9:.3f} B params bf16): {FAMILY_SLOTS} slots "
              f"prefilled at {lens.min()}-{lens.max()} tokens, "
              f"{FAMILY_STEPS} decode steps, kernels vs impl='ref' max "
              f"|diff| / max |logit| {worst:.4g} (greedy argmax agreement "
              f"{float(sum(agree) / len(agree)):.3f}); tol {LOGITS_REL_TOL}; "
              f"flash_decode launches {launches['flash_decode']}; "
              f"{time.perf_counter() - t0:.1f} s")
        check(worst <= LOGITS_REL_TOL, f"{arch}: kernel logits vs "
              f"impl='ref' rel err {worst:.3g} > {LOGITS_REL_TOL}")
        out[arch] = launches["flash_decode"]
        del params, cache, ref
        torch.cuda.empty_cache()
    return out


# --- phases 5h-5k: the recurrent and MoE families ---------------------------

#: seed of the weights and requests of phases 5h-5k
FAMILY2_SEED = 23
#: xlstm-125m's served requests: prompt lengths as [low, high) and new
#: tokens a request; the decode step held against a prefill (1, as
#: ``tests/test_recurrent.py::test_mamba_decode_matches_prefill_tail``)
#: and the one printed beside it; the prompt of the sensitivity probe
XLSTM_PROMPT_LENS, XLSTM_NEW = (128, 513), 64
XLSTM_HELD_STEP, XLSTM_SHOWN_STEP = 1, 8
XLSTM_PROBE_LEN = 64
#: prompt tokens of the xlstm-125m trace phase: its step reads a state of
#: fixed size, whatever the position
XLSTM_TRACE_PROMPT = 128
#: jamba: one period of its block pattern (7 Mamba, 1 attention, 4 MoE)
JAMBA_LAYERS = 8
JAMBA_PROMPT_LENS, JAMBA_NEW = (256, 1025), 32
#: phase 5k: the MoE configs held at one layer through ``forward``
MOE_FORWARD = ("grok-1-314b", "qwen3-moe-235b-a22b")
MOE_LAYERS = 1


def path_launches(row: dict, paths: dict) -> None:
    """Set a kernel row's ``launches`` to the sum over the main paths that
    launch it, each counted from 0 just before its run and read just
    after, and keep them by path."""
    row["launches_by_path"] = paths
    row["launches"] = sum(paths.values())


def recurrent_bytes(M, cache) -> int:
    """Bytes of a cache's recurrent leaves (all but K and V): what a
    decode step reads and writes again."""
    return sum(t.numel() * t.element_size() for path, t in M._walk(cache)
               if path[-1] not in ("k", "v"))


def family2_requests(np, serve, cfg, lens_range, new, tag) -> list:
    rng = np.random.default_rng(FAMILY2_SEED)
    lens = rng.integers(*lens_range, size=16)
    return [serve.Request(f"{tag}{i}", tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, n)), new) for i, n in enumerate(lens)]


def family2_params(torch, M, cfg, label: str):
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(FAMILY2_SEED),
        device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"{label}: {cfg.n_layers} layers {'/'.join(sorted(set(cfg.layer_plan())))}, "
          f"d_model {cfg.d_model}, H {cfg.n_heads} Hkv {cfg.n_kv_heads}, "
          f"vocab {cfg.vocab_size}; {n / 1e9:.3f} B params "
          f"({w_bytes / 1e9:.2f} GB), init {time.perf_counter() - t0:.1f} s")
    return params, w_bytes


def step_bound(label: str, eng, reqs, w_bytes: int, M, ms_step: float,
               kv_row_bytes: int = 0) -> float:
    """Print and return a decode step's bound: the weights read once, the
    recurrent state read and written, and the live K and V rows (the
    run's mean), over the HBM rate."""
    steps = eng.stats()["decode_tokens"]
    state = 2 * recurrent_bytes(M, eng.cache)
    kv = kv_row_bytes * sum(p + 1 for r in reqs for p in range(
        len(r.prompt), len(r.prompt) + r.max_new_tokens - 1)) / steps
    bound_ms = (w_bytes + state + kv) / HBM_BYTES_PER_S * 1e3
    print(f"{label}: bound {bound_ms:.3f} ms/step ({w_bytes / 1e9:.3f} GB "
          f"of weights, {state / 1e6:.1f} MB of recurrent state read and "
          f"written, {kv / 1e6:.1f} MB of live K and V rows a step, the "
          f"run's mean, at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); the step "
          f"takes {ms_step:.3f} ms, {ms_step / bound_ms:.2f}x its bound")
    return bound_ms


def graphs_vs_eager(torch, np, serve, eng, reqs, label: str, n: int = 4,
                    new: int = 16) -> None:
    """``n`` requests of ``new`` tokens through the graphed engine and
    through an eager one on the same weights: byte-identical streams."""
    par = [serve.Request(f"q{i}", r.prompt, new)
           for i, r in enumerate(reqs[:n])]
    got = eng.run(par)
    eager = serve.ServeEngine(eng.cfg, eng.params, max_slots=eng.max_slots,
                              max_len=eng.max_len, chunk=eng.chunk,
                              device="cuda", cuda_graphs=False)
    want = eager.run(par)
    del eager
    torch.cuda.empty_cache()
    same = got.keys() == want.keys() and all(
        np.asarray(got[r], np.int32).tobytes()
        == np.asarray(want[r], np.int32).tobytes() for r in got)
    check(same, f"{label}: graphed streams differ from eager")
    print(f"{label}: parity: {n} greedy streams of {new} tokens "
          f"byte-identical, graphed vs eager")


def decode_vs_prefill(torch, cfg, M, params, prompts, k: int,
                      label: str) -> float:
    """The logits of greedy decode step ``k`` (through the engine's
    forward, prompts prefilled into slots of a 2048-row cache) against a
    prefill of each prompt and the ``k`` tokens decoded: the recurrent
    state carried step by step against the chunkwise prefill. Returns
    max |diff| / max |logit|."""
    from repro_torch.serve.slots import insert
    from repro_torch.train.serve import make_prefill_step
    prefill = make_prefill_step(cfg, cache_len=2048)
    cache = M.init_cache(cfg, len(prompts), 2048, "cuda")
    first = []
    for i, p in enumerate(prompts):
        lg, one = prefill(params, {"tokens": torch.tensor(
            [p], dtype=torch.int64, device="cuda")})
        insert(cache, one, i)
        first.append(int(lg[0, -1].argmax()))
    del one
    tok = torch.tensor(first, dtype=torch.int64, device="cuda")[:, None]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    fed = [tok]
    for step in range(k):
        lk, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=cache, pos=pos, kv_len=2048)
        if step < k - 1:
            tok = lk[:, 0].argmax(-1)[:, None]
            fed.append(tok)
            pos = pos + 1
    fed = torch.cat(fed, dim=1).tolist()
    want = torch.cat([prefill(params, {"tokens": torch.tensor(
        [tuple(p) + tuple(f)], dtype=torch.int64, device="cuda")})[0]
        for p, f in zip(prompts, fed)]).float()
    lk = lk.float()
    check(bool(torch.isfinite(lk).all()), f"{label}: non-finite logits")
    return ((lk - want).abs().max() / want.abs().max()).item()


def embedding_sensitivity(torch, cfg, M, params, prompt) -> float:
    """max |change| / max |logit| of a prompt's last logits when one
    element of its first token's embedding moves by one bf16 ulp."""
    tok = torch.tensor([prompt], dtype=torch.int64, device="cuda")
    base = M.forward(cfg, params, {"tokens": tok})[0].float()
    emb = params["tok_embed"].clone()
    emb.view(torch.int16)[prompt[0], 0] += 1
    moved = M.forward(cfg, dict(params, tok_embed=emb),
                      {"tokens": tok})[0].float()
    return ((moved - base).abs().max() / base.abs().max()).item()


def phase_xlstm_engine(torch, np, cfg_mod, M, K, serve):
    """5h: xlstm-125m at its published width and depth through the dense
    engine (one graph: it reads no KV rows); decode against prefill;
    graphed against eager. Returns (engine, requests)."""
    cfg = cfg_mod.get_config("xlstm-125m")
    label = "xlstm-125m engine"
    params, w_bytes = family2_params(torch, M, cfg, label)
    reqs = family2_requests(np, serve, cfg, XLSTM_PROMPT_LENS, XLSTM_NEW, "x")
    eng, _ = serve_dense(torch, K, serve, cfg, params, reqs, label)
    st = eng.stats()
    step_bound(label, eng, reqs, w_bytes, M,
               st["decode_s"] / st["decode_tokens"] * 1e3)
    t0 = time.perf_counter()
    prompts = [r.prompt for r in reqs[:4]]
    rel = decode_vs_prefill(torch, cfg, M, params, prompts, XLSTM_HELD_STEP,
                            label)
    shown = decode_vs_prefill(torch, cfg, M, params, prompts[:2],
                              XLSTM_SHOWN_STEP, label)
    probe = embedding_sensitivity(torch, cfg, M, params, reqs[0].prompt[
        :XLSTM_PROBE_LEN])
    print(f"{label}: logits of decode step {XLSTM_HELD_STEP} (4 slots) vs "
          f"a prefill of the prompt and the token decoded, max |diff| / max "
          f"|logit| {rel:.4g}; tol {LOGITS_REL_TOL}. Not held: at decode step "
          f"{XLSTM_SHOWN_STEP} (2 slots) {shown:.4g}; one bf16 ulp of one "
          f"element of its first token's embedding moves a "
          f"{XLSTM_PROBE_LEN}-token prompt's logits by {probe:.4g} of their "
          f"largest (the sLSTM "
          f"recurrence at this init, r of std 1/sqrt(H) over Dh = "
          f"{cfg.d_model // cfg.n_heads}, amplifies a rounding difference "
          f"step by step) ({time.perf_counter() - t0:.1f} s)")
    check(rel <= LOGITS_REL_TOL, f"{label}: decode vs prefill logits "
          f"{rel:.3g} > {LOGITS_REL_TOL}")
    graphs_vs_eager(torch, np, serve, eng, reqs, label)
    return eng, reqs


def phase_xlstm_paged(torch, M, serve, eng, reqs) -> None:
    """5i: one xlstm-125m ``PagedServeEngine`` round: 7 requests, the
    first forked after its first chunk (its recurrent rows copied into
    the clone's slot on the card), the clone's greedy stream equal to its
    parent's."""
    from repro_torch.serve.slots import SLOT_AXIS
    cfg, label = eng.cfg, "xlstm-125m paged"
    peng = serve.PagedServeEngine(cfg, eng.params, page_size=16, max_slots=8,
                                  max_len=2048, chunk=8, device="cuda")
    capture_graphs(torch, peng, label)
    par = [serve.Request(f"f{i}", r.prompt, 24) for i, r in
           enumerate(reqs[:7])]
    for r in par:
        peng.admit(r)
    out = dict(peng.step())
    src = next(i for i, s in enumerate(peng.slots)
               if s is not None and s.rid == "f0")
    dst = peng.fork("f0", "f0-fork")
    rows = [(t.select(SLOT_AXIS[path[0]], src),
             t.select(SLOT_AXIS[path[0]], dst))
            for path, t in M._walk(peng.cache)]
    check(all(torch.equal(a, b) for a, b in rows), f"{label}: the clone's "
          f"recurrent rows differ from its parent's")
    t0 = time.perf_counter()
    while any(s is not None for s in peng.slots):
        out.update(peng.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(out["f0"].tolist() == out["f0-fork"].tolist(),
          f"{label}: the greedy fork diverged from its parent")
    check(all(len(out[r.rid]) == 24 for r in par), f"{label}: not every "
          f"request got its tokens")
    check(len(peng.graphs.graphs) == 1, f"{label}: more than one graph")
    print(f"{label}: 7 requests of 24 new tokens, one forked after its "
          f"first chunk: {len(rows)} recurrent leaves copied into the "
          f"clone's slot on the card (rows equal), the clone's stream equal "
          f"to its parent's; {peng.stats()['decode_tokens']} steps, the "
          f"rest decoded in {wall:.2f} s")
    del peng
    torch.cuda.empty_cache()


def phase_jamba(torch, np, cfg_mod, M, K, serve, PG):
    """5j: one jamba period at full width through the dense engine (its
    graphs captured first), its step against its bound, one step's
    kernel logits against ``impl="ref"``, graphed against eager; then a
    paged round with a fork and one paged decode step against dense.
    Returns (dense engine, requests, launches)."""
    cfg = dataclasses.replace(cfg_mod.get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_LAYERS)
    label = "jamba engine"
    params, w_bytes = family2_params(torch, M, cfg, label)
    reqs = family2_requests(np, serve, cfg, JAMBA_PROMPT_LENS, JAMBA_NEW,
                            "j")
    eng, launches = serve_dense(torch, K, serve, cfg, params, reqs, label)
    st = eng.stats()
    row = 2 * cfg.n_kv_heads * cfg.head_dim_eff * 2 * attention_layers(cfg)
    step_bound(label, eng, reqs, w_bytes, M,
               st["decode_s"] / st["decode_tokens"] * 1e3, row)
    rel, agree, apart = _one_step_logits(
        torch, cfg, M, params, [r.prompt for r in reqs[:8]], label)
    print(f"{label}: one decode step, kernels vs impl='ref', max |diff| / "
          f"max |logit| {rel:.4g} over the slots routed alike (greedy argmax "
          f"agreement {agree:.3f}; {apart} of 8 slots routed apart by a "
          f"router near tie); tol {LOGITS_REL_TOL}")
    check(rel <= LOGITS_REL_TOL, f"{label}: kernel logits vs impl='ref' "
          f"rel err {rel:.3g} > {LOGITS_REL_TOL}")
    graphs_vs_eager(torch, np, serve, eng, reqs, label)

    plabel = "jamba paged"
    peng = serve.PagedServeEngine(cfg, params, page_size=16, max_slots=8,
                                  max_len=2048, chunk=8, device="cuda")
    capture_graphs(torch, peng, plabel)
    K.reset_launches()
    res = serve_schedule(peng, [serve.Request(f"p{i}", r.prompt, JAMBA_NEW)
                                for i, r in enumerate(reqs[:8])],
                         fork=True, cancel_after=1,
                         on_round=lambda e: e.check_pool())
    plaunches = dict(K.LAUNCHES)
    steps = peng.stats()["decode_tokens"]
    check(plaunches["flash_decode_paged"] == plaunches["kv_rows_in_decode"]
          == attention_layers(cfg) * steps > 0
          and plaunches["flash_decode"] == 0,
          f"{plabel}: launches {plaunches}, expected flash_decode_paged "
          f"{attention_layers(cfg)} x {steps}")
    # no clone == parent check here: MoE capacity couples the two rows
    # (of two rows sent to a full expert, the later one is dropped)
    check(all(0 <= min(t) and max(t) < cfg.vocab_size for t in res.values()),
          f"{plabel}: token id out of vocab")
    print(f"{plabel}: 8 requests of {JAMBA_NEW} new tokens, page 16, one "
          f"forked "
          f"after its first chunk, one cancelled: {len(res)} streams, "
          f"{steps} steps, launches flash_decode_paged "
          f"{plaunches['flash_decode_paged']}; pool "
          f"{dict(peng.pool.stats)}")
    del peng
    torch.cuda.empty_cache()
    rel, agree, apart = _paged_vs_dense_logits(
        torch, cfg, M, PG, params, [r.prompt for r in reqs[:8]])
    print(f"{plabel}: one decode step, paged kernel (page 16) vs dense "
          f"kernel on the same prompts, max |diff| / max |logit| {rel:.4g} "
          f"over the slots routed alike (greedy argmax agreement "
          f"{agree:.3f}; {apart} of 8 routed apart); tol {LOGITS_REL_TOL}")
    check(rel <= LOGITS_REL_TOL, f"{plabel}: paged vs dense logits "
          f"{rel:.3g} > {LOGITS_REL_TOL}")
    return eng, reqs, {"dense": launches["flash_decode"],
                       "paged": plaunches["flash_decode_paged"]}


def phase_moe_forward(torch, np, cfg_mod, M, K) -> dict:
    """5k: grok-1 and qwen3-moe at full width, one layer each: 8 slots
    prefilled, then ``FAMILY_STEPS`` decode steps through the kernels and
    through their plain versions on a copy of the cache, logits held as
    in phase 5 over the slots routed alike. Returns the decode launches
    by config."""
    from repro_torch.serve.slots import insert
    out = {}
    for i, arch in enumerate(MOE_FORWARD):
        cfg = dataclasses.replace(cfg_mod.get_config(arch),
                                  n_layers=MOE_LAYERS)
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
            FAMILY2_SEED + i), "cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        rng = np.random.default_rng(FAMILY2_SEED + i)
        lens = rng.integers(*FAMILY_PROMPT_LENS, size=FAMILY_SLOTS)
        cache = M.init_cache(cfg, FAMILY_SLOTS, FAMILY_HORIZON, "cuda")
        for slot, n in enumerate(lens):
            _, _, one = M.forward(cfg, params, family_batch(
                torch, np, cfg, rng, 1, int(n)), mode="prefill",
                cache_len=FAMILY_HORIZON)
            insert(cache, one, slot)
        del one
        ref = _clone(cache)
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        K.reset_launches()
        worst, agree, apart = 0.0, [], 0
        for _ in range(FAMILY_STEPS):
            batch = family_batch(torch, np, cfg, rng, FAMILY_SLOTS, 1)
            kv_len = int(pos.max()) + 1
            with RouteLog() as rk:
                lk = M.forward(cfg, params, batch, mode="decode", cache=cache,
                               pos=pos, impl="auto", kv_len=kv_len)[0]
            with RouteLog() as rr:
                lr = M.forward(cfg, params, batch, mode="decode", cache=ref,
                               pos=pos, impl="ref", kv_len=kv_len)[0]
            rel, ag, ap = logits_rel(torch, lk, lr, routed_alike(
                torch, rk, rr, FAMILY_SLOTS), arch)
            worst, apart = max(worst, rel), apart + ap
            agree.append(ag)
            pos = pos + 1
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        want = attention_layers(cfg) * FAMILY_STEPS
        check(launches["flash_decode"] == launches["kv_rows_in_decode"]
              == want, f"{arch}: launches {launches}, expected flash_decode "
              f"{want}")
        print(f"moe: {arch} at full width, {cfg.n_layers} layer (d_model "
              f"{cfg.d_model}, H {cfg.n_heads} Hkv {cfg.n_kv_heads} "
              f"(G={cfg.n_heads // cfg.n_kv_heads}) Dh {cfg.head_dim_eff}, "
              f"{cfg.n_experts} experts top-{cfg.experts_per_token} of "
              f"d_ff {cfg.d_ff_expert}, qk_norm {cfg.qk_norm}; "
              f"{n_params / 1e9:.3f} B params bf16): {FAMILY_SLOTS} slots "
              f"prefilled at {lens.min()}-{lens.max()} tokens, "
              f"{FAMILY_STEPS} decode steps, kernels vs impl='ref' max "
              f"|diff| / max |logit| {worst:.4g} over the slots routed alike "
              f"(greedy argmax agreement {float(sum(agree) / len(agree)):.3f};"
              f" {apart} of {FAMILY_SLOTS * FAMILY_STEPS} slot steps routed "
              f"apart); tol {LOGITS_REL_TOL}; flash_decode launches "
              f"{launches['flash_decode']}; {time.perf_counter() - t0:.1f} s")
        check(worst <= LOGITS_REL_TOL, f"{arch}: kernel logits vs "
              f"impl='ref' rel err {worst:.3g} > {LOGITS_REL_TOL}")
        out[arch] = launches["flash_decode"]
        del params, cache, ref
        torch.cuda.empty_cache()
    return out


def phase_new_timings(torch, D, ops, R, S_, peng, reqs, paged_launches,
                      paged_err, flash_launches, flash_err) -> list:
    """The paged decode kernel at page 16 and the dense timing's live rows,
    and the flash-attention kernel at yi-9b prefill shapes."""
    from repro_torch.kernels.attention import flash as FL
    F = torch.nn.functional
    pool = peng.cache["scan"]["0"]
    n_layers, n_pages, ps = pool["k"].shape[:3]
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:B]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    n_blocks = -(-kv_len // ps)
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(13))
    bt = perm[:B * n_blocks].reshape(B, n_blocks).int().cuda()
    bound, split_len, n_splits = D.paged_split_plan(B, HKV, ps, n_blocks,
                                                    None)
    gen = torch.Generator(device="cuda").manual_seed(14)
    q = torch.randn(B, 1, H, DH, generator=gen, device="cuda").bfloat16()
    kn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    vn = torch.randn(B, 1, HKV, DH, generator=gen, device="cuda").bfloat16()
    kw = dict(window=None, split_len=split_len, n_splits=n_splits,
              bound=bound)
    layer = [0]

    def next_pool():
        i = layer[0] = (layer[0] + 1) % n_layers
        return pool["k"][i], pool["v"][i]

    def kern():
        # the router's finished output: one launch
        kp, vp = next_pool()
        ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=kv_len,
                               impl="cuda")

    def fused():
        # as the decode step calls it: the step's row written first
        kp, vp = next_pool()
        ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=kv_len,
                               impl="cuda", k_new=kn, v_new=vn)

    def pair():
        # the same work as the plain index write and then the decode
        kp, vp = next_pool()
        S_.ref_paged_row_update(kp, vp, bt, kn, vn, pos)
        ops.flash_decode_paged(q, kp, vp, bt, pos, kv_len=kv_len,
                               impl="cuda")

    def partials():
        kp, vp = next_pool()
        D.decode_paged_partials(q, kp, vp, bt, pos, impl="cuda", **kw)

    def plain():
        kp, vp = next_pool()
        D.decode_paged_finished(q, kp, vp, bt, pos, impl="ref", **kw)

    ms = timed(torch, kern, 480)
    part_ms = timed(torch, partials, 480)
    fused_ms = timed(torch, fused, 480)
    pair_ms = timed(torch, pair, 96)
    plain_ms = timed(torch, plain, 48)
    # the same rows cut into 4 splits of 128 rows: B*Hkv*4 = 128 blocks,
    # one an SM (``default_splits``' count since it stopped at one wave)
    b4, sl4, n4 = D.paged_split_plan(B, HKV, ps, n_blocks, 4)
    ms4 = timed(torch, lambda: D.decode_paged_finished(
        q, *next_pool(), bt, pos, window=None, split_len=sl4, n_splits=n4,
        bound=b4, impl="cuda"), 480)
    live_b = (pos + 1).clamp(max=bound)
    live = live_b.sum().item()
    n_table = ((live_b + ps - 1) // ps).sum().item()       # entries read
    bound_ms, bound_by, n_bytes = decode_bound(B, H, HKV, DH, live, 2,
                                               n_table)
    paged_row = {
        "name": "flash_decode_paged", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode.cu",
        "replaces": "src/repro/kernels/attention/decode.py:267",
        "launches": paged_launches["flash_decode_paged"],
        "max_abs_err": paged_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "fused_write_ms": fused_ms,
        "fused_write_bound_ms": max(bound_ms, (n_bytes + 2 * 2 * B * HKV
                                               * DH * 2) / HBM_BYTES_PER_S
                                    * 1e3)}
    print(f"timing: flash_decode_paged (ops.flash_decode_paged, finished "
          f"output, one launch) at B={B} Sq=1 page={ps} kv_len={kv_len} "
          f"({n_blocks} table columns, permuted) n_splits={n_splits} "
          f"({live} live rows, {n_table} table entries): {ms * 1e3:.2f} us "
          f"= {n_bytes / ms / 1e6:.0f} GB/s ({bound_ms / ms:.3f} of the "
          f"{bound_by} bound {bound_ms * 1e3:.2f} us), plain (partials + "
          f"combine_splits + cast) {plain_ms * 1e3:.1f} us; no single "
          f"PyTorch call reads a paged cache, so no library time; the "
          f"partials alone {part_ms * 1e3:.2f} us; at {n4} splits of {sl4} "
          f"rows ({B * HKV * n4} blocks) {ms4 * 1e3:.2f} us; with the step's "
          f"row write in the same launch, as the decode step calls it, "
          f"{fused_ms * 1e3:.2f} us, against {pair_ms * 1e3:.2f} us for the "
          f"plain index write and then the decode (device time by "
          f"profiler)")

    rows = []
    for s in (512, 2048):
        q = torch.randn(1, H, s, DH, generator=gen, device="cuda").bfloat16()
        k = torch.randn(1, HKV, s, DH, generator=gen,
                        device="cuda").bfloat16()
        v = torch.randn(1, HKV, s, DH, generator=gen,
                        device="cuda").bfloat16()
        n_bytes = (2 * H + 2 * HKV) * s * DH * 2
        flops = 4 * (s * (s + 1) // 2) * H * DH
        tb = n_bytes / HBM_BYTES_PER_S * 1e3
        to = flops / BF16_FLOPS * 1e3
        # the operations are a floor; the bytes (a few MB, in L2) are not
        floor = ("flash_attention", to * 1e3, "operations")
        fk = timed(torch, lambda: ops.flash_attention(q, k, v, impl="cuda"),
                   20, bound=floor)
        fp = timed(torch, lambda: R.attention(q, k, v), 5, bound=floor)
        fl = timed(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 50, bound=floor)
        tiles = {bk: timed(torch, lambda bk=bk: ops.flash_attention(
            q, k, v, bk=bk, impl="cuda"), 20, bound=floor)
            for bk in FL.KERNEL_KEY_TILES
            if bk <= FL.default_bk(torch.bfloat16, DH)} if s == 2048 else {}
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash.cu",
            "replaces": "src/repro/kernels/attention/flash.py:115",
            "launches": flash_launches["flash_attention"],
            "max_abs_err": flash_err, "ms": fk, "plain_ms": fp,
            "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": fl})
        print(f"timing: flash_attention at B=1 S={s} H={H} Hkv={HKV} "
              f"Dh={DH} bf16 causal: {fk * 1e3:.1f} us = "
              f"{flops / fk / 1e9:.1f} TFLOP/s ({to / fk:.3f} of "
              f"{BF16_FLOPS / 1e12:.0f}), bound "
              f"{max(tb, to) * 1e3:.2f} us ({'bytes' if tb >= to else 'ops'}"
              f"; {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
              f"{BF16_FLOPS / 1e12:.0f} TFLOP/s), plain {fp * 1e3:.1f} us, "
              f"sdpa {fl * 1e3:.2f} us" + ("; by key tile " + ", ".join(
                  f"{bk} keys {ms * 1e3:.1f} us" for bk, ms in tiles.items())
                  if tiles else "") + " (device time by profiler)")
    return [paged_row, rows[-1]]


def phase_wide_timings(torch, D, ops, R, reqs) -> None:
    """The three attention kernels at gemma3-4b's head shapes (H=8, Hkv=4,
    Dh=256, bf16), beside their bounds and sdpa: decode, dense and paged
    (page 16), at B=8 over the dense timing's live rows, the caches of 16
    layers cycled so every call reads cold rows; flash attention at B=1,
    S=2048, causal. Printed only: the ``kernels`` line keeps the served
    shapes."""
    from repro_torch.kernels.attention import flash as FL
    F = torch.nn.functional
    b, h, hkv, dh, n_layers, skv, ps = 8, 8, 4, 256, 16, 2048, 16
    gen = torch.Generator(device="cuda").manual_seed(15)
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:b]],
                       dtype=torch.int32, device="cuda")
    kv_len = int(pos.max()) + 1
    kc = torch.randn(n_layers, b, skv, hkv, dh, generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn_like(kc)
    q = torch.randn(b, 1, h, dh, generator=gen, device="cuda").bfloat16()
    bound, split_len, n_splits = D.split_plan(b, hkv, skv, 128, None, kv_len)
    # the same rows as page pools under a shuffled table
    kp = kc.view(n_layers, b * skv // ps, ps, hkv, dh)
    vp = vc.view(n_layers, b * skv // ps, ps, hkv, dh)
    nb = -(-kv_len // ps)
    bt = torch.randperm(kp.shape[1], generator=torch.Generator().manual_seed(
        16))[:b * nb].reshape(b, nb).int().cuda()
    pbound, psl, pns = D.paged_split_plan(b, hkv, ps, nb, None)
    layer = [0]

    def nxt():
        layer[0] = (layer[0] + 1) % n_layers
        return layer[0]

    mask = (torch.arange(bound, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    dkw = dict(window=None, split_len=split_len, n_splits=n_splits,
               bound=bound)
    pkw = dict(window=None, split_len=psl, n_splits=pns, bound=pbound)
    # finished output (one launch), then the partials alone
    dense_ms = [timed(torch, lambda f=f: f(
        q, kc[nxt()], vc[layer[0]], pos, impl="cuda", **dkw), 480)
        for f in (D.decode_finished, D.decode_partials)]
    paged_ms = [timed(torch, lambda f=f: f(
        q, kp[nxt()], vp[layer[0]], bt, pos, impl="cuda", **pkw), 480)
        for f in (D.decode_paged_finished, D.decode_paged_partials)]
    sdpa_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        qt, kc[nxt()][:, :bound].transpose(1, 2),
        vc[layer[0]][:, :bound].transpose(1, 2), attn_mask=mask,
        enable_gqa=True), 480)
    live = (pos + 1).clamp(max=bound).sum().item()
    for name, (ms, part_ms), ns, entries in (
            ("flash_decode", dense_ms, n_splits, 0),
            ("flash_decode_paged", paged_ms, pns,
             ((pos + 1 + ps - 1) // ps).sum().item())):
        bound_ms, bound_by, n_bytes = decode_bound(b, h, hkv, dh, live, 2,
                                                   entries)
        print(f"timing: {name} at gemma3-4b heads (B={b} H={h} Hkv={hkv} "
              f"Dh={dh} bf16, {live} live rows, n_splits={ns}), finished "
              f"output: {ms * 1e3:.2f} us = {n_bytes / ms / 1e6:.0f} GB/s, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}), sdpa "
              f"{sdpa_ms * 1e3:.2f} us; the partials alone "
              f"{part_ms * 1e3:.2f} us (device time by profiler)")
    del kc, vc, kp, vp
    s = 2048
    fq = torch.randn(1, h, s, dh, generator=gen, device="cuda").bfloat16()
    fk = torch.randn(1, hkv, s, dh, generator=gen, device="cuda").bfloat16()
    fv = torch.randn(1, hkv, s, dh, generator=gen, device="cuda").bfloat16()
    n_bytes = (2 * h + 2 * hkv) * s * dh * 2
    flops = 4 * (s * (s + 1) // 2) * h * dh
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = flops / BF16_FLOPS * 1e3
    floor = ("flash_attention", to * 1e3, "operations")
    fk_ms = timed(torch, lambda: ops.flash_attention(fq, fk, fv, impl="cuda"),
                  20, bound=floor)
    fp_ms = timed(torch, lambda: R.attention(fq, fk, fv), 5, bound=floor)
    fl_ms = timed(torch, lambda: F.scaled_dot_product_attention(
        fq, fk, fv, is_causal=True, enable_gqa=True), 50, bound=floor)
    tiles = {bk: timed(torch, lambda bk=bk: ops.flash_attention(
        fq, fk, fv, bk=bk, impl="cuda"), 20, bound=floor)
        for bk in FL.KERNEL_KEY_TILES if bk <= FL.default_bk(torch.bfloat16,
                                                              dh)}
    print(f"timing: flash_attention at gemma3-4b heads (B=1 S={s} H={h} "
          f"Hkv={hkv} Dh={dh} bf16 causal), default "
          f"{FL.default_bk(torch.bfloat16, dh)}-key tiles: "
          f"{fk_ms * 1e3:.1f} us = "
          f"{flops / fk_ms / 1e9:.1f} TFLOP/s ({to / fk_ms:.3f} of "
          f"{BF16_FLOPS / 1e12:.0f}), bound {max(tb, to) * 1e3:.2f} us "
          f"({'bytes' if tb >= to else 'operations'}), plain "
          f"{fp_ms * 1e3:.1f} us, sdpa {fl_ms * 1e3:.2f} us; by key tile "
          + ", ".join(f"{bk} keys {ms * 1e3:.1f} us" for bk, ms in
                      tiles.items()) + " (device time by profiler)")


def phase_trace(torch, serve, eng, reqs, label: str) -> float:
    """Where a full-width decode step's device time goes, and the
    device's idle share over the same steps.

    The same 8 requests are served twice from an idle engine: once to
    take the wall time of two chunked dispatches, once under the
    profiler to take the device's busy time in the same two dispatches.
    Greedy decoding repeats the same tokens, positions and occupancy
    bounds, so both passes do the same work. Returns the unprofiled
    pass's wall ms a step. Prints the device kernels a
    step beside the copies and fills, as the profiler counts them, and
    the host API calls a step that put that work on the card (kernel
    launches, graph launches, copies). An engine with CUDA graphs has
    every bucket's captured first, outside the windows. ``LAUNCHES`` is
    set to 0 at the start of each window; the phase fails unless its
    decode counts are the steps' (layers times steps) and the profile
    holds as many decode kernel events, bar the profiler's known drops
    (:data:`PROFILER_DROPS`): so a replay whose kernels the profile does
    not see fails, and so do replays whose counts are bookkeeping alone.
    A window whose profile lost more decode kernel events than that is
    taken again (:func:`profiled`), up to ``PROFILE_ATTEMPTS`` windows.
    """
    from repro_torch.kernels import LAUNCHES, reset_launches
    check(not any(eng.slots), f"{label}: engine not idle")
    if getattr(eng, "graphs", None) is not None:
        capture_graphs(torch, eng, label)

    def admit_and_warm(tag):
        # 1 token from the prefill and 3 chunks: the warm dispatch, then
        # the two that are measured, after which the requests retire
        for r in reqs[:8]:
            eng.admit(serve.Request(f"{tag}-{r.rid}", r.prompt,
                                    1 + 3 * eng.chunk))
        eng.step()
        torch.cuda.synchronize()

    steps = 2 * eng.chunk
    admit_and_warm("wall")
    t0 = time.perf_counter()
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    check(not any(eng.slots), f"{label}: requests did not retire")
    passes, counted = [], []

    def run():
        reset_launches()
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        passes.append((time.perf_counter() - t0) / steps * 1e3)
        counted.append(LAUNCHES["flash_decode"]
                       + LAUNCHES["flash_decode_paged"])

    want = attention_layers(eng.cfg) * steps

    def lost_decode_events(by_name, counts):
        # CUPTI on the card sometimes drops a few percent of a window's
        # ~40k kernel events: such a window is taken again, named
        decode = sum(n for name, n in counts.items()
                     if DECODE_KERNEL.search(name))
        return [] if decode >= want - profiler_drops(want) else [
            f"the profiler recorded {decode} of the {want} decode kernels"]

    # a window taken again serves the requests once more, from idle
    counts, host = {}, {}
    by_name = profiled(torch, run, label, setup=lambda: admit_and_warm(
        f"trace{len(passes)}"), counts=counts, host=host,
        faults=lost_decode_events)
    check(not any(eng.slots), f"{label}: requests did not retire")
    prof_wall_ms = passes[-1]
    # before any reading is printed: the replays' kernels are in the
    # profile, and so are the host calls that launched them
    decode = sum(n for name, n in counts.items()
                 if DECODE_KERNEL.search(name))
    print(f"{label}: decode kernels in the window: {decode} profiler "
          f"events, {counted[-1]} counted by LAUNCHES ({want} expected)")
    check(counted[-1] == want, f"{label}: LAUNCHES counted {counted[-1]} "
          f"decode launches in the window, expected {want}")
    check(want - profiler_drops(want) <= decode <= want,
          f"{label}: the profile holds {decode} decode kernels of the "
          f"{want} LAUNCHES counted (at most {profiler_drops(want)} "
          f"dropped)")
    calls = host_launches(host)
    check(calls["kernel"] + calls["graph"] > 0,
          f"{label}: the profile holds no host launch call")
    total = sum(by_name.values())
    groups = {"flash_decode": 0.0, "flash_decode_paged": 0.0,
              "kv_row_update": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in by_name.items():
        low = name.lower()
        if DECODE_KERNEL.search(name):
            # one kernel body, instantiated with PAGED = false and true
            paged = DECODE_PAGED.search(name) is not None
            groups["flash_decode_paged" if paged else "flash_decode"] += us
        elif "kv_rows_kernel" in name:
            groups["kv_row_update"] += us
        elif any(t in low for t in ("gemm", "gemv", "cutlass", "sm90_",
                                    "nvjet", "matmul", "splitk")):
            groups["matmul"] += us
        else:
            groups["other"] += us
    dev_ms = total / 1e3 / steps
    print(f"{label}: full-width decode step, 8 slots (2 dispatches of "
          f"{eng.chunk} tokens, same requests twice): device busy "
          f"{dev_ms:.2f} ms/step (profiled pass) of {wall_ms:.2f} ms/step "
          f"wall (unprofiled pass), idle share {1 - dev_ms / wall_ms:.3f}; "
          f"under the profiler {prof_wall_ms:.2f} ms/step wall")
    copies = sum(n for name, n in counts.items()
                 if name.startswith(("Memcpy", "Memset")))
    print(f"{label}: device kernels a step "
          f"{(sum(counts.values()) - copies) / steps:.1f}, plus "
          f"{copies / steps:.1f} copies and fills (profiler events; it "
          f"drops a few)")
    print(f"{label}: host launch calls a step "
          f"{(calls['kernel'] + calls['graph']) / steps:.3f} "
          f"({calls['kernel'] / steps:.3f} kernel launches, "
          f"{calls['graph'] / steps:.3f} graph launches), plus "
          f"{calls['copy'] / steps:.3f} copy calls")
    print(f"{label}: device time by group: " + ", ".join(
        f"{g} {us / 1e3 / steps:.3f} ms/step ({us / total:.3f})"
        for g, us in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        print(f"{label}: {us / 1e3 / steps:8.3f} ms/step  {name[:100]}")
    return wall_ms


# --- planning and pricing on the card's machine file -----------------------

#: the scheduling backends each plan line prices the step with
PLAN_BACKENDS = ("tp_bound", "mca_sched")
#: split counts the decode sweep times besides ``default_splits``' and
#: the tuner's, at 64-row blocks (the bf16 kernel's tile: 8 splits fit
#: the sweep's 512-row bound)
SWEEP_SPLITS = (1, 2, 4, 8)
SWEEP_BK = 64
#: the sweep's calls a timing window
SWEEP_ITERS = 240
#: the guard: the tile tuner's split count reads at most this much slower
#: than the sweep's fastest count at each shape (the tuner prices the
#: decode kernels' grid in whole waves of the SMs and their merge). The
#: serving path keeps ``default_splits``, the most splits one wave holds,
#: which is the tuner's count at every shape here; a reading over the
#: guard prints a notice.
SWEEP_GUARD = 1.03
#: the least share of the planned engine's greedy tokens that must match
#: the chunk-8 engine's, each stream up to its first parting token. The
#: two engines run the same per-token step, but at the steps where a
#: chunk crosses a 128-row boundary their ``kv_len`` buckets differ, so
#: the split partition of the KV rows and the bf16 rounding of the
#: combine differ, and a near tie of the greedy argmax can part a
#: stream from there on. A wrong planned path (a wrong position or cache
#: row) parts every stream at its first decode token.
PLANNED_STREAM_MIN = 0.5


def tuner_plan(q, hkv: int, bound: int):
    """The tile tuner's plan on the ``h100`` machine file for a decode
    call on ``q`` (B, Sq, H, Dh) over ``bound`` rows of ``hkv`` KV heads,
    as the JAX router asks it (``dtype`` the dtype's name)."""
    from repro_torch.kernels import tuning
    b, _, h, dh = q.shape
    return tuning.decode_tiles("h100", skv=bound, dh=dh, h=h, hkv=hkv,
                               batch=b, dtype=str(q.dtype)[len("torch."):])


def trace_rows(reqs, chunk: int) -> int:
    """Mean cache rows a slot holds over :func:`phase_trace`'s two
    measured chunks (its requests' prompts, the prefill's token and the
    warm chunk before them): the occupancy its wall time was read at."""
    lens = [len(r.prompt) for r in reqs[:8]]
    return round(sum(lens) / len(lens) + 1 + 2 * chunk)


def phase_plan(torch, label: str, eng, measured_ms: float,
               occupancy: int | None) -> float:
    """One ``plan`` line: the served config's decode step planned for the
    ``h100`` machine file, beside the card's reading.

    The step's ATen trace (``planner.decode_step_trace``, the dense step
    at the engine's slots and horizon, lowered on meta tensors) is priced
    under both backends: ``dense_ms`` the full-horizon step, ``kernel_ms``
    the step with its KV read re-priced at ``occupancy`` rows a slot
    through the tuner's tiles (``_kernel_adjusted``; ``page_size`` for a
    paged engine). That bound rounds to the tuner's KV block on ``h100``
    (64 rows at yi-9b's measured occupancy), not to the 128-row block the
    dense path runs. ``measured_ms`` is :func:`phase_trace`'s wall ms a
    step; the ratio is measured over ``kernel_ms``. ``chunk`` and
    ``store_flavor`` are the engine's own plan (occupancy = its horizon),
    what ``ServeEngine(chunk=None, machine="h100")`` takes. Returns the
    seconds the phase took."""
    from repro_torch.serve import planner
    t0 = time.perf_counter()
    cfg, b, horizon = eng.cfg, eng.max_slots, eng.max_len
    page = eng.page_size if eng.paged else None
    tr = planner.decode_step_trace(cfg, b, horizon)
    t_lower = time.perf_counter() - t0

    def walk(region):
        for op in region.ops:
            yield op
            if op.region is not None:
                yield from walk(op.region)
    unknown = sorted({op.opcode for op in walk(tr.entry) if op.unknown})
    pred = {}
    for backend in PLAN_BACKENDS:
        adj = planner.plan_chunk_size(cfg, b, horizon, machine="h100",
                                      backend=backend, page_size=page,
                                      occupancy=occupancy)
        dense = (adj.per_machine_dense or adj.per_machine)["h100"]
        pred[backend] = {"dense_ms": dense * 1e3,
                         "kernel_ms": adj.t_step_seconds * 1e3}
    own = planner.plan_chunk_size(cfg, b, horizon, machine="h100",
                                  occupancy=horizon, page_size=page)
    line = {
        "plan": label, "arch": cfg.name, "layers": cfg.n_layers,
        "slots": b, "horizon": horizon, "page_size": page,
        "machine": "h100", "trace_ops": tr.n_ops(),
        "unknown_ops": unknown, "occupancy": occupancy,
        "predicted_ms": pred, "measured_ms": measured_ms,
        "measured_over_predicted": {
            k: measured_ms / v["kernel_ms"] for k, v in pred.items()},
        "chunk": own.chunk, "store_flavor": own.store_flavor,
        "lower_s": t_lower, "plan_s": time.perf_counter() - t0}
    print(json.dumps(line))
    for k, v in pred.items():
        check(all(math.isfinite(x) and x > 0 for x in v.values()),
              f"{label}: {k} predicted {v}")
    check(pred["mca_sched"]["kernel_ms"] >= pred["tp_bound"]["kernel_ms"]
          * (1 - 1e-9), f"{label}: mca_sched under tp_bound: {pred}")
    check(own.store_flavor == "standard",
          f"{label}: h100 store flavor {own.store_flavor}")
    return time.perf_counter() - t0


def phase_split_sweep(torch, D, ops, eng, reqs) -> float:
    """The decode kernels at the split counts the tuner chooses among.

    ``flash_decode`` at yi-9b's decode shape (the engine's own 48-layer
    cache, cycled) and at gemma3-4b's (H=8, Hkv=4, Dh=256, 16 random
    layers), ``flash_decode_paged`` at yi-9b's (the same cache as page
    pools of 16 rows under a permuted table): B=8, the dense timing's
    positions, the bound their 128-row bucket; and ``flash_decode`` at
    gemma3-4b's again at its own served positions (``GEMMA_PROMPT_LENS``
    plus 32 decoded tokens) and their bucket. Each at n_splits 1, 2,
    4, 8 (``SWEEP_BK``-row blocks), ``default_splits``' count (the
    path's: the most splits whose B x Hkv x n_splits blocks fit in one
    wave of the machine file's SMs; 128-row blocks) and the tile tuner's
    (:func:`tuner_plan`), each a ``split_sweep`` line with the tuner's
    modeled ``TilePlan.seconds`` beside the measured µs (``timed``).
    Prints at each shape the guard (the tuner's pick over the sweep's fastest
    count) and the tuner's tiles of every yi-9b bucket. Returns the
    seconds the phase took."""
    t0 = time.perf_counter()
    pos = torch.tensor([len(r.prompt) + 32 for r in reqs[:B]],
                       dtype=torch.int32, device="cuda")
    cache = eng.cache["scan"]["0"]
    kc, vc = cache["k"], cache["v"]
    skv = kc.shape[2]
    bound = min(-(-(int(pos.max()) + 1) // 128) * 128, skv)
    gen = torch.Generator(device="cuda").manual_seed(21)
    gk = torch.randn(16, B, skv, 4, 256, generator=gen,
                     device="cuda").bfloat16()
    gv = torch.randn_like(gk)
    ps = 16
    kp = kc.view(kc.shape[0], B * skv // ps, ps, HKV, DH)
    vp = vc.view(vc.shape[0], B * skv // ps, ps, HKV, DH)
    nb = bound // ps
    bt = torch.randperm(kp.shape[1], generator=torch.Generator().manual_seed(
        22))[:B * nb].reshape(B, nb).int().cuda()
    gpos = torch.randint(*GEMMA_PROMPT_LENS, (B,), generator=torch.Generator(
        ).manual_seed(23), dtype=torch.int32).cuda() + 32
    gbound = min(-(-(int(gpos.max()) + 1) // 128) * 128, skv)
    shapes = (("flash_decode yi-9b", H, HKV, DH, kc, vc, None, pos, bound),
              ("flash_decode gemma3-4b", 8, 4, 256, gk, gv, None, pos,
               bound),
              ("flash_decode_paged yi-9b", H, HKV, DH, kp, vp, bt, pos,
               bound),
              ("flash_decode gemma3-4b served", 8, 4, 256, gk, gv, None,
               gpos, gbound))
    guards = {}
    for label, h, hkv, dh, kk, vv, table, pos, bound in shapes:
        live = int((pos + 1).clamp(max=bound).sum())
        entries = 0 if table is None else int(((pos + 1).clamp(max=bound)
                                               + ps - 1).div(ps).sum())
        bound_ms, bound_by, _ = decode_bound(B, h, hkv, dh, live, 2, entries)
        q = torch.randn(B, 1, h, dh, generator=gen, device="cuda").bfloat16()
        plan = tuner_plan(q, hkv, bound)
        blocks = -(-bound // 128) if table is None else nb
        default = D.default_splits(B, hkv, blocks)
        layer = [0]
        variants = [("", SWEEP_BK, n) for n in SWEEP_SPLITS] + [
            ("default_splits", 128, default),
            ("tuner", plan.bk, plan.n_splits)]
        times = {}
        for which, bk, ns in variants:
            if table is None:
                bnd, sl, n = D.split_plan(B, hkv, skv, bk, ns, bound)
            else:
                bnd, sl, n = D.paged_split_plan(B, hkv, ps, nb, ns)
            kw = dict(window=None, split_len=sl, n_splits=n, bound=bnd,
                      impl="cuda")

            def call(kw=kw):
                i = layer[0] = (layer[0] + 1) % kk.shape[0]
                if table is None:
                    D.decode_finished(q, kk[i], vv[i], pos, **kw)
                else:
                    D.decode_paged_finished(q, kk[i], vv[i], table, pos,
                                            **kw)
            ms = timed(torch, call, SWEEP_ITERS)
            times[which or f"n{ns}"] = ms
            print(json.dumps({
                "split_sweep": label, "which": which or "fixed",
                "n_splits": n, "bk": bk if table is None else ps,
                "blocks": B * hkv * n, "bound": bnd, "live_rows": live,
                "us": ms * 1e3, "bound_us": bound_ms * 1e3,
                "bound_by": bound_by, "tuner_bk": plan.bk,
                "tuner_splits": plan.n_splits,
                "tuner_model_us": plan.seconds * 1e6}))
        ratio = times["tuner"] / times["default_splits"]
        fastest = min(SWEEP_SPLITS, key=lambda n: times[f"n{n}"])
        guards[label] = times["tuner"] / times[f"n{fastest}"]
        print(f"split sweep: {label}: the tuner's (bk {plan.bk}, "
              f"{plan.n_splits} splits) {times['tuner'] * 1e3:.2f} us, "
              f"the sweep's fastest {fastest} splits "
              f"{times[f'n{fastest}'] * 1e3:.2f} us (guard "
              f"{guards[label]:.3f}x), default_splits' {default} "
              f"{times['default_splits'] * 1e3:.2f} us ({ratio:.3f}x), "
              f"model {plan.seconds * 1e6:.2f} us; {live} live rows at "
              f"Dh={dh}, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    del gk, gv
    held = [k for k, g in guards.items() if g <= SWEEP_GUARD]
    print(f"split sweep: guard (the tuner's pick over the sweep's fastest "
          f"count, <= {SWEEP_GUARD}) held at {len(held)} of {len(guards)} "
          f"shapes: " + ", ".join(f"{k} {g:.3f}x" for k, g in
                                  guards.items()))
    if len(held) < len(guards):
        print("split sweep: NOTICE: the tuner's pick reads over the guard: "
              "ROADMAP queue 3's split fault stays open")
    q = torch.empty(B, 1, H, DH, dtype=torch.bfloat16, device="meta")
    tiles = {kv: (tuner_plan(q, HKV, kv),
                  D.default_splits(B, HKV, -(-kv // 128)))
             for kv in range(128, skv + 1, 128)}
    print("split sweep: by yi-9b dense kv_len bucket, the tuner's (bk, "
          "n_splits) on h100 beside default_splits' count at 128-row "
          "blocks: " + ", ".join(f"{kv}: ({p.bk}, {p.n_splits}) / {d}"
                                 for kv, (p, d) in tiles.items()))
    return time.perf_counter() - t0


#: Fig. 3's quick grid on the card: variants and sizes (``core/rpe.py``'s
#: card sizes: S 2^24, L 2^28 f32 an array)
ANALYSIS_VARIANTS = ("eager", "loop")
ANALYSIS_SIZES = ("S", "L")
#: each block's timing there: best of 3 single calls (the full grid,
#: ``repro_torch.bench.run --only fig3 --full``, takes rpe's 5 x 3)
ANALYSIS_REPS, ANALYSIS_INNER = 3, 1
#: elements of the ``kernel`` variant's check against the plain version
ANALYSIS_CHECK_N = 1 << 20


def phase_analysis(torch, K) -> float:
    """Phase 6b: the analysis half on the card (module docstring).
    Returns the seconds it took."""
    from repro_torch.bench import fig4_wa, fig4b_ntstore
    from repro_torch.core import rpe, ubench
    from repro_torch.kernels.stream.ref import KERNELS_13
    t0 = time.perf_counter()
    model = ubench.calibrated_host_model(device="cuda")
    raw = ubench.calibration("cuda")
    print(json.dumps({"calibration": model.name, "chain_us": {
        k[:-2]: raw[k] * 1e6 for k in ("add_s", "fma_s", "div_s", "exp_s",
                                       "gather_s", "move_s", "matmul_s")},
        "rates": raw["rates"], "bf16_matmul_tflops":
        raw["flops_matmul"] / 1e12, "stream_gbs": raw["stream_bw"] / 1e9,
        "l2_chain_gbs": raw["l2_chain_bw"] / 1e9,
        "tiers": [{"name": t.name, "per_sm_gbs": t.load_bw / 1e9,
                   "shared_gbs": t.shared_bw / 1e9}
                  for t in model.mem_tiers],
        "block_read_gbs": {tier: {str(c): r / 1e9 for c, r in sweep}
                           for tier, sweep in raw["cta_sweep"].items()},
        "per_sm_share_gbs": model.chip.hbm_bw / model.cores / 1e9}))
    t_cal = time.perf_counter() - t0
    machines = (model.name, "h100")
    recs = {m: [] for m in machines}
    for k in KERNELS_13:
        for v in ANALYSIS_VARIANTS:
            for size in ANALYSIS_SIZES:
                for m, r in zip(machines, rpe.run_block_machines(
                        k, v, size, machines, "cuda", reps=ANALYSIS_REPS,
                        inner=ANALYSIS_INNER)):
                    recs[m].append(r)
    t_grid = time.perf_counter() - t0 - t_cal
    for m, rs in recs.items():
        bad = rpe.nan_records(rs)
        print(json.dumps({"fig3_quick": m, "blocks": len(rs),
                          "nan_records": len(bad),
                          "summary": rpe.summarize(rs),
                          "hist": {w: rpe.histogram(rs, w)
                                   for w in ("port", "mca", "naive")}}))
        check(not bad, f"fig3 quick grid on {m}: NaN records "
              f"{[(r.kernel, r.variant, r.size) for r in bad]}")
    print("fig3 quick: blocks (kernel, variant, size: measured us, "
          "h100_measured port/mca/naive us, h100 port us): " + "; ".join(
              f"{a.kernel}/{a.variant}/{a.size}: {a.t_meas * 1e6:.1f}, "
              f"{a.t_port * 1e6:.1f}/{a.t_mca * 1e6:.1f}/"
              f"{a.t_naive * 1e6:.1f}, {b.t_port * 1e6:.1f}"
              for a, b in zip(*recs.values())))
    for k in KERNELS_13:
        args = rpe.make_inputs(k, ANALYSIS_CHECK_N, device="cuda")
        K.reset_launches()
        fn, a = rpe.build_variant(k, "kernel", ANALYSIS_CHECK_N, "cuda", args)
        got = fn(*a)
        launched = sorted(n for n, c in K.LAUNCHES.items() if c)
        pfn, pa = rpe.build_variant(k, "eager", ANALYSIS_CHECK_N, "cuda",
                                    args)
        want = pfn(*pa).reshape(got.shape)
        err = float((got.float() - want.float()).abs().max())
        # a sum's rounding scales with the sum of its terms' magnitudes
        scale = float(args[0].abs().sum() if k == "sum_reduction"
                      else want.float().abs().max())
        print(f"rpe kernel variant: {k}: launched {launched or 'none'}, "
              f"max |kernel - plain| {err:.3e} (max |plain| {scale:.3e})")
        check(launched == ([] if k in rpe.PLAIN_KERNELS else
                           ["init_store" if k == "init" else k]),
              f"rpe kernel variant {k}: launched {launched}")
        check(err <= 1e-6 * max(scale, 1.0),
              f"rpe kernel variant {k}: off its plain version by {err}")
    for line in fig4b_ntstore.main(quick=True, device="cuda"):
        print(line)
    for line in fig4_wa.main(quick=True, device="cuda"):
        if "_store" in line:
            print(line)
    print(f"analysis phase: {time.perf_counter() - t0:.1f} s (calibration "
          f"{t_cal:.1f} s, Fig. 3 quick grid {t_grid:.1f} s)")
    return time.perf_counter() - t0


def phase_planned_engine(torch, np, serve, cfg, params) -> float:
    """One planned engine: ``ServeEngine(chunk=None, machine="h100")``
    serves 8 requests of 128-256-token prompts, 48 new tokens each, at
    the 2048-row horizon, beside a chunk-8 engine on the same requests.
    Each engine serves one warm-up set (capturing the graphs of the
    buckets it reaches) and is then timed on a second set of the same
    lengths; both engines get the same two sets. Fails unless
    ``engine.chunk == engine.plan.chunk``, every request gets its
    tokens, every stream's first token agrees between the engines, and
    at least ``PLANNED_STREAM_MIN`` of the planned engine's tokens match
    the chunk-8 engine's up to each stream's first parting token.
    Returns the seconds the phase took."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    lens = rng.integers(128, 257, size=8)

    def requests(tag):
        return [serve.Request(f"{tag}{i}", tuple(
            int(t) for t in rng.integers(0, cfg.vocab_size, n)), 48)
            for i, n in enumerate(lens)]
    warm, timed_reqs = requests("w"), requests("t")
    out = {}
    for chunk in (None, 8):
        eng = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048,
                                chunk=chunk, machine="h100", device="cuda")
        if chunk is None:
            check(eng.plan is not None and eng.chunk == eng.plan.chunk,
                  f"planned engine: chunk {eng.chunk}, plan {eng.plan}")
        eng.run(warm)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = eng.run(timed_reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        check(all(len(res[r.rid]) == r.max_new_tokens for r in timed_reqs),
              f"planned engine (chunk={chunk}): not every request got its "
              f"tokens")
        out["planned" if chunk is None else "chunk 8"] = (
            eng.chunk, sum(len(v) for v in res.values()) / wall, res)
        del eng
        torch.cuda.empty_cache()
    (pc, ptok, pres), (_, ctok, cres) = out["planned"], out["chunk 8"]
    parted = []
    for r in timed_reqs:
        a, b = list(pres[r.rid]), list(cres[r.rid])
        parted.append(next((i for i, (x, y) in enumerate(zip(a, b))
                            if x != y), len(a)))
    share = sum(parted) / sum(r.max_new_tokens for r in timed_reqs)
    print(f"planned engine: ServeEngine(chunk=None, machine='h100') on "
          f"yi-9b took chunk {pc} (engine.chunk == engine.plan.chunk): "
          f"{ptok:.1f} tok/s, beside {ctok:.1f} tok/s at chunk 8 on the "
          f"same requests (8 slots, 128-256-token prompts, 48 new tokens); "
          f"greedy streams identical to chunk 8's: "
          f"{sum(p == r.max_new_tokens for p, r in zip(parted, timed_reqs))}"
          f" of {len(timed_reqs)}, first parting token by stream {parted}, "
          f"tokens before it {share:.3f} (min {PLANNED_STREAM_MIN})")
    check(all(p > 0 for p in parted),
          f"planned engine: a stream's first token differs from chunk 8's "
          f"({parted})")
    check(share >= PLANNED_STREAM_MIN,
          f"planned engine: {share:.3f} of the tokens match chunk 8's "
          f"streams, under {PLANNED_STREAM_MIN}")
    return time.perf_counter() - t0


# --- phase 7: the serving benchmarks at full width --------------------------

#: phase 7: the seeds of the weights of 7a-7d
FIG_SEEDS = {"fig7": 71, "fig8": 72, "fig9": 73, "fig10": 74}
#: phase 7a: chunk replays a profiler window (and a wall window) per path
#: and occupancy
FIG7_ITERS = 3
#: phase 7c: requests a trace
FIG9_REQUESTS = 16
#: phase 7d: requests a trace
FIG10_REQUESTS = 16


def fig_model(torch, arch: str, seed: int, label: str,
              dtype: str | None = None, layers: int | None = None):
    """``(cfg, params)`` of ``arch`` at its published width and depth (or
    ``layers`` layers) on the card, weights from ``seed``
    (``bench._common.model``); prints their size."""
    from repro_torch.bench._common import model
    t0 = time.perf_counter()
    cfg, params = model(arch, "cuda", seed=seed, dtype=dtype, layers=layers)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"{label}: {cfg.name} at its published width "
          f"({cfg.n_layers} layers, d_model {cfg.d_model}), {n / 1e9:.3f} B "
          f"params {cfg.param_dtype}, init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def print_engine_graphs(torch, engines, label: str) -> None:
    """Each engine's captured graphs (over every chunk length), graph pool
    bytes, decode ms a step and prefill seconds."""
    for i, eng in enumerate(engines):
        st = eng.stats()
        pool = graph_pool_bytes(torch, eng.graphs.pool)
        ms = st["decode_s"] / max(1, st["decode_tokens"]) * 1e3
        print(f"{label}: engine {i}: chunk lengths {eng.chunk_lengths}, "
              f"{eng.captured_graphs()} CUDA graphs captured, graph pool "
              + ("not in the allocator's snapshot" if pool is None
                 else f"{pool / 2 ** 20:.1f} MiB")
              + f"; {st['decode_dispatches']} decode dispatches, "
              f"{st['decode_tokens']} steps, {ms:.3f} ms/step, prefill "
              f"{st['prefill_s']:.2f} s ({st['prefill_dispatches']} "
              f"dispatches), quarantined {st['quarantined']}")


def phase_fig7(torch, K) -> int:
    """7a: fig7 at yi-9b's published width and depth (B=8, a 4096-row
    horizon, occupancy 1/8, 1/4, 1/2, 1): the decode kernel's device µs a
    step over the full horizon (``kv_len=None``) against bounded by the
    occupancy, each chunk a CUDA-graph replay, and the chunk's ms a step;
    the reference's gates on the kernel's time. Returns the path's
    ``flash_decode`` launches."""
    from repro_torch.bench import fig7_decode as F7
    label = "fig7 (7a)"
    t0 = time.perf_counter()
    cfg, params = fig_model(torch, "yi-9b", FIG_SEEDS["fig7"], label)
    occ = tuple(F7.CARD_MAX_LEN * f // 16 for f in F7.CARD_FRACS)
    K.reset_launches()
    rec = F7.decode_record(cfg, params, F7.CARD_BATCH, F7.CARD_MAX_LEN, occ,
                           FIG7_ITERS, "cuda")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for ln in F7.record_lines(rec, "cuda"):
        print(ln)
    print(F7.gate(rec))
    check(launches["flash_decode"] > 0 and launches["flash_decode_paged"] == 0
          and launches["kv_row_update"] == 0,
          f"{label}: launches {launches}, expected flash_decode only")
    lo = rec["cells"][0]
    print(f"{label}: at occupancy {lo['occ']} of {F7.CARD_MAX_LEN} rows the "
          f"bounded decode reads {lo['k_split'] * 1e6:.1f} us a step against "
          f"{lo['k_dense'] * 1e6:.1f} over the full horizon "
          f"({lo['k_dense'] / lo['k_split']:.2f}x); flash_decode launches "
          f"{launches['flash_decode']}; {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()
    return launches["flash_decode"]


def phase_fig8(torch, K) -> tuple:
    """7b: fig8 at yi-9b's published width and depth in fp32 (8 slots, a
    2048-row horizon, pages of 16): priced and measured peak KV bytes,
    dense against paged streams byte-identical with a shared prefix and a
    fork, shared-prefix admission, the gather counter and a diverging
    fork's copy on write. Returns the path's (``flash_decode``,
    ``flash_decode_paged``) launches."""
    from repro_torch.bench import fig8_paged as F8
    label = "fig8 (7b)"
    t0 = time.perf_counter()
    K.reset_launches()
    lines = F8.main(device="cuda")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for ln in lines:
        print(ln)
    check(any("fork_identical=OK" in ln for ln in lines),
          f"{label}: no forked stream was held")
    check(launches["flash_decode"] > 0 and launches["flash_decode_paged"] > 0
          and launches["kv_row_update"] == 0,
          f"{label}: launches {launches}, expected both decode kernels")
    print(f"{label}: flash_decode launches {launches['flash_decode']}, "
          f"flash_decode_paged {launches['flash_decode_paged']}; "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches["flash_decode"], launches["flash_decode_paged"]


def phase_fig9(torch, K) -> int:
    """7c: fig9 at gemma3-4b's published width and depth: 2 replicas of 8
    slots over one copy of the weights, a 16-request Poisson and a bursty
    trace under both policies; latency percentiles, tokens a chip and the
    conservation gate; each engine's graphs. Returns the path's
    ``flash_decode`` launches."""
    from repro_torch.bench import fig9_load as F9
    label = "fig9 (7c)"
    t0 = time.perf_counter()
    cfg, params = fig_model(torch, "gemma3-4b", FIG_SEEDS["fig9"],
                            label)
    engines = F9.build_engines(cfg, params, slots=F9.CARD_SLOTS,
                               device="cuda")
    K.reset_launches()
    lines = F9.load_lines(cfg, engines, n_req=FIG9_REQUESTS, device="cuda")
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for ln in lines + F9._sharding_gates(cfg):
        print(ln)
    check(len(lines) == 4 and all("conserved=OK" in ln for ln in lines),
          f"{label}: a trace was not conserved")
    check(launches["flash_decode"] > 0 and launches["flash_decode_paged"] == 0,
          f"{label}: launches {launches}, expected flash_decode only")
    print_engine_graphs(torch, engines, label)
    print(f"{label}: flash_decode launches {launches['flash_decode']}; "
          f"{time.perf_counter() - t0:.1f} s")
    del engines, params
    torch.cuda.empty_cache()
    return launches["flash_decode"]


def phase_fig10(torch, K) -> None:
    """7d: fig10 at xlstm-125m's published width and depth in fp32: 2
    planned replicas of 8 slots (chunk planned on ``h100``), the
    reference's fault-free baseline and chaos run of a Poisson and a
    bursty trace (``fig10_chaos.chaos_record``): a stuck replica ejected
    and its streams rescued, a NaN poison in the graph-replayed recurrent
    state quarantined and rescued, an admission error, and a pool
    exhaustion whose priced decision replans the chunk through
    ``set_chunk`` (the new chunk's graph captured). The reference's
    gates, and: each fault fired, each rescue path ran, a replan
    landed."""
    from repro_torch.bench import fig10_chaos as F10
    label = "fig10 (7d)"
    t0 = time.perf_counter()
    cfg, params = fig_model(torch, "xlstm-125m", FIG_SEEDS["fig10"], label,
                            dtype="float32")
    engines = F10.build_engines(cfg, params, slots=F10.CARD_SLOTS,
                                machine="h100", device="cuda")
    reasons, replans, tokens = set(), 0, 0
    fired: dict = {}
    for kind in ("poisson", "bursty"):
        t1 = time.perf_counter()
        out = F10.chaos_record(engines, kind, FIG10_REQUESTS,
                               cfg.vocab_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        for ln in F10.gate_lines(kind, FIG10_REQUESTS, out):
            print(ln)
        rt, rec = out["router"], out["rec"]
        reasons |= {e["reason"] for e in rec["events"]
                    if e["kind"] == "rescue"}
        replans += sum(d["choice"] == "replan" for d in rt.degrade_log)
        for eng in rt.replicas:
            for k, n in eng.injected.items():
                fired[k] = fired.get(k, 0) + n
        check(any(s == "ejected" for _, _, s in rt.health[0].transitions),
              f"{label}: the stuck replica was not ejected ({kind})")
        tokens += sum(len(v) for v in out["base"]["results"].values()) \
            + sum(len(v) for v in rec["results"].values())
        print(f"{label}: {kind}: baseline and chaos runs in {wall:.2f} s")
    check({"eject", "nonfinite"} <= reasons,
          f"{label}: rescue paths run {sorted(reasons)}, expected eject and "
          f"nonfinite")
    check(all(fired.get(k, 0) > 0 for k in ("stuck", "nonfinite",
                                            "admit_error", "pool_exhausted")),
          f"{label}: faults fired {fired}")
    check(replans >= 1, f"{label}: no replan decision landed")
    check(any(len(e.chunk_lengths) >= 2 and e.captured_graphs() >= 2
              for e in engines),
          f"{label}: no engine captured a replanned chunk's graph")
    print_engine_graphs(torch, engines, label)
    print(f"{label}: faults fired {fired}; rescue paths {sorted(reasons)}; "
          f"{replans} replans through set_chunk; {tokens} tokens over the "
          f"baseline and chaos runs; {time.perf_counter() - t0:.1f} s")
    del engines, params
    torch.cuda.empty_cache()


def phase_serving_benchmarks(torch, K) -> dict:
    """Phase 7 (7a-7d), after every other phase's engines are freed.
    Returns the new paths' decode launches by kernel and path."""
    t0 = time.perf_counter()
    n7 = phase_fig7(torch, K)
    n8, n8p = phase_fig8(torch, K)
    n9 = phase_fig9(torch, K)
    phase_fig10(torch, K)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    return {"flash_decode": {"fig7 decode sweep": n7,
                             "fig8 dense engine": n8,
                             "fig9 replicas": n9},
            "flash_decode_paged": {"fig8 paged engines": n8p}}


# --- phase 8: the runtime around the engine ---------------------------------

#: phase 8: the seeds of 8a's weights (yi-9b) and of 8c's and 8e's
#: (xlstm-125m), and of their requests
RUNTIME_SEEDS = {"yi-9b": 81, "xlstm-125m": 82, "requests": 5}
#: phase 8a: yi-9b's depth, 16 of its 48 layers (all 48 until phase 12
#: came; cut so that the script stays well inside its time limit on a
#: slow host: its four engines' graph captures took ~50 s of it)
RUNTIME_LAYERS = 16
#: phase 8: the pipelined engines' in-flight bound
PIPELINE = 2
#: phase 8a: host calls that block the host on the card's work
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy")
#: phase 8c: xlstm-125m requests (prompt tokens, new tokens) and their
#: count: 16 rounds of 8 tokens a serve
SNAPSHOT_REQUESTS = (64, 129, 8)
#: phase 8e: the launcher's batch, prompt and new tokens
LAUNCH_CELL = (8, 64, 64)


def runtime_requests(np, serve, vocab: int) -> list:
    """Phase 5's 16 requests: 128-512-token prompts, 64 new tokens each."""
    rng = np.random.default_rng(RUNTIME_SEEDS["requests"])
    lens = rng.integers(128, 513, size=16)
    return [serve.Request(f"r{i}", tuple(int(t) for t in
                                         rng.integers(0, vocab, n)), 64)
            for i, n in enumerate(lens)]


def blocking_between_enqueues(prof) -> tuple:
    """Host calls of :data:`BLOCKING_CALLS` that start between the first
    and the last decode enqueue (graph launch) of a profile, by name, and
    the number of enqueues."""
    from torch.autograd import DeviceType
    host = [(ev.start_ns(), ev.name())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() != DeviceType.CUDA]
    enq = sorted(t for t, n in host
                 if n.startswith(HOST_CALLS["graph"]))
    out: dict = {}
    if len(enq) >= 2:
        for t, n in host:
            if enq[0] < t < enq[-1] and any(
                    n == b or n.startswith(b + "_v") for b in BLOCKING_CALLS):
                out[n] = out.get(n, 0) + 1
    return out, len(enq)


def device_gaps(prof) -> tuple:
    """``(span µs, busy µs, largest gap µs)`` of a profile's device
    timeline: from its first kernel's start (the copies a round ships
    before its graph launch are left out: the host's time to launch the
    first graph is not a gap between rounds) to its last event's end, the
    union of its events (kernels, copies, fills) in that span, and the
    longest stretch inside it with no event on the card."""
    from torch.autograd import DeviceType
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA]
    starts = [ev.start_ns() for ev in events
              if not ev.name().startswith(("Memcpy", "Memset"))]
    if not starts:
        return 0.0, 0.0, 0.0
    first = min(starts)
    spans = sorted((max(ev.start_ns(), first), ev.end_ns()) for ev in events
                   if ev.end_ns() > first)
    busy, gap = 0, 0
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gap = max(gap, a - hi)
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return (spans[-1][1] - spans[0][0]) / 1e3, busy / 1e3, gap / 1e3


def trace_rounds(torch, serve, eng, reqs, depth: int, label: str) -> dict:
    """Two decode rounds of ``eng`` at in-flight bound ``depth`` (0:
    serial), from nothing in flight, then a sync: once on the wall clock,
    once under the profiler. Returns the device idle share over the
    unprofiled window, the idle share inside the device's own span (from
    its first event to its last: the gaps between kernels and between
    the rounds), its largest gap, and the blocking calls between the two
    enqueues."""
    from torch.profiler import ProfilerActivity, profile
    eng.pipeline = depth
    steps = 2 * eng.chunk

    def admit_and_warm(tag):
        for r in reqs[:eng.max_slots]:
            eng.admit(serve.Request(f"{tag}-{r.rid}", r.prompt,
                                    1 + 4 * eng.chunk))
        eng.step()
        eng.sync()
        torch.cuda.synchronize()

    def two_rounds():
        eng.step()
        eng.step()
        eng.sync()
        torch.cuda.synchronize()

    def drain():
        while any(eng.slots):
            eng.step()
        eng.sync()

    admit_and_warm("wall")
    t0 = time.perf_counter()
    two_rounds()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    drain()
    admit_and_warm("prof")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        two_rounds()
    drain()
    by_name = device_us(prof)
    check(sum(by_name.values()) > 0,
          f"{label}: the profiler saw no device time")
    blocking, enqueues = blocking_between_enqueues(prof)
    check(enqueues == 2, f"{label}: {enqueues} graph launches in the "
          f"window, expected 2")
    dev_ms = sum(by_name.values()) / 1e3 / steps
    idle = 1 - dev_ms / wall_ms
    span, busy, gap = device_gaps(prof)
    print(f"{label}: two rounds of {eng.chunk} steps from nothing in "
          f"flight: device busy {dev_ms:.3f} ms/step of {wall_ms:.3f} "
          f"ms/step wall, idle share {idle:.4f}; inside the device's span "
          f"({span / 1e3:.3f} ms) idle share {1 - busy / span:.4f}, largest "
          f"gap {gap:.1f} us; host-blocking calls between the two "
          f"enqueues: {blocking or 'none'}")
    return {"idle": idle, "blocking": blocking, "wall_ms": wall_ms,
            "dev_ms": dev_ms, "span_idle": 1 - busy / span, "gap_us": gap}


def pipelined_pair(torch, K, serve, cfg, params, reqs, *, paged: bool,
                   temperature: float, launch_paths: dict) -> dict:
    """One 8a engine (dense or paged, greedy or sampled; its graphs
    captured first) serving ``reqs`` serially, then pipelined (the in-flight
    bound set between the runs, nothing in flight): streams and dispatch
    counts byte-identical, decode launches attention layers x steps in
    each mode. Greedy engines also trace two rounds in each mode
    (:func:`trace_rounds`)."""
    kind = "paged" if paged else "dense"
    label = f"8a {kind} T={temperature}"
    common = dict(max_slots=8, max_len=2048, chunk=8, device="cuda",
                  temperature=temperature, seed=3, pipeline=PIPELINE)
    eng = serve.PagedServeEngine(cfg, params, page_size=16, **common) \
        if paged else serve.ServeEngine(cfg, params, **common)
    capture_graphs(torch, eng, label)
    kernel = "flash_decode_paged" if paged else "flash_decode"
    want_layers = attention_layers(cfg)
    runs = {}
    # a first, unmeasured serial run: the engine's first prefills at each
    # prompt length are slower than the rest (seen at every engine's first
    # run on an H100)
    for mode, depth in (("warm", 0), ("serial", 0),
                        ("pipelined", PIPELINE)):
        eng.pipeline = depth
        eng.dispatch_gap_s, eng.gap_rounds, eng._t_enqueued = 0.0, 0, None
        d0, s0 = eng.decode_dispatches, eng.decode_tokens
        K.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(list(reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        steps = eng.decode_tokens - s0
        st = eng.stats()
        n_tok = sum(len(v) for v in res.values())
        check(st["in_flight"] == 0 and st["quarantined"] == 0,
              f"{label} {mode}: {st['in_flight']} rounds left in flight, "
              f"{st['quarantined']} quarantined")
        check(launches[kernel] == want_layers * steps
              and launches["kv_rows_in_decode"] == want_layers * steps,
              f"{label} {mode}: {launches[kernel]} {kernel} launches, "
              f"expected {want_layers} layers x {steps} steps")
        if paged:
            eng.check_pool()
        if mode == "warm":
            runs[mode] = ({r: v.tolist() for r, v in res.items()},
                          eng.decode_dispatches - d0)
            continue
        launch_paths[kernel][f"yi-9b {kind} {mode} T={temperature} (8a)"] \
            = launches[kernel]
        runs[mode] = ({r: v.tolist() for r, v in res.items()},
                      eng.decode_dispatches - d0)
        print(f"{label} {mode}: {len(res)} requests, {n_tok} tokens in "
              f"{wall:.2f} s = {n_tok / wall:.1f} tok/s; "
              f"{runs[mode][1]} decode dispatches ({steps} steps), "
              f"mean_dispatch_gap_s {st['mean_dispatch_gap_s']:.6f} over "
              f"{st['gap_rounds']} gaps; {kernel} launches "
              f"{launches[kernel]}; staging {st['staging']}")
    check(runs["warm"] == runs["serial"] == runs["pipelined"],
          f"{label}: pipelined streams or dispatch counts differ from "
          f"serial")
    print(f"{label}: streams and dispatch counts byte-identical "
          f"({runs['serial'][1]} dispatches)")
    out = {"eng": eng, "streams": runs["serial"][0]}
    if temperature == 0.0:
        for mode, depth in (("serial", 0), ("pipelined", PIPELINE)):
            out[mode] = trace_rounds(torch, serve, eng, reqs, depth,
                                     f"{label} {mode} trace")
        check(not out["pipelined"]["blocking"],
              f"{label}: pipelined rounds made host-blocking calls between "
              f"enqueues: {out['pipelined']['blocking']}")
        check(out["serial"]["blocking"].get("cudaStreamSynchronize", 0) > 0,
              f"{label}: the serial rounds' readback sync is not in the "
              f"profile ({out['serial']['blocking']})")
        eng.pipeline = PIPELINE
    return out


def phase_staging(torch, K, serve, cfg, eng, reqs, want: dict,
                  launch_paths: dict) -> None:
    """8b: the 16 requests through the router's ``submit`` to the
    pipelined dense engine: every admission after the first batch a staging
    hit, streams as 8a's; and one prompt's prefill logits staged and
    unstaged bit for bit."""
    from repro_torch.serve.staging import PromptStager
    from repro_torch.train import serve as TS
    label = "8b staging"
    before = dict(eng.stats()["staging"])
    router = serve.ReplicaRouter([eng], max_queue=8)
    K.reset_launches()
    res = router.run(list(reqs))
    torch.cuda.synchronize()
    launch_paths["flash_decode"]["yi-9b router pipelined (8b)"] = \
        K.LAUNCHES["flash_decode"]
    st = eng.stats()["staging"]
    hits = st["hits"] - before["hits"]
    misses = st["misses"] - before["misses"]
    check(hits + misses == len(reqs) and misses <= eng.max_slots,
          f"{label}: {hits} hits and {misses} misses over {len(reqs)} "
          f"admissions (first batch {eng.max_slots})")
    check({r: v.tolist() for r, v in res.items()} == want,
          f"{label}: the router's streams differ from 8a's")
    stager = PromptStager(device="cuda")
    prompt = reqs[0].prompt
    stager.stage("x", prompt)
    staged = stager.take("x", prompt)
    inline = torch.tensor([prompt], dtype=torch.int64, device="cuda")
    prefill = TS.make_prefill_step(cfg, cache_len=None)
    a, _ = prefill(eng.params, {"tokens": staged})
    b, _ = prefill(eng.params, {"tokens": inline})
    check(torch.equal(a.view(torch.int16), b.view(torch.int16))
          if a.dtype == torch.bfloat16 else torch.equal(a, b),
          f"{label}: staged and unstaged prefill logits differ")
    print(f"{label}: {len(reqs)} requests through the router's submit: "
          f"{hits} staging hits, {misses} misses (first batch "
          f"{eng.max_slots}); streams as 8a's; a {len(prompt)}-token "
          f"prompt's prefill logits staged and unstaged bit for bit; "
          f"flash_decode launches {K.LAUNCHES['flash_decode']}")


def phase_snapshots(torch, np, serve) -> None:
    """8c: xlstm-125m at its published width, pipelined (8 slots): its
    requests served once with no snapshot, then again with a snapshot
    offered every round (``skip_if_busy``); each round's wall time with no
    snapshot, with a write in flight and without one. The last snapshot
    restored bit for bit, and in a profiled round with a snapshot the
    params' device-to-host copies on a stream other than the decode
    kernels'."""
    import shutil
    import tempfile
    from collections import deque

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import Checkpointer
    label = "8c snapshots"
    cfg, params = fig_model(torch, "xlstm-125m", RUNTIME_SEEDS["xlstm-125m"],
                            label)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompt, new, n = SNAPSHOT_REQUESTS
    rng = np.random.default_rng(RUNTIME_SEEDS["requests"])
    reqs = [serve.Request(f"x{i}", tuple(int(t) for t in rng.integers(
        0, cfg.vocab_size, prompt)), new) for i in range(n)]
    eng = serve.ServeEngine(cfg, params, max_slots=8, max_len=2048, chunk=8,
                            device="cuda", pipeline=PIPELINE)
    capture_graphs(torch, eng, label)

    def serve_rounds(ckpt, tag):
        """(write in flight, round wall s, host s in save() or None) for
        every round of one serve of ``reqs``; a snapshot offered after
        each round when ``ckpt`` is given."""
        pending, rounds = deque(reqs), []
        while pending or any(eng.slots):
            for slot in eng.free_slots():
                if pending:
                    r = pending.popleft()
                    eng.admit(serve.Request(f"{tag}-{r.rid}", r.prompt,
                                            r.max_new_tokens), slot)
            busy = ckpt is not None and ckpt.busy()
            t0 = time.perf_counter()
            eng.step()
            wall = time.perf_counter() - t0
            save_s = None
            if ckpt is not None:
                t0 = time.perf_counter()
                if eng.snapshot(ckpt, step=len(rounds)):
                    save_s = time.perf_counter() - t0
            rounds.append((busy, wall, save_s))
        eng.sync()
        torch.cuda.synchronize()
        return rounds

    def ms(walls):
        return (f"{[round(w * 1e3, 2) for w in walls]} (median "
                + (f"{1e3 * float(np.median(walls)):.3f})" if walls
                   else "none)"))

    os.makedirs(os.path.join(HERE, "_chipcheck"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase8_ckpt_",
                            dir=os.path.join(HERE, "_chipcheck"))
    try:
        ckpt = Checkpointer(root, keep=2)
        serve_rounds(None, "warm")
        base = serve_rounds(None, "base")
        snap = serve_rounds(ckpt, "snap")
        ckpt.wait()
        saves = [s for _, _, s in snap if s is not None]
        print(f"{label}: {cfg.name} params {n_bytes / 1e9:.3f} GB; "
              f"{len(snap)} pipelined rounds, a snapshot offered after "
              f"each, {len(saves)} written, {len(snap) - len(saves)} "
              f"skipped busy; round wall ms with no snapshot "
              f"{ms([w for _, w, _ in base[1:]])}; with a write in flight "
              f"{ms([w for b, w, _ in snap[1:] if b])}; with none in "
              f"flight {ms([w for b, w, _ in snap[1:] if not b])}; host ms "
              f"in save() {[round(s * 1e3, 2) for s in saves]}")
        check(saves, f"{label}: no snapshot was written")
        step, back = ckpt.restore_latest({"params": params})
        check(step is not None, f"{label}: no snapshot committed")
        got, want = list(_leaves(back["params"])), list(_leaves(params))
        check(len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
            for a, b in zip(got, want)),
            f"{label}: step {step} did not restore bit for bit")
        print(f"{label}: step {step} restored bit for bit ({len(got)} "
              f"leaves)")
        # one profiled round with a snapshot: which streams its copies use
        for r in reqs[:2]:
            eng.admit(serve.Request(f"p-{r.rid}", r.prompt,
                                    1 + 4 * eng.chunk))
        eng.step()
        eng.sync()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            check(eng.snapshot(ckpt, step=10 ** 6),
                  f"{label}: the checkpointer was busy")
            eng.step()
            eng.sync()
            ckpt.wait()
            torch.cuda.synchronize()
        while any(eng.slots):
            eng.step()
        eng.sync()
        kernels, dtoh = set(), {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            stream = ev.device_resource_id()
            if ev.name().startswith("Memcpy DtoH"):
                dtoh[stream] = dtoh.get(stream, 0) + 1
            elif not ev.name().startswith(("Memcpy", "Memset")):
                kernels.add(stream)
        side = {s: c for s, c in dtoh.items() if s not in kernels}
        print(f"{label}: profiled round with a snapshot: kernels on "
              f"stream(s) {sorted(kernels)}; device-to-host copies by "
              f"stream {dtoh} ({len(want)} param leaves)")
        check(sum(side.values()) >= len(want) - profiler_drops(len(want)),
              f"{label}: the params' device-to-host copies are not on a "
              f"stream of their own")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del eng, params
    torch.cuda.empty_cache()


def phase_fig11(torch, K, launch_paths: dict) -> None:
    """8d: ``python -m repro_torch.bench.run --only fig11`` in process: its
    three sections and their gates on the card."""
    from repro_torch.bench import run as bench_run
    label = "8d fig11"
    t0 = time.perf_counter()
    K.reset_launches()
    rc = bench_run.main(["--only", "fig11"])
    torch.cuda.synchronize()
    check(rc == 0, f"{label}: bench.run --only fig11 exited {rc}")
    for kernel in ("flash_decode", "flash_decode_paged"):
        check(K.LAUNCHES[kernel] > 0, f"{label}: no {kernel} launch")
        launch_paths[kernel]["fig11 overlap (8d)"] = K.LAUNCHES[kernel]
    print(f"{label}: gates held; flash_decode launches "
          f"{K.LAUNCHES['flash_decode']}, flash_decode_paged "
          f"{K.LAUNCHES['flash_decode_paged']}; "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def phase_launch_serve(torch) -> None:
    """8e: ``repro_torch.launch.serve.main`` on xlstm-125m at its
    published width with ``--pipeline 2`` and a ``--plan-db`` swept here
    for ``h100`` alone: the plan a database hit, no online plan."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as LS
    from repro_torch.serve import plandb
    from repro_torch.serve.planner import plan_stats
    label = "8e launch.serve"
    batch, prompt, new = LAUNCH_CELL
    t0 = time.perf_counter()
    db = plandb.sweep(get_config("xlstm-125m"), batches=(batch,),
                      max_lens=(prompt + new,), machines=("h100",),
                      tps=(1,))
    sweep_s = time.perf_counter() - t0
    os.makedirs(os.path.join(HERE, "_chipcheck"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase8_plandb_",
                            dir=os.path.join(HERE, "_chipcheck"))
    try:
        path = os.path.join(root, "plans.json")
        db.save(path)
        rc = LS.main(["--arch", "xlstm-125m", "--batch", str(batch),
                      "--prompt-len", str(prompt), "--gen", str(new),
                      "--pipeline", str(PIPELINE), "--plan-db", path,
                      "--seed", str(RUNTIME_SEEDS["xlstm-125m"])])
        stats = plan_stats()
    finally:
        plandb.install(None)
        shutil.rmtree(root, ignore_errors=True)
    check(rc == 0, f"{label}: main exited {rc}")
    check(stats["db_hits"] > 0 and stats["online_plans"] == 0,
          f"{label}: plan stats {stats}, expected DB hits and no online "
          f"plan")
    print(f"{label}: plan db of {len(db)} entries swept for h100 in "
          f"{sweep_s:.1f} s; plan stats {stats}; "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


def phase_runtime(torch, np, K, serve) -> dict:
    """Phase 8 (8a-8e), after every earlier engine is freed. Returns the
    new paths' decode launches by kernel and path."""
    t0 = time.perf_counter()
    paths = {"flash_decode": {}, "flash_decode_paged": {}}
    cfg, params = fig_model(torch, "yi-9b", RUNTIME_SEEDS["yi-9b"], "8a",
                            layers=RUNTIME_LAYERS)
    reqs = runtime_requests(np, serve, cfg.vocab_size)
    traces = {}
    keep = None
    for paged in (False, True):
        for temperature in (0.0, 0.8):
            out = pipelined_pair(torch, K, serve, cfg, params, reqs,
                                 paged=paged, temperature=temperature,
                                 launch_paths=paths)
            if temperature == 0.0:
                traces["paged" if paged else "dense"] = out
                if not paged:
                    keep = out
                    continue
            del out["eng"]
            torch.cuda.empty_cache()
    for kind, out in traces.items():
        s_, p_ = out["serial"], out["pipelined"]
        print(f"8a {kind}: idle share serial {s_['idle']:.4f} -> pipelined "
              f"{p_['idle']:.4f}; inside the device's span "
              f"{s_['span_idle']:.4f} -> {p_['span_idle']:.4f}, largest gap "
              f"{s_['gap_us']:.1f} -> {p_['gap_us']:.1f} us; blocking calls "
              f"between enqueues serial {s_['blocking']} -> pipelined "
              f"{p_['blocking'] or 'none'}")
    phase_staging(torch, K, serve, cfg, keep["eng"], reqs,
                  keep["streams"], paths)
    del keep, traces, params
    torch.cuda.empty_cache()
    phase_snapshots(torch, np, serve)
    phase_fig11(torch, K, paths)
    phase_launch_serve(torch)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    return paths


# --- phase 9: training on the card ------------------------------------------

#: phase 9: the seeds of 9a's weights and data, 9b's runs and 9c's states
TRAIN_SEEDS = {"yi-9b": 91, "data": 92, "launch": 93, "parity": 94}
#: 9a: yi-9b's depth, batch, sequence, accumulation, steps (fp32 and int8
#: moments) and optimizer. At lr 1e-3 (warmup 2) the loss rose over the 6
#: steps (11.63 -> 15.09 ... 12.04 on an H100 80GB HBM3 at 700 W): Adam's
#: first update moves every weight by +-lr/2 alike, against init scales
#: of 0.016-0.02
TRAIN_CELL = dict(layers=4, batch=8, seq=2048, accum=2, steps=6,
                  int8_steps=3, lr=1e-4, warmup=2)
#: 9b: xlstm-125m at ``examples/train_lm.py``'s batch, sequence and lr
XLSTM_TRAIN = ["--batch", "4", "--seq", "256", "--lr", "1e-3"]
#: 9c: batch and sequence of the parity step; its tolerances: loss and
#: grad norm (relative), each gradient leaf (of its largest magnitude)
PARITY_SHAPE, PARITY_RTOL, PARITY_GRAD_TOL = (4, 32), 1e-5, 1e-4


def train_flops(cfg, M, tokens: int, batch: int, seq: int) -> tuple:
    """Model FLOPs of one training step: 6 x the matmul params (every 2-D
    or stacked weight but the embedding table) x tokens, plus causal
    attention's two products a layer, forward and backward (3 x 4 x
    B S^2 H Dh / 2). Returns ``(flops, matmul params)``."""
    n = 0
    for path, (shape, _) in M._walk(M.param_shapes(cfg)):
        if path[-1] != "tok_embed" and len(shape) >= 2 + (path[0] == "scan"):
            n += math.prod(shape)
    n_attn = sum(b.split(":")[0] in ("attn", "attn_local")
                 for b in cfg.layer_plan())
    attn = 3 * 4 * batch * seq * seq * cfg.n_heads * cfg.head_dim_eff / 2
    return 6 * n * tokens + n_attn * attn, n


def phase_train_yi(torch, np) -> None:
    """9a: yi-9b at full width, 4 layers, trained on the card."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import make_iterator
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptConfig, adamw_update
    from repro_torch.train import step as TS
    label = "9a yi-9b train"
    c = TRAIN_CELL
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=c["layers"])
    check(cfg.remat == "full", f"{label}: remat {cfg.remat!r}")
    b, s = c["batch"], c["seq"]
    shape = ShapeSpec("9a", s, b, "train")
    flops, n_mm = train_flops(cfg, M, b * s, b, s)
    torch.cuda.reset_peak_memory_stats()
    for moments, steps in (("float32", c["steps"]),
                           ("int8", c["int8_steps"])):
        oc = OptConfig(lr=c["lr"], warmup_steps=c["warmup"],
                       total_steps=c["steps"], moments_dtype=moments)
        torch.cuda.empty_cache()
        state = TS.init_train_state(cfg, torch.Generator(
            device="cuda").manual_seed(TRAIN_SEEDS["yi-9b"]), oc,
            device="cuda")
        n_params = sum(t.numel() for _, t in M._walk(state["params"]))
        step = TS.make_train_step(cfg, oc, accum_steps=c["accum"])
        it = make_iterator(cfg, shape, seed=TRAIN_SEEDS["data"],
                           device="cuda")
        losses, gnorms, walls = [], [], []
        for _ in range(steps):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check(all(math.isfinite(x) for x in losses + gnorms),
              f"{label} ({moments} moments): losses {losses}, grad norms "
              f"{gnorms}")
        ms = 1e3 * float(np.median(walls[2:]))
        print(f"{label} ({moments} moments, {n_params / 1e9:.3f} B params, "
              f"accum {c['accum']}, {b} x {s} tokens a step): losses "
              f"{[round(x, 4) for x in losses]}; grad norms "
              f"{[round(x, 3) for x in gnorms]}; ms a step "
              f"{[round(1e3 * w, 1) for w in walls]} (median from step 2 "
              f"{ms:.1f}); {b * s / ms * 1e3:.0f} tokens/s")
        if moments == "float32":
            check(float(np.mean(losses[-3:])) < losses[0],
                  f"{label}: the last 3 losses' mean "
                  f"{np.mean(losses[-3:]):.4f} is not under the first "
                  f"{losses[0]:.4f}")
            peak = torch.cuda.max_memory_allocated()
            print(f"{label}: model FLOPs a step {flops:.4g} (6 x "
                  f"{n_mm / 1e6:.1f} M matmul params x {b * s} tokens + "
                  f"causal attention), {flops / (ms * 1e-3) / 1e12:.1f} "
                  f"TFLOP/s, {flops / (ms * 1e-3) / BF16_FLOPS:.3f}"
                  f" of the {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
                  f"dense peak ({flops / BF16_FLOPS * 1e3:.1f} ms "
                  f"at the peak); max_memory_allocated "
                  f"{peak / 1e9:.2f} GB")
            state = profile_train_step(torch, step, state, next(it), label)
            # the optimizer alone, on the step's own gradient dtype (fp32
            # under accumulation)
            grads = _tree_map(lambda p: torch.randn(
                p.shape, dtype=torch.float32, device="cuda") * 1e-3,
                state["params"])
            # params and moments read and written, gradients read
            moved = sum(t.numel() * t.element_size() * n
                        for tree, n in ((state["params"], 2), (grads, 1),
                                        (state["opt"], 2))
                        for t in _leaves(tree))
            times = []
            for _ in range(4):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = adamw_update(oc, state["params"], grads, state["opt"],
                                   state["step"])
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
                del out
            bound = moved / HBM_BYTES_PER_S * 1e3
            print(f"{label}: adamw_update (fp32 moments, fp32 gradients) "
                  f"{[round(t, 2) for t in times]} ms (median of the last "
                  f"3 {float(np.median(times[1:])):.2f}) against its byte "
                  f"bound {bound:.2f} ms ({moved / 1e9:.2f} GB over "
                  f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
            del grads
        state = step = it = None
    torch.cuda.empty_cache()


def profile_train_step(torch, step, state, batch, label: str):
    """One more step under the profiler: device busy ms against the
    step's wall ms (an unprofiled pass of the same step time is 9a's
    median), device time by group (matmuls, the rest) and the five
    costliest other kernels. Returns the new state."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts: dict = {}
    by_name = device_us(prof, counts)
    matmul = {n: us for n, us in by_name.items()
              if any(t in n.lower() for t in ("gemm", "gemv", "cutlass",
                                              "sm90_", "nvjet", "matmul",
                                              "splitk"))}
    total, mm = sum(by_name.values()), sum(matmul.values())
    tags: dict = {}
    for n, us in by_name.items():
        if n not in matmul:
            t = tags.setdefault(kernel_tag(n), [0.0, 0])
            t[0] += us
            t[1] += counts[n]
    other = sorted(((us, n, k) for n, (us, k) in tags.items()),
                   reverse=True)[:8]
    print(f"{label}: one profiled step: device busy {total / 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall (idle share {1 - total / 1e6 / wall:.3f})"
          f", {sum(counts.values())} device events; matmuls "
          f"{mm / 1e3:.1f} ms ({mm / total:.3f}), the rest "
          f"{(total - mm) / 1e3:.1f} ms; the rest's costliest kernels by "
          f"operation: " + "; ".join(f"{n} {us / 1e3:.1f} ms x{k}"
                                     for us, n, k in other))
    return state


#: kernel-name words that say nothing of the operation
GENERIC_TAGS = {"Binary", "AUnary", "BUnary", "Unary", "gpu", "func_wrapper",
                "CUDA", "Reduce", "elementwise", "Load", "Cast"}


def kernel_tag(name: str) -> str:
    """A short name of the operation an ATen kernel runs, from its
    demangled name: the functor (``MulFunctor`` -> ``Mul``,
    ``CUDAFunctorOnSelf_add`` -> ``add``) or the kernel function
    (``exp_kernel_cuda`` -> ``exp``, ``direct_copy_kernel_cuda``), else
    the name up to its template arguments."""
    tags = re.findall(r"Functor(?:OnSelf|OnOther)?_(\w+?)[<>,( ]", name)
    tags += [t for t in re.findall(
        r"(\w+?)(?:Functor|_functor|_kernel_cuda|_kernel_impl)\b", name)
        if t not in GENERIC_TAGS]
    if tags:
        return tags[-1]
    return re.sub(r"^void ", "", re.sub(r"[<(].*", "", name))[-48:]


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def phase_train_launch(torch) -> None:
    """9b: ``repro_torch.launch.train.main`` on the card."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.train import step as TS
    label = "9b launch.train"

    def run(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            losses = LT.main(argv + ["--seed", str(TRAIN_SEEDS["launch"])])
        out = buf.getvalue()
        print("\n".join(f"{label}: {line}" for line in out.splitlines()))
        return losses, out, time.perf_counter() - t0

    os.makedirs(os.path.join(HERE, "_chipcheck"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase9_", dir=os.path.join(HERE,
                                                               "_chipcheck"))
    try:
        d = os.path.join(root, "resume")
        smoke = ["--arch", "yi-9b", "--smoke", "--batch", "8", "--seq",
                 "128", "--ckpt-dir", d, "--ckpt-every", "4"]
        losses, _, t_a = run(smoke + ["--steps", "8"])
        check(len(losses) == 8, f"{label}: {len(losses)} steps, not 8")
        losses, out, t_b = run(smoke + ["--steps", "10"])
        check("[restore] resumed from step 8" in out and len(losses) == 2
              and "step     8 loss" in out and "step     9 loss" in out,
              f"{label}: the resume did not run steps 8-9")
        d = os.path.join(root, "compress")
        losses, _, t_c = run(["--arch", "yi-9b", "--smoke", "--batch", "8",
                              "--seq", "128", "--steps", "4", "--compress",
                              "--ckpt-dir", d])
        like = TS.init_train_state(get_smoke_config("yi-9b"),
                                   torch.Generator(device="cuda"),
                                   device="cuda")
        like["resid"] = like["params"]
        got, st = Checkpointer(d).restore_latest(like)
        resid = sum(float(r.abs().sum()) for _, r in M._walk(st["resid"]))
        check(got == 4 and resid > 0,
              f"{label}: compress checkpoint at {got}, |resid| {resid}")
        print(f"{label}: smoke runs {t_a:.1f} + {t_b:.1f} s; --compress "
              f"{t_c:.1f} s, sum |resid| after 4 steps {resid:.6g}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses, out, t_x = run(["--arch", "xlstm-125m", "--steps", "2"]
                           + XLSTM_TRAIN)
    check(len(losses) == 2, f"{label}: xlstm-125m ran {len(losses)} steps")
    args = " ".join(XLSTM_TRAIN)
    print(f"{label}: xlstm-125m at full width and depth ({args}): losses "
          f"{losses} (not held to fall: the reference's gradient blows up "
          f"at this width too); {t_x:.1f} s")
    torch.cuda.empty_cache()


def phase_train_parity(torch, np) -> None:
    """9c: one training step of each smoke config on the card and on the
    host from the same state and batch (fp32)."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM, host_batch, to_device
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as TS
    label = "9c train parity"
    b, s = PARITY_SHAPE
    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  param_dtype="float32")
        accum = 2 if arch in ("yi-9b", "qwen2-vl-7b") else 1
        oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        host = TS.init_train_state(cfg, torch.Generator().manual_seed(
            TRAIN_SEEDS["parity"]), oc, device="cpu")
        card = _tree_map(lambda t: t.to("cuda"), host)
        nb = host_batch(cfg, ShapeSpec("9c", s, b, "train"), SyntheticLM(
            cfg.vocab_size, s, TRAIN_SEEDS["parity"]), 0)
        out = {}
        for dev, st in (("cpu", host), ("cuda", card)):
            batch = to_device(cfg, nb, dev)
            _, grads = TS.value_and_grad(TS.make_loss_fn(cfg))(
                st["params"], batch)
            _, m = TS.make_train_step(cfg, oc, accum)(st, batch)
            out[dev] = (grads, float(m["loss"]), float(m["grad_norm"]))
        (gh, lh, nh), (gc, lc, nc) = out["cpu"], out["cuda"]
        rel = max(abs(lc / lh - 1), abs(nc / nh - 1))
        check(rel <= PARITY_RTOL, f"{label} {arch}: loss {lc} / {lh}, grad "
              f"norm {nc} / {nh} (tolerance {PARITY_RTOL} relative)")
        leaf = 0.0
        for (path, a), (_, w) in zip(M._walk(gc), M._walk(gh)):
            scale = float(w.abs().max())
            err = float((a.cpu() - w).abs().max()) / max(scale, 1e-30)
            check(err <= PARITY_GRAD_TOL, f"{label} {arch}: gradient "
                  f"{'/'.join(path)} {err:.3g} of its largest magnitude "
                  f"(tolerance {PARITY_GRAD_TOL})")
            leaf = max(leaf, err)
        worst[arch] = (rel, leaf)
        print(f"{label} {arch} (accum {accum}): loss {lc:.7f} card / "
              f"{lh:.7f} host, grad norm {nc:.6f} / {nh:.6f}, relative "
              f"{rel:.3g}; worst gradient leaf {leaf:.3g} of its largest "
              f"magnitude")
    torch.cuda.empty_cache()


def phase_training(torch, np, K) -> None:
    """Phase 9: 9a-9c, the launch counts zeroed before and read after."""
    t0 = time.perf_counter()
    K.reset_launches()
    phase_train_yi(torch, np)
    phase_train_launch(torch)
    phase_train_parity(torch, np)
    launched = {n: c for n, c in K.LAUNCHES.items() if c}
    check(not launched, f"phase 9: the training path launched {launched}")
    print("phase 9: the training path launched no hand-written kernel "
          "(launch counts all 0)")
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")



# --- phase 10: meshes and tensor-parallel serving ----------------------------

#: phase 10: the seeds of yi-9b's weights, the served requests and the
#: prompts of the first decode step's logits
MESH_SEEDS = {"yi-9b": 101, "requests": 102, "prompts": 103}
#: the served cell: slots, requests, prompt lengths [low, high), new
#: tokens a request, chunk, the slot horizon and the paged engine's page
MESH_CELL = dict(slots=8, n=8, prompt=(128, 257), new=32, chunk=8,
                 max_len=384, page=16)
#: 10b: the ranks' time limit (their spawn, CUDA start, the weights, both
#: jobs) and yi-9b's depth in fp32
MESH_TP_TIMEOUT = 420
MESH_FP32_LAYERS = 4
#: yi-9b's depth in bf16 in 10a, 10b and 11c: 16 of its 48 layers (all
#: 48 until phase 12 came; cut so that the script stays near 1000 s)
MESH_BF16_LAYERS = 16
#: 10b: GB a rank may hold on the card between jobs (the mesh, the
#: kernels' split counters), so that each job's peak is its own
MESH_HELD_GB = 0.5
#: 10b's held limits, as max |logit difference| over max |logit| of the
#: first decode step (8 prompts of 128 tokens, greedy), TP=2 against the
#: unsharded engine's weights and prompts.
#: bf16, 16 layers: the unsharded out-projection and down-projection each
#: accumulate one product in fp32 and round once to bf16; at TP=2 each
#: rank rounds its half-sum to bf16 and the all-reduce rounds their sum
#: again, so every one of the 32 row-parallel products a step differs by
#: up to about one bf16 ulp (2**-8 relative) on most of its elements,
#: where the kernels-vs-plain comparison of phase 5 (0.0204 and 0.0236 on
#: an H100, limit 5e-2) differs only where a sum straddles a rounding
#: boundary. Held at twice that limit; the streams are counted, not held
#: (a flip at a near tie parts a greedy stream for good).
MESH_BF16_REL_TOL = 0.1
#: fp32, 4 layers: the same sums in fp32 (2**-24 relative) in another
#: order, 8 row-parallel products deep: ~1e-6; streams held identical
MESH_FP32_REL_TOL = 1e-4


def mesh_requests(np, serve, vocab: int) -> list:
    """Phase 10's 8 requests: 128-256-token prompts, 32 new tokens each."""
    rng = np.random.default_rng(MESH_SEEDS["requests"])
    lens = rng.integers(*MESH_CELL["prompt"], size=MESH_CELL["n"])
    return [serve.Request(f"m{i}", tuple(int(t) for t in rng.integers(
        0, vocab, n)), MESH_CELL["new"]) for i, n in enumerate(lens)]


def mesh_prompts(torch, vocab: int):
    g = torch.Generator().manual_seed(MESH_SEEDS["prompts"])
    return torch.randint(0, vocab, (MESH_CELL["slots"], 128), generator=g)


def mesh_config(dtype: str, layers: int | None = None):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("yi-9b"), param_dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def mesh_params(torch, cfg, mesh=None):
    """yi-9b's weights from ``MESH_SEEDS``; with a ``mesh`` each rank
    keeps its shard of every leaf as it is made."""
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as shd
    place = None if mesh is None else shd.placer(mesh, M.param_pspecs(
        cfg, shd.SERVE_ENGINE_RULES, shd.mesh_axis_sizes(mesh)))
    gen = torch.Generator(device="cuda").manual_seed(MESH_SEEDS["yi-9b"])
    return M.init_params(cfg, gen, device="cuda", place=place)


def first_step_logits(torch, cfg, params, prompts, mesh=None):
    """The logits (fp32, on the host) of one decode step after a batched
    prefill of ``prompts``, its token the prefill's greedy pick."""
    import contextlib
    from repro_torch.models import model as M
    from repro_torch.serve.engine import kv_bucket
    from repro_torch.train import serve as serve_lib
    from repro_torch.utils import sharding as shd
    b, s = prompts.shape
    ctx = contextlib.nullcontext() if mesh is None else \
        shd.use_mesh_rules(mesh, shd.SERVE_ENGINE_RULES)
    with ctx:
        logits, cache = serve_lib.make_prefill_step(
            cfg, cache_len=MESH_CELL["max_len"])(
                params, {"tokens": prompts.cuda()})
        tok = logits[:, -1].argmax(-1)[:, None]
        pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
        lg, _, _ = M.forward(cfg, params, {"tokens": tok}, mode="decode",
                             cache=cache, pos=pos,
                             kv_len=kv_bucket(s + 1, MESH_CELL["max_len"]))
    return lg[:, 0].float().cpu()


def collectives_per_step(torch, eng) -> tuple:
    """The collectives of one eager decode step of ``eng`` (a one-token
    chunk of its body, on its cache after its run: rows it rewrites
    before any token reads them) as ``CommDebugMode`` counts them; and by
    op."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.serve.engine import KV_BUCKET
    chunk = eng.chunk
    eng.set_chunk(1)
    inputs = {k: torch.from_numpy(v).cuda()
              for k, v in eng._step_inputs().items()}
    with CommDebugMode() as cm:
        eng._body(eng.params, eng.cache, kv_len=KV_BUCKET, **inputs)
    torch.cuda.synchronize()
    eng.set_chunk(chunk)
    total = cm.get_total_counts()
    by_op = {k._qualified_op_name: n for k, n in
             cm.get_comm_counts().items() if n}
    check(sum(by_op.values()) == total,
          f"collectives by op {by_op} do not sum to the total {total}")
    return total, by_op


def serve_mesh(torch, K, serve, cfg, params, reqs, *, paged: bool, mesh,
               label: str, cuda_graphs: bool = True) -> dict:
    """Serve ``reqs`` through an 8-slot engine (``MESH_CELL``), its graphs
    captured first, launch counts zeroed just before the run and read
    just after; fails unless every request got its tokens and every
    decode launch was the layout's fused kernel (attention layers x
    steps). Returns streams, launches, ms a step and the engine."""
    import numpy as np
    c = MESH_CELL
    kw = dict(max_slots=c["slots"], max_len=c["max_len"], chunk=c["chunk"],
              device="cuda", mesh=mesh, cuda_graphs=cuda_graphs)
    eng = serve.PagedServeEngine(cfg, params, page_size=c["page"], **kw) \
        if paged else serve.ServeEngine(cfg, params, **kw)
    if eng.graphs is not None:
        capture_graphs(torch, eng, label)
    K.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    st = eng.stats()
    steps = st["decode_tokens"]
    check(sorted(res) == sorted(r.rid for r in reqs)
          and all(len(res[r.rid]) == r.max_new_tokens for r in reqs)
          and st["quarantined"] == 0,
          f"{label}: not every request got its tokens")
    kern = "flash_decode_paged" if paged else "flash_decode"
    want = attention_layers(cfg) * steps
    check(launches[kern] == want and launches["kv_rows_in_decode"] == want,
          f"{label}: launches {launches}, expected {kern} {want}")
    ms = st["decode_s"] / steps * 1e3
    print(f"{label}: {len(res)} requests in {wall:.2f} s; decode "
          f"{st['decode_s']:.2f} s over {steps} steps = {ms:.2f} ms/step, "
          f"prefill {st['prefill_s']:.2f} s; {kern} launches {launches[kern]}"
          f" (= {attention_layers(cfg)} layers x {steps} steps)")
    return {"streams": {r: np.asarray(t, np.int32).tolist()
                        for r, t in res.items()},
            "launches": launches[kern], "ms": ms, "eng": eng}


def phase_mesh_world1(torch, np, K, serve, paths: dict) -> tuple:
    """10a: a world of one over NCCL, mesh (1,1), yi-9b at its published
    width (``MESH_BF16_LAYERS`` layers, bf16), dense and paged, against
    mesh=None on the same weights and requests (CUDA graphs on). Returns
    the unsharded streams and first-step logits (10b's reference)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serve_mesh
    cfg = mesh_config("bfloat16", MESH_BF16_LAYERS)
    t0 = time.perf_counter()
    params = mesh_params(torch, cfg)
    torch.cuda.synchronize()
    print(f"10a: yi-9b at its published width ({cfg.n_layers} layers, "
          f"bf16), init {time.perf_counter() - t0:.1f} s")
    reqs = mesh_requests(np, serve, cfg.vocab_size)
    mesh = make_serve_mesh("data,model=1,1")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "10a: the world is not one NCCL rank")
    out = {}
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        base = serve_mesh(torch, K, serve, cfg, params, reqs, paged=paged,
                          mesh=None, label=f"10a {kind} mesh=None")
        del base["eng"]
        got = serve_mesh(torch, K, serve, cfg, params, reqs, paged=paged,
                         mesh=mesh, label=f"10a {kind} mesh (1,1)")
        n_coll, kinds = collectives_per_step(torch, got["eng"])
        del got["eng"]
        torch.cuda.empty_cache()
        differ = [r for r in base["streams"]
                  if base["streams"][r] != got["streams"][r]]
        check(not differ, f"10a {kind}: mesh (1,1) streams differ from "
                          f"mesh=None: {differ}")
        print(f"10a {kind}: {len(reqs)} greedy streams identical, mesh (1,1)"
              f" vs mesh=None; {got['ms']:.3f} vs {base['ms']:.3f} ms/step "
              f"({got['ms'] / base['ms']:.3f}x); collectives a step "
              f"(CommDebugMode, one eager chunk) {n_coll:g} {kinds or ''}")
        kern = "flash_decode_paged" if paged else "flash_decode"
        paths[kern][f"yi-9b {kind} engine, mesh (1,1)"] = got["launches"]
        out[kind] = base["streams"]
    logits = first_step_logits(torch, cfg, params, mesh_prompts(
        torch, cfg.vocab_size))
    dist.destroy_process_group()
    del params
    torch.cuda.empty_cache()
    return out, logits


def _tp_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of 10b: a (1, 2) mesh over gloo on ``cuda:0`` (the world
    from the environment ``torchrun`` would set, its store on this
    host); its shard of each job's weights made leaf by leaf; the first
    step's logits and an eager engine run a job, written under
    ``out_dir``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K, serve
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh((1, 2), device_type="cuda", backend="gloo")
    res = {"graphs_refused": gloo_graphs_refused(torch, serve, mesh)}
    for job, (dtype, layers, layouts) in MESH_TP_JOBS.items():
        cfg = mesh_config(dtype, layers)
        # nothing of the last job may stay on the card, or its bytes
        # would count in this job's peak
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 1e9
        check(held < MESH_HELD_GB, f"10b {job}: {held:.2f} GB still held "
                                   "on the card before the job")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = mesh_params(torch, cfg, mesh)
        torch.cuda.synchronize()
        rec = {"init_s": time.perf_counter() - t0, "held_gb": held,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        logits = first_step_logits(torch, cfg, params, mesh_prompts(
            torch, cfg.vocab_size), mesh)
        if rank == 0:
            torch.save(logits, os.path.join(out_dir, f"{job}.logits.pt"))
        reqs = mesh_requests(np, serve, cfg.vocab_size)
        for paged in layouts:
            kind = "paged" if paged else "dense"
            got = serve_mesh(torch, K, serve, cfg, params, reqs, paged=paged,
                             mesh=mesh, cuda_graphs=False,
                             label=f"10b {job} {kind} TP=2 rank {rank}")
            n_coll, kinds = collectives_per_step(torch, got.pop("eng"))
            rec[kind] = dict(got, collectives=n_coll, kinds=kinds,
                             tp=2)
        res[job] = rec
        del params
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def gloo_graphs_refused(torch, serve, mesh) -> str:
    """The ``ValueError`` an engine raises when asked for CUDA graphs over
    ``mesh``'s gloo group (checked before any weight is placed); fails
    if it serves instead."""
    cfg = mesh_config("float32", 1)
    params = {"final_norm": torch.ones(cfg.d_model, device="cuda")}
    try:
        serve.ServeEngine(cfg, params, max_slots=MESH_CELL["slots"],
                          max_len=MESH_CELL["max_len"],
                          chunk=MESH_CELL["chunk"], device="cuda",
                          mesh=mesh, cuda_graphs=True)
    except ValueError as e:
        if "gloo" not in str(e):
            raise
        return str(e)
    raise PhaseError("10b: an engine over a gloo group took cuda_graphs="
                     "True instead of refusing it")


#: 10b's jobs: dtype, depth and layouts (paged?)
MESH_TP_JOBS = {"bf16": ("bfloat16", MESH_BF16_LAYERS, (False,)),
                "fp32": ("float32", MESH_FP32_LAYERS, (False, True))}


def phase_mesh_tp2(torch, np, K, serve, ref_streams: dict, ref_logits,
                   paths: dict) -> None:
    """10b: TP=2 as two ranks on the one card over gloo, eager (a gloo
    group cannot be captured), each job's streams and first-step logits
    against the unsharded engine on the same weights, the ranks' streams
    against each other."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    cfg32 = mesh_config("float32", MESH_FP32_LAYERS)
    reqs = mesh_requests(np, serve, cfg32.vocab_size)
    params = mesh_params(torch, cfg32)
    ref = {"bf16": ({"dense": ref_streams["dense"]}, ref_logits)}
    ref32 = {}
    for paged in (False, True):
        got = serve_mesh(torch, K, serve, cfg32, params, reqs,
                         paged=paged, mesh=None, cuda_graphs=False,
                         label=f"10b fp32 {'paged' if paged else 'dense'} "
                               f"mesh=None")
        ref32["paged" if paged else "dense"] = got["streams"]
        del got
    ref["fp32"] = (ref32, first_step_logits(torch, cfg32, params,
                                            mesh_prompts(torch,
                                                         cfg32.vocab_size)))
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_tp_rank, args=(port, tmp), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TP_TIMEOUT
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise PhaseError(f"10b: the two ranks ran past "
                                 f"{MESH_TP_TIMEOUT} s")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        logits = {job: torch.load(os.path.join(tmp, f"{job}.logits.pt"))
                  for job in MESH_TP_JOBS}
    print(f"10b: two ranks (gloo, cuda:0) ran in "
          f"{time.perf_counter() - t0:.1f} s; cuda_graphs=True refused: "
          f"{ranks[0]['graphs_refused']}")
    for job, (want_streams, want_logits) in ref.items():
        rec, other = ranks[0][job], ranks[1][job]
        rel = float((logits[job] - want_logits).abs().max()
                    / want_logits.abs().max())
        tol = MESH_BF16_REL_TOL if job == "bf16" else MESH_FP32_REL_TOL
        print(f"10b {job}: rank 0 weights init {rec['init_s']:.1f} s, "
              f"{rec['held_gb']:.3f} GB held before the job, peak "
              f"{rec['peak_gb']:.2f} GB a rank; first decode step max "
              f"|dlogit|/max|logit| TP=2 vs unsharded {rel:.3e} (held "
              f"under {tol:g})")
        check(rel <= tol, f"10b {job}: logits {rel:.3e} over {tol:g}")
        for kind, want in want_streams.items():
            got = rec[kind]
            check(got["streams"] == other[kind]["streams"],
                  f"10b {job} {kind}: the two ranks' streams differ")
            same = sum(got["streams"][r] == want[r] for r in want)
            print(f"10b {job} {kind}: {same}/{len(want)} greedy streams "
                  f"identical to the unsharded engine's; ranks agree; "
                  f"{got['ms']:.2f} ms/step eager; collectives a step "
                  f"{got['collectives']:g} {got['kinds']}")
            if job == "fp32":
                check(same == len(want), f"10b fp32 {kind}: {len(want) - same}"
                                         f" streams differ from unsharded")
            kern = "flash_decode_paged" if kind == "paged" else "flash_decode"
            paths[kern][f"yi-9b {kind} engine {job}, TP=2 rank 0"] = \
                got["launches"]


def phase_mesh(torch, np, K, serve) -> dict:
    """Phase 10 (10a, 10b), after phase 9. Returns the mesh paths' decode
    launches by kernel and path."""
    t0 = time.perf_counter()
    paths = {"flash_decode": {}, "flash_decode_paged": {}}
    ref_streams, ref_logits = phase_mesh_world1(torch, np, K, serve, paths)
    phase_mesh_tp2(torch, np, K, serve, ref_streams, ref_logits, paths)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# Phase 11: the dry run on fake process groups, held against the card
# ---------------------------------------------------------------------------

#: 11a: full-width cells (arch, shape, multi-pod, serve variant), each
#: lowered by ``python -m repro_torch.launch.dryrun`` in a process of its
#: own (a process holds one fake world), all at once
DRYRUN_CELLS = (("yi-9b", "train_4k", False, "resident2d"),
                ("yi-9b", "prefill_32k", False, "resident2d"),
                ("yi-9b", "decode_32k", False, "resident2d"),
                ("qwen1.5-110b", "decode_32k", False, "gather"),
                ("qwen1.5-110b", "decode_32k", False, "resident2d"),
                ("yi-9b", "train_4k", True, "resident2d"),
                ("jamba-v0.1-52b", "train_4k", False, "resident2d"),
                ("qwen3-moe-235b-a22b", "decode_32k", False, "resident2d"))
#: every phase-11 child's time limit, from its start
DRYRUN_TIMEOUT = 600
CARD_GB = 80.0
#: 11b: yi-9b's decode step lowered at mesh (1,1) (a fake world of one)
#: and run on the card: slots, cache rows, the slots' position
DRYRUN_STEP = dict(slots=8, rows=2048, pos=1500)
#: the caching allocator rounds each block up to 512 bytes
ALLOC_ROUND = 512
#: 11c: the sequence-sharded decode jobs (name, dtype, depth, decode
#: steps) and the yi-9b train step at (1,2) (layers, batch, sequence)
SEQ_JOBS = (("fp32", "float32", 4, 16),
            ("bf16", "bfloat16", MESH_BF16_LAYERS, 1))
MESH_TRAIN = dict(layers=2, batch=4, seq=256)
MESH_TRAIN_OPT = dict(lr=1e-3, warmup_steps=1)
PHASE11_SEEDS = {"step": 111, "seq": 112, "train": 113, "data": 114}
#: 11c's held limits. The sequence-sharded decode in fp32: each rank's
#: partials over its half of the rows, merged by log-sum-exp across the
#: ranks, against the kernel's merge of its splits over all rows, beside
#: TP=2's row-parallel sums: sums in another order (~1e-6 relative of
#: the largest logit). Held: the logits of every step that both runs
#: computed from the same tokens within this (all steps of a stream
#: that stays identical to mesh=None's; those up to and including its
#: parting step of one that parts); a stream may part only where
#: mesh=None's top two logits stood within twice that step's max|dlogit|
#: of each other (a tie that the two sums' rounding flipped; counted and
#: printed). bf16: the first step's
#: logits as 10b holds its (MESH_BF16_REL_TOL's reasoning: the
#: row-parallel products round once more a rank).
SEQ_FP32_REL_TOL = 1e-4
#: the train step: loss and grad norm within 1e-5 relative (fp32 sums in
#: another order); a parameter within 1e-5 of its leaf's largest plus
#: 1 % of lr of mesh=None's, but where a gradient near 0 flipped sign
#: (AdamW's update is ~lr whatever the gradient's size): at most 1 % of
#: a leaf's elements, each within 2 lr more
MESH_TRAIN_RTOL = 1e-5


def dryrun_children(tmp: str) -> dict:
    """Start every phase-11 lowering at once: 11a's cells through the
    CLI, 11b's two steps from ``python -c``. Returns ``{name: Popen}``;
    their records land in ``tmp``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {}
    for arch, shape, mp, variant in DRYRUN_CELLS:
        tag = dryrun_tag(arch, shape, mp, variant)
        if variant == "gather":
            argv = [sys.executable, "-c", DRYRUN_GATHER_CODE.format(
                src=SRC, arch=arch, shape=shape, mp=mp,
                out=os.path.join(tmp, tag + ".json"))]
        else:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--out", tmp] + (
                        ["--multi-pod"] if mp else [])
        procs[tag] = subprocess.Popen(argv, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE)
    for name, code in (("step11", DRYRUN_STEP_CODE),
                       ("step12", DRYRUN_TP2_CODE)):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code.format(
                src=SRC, out=os.path.join(tmp, f"{name}.json"),
                slots=DRYRUN_STEP["slots"], rows=DRYRUN_STEP["rows"],
                mesh_rows=MESH_CELL["max_len"])],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    return procs


def dryrun_tag(arch: str, shape: str, mp: bool, variant: str) -> str:
    """An 11a record's name: the CLI's ``<arch>_<shape>_<sp|mp>``, and
    ``_gather`` for the weight-gather serve rules."""
    return f"{arch}_{shape}_{'mp' if mp else 'sp'}" + (
        "_gather" if variant == "gather" else "")


#: 11a: a cell under the weight-gather serve rules (``run_cell``'s
#: ``serve_variant``; the CLI lowers the reference's resident 2-D rules)
DRYRUN_GATHER_CODE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch import dryrun as D
rec = D.run_cell({arch!r}, {shape!r}, multi_pod={mp!r}, serve_variant="gather")
json.dump(rec, open({out!r}, "w"))
"""

#: 11b: yi-9b's decode step at mesh (1,1), a fake world of one
DRYRUN_STEP_CODE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
mesh = make_test_mesh((1, 1), fake=True)
rec = D.run_cell("yi-9b", "decode_2k", cfg=get_config("yi-9b"), mesh=mesh,
                 shape=ShapeSpec("decode_2k", {rows}, {slots}, "decode"))
json.dump(rec, open({out!r}, "w"))
"""

#: 11b: 10b's TP=2 decode step (the engines' rules, logits gathered whole)
#: at mesh (1,2), a fake world of two
DRYRUN_TP2_CODE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.utils import sharding as S
mesh = make_test_mesh((1, 2), fake=True)
rec = D.run_cell("yi-9b", "decode_mesh", cfg=get_config("yi-9b"), mesh=mesh,
                 shape=ShapeSpec("decode_mesh", {mesh_rows}, {slots}, "decode"),
                 rules=S.SERVE_ENGINE_RULES, gather_logits=True)
json.dump(rec, open({out!r}, "w"))
"""


def child_result(p, name: str, deadline: float) -> str:
    """A phase-11 child's standard output by ``deadline``; fails if it
    hangs (killed) or exits non-zero."""
    try:
        out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise PhaseError(f"11: {name} ran past {DRYRUN_TIMEOUT} s")
    check(p.returncode == 0, f"11: {name} exited {p.returncode}: "
                             f"{err[-2000:]}")
    return out


def print_roofline(rec: dict, label: str) -> None:
    """The ``h100`` roofline of a record: its terms and dominant term."""
    from repro_torch.bench.roofline_sweep import report_of
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.core import roofline
    from repro_torch.core.machine import MACHINES
    c = roofline.analyze_cell(rec, get_config(rec["arch"]),
                              SHAPES[rec["shape"]], machine=MACHINES["h100"],
                              report=report_of(rec["portmodel"]))
    print(f"11a {label} h100 roofline: T_comp {c.t_compute*1e3:.2f} ms, "
          f"T_comp(port) {c.t_compute_port*1e3:.2f} ms, T_mem "
          f"{c.t_memory*1e3:.2f} ms, T_coll {c.t_collective*1e3:.2f} ms; "
          f"dominant {c.dominant}; useful {c.useful_ratio:.2f}, peak "
          f"fraction {c.peak_fraction:.3f}")


def phase_dryrun_records(procs: dict, tmp: str, deadline: float) -> None:
    """11a: the full-width records, each with its lowering time: peak GB a
    rank against the card's 80 GB, FLOPs a rank, collectives by kind
    with their bytes, the ``h100`` roofline."""
    for arch, shape, mp, variant in DRYRUN_CELLS:
        tag = dryrun_tag(arch, shape, mp, variant)
        child_result(procs.pop(tag), tag, deadline)
        with open(os.path.join(tmp, tag + ".json")) as f:
            rec = json.load(f)
        m = rec["memory"]
        check(rec["device_type"] == "cuda" and rec["n_devices"] ==
              (512 if mp else 256), f"11a {tag}: mesh {rec['mesh']} on "
                                    f"{rec['device_type']}")
        check(sum(v["count"] for v in rec["collectives"].values()) > 0,
              f"11a {tag}: no collectives")
        coll = "; ".join(
            f"{k} {v['count']:g} x, {v['bytes']/1e9:.3f} GB (groups "
            f"{v['groups']})" for k, v in sorted(rec["collectives"].items()))
        print(f"11a {tag} ({rec['mesh']}, rules {rec['rules']}): lowered in "
              f"{rec['lower_s']} s; peak {m['peak_bytes']/1e9:.2f} GB a rank "
              f"of the card's {CARD_GB:.0f} GB (arguments "
              f"{m['argument_bytes']/1e9:.2f}); FLOPs a rank "
              f"{rec['cost']['flops']:.4e}; {coll}")
        print_roofline(rec, tag)


def step_args(torch, cfg, M):
    """11b's decode step on the card: yi-9b's weights from the phase's
    seed, a zero cache of ``DRYRUN_STEP``'s slots and rows, a token a
    slot and the slots' position (the lowered step's arguments)."""
    c = DRYRUN_STEP
    gen = torch.Generator(device="cuda").manual_seed(PHASE11_SEEDS["step"])
    params = M.init_params(cfg, gen, device="cuda")
    cache = M.init_cache(cfg, c["slots"], c["rows"], device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (c["slots"], 1), device="cuda",
                        generator=gen, dtype=torch.int32)
    pos = torch.tensor(c["pos"], dtype=torch.int32, device="cuda")
    return params, cache, {"tokens": tok}, pos


def phase_dryrun_card(torch, procs: dict, tmp: str, deadline: float) -> None:
    """11b: the (1,1) record of yi-9b's decode step against the same step
    on the card: its argument bytes against the allocator's growth from
    placing them, its matrix-product FLOPs outside the kernel regions
    against ``FlopCounterMode`` over the step, its peak against the
    card's; then 10b's TP=2 step lowered at (1,2): its collectives by
    kind against what 10b counted on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import serve as serve_lib
    cfg = get_config("yi-9b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = step_args(torch, cfg, M)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated() - base
    n_leaves = len(list(_leaves({"params": args[0], "cache": args[1],
                                 "batch": args[2]}))) + 1     # and pos
    torch.cuda.reset_peak_memory_stats()
    step = serve_lib.make_decode_step(cfg)
    step(*args)                      # warm: the kernels' first launch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    card_flops = fc.get_total_flops()
    card_peak = torch.cuda.max_memory_allocated() - base
    child_result(procs.pop("step11"), "step11", deadline)
    with open(os.path.join(tmp, "step11.json")) as f:
        rec = json.load(f)
    m, cost = rec["memory"], rec["cost"]
    print(f"11b yi-9b decode step ({DRYRUN_STEP['slots']} slots, "
          f"{DRYRUN_STEP['rows']} rows, mesh (1,1), lowered in "
          f"{rec['lower_s']} s): argument_bytes {m['argument_bytes']} against "
          f"the card's memory_allocated growth {placed} from placing its "
          f"{n_leaves} tensors (held within {n_leaves} x {ALLOC_ROUND} B of "
          f"the allocator's rounding); matmul FLOPs outside the kernels "
          f"{cost['matmul_flops_outside_kernels']:.6e} against "
          f"FlopCounterMode {card_flops:.6e}; peak_bytes "
          f"{m['peak_bytes']} against max_memory_allocated growth "
          f"{card_peak} ({m['peak_bytes'] / max(card_peak, 1):.3f}x)")
    check(0 <= placed - m["argument_bytes"] <= n_leaves * ALLOC_ROUND,
          f"11b: argument_bytes {m['argument_bytes']} vs placed {placed}")
    check(cost["matmul_flops_outside_kernels"] == card_flops,
          f"11b: FLOPs {cost['matmul_flops_outside_kernels']} vs the "
          f"card's {card_flops}")
    del args, step
    gc.collect()
    torch.cuda.empty_cache()
    child_result(procs.pop("step12"), "step12", deadline)
    with open(os.path.join(tmp, "step12.json")) as f:
        rec = json.load(f)
    kinds = {k: v["count"] for k, v in rec["collectives"].items()}
    print(f"11b 10b's TP=2 decode step lowered at (1,2) "
          f"({rec['lower_s']} s): collectives {kinds} (groups "
          f"{ {k: v['groups'] for k, v in rec['collectives'].items()} })")
    want = {"all-reduce": 2 * cfg.n_layers + 1, "all-gather": 1}
    check(kinds == want, f"11b: (1,2) collectives {kinds}, 10b counts "
                         f"{want} on the card")


def seq_params(torch, cfg, mesh, seed: int):
    """yi-9b's weights from ``seed``; with a ``mesh`` each rank keeps its
    shard of every leaf under ``SERVE_RULES``."""
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as shd
    place = None if mesh is None else shd.placer(mesh, M.param_pspecs(
        cfg, shd.SERVE_RULES, shd.mesh_axis_sizes(mesh)))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return M.init_params(cfg, gen, device="cuda", place=place)


def seq_decode(torch, cfg, params, n_new: int, mesh=None, K=None,
               first=None):
    """Greedy streams of ``mesh_prompts`` (prefill at 384 rows, then
    ``n_new`` decode steps; ``first``, when given, the token a slot's
    first step decodes instead of the prefill's pick), the prefill's
    last-position logits and each step's (fp32, on the host), and the
    decode kernels' launches over the decode steps (counts zeroed just
    before them). Under ``mesh`` the cache is sharded on its rows
    (``SERVE_RULES``)."""
    import contextlib
    from repro_torch.train import serve as serve_lib
    from repro_torch.utils import sharding as shd
    prompts = mesh_prompts(torch, cfg.vocab_size).cuda()
    b, s = prompts.shape
    ctx = contextlib.nullcontext() if mesh is None else \
        shd.use_mesh_rules(mesh, shd.SERVE_RULES)
    with ctx:
        logits, cache = serve_lib.make_prefill_step(
            cfg, cache_len=MESH_CELL["max_len"])(params, {"tokens": prompts})
        if mesh is not None:
            pl = cache["scan"]["0"]["k"].placements
            check(any(p.is_shard() and p.dim == 2 for p in pl),
                  f"11c: the cache is not sharded on its rows: {pl}")
        pre = logits[:, -1].float().cpu()
        tok = logits[:, -1].argmax(-1)[:, None] if first is None \
            else first.cuda()
        pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
        step = serve_lib.make_decode_step(cfg)
        toks, steps = [tok], []
        if K is not None:
            K.reset_launches()
        for _ in range(n_new):
            lg, cache = step(params, cache, {"tokens": tok}, pos)
            steps.append(lg.float().cpu())
            tok = lg.argmax(-1)[:, None]
            toks.append(tok)
            pos = pos + 1
        torch.cuda.synchronize()
        launches = None if K is None else dict(K.LAUNCHES)
    return (torch.cat(toks, 1).cpu().tolist(), pre, torch.stack(steps),
            launches)


def stream_partings(got: list, want: list, got_lg, want_lg) -> list:
    """Where each stream of ``got`` first parts from ``want``: ``(slot,
    token, mesh=None's top-2 logit gap there, max |dlogit| there)``,
    each of the largest logit; ``*_lg`` are the logits each token was
    picked from (the prefill's, then each step's: ``(tokens, B, V)``),
    the two runs fed the same tokens up to the parting. A parting is a
    tie when that gap is within twice the max |dlogit| there."""
    out = []
    for b, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        t = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
        ref = want_lg[t, b]
        top = ref.topk(2).values
        scale = float(ref.abs().max())
        out.append((b, t, float(top[0] - top[1]) / scale,
                    float((got_lg[t, b] - ref).abs().max()) / scale))
    return out


def shared_step_err(got: list, want: list, got_lg, want_lg) -> float:
    """max |dlogit| / max |logit| (of mesh=None's logits, a slot and step
    at a time) over every step whose logits both runs computed from the
    same tokens: every step of a stream identical to ``want``'s, those
    up to and including the parting step of one that parts (``*_lg`` as
    :func:`stream_partings` takes them)."""
    worst = 0.0
    for b, (g, w) in enumerate(zip(got, want)):
        n = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y),
                 len(w) - 1) + 1
        ref = want_lg[:n, b]
        err = (got_lg[:n, b] - ref).abs().amax(-1) / ref.abs().amax(-1)
        worst = max(worst, float(err.max()))
    return worst


def mesh_train_cell(torch, cfg, mesh=None):
    """11c's train step: yi-9b's state from the phase's seed, one batch,
    one AdamW step; under ``mesh`` (``TRAIN_RULES``) each rank keeps its
    shards. Returns the new state and the metrics."""
    import contextlib
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import step as ST
    from repro_torch.utils import sharding as shd
    oc = OptConfig(**MESH_TRAIN_OPT)
    gen = torch.Generator(device="cuda").manual_seed(PHASE11_SEEDS["train"])
    state = ST.init_train_state(cfg, gen, oc, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(PHASE11_SEEDS["data"])
    shape = (MESH_TRAIN["batch"], MESH_TRAIN["seq"])
    batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=g,
                              device="cuda", dtype=torch.int32)
             for k in ("tokens", "targets")}
    ctx = contextlib.nullcontext()
    if mesh is not None:
        sizes = shd.mesh_axis_sizes(mesh)
        state = shd.distribute(state, mesh, ST.train_state_pspecs(
            cfg, shd.TRAIN_RULES, sizes, oc))
        batch = shd.distribute(batch, mesh, ST.batch_pspecs(
            cfg, batch, shd.TRAIN_RULES, sizes))
        ctx = shd.use_mesh_rules(mesh, shd.TRAIN_RULES)
    with ctx:
        new, met = ST.make_train_step(cfg, oc, 1)(state, batch)
    torch.cuda.synchronize()
    return new, {k: float(shd.replicated(v)) for k, v in met.items()}


def _seq_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of 11c: a (1, 2) gloo mesh on ``cuda:0``; the
    sequence-sharded decode in fp32 (4 layers, streams) and bf16 (16
    layers, the first step's logits), then the train step at (1,2)
    against mesh=None's new parameters (``out_dir/train_ref.pt``)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as shd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh((1, 2), device_type="cuda", backend="gloo")
    res = {}
    firsts = torch.load(os.path.join(out_dir, "first_tokens.pt"))
    for job, dtype, layers, n_new in SEQ_JOBS:
        cfg = mesh_config(dtype, layers)
        params = seq_params(torch, cfg, mesh, PHASE11_SEEDS["seq"])
        t0 = time.perf_counter()
        streams, pre, logits, launches = seq_decode(
            torch, cfg, params, n_new, mesh, K, firsts.get(job))
        res[job] = {"streams": streams, "s": time.perf_counter() - t0,
                    "launches": launches["flash_decode"],
                    "want_launches": attention_layers(cfg) * n_new}
        if rank == 0:
            torch.save(torch.cat([pre[None], logits]),
                       os.path.join(out_dir, f"seq_{job}.pt"))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    cfg = mesh_config("float32", MESH_TRAIN["layers"])
    t0 = time.perf_counter()
    new, met = mesh_train_cell(torch, cfg, mesh)
    res["train"] = {"metrics": met, "s": time.perf_counter() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    ref = torch.load(os.path.join(out_dir, "train_ref.pt"), mmap=True)
    worst, far = 0.0, 0.0
    lr = MESH_TRAIN_OPT["lr"]
    for (path, got), (_, want) in zip(M._walk(new["params"]),
                                      M._walk(ref)):
        sl = [slice(None)] * want.ndim
        for d in range(want.ndim):
            off, n = shd.shard_offset(mesh, got.placements, d, want.shape[d])
            sl[d] = slice(off, off + n)
        w = want[tuple(sl)].to("cuda")
        err = (got.to_local() - w).abs()
        tol = 1e-5 * float(want.abs().max()) + 0.01 * lr
        far = max(far, float((err > tol).float().mean()))
        worst = max(worst, float(err.max()) - tol)
    res["train"].update(far=far, over=worst)
    with open(os.path.join(out_dir, f"seq_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


#: 11c: rank-local positions of the 8 slots that the partials are held
#: at against their plain version: below every row of a rank (its rows
#: all after the slot; none read), at its first row, inside, at its last
#: and past every row (all read up to the bound)
SEQ_LOCAL_POS = (-64, -1, 0, 5, 127, 191, 192, 250)
#: ... and the bounds: the whole shard (no ``kv_len``), one clipped into
#: it (``min(kv_len - off, S_loc)``) and the floor of 1 a rank whose rows
#: all lie past ``kv_len`` gets
SEQ_BOUNDS = (None, 150, 1)


def seq_partials_check(torch, dtype) -> float:
    """The decode kernel's partials at the sequence-sharded path's shape
    (a rank's half of the 384 rows, 8 slots, yi-9b's heads): held against
    the plain version (``impl="ref"``) on the same inputs at the
    positions and bounds the path hands a rank (``SEQ_LOCAL_POS`` x
    ``SEQ_BOUNDS``): the splits merged by ``combine_splits`` within
    DECODE_TOL, the dead splits (l = 0) the same, a slot below every row
    all dead (m = -1e30) with an output of 0. Then the device µs of one
    launch with every row live, beside its byte bound (the live K and V
    rows over 3.35 TB/s, the q, partials and positions besides). Returns
    the max abs err."""
    from repro_torch.kernels.attention import decode as D
    from repro_torch.kernels.attention import ops
    b, rows, h, hkv, dh = (MESH_CELL["slots"], MESH_CELL["max_len"] // 2,
                           32, 4, 128)
    g = torch.Generator(device="cuda").manual_seed(PHASE11_SEEDS["seq"])
    q = torch.randn((b, 1, h, dh), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, rows, hkv, dh), generator=g,
                        device="cuda").to(dtype) for _ in range(2))
    lpos = torch.tensor(SEQ_LOCAL_POS, dtype=torch.int32, device="cuda")
    below = lpos < 0
    worst = 0.0
    for bound in SEQ_BOUNDS:
        ok_, mk, lk = ops.flash_decode_partials(q, k, v, lpos, kv_len=bound)
        orf, mr, lr = ops.flash_decode_partials(q, k, v, lpos, kv_len=bound,
                                                impl="ref")
        torch.cuda.synchronize()
        where = f"11c partials ({str(dtype)[6:]}, bound {bound})"
        check(torch.equal(lk == 0, lr == 0), f"{where}: dead splits differ")
        check(bool((lk[:, below] == 0).all()) and bool(
            (mk[:, below] == D.NEG_INF).all()),
            f"{where}: a slot below every row read a row")
        got = D.combine_splits(ok_, mk, lk)
        err = (got - D.combine_splits(orf, mr, lr)).abs().max().item()
        check(err <= DECODE_TOL, f"{where}: max err {err:.3g} > {DECODE_TOL}")
        check(not got[below].any(), f"{where}: a slot below every row has "
                                    f"an output")
        worst = max(worst, err)
    pos = torch.full((b,), MESH_CELL["max_len"] - 1, dtype=torch.int32,
                     device="cuda")
    o, _, _ = ops.flash_decode_partials(q, k, v, pos, kv_len=rows)
    elt = q.element_size()
    nbytes = (2 * b * rows * hkv * dh + b * h * dh) * elt \
        + o.shape[0] * b * h * (dh + 2) * 4 + 4 * b
    bound_us = nbytes / _H100.hbm_bw * 1e6
    us = timed(torch, lambda: ops.flash_decode_partials(
        q, k, v, pos, kv_len=rows), 200) * 1e3
    print(f"11c decode kernel partials at the sequence-sharded path's shape "
          f"({b} slots, {rows} rows a rank, H {h}, Hkv {hkv}, Dh {dh}, "
          f"{str(dtype)[6:]}): against the plain version at local positions "
          f"{list(SEQ_LOCAL_POS)} and bounds {list(SEQ_BOUNDS)} max abs err "
          f"{worst:.3g} (tol {DECODE_TOL}, splits merged in fp32; dead "
          f"splits equal, slots below every row read none); every row live "
          f"({o.shape[0]} splits): {us:.2f} us a launch, bound "
          f"{bound_us:.2f} us ({nbytes} bytes)")
    return worst


def phase_mesh_paths(torch, np, paths: dict) -> None:
    """11c: the new mesh paths on the card, two gloo ranks on ``cuda:0``
    (eager, as 10b): the decode cache sharded on its rows under
    ``SERVE_RULES`` (the decode kernel's partials over each rank's half,
    merged across the ranks), and yi-9b's train step at (1,2) under
    ``TRAIN_RULES``, each against mesh=None on the same weights. gloo has
    no reduce-scatter on CUDA tensors that FSDP over ``data`` > 1 would
    run, so that is held by the fake group's lowering (the CPU tests),
    not numerically here."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.models import model as M
    for dtype in (torch.float32, torch.bfloat16):
        seq_partials_check(torch, dtype)
    ref = {}
    with tempfile.TemporaryDirectory() as tmp:
        for job, dtype, layers, n_new in SEQ_JOBS:
            cfg = mesh_config(dtype, layers)
            params = seq_params(torch, cfg, None, PHASE11_SEEDS["seq"])
            streams, pre, logits, _ = seq_decode(torch, cfg, params, n_new)
            ref[job] = (streams, torch.cat([pre[None], logits]))
            del params
            gc.collect()
            torch.cuda.empty_cache()
        # the ranks' first step decodes mesh=None's prefill token: a
        # prefill pick that a rounding flips at a near tie would feed
        # another token, and its logits would be another's (the prefill's
        # logits are held apart)
        torch.save({job: torch.tensor([s[:1] for s in r[0]])
                    for job, r in ref.items()},
                   os.path.join(tmp, "first_tokens.pt"))
        cfg = mesh_config("float32", MESH_TRAIN["layers"])
        new, met = mesh_train_cell(torch, cfg)
        torch.save(M._map_tree(lambda t: t.cpu(), new["params"]),
                   os.path.join(tmp, "train_ref.pt"))
        del new
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = mp.start_processes(_seq_rank, args=(port, tmp), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_TP_TIMEOUT
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise PhaseError(f"11c: the two ranks ran past "
                                 f"{MESH_TP_TIMEOUT} s")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"seq_rank{r}.json")) as f:
                ranks.append(json.load(f))
        got_lg = {job: torch.load(os.path.join(tmp, f"seq_{job}.pt"))
                  for job in ref}
    print(f"11c: two ranks (gloo, cuda:0) ran in "
          f"{time.perf_counter() - t0:.1f} s")
    for job, (streams, want_lg) in ref.items():
        rec = ranks[0][job]
        check(rec["streams"] == ranks[1][job]["streams"],
              f"11c {job}: the two ranks' streams differ")
        check(rec["launches"] == rec["want_launches"],
              f"11c {job}: {rec['launches']} decode launches, expected "
              f"{rec['want_launches']} (attention layers x steps)")
        lg = got_lg[job]
        rel_pre, rel = (float((lg[i] - want_lg[i]).abs().max()
                              / want_lg[i].abs().max()) for i in (0, 1))
        same = sum(a == b for a, b in zip(rec["streams"], streams))
        tol = SEQ_FP32_REL_TOL if job == "fp32" else MESH_BF16_REL_TOL
        shared = shared_step_err(rec["streams"], streams, lg, want_lg)
        print(f"11c {job} sequence-sharded decode (cache rows over model, "
              f"TP=2; the first step fed mesh=None's prefill token): "
              f"{same}/{len(streams)} greedy streams of {len(streams[0])} "
              f"tokens identical to mesh=None; max|dlogit|/max|logit| "
              f"prefill {rel_pre:.3e}, first step {rel:.3e}, every step "
              f"fed the same tokens {shared:.3e} (held under {tol:g}); "
              f"decode kernel launches {rec['launches']} a rank; "
              f"{rec['s']:.1f} s")
        check(max(rel_pre, rel, shared) <= tol,
              f"11c {job}: logits {rel_pre:.3e} / {rel:.3e} / {shared:.3e} "
              f"over {tol:g}")
        if job == "fp32":
            parts = stream_partings(rec["streams"], streams, lg, want_lg)
            for b, t, gap, err in parts:
                print(f"11c fp32: stream {b} parts at token {t}: mesh=None's "
                      f"top-2 logit gap there {gap:.3e} of the largest, "
                      f"max|dlogit| there {err:.3e} (a tie when the gap "
                      f"is within 2 x that)")
            check(all(gap <= 2 * err for _, _, gap, err in parts),
                  f"11c fp32: a stream parts from mesh=None where its top "
                  f"two logits stand further apart than the two runs' "
                  f"logits differ: {parts}")
        paths["flash_decode"][f"yi-9b {job} sequence-sharded decode, TP=2 "
                              f"rank 0"] = rec["launches"]
    tr = ranks[0]["train"]
    for k in ("loss", "grad_norm"):
        rel = abs(tr["metrics"][k] - met[k]) / abs(met[k])
        print(f"11c train (yi-9b, {MESH_TRAIN['layers']} layers, fp32, "
              f"(1,2)): {k} {tr['metrics'][k]:.7f} against mesh=None "
              f"{met[k]:.7f} (rel {rel:.2e}, held under {MESH_TRAIN_RTOL:g})")
        check(rel <= MESH_TRAIN_RTOL, f"11c train: {k} rel {rel:.2e}")
    for r, rec in enumerate(ranks):
        t = rec["train"]
        print(f"11c train rank {r}: {t['s']:.1f} s, peak {t['peak_gb']:.2f} "
              f"GB; params off mesh=None's beyond 1e-5 of the leaf's max + "
              f"0.01 lr on a share {t['far']:.2e} of a leaf at most (held "
              f"under 0.01), by {max(t['over'], 0.0):.2e} at most (held "
              f"under 2 lr)")
        check(t["far"] < 0.01 and t["over"] <= 2 * MESH_TRAIN_OPT["lr"],
              f"11c train rank {r}: params off mesh=None's")


def start_dryrun() -> tuple:
    """Start phase 11's lowerings (:func:`dryrun_children`) in a fresh
    directory; returns ``(children, directory, deadline)``. They are CPU
    work alone, so chip_smoke starts them before phase 10, beside it."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    return dryrun_children(tmp), tmp, time.monotonic() + DRYRUN_TIMEOUT


def stop_dryrun(procs: dict, tmp: str) -> None:
    """Kill what is left of phase 11's children; remove their directory."""
    import shutil
    for p in procs.values():
        p.kill()
        p.communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def phase_dryrun(torch, np, paths: dict, procs: dict, tmp: str,
                 deadline: float) -> None:
    """Phase 11 (11a-11c), last: 11c's ranks and 11b's step on the card
    while the lowerings (started by :func:`start_dryrun`) finish, then
    their records."""
    t0 = time.perf_counter()
    phase_mesh_paths(torch, np, paths)
    phase_dryrun_card(torch, procs, tmp, deadline)
    phase_dryrun_records(procs, tmp, deadline)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s (its lowerings "
          f"started before phase 10)")

# ---------------------------------------------------------------------------
# Phase 12: what a mesh once refused, on the card
# ---------------------------------------------------------------------------

#: phase 12: the seed of every job's weights and inputs
PHASE12_SEED = 121
#: the families' jobs: (name, arch, dtype, depth (None: every layer),
#: decode steps). jamba at 5 layers holds its attention layer (layer 4)
#: and two MoE layers; grok-1 and qwen3-moe at one layer are
#: expert-parallel at (1,2) (4 and 64 experts a rank)
FAMILY_MESH_JOBS = (
    ("jamba bf16", "jamba-v0.1-52b", "bfloat16", JAMBA_LAYERS, 2),
    ("jamba fp32", "jamba-v0.1-52b", "float32", 5, 8),
    ("xlstm-125m fp32", "xlstm-125m", "float32", None, 8),
    ("xlstm-125m bf16", "xlstm-125m", "bfloat16", None, 2),
    ("musicgen-large bf16", "musicgen-large", "bfloat16", None, 2),
    ("grok-1 fp32", "grok-1-314b", "float32", MOE_LAYERS, 8),
    ("qwen3-moe fp32", "qwen3-moe-235b-a22b", "float32", MOE_LAYERS, 8))
#: the jobs' slots, prompt tokens (or frames) and cache rows
FAMILY_MESH_CELL = dict(slots=8, prompt=128, horizon=256)
#: configs whose prefill amplifies a rounding-level change to O(1): at
#: xlstm-125m's published width (random weights, fp32) a 1-ulp change to
#: one input element moves an sLSTM layer's output by 1.2-1.4 of its
#: largest element by 64 tokens, on the card and on the host alike, and
#: projecting the heads' halves apart (what TP=2 does) by as much
#: (``scripts/slstm_rounding_probe.py``). Their TP=2 prefill and streams
#: at ``FAMILY_MESH_CELL``'s prompt are printed, not held; their first
#: decode step is held from mesh=None's prefill cache as every job's is,
#: and in fp32 their own TP=2 prefill and first step at the short
#: prompts of ``AMPLIFIED_PROMPTS``
ROUNDING_AMPLIFIED = ("xlstm-125m",)
#: the short prompts (tokens) at which a ``ROUNDING_AMPLIFIED`` config's
#: own TP=2 prefill and first step are read against mesh=None's; those
#: of at most ``AMPLIFIED_HELD`` tokens held within ``MESH_FP32_REL_TOL``.
#: The difference grows about 1.5x a token (as an sLSTM layer grows the
#: training gradient), from 1.2e-5 at one token (the first step from
#: mesh=None's cache) to 6.8e-3 at 16 tokens; at 4 tokens it stays near
#: 5e-5 (an H100, fp32)
AMPLIFIED_PROMPTS = (2, 4, 8, 16)
AMPLIFIED_HELD = 4
#: the two ranks' time limit (their spawn, every job)
FAMILY_MESH_TIMEOUT = 600


def fam_config(arch: str, dtype: str, layers):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def fam_params(torch, cfg, mesh=None):
    """A job's weights from ``PHASE12_SEED``; with a ``mesh`` each rank
    keeps its shard of every leaf (the engines' rules) as it is made."""
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as shd
    place = None if mesh is None else shd.placer(mesh, M.param_pspecs(
        cfg, shd.SERVE_ENGINE_RULES, shd.mesh_axis_sizes(mesh)))
    gen = torch.Generator(device="cuda").manual_seed(PHASE12_SEED)
    return M.init_params(cfg, gen, device="cuda", place=place)


def fam_inputs(torch, cfg, steps: int, prompt: int | None = None) -> dict:
    """The prompts of ``prompt`` tokens (``FAMILY_MESH_CELL``'s by
    default; token ids, or frame embeddings and one frame a decode step
    for an embedding-input model) from ``PHASE12_SEED``."""
    c = FAMILY_MESH_CELL
    s = prompt or c["prompt"]
    g = torch.Generator(device="cuda").manual_seed(PHASE12_SEED)
    if cfg.embed_inputs:
        return {"tokens": torch.randint(0, cfg.vocab_size, (c["slots"], s),
                                        generator=g, device="cuda")}
    dt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    return {"embeds": torch.randn((c["slots"], s, cfg.d_model),
                                  generator=g, device="cuda").to(dt),
            "steps": torch.randn((steps, c["slots"], 1, cfg.d_model),
                                 generator=g, device="cuda").to(dt)}


def _routes(log) -> list:
    return [(e.cpu(), k.cpu()) for e, k in log.calls]


def routes_alike(a: list, b: list, slots: int):
    """(slots,) bool: the slots whose tokens two runs sent to the same
    experts and kept or dropped alike in every MoE call of their logs
    (prefill and first decode step; all True without MoE layers)."""
    import torch
    check(len(a) == len(b), "MoE route logs of unequal length")
    same = torch.ones(slots, dtype=torch.bool)
    for (ea, ka), (eb, kb) in zip(a, b):
        same &= (ea.reshape(slots, -1) == eb.reshape(slots, -1)).all(-1)
        same &= (ka.reshape(slots, -1) == kb.reshape(slots, -1)).all(-1)
    return same


def fam_decode(torch, cfg, params, inputs: dict, steps: int, mesh=None,
               K=None, first=None, rules=None, flavor=None,
               keep_prefill: bool = False) -> dict:
    """Prefill the slots (``FAMILY_MESH_CELL``'s rows) and decode
    ``steps`` greedy steps through ``forward`` under ``mesh`` and
    ``rules`` (the engines' by default): the streams (``first``, when
    given, the token the first step decodes instead of the prefill's
    pick), the prefill's last-position logits and each step's (fp32, on
    the host), the MoE routes of the prefill and the first step, the
    decode kernels' launches over the steps (counts zeroed just before
    them), ms a step, and under a mesh the collectives of one more step
    by op (``CommDebugMode``); with ``keep_prefill`` the prefill's cache
    copied to the host (whole)."""
    import contextlib
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models import model as M
    from repro_torch.train import serve as serve_lib
    from repro_torch.utils import sharding as shd
    c = FAMILY_MESH_CELL
    ctx = contextlib.nullcontext() if mesh is None else \
        shd.use_mesh_rules(mesh, rules or shd.SERVE_ENGINE_RULES)
    out = {}
    with ctx:
        batch = {k: v for k, v in inputs.items() if k != "steps"}
        b, s = next(iter(batch.values())).shape[:2]
        with RouteLog() as pre_log:
            logits, cache = serve_lib.make_prefill_step(
                cfg, cache_len=c["horizon"])(params, batch)
        logits = shd.replicated(logits)
        out["pre"] = logits[:, -1].float().cpu()
        if keep_prefill:
            out["prefill_cache"] = M._map_tree(
                lambda t: shd.replicated(t).to("cpu", copy=True), cache)
        tok = logits[:, -1].argmax(-1)[:, None] if first is None \
            else first.cuda()
        pos = torch.full((b,), s, dtype=torch.int32, device="cuda")
        toks, lgs, walls = [tok], [], []
        out["routes_pre"] = _routes(pre_log)
        if K is not None:
            K.reset_launches()
        for t in range(steps):
            x = {"tokens": tok} if cfg.embed_inputs \
                else {"embeds": inputs["steps"][t]}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with RouteLog() as log:
                lg, _, cache = M.forward(cfg, params, x, mode="decode",
                                         cache=cache, pos=pos,
                                         store_flavor=flavor)
            lg = shd.replicated(lg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if t == 0:
                out["routes_step"] = _routes(log)
            lgs.append(lg[:, 0].float().cpu())
            tok = lg[:, 0].argmax(-1)[:, None]
            toks.append(tok)
            pos = pos + 1
        out["launches"] = None if K is None else dict(K.LAUNCHES)
        if mesh is not None:
            x = {"tokens": tok} if cfg.embed_inputs \
                else {"embeds": inputs["steps"][-1]}
            with CommDebugMode() as cm:
                M.forward(cfg, params, x, mode="decode", cache=cache,
                          pos=pos, store_flavor=flavor)
            torch.cuda.synchronize()
            out["collectives"] = {k._qualified_op_name: n for k, n in
                                  cm.get_comm_counts().items() if n}
        out["cache"] = cache
    out["streams"] = torch.cat(toks, 1).cpu().tolist()
    out["steps"] = torch.stack(lgs)
    out["ms"] = 1e3 * sum(walls[1:] or walls) / len(walls[1:] or walls)
    return out


def fam_held_step(torch, cfg, params, cache: dict, x: dict, mesh) -> dict:
    """One decode step under ``mesh`` from mesh=None's prefill ``cache``
    (whole, on the host; each rank keeps its shard) and its inputs ``x``:
    the step's logits (fp32, on the host) and MoE routes, so that TP=2
    and mesh=None step from one state (a bf16 prefill's router near ties
    part the two runs' own caches)."""
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as shd
    c = FAMILY_MESH_CELL
    rules = shd.SERVE_ENGINE_RULES
    specs = M.cache_pspecs(cfg, rules, shd.mesh_axis_sizes(mesh),
                           c["slots"], c["horizon"])
    with shd.use_mesh_rules(mesh, rules):
        cache = shd.distribute(M._map_tree(lambda t: t.cuda(), cache), mesh,
                               specs)
        pos = torch.full((c["slots"],), c["prompt"], dtype=torch.int32,
                         device="cuda")
        with RouteLog() as log:
            lg, _, _ = M.forward(cfg, params, {k: v.cuda() for k, v in
                                               x.items()}, mode="decode",
                                 cache=cache, pos=pos)
        lg = shd.replicated(lg)
    return {"logits": lg[:, 0].float().cpu(), "routes": _routes(log)}


def _fam_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase 12: the families' jobs at (1,2), then the engine
    features (``pipeline=2`` and a snapshot at (1,2), the paged engine at
    (2,1), the sequence-sharded decode with non-temporal stores), two
    gloo ranks on ``cuda:0`` as 10b's; records under ``out_dir``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K, serve
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.utils import sharding as shd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_test_mesh((1, 2), device_type="cuda", backend="gloo")
    firsts = torch.load(os.path.join(out_dir, "first_tokens.pt"))
    res = {}
    for name, arch, dtype, layers, steps in FAMILY_MESH_JOBS:
        cfg = fam_config(arch, dtype, layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = fam_params(torch, cfg, mesh)
        inputs = fam_inputs(torch, cfg, steps)
        got = fam_decode(torch, cfg, params, inputs, steps, mesh, K,
                         firsts.get(name))
        del got["cache"]
        res[name] = {k: got[k] for k in ("streams", "ms", "collectives")}
        res[name].update(
            launches=got["launches"]["flash_decode"], s=time.perf_counter()
            - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        held = torch.load(os.path.join(out_dir, f"{name}.prefill.pt"))
        x0 = {"tokens": firsts[name]} if cfg.embed_inputs \
            else {"embeds": inputs["steps"][0]}
        step = fam_held_step(torch, cfg, params, held, x0, mesh)
        if rank == 0:
            torch.save(dict(step, pre=got["pre"], steps=got["steps"],
                            routes_pre=got["routes_pre"]),
                       os.path.join(out_dir, f"{name}.pt"))
        if arch in ROUNDING_AMPLIFIED and dtype == "float32":
            short = {}
            for n in AMPLIFIED_PROMPTS:
                got = fam_decode(torch, cfg, params, fam_inputs(
                    torch, cfg, 1, n), 1, mesh, first=firsts[f"{name} {n}"])
                short[n] = {k: got[k] for k in ("pre", "steps")}
            if rank == 0:
                torch.save(short, os.path.join(out_dir, f"{name}.short.pt"))
        del params, got, held
    # the engine features on yi-9b, fp32, 4 layers (10b's fp32 job)
    cfg = mesh_config("float32", MESH_FP32_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    params = mesh_params(torch, cfg, mesh)
    reqs = mesh_requests(np, serve, cfg.vocab_size)
    feats = {}
    for depth in (0, PIPELINE):
        c = MESH_CELL
        eng = serve.ServeEngine(cfg, params, max_slots=c["slots"],
                                max_len=c["max_len"], chunk=c["chunk"],
                                device="cuda", mesh=mesh, cuda_graphs=False,
                                pipeline=depth)
        t0 = time.perf_counter()
        out = eng.run(reqs)
        torch.cuda.synchronize()
        st = eng.stats()
        feats[f"pipeline{depth}"] = {
            "streams": {r: np.asarray(t).tolist() for r, t in out.items()},
            "ms": st["decode_s"] / st["decode_tokens"] * 1e3,
            "s": time.perf_counter() - t0}
        if depth:
            ck = Checkpointer(os.path.join(out_dir, "ckpt"))
            t0 = time.perf_counter()
            feats["snapshot"] = {"took": eng.snapshot(ck, 1)}
            ck.wait()
            feats["snapshot"]["s"] = time.perf_counter() - t0
        del eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mesh21 = make_test_mesh((2, 1), device_type="cuda", backend="gloo")
    params = mesh_params(torch, cfg, mesh21)
    got = serve_mesh(torch, K, serve, cfg, params, reqs, paged=True,
                     mesh=mesh21, cuda_graphs=False,
                     label=f"12 yi-9b fp32 paged (2,1) rank {rank}")
    del got["eng"], params
    feats["paged21"] = got
    gc.collect()
    torch.cuda.empty_cache()
    # the cache's rows over model (11c's layout), non-temporal stores
    params = seq_params(torch, cfg, mesh, PHASE11_SEEDS["seq"])
    seq_in = {"tokens": mesh_prompts(torch, cfg.vocab_size).cuda()}
    nt = {}
    for flavor in ("standard", "nt"):
        got = fam_decode(torch, cfg, params, seq_in, SEQ_JOBS[0][3], mesh, K,
                         firsts["seq"], rules=shd.SERVE_RULES, flavor=flavor)
        nt[flavor] = {"streams": got["streams"],
                      "writer": got["launches"]["kv_row_update"],
                      "decode": got["launches"]["flash_decode"]}
        cache = got.pop("cache")
    # one step at positions a single rank owns a row of: slot 0 at rank
    # 1's 6th row, every other slot at rank 0's 4th; each rank's shards
    # before and after
    from repro_torch.models import model as M
    half = FAMILY_MESH_CELL["horizon"] // 2
    own = torch.full((FAMILY_MESH_CELL["slots"],), 3, dtype=torch.int32,
                     device="cuda")
    own[0] = half + 5
    kv = [t for path, t in M._walk(cache) if path[-1] in ("k", "v")]
    before = [t.to_local().clone() for t in kv]
    with shd.use_mesh_rules(mesh, shd.SERVE_RULES):
        M.forward(cfg, params, {"tokens": seq_in["tokens"][:, :1]},
                  mode="decode", cache=cache, pos=own, store_flavor="nt")
    torch.cuda.synchronize()
    changed = set()
    for a, t in zip(before, kv):
        diff = (a != t.to_local()).any(-1).any(-1).any(0)
        changed |= {(int(b), int(r)) for b, r in diff.nonzero().tolist()}
    nt["changed"] = sorted(changed)
    feats["nt"] = nt
    res["features"] = feats
    with open(os.path.join(out_dir, f"fam_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def fam_reference(torch, name: str, arch: str, dtype: str, layers,
                  steps: int) -> dict:
    """A job's run at mesh=None on the card (the same weights and
    inputs), timed as the ranks' are; a ``ROUNDING_AMPLIFIED`` fp32 job's
    also at each of ``AMPLIFIED_PROMPTS`` (``short``)."""
    cfg = fam_config(arch, dtype, layers)
    params = fam_params(torch, cfg)
    got = fam_decode(torch, cfg, params, fam_inputs(torch, cfg, steps),
                     steps, keep_prefill=True)
    del got["cache"]
    if arch in ROUNDING_AMPLIFIED and dtype == "float32":
        got["short"] = {}
        for n in AMPLIFIED_PROMPTS:
            got["short"][n] = fam_decode(torch, cfg, params, fam_inputs(
                torch, cfg, 1, n), 1)
            del got["short"][n]["cache"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return got


def phase_mesh_families(torch, np, K, paths: dict) -> None:
    """Phase 12, after phase 11: the recurrent, MoE and embedding-input
    configs at full width under a (1,2) mesh (``FAMILY_MESH_JOBS``), and
    the engine features a mesh once refused, each against mesh=None on
    the same card, weights and inputs, two gloo ranks on ``cuda:0``
    spawned under ``FAMILY_MESH_TIMEOUT`` as 10b's."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch import serve
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    ref = {}
    for job in FAMILY_MESH_JOBS:
        ref[job[0]] = fam_reference(torch, *job)
    cfg = mesh_config("float32", MESH_FP32_LAYERS)
    params = mesh_params(torch, cfg)
    reqs = mesh_requests(np, serve, cfg.vocab_size)
    paged_ref = serve_mesh(torch, K, serve, cfg, params, reqs, paged=True,
                           mesh=None, cuda_graphs=False,
                           label="12 yi-9b fp32 paged mesh=None")
    del paged_ref["eng"]
    seq_params_ref = seq_params(torch, cfg, None, PHASE11_SEEDS["seq"])
    seq_ref = fam_decode(torch, cfg, seq_params_ref, {
        "tokens": mesh_prompts(torch, cfg.vocab_size).cuda()},
        SEQ_JOBS[0][3])
    del seq_ref["cache"], seq_params_ref
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks' first step decodes mesh=None's prefill token (11c's
        # reason: a near-tie prefill pick would feed another token)
        firsts = {name: torch.tensor([s[:1] for s in ref[name]["streams"]])
                  for name, arch, dtype, layers, _ in FAMILY_MESH_JOBS
                  if fam_config(arch, dtype, layers).embed_inputs}
        firsts.update({f"{name} {n}": torch.tensor(
            [s[:1] for s in short["streams"]])
            for name, r in ref.items()
            for n, short in r.get("short", {}).items()})
        firsts["seq"] = torch.tensor([s[:1] for s in seq_ref["streams"]])
        torch.save(firsts, os.path.join(tmp, "first_tokens.pt"))
        for name, r in ref.items():
            torch.save(r.pop("prefill_cache"),
                       os.path.join(tmp, f"{name}.prefill.pt"))
        t0 = time.perf_counter()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = mp.start_processes(_fam_rank, args=(port, tmp), nprocs=2,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + FAMILY_MESH_TIMEOUT
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise PhaseError(f"12: the two ranks ran past "
                                 f"{FAMILY_MESH_TIMEOUT} s")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"fam_rank{r}.json")) as f:
                ranks.append(json.load(f))
        got_lg = {job[0]: torch.load(os.path.join(tmp, f"{job[0]}.pt"))
                  for job in FAMILY_MESH_JOBS}
        short = {name: torch.load(os.path.join(tmp, f"{name}.short.pt"))
                 for name in ref if "short" in ref[name]}
        ck = Checkpointer(os.path.join(tmp, "ckpt"))
        restored = ck.restore(1, {"params": params})["params"]
        leaves_equal = all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                M._walk(restored), M._walk(params)))
        n_leaves = len(list(M._walk(params)))
    del params, restored
    gc.collect()
    torch.cuda.empty_cache()
    print(f"12: two ranks (gloo, cuda:0) ran in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, arch, dtype, layers, steps in FAMILY_MESH_JOBS:
        cfg = fam_config(arch, dtype, layers)
        want, rec, other = ref[name], ranks[0][name], ranks[1][name]
        lg = got_lg[name]
        check(rec["streams"] == other["streams"],
              f"12 {name}: the two ranks' streams differ")
        slots = FAMILY_MESH_CELL["slots"]
        # the first step from one state: mesh=None's prefill cache
        alike = routes_alike(lg["routes"], want["routes_step"], slots)
        apart = int((~alike).sum())
        check(2 * apart < slots, f"12 {name}: {apart} of {slots} slots "
                                 f"routed apart in the first step")
        ref0 = want["steps"][0]
        rel = float((lg["logits"] - ref0)[alike].abs().max()
                    / ref0.abs().max())
        pre_alike = routes_alike(lg["routes_pre"], want["routes_pre"], slots)
        rel_pre = float((lg["pre"] - want["pre"])[pre_alike].abs().max()
                        / want["pre"].abs().max()) if pre_alike.any() \
            else float("nan")
        tol = MESH_FP32_REL_TOL if dtype == "float32" else MESH_BF16_REL_TOL
        same = sum(a == b for a, b in zip(rec["streams"], want["streams"]))
        kinds = rec["collectives"]
        want_launches = attention_layers(cfg) * steps
        print(f"12 {name} ({cfg.n_layers} layers, {arch} at its published "
              f"width, (1,2)): first decode step from mesh=None's prefill "
              f"cache max|dlogit|/max|logit| {rel:.3e} (held under {tol:g};"
              f" {slots - apart} of {slots} slots routed alike); the ranks' "
              f"own prefill {rel_pre:.3e} over the {int(pre_alike.sum())} "
              f"slots routed alike there; {same}/{len(want['streams'])} "
              f"greedy streams of {steps + 1} tokens identical; collectives "
              f"a step {sum(kinds.values())} {kinds}; {rec['ms']:.2f} ms/step"
              f" eager TP=2 vs {want['ms']:.2f} mesh=None; flash_decode "
              f"launches {rec['launches']} a rank (= {want_launches}); "
              f"{rec['s']:.1f} s, peak {rec['peak_gb']:.2f} GB a rank")
        check(rel <= tol, f"12 {name}: first step {rel:.3e} over {tol:g}")
        check(rec["launches"] == want_launches, f"12 {name}: "
              f"{rec['launches']} decode launches, expected {want_launches}")
        if attention_layers(cfg):
            paths["flash_decode"][f"{name} forward, (1,2) rank 0"] = \
                rec["launches"]
        if arch in ROUNDING_AMPLIFIED:
            print(f"12 {name}: the TP=2 prefill and streams of "
                  f"{FAMILY_MESH_CELL['prompt']} tokens are not held "
                  f"(ROUNDING_AMPLIFIED: its sLSTM layers amplify a "
                  f"rounding-level change to O(1) within 64 tokens)")
            if name in short:
                rels = {n: [float((a - b).abs().max() / b.abs().max())
                            for a, b in ((g["pre"], w["pre"]),
                                         (g["steps"][0], w["steps"][0]))]
                        for n, (g, w) in ((n, (short[name][n],
                                               want["short"][n]))
                                          for n in AMPLIFIED_PROMPTS)}
                print(f"12 {name}, the ranks' own prefill and first decode "
                      f"step at short prompts, max|dlogit|/max|logit|: " +
                      "; ".join(f"{n} tokens {p:.3e}, {t:.3e}"
                                for n, (p, t) in rels.items()) +
                      f" (held under {MESH_FP32_REL_TOL:g} up to "
                      f"{AMPLIFIED_HELD} tokens)")
                over = {n: r for n, r in rels.items()
                        if n <= AMPLIFIED_HELD and max(r) > MESH_FP32_REL_TOL}
                check(not over, f"12 {name}: short prompts over "
                                f"{MESH_FP32_REL_TOL:g}: {over}")
            continue
        if dtype == "float32":
            check(rel_pre <= tol and bool(pre_alike.all()),
                  f"12 {name}: prefill {rel_pre:.3e} over {tol:g} or "
                  f"routed apart")
            want_lg = torch.cat([want["pre"][None], want["steps"]])
            both = torch.cat([lg["pre"][None], lg["steps"]])
            shared = shared_step_err(rec["streams"], want["streams"], both,
                                     want_lg)
            parts = stream_partings(rec["streams"], want["streams"], both,
                                    want_lg)
            print(f"12 {name}: every step fed the same tokens max|dlogit|/"
                  f"max|logit| {shared:.3e}; partings {parts}")
            check(all(gap <= 2 * err for _, _, gap, err in parts),
                  f"12 {name}: a stream parts where mesh=None's top two "
                  f"logits stand apart: {parts}")
            check(shared <= tol, f"12 {name}: logits {shared:.3e} over "
                                 f"{tol:g}")
    feats, other = ranks[0]["features"], ranks[1]["features"]
    serial, piped = feats["pipeline0"], feats[f"pipeline{PIPELINE}"]
    check(piped["streams"] == serial["streams"]
          == other[f"pipeline{PIPELINE}"]["streams"],
          "12 pipeline: pipelined streams differ from serial under the mesh")
    print(f"12 yi-9b fp32 ({MESH_FP32_LAYERS} layers) pipeline={PIPELINE} at"
          f" (1,2): {len(reqs)} greedy streams identical to serial; "
          f"{piped['ms']:.2f} vs {serial['ms']:.2f} ms/step eager")
    snap = feats["snapshot"]
    check(snap["took"] and other["snapshot"]["took"] and leaves_equal,
          f"12 snapshot: taken {snap['took']}, leaves equal {leaves_equal}")
    print(f"12 snapshot of the (1,2) engine ({snap['s']:.1f} s, rank 0 "
          f"writes the whole leaves): restored at mesh=None, its "
          f"{n_leaves} leaves equal to mesh=None's params")
    pg = feats["paged21"]
    check(pg["streams"] == paged_ref["streams"]
          == other["paged21"]["streams"],
          "12 paged (2,1): streams differ from mesh=None's")
    print(f"12 yi-9b fp32 paged engine at (2,1) (slots over data): "
          f"{len(reqs)} greedy streams identical to mesh=None's; "
          f"{pg['ms']:.2f} vs {paged_ref['ms']:.2f} ms/step; "
          f"flash_decode_paged launches {pg['launches']} a rank")
    paths["flash_decode_paged"]["yi-9b paged engine fp32, (2,1) rank 0"] = \
        pg["launches"]
    nt = feats["nt"]
    half = FAMILY_MESH_CELL["horizon"] // 2
    owned = {0: [[b, 3] for b in range(1, FAMILY_MESH_CELL["slots"])],
             1: [[0, 5]]}
    for r, rec in enumerate(ranks):
        got = rec["features"]["nt"]
        check(got["nt"]["streams"] == got["standard"]["streams"],
              f"12 nt rank {r}: streams differ from the standard stores'")
        check(got["changed"] == owned[r], f"12 nt rank {r}: rows written "
              f"{got['changed']}, owned {owned[r]}")
    writers = [rec["features"]["nt"]["nt"]["writer"] for rec in ranks]
    same = sum(a == b for a, b in zip(nt["nt"]["streams"],
                                      seq_ref["streams"]))
    print(f"12 sequence-sharded decode (yi-9b fp32, rows over model) with "
          f"store_flavor='nt': streams identical to the standard stores' "
          f"({same}/{len(seq_ref['streams'])} to mesh=None's); one step at "
          f"rows owned by one rank each: rank 0 wrote {len(owned[0])} rows, "
          f"rank 1 {len(owned[1])}, no other row changed (of {half} a rank);"
          f" kv_row_update launches {writers[0]} on rank 0 and "
          f"{writers[1]} on rank 1 over {SEQ_JOBS[0][3]} steps (every slot "
          f"at rows of one rank; a launch a layer and run of owned slots), "
          f"flash_decode {nt['nt']['decode']} a rank")
    paths["flash_decode"]["yi-9b fp32 sequence-sharded decode, nt, rank 0"] = \
        nt["nt"]["decode"]
    paths["kv_row_update"] = {
        f"yi-9b fp32 sequence-sharded decode, nt, rank {r}": n
        for r, n in enumerate(writers)}
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")


# --- phase 13: the entry points ---------------------------------------------

EXAMPLES = os.path.join(HERE, "examples", "torch")
EXAMPLE_TOKENS = 144              # serve_lm's 6 requests, 16 + 8 * (i % 3)
EXAMPLES_MESH = "data,model=1,2"
EXAMPLES_MESH_TIMEOUT = 300
#: a number and its unit as the examples print them (``1054.1 us``)
US_FIGURE = re.compile(r"([-+\d.eE]+) us\b")
RPE_FIGURE = re.compile(r"\(rpe ([-+\d.]+)")


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module, its ``main`` callable
    in-process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, name: str, argv: list) -> str:
    """``mod.main(argv)`` with its standard output captured and echoed a
    line at a time; fails unless it returns 0. Returns the output."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"13 {name}| {line}")
    print(f"13 {name} {' '.join(argv)}: exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(rc == 0, f"13 {name} {argv}: exit {rc}")
    return out


def served_tokens(out: str, label: str) -> float:
    """Check a serve_lm output's tokens; returns its seconds."""
    m = re.search(r"served 6 requests on 2 slots: (\d+) tokens in "
                  r"([\d.]+)s", out)
    check(m is not None, f"13 {label}: no 'served' line")
    check(int(m.group(1)) == EXAMPLE_TOKENS, f"13 {label}: {m.group(1)} "
          f"tokens, expected {EXAMPLE_TOKENS}")
    return float(m.group(2))


def _examples_rank(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase 13's mesh run: the world from the environment
    ``torchrun`` would set, its gloo group made here (NCCL refuses two
    ranks on one card), then ``serve_lm --smoke --mesh`` through its
    ``main``; the output and the rank's ``flash_decode`` launches written
    under ``out_dir``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, SRC)
    import contextlib
    import io
    import torch
    import torch.distributed as dist
    from repro_torch import kernels as K
    dist.init_process_group("gloo", rank=rank, world_size=2)
    mod = load_example("serve_lm")
    K.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--smoke", "--mesh", EXAMPLES_MESH])
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rc": rc, "out": buf.getvalue(),
                   "flash_decode": K.LAUNCHES["flash_decode"]}, f)
    dist.destroy_process_group()


def start_examples_mesh(tmp: str):
    """Spawn the two ranks of :func:`_examples_rank`; returns the context
    and its deadline."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(_examples_rank, args=(port, tmp), nprocs=2,
                             join=False, start_method="spawn")
    return ctx, time.monotonic() + EXAMPLES_MESH_TIMEOUT


def join_examples_mesh(ctx, deadline: float, tmp: str) -> tuple:
    """Wait for the ranks (killed past the deadline); returns rank 0's
    output and its ``flash_decode`` launches."""
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise PhaseError(f"13 serve_lm --mesh: the two ranks ran past "
                             f"{EXAMPLES_MESH_TIMEOUT} s")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, rec in enumerate(ranks):
        check(rec["rc"] == 0, f"13 serve_lm --mesh rank {r}: exit "
                              f"{rec['rc']}")
    check(not ranks[1]["out"].strip(), "13 serve_lm --mesh: rank 1 printed")
    for line in ranks[0]["out"].splitlines():
        print(f"13 serve_lm --mesh rank 0| {line}")
    return ranks[0]["out"], ranks[0]["flash_decode"]


def phase_examples(torch, K, cfg_mod) -> dict:
    """Phase 13 (module docstring). Returns the launches by kernel and
    path."""
    import tempfile
    t0 = time.perf_counter()
    paths = {"flash_decode": {}, "stream_triad": {}}
    with tempfile.TemporaryDirectory() as tmp:
        ctx, deadline = start_examples_mesh(tmp)
        try:
            mod = load_example("compare_arch")
            out = run_example(mod, "compare_arch", [])
            check("WA ordering Grace <= SPR <= Zen4 (no NT stores): OK" in
                  out, "13 compare_arch: the ordering line is not OK")
            for m in mod.DEFAULT_MACHINES:
                check(re.search(rf"^{m}\s", out, re.M) is not None,
                      f"13 compare_arch: no row for {m}")
            out = run_example(load_example("analyze_arch"), "analyze_arch",
                              ["--arch", "jamba-v0.1-52b"])
            check(re.search(r"unknown ops\s*: 0$", out, re.M) is not None,
                  "13 analyze_arch: the trace holds unknown ops")
            figs = [float(x) for x in US_FIGURE.findall(out)]
            check(len(figs) == 4 and all(map(math.isfinite, figs)),
                  f"13 analyze_arch: terms {figs}")
        finally:
            mesh_out, mesh_launches = join_examples_mesh(ctx, deadline, tmp)
    mesh_s = served_tokens(mesh_out, "serve_lm --mesh")
    check(", tp=2" in mesh_out, "13 serve_lm --mesh: not at tp=2")
    check(mesh_launches > 0, "13 serve_lm --mesh: no flash_decode launch")
    paths["flash_decode"][f"examples serve_lm --smoke --mesh "
                          f"{EXAMPLES_MESH}, rank 0"] = mesh_launches

    K.reset_launches()
    out = run_example(load_example("quickstart"), "quickstart", [])
    torch.cuda.synchronize()
    paths["stream_triad"]["examples quickstart"] = K.LAUNCHES["stream_triad"]
    check(K.LAUNCHES["stream_triad"] > 0, "13 quickstart: no stream_triad "
                                          "launch")
    us = [float(x) for x in US_FIGURE.findall(out)]
    rpes = [float(x) for x in RPE_FIGURE.findall(out)]
    m = re.search(r"flops=(\S+)\s+hbm_bytes=(\S+)", out)
    check(m is not None, "13 quickstart: no flops line")
    figs = us + [float(m.group(1)), float(m.group(2))]
    check(len(us) == 6 and len(rpes) == 3 and all(
        math.isfinite(x) and x > 0 for x in figs) and all(
        map(math.isfinite, rpes)), f"13 quickstart: figures {figs}, "
        f"RPEs {rpes}")
    print(f"13 quickstart: RPE against the h100 file {rpes[0]:+.4f}, the "
          f"calibrated model {rpes[1]:+.4f}, the naive baseline "
          f"{rpes[2]:+.4f}; stream_triad launches "
          f"{K.LAUNCHES['stream_triad']}")

    per_step = attention_layers(cfg_mod.get_config("gemma3-4b"))
    for argv in ([], ["--replicas", "2"]):
        label = " ".join(["serve_lm"] + argv)
        gc.collect()
        torch.cuda.empty_cache()
        K.reset_launches()
        out = run_example(load_example("serve_lm"), "serve_lm", argv)
        torch.cuda.synchronize()
        n = K.LAUNCHES["flash_decode"]
        check(n > 0 and n % per_step == 0, f"13 {label}: flash_decode "
              f"launches {n}, not a positive multiple of {per_step}")
        secs = served_tokens(out, label)
        print(f"13 {label}: gemma3-4b full width, {EXAMPLE_TOKENS} tokens "
              f"in {secs:.2f} s = {EXAMPLE_TOKENS / secs:.1f} tok/s; "
              f"flash_decode {n} ({n // per_step} steps of {per_step} "
              f"layers)")
        paths["flash_decode"]["examples " + label] = n
    print(f"13 serve_lm --smoke --mesh {EXAMPLES_MESH}: {EXAMPLE_TOKENS} "
          f"tokens in {mesh_s:.2f} s on two gloo ranks, eager; "
          f"flash_decode {mesh_launches} on rank 0")
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as ckpt:
        out = run_example(load_example("train_lm"), "train_lm",
                          ["--steps", "2", "--ckpt-dir", ckpt])
        first = re.search(r"^step\s+0 loss (\S+) gnorm (\S+)", out, re.M)
        done = re.search(r"^done: first loss (\S+) -> last (\S+)", out, re.M)
        check(first is not None and done is not None,
              "13 train_lm: no loss line for each step")
        check(math.isfinite(float(first.group(1))),
              f"13 train_lm: step 0 loss {first.group(1)}")
        committed = os.path.join(ckpt, "step_00000002", "COMMIT")
        check(os.path.exists(committed),
              "13 train_lm: no committed checkpoint at step 2")
        print(f"13 train_lm: step 0 loss {first.group(1)} gnorm "
              f"{first.group(2)}; step 1 loss {done.group(2)}; the "
              f"checkpoint of step 2 committed")
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from the repository root (src/repro_torch "
              "not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import configs as cfg_mod
    from repro_torch import kernels as K
    from repro_torch import serve
    from repro_torch.kernels import build, stores as S_
    from repro_torch.kernels.attention import decode as D, ops, ref as R
    from repro_torch.kernels.stream import kernels as SK, ops as SO, ref as SR
    from repro_torch.models import layers as L, model as M
    from repro_torch.serve import pages as PG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name = phase_device(torch)
    phase_build(build)
    decode_err = phase_decode(torch, D, ops)
    paged_err = phase_paged_decode(torch, D, ops)
    phase_flash_sass(build)
    flash_err = phase_flash(torch, ops, R)
    phase_fused_write(torch, D, ops, S_, K)
    writer_launches = phase_stores(torch, S_, K)
    stream_rows = phase_stream(torch, K, SO, SR, SK,
                               phase_stream_check(torch, K, SO, SR, SK))
    eng, reqs, launches = phase_engine(torch, np, cfg_mod, M, K, serve)
    flash_launches = phase_prefill_attention(torch, np, eng.cfg, M, L, K,
                                             ops, R, eng.params)
    peng, paged_launches = phase_paged_engine(
        torch, np, cfg_mod, M, K, serve, PG, eng.params, eng.stats())
    phase_graph_parity(torch, np, serve, eng.cfg, eng.params)
    rows = phase_timings(torch, np, D, ops, S_, eng, reqs, launches,
                         decode_err, writer_launches)
    rows += phase_new_timings(torch, D, ops, R, S_, peng, reqs, paged_launches,
                              paged_err, flash_launches, flash_err)
    rows += stream_rows
    phase_wide_timings(torch, D, ops, R, reqs)
    ms = phase_trace(torch, serve, eng, reqs, "trace")
    plan_s = phase_plan(torch, "yi-9b dense", eng, ms,
                        trace_rows(reqs, eng.chunk))
    preqs = paged_requests(np, serve, eng.cfg.vocab_size, 8, 5, 256, 256, 64)
    ms = phase_trace(torch, serve, peng, preqs, "paged trace")
    plan_s += phase_plan(torch, "yi-9b paged", peng, ms,
                         trace_rows(preqs, peng.chunk))
    plan_s += phase_split_sweep(torch, D, ops, eng, reqs)
    params = eng.params
    del eng, peng
    torch.cuda.empty_cache()
    phase_analysis(torch, K)
    torch.cuda.empty_cache()
    plan_s += phase_planned_engine(torch, np, serve, cfg_mod.get_config(
        "yi-9b"), params)
    del params
    torch.cuda.empty_cache()
    geng, greqs, gemma_launches = phase_gemma_engine(torch, np, cfg_mod, M,
                                                     K, serve)
    phase_gemma_paged(torch, M, K, PG, geng, greqs)
    ms = phase_trace(torch, serve, geng, greqs, "gemma3-4b trace")
    plan_s += phase_plan(torch, "gemma3-4b dense", geng, ms,
                         trace_rows(greqs, geng.chunk))
    del geng
    torch.cuda.empty_cache()
    family_launches = phase_family_forward(torch, np, cfg_mod, M, K)
    t_new = time.perf_counter()
    xeng, xreqs = phase_xlstm_engine(torch, np, cfg_mod, M, K, serve)
    phase_xlstm_paged(torch, M, serve, xeng, xreqs)
    xtrace = [serve.Request(r.rid, r.prompt[:XLSTM_TRACE_PROMPT],
                            r.max_new_tokens) for r in xreqs]
    ms = phase_trace(torch, serve, xeng, xtrace, "xlstm-125m trace")
    plan_s += phase_plan(torch, "xlstm-125m dense", xeng, ms, None)
    del xeng
    torch.cuda.empty_cache()
    jeng, jreqs, jamba_launches = phase_jamba(torch, np, cfg_mod, M, K,
                                              serve, PG)
    ms = phase_trace(torch, serve, jeng, jreqs, "jamba trace")
    plan_s += phase_plan(torch, "jamba period dense", jeng, ms,
                         trace_rows(jreqs, jeng.chunk))
    del jeng
    torch.cuda.empty_cache()
    moe_launches = phase_moe_forward(torch, np, cfg_mod, M, K)
    print(f"phases 5h-5k: {time.perf_counter() - t_new:.1f} s")
    torch.cuda.empty_cache()
    fig_launches = phase_serving_benchmarks(torch, K)
    torch.cuda.empty_cache()
    runtime_launches = phase_runtime(torch, np, K, serve)
    torch.cuda.empty_cache()
    phase_training(torch, np, K)
    torch.cuda.empty_cache()
    procs, dry_tmp, dry_deadline = start_dryrun()
    try:
        mesh_launches = phase_mesh(torch, np, K, serve)
        torch.cuda.empty_cache()
        phase_dryrun(torch, np, mesh_launches, procs, dry_tmp, dry_deadline)
    finally:
        stop_dryrun(procs, dry_tmp)
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh_families(torch, np, K, mesh_launches)
    gc.collect()
    torch.cuda.empty_cache()
    example_launches = phase_examples(torch, K, cfg_mod)
    by_name = {r["name"]: r for r in rows}
    path_launches(by_name["flash_decode"], dict(
        {"yi-9b dense engine": by_name["flash_decode"]["launches"],
         "gemma3-4b dense engine": gemma_launches,
         "jamba dense engine": jamba_launches["dense"]},
        **{f"{a} forward": n for a, n in family_launches.items()},
        **{f"{a} forward": n for a, n in moe_launches.items()},
        **fig_launches["flash_decode"],
        **runtime_launches["flash_decode"],
        **mesh_launches["flash_decode"],
        **example_launches["flash_decode"]))
    path_launches(by_name["stream_triad"], dict(
        {"stream main path": by_name["stream_triad"]["launches"]},
        **example_launches["stream_triad"]))
    by_name["kv_row_update"]["standalone_launches_by_path"] = \
        mesh_launches["kv_row_update"]
    path_launches(by_name["flash_decode_paged"], dict(
        {"yi-9b paged engine": by_name["flash_decode_paged"]["launches"],
         "jamba paged engine": jamba_launches["paged"]},
        **fig_launches["flash_decode_paged"],
        **runtime_launches["flash_decode_paged"],
        **mesh_launches["flash_decode_paged"]))
    print(f"planning phases (plan lines, split sweep, planned engine): "
          f"{plan_s:.1f} s")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
