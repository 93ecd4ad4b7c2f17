#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX and exits non-zero, printing no result, when no
CUDA GPU is usable or the port's package is not beside it.  Phases:
  1. build the Hopper kernels (csrc/*.cu) with nvcc, one process per source;
  2. hold each kernel against its plain PyTorch version on the GPU, bit for
     bit, and time both with CUDA events: K1-K4 at the sketch step's shapes
     (n = 8,388,608 windows for kw = 1..4; the compaction stages the
     planner gives; K3 also at G 1-128 and n 1 to 2^22 with all-valid and
     all-sentinel rows; K4 at 65,536 keys, G = 2, kw 1-4, each timed, and
     at N = 1,024 to 2^20 with all-sentinel and all-equal rows); K5 and K6 at
     config 2's shapes (128 runs of 32,768 entries, pw 2, gp 128), at pw 5,
     and K6 at pw 1, 3 and 4, at gp 2048 (2,048 runs of 2,048, a key in
     every genome) and gp 8192 (runs of 8,192, open across chunk edges),
     full and split, and on empty and all-sentinel streams;
     K10 (without and with the column block's gid offset) and K6 (split,
     its second timed shape) at the blocked schedule's macro-tile (two
     presorted blocks of 128 x 32,768, gp 256); K6 also at macro-tiles of
     two blocks of related genomes (the cell's Zipf species) and of
     unrelated ones;
  3. write synthetic FASTAs from --seed (8 genomes of 4-6 Mnt with a few
     records and N-runs, genome 1 a 3%-mutated copy of genome 0) and run
     the CLI (`driver.main --window 20 --k 16 --device cuda`) on all 8, then
     on genomes 0 and 1 alone (BASELINE config 1, twice: cold and warm);
  4. run the CLI's 62-config reference sweep on genomes 0 and 1 in two
     turns: every turn writes the first turn's CSV bytes, and the batch
     step's upload of each of phase 3's genomes equals a fresh pack, its
     run-id plane expanded on the card the host's;
  5. BASELINE config 2: 100 related FASTAs of 4-6 Mnt (one ancestor, 5
     clade roots 3% substituted from it, 20 members per clade 0.2-2%
     substituted from their root) through the same CLI; all-pairs takes
     the device Gram (K5, K6);
  6. all_pairs_intersections on 4,096 synthetic sketches of ~25,000 40-bit
     keys (capacity 32,768) drawn from 64 clade pools: the blocked
     block-cache route (each sketch packed bit-tight on the host, K12 + K5
     per block, K10 + K6 per macro-tile), then once more under
     torch.profiler for the device time and launches of the kernels of
     K12, K5, K10, K6 and K3;
  7. BASELINE config 5: two synthetic chromosomes of 268.5-272 Mnt (B a
     1.2%-substituted copy of A, each with N-gaps of 10 kb to 1 Mnt, some
     on segment edges), FASTAs of 80-nt lines of 2^28 bytes or more, through
     the CLI: sketch_files streams each in 17 segments (K7 per segment, the
     finish, a K4 merge), then once more under torch.profiler, as phase 6;
  8. BASELINE config 4: (a) the CLI on 640 related FASTAs of 1.5-1.7 Mnt
     (8 clades), which routes through the one-flow DevicePipeline (K7, the
     finish, K5 presort per block, K10 + K6 tiles), against the two-step
     path's CSV byte for byte; (b) DevicePipeline.all_pairs on 10,240
     genomes of 1.55 Mnt drawn on the device (device_source), then once
     more under torch.profiler, as phase 6;
  9. BASELINE config 3: 8 spaced seeds (mask seeds 0-7, w=20, k=16) over
     each of phase 3's genomes 0 and 1 through sketch_packed_multiseed
     (one compact upload and one K7 seed-batch launch a genome);
 10. (a) sketch_from_codes on genome 0 (K11, K4); (b) 16 genomes of
     48,502 nt (phage lambda) at sketch_capacity 512, which the planner
     sends to the _finish_runs fallback (K8, K5); (c) a 2 Mnt genome at
     sketch_capacity 2048: the tiled _finish_candidates (K9) overflows and
     the retry finishes;
 11. the port's bench (`python -m spaced_kmer_sketching_tpu_torch.bench`),
     one subprocess a run: sketch and multiseed at their defaults, allpairs
     --ondevice and --probe at G = 128, allpairs --blocked at G = 512,
     stream at 2^25 nt (two segments), e2e from codes at G = 256 and from
     device genomes at G = 1,024, the latter also with --e2e-mesh
     (MeshDevicePipeline over every local GPU), four at a time; each must
     exit 0 with a verified line from the gpu that launched the run's
     kernels;
 12. (a) the CLI's 62-config sweep on genomes 0 and 1 with --store, whose
     CSV must be phase 4's bytes, cut after 31 configs and 2 rows (as a
     kill leaves it) and rerun with the same store: phase 4's bytes again,
     and no K1 launch; (b) config 2's 100 genomes through the CLI with
     --store twice (the second run launches no K1; both write phase 5's
     bytes), then with --pairing ring: 100 rows, each phase 5's row
     (i, i+1 mod 100); (c) blocked_all_pairs on 16,512 host sketches of
     ~25,000 40-bit keys at capacity 32,768 (129 blocks, from clade pools
     as phase 6 draws them) at the default budgets: the slab and cache
     would need 8,657,043,456 bytes, over 8 GiB, so the out-of-core
     schedule runs (K5 presorts, one K10 and one K6 a tile, 8,385 tiles),
     then once more under torch.profiler, as phase 6, then through
     FracMinHashSketcher.all_pairs_intersections on the same keys as
     Sketch objects (blocks stacked on demand): the same matrix; (d) phase
     8(b)'s int32 matrix download in turns with an int16 one; (e) the CLI
     on config 1 with --profile DIR: the trace must name the kernels and
     the CSV be phase 3's;
 13. the multi-GPU layer (parallel/, MeshDevicePipeline) on one card:
     (a) the CLI with --mesh auto on config 1 in this process at world
     size 1 over NCCL (RANK=0 WORLD_SIZE=1): a 1 x 1 mesh, both 5.4 Mnt
     genomes through the sharded K1 batch, phase 3's CSV bytes, then
     MeshSketcher.sketch_packed on the 1 x 1 mesh sends both through the
     sequence-parallel ring (K11; each the native scalar pipeline's
     sketch); (b) the same CLI on config 2: the sharded K1 batch, the
     matrix by mesh_all_pairs_packed, phase 5's CSV bytes; (c)
     MeshSketcher on a 2 x 2 mesh whose four slots are cuda:0: config 1's
     genomes through the compact ring of sketch_packed (each the native
     scalar pipeline's sketch),
     chromosome A of config 5 through the mesh's sketch_file_streaming
     (phase 7's sketch), all_pairs_intersections over config 2's sketches
     (phase 5's matrix); (d) MeshDevicePipeline on phase 8(b)'s 10,240
     device genomes on a 1 x 1 and on the 2 x 2 mesh (phase 8(b)'s
     matrix and counts), each once more under torch.profiler; (e) two
     processes over gloo, both on cuda:0, running the driver with --mesh
     auto on config 2 (both CSVs phase 5's bytes).  Slots that share the
     card run one after another: their walls show no scaling;
 14. the bit-tight slab transport on phase 6's sketches: (a) K12 against
     its plain version bit for bit at phase 6's block shape (128 x 32,768,
     40-bit keys), timed with CUDA events and torch.profiler (also with
     the L2 flushed between launches) beside its byte bound, and the
     tight presort of block 0 against the word presort; (b)
     blocked_all_pairs over the sketcher's host source by the tight and
     the word transports in turns (tight, words, words, tight),
     each with its wall, host pack and stack thread-ms, bytes uploaded and
     a profiled rerun's device sums of K12, K5, K10, K6 and the
     host-to-device copies; every matrix phase 6's; (c) the route phase
     6's all_pairs_intersections took.
Phase 2 also holds K7 against its plain version at a streaming segment's
shape (G = 1, n = 2^25, K = 64), a pipeline dispatch's (G = 32, n = 2^21,
K = 8) and with K = 512 real bounds; the seed-batch modes at config 3's
shape (8 seeds over one genome, n = 2^23): K1's against its plain version
and 8 single-seed launches, K7's (phase 9's launch) over the compact
upload of the same genome against its plain version and K1's output;
K11 at n = 2^23; K8 (register tiles that stop at the run and store odd
runs reversed, K5's levels above 4,096) at _finish_runs shapes (8 rows of
2 runs of 2,048: one launch; 1 row of 8 runs of 32,768) and K9 (a sort
that keeps each tile's cut and never merges what the cut drops) at tiled
shapes (4 tiles at capacity 2,048, 16 at 8,192), each timed at both.
Every sketch of phases 3-5 and 7 must equal the native C++ scalar
pipeline's (native/sketchlib.cpp) and every CSV value the host math on
native intersections of those sketches; phase 6's matrix must have the
counts on its diagonal, be symmetric, and equal native merges on every pair
of two whole blocks and on a seeded sample of 2,000 pairs.  Phase 8(a)'s
CSV must equal the two-step path's, 64 sampled sketches the native ones,
and the pipeline's matrix among those 64 native merges of them; phase
8(b)'s matrix must be symmetric with the counts on its
diagonal, and 8 sampled sketches (and their pairs) must equal the native
pipeline on their genomes' codes drawn again.  Phase 12(c)'s matrix must
be symmetric with the counts on its diagonal, equal native merges on
every pair of block 0 and the last block and on a seeded sample of 2,000
pairs, and equal the in-core route on its leading 4,096 x 4,096 block.
Phases 9 and 10 hold every
sketch to the native scalar pipeline (phase 9 with each seed's mask and
salt).  The kernels' launch counters are set to 0 before each of the paths
(phases 3-4, 5, 6, 7, 8a, 8b, 9, 10a, 10b, 10c, 12a's two runs, 12b's
three, 12c and 12e, 13a-13d's, 14b's four; each bench run and 13e's ranks
in their own processes) and read after it; each kernel must have been
launched by the path that uses it, K7 by phases 7, 8a, 8b, 9, 13d and the
bench's multiseed, stream and e2e runs, K1, K3-K7, K10 and K11 by phase
13, and K12 by phases 6 and 14b's tight turns.

K6's compiled code must hold tensor-core instructions (IMMA or IGMMA in
every pw instance, from cuobjdump -sass).

The extract kernels' compiled code (the five instances of slide_kernel:
K1, K7 and K11, K1's and K7's seed-batch modes) must hold no CALL (the
64-bit division routine: the filter is a multiply-high), and the build's
-Xptxas=-v registers and spills of those instances and of the sorts' kernels
are printed.

Output: the card's name and power limit, a JSON line of per-kernel results
({"kernels": [...]}: launches on the paths, max_abs_err, kernel, plain and
torch.sort-yardstick times, and the bound from the kernel's bytes or, for
K1, K7 and K11, the instructions a window cannot skip at its timed shape
(the slide, the select, the hash and the filter, counted from probes'
compiled code with cuobjdump), for K6 its int8 tensor operations on the
runs it keeps; for K4, K5, K8, K9, K10 and K12 also the device launches
of one call, from torch.profiler; K1, K2, K3, K6, K8, K9, K11 and K12
their device time from torch.profiler beside the CUDA-event time, which
also holds the wrapper's host time (K8 and K9 at both their timed
shapes; a device time or launch count is null where the profiler
recorded no kernel event in three tries); K4 its device time by kernel,
its grids and its time at kw 1-4; K7 its seed-batch launch; K6 at its
four timed shapes (config 2, the 4-clade macro-tile, macro-tiles of
related and of unrelated blocks like the all-pairs cell's), each with
its kept runs, which the kernel's own count must equal, and its byte
and tensor bounds, K3 with the grids the profiler recorded), a line of
the profiled sums of K4, K7, K2, K5, K10, K6, K3 and K12 over phases 6, 7
and 8(b) with the bytes of K2 and K3 on those paths and K4's launches by
grid in 8(b), a line of phase 14's route and turns, and as the LAST line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
TOLERANCE = 0        # integer keys and counts: every comparison is exact
GENOMES = 8          # phase 3: the native host merge's largest G
CONFIG2_GENOMES = 100
BLOCKED_GENOMES = 4096
# Phase 12(c): 129 blocks of 128 sketches of ~25,000 40-bit keys at capacity
# 32,768 (a 5-Mnt genome at w = 20, scale 200), drawn from 64 clade pools of
# 40,000 keys: the in-core slab and cache would pass the 8 GiB budget.  The
# leading 32 blocks are checked against the in-core route.
OUT_OF_CORE = {"genomes": 16512, "cap": 32768, "count": 25000, "pool": 40000,
               "lead_blocks": 32}
SEGMENT = 1 << 24    # streaming segment (sketch_file_streaming's default)
CONFIG4_FILES = 640  # 5 blocks of 128: past the pipeline's 512-genome route
CONFIG4_GENOMES = 10240
CONFIG4_NT = 1_550_000
M32 = 0xFFFFFFFF
CONFIG3_SEEDS = 8    # phase 9: mask seeds 0..7
LAMBDA_NT = 48_502   # phase 10(b): phage lambda's length
# Phase 11: the port's bench (python -m spaced_kmer_sketching_tpu_torch.bench)
# one subprocess a run, with the hand-written kernels each run must launch
# (its line's `launches`); the sketch mode's finish adds its route's kernels.
BENCH_RUNS = (
    ("sketch", ["--mode", "sketch"], ("K1", "K3", "K4")),
    ("multiseed", ["--mode", "multiseed"], ("K7", "K3", "K4")),
    ("allpairs ondevice", ["--mode", "allpairs", "--ondevice"], ("K5", "K6")),
    ("allpairs probe", ["--mode", "allpairs", "--probe"], ()),
    ("allpairs blocked", ["--mode", "allpairs", "--blocked", "--genomes",
                          "512"], ("K5", "K10", "K6")),
    ("stream", ["--mode", "stream", "--nt", "33554432"], ("K7", "K3", "K4")),
    ("e2e codes", ["--mode", "e2e", "--e2e-source", "codes", "--genomes",
                   "256"], ("K7", "K3", "K4", "K5", "K10", "K6")),
    ("e2e device", ["--mode", "e2e", "--e2e-source", "device", "--genomes",
                    "1024"], ("K7", "K3", "K4", "K5", "K10", "K6")),
    ("e2e device mesh", ["--mode", "e2e", "--e2e-source", "device",
                         "--genomes", "1024", "--e2e-mesh"],
     ("K7", "K3", "K4", "K5", "K10", "K6")),
)
ROUTE_KERNELS = {"tree": ("K2",), "runs": ("K8", "K5"), "tiled": ("K9",),
                 "sort": ()}
BENCH_WORKERS = 4
# The least time the card could take (NVIDIA's published H100 SXM peaks,
# at 700 W): bytes over the HBM rate, or instructions over the rate the
# schedulers dispatch them.
# The published 67 TFLOP/s of float32 is 132 SMs x 4 schedulers x 32 lanes
# x 2 (an FMA) x 1.98 GHz.  A scheduler dispatches one warp instruction a clock
# whatever its pipe (integer ALU, IMAD on the FMA pipe, loads, branches),
# so no instruction stream runs faster than 67e12 / 2 thread-instructions
# a second.  The extract kernels' instructions a window are counted from
# their SASS (extract_op_counts).
# The kernels of the profiled paths, by the names the profiler shows: K4's,
# K5's and K10's in csrc/sort.cu, K7's in csrc/extract.cu, K6's in
# csrc/gram_tiles.cu, K2's and K3's three in csrc/compact.cu.
PATH_KERNELS = {"K4": ("reg_tile_sort_kernel", "sort_level_kernel"),
                "K7": ("slide_kernel",), "K2": ("compact_rows_kernel",),
                "K5": ("merge_level_kernel", "merge_runs_smem_kernel"),
                "K10": ("merge_pair_kernel",), "K6": ("gram_mma_kernel",),
                "K3": ("compact_count_kernel", "compact_offset_kernel",
                       "compact_scatter_kernel"),
                "K12": ("tight_gid_planes_kernel",)}
HBM_BYTES_PER_S = 3.35e12
INSTRUCTIONS_PER_S = 67e12 / 2
INT8_OPS_PER_S = 1979e12     # dense int8 tensor-core operations
# Probes of csrc/extract.cu's device functions, compiled like the library
# and read with cuobjdump: each is one thread's frame (its index, six
# 64-bit loads, one store) around one piece of a window's work, so a
# probe's instructions less probe_frame's are that piece's: the slide of
# both strands by one code (with the two code streams' shifts), the
# select (both strands masked, compared as 128-bit values, the smaller
# taken), and the hash with the filter.  The hash (modern) is fixed, as in
# every timed launch, so the compiler keeps only the code such a window
# runs: no legacy hash, no loop.
PROBES_CU = r"""
#include "extract.cu"

#define PROBE(name)                                                         \
  extern "C" __global__ void name(const uint64_t* q, uint64_t mask_lo,      \
                                  uint64_t mask_hi, uint64_t salt,          \
                                  uint64_t magic, uint32_t scale, int sh1,  \
                                  int sh2, uint64_t* out)
#define PROBE_FRAME                                                         \
  constexpr bool legacy = false;                                            \
  const int64_t t = blockIdx.x * 128ll + threadIdx.x;                       \
  const sks::Seed sd{mask_lo, mask_hi, salt};                               \
  const sks::Filter filt{magic, scale, sh1, sh2};                           \
  const uint64_t a = q[6 * t], b = q[6 * t + 1], c = q[6 * t + 2],          \
                 d = q[6 * t + 3], e = q[6 * t + 4], f = q[6 * t + 5];

PROBE(probe_frame) {
  PROBE_FRAME
  out[t] = a ^ b ^ c ^ d ^ e ^ f;
}
PROBE(probe_slide) {
  PROBE_FRAME
  sks::Strands st{a, b, c, d};
  sks::slide(st, static_cast<uint32_t>(e & 3), static_cast<uint32_t>(f & 3));
  out[t] = st.f_lo ^ st.f_hi ^ st.s_lo ^ st.s_hi ^ (e >> 2) ^ (f >> 2);
}
PROBE(probe_select) {
  PROBE_FRAME
  const sks::Strands st{a, b, c, d};
  uint64_t lo, hi;
  sks::strand_key(st, sd, lo, hi);
  out[t] = lo ^ hi ^ e ^ f;
}
PROBE(probe_hash) {
  PROBE_FRAME
  out[t] = sks::fmh_keep(sks::hash_bitset128(a, b, legacy), sd.salt, filt)
               ? c ^ d : e ^ f;
}
"""
PROBES = ("probe_frame", "probe_slide", "probe_select", "probe_hash")
SASS_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profiled(fn):
    """fn() once under torch.profiler, device activity only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _kernel_sums(prof) -> dict:
    out = {}
    for e in prof.key_averages():
        if "sks::" not in e.key:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        m = re.search(r"sks::(?:\(anonymous namespace\)::)?(\w+)", e.key)
        name = m.group(1) if m else e.key
        acc = out.setdefault(name, [0.0, 0])
        acc[0] += us / 1e3
        acc[1] += e.count
    return out


def _trace_grids(prof, names) -> dict:
    """The grid of each launch of the named kernels, as the profiler's
    trace records it (a kernel event's "grid" argument; None where the
    trace has none)."""
    from spaced_kmer_sketching_tpu_torch.utils.native import BUILD_DIR
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    grids = {}
    for e in events:
        m = re.search(r"sks::(?:\(anonymous namespace\)::)?(\w+)",
                      str(e.get("name", "")))
        if e.get("cat") == "kernel" and m and m.group(1) in names:
            grids.setdefault(m.group(1), []).append(
                (e.get("args") or {}).get("grid"))
    return grids


def profile_kernels(fn) -> dict:
    """Run fn() once under torch.profiler: {kernel: [device ms, launches]}
    of the port's kernels (those in namespace sks), summed over template
    instances.  Only device activity is traced, which keeps the profiled
    run short (phase 8(b) ~6 s on an H100 80GB HBM3 at 700 W, ~24 s with
    the host's ops traced too)."""
    return _kernel_sums(_profiled(fn))


def device_ms(fn, reps: int, tries: int = 3) -> float | None:
    """Device time of one fn() call: the port's kernels' summed device time
    over `reps` calls under torch.profiler, over reps, profiled again, up
    to `tries` times, while the profiler records none; None (null in the
    output) if it never does.  Where the host is slower than the kernels,
    time_ms measures the host's launch rate and this the kernels."""
    for _ in range(tries):
        kernels = profile_kernels(lambda: [fn() for _ in range(reps)])
        if kernels:
            return sum(ms for ms, _ in kernels.values()) / reps
    return None


def device_launches(fn, tries: int = 3) -> int | None:
    """Kernel launches on the device of one fn() call (torch.profiler),
    profiled again, up to `tries` times, while the profiler records none
    (it drops a run's events now and then); None if it never does."""
    for _ in range(tries):
        n = sum(n for _, n in profile_kernels(fn).values())
        if n:
            return n
    return None


def kernel_grids(fn, names) -> dict:
    """The grid of each launch of the named kernels in one fn() call."""
    return _trace_grids(_profiled(fn), names)


def profile_path(what: str, fn, grid_names=()) -> dict:
    """A second, profiled run of a path after its timed one: prints the
    summed device time and launches of the kernels of K4, K7, K2, K5, K10,
    K6 and K3 and of every kernel of the port, the bytes of K2 and K3 on
    the path (each compact_rows and compact_global call's input read once
    and its outputs written once, counted call by call, their time at the
    HBM rate, and that bound's share of the kernel's profiled sum) and,
    for the kernels in grid_names, how many launches had each grid."""
    from spaced_kmer_sketching_tpu_torch.ops import sketch as sketch_ops
    moved = {"K2": {"calls": 0, "bytes": 0}, "K3": {"calls": 0, "bytes": 0}}
    orig_rows, orig_global = sketch_ops.compact_rows, sketch_ops.compact_global

    def counting_rows(planes, k_out, **kw):
        out = orig_rows(planes, k_out, **kw)
        moved["K2"]["calls"] += 1
        moved["K2"]["bytes"] += nbytes(planes, *(t for t in out
                                                 if t is not None))
        return out

    def counting_global(planes):
        moved["K3"]["calls"] += 1
        moved["K3"]["bytes"] += 2 * nbytes(planes)
        return orig_global(planes)
    sketch_ops.compact_rows = counting_rows
    sketch_ops.compact_global = counting_global
    t0 = time.perf_counter()
    try:
        prof = _profiled(fn)
    finally:
        sketch_ops.compact_rows = orig_rows
        sketch_ops.compact_global = orig_global
    wall = time.perf_counter() - t0
    kernels = _kernel_sums(prof)
    sums = {key: [sum(kernels.get(n, [0.0, 0])[i] for n in names)
                  for i in (0, 1)] for key, names in PATH_KERNELS.items()}
    for key, m in moved.items():
        m["bound_ms"] = m["bytes"] / HBM_BYTES_PER_S * 1e3
        m["share_of_bound"] = (m["bound_ms"] / sums[key][0]
                               if sums[key][0] else None)
    grids = {}
    for name, gs in _trace_grids(prof, grid_names).items():
        for grid in gs:
            key = str(grid)
            grids.setdefault(name, {})[key] = grids.get(name, {}).get(key,
                                                                      0) + 1
    print(f"{what} profile ({wall:.3f} s wall, profiled): "
          + ", ".join(f"{k} {v[0]:.3f} ms device over {v[1]} launches"
                      for k, v in sums.items())
          + f"; K2 bytes {json.dumps(moved['K2'])}; K3 bytes "
          + json.dumps(moved["K3"]) + "; every kernel [ms, launches] "
          + json.dumps({k: [round(v[0], 3), v[1]]
                        for k, v in sorted(kernels.items())})
          + (f"; launches by grid {json.dumps(grids)}" if grids else ""))
    sums["K2 bytes"] = moved["K2"]
    sums["K3 bytes"] = moved["K3"]
    if grids:
        sums["grids"] = grids
    return sums


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_: float, ops: float = 0.0, int8_ops: float = 0.0) -> dict:
    """bound_ms and bound_by of work that moves `bytes_` (each input read
    once, each output written once), executes `ops` thread-instructions
    and `int8_ops` int8 tensor-core operations."""
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = max(ops / INSTRUCTIONS_PER_S, int8_ops / INT8_OPS_PER_S) * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "operations" if o_ms > b_ms else "bytes"}


def sass_opcodes(path: pathlib.Path) -> dict:
    """The opcodes (NOPs left out) of every kernel in a library or cubin,
    by its (mangled) name, from `cuobjdump -sass`."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    tool = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    ops, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            name = head.group(1)
            ops[name] = []
            continue
        op = SASS_INSTRUCTION.search(line)
        if name is not None and op and op.group(1) != "NOP":
            ops[name].append(op.group(1))
    return ops


def sass_instructions(path: pathlib.Path) -> dict:
    """Static instruction count of every kernel (sass_opcodes)."""
    return {k: len(v) for k, v in sass_opcodes(path).items()}


def k6_tensor_cores(so: pathlib.Path) -> dict:
    """K6's compiled code (every pw instance of gram_mma_kernel in the
    library): its tensor-core instructions, IMMA (mma.sync) or IGMMA
    (wgmma), counted by opcode; fails if an instance has none."""
    found = {name: [op for op in ops if op.startswith(("IMMA", "IGMMA"))]
             for name, ops in sass_opcodes(so).items()
             if "gram_mma_kernel" in name}
    need(len(found) == 5 and all(found.values()),
         f"K6 instances without tensor-core instructions: "
         f"{ {k: len(v) for k, v in found.items()} }")
    return {op: sum(v.count(op) for v in found.values())
            for op in sorted({op for v in found.values() for op in v})}


def k6_kept_runs(sw, gidbits: int, gp: int, split=None) -> int:
    """Runs of a packed stream that can add to K6's output, summed over its
    128 x 128 tiles, as the kernel keeps them: an entry in the tile's row
    range and one in its column range, or two in range on a diagonal tile
    of full mode.  Each kept run costs 2 x 128 x 128 tensor operations."""
    import torch
    pw = sw.shape[0]
    w = sw.reshape(pw, -1)
    gmask = (1 << gidbits) - 1
    key = torch.cat([(w[0] & ~gmask)[None], w[1:]])
    bnd = torch.ones(w.shape[1], dtype=torch.bool, device=w.device)
    bnd[1:] = (key[:, 1:] != key[:, :-1]).any(0)
    valid = w[pw - 1] >= 0
    rid = (torch.cumsum(bnd.long(), 0) - 1)[valid]
    gid = (w[0] & gmask)[valid].long()
    nruns = int(rid[-1]) + 1 if rid.numel() else 0
    rows = gp if split is None else split
    c0 = 0 if split is None else split
    kept = 0
    for tr in range(rows // 128):
        for tc in range((gp - c0) // 128):
            r0, cg0 = tr * 128, c0 + tc * 128
            if split is None and tr > tc:
                continue

            def hits(lo):
                sel = (gid >= lo) & (gid < lo + 128)
                return torch.bincount(rid[sel], minlength=nruns)
            if split is None and tr == tc:
                kept += int((hits(r0) >= 2).sum())
            else:
                kept += int(((hits(r0) > 0) & (hits(cg0) > 0)).sum())
    return kept


def extract_op_counts(build_dir: pathlib.Path) -> dict:
    """Instructions a window of the extract kernels' function needs, from
    the compiled probes (PROBES_CU): {"K1": (every window, every valid
    window), "K11": (...), "sass": each probe's count}.

    The count is the work a window cannot skip, not what a kernel issues:
    every window slides both strands by one code; a valid one of K1 and K7
    also masks and compares them (the select) and hashes and filters the
    key.  K11 computes the key at every window, so every window pays the
    slide and the select and a valid one the hash and the filter.  No run
    search or plane read, no strand rebuild, no row ranking and no store
    is charged: the three kernels share one sliding body, and the bound
    says how far that body is from the work itself."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        src = pathlib.Path(tmp) / "probes.cu"
        src.write_text(PROBES_CU)
        cubin = src.with_suffix(".cubin")
        subprocess.run([build._nvcc(), "-arch=sm_90a", "-std=c++17", "-O3",
                        "-cubin", "-I", str(build.CSRC), str(src), "-o",
                        str(cubin)], check=True, capture_output=True)
        sass = sass_instructions(cubin)
    need(set(PROBES) <= set(sass), f"probe SASS functions: {sorted(sass)}")
    c = {name[len("probe_"):]: sass[name] for name in PROBES}
    slide, select, hash_ = (c[k] - c["frame"] for k in ("slide", "select",
                                                         "hash"))
    need(min(slide, select, hash_) > 0, f"probe SASS counts out of order: {c}")
    return {"K1": (slide, select + hash_), "K11": (slide + select, hash_),
            "sass": c}


def extract_instance(name: str):
    """Which extract launch a compiled slide_kernel instance serves, from
    its mangled name: K1 (run-id plane, compacted rows), K7 (run bounds)
    or K11 (every window), " seeds" added for seed-batch mode; None for
    any other kernel."""
    if "slide_kernel" not in name:
        return None
    key = ("K11" if "EmitAll" in name else "K7" if "RunBounds" in name
           else "K1")
    return key + (" seeds" if "SeedRows" in name else "")


EXTRACT_INSTANCES = ("K1", "K1 seeds", "K7", "K7 seeds", "K11")


def no_division_calls(so: pathlib.Path) -> dict:
    """The extract kernels' compiled code (the five slide_kernel instances
    of K1, K7 and K11): fails if any holds a CALL, which is how a 64-bit
    division or remainder compiles (nvcc's subroutine), or if an instance
    is missing.  Returns each instance's instruction count."""
    found = {extract_instance(n): ops for n, ops in sass_opcodes(so).items()
             if extract_instance(n)}
    calls = {n: [op for op in ops if op.startswith("CALL")]
             for n, ops in found.items()}
    need(sorted(found) == sorted(EXTRACT_INSTANCES),
         f"extract instances in the SASS: {sorted(found)}")
    need(not any(calls.values()),
         f"extract kernels with CALLs (a division routine?): {calls}")
    return {n: len(ops) for n, ops in sorted(found.items())}


def kernel_label(name: str):
    """ptxas_usage's label of a kernel: its extract instance, the sorts'
    kernels (K4's, K8's and K9's) by name, else None."""
    return extract_instance(name) or next(
        (k for k in ("reg_tile_sort_kernel", "sort_level_kernel",
                     "cut_merge_kernel") if k in name), None)


def ptxas_usage(so: pathlib.Path, label=kernel_label) -> dict:
    """Registers and spill bytes of each kernel instance that `label`
    names, from the build's -Xptxas=-v log beside the library."""
    usage, name = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = label(m.group(1))
            if name is not None:
                usage.setdefault(name, []).append({})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name][-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name][-1]["registers"] = int(m.group(1))
    return usage


def valid_windows(rid: np.ndarray, window: int) -> int:
    """Windows of a (G, n) run-id plane whose first and last codes share a
    run id >= 0."""
    a, b = rid[:, :rid.shape[1] - window + 1], rid[:, window - 1:]
    return int(((a == b) & (a >= 0)).sum())


def extract_ops(windows: int, valid: int, counts) -> int:
    """Instructions of an extract launch's function: every window pays
    counts[0], a valid one also counts[1] (extract_op_counts)."""
    return windows * counts[0] + valid * counts[1]


def sort_key64(planes):
    """(2, ..., N) int32 planes (u32 words, word 1 most significant) as one
    int64 per key whose signed order is the planes' unsigned order: the
    input of the torch.sort yardstick (library_ms)."""
    import torch
    hi = (planes[1] ^ torch.iinfo(torch.int32).min).long()
    return (hi << 32) | (planes[0].long() & M32)


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over the outputs, as integers."""
    err = 0
    for a, b in zip(got, want):
        need(a.shape == b.shape and a.dtype == b.dtype,
             f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# --- phase 2: each kernel against its plain version -------------------------

def phase_kernels(dev, rng, timer, ops, n=8388608, length=5_000_000):
    """K1-K4 against their plain versions at the main path's shapes: n
    windows of a `length`-nt genome in three runs (G = 2), config 1's
    capacity and scale; `ops` from extract_op_counts.  Returns per-kernel
    max_abs_err and times."""
    import torch

    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.ops import sketch as sk
    from spaced_kmer_sketching_tpu_torch.ops.cuda import compact, extract, sort
    from spaced_kmer_sketching_tpu_torch.utils import boosthash
    from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

    g, scale = 2, 200
    codes = rng.integers(0, 4, (g, n)).astype(np.uint8)
    rid = np.full((g, n), -1, np.int32)
    cut = length // 5 * 2
    rid[:, :cut] = 0                             # three runs, then padding
    rid[:, cut + 50:2 * cut] = 1
    rid[:, 2 * cut + 100:length] = 2
    packed = torch.from_numpy(extract.pack2bit_rows(codes).view(np.int32)
                              ).to(dev)
    run_id = torch.from_numpy(rid).to(dev)
    capacity = SketchConfig(window=20, k=16).capacity_for(length)
    res = {}

    # K1 at every key-word bucket; timed at kw = 2 (config 1's w = 20)
    err = 0
    for window, k in ((16, 12), (20, 16), (40, 30), (50, 40)):
        mask = spaced_seed_mask(window, k, 0)
        salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
        kw = sk.finish_words(window)
        nw = n - (16 * (kw - 1) + 1) + 1
        k_slots = sk._k_slots_for(nw, scale, capacity)
        args = dict(window=window, nw=nw, scale=scale, variant="modern",
                    k_slots=k_slots, out_words=kw)

        def kern():
            return extract.extract_compact(packed, run_id, mask.words_u32,
                                           salt, **args)

        def plain():
            return extract.extract_compact_plain(packed, run_id,
                                                 mask.words_u32, salt, **args)
        got, want = kern(), plain()
        err = max(err, max_abs_err(got, want))
        print(f"K1 w={window} kw={kw} k_slots={k_slots} "
              f"planes={tuple(got[0].shape)} kept={int(got[1].sum())} "
              f"max_abs_err={max_abs_err(got, want)}")
        if kw == 2:
            res["K1"] = dict(ms=timer(kern, 20),
                             device_ms=device_ms(kern, 20),
                             plain_ms=timer(plain, 3))
            res["K1"].update(bound(
                nbytes(packed, run_id, *got),
                extract_ops(g * got[1].shape[1] * 128,
                            valid_windows(rid, window), ops["K1"])))
            k1_planes, k1_slots = got[0], k_slots
    res["K1"]["max_abs_err"] = err

    # K2 on the planner's chain over the real K1 output (kw = 2)
    kw, _, m = k1_planes.shape
    stages = sk._tree_chain(m, 128.0 / k1_slots, scale, capacity, g)
    need(bool(stages), f"no compaction chain planned for m={m}")
    planes, err = k1_planes, 0
    for si, (srows, k_out) in enumerate(stages):
        x = planes.reshape(kw, g, srows, 128)
        last = si == len(stages) - 1
        got = compact.compact_rows(x, k_out, with_counts=last)
        want = compact.compact_rows_plain(x, k_out, with_counts=last)
        e = max_abs_err([t for t in got if t is not None],
                        [t for t in want if t is not None])
        err = max(err, e)
        print(f"K2 stage {si}: rows={srows} k_out={k_out} max_abs_err={e}")
        if si == 0:
            res["K2"] = dict(
                ms=timer(lambda: compact.compact_rows(x, k_out), 20),
                device_ms=device_ms(lambda: compact.compact_rows(x, k_out),
                                    20),
                plain_ms=timer(lambda: compact.compact_rows_plain(x, k_out),
                                 5),
                **bound(nbytes(x) * (1 + k_out / 128)))
        planes = got[0].reshape(kw, g, srows * k_out)
    res["K2"]["max_abs_err"] = err

    # K3 at the finish's two sizes: the padded chain output, the capacity;
    # then G 1-128 and n 1 to 2^22 with all-valid and all-sentinel rows
    mp = 1 << (max(planes.shape[2], capacity) - 1).bit_length()
    chain_out = sk._pad_to(planes, mp)
    got = compact.compact_global(chain_out)
    err = max_abs_err([got], [compact.compact_global_plain(chain_out)])
    holed = sort.sort_rows(got[:, :, :capacity].contiguous())
    holed[:, :, ::5] = -1
    err = max(err, max_abs_err([compact.compact_global(holed)],
                               [compact.compact_global_plain(holed)]))
    print(f"K3 n={mp} and n={capacity}: max_abs_err={err}")
    for kw, g3, n3 in ((1, 1, 1), (2, 1, 2049), (3, 128, 4097),
                       (4, 2, 131071), (1, 1, 1 << 22), (2, 3, (1 << 21) + 5)):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, g3, n3),
                          dtype=torch.int32, device=dev)
        x[:, torch.rand((g3, n3), device=dev) < 0.4] = -1
        x[:, 0] = x[:, 0] & 0x7FFFFFFF            # row 0: every slot valid
        if g3 > 1:
            x[:, -1] = -1                         # the last: none
        e = max_abs_err([compact.compact_global(x)],
                        [compact.compact_global_plain(x)])
        err = max(err, e)
        print(f"K3 kw={kw} G={g3} n={n3}: max_abs_err={e}")
    grids = kernel_grids(lambda: compact.compact_global(chain_out),
                         PATH_KERNELS["K3"])
    g3, n3 = chain_out.shape[1:]
    print(f"K3 timed shape {tuple(chain_out.shape)}: grids the profiler "
          f"recorded {json.dumps(grids)} (a row of {n3} slots is "
          f"{-(-n3 // 2048)} tiles of 2,048)")
    count_grid = grids.get("compact_count_kernel", [None])[0]
    need(count_grid is None or list(count_grid[:2]) == [-(-n3 // 2048), g3],
         f"K3's count launch has grid {count_grid}, not a block a tile")
    res["K3"] = dict(
        max_abs_err=err, grid=grids,
        device_ms=device_ms(lambda: compact.compact_global(chain_out), 20),
        ms=timer(lambda: compact.compact_global(chain_out), 20),
        plain_ms=timer(lambda: compact.compact_global_plain(chain_out), 5),
        **bound(2 * nbytes(chain_out)))

    # K4 at 65,536 keys, G = 2, kw = 1..4, with duplicates and sentinels,
    # each kw timed; then N = 1,024 to 2^20 with all-sentinel and all-equal
    # rows
    err, by_kw = 0, {}
    for kw in (1, 2, 3, 4):
        z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, 2, 65536),
                          dtype=torch.int32, device=dev)
        z[:, :, ::3] = z[:, :, 1:2]
        z[:, :, -1000:] = -1
        e = max_abs_err([sort.sort_rows(z)], [sort.sort_rows_plain(z)])
        err = max(err, e)
        by_kw[kw] = timer(lambda: sort.sort_rows(z), 20)
        print(f"K4 kw={kw} n=65536 G=2 max_abs_err={e} {by_kw[kw]} ms")
        if kw == 2:
            key64 = sort_key64(z)
            res["K4"] = dict(ms=by_kw[kw],
                             plain_ms=timer(lambda: sort.sort_rows_plain(z),
                                              5),
                             library_ms=timer(
                                 lambda: torch.sort(key64, dim=-1), 20),
                             device_launches=device_launches(
                                 lambda: sort.sort_rows(z)),
                             device={k: [v[0] / 20, v[1] / 20] for k, v in
                                     profile_kernels(lambda: [
                                         sort.sort_rows(z)
                                         for _ in range(20)]).items()},
                             grid=kernel_grids(lambda: sort.sort_rows(z),
                                               PATH_KERNELS["K4"]),
                             **bound(2 * nbytes(z)))
    for kw, g4, n4 in ((1, 3, 1024), (2, 3, 1024), (3, 3, 2048),
                       (4, 3, 4096), (2, 3, 16384), (3, 3, 8192),
                       (1, 2, 1 << 20), (2, 3, 1 << 20), (3, 1, 1 << 20),
                       (4, 2, 1 << 20)):
        z = torch.randint(-2 ** 31, 2 ** 31 - 1, (kw, g4, n4),
                          dtype=torch.int32, device=dev)
        z[:, 0, ::5] = z[:, 0, 2:3]
        z[:, 1:2] = -1                            # all sentinels
        z[:, 2:] = z[:, 2:, :1]                   # all equal
        e = max_abs_err([sort.sort_rows(z)], [sort.sort_rows_plain(z)])
        err = max(err, e)
        print(f"K4 kw={kw} n={n4} G={g4} max_abs_err={e}")
    res["K4"].update(max_abs_err=err, ms_by_kw=by_kw)
    for name, r in res.items():
        need(r["max_abs_err"] <= TOLERANCE,
             f"{name} disagrees with its plain version: {r}")
    return res


def phase_k7(dev, rng, timer, ops):
    """K7 against its plain version at (a) a streaming segment's shape (G =
    1, n = 2^25, K = 64 with 5 real bounds, rid0 = 7, vlen < body), (b) a
    pipeline dispatch's (G = 32, n = 2^21, K = 8) and (c) K = 512 real
    bounds (G = 4, n = 2^21).  Timed at (a)."""
    import torch

    from spaced_kmer_sketching_tpu_torch.ops import sketch as sk
    from spaced_kmer_sketching_tpu_torch.ops.cuda import extract
    from spaced_kmer_sketching_tpu_torch.utils import boosthash
    from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

    window, scale = 20, 200
    mask = spaced_seed_mask(window, 16, 0)
    salt = boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")
    res = {"max_abs_err": 0}
    cases = [("a: streaming segment", 1, 1 << 25, 64, 5, 7, 3000),
             ("b: pipeline dispatch", 32, 1 << 21, 8, 3, 0, 40000),
             ("c: K = 512 real bounds", 4, 1 << 21, 512, 512, 2, 100)]
    for what, g, n, k, real, rid0, short in cases:
        body = extract.packed_body(n)
        p = torch.randint(-2 ** 31, 2 ** 31, (g, body // 16),
                          dtype=torch.int32, device=dev)
        b = np.full((g, k), body, np.int32)
        for i in range(g):
            b[i, :real] = np.sort(rng.choice(n - short, real, replace=False))
        bounds = torch.from_numpy(b).to(dev)
        rid0_t = torch.full((g,), rid0, dtype=torch.int32, device=dev)
        vlen = torch.full((g,), n - short, dtype=torch.int32, device=dev)
        nw = n - window + 1
        args = dict(window=window, nw=nw, scale=scale, variant="modern",
                    k_slots=sk._k_slots_for(nw, scale, 1 << 17),
                    out_words=sk.finish_words(window))

        def kern():
            return extract.extract_compact_raw(p, bounds, rid0_t, vlen,
                                               mask.words_u32, salt, **args)

        def plain():
            return extract.extract_compact_raw_plain(
                p, bounds, rid0_t, vlen, mask.words_u32, salt, **args)
        got, want = kern(), plain()
        e = max_abs_err(got, want)
        res["max_abs_err"] = max(res["max_abs_err"], e)
        kept = int(got[1].sum())
        need(kept > 0, f"K7 {what}: nothing kept")
        if what.startswith("a"):
            res.update(ms=timer(kern, 20), plain_ms=timer(plain, 3))
            starts = np.concatenate([[0], b[0, :real], [n - short]])
            valid = g * int(np.maximum(0, np.diff(starts) - window + 1).sum())
            res.update(bound(
                nbytes(p, bounds, rid0_t, vlen, *got),
                extract_ops(g * (n - short), valid, ops["K1"])))
            print(f"K7 timing at {what}: kernel {res['ms']} ms, plain "
                  f"{res['plain_ms']} ms")
        print(f"K7 {what}: G={g} n={n} K={k} planes="
              f"{tuple(got[0].shape)} kept={kept} max_abs_err={e}")
        del got, want
    need(res["max_abs_err"] <= TOLERANCE,
         f"K7 disagrees with its plain version: {res}")
    return {"K7": res}


def phase_seed_and_fallback_kernels(dev, rng, timer, ops, n=8388608,
                                    length=5_000_000):
    """The seed-batch modes at config 3's shape (8 seeds over one genome of
    two runs, n = 2^23, w = 20): K1's (also against 8 single-seed K1
    launches) and K7's over the same genome's compact upload (packed_body(n)
    words, the run starts, vlen; also against K1's seed-batch output); K11
    (one genome, n = 2^23); K8 at _finish_runs shapes (kw 2: 8 rows of 2
    runs of 2,048, 1 row of 8 runs of 32,768) and K9 at tiled shapes (kw 2:
    4 tiles and capacity 2,048, 16 tiles and capacity 8,192; sparse valid
    keys), each against its plain version.  Timed at the first shape of
    each."""
    import torch

    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.ops import sketch as sk
    from spaced_kmer_sketching_tpu_torch.ops.cuda import extract, sort
    from spaced_kmer_sketching_tpu_torch.utils import boosthash
    from spaced_kmer_sketching_tpu_torch.utils.masks import spaced_seed_mask

    window, scale = 20, 200
    codes = rng.integers(0, 4, (1, n)).astype(np.uint8)
    rid = np.full((1, n), -1, np.int32)
    rid[0, :length // 2] = 0                  # two records, then padding
    rid[0, length // 2:length] = 1
    masks = [spaced_seed_mask(window, 16, s) for s in range(CONFIG3_SEEDS)]
    salts = [boosthash.fmh_salt(m.lo, m.hi, window, 1, "modern")
             for m in masks]
    mw = np.stack([m.words_u32 for m in masks])
    c = torch.from_numpy(codes).to(dev)
    packed = extract.pack_codes(c)
    run_id = torch.from_numpy(rid).to(dev)
    nw = n - window + 1
    capacity = SketchConfig(window=window, k=16).capacity_for(
        length - window + 1)
    k_slots = sk._k_slots_for(nw, scale, capacity)
    args = dict(window=window, nw=nw, scale=scale, variant="modern",
                k_slots=k_slots, out_words=sk.finish_words(window))
    valid = valid_windows(rid, window)
    res = {}

    def seeds():
        return extract.extract_compact(packed, run_id, mw, salts, **args)

    def singles():
        return [extract.extract_compact(packed, run_id, mw[i], salts[i],
                                        **args) for i in range(len(salts))]

    def seeds_plain():
        return extract.extract_compact_plain(packed, run_id, mw, salts, **args)
    got = seeds()
    err = max_abs_err(got, seeds_plain())
    ones = singles()
    err = max(err, max_abs_err(got, [torch.cat([o[0] for o in ones], dim=1),
                                     torch.cat([o[1] for o in ones])]))
    del ones
    seed_ops = extract_ops(len(salts) * got[1].shape[1] * 128,
                           len(salts) * valid, ops["K1"])
    res["K1 seeds"] = dict(
        max_abs_err=err, ms=timer(seeds, 10), device_ms=device_ms(seeds, 10),
        singles_ms=timer(singles, 5),
        plain_ms=timer(seeds_plain, 2),
        **bound(nbytes(packed, run_id, *got), seed_ops))
    print(f"K1 seed-batch mode: {len(salts)} seeds over one genome, n={n} "
          f"planes={tuple(got[0].shape)} kept={int(got[1].sum())} "
          f"max_abs_err={err}; {res['K1 seeds']['ms']} ms against "
          f"{res['K1 seeds']['singles_ms']} ms for {len(salts)} single-seed "
          f"launches")

    # K7's seed-batch mode over the same genome's compact upload, as
    # sketch_packed_multiseed sends it
    body = extract.packed_body(n)
    p7 = torch.zeros((1, body // 16), dtype=torch.int32, device=dev)
    p7[:, :packed.shape[1]] = packed
    bounds = torch.tensor([[length // 2, body]], dtype=torch.int32,
                          device=dev)
    rid0 = torch.zeros(1, dtype=torch.int32, device=dev)
    vlen = torch.full((1,), length, dtype=torch.int32, device=dev)

    def seeds7():
        return extract.extract_compact_raw(p7, bounds, rid0, vlen, mw, salts,
                                           **args)

    def seeds7_plain():
        return extract.extract_compact_raw_plain(p7, bounds, rid0, vlen, mw,
                                                 salts, **args)
    got7 = seeds7()
    err = max(max_abs_err(got7, seeds7_plain()), max_abs_err(got7, got))
    res["K7 seeds"] = dict(
        max_abs_err=err, ms=timer(seeds7, 10), device_ms=device_ms(seeds7, 10),
        plain_ms=timer(seeds7_plain, 2),
        **bound(nbytes(p7, bounds, rid0, vlen, *got7), seed_ops))
    print(f"K7 seed-batch mode: the same {len(salts)} seeds over the compact "
          f"upload ({body // 16} words, bounds {bounds.tolist()}, vlen "
          f"{length}) max_abs_err={err} (against its plain version and K1's "
          f"seed-batch output); {res['K7 seeds']['ms']} ms")
    del got, got7

    def filt():
        return extract.extract_filter(c, run_id, mw[0], salts[0],
                                      window=window, scale=scale,
                                      variant="modern")

    def filt_plain():
        return extract.extract_filter_plain(c, run_id, mw[0], salts[0],
                                            window=window, scale=scale,
                                            variant="modern")
    got = filt()
    err = max_abs_err(got, filt_plain())
    res["K11"] = dict(
        max_abs_err=err, ms=timer(filt, 10), device_ms=device_ms(filt, 10),
        plain_ms=timer(filt_plain, 2),
        pack_ms=timer(lambda: extract.pack_codes(c), 10),
        **bound(nbytes(c, run_id, *got), extract_ops(nw, valid, ops["K11"])))
    print(f"K11 n={n} canon={tuple(got[0].shape)} kept={int(got[1].sum())} "
          f"max_abs_err={err}; {res['K11']['ms']} ms a call, of which the "
          f"device pack (pack_codes) {res['K11']['pack_ms']} ms; K11's "
          f"kernel {res['K11']['device_ms']} ms device")
    del got

    def keys(shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                             device=dev)
    err, shapes = 0, []
    for i, (g, runs, run) in enumerate([(8, 2, 2048), (1, 8, 32768)]):
        z = keys((2, g, runs * run))
        z[:, :, ::7] = z[:, :, 1:2]
        z[:, :, -run // 2:] = -1
        e = max_abs_err([sort.sort_runs(z, run)],
                        [sort.sort_runs_plain(z, run)])
        err = max(err, e)
        shapes.append(dict(
            shape=[2, g, runs, run], max_abs_err=e,
            ms=timer(lambda: sort.sort_runs(z, run), 20),
            device_ms=device_ms(lambda: sort.sort_runs(z, run), 20),
            device_launches=device_launches(lambda: sort.sort_runs(z, run))))
        print(f"K8 kw=2 G={g} {runs} runs of {run}: max_abs_err={e}; "
              f"{json.dumps(shapes[-1])}")
        if i == 0:
            key64 = sort_key64(z).reshape(g * runs, run)
            res["K8"] = dict(
                ms=shapes[-1]["ms"], device_ms=shapes[-1]["device_ms"],
                device_launches=shapes[-1]["device_launches"],
                plain_ms=timer(lambda: sort.sort_runs_plain(z, run), 5),
                library_ms=timer(lambda: torch.sort(key64, dim=-1), 20),
                **bound(2 * nbytes(z)))
    res["K8"].update(max_abs_err=err, timed_shapes=shapes)

    err, shapes = 0, []
    for i, (t, cap) in enumerate([(4, 2048), (16, 8192)]):
        z = torch.full((2, 1, t * sort.TILE), -1, dtype=torch.int32,
                       device=dev)
        hit = torch.rand(t * sort.TILE, device=dev) < cap / (2 * t * sort.TILE)
        z[:, 0, hit] = keys((2, int(hit.sum())))
        got = sort.sort_truncate(z, cap)
        e = max_abs_err([got], [sort.sort_truncate_plain(z, cap)])
        err = max(err, e)
        shapes.append(dict(
            shape=[2, 1, t, cap], max_abs_err=e,
            ms=timer(lambda: sort.sort_truncate(z, cap), 20),
            device_ms=device_ms(lambda: sort.sort_truncate(z, cap), 20),
            device_launches=device_launches(
                lambda: sort.sort_truncate(z, cap))))
        print(f"K9 kw=2 {t} tiles of {sort.TILE}, capacity {cap}, "
              f"{int(hit.sum())} valid keys: max_abs_err={e}; "
              f"{json.dumps(shapes[-1])}")
        if i == 0:
            key64 = sort_key64(z)
            res["K9"] = dict(
                ms=shapes[-1]["ms"], device_ms=shapes[-1]["device_ms"],
                device_launches=shapes[-1]["device_launches"],
                plain_ms=timer(lambda: sort.sort_truncate_plain(z, cap), 5),
                library_ms=timer(lambda: torch.sort(key64, dim=-1), 20),
                **bound(nbytes(z, got)))
    res["K9"].update(max_abs_err=err, timed_shapes=shapes)
    for name, r in res.items():
        need(r["max_abs_err"] <= TOLERANCE,
             f"{name} disagrees with its plain version: {r}")
    return res


def clade_keys(gen, dev, g, cap, pool, count, clades, key_bits, clade=None):
    """(g, cap, kw) int32 device sketches: genome i draws each key of its
    clade's pool ((i // 32) % clades, or clade[i] when a tensor of clade
    ids is given) with probability count / pool; pools are strictly
    ascending (random steps), so every sketch is sorted and unique,
    all-ones padded.  Words past the 62 random low bits are a slow ramp and
    a per-clade constant, so 128-bit keys stay ascending too."""
    import torch

    from spaced_kmer_sketching_tpu_torch.ops import u64ops
    from spaced_kmer_sketching_tpu_torch.ops.gram import _guard_words

    kw = _guard_words(key_bits)
    if clade is None:
        clade = (torch.arange(g, device=dev) // 32) % clades
    clades = int(clade.max()) + 1
    step = max(2, (1 << min(key_bits, 62)) // pool)
    low = torch.randint(1, step, (clades, pool), generator=gen, device=dev,
                        dtype=torch.int64).cumsum(1)
    words = [low & M32, low >> 32,
             (torch.arange(pool, device=dev) >> 10).expand(clades, pool),
             torch.randint(0, 1 << 31, (clades, 1), generator=gen,
                           device=dev).expand(clades, pool)][:kw]
    table = torch.stack([u64ops.as_i32(w) for w in words], -1)
    table = torch.cat([table, torch.full((clades, 1, kw), -1,
                                         dtype=torch.int32, device=dev)], 1)
    pick = torch.rand((g, pool), generator=gen, device=dev) < count / pool
    idx = torch.where(pick, torch.arange(pool, device=dev), pool)
    idx = idx.sort(dim=1).values[:, :cap]
    if pool < cap:
        idx = torch.cat([idx, torch.full((g, cap - pool), pool,
                                         device=dev)], 1)
    return table[clade[:, None], idx]


def zipf_clades(seed, g, collection=10240, species=1024, exponent=1.0):
    """Clade ids (0, 1, ...) of g genomes drawn without replacement from a
    collection of `collection` genomes in `species` species of Zipf sizes
    (size ~ rank^-exponent, at least 1), in a shuffled order: the species
    structure of the all-pairs cell (benchmark/configs/collection10k.json),
    where two blocks of 128 genomes share some 20-30 species."""
    w = np.arange(1, species + 1, dtype=np.float64) ** -exponent
    sizes = np.maximum(1, np.floor(collection * w / w.sum())).astype(int)
    drawn = np.random.default_rng(seed).permutation(
        np.repeat(np.arange(species), sizes))[:g]
    return np.unique(drawn, return_inverse=True)[1]


def packed_runs(keys, key_bits, gidbits):
    """(g, cap, kw) sketches -> (pw, g*cap/128, 128) packed planes whose
    cap-entry runs (one genome each) are ascending."""
    import torch

    from spaced_kmer_sketching_tpu_torch.ops import gram

    g, cap, _ = keys.shape
    pw = gram.pack_plan(key_bits, gidbits)
    gid = torch.arange(g, device=keys.device)[:, None].expand(g, cap)
    planes = gram._pack_gid_planes(keys, gid, key_bits, gidbits, pw)
    return planes.reshape(pw, g * cap // 128, 128)


def every_genome_key(keys):
    """keys (g, cap, kw) with the all-zero key, below every clade key, put
    first in every sketch (the last slot drops): a run held by every
    genome."""
    import torch
    zero = torch.zeros_like(keys[:, :1])
    return torch.cat([zero, keys[:, :-1]], 1)


def phase_gram_kernels(dev, timer, seed):
    """K5, K6 and K10 against their plain versions: K5 and K6 at config
    2's shapes (128 genome runs of 32,768, 40-bit keys, pw 2, gp 128), at
    pw 5 (128-bit keys), and K6 at pw 1, 3 and 4, at gp 512, at gp 2048
    (2,048 runs of 2,048 with a key in every genome) and at gp 8192 (a run
    of 8,192, open across chunk edges), full and split, and on empty and
    all-sentinel streams; K10 and the split K6 at a blocked
    macro-tile (two presorted blocks of 128 x 32,768, gidbits 8, gp 256).
    K6 is timed at config 2's shape, at that macro-tile and at two more
    like the all-pairs cell's (related blocks of Zipf species, unrelated
    blocks), each with its kept runs, counted by the kernel too, and its
    byte and tensor bounds.  Returns per-kernel max_abs_err and times."""
    import torch

    from spaced_kmer_sketching_tpu_torch.ops.cuda import gram_tiles, sort

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    res = {"K5": {"max_abs_err": 0}, "K6": {"max_abs_err": 0},
           "K10": {"max_abs_err": 0}}

    def hold(key, got, want, what):
        e = max_abs_err([got], [want])
        res[key]["max_abs_err"] = max(res[key]["max_abs_err"], e)
        print(f"{key} {what}: max_abs_err={e}")

    def k6_timing(what, args, split):
        gram_tiles.take_kept_runs(dev)
        got = gram_tiles.gram_tile_scan(*args, split=split)
        hold("K6", got, gram_tiles.gram_tile_scan_plain(*args, split=split),
             f"timed shape {what}")
        kept = k6_kept_runs(*args, split=split)
        counted = gram_tiles.take_kept_runs(dev)
        need(counted == kept, f"K6 at {what} counted {counted} kept runs, "
             f"the plain count is {kept}")
        sw = args[0]
        valid = int((sw.reshape(sw.shape[0], -1)[-1] >= 0).sum())
        ops = 2.0 * 128 * 128 * kept
        r = dict(shape=what, kept_runs=kept, valid_entries=valid,
                 device_ms=device_ms(lambda: gram_tiles.gram_tile_scan(
                     *args, split=split), 10),
                 ms=timer(lambda: gram_tiles.gram_tile_scan(*args,
                                                            split=split), 10),
                 plain_ms=timer(lambda: gram_tiles.gram_tile_scan_plain(
                     *args, split=split), 3),
                 bytes_bound_ms=(valid * sw.shape[0] * 4 + nbytes(got))
                 / HBM_BYTES_PER_S * 1e3,
                 tensor_bound_ms=ops / INT8_OPS_PER_S * 1e3,
                 **bound(nbytes(sw, got), int8_ops=ops))
        print(f"K6 timing at {what}: kernel {r['ms']} ms (device "
              f"{r['device_ms']} ms), plain {r['plain_ms']} ms, {kept} kept "
              f"runs, {valid} valid entries, byte bound "
              f"{r['bytes_bound_ms']:.5f} ms, tensor bound "
              f"{r['tensor_bound_ms']:.5f} ms")
        return r

    cases = [  # (what, genomes, cap, pool, count, key_bits, every, timed)
        ("config 2: 128 x 32768, 40-bit keys", 128, 32768, 32768, 25000, 40,
         False, True),
        ("pw 5: 128 x 32768, 128-bit keys", 128, 32768, 32768, 25000, 128,
         False, False),
        ("gp 2048: 2048 x 2048, 40-bit keys, a key in every genome", 2048,
         2048, 2048, 1500, 40, True, False),
        ("gp 8192: 8192 x 256, 40-bit keys, a key in every genome", 8192,
         256, 512, 200, 40, True, False),
        ("pw 1: 128 x 2048, 16-bit keys, a key in every genome", 128, 2048,
         2048, 1500, 16, True, False),
        ("pw 3: 512 x 1024, 60-bit keys", 512, 1024, 1024, 700, 60, False,
         False),
        ("pw 4: 256 x 4096, 90-bit keys, a key in every genome", 256, 4096,
         4096, 3000, 90, True, False)]
    shapes = []
    for what, g, cap, pool, count, kb, every, timed in cases:
        gidbits = max(1, (g - 1).bit_length())
        keys = clade_keys(gen, dev, g, cap, pool, count, 64, kb)
        if every:
            keys = every_genome_key(keys)
        runs = packed_runs(keys, kb, gidbits)
        del keys
        merged = sort.merge_sorted_runs(runs, cap // 128)
        hold("K5", merged, sort.merge_sorted_runs_plain(runs, cap // 128),
             f"{what}, pw {runs.shape[0]}")
        gram = gram_tiles.gram_tile_scan(merged, gidbits, g)
        hold("K6", gram, gram_tiles.gram_tile_scan_plain(merged, gidbits, g),
             f"{what}, gp {g}, Gram sum {int(gram.sum())}")
        need(not every or int(gram.min()) >= 1,
             f"K6 {what}: a pair without the shared key")
        for split in sorted({x for x in (128, g // 2 // 128 * 128, g - 128)
                             if 0 < x < g}):
            hold("K6", gram_tiles.gram_tile_scan(merged, gidbits, g,
                                                 split=split),
                 gram[:split, split:], f"{what}, split {split}")
        if timed:
            key64 = sort_key64(runs.reshape(runs.shape[0], -1))
            res["K5"].update(
                ms=timer(lambda: sort.merge_sorted_runs(runs, cap // 128), 10),
                device_launches=device_launches(
                    lambda: sort.merge_sorted_runs(runs, cap // 128)),
                plain_ms=timer(lambda: sort.merge_sorted_runs_plain(
                    runs, cap // 128), 3),
                library_ms=timer(lambda: torch.sort(key64), 10),
                **bound(2 * nbytes(runs)))
            shapes.append(k6_timing(f"{what}, gp {g}", (merged, gidbits, g),
                                    None))
        del runs, merged, gram
    for pw in (1, 5):
        for sw in (torch.empty((pw, 0), dtype=torch.int32, device=dev),
                   torch.full((pw, 64, 128), -1, dtype=torch.int32,
                              device=dev)):
            for split in (None, 128):
                got = gram_tiles.gram_tile_scan(sw, 8, 256, split=split)
                hold("K6", got, gram_tiles.gram_tile_scan_plain(
                    sw, 8, 256, split=split),
                    f"pw {pw}, {sw.numel() // pw} entries, all sentinels, "
                    f"split {split}")

    # a blocked macro-tile of two blocks that share their 4 clades, as
    # blocks b and b + 16 of phase 6 do
    block, cap, kb, gidbits = 128, 32768, 40, 8
    keys = clade_keys(gen, dev, 2 * block, cap, 40000, 25000, 4, kb)
    pa = sort.merge_sorted_runs(packed_runs(keys[:block], kb, gidbits),
                                cap // 128)
    pb = sort.merge_sorted_runs(packed_runs(keys[block:], kb, gidbits),
                                cap // 128)
    hold("K10", sort.merge_pair_streams(pa, pb),
         sort.merge_pair_streams_plain(pa, pb),
         f"two blocks of {block} x {cap}, pw {pa.shape[0]}, no offset")
    # column gids + block, as gram_pair_tile calls K10
    merged = sort.merge_pair_streams(pa, pb, b_gid_offset=block)
    hold("K10", merged,
         sort.merge_pair_streams_plain(pa, pb, b_gid_offset=block),
         f"two blocks of {block} x {cap}, pw {pa.shape[0]}, offset {block}")
    tile = gram_tiles.gram_tile_scan(merged, gidbits, 2 * block, split=block)
    hold("K6", tile, gram_tiles.gram_tile_scan_plain(
        merged, gidbits, 2 * block, split=block),
        f"split {block} of gp {2 * block}, tile sum {int(tile.sum())}")
    pbs = pb.clone()
    pbs[0] += (pb[-1] >= 0).to(torch.int32) * block
    key64 = sort_key64(torch.cat([pa, pbs], dim=1).reshape(pa.shape[0], -1))
    del pbs

    def pair():
        return sort.merge_pair_streams(pa, pb, b_gid_offset=block)
    res["K10"].update(
        ms=timer(pair, 10),
        plain_ms=timer(lambda: sort.merge_pair_streams_plain(
            pa, pb, b_gid_offset=block), 3),
        library_ms=timer(lambda: torch.sort(key64), 10),
        device_launches=device_launches(pair),
        **bound(nbytes(pa, pb, merged)))
    shapes.append(k6_timing(f"macro-tile: split {block} of gp {2 * block}, "
                            f"2 x {block} x {cap}", (merged, gidbits,
                                                     2 * block), block))
    del merged, keys, pa, pb
    # macro-tiles as the all-pairs cell's: two blocks of 128 related
    # genomes whose species follow its Zipf law (two blocks share ~20-30
    # species, hundreds of kept runs a chunk), and two blocks of unrelated
    # genomes (each its own clade: no kept run); ~24,400 keys a genome
    for what, clade, pool in (
            ("related (Zipf species)", zipf_clades(seed, 2 * block), 30000),
            ("unrelated (a clade a genome)", np.arange(2 * block), 25000)):
        keys = clade_keys(gen, dev, 2 * block, cap, pool, 24400, 0, kb,
                          clade=torch.from_numpy(clade).to(dev))
        pa, pb = (sort.merge_sorted_runs(packed_runs(k, kb, gidbits),
                                         cap // 128)
                  for k in (keys[:block], keys[block:]))
        merged = sort.merge_pair_streams(pa, pb, b_gid_offset=block)
        shapes.append(k6_timing(
            f"macro-tile, {what}: split {block} of gp {2 * block}, 2 x "
            f"{block} x {cap}", (merged, gidbits, 2 * block), block))
        del keys, pa, pb, merged
    res["K6"].update({k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "device_ms")},
                     timed_shapes=shapes)
    for name, r in res.items():
        need(r["max_abs_err"] <= TOLERANCE,
             f"{name} disagrees with its plain version: {r}")
    return res


# --- phase 3-4 data and checks ------------------------------------------------

def mutate(rng, codes, rate):
    """A copy of codes with a `rate` share of positions substituted."""
    out = codes.copy()
    hit = rng.random(out.size) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def write_fasta(path, name, codes, rng):
    """codes as a FASTA of a few records (two random cuts) with three
    N-runs of 10-99 nt, 80 nt per line."""
    text = np.frombuffer(b"ACGT", np.uint8)[codes]
    for start in rng.integers(0, text.size - 200, 3):
        text[start:start + int(rng.integers(10, 100))] = ord("N")
    cuts = np.sort(rng.integers(1, text.size, 2))
    with open(path, "wb") as f:
        for r, rec in enumerate(np.split(text, cuts)):
            f.write(f">{name}_record{r}\n".encode())
            full = rec.size // 80 * 80
            lines = np.full((rec.size // 80, 81), ord("\n"), np.uint8)
            lines[:, :80] = rec[:full].reshape(-1, 80)
            f.write(lines.tobytes())
            if full < rec.size:
                f.write(rec[full:].tobytes() + b"\n")
    return str(path)


def write_genomes(dirpath: pathlib.Path, rng, count: int,
                  nt=(4_000_000, 6_000_000)):
    """FASTAs of nt[0]..nt[1] nucleotides: a few records each, N-runs
    inside; genome 1 is a 3%-substituted copy of genome 0."""
    base = None
    paths = []
    for i in range(count):
        length = int(rng.integers(nt[0], nt[1] + 1))
        if i == 1:
            codes = mutate(rng, base, 0.03)
        else:
            codes = rng.integers(0, 4, length).astype(np.uint8)
        if i == 0:
            base = codes
        paths.append(write_fasta(dirpath / f"genome{i}.fa", f"genome{i}",
                                 codes, rng))
    return paths


def write_collection(dirpath: pathlib.Path, rng, clades=5, members=20,
                     nt=(4_000_000, 6_000_000)):
    """BASELINE config 2's collection: one ancestor of nt[1] nt; `clades`
    roots, each 3% substituted from it; `members` genomes per clade, each
    0.2-2% substituted from its root and cut to nt[0]..nt[1] nt."""
    ancestor = rng.integers(0, 4, nt[1]).astype(np.uint8)
    paths = []
    for c in range(clades):
        root = mutate(rng, ancestor, 0.03)
        for m in range(members):
            length = int(rng.integers(nt[0], nt[1] + 1))
            codes = mutate(rng, root[:length], float(rng.uniform(0.002, 0.02)))
            name = f"clade{c}_member{m}"
            paths.append(write_fasta(dirpath / f"{name}.fa", name, codes, rng))
    return paths


def record_sketches():
    """Capture every sketch list the CLI's sketcher returns."""
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    captured = []
    orig = FracMinHashSketcher.sketch_files

    def recording(self, paths, *a, **kw):
        out = orig(self, paths, *a, **kw)
        captured.append((self, list(paths), out))
        return out
    FracMinHashSketcher.sketch_files = recording
    return captured


def run_cli(argv):
    """driver.main on argv; returns (stdout lines, sketching ms, comparison
    ms) with the timings summed over the run's experiments."""
    from spaced_kmer_sketching_tpu_torch import driver
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main(argv)
    need(rc == 0, f"driver.main returned {rc}")
    lines = buf.getvalue().splitlines()
    ms = {"sketching": 0.0, "comparison": 0.0}
    for line in lines:
        m = re.fullmatch(r"Time taken for (sketching|comparison) = (\S+) ms",
                         line)
        need(m is not None, f"unexpected driver output {line!r}")
        ms[m.group(1)] += float(m.group(2))
    return lines, ms["sketching"], ms["comparison"]


def check_experiment(sketcher, paths, sketches, csv_rows, parsed, pool):
    """Sketches equal the native scalar pipeline; CSV rows equal the host
    math on native intersections of them.  `parsed` caches read_fasta per
    path; the native calls run on the thread pool `pool`."""
    from spaced_kmer_sketching_tpu_torch.ani import (binomial_estimator,
                                                     containment)
    from spaced_kmer_sketching_tpu_torch.csvout import format_double
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.utils import native

    cfg, mask = sketcher.config, sketcher.mask
    for p, pk in zip(paths, pool.map(
            lambda q: parsed[q] if q in parsed else read_fasta(q), paths)):
        parsed[p] = pk

    def scalar(p):
        pk = parsed[p]
        return native.sketch_codes(pk.codes, pk.run_lens, mask.lo, mask.hi,
                                   cfg.window, sketcher.salt, cfg.scale,
                                   cfg.hash_variant == "legacy")
    u64 = list(pool.map(scalar, paths))
    for p, s, want in zip(paths, sketches, u64):
        need(s.count > 0 and np.array_equal(s.keys_u64(), want),
             f"w={cfg.window} k={cfg.k} {p}: sketch of {s.count} keys != "
             f"native scalar pipeline's {want.shape[0]}")
    g = len(paths)
    need(len(csv_rows) == g * g, f"{len(csv_rows)} CSV rows for {g} genomes")
    inter = np.diag([s.count for s in sketches]).astype(np.int64)
    upper = [(i, j) for i in range(g) for j in range(i + 1, g)]
    for (i, j), v in zip(upper, pool.map(
            lambda ij: native.intersect_sorted(u64[ij[0]], u64[ij[1]]),
            upper)):
        inter[i, j] = inter[j, i] = v
    for i in range(g):
        for j in range(g):
            ani = binomial_estimator(containment(int(inter[i, j]),
                                                 sketches[i].count),
                                     mask.care_positions)
            want_row = (f"{paths[i]},{paths[j]},{format_double(float(ani))},"
                        f"{cfg.window},{mask.bitstring()}")
            need(csv_rows[i * g + j] == want_row,
                 f"CSV row {i * g + j}: {csv_rows[i * g + j]!r} != "
                 f"{want_row!r}")
            need(np.isfinite(ani) and 0 <= ani <= 1, f"ANI {ani}")
    return inter


def run_main_path(paths, tmp: pathlib.Path, device: str, pool) -> dict:
    """Phases 3-4 through the CLI, then their checks.  Returns the config-1
    timings and the kernels' launch counts of the CLI runs alone."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    captured = record_sketches()
    build.reset_launches()
    t0 = time.perf_counter()
    out3 = tmp / "config_w20_k16.csv"
    _, s_ms, c_ms = run_cli([str(out3), *paths, "--window", "20", "--k", "16",
                             "--device", device])
    print(f"phase 3: {len(paths)} genomes w=20 k=16: sketching {s_ms} ms, "
          f"comparison {c_ms} ms")
    cfg1 = []
    for rep in ("cold", "warm"):
        lines, s_ms, c_ms = run_cli([str(tmp / f"cfg1_{rep}.csv"), *paths[:2],
                                     "--window", "20", "--k", "16",
                                     "--device", device])
        cfg1.append((s_ms, c_ms))
        print(f"phase 3: config 1 ({rep}): " + " | ".join(lines))
    t3 = time.perf_counter() - t0
    out4 = tmp / "sweep.csv"
    sweep4 = run_sweep_turns(paths[:2], out4, device)
    t4 = sweep4["turns"][0]["wall_s"]
    launches = sweep4.pop("launches")
    print(f"main path (phases 3-4's first turn, {t3 + t4:.3f} s): launches "
          + json.dumps(launches))

    # checks (no kernel runs here)
    t0 = time.perf_counter()
    parsed = {}
    csv3 = out3.read_text().splitlines()
    need(csv3[0] == "File 1,File 2,Estimated Value,Window Size,Mask",
         "CSV header")
    sk3, p3, sketches3 = captured[0]
    check_experiment(sk3, p3, sketches3, csv3[1:], parsed, pool)
    ani01 = float(csv3[2].split(",")[2])
    need(0.9 < ani01 < 1.0, f"ANI of the 3%-mutated copy: {ani01}")
    for (skc, pc, sc), rep in zip(captured[1:3], ("cold", "warm")):
        rows = (tmp / f"cfg1_{rep}.csv").read_text().splitlines()[1:]
        check_experiment(skc, pc, sc, rows, parsed, pool)
    csv4 = out4.read_text().splitlines()
    need(len(csv4) == 1 + 62 * 4, f"sweep CSV has {len(csv4)} lines")
    need(len(captured) == 3 + 62 * len(sweep4["turns"]),
         f"{len(captured)} experiments in phases 3-4")
    sweep = captured[3:3 + 62]      # the first turn's; the others' CSV bytes
    buckets = set()
    for e, (skc, pc, sc) in enumerate(sweep):
        check_experiment(skc, pc, sc, csv4[1 + 4 * e:5 + 4 * e], parsed,
                         pool)
        buckets.add((2 * skc.config.window + 31) // 32)
    need(buckets == {1, 2, 3, 4}, f"key-word buckets {buckets}")
    print(f"checks: {len(captured)} experiments equal the native scalar "
          f"pipeline and the host ANI math (kw buckets {sorted(buckets)}) in "
          f"{time.perf_counter() - t0:.3f} s; ANI(genome0, genome1) = {ani01}")
    sweep4["host_ms"] = check_uploads(paths, parsed, paths[:2])
    return {"launches": launches, "config1_warm": cfg1[1], "sweep": sweep4}


def run_sweep_turns(paths, out: pathlib.Path, device: str) -> dict:
    """Phase 4: the CLI's 62-config sweep on `paths` in two turns.  Every
    turn must write the first turn's CSV bytes.  Returns each turn's
    numbers and the kernels' launches over the first turn (the main
    path's sweep)."""
    turns, launches = [], None
    for t in range(2):
        csv = out if t == 0 else out.with_name(f"sweep_turn{t}.csv")
        t0 = time.perf_counter()
        _, s_ms, c_ms = run_cli([str(csv), *paths, "--device", device])
        wall = time.perf_counter() - t0
        if t == 0:
            launches = launch_counts()
        need(csv.read_bytes() == out.read_bytes(),
             f"phase 4: turn {t}'s CSV != the first turn's")
        turns.append({"wall_s": wall, "sketching_ms": s_ms,
                      "comparison_ms": c_ms,
                      "sketching_ms_per_config": s_ms / 62})
        print(f"phase 4: 62-config sweep on {len(paths)} genomes, turn {t}: "
              f"{wall:.3f} s wall, sketching {s_ms} ms ({s_ms / 62} ms a "
              f"config), comparison {c_ms} ms")
    return {"launches": launches, "turns": turns}


def check_uploads(paths, parsed, sweep_paths) -> dict:
    """The batch step's upload of each genome of `paths` (phase 3's
    genomes, parsed in `parsed`) at the sweep's bucket on the card: its
    2-bit words and run ends equal to a fresh pack, and the run-id plane
    the step reads expanded from them equal to the host plane (a loop over
    the runs).  Returns the host ms of a sweep config's packs and uploads
    of `sweep_paths`."""
    import torch
    from spaced_kmer_sketching_tpu_torch.models import fracminhash as fm
    from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import pack2bit

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for p in paths:
        pk = parsed[p]
        n = fm._bucket_size(pk.codes.size + 20)
        (entry,) = fm.upload_genomes([pk], n, dev)
        words = pack2bit(pk.codes, n // 16).view(np.int32)
        ends = np.cumsum(pk.run_lens).astype(np.int32)
        need(torch.equal(entry.words, torch.from_numpy(words).to(dev))
             and torch.equal(entry.ends, torch.from_numpy(ends).to(dev)),
             f"{p}: the batch step's upload != a fresh pack of its genome")
        rid = np.full(n, -1, np.int32)
        pos = 0
        for r, ln in enumerate(pk.run_lens):
            rid[pos:pos + int(ln)] = r
            pos += int(ln)
        need(np.array_equal(
            fm._stack_uploads([entry], n)[1][0].cpu().numpy(), rid),
            f"{p}: the run-id plane expanded on the card != the host plane")
    print(f"checks: the batch step's uploads of {len(paths)} genomes equal "
          f"fresh packs, and their run-id planes the host's, in "
          f"{time.perf_counter() - t0:.3f} s")
    sweep = [parsed[p] for p in sweep_paths]
    n = fm._bucket_size(max(pk.codes.size for pk in sweep) + 20)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        fm.upload_genomes(sweep, n, dev)
        torch.cuda.synchronize()
    ms = {"pack_upload": (time.perf_counter() - t0) * 1e3 / reps}
    print(f"phase 4: a config's host work on its {len(sweep)} genomes: "
          f"packs and uploads {ms['pack_upload']} ms")
    return ms


def run_config2(tmp: pathlib.Path, rng, pool) -> dict:
    """Phase 5: BASELINE config 2 (100 related genomes) through the CLI,
    then its checks.  Returns its timings and launch counts."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = write_collection(tmp, rng)
    print(f"phase 5 data: {len(paths)} related FASTAs written in "
          f"{time.perf_counter() - t0:.3f} s")
    captured = record_sketches()
    build.reset_launches()
    t0 = time.perf_counter()
    out = tmp / "config2.csv"
    _, s_ms, c_ms = run_cli([str(out), *paths, "--window", "20", "--k", "16",
                             "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    print(f"phase 5: config 2 ({len(paths)} genomes, w=20, k=16): "
          f"{wall:.3f} s wall, sketching {s_ms} ms, comparison {c_ms} ms; "
          "launches " + json.dumps(launches))
    for key in ("K1", "K2", "K3", "K4", "K5", "K6"):
        need(launches[key] > 0, f"{key} was not launched by config 2")
    t0 = time.perf_counter()
    rows = out.read_text().splitlines()
    need(len(captured) == 1, f"{len(captured)} config-2 experiments")
    skc, pc, sc = captured[0]
    inter = check_experiment(skc, pc, sc, rows[1:], {}, pool)
    off = inter[~np.eye(len(pc), dtype=bool)] / np.repeat(
        [s.count for s in sc], len(pc) - 1)
    print(f"checks: config 2's {len(pc)} sketches equal the native scalar "
          f"pipeline and its {len(rows) - 1} CSV rows the host math on "
          f"native intersections in {time.perf_counter() - t0:.3f} s; "
          f"containment off the diagonal {off.min():.4f}-{off.max():.4f}")
    return {"launches": launches, "sketching_ms": s_ms, "comparison_ms": c_ms,
            "wall_s": wall, "paths": paths, "sketches": sc, "inter": inter}


def blocked_sketches(rng, mask, g=BLOCKED_GENOMES, clades=64, pool_n=40000,
                     count=25000):
    """Phase 6's host sketches: g sketches of ~count 40-bit keys (w = 20)
    drawn from `clades` ascending pools of pool_n keys, genome i from pool
    (i // 32) % clades."""
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import Sketch

    steps = rng.integers(1, (1 << 40) // pool_n, (clades, pool_n),
                         dtype=np.int64)
    pools = np.cumsum(steps, axis=1).astype(np.uint64)   # ascending, unique
    sketches = []
    for i in range(g):
        v = pools[(i // 32) % clades][rng.random(pool_n) < count / pool_n]
        keys = np.zeros((v.size, 4), np.uint32)
        keys[:, 0] = (v & np.uint64(M32)).astype(np.uint32)
        keys[:, 1] = (v >> np.uint64(32)).astype(np.uint32)
        sketches.append(Sketch(keys=keys, count=v.size, window=20,
                               mask=mask))
    return sketches


def run_blocked(rng, pool) -> dict:
    """Phase 6: all_pairs_intersections on BLOCKED_GENOMES synthetic
    sketches of ~25,000 40-bit keys (capacity 32,768) from 64 clade pools
    of 40,000 keys (genome i in clade (i // 32) % 64, so blocks b and
    b + 16 share clades and runs are ~40 long), through the blocked
    route.  Returns its wall time, launch counts and bytes uploaded, and
    its sketcher, sketches and matrix for phase 14."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    from spaced_kmer_sketching_tpu_torch.utils import native

    g, block = BLOCKED_GENOMES, 128
    t0 = time.perf_counter()
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    sketches = blocked_sketches(rng, sk.mask)
    print(f"phase 6 data: {g} sketches of {min(s.count for s in sketches)}-"
          f"{max(s.count for s in sketches)} keys in "
          f"{time.perf_counter() - t0:.3f} s")
    build.reset_launches()
    observability.reset_counters()
    t0 = time.perf_counter()
    out = sk.all_pairs_intersections(sketches)
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    h2d = observability.counters().get("blocked_h2d_bytes", 0)
    print(f"phase 6: all_pairs_intersections over {g} sketches (blocked, "
          f"block {block}): {wall:.3f} s wall; {h2d} bytes uploaded; "
          "launches " + json.dumps(launches))
    for key in ("K12", "K5", "K6", "K10"):
        need(launches[key] > 0, f"{key} was not launched by phase 6")
    prof = profile_path("phase 6", lambda: sk.all_pairs_intersections(
        sketches))

    t0 = time.perf_counter()
    counts = np.array([s.count for s in sketches])
    need(out.shape == (g, g) and out.dtype == np.int32, "matrix shape/type")
    need(np.array_equal(np.diag(out), counts), "diagonal != sketch sizes")
    need(np.array_equal(out, out.T), "matrix not symmetric")
    other = min(16, g // block - 1)       # block 16 shares block 0's clades
    pairs = [(a, b) for a in range(block)
             for b in range(other * block, (other + 1) * block)]
    pairs += [tuple(p) for p in rng.integers(0, g, (2000, 2))]
    u64 = {x: sketches[x].keys_u64() for ab in pairs for x in ab}

    def merge(ab):
        a, b = ab
        return counts[a] if a == b else native.intersect_sorted(u64[a],
                                                                u64[b])
    got = [int(out[a, b]) for a, b in pairs]
    want = list(pool.map(merge, pairs))
    bad = [(p, x, y) for p, x, y in zip(pairs, got, want) if x != y]
    need(not bad, f"{len(bad)} pairs differ from native merges: {bad[:5]}")
    nonzero = sum(x > 0 for x in got)
    print(f"checks: diagonal, symmetry and {len(pairs)} pairs (blocks 0 x "
          f"{other} whole, {nonzero} nonzero) equal native merges in "
          f"{time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "wall_s": wall, "profile": prof,
            "h2d_bytes": h2d, "sketcher": sk, "sketches": sketches,
            "inter": out}


# --- phase 14: the bit-tight slab transport ----------------------------------

def _copy_sums(prof) -> dict:
    """{copy kind: [device ms, count]} of the host-to-device copies the
    profiler recorded ("Memcpy HtoD (Pinned -> Device)", "... (Pageable ->
    Device)")."""
    out = {}
    for e in prof.key_averages():
        if not e.key.startswith("Memcpy HtoD"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        acc = out.setdefault(e.key, [0.0, 0])
        acc[0] += us / 1e3
        acc[1] += e.count
    return out


def run_tight(blk: dict) -> dict:
    """Phase 14 on phase 6's sketches: (a) K12 against its plain version
    bit for bit at phase 6's block shape (the first 128 sketches packed
    tight, capacity 32,768, 40-bit keys, gidbits 8, pw 2), timed with CUDA
    events and torch.profiler beside its byte bound; (b) blocked_all_pairs
    over the sketcher's host source (blocked_source) by the tight and the
    word transports in turns (tight, words, words, tight), each once timed
    (wall, host pack and stack thread-ms, bytes uploaded) and once under
    torch.profiler (device sums of K12, K5, K10 and K6 and of the
    host-to-device copies); every matrix must be phase 6's; (c) the route
    phase 6's all_pairs_intersections took."""
    import torch

    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.models import fracminhash
    from spaced_kmer_sketching_tpu_torch.ops import gram
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build, tight
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs

    sk, sketches, want = blk["sketcher"], blk["sketches"], blk["inter"]
    g, block, key_bits = len(sketches), allpairs.BLOCK, 40
    gidbits, pw = allpairs.GIDBITS, gram.pack_plan(40, allpairs.GIDBITS)
    src = sk.blocked_source(sketches)
    need(src["key_bits"] == key_bits, "phase 14: phase 6 is not at w = 20")

    # (a)
    cap = max(128, 1 << (max(s.count for s in sketches) - 1).bit_length())
    host = np.zeros((block, cap // 4, gram.tight_words4(key_bits)),
                    np.uint32)
    counts = src["pack"](0, block, host)
    dev = sk.device
    t = torch.from_numpy(host.view(np.int32)).to(dev)
    c = torch.from_numpy(np.asarray(counts, np.int32)).to(dev)
    kw = dict(key_bits=key_bits, gidbits=gidbits, pw=pw)
    got = tight.tight_gid_planes(t, c, **kw)
    plain = tight.tight_gid_planes_plain(t, c, **kw)
    err = max_abs_err([got], [plain])
    need(err <= TOLERANCE, f"K12 disagrees with its plain version: {err}")
    words = torch.from_numpy(fracminhash._stack_host(
        sketches[:block], cap, 2).view(np.int32)).to(dev)
    need(torch.equal(gram.presort_block_tight(t, c, **kw),
                     gram.presort_block_packed(words, **kw)),
         "phase 14a: the tight presort != the word presort of block 0")
    del words
    # the main path finds the block cold: it was just uploaded.  Between
    # the launches of the cold timing a 128 MiB write evicts the 50 MB L2
    # (its kernel is not the port's, so device_ms does not count it)
    flush = torch.empty(1 << 27, dtype=torch.int8, device=dev)

    def cold():
        flush.zero_()
        return tight.tight_gid_planes(t, c, **kw)
    kern = dict(max_abs_err=err,
                ms=time_ms(lambda: tight.tight_gid_planes(t, c, **kw), 20),
                device_ms=device_ms(lambda: tight.tight_gid_planes(
                    t, c, **kw), 20),
                device_ms_cold_l2=device_ms(cold, 20),
                device_launches=device_launches(
                    lambda: tight.tight_gid_planes(t, c, **kw)),
                plain_ms=time_ms(lambda: tight.tight_gid_planes_plain(
                    t, c, **kw), 3),
                library_ms=None, **bound(nbytes(t, c, got)))
    kern["fraction_of_bound"] = kern["bound_ms"] / kern["ms"]
    print(f"phase 14a: K12 at phase 6's block ({block} x {cap}, "
          f"{nbytes(t, c, got)} bytes): max_abs_err={err}; kernel "
          f"{kern['ms']} ms (device {kern['device_ms']} ms, L2 flushed "
          f"{kern['device_ms_cold_l2']} ms, {kern['device_launches']} "
          f"launches), plain {kern['plain_ms']} ms, bound "
          f"{kern['bound_ms']} ms ({kern['bound_by']})")
    del t, c, got, plain, flush

    # (b)
    pack, provider = src["pack"], src["keys"]
    spent = {"pack": 0.0, "stack": 0.0}

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[key] += time.perf_counter() - t0
        return run
    args = dict(src, pack=timed(pack, "pack"), keys=timed(provider, "stack"))
    turns, launches = [], dict.fromkeys(build.KERNELS, 0)
    for transport in ("tight", "words", "words", "tight"):
        spent.update(pack=0.0, stack=0.0)
        build.reset_launches()
        observability.reset_counters()
        t0 = time.perf_counter()
        out = allpairs.blocked_all_pairs(**args, transport=transport)
        wall = time.perf_counter() - t0
        run_launches = launch_counts()
        h2d = observability.counters().get("blocked_h2d_bytes", 0)
        need(np.array_equal(out, want),
             f"phase 14b: the {transport} route's matrix != phase 6's")
        need((run_launches["K12"] > 0) == (transport == "tight"),
             f"phase 14b: the {transport} route launched K12 "
             f"{run_launches['K12']} times")
        host_ms = {k: v * 1e3 for k, v in spent.items()}
        prof = _profiled(lambda: allpairs.blocked_all_pairs(
            **src, transport=transport))
        kernels = _kernel_sums(prof)
        sums = {key: [sum(kernels.get(n, [0.0, 0])[i]
                          for n in PATH_KERNELS[key]) for i in (0, 1)]
                for key in ("K12", "K5", "K10", "K6")}
        copies = _copy_sums(prof)
        turns.append({"transport": transport, "wall_s": wall,
                      "host_thread_ms": host_ms, "h2d_bytes": h2d,
                      "h2d_device_ms": copies, "device": sums})
        launches = add_launches(launches, run_launches)
        print(f"phase 14b: {transport}: {wall:.3f} s wall; host thread ms "
              f"pack {host_ms['pack']:.1f}, stack {host_ms['stack']:.1f}; "
              f"H2D {h2d} bytes, device copies [ms, count] "
              f"{json.dumps(copies)}; device sums [ms, launches] "
              f"{json.dumps(sums)}; phase 6's matrix")
        del out
    tight_s = [r["wall_s"] for r in turns if r["transport"] == "tight"]
    words_s = [r["wall_s"] for r in turns if r["transport"] == "words"]
    faster = sum(a < b for a, b in zip(tight_s, words_s))
    print(f"phase 14b: tight {tight_s} s, words {words_s} s: tight faster "
          f"in {faster} of 2 turn pairs (tight, words | words, tight)")

    # (c)
    route = ("in core, tight transport" if blk["launches"]["K12"] > 0
             else "in core, word transport")
    need(blk["launches"]["K12"] in (0, -(-g // block)),
         "phase 14c: phase 6 launched K12 other than once a block")
    print(f"phase 14c: phase 6's all_pairs_intersections took the blocked "
          f"schedule {route} (K12 {blk['launches']['K12']} launches, "
          f"{blk['h2d_bytes']} bytes uploaded)")
    return {"kernel": kern, "launches": launches, "turns": turns,
            "route": route}


# --- phases 9-10: BASELINE config 3, the single-genome step, the fallbacks --

def native_u64(pk, mask, window, salt, scale):
    """The native scalar pipeline's sketch of PackedSeqs `pk`."""
    from spaced_kmer_sketching_tpu_torch.utils import native
    return native.sketch_codes(pk.codes, pk.run_lens, mask.lo, mask.hi,
                               window, salt, scale, False)


def seed_salt(mask, window):
    """The FracMinHash salt of `mask` at the default nonce and hash."""
    from spaced_kmer_sketching_tpu_torch.utils import boosthash
    return boosthash.fmh_salt(mask.lo, mask.hi, window, 1, "modern")


def run_config3(paths, pool, device="cuda", calls=3) -> dict:
    """Phase 9: BASELINE config 3, CONFIG3_SEEDS spaced seeds (mask seeds
    0..7, w = 20, k = 16, scale 200) over each of config 1's two genomes
    through FracMinHashSketcher.sketch_packed_multiseed, `calls` times a
    genome (the first call pays one-time set-up): one compact upload and
    one K7 launch for all seeds a call (unless a retry ran).  Every sketch
    must equal the native scalar pipeline with its seed's mask and salt.
    Returns wall times, window-seeds/s and launch counts."""
    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.models import fracminhash
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    sk = fracminhash.FracMinHashSketcher(SketchConfig(window=20, k=16),
                                         device=device)
    packed = list(pool.map(read_fasta, paths))
    steps = []
    orig = fracminhash.sketch_batch_compact

    def counting(*a, **kw):
        steps.append(1)
        return orig(*a, **kw)
    fracminhash.sketch_batch_compact = counting
    build.reset_launches()
    out, walls = [], []
    try:
        for pk in packed:
            for c in range(calls):
                t0 = time.perf_counter()
                res = sk.sketch_packed_multiseed(pk)
                walls.append(time.perf_counter() - t0)
                if c == 0:
                    out.append(res)
                else:
                    need(all(np.array_equal(a.keys, b.keys)
                             for a, b in zip(out[-1], res)),
                         "config 3: a repeated call gave other keys")
    finally:
        fracminhash.sketch_batch_compact = orig
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    windows = [pk.total_windows(20) for pk in packed for _ in range(calls)]
    rates = [CONFIG3_SEEDS * w / t for w, t in zip(windows, walls)]
    print(f"phase 9: config 3 ({CONFIG3_SEEDS} seeds, w=20, k=16), {calls} "
          f"calls on each of 2 genomes of {windows[::calls]} windows: "
          f"{walls} s wall, {rates} window-seeds/s; {len(steps)} sketch "
          "steps; launches " + json.dumps(launches))
    need(launches["K7"] == len(steps) >= len(walls),
         f"K7 launched {launches['K7']} times for {len(steps)} steps")
    if len(steps) > len(walls):
        print(f"phase 9: {len(steps) - len(walls)} overflow retries ran")

    t0 = time.perf_counter()
    jobs = [(pk, sketch) for pk, sketches in zip(packed, out)
            for sketch in sketches]
    want = list(pool.map(lambda js: native_u64(
        js[0], js[1].mask, 20, seed_salt(js[1].mask, 20), 200), jobs))
    for (pk, sketch), u64 in zip(jobs, want):
        need(sketch.count > 0 and np.array_equal(sketch.keys_u64(), u64),
             f"config 3: seed mask {sketch.mask.lo:#x} sketch of "
             f"{sketch.count} keys != native's {u64.shape[0]}")
    need(len(jobs) == 2 * CONFIG3_SEEDS, f"{len(jobs)} config-3 sketches")
    print(f"checks: config 3's {len(jobs)} sketches equal the native scalar "
          f"pipeline with their seeds' masks and salts in "
          f"{time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "wall_s": walls, "rates": rates}


def route_for(sk, n: int, capacity: int, g: int) -> str:
    """The planner's finish route of the sketcher's dyn step (G genomes
    of bucket n) at `capacity`."""
    from spaced_kmer_sketching_tpu_torch.ops import sketch as ops_sketch
    from spaced_kmer_sketching_tpu_torch.ops.cuda.extract import out_rows
    kw = ops_sketch.finish_words(sk.config.window)
    nw = n - 16 * (kw - 1)
    k_slots = ops_sketch._k_slots_for(nw, sk.config.scale, capacity)
    return ops_sketch.finish_route(out_rows(nw) * k_slots, nw, k_slots,
                                   capacity, sk.config.scale, g)


def run_fallbacks(path_a, rng, pool, device="cuda") -> dict:
    """Phase 10: (a) sketch_from_codes on config 1's genome A (K11, the
    chunked top-k, K4); (b) 16 phage-lambda-sized genomes through
    sketch_packed_batch at sketch_capacity 512, which the planner sends to
    _finish_runs (K8, K5) with no overflow; (c) a 2 Mnt genome at
    sketch_capacity 2048, whose first step takes the tiled
    _finish_candidates (K9) and overflows, and whose retry finishes.
    Every sketch must equal the native scalar pipeline.  Returns the launch
    counts of the three runs together."""
    import torch

    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import (PackedSeqs,
                                                              read_fasta)
    from spaced_kmer_sketching_tpu_torch.models import fracminhash
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    from spaced_kmer_sketching_tpu_torch.ops.sketch import sketch_from_codes

    total = {k: 0 for k in build.KERNELS}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # (a)
    sk = fracminhash.FracMinHashSketcher(SketchConfig(window=20, k=16),
                                         device=device)
    pk = read_fasta(path_a)
    rid = np.repeat(np.arange(pk.run_lens.size, dtype=np.int32),
                    pk.run_lens)
    cap = sk.config.capacity_for(pk.total_windows(20))
    build.reset_launches()
    t0 = time.perf_counter()
    codes = torch.from_numpy(pk.codes).to(device)
    run_id = torch.from_numpy(rid).to(device)
    while True:
        res = sketch_from_codes(codes, run_id, sk.mask.words_u32, window=20,
                                salt=sk.salt, scale=200, variant="modern",
                                capacity=cap)
        raw = int(res.raw_kept)
        if raw <= cap:
            break
        cap = 1 << raw.bit_length()
    count = int(res.count)
    keys = res.keys[:count].cpu().numpy().view(np.uint32).astype(np.uint64)
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    add(launches)
    print(f"phase 10a: sketch_from_codes on genome A ({pk.codes.size} codes, "
          f"capacity {cap}): {wall:.3f} s wall, {count} keys; launches "
          + json.dumps(launches))
    for key in ("K11", "K4"):
        need(launches[key] > 0, f"{key} was not launched by phase 10a")
    u64 = np.stack([keys[:, 0] | keys[:, 1] << np.uint64(32),
                    keys[:, 2] | keys[:, 3] << np.uint64(32)], axis=1)
    need(np.array_equal(u64, native_u64(pk, sk.mask, 20, sk.salt, 200)),
         "phase 10a: sketch_from_codes != native scalar pipeline")

    # (b)
    sk = fracminhash.FracMinHashSketcher(
        SketchConfig(window=20, k=16, sketch_capacity=512), device=device)
    lam = [PackedSeqs(rng.integers(0, 4, LAMBDA_NT).astype(np.uint8),
                      np.array([LAMBDA_NT], np.int64)) for _ in range(16)]
    n = fracminhash._bucket_size(LAMBDA_NT + 20)
    need(route_for(sk, n, 512, 8) == "runs",
         f"phase 10b: the planner routes n={n} to {route_for(sk, n, 512, 8)}")
    build.reset_launches()
    t0 = time.perf_counter()
    got = sk.sketch_packed_batch(lam)
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    add(launches)
    print(f"phase 10b: 16 genomes of {LAMBDA_NT} nt (bucket {n}) at "
          f"capacity 512 through _finish_runs: {wall:.3f} s wall, "
          f"{[x.count for x in got]} keys; launches " + json.dumps(launches))
    need(launches["K8"] == 2 and launches["K2"] == 0,
         "phase 10b: expected one K8 finish per 8-genome dispatch and no "
         "retry")
    want = list(pool.map(lambda q: native_u64(q, sk.mask, 20, sk.salt, 200),
                         lam))
    for i, (x, u) in enumerate(zip(got, want)):
        need(np.array_equal(x.keys_u64(), u),
             f"phase 10b: genome {i}'s sketch != native")

    # (c)
    sk = fracminhash.FracMinHashSketcher(
        SketchConfig(window=20, k=16, sketch_capacity=2048), device=device)
    big = PackedSeqs(rng.integers(0, 4, 2_000_000).astype(np.uint8),
                     np.array([1_200_000, 800_000], np.int64))
    n = fracminhash._bucket_size(big.codes.size + 20)
    need(route_for(sk, n, 2048, 1) == "tiled",
         f"phase 10c: the planner routes n={n} to {route_for(sk, n, 2048, 1)}")
    build.reset_launches()
    t0 = time.perf_counter()
    got, = sk.sketch_packed_batch([big])
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    add(launches)
    print(f"phase 10c: a 2 Mnt genome at capacity 2048 (bucket {n}): "
          f"{wall:.3f} s wall, {got.count} keys; launches "
          + json.dumps(launches))
    need(launches["K9"] == 1 and launches["K2"] > 0,
         "phase 10c: expected the tiled K9 finish, an overflow and a "
         "tree-finished retry")
    need(np.array_equal(got.keys_u64(),
                        native_u64(big, sk.mask, 20, sk.salt, 200)),
         "phase 10c: the sketch != native scalar pipeline")
    print("checks: phase 10's sketches equal the native scalar pipeline")
    return {"launches": total}


# --- phase 7: BASELINE config 5 -------------------------------------------

def write_chromosome(path, name, codes, gaps):
    """codes as one FASTA record of 80-nt lines, with an N-gap of `length`
    inserted before code `pos` for each (pos, length) of `gaps`."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pieces, prev = [], 0
    for pos, length in gaps:
        pieces += [acgt[codes[prev:pos]], np.full(length, ord("N"), np.uint8)]
        prev = pos
    pieces.append(acgt[codes[prev:]])
    text = np.concatenate(pieces)
    del pieces
    full = text.size // 80 * 80
    lines = np.full((text.size // 80, 81), ord("\n"), np.uint8)
    lines[:, :80] = text[:full].reshape(-1, 80)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        f.write(memoryview(lines).cast("B"))
        if full < text.size:
            f.write(text[full:].tobytes() + b"\n")
    return str(path)


def write_chromosomes(dirpath: pathlib.Path, rng):
    """Config 5's two chromosomes: A of 268.5-272 Mnt (more than 16
    segments of 2^24 codes, so 17), B a 1.2%-substituted copy; N-gaps of
    10 kb to 1 Mnt, some exactly on a segment edge, some a few codes (less
    than the window) before or after one."""
    length = int(rng.integers(268_500_000, 272_000_001))
    a = rng.integers(0, 4, length).astype(np.uint8)
    gaps_a = [(SEGMENT, 10_000), (3 * SEGMENT + 12_345, 1_000_000),
              (5 * SEGMENT - 7, 50_000), (9 * SEGMENT + 1, 200_000),
              (13 * SEGMENT + 777_777, 10_000), (15 * SEGMENT + 3, 500_000)]
    gaps_b = [(2 * SEGMENT, 20_000), (4 * SEGMENT + 999, 1_000_000),
              (7 * SEGMENT - 1, 10_000), (11 * SEGMENT + 5_000_000, 300_000),
              (16 * SEGMENT - 19, 75_000)]
    paths = [write_chromosome(dirpath / "chrA.fa", "chrA", a, gaps_a)]
    b = mutate(rng, a, 0.012)
    del a
    paths.append(write_chromosome(dirpath / "chrB.fa", "chrB", b, gaps_b))
    return paths, length


def run_config5(tmp: pathlib.Path, rng, pool) -> dict:
    """Phase 7: BASELINE config 5 through the CLI (both files stream),
    then its checks.  Returns its timings and launch counts."""
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths, length = write_chromosomes(tmp, rng)
    sizes = [os.path.getsize(q) for q in paths]
    print(f"phase 7 data: 2 chromosomes of {length} codes, {sizes} bytes, "
          f"written in {time.perf_counter() - t0:.3f} s")
    need(min(sizes) >= FracMinHashSketcher._STREAM_THRESHOLD_BYTES,
         f"config-5 files of {sizes} bytes would not stream")
    need(length > 16 * SEGMENT, "config 5 needs 17 segments a file")
    captured = record_sketches()
    streamed = []
    orig = FracMinHashSketcher.sketch_file_streaming

    def counting(self, path, *a, **kw):
        streamed.append(path)
        return orig(self, path, *a, **kw)
    FracMinHashSketcher.sketch_file_streaming = counting
    build.reset_launches()
    t0 = time.perf_counter()
    out = tmp / "config5.csv"
    try:
        _, s_ms, c_ms = run_cli([str(out), *paths, "--window", "20", "--k",
                                 "16", "--device", "cuda"])
    finally:
        FracMinHashSketcher.sketch_file_streaming = orig
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    print(f"phase 7: config 5 (2 chromosomes, w=20, k=16): {wall:.3f} s "
          f"wall, sketching {s_ms} ms, comparison {c_ms} ms; launches "
          + json.dumps(launches))
    need(sorted(streamed) == sorted(paths), f"streamed {streamed}")
    need(launches["K7"] >= 34, f"K7 launched {launches['K7']} times, "
         "expected one per segment (17 a file)")
    for key in ("K2", "K3", "K4"):
        need(launches[key] > 0, f"{key} was not launched by config 5")
    t0 = time.perf_counter()
    rows = out.read_text().splitlines()
    need(len(captured) == 1, f"{len(captured)} config-5 experiments")
    skc, pc, sc = captured[0]
    inter = check_experiment(skc, pc, sc, rows[1:], {}, pool)
    ani = float(rows[2].split(",")[2])
    need(0.97 < ani < 1.0, f"ANI(chrA, chrB) {ani}")
    print(f"checks: config 5's 2 streamed sketches ({sc[0].count}, "
          f"{sc[1].count} keys, {int(inter[0, 1])} shared) equal the native "
          f"scalar pipeline on the whole files and the CSV the host math in "
          f"{time.perf_counter() - t0:.3f} s; ANI(chrA, chrB) = {ani}")
    prof = profile_path("phase 7", lambda: run_cli(
        [str(tmp / "config5_profiled.csv"), *paths, "--window", "20", "--k",
         "16", "--device", "cuda"]))
    return {"launches": launches, "sketching_ms": s_ms, "comparison_ms": c_ms,
            "wall_s": wall, "profile": prof, "paths": pc, "sketches": sc}


# --- phase 8: BASELINE config 4 -------------------------------------------

def write_surveillance(dirpath: pathlib.Path, seed, pool, clades=8,
                       members=CONFIG4_FILES // 8,
                       nt=(1_500_000, 1_700_000)):
    """Config 4's collection, sized like a Campylobacter surveillance set:
    one ancestor, `clades` roots 3% substituted from it, `members` genomes
    per clade 0.2-2% substituted from their root and cut to nt[0]..nt[1]
    nt, written as write_fasta does (records, N-runs).  Each member has
    its own generator, so the pool writes them in parallel."""
    rng = np.random.default_rng([seed, 4])
    ancestor = rng.integers(0, 4, nt[1]).astype(np.uint8)
    roots = [mutate(rng, ancestor, 0.03) for _ in range(clades)]

    def member(cm):
        c, m = cm
        r = np.random.default_rng([seed, 4, c, m])
        length = int(r.integers(nt[0], nt[1] + 1))
        codes = mutate(r, roots[c][:length], float(r.uniform(0.002, 0.02)))
        name = f"clade{c}_member{m}"
        return write_fasta(dirpath / f"{name}.fa", name, codes, r)
    return list(pool.map(member, [(c, m) for c in range(clades)
                                  for m in range(members)]))


def run_config4_cli(tmp: pathlib.Path, seed, pool) -> dict:
    """Phase 8(a): config 4's 640 files through the CLI, which must route
    through the DevicePipeline; then the two-step path on the same files,
    whose CSV must be the same bytes; then 64 sampled sketches against the
    native scalar pipeline.  Returns timings and the pipeline run's launch
    counts."""
    from spaced_kmer_sketching_tpu_torch import driver, pipeline
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    from spaced_kmer_sketching_tpu_torch.utils import native

    t0 = time.perf_counter()
    paths = write_surveillance(tmp, seed, pool)
    print(f"phase 8a data: {len(paths)} related FASTAs written in "
          f"{time.perf_counter() - t0:.3f} s")
    args = ["--window", "20", "--k", "16", "--device", "cuda"]
    results = []
    orig = pipeline.DevicePipeline.all_pairs

    def recording(self, *a, **kw):
        results.append(orig(self, *a, **kw))
        return results[-1]
    pipeline.DevicePipeline.all_pairs = recording
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        _, s_ms, c_ms = run_cli([str(tmp / "pipeline.csv"), *paths, *args])
    finally:
        pipeline.DevicePipeline.all_pairs = orig
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    need(len(results) == 1, "the CLI did not route through DevicePipeline")
    ph = results[0].phases
    print(f"phase 8a: config 4 CLI ({len(paths)} genomes, w=20, k=16) through "
          f"DevicePipeline: {wall:.3f} s wall, sketching {s_ms} ms, "
          f"comparison {c_ms} ms; phases " + json.dumps(ph)
          + "; launches " + json.dumps(launches))
    for key in ("K7", "K2", "K3", "K4", "K5", "K6", "K10"):
        need(launches[key] > 0, f"{key} was not launched by config 4's CLI")
    need(launches["K1"] == 0, "the pipeline launched K1")

    captured = record_sketches()
    routing = driver._use_device_pipeline
    driver._use_device_pipeline = lambda *args: False
    t0 = time.perf_counter()
    try:
        _, s2_ms, c2_ms = run_cli([str(tmp / "two_step.csv"), *paths, *args])
    finally:
        driver._use_device_pipeline = routing
    wall2 = time.perf_counter() - t0
    print(f"phase 8a: the same files through the two-step path: {wall2:.3f} "
          f"s wall, sketching {s2_ms} ms, comparison {c2_ms} ms")
    t0 = time.perf_counter()
    want = (tmp / "two_step.csv").read_bytes()
    need((tmp / "pipeline.csv").read_bytes() == want,
         "config 4: the pipeline's CSV differs from the two-step path's")
    sk, pc, sc = captured[0]
    need(np.array_equal(results[0].counts, [x.count for x in sc]),
         "config 4: pipeline counts != two-step sketch counts")
    sample = np.random.default_rng([seed, 64]).choice(len(paths), 64,
                                                      replace=False)
    cfg = sk.config

    def scalar(i):
        pk = read_fasta(paths[i])
        return native.sketch_codes(pk.codes, pk.run_lens, sk.mask.lo,
                                   sk.mask.hi, cfg.window, sk.salt, cfg.scale,
                                   cfg.hash_variant == "legacy")
    u64 = dict(zip(sample, pool.map(scalar, sample)))
    for i in sample:
        need(np.array_equal(sc[i].keys_u64(), u64[i]),
             f"config 4 sketch {paths[i]} != native scalar pipeline")
    # the pipeline's own matrix against native merges of native sketches,
    # independent of the two-step path's kernels
    inter = results[0].inter
    for i in sample:
        need(int(inter[i, i]) == len(u64[i]),
             f"config 4 pipeline count of {paths[i]} != native")
        for j in sample:
            if i < j:
                need(int(inter[i, j]) == int(inter[j, i])
                     == native.intersect_sorted(u64[i], u64[j]),
                     f"config 4 pipeline pair ({i}, {j}) != native merge")
    rows = want.count(b"\n") - 1
    print(f"checks: config 4's CLI CSV ({rows} rows) is byte-identical to "
          f"the two-step path's, counts equal, 64 sampled sketches equal the "
          f"native scalar pipeline and the pipeline's 4,096 entries among "
          f"them equal native merges, in {time.perf_counter() - t0:.3f} s")
    return {"launches": launches, "sketching_ms": s_ms, "comparison_ms": c_ms,
            "wall_s": wall, "two_step_ms": (s2_ms, c2_ms)}


def run_config4_device(seed, pool) -> dict:
    """Phase 8(b): DevicePipeline.all_pairs on CONFIG4_GENOMES genomes of
    CONFIG4_NT codes drawn on the device, then its checks: symmetry, the
    counts on the diagonal, and 8 sampled sketches and their pairs against
    the native pipeline on the codes drawn again."""
    import torch

    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    from spaced_kmer_sketching_tpu_torch.pipeline import (DevicePipeline,
                                                          device_source)
    from spaced_kmer_sketching_tpu_torch.utils import native

    g, n = CONFIG4_GENOMES, CONFIG4_NT
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    pipe = DevicePipeline(sk)
    src = device_source(g, n, seed=seed, device="cuda")
    verify = sorted(int(i) for i in np.random.default_rng([seed, 8]).choice(
        g, 8, replace=False))
    build.reset_launches()
    t0 = time.perf_counter()
    res = pipe.all_pairs(src, g, n, verify_ids=verify)
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in build.KERNELS.items()}
    # phase 12(d): the route's int32 matrix download in turns with an int16
    # one of the same matrix (cast on the device, widened by numpy), which
    # the port does not take: the record for pinned-buffer work
    m = torch.from_numpy(res.inter).to("cuda")
    need(int(res.inter.max()) <= 32767, "phase 12d: a count past int16")
    narrow = m.to(torch.int16)
    turns = {"int32": lambda: m.cpu().numpy(),
             "int16": lambda: narrow.cpu().numpy().astype(np.int32)}
    need(np.array_equal(turns["int16"](), res.inter),
         "phase 12d: the int16 download differs")
    times = {k: [] for k in turns}
    for k in ("int32", "int16", "int16", "int32", "int32", "int16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turns[k]()
        times[k].append((time.perf_counter() - t0) * 1e3)
    download = {"bytes": nbytes(m), "int16_bytes": nbytes(narrow),
                "turns_ms": times}
    del m, narrow
    print(f"phase 12d: phase 8b's {g} x {g} matrix download in turns [ms] "
          f"{json.dumps(times)} (int32: {download['bytes']} bytes, the "
          f"route's; int16: {download['int16_bytes']} bytes cast on the "
          f"device and widened by numpy)")
    print(f"phase 8b: DevicePipeline.all_pairs, {g} device genomes of {n} "
          f"codes: {wall:.3f} s wall; phases " + json.dumps(res.phases)
          + f"; cache width {res.cache_cap}; launches "
          + json.dumps(launches))
    for key in ("K7", "K5", "K6", "K10"):
        need(launches[key] > 0, f"{key} was not launched by phase 8b")
    prof = profile_path("phase 8b", lambda: pipe.all_pairs(src, g, n),
                        PATH_KERNELS["K4"])

    t0 = time.perf_counter()
    out = res.inter
    need(out.shape == (g, g), f"matrix shape {out.shape}")
    need(np.array_equal(np.diag(out), res.counts), "diagonal != counts")
    need(np.array_equal(out, out.T), "matrix not symmetric")
    need(res.counts.min() > 0, "an empty sketch")
    shifts = 2 * np.arange(16, dtype=np.uint32)

    def scalar(i):
        s0 = i // pipe.dispatch * pipe.dispatch
        words = src(s0, min(g, s0 + pipe.dispatch)).p[i - s0]
        w = words.cpu().numpy().view(np.uint32)
        codes = ((w[:, None] >> shifts) & 3).reshape(-1)[:n].astype(np.uint8)
        return native.sketch_codes(codes, np.array([n], np.int64), sk.mask.lo,
                                   sk.mask.hi, 20, sk.salt, sk.config.scale,
                                   False)
    u64 = dict(zip(verify, map(scalar, verify)))
    torch.cuda.synchronize()
    for i in verify:
        need(np.array_equal(res.sample_keys[i], u64[i]),
             f"phase 8b: genome {i}'s sketch != native scalar pipeline")
        for j in verify:
            want = res.counts[i] if i == j else native.intersect_sorted(
                u64[i], u64[j])
            need(int(out[i, j]) == int(want), f"phase 8b pair ({i}, {j})")
    print(f"checks: diagonal, symmetry, 8 sampled sketches {verify} and their "
          f"64 pairs equal the native pipeline in "
          f"{time.perf_counter() - t0:.3f} s; counts "
          f"{int(res.counts.min())}-{int(res.counts.max())}")
    return {"launches": launches, "wall_s": wall, "phases": res.phases,
            "profile": prof, "download": download, "inter": res.inter,
            "counts": res.counts}


# --- phase 11: the port's bench ----------------------------------------------

def run_bench() -> dict:
    """Phase 11: each of BENCH_RUNS through `python -m
    spaced_kmer_sketching_tpu_torch.bench` in a subprocess, BENCH_WORKERS
    at a time (a process takes ~8 s to reach the card).  Each must exit 0
    with a last line that is verified against the native pipeline, ran on
    the gpu, and launched the run's kernels; the lines are printed and
    their launches summed.  Runs share the card here, so their times are
    not the bench's measurements: those come from runs of their own."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    def run(argv):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "spaced_kmer_sketching_tpu_torch.bench",
             *argv], cwd=ROOT, capture_output=True, text=True, timeout=300)
        return p, time.perf_counter() - t0

    launches = dict.fromkeys(build.KERNELS, 0)
    lines = {}
    with cf.ThreadPoolExecutor(max_workers=BENCH_WORKERS) as pool:
        futs = [(label, kernels, pool.submit(run, argv))
                for label, argv, kernels in BENCH_RUNS]
        for label, kernels, fut in futs:
            p, wall = fut.result()
            need(p.returncode == 0, f"phase 11: bench {label} exited "
                 f"{p.returncode}: {p.stderr[-3000:]}")
            line = json.loads(p.stdout.strip().splitlines()[-1])
            print(f"phase 11: bench {label} ({wall:.3f} s): "
                  f"{json.dumps(line)}")
            need(line["verified"] is True,
                 f"phase 11: bench {label} not verified")
            need(line["platform"] == "gpu", f"phase 11: bench {label} ran "
                 f"on {line['platform']}")
            for key in kernels + ROUTE_KERNELS[line.get("finish_route",
                                                         "sort")]:
                need(line["launches"].get(key, 0) > 0,
                     f"{key} was not launched by bench {label}")
            for key, n in line["launches"].items():
                launches[key] += n
            lines[label] = line
    return {"launches": launches, "lines": lines}


# --- phase 12: the store, resumed sweeps, ring pairing, out of core ---------

def launch_counts() -> dict:
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    return {k: v.launches for k, v in build.KERNELS.items()}


def add_launches(*runs) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def run_resumed_sweep(paths, tmp: pathlib.Path) -> dict:
    """Phase 12(a): the CLI's 62-config sweep on genomes 0 and 1 with
    --store, which must write phase 4's CSV bytes; the CSV cut inside a
    config (31 configs and 2 rows, as a kill leaves it), then the same
    command again, which must complete it to phase 4's bytes from the
    store alone (no K1 launch)."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    want = (tmp / "sweep.csv").read_bytes()
    out, store = tmp / "sweep_store.csv", tmp / "store12a"
    argv = [str(out), *paths, "--store", str(store), "--device", "cuda"]
    build.reset_launches()
    t0 = time.perf_counter()
    run_cli(argv)
    wall = time.perf_counter() - t0
    first = launch_counts()
    need(out.read_bytes() == want,
         "phase 12a: the sweep with --store != phase 4's CSV")
    need(first["K1"] > 0, "phase 12a: the first sweep launched no K1")
    lines = want.splitlines(keepends=True)
    cut = 1 + 31 * 4 + 2
    out.write_bytes(b"".join(lines[:cut]))
    build.reset_launches()
    t0 = time.perf_counter()
    run_cli(argv)
    wall2 = time.perf_counter() - t0
    second = launch_counts()
    need(out.read_bytes() == want,
         "phase 12a: the resumed sweep != phase 4's CSV")
    need(second["K1"] == 0,
         f"phase 12a: the resumed sweep launched K1 {second['K1']} times")
    print(f"phase 12a: the 62-config sweep with --store: {wall:.3f} s wall, "
          f"launches {json.dumps(first)}; cut after {cut - 1} of "
          f"{len(lines) - 1} rows and resumed: {wall2:.3f} s wall, launches "
          f"{json.dumps(second)}; both CSVs are phase 4's bytes")
    return {"launches": add_launches(first, second), "wall_s": wall,
            "resume_wall_s": wall2}


def run_config2_store_and_ring(paths, tmp: pathlib.Path) -> dict:
    """Phase 12(b): config 2's genomes through the CLI with --store twice
    (the second run must launch no K1 and both must write phase 5's CSV
    bytes), then with --pairing ring: 100 rows, row i phase 5's row
    (i, i+1 mod 100)."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    want = (tmp / "config2.csv").read_bytes()
    args = ["--window", "20", "--k", "16", "--device", "cuda"]
    runs, walls = [], []
    for r in range(2):
        out = tmp / f"config2_store{r}.csv"
        build.reset_launches()
        t0 = time.perf_counter()
        run_cli([str(out), *paths, *args, "--store", str(tmp / "store12b")])
        walls.append(time.perf_counter() - t0)
        runs.append(launch_counts())
        need(out.read_bytes() == want,
             f"phase 12b: config 2 with --store (run {r}) != phase 5's CSV")
    need(runs[0]["K1"] > 0, "phase 12b: the first --store run launched no K1")
    need(runs[1]["K1"] == 0,
         f"phase 12b: the cached run launched K1 {runs[1]['K1']} times")
    out = tmp / "config2_ring.csv"
    build.reset_launches()
    t0 = time.perf_counter()
    _, s_ms, c_ms = run_cli([str(out), *paths, *args, "--pairing", "ring"])
    ring_wall = time.perf_counter() - t0
    ring = launch_counts()
    need(ring["K1"] > 0, "phase 12b: the ring run launched no K1")
    full = want.decode().splitlines()
    rows = out.read_text().splitlines()
    g = len(paths)
    need(rows[0] == full[0] and len(rows) == 1 + g,
         f"phase 12b: the ring CSV has {len(rows)} lines")
    for i in range(g):
        need(rows[1 + i] == full[1 + i * g + (i + 1) % g],
             f"phase 12b: ring row {i} != phase 5's row ({i}, {(i + 1) % g})")
    print(f"phase 12b: config 2 with --store: {walls[0]:.3f} s, then "
          f"{walls[1]:.3f} s from the store, launches {json.dumps(runs[0])} "
          f"then {json.dumps(runs[1])}; --pairing ring: {ring_wall:.3f} s "
          f"wall, sketching {s_ms} ms, comparison {c_ms} ms, launches "
          f"{json.dumps(ring)}; every CSV row is phase 5's")
    return {"launches": add_launches(*runs, ring), "walls_s": walls,
            "ring_wall_s": ring_wall}


def run_profile_flag(paths, tmp: pathlib.Path) -> dict:
    """Phase 12(e): the CLI on config 1 with --profile DIR: the trace it
    writes must name the port's kernels, and the CSV must be phase 3's
    config-1 bytes."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    out, trace_dir = tmp / "cfg1_profiled.csv", tmp / "trace12e"
    build.reset_launches()
    t0 = time.perf_counter()
    run_cli([str(out), *paths, "--window", "20", "--k", "16", "--device",
             "cuda", "--profile", str(trace_dir)])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(out.read_bytes() == (tmp / "cfg1_cold.csv").read_bytes(),
         "phase 12e: the profiled CSV != phase 3's config-1 CSV")
    traces = list(trace_dir.glob("*.pt.trace.json"))
    need(len(traces) == 1, f"phase 12e: {len(traces)} trace files")
    names = set()
    for e in json.loads(traces[0].read_text()).get("traceEvents", []):
        m = re.search(r"sks::(?:\(anonymous namespace\)::)?(\w+)",
                      str(e.get("name", "")))
        if e.get("cat") == "kernel" and m:
            names.add(m.group(1))
    need("slide_kernel" in names and "reg_tile_sort_kernel" in names,
         f"phase 12e: the trace names the kernels {sorted(names)}")
    print(f"phase 12e: config 1 with --profile: {wall:.3f} s wall, trace "
          f"{traces[0].name} ({traces[0].stat().st_size} bytes) names "
          f"{sorted(names)}; launches {json.dumps(launches)}")
    return {"launches": launches, "wall_s": wall}


def run_out_of_core(rng, pool) -> dict:
    """Phase 12(c): blocked_all_pairs on OUT_OF_CORE's host sketches
    (16,512 of ~25,000 40-bit keys at capacity 32,768, kw = 2), drawn from
    clade pools as phase 6 draws them, at the default budgets: the slab
    and cache would pass CACHE_BUDGET_BYTES, so the out-of-core schedule
    runs.  Checks: symmetry, the counts on the diagonal, blocks 0 and the
    last whole and 2,000 seeded pairs against native merges, the leading
    4,096 x 4,096 block against the in-core route on the first 32 blocks,
    and one K10 and one K6 launch a tile.  Then the sketcher's route over
    the same keys as Sketch objects (all_pairs_intersections: past the
    budget by their own size, a provider that stacks each block from the
    host sketches): the same presorts, launches and matrix bit for bit."""
    from spaced_kmer_sketching_tpu_torch import observability
    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher, Sketch)
    from spaced_kmer_sketching_tpu_torch.parallel import allpairs
    from spaced_kmer_sketching_tpu_torch.utils import native

    g, cap, count, pool_n = (OUT_OF_CORE[k] for k in ("genomes", "cap",
                                                      "count", "pool"))
    clades, key_bits = 64, 40
    block = allpairs.BLOCK
    t0 = time.perf_counter()
    steps = rng.integers(1, (1 << key_bits) // pool_n, (clades, pool_n),
                         dtype=np.int64)
    pools = np.cumsum(steps, axis=1).astype(np.uint64)   # ascending, unique
    words = [(pools & np.uint64(M32)).astype(np.uint32),
             (pools >> np.uint64(32)).astype(np.uint32)]
    keys = np.full((g, cap, 2), M32, np.uint32)
    counts = np.empty(g, np.int64)
    for i in range(g):
        c = (i // 32) % clades
        pick = rng.random(pool_n) < count / pool_n
        counts[i] = n = int(pick.sum())
        keys[i, :n, 0] = words[0][c][pick]
        keys[i, :n, 1] = words[1][c][pick]
    need_bytes = allpairs.slab_cache_bytes(g, cap, 2, key_bits)
    print(f"phase 12c data: {g} host sketches of {counts.min()}-"
          f"{counts.max()} keys at capacity {cap} ({keys.nbytes} bytes) in "
          f"{time.perf_counter() - t0:.3f} s; the in-core slab and cache "
          f"would need {need_bytes} bytes, the budget is "
          f"{allpairs.CACHE_BUDGET_BYTES}")
    need(need_bytes > allpairs.CACHE_BUDGET_BYTES and counts.max() <= cap
         and counts.max() > cap // 2, "phase 12c: the data misses its size")

    def run():
        return allpairs.blocked_all_pairs(keys, key_bits=key_bits,
                                          device="cuda")
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    build.reset_launches()
    observability.reset_counters()
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stats = observability.counters()
    nb = -(-g // block)
    tiles = nb * (nb + 1) // 2
    presorts, hits = stats.get("blocked_presorts", 0), stats.get(
        "blocked_cache_hits", 0)
    print(f"phase 12c: blocked_all_pairs over {g} host sketches (out of "
          f"core, {nb} blocks, {tiles} tiles): {wall:.3f} s wall; "
          f"{presorts} block presorts, {hits} column-cache hits; launches "
          + json.dumps(launches))
    need(presorts > 0 and presorts + hits == tiles,
         "phase 12c: the out-of-core schedule did not run")
    need(launches["K5"] > 0, "K5 was not launched by phase 12c")
    for key in ("K10", "K6"):
        need(launches[key] == tiles,
             f"phase 12c: {key} launched {launches[key]} times, not {tiles}")
    prof = profile_path("phase 12c", run)

    t0 = time.perf_counter()
    need(out.shape == (g, g) and out.dtype == np.int32, "matrix shape/type")
    need(np.array_equal(np.diag(out), counts), "diagonal != sketch sizes")
    need(np.array_equal(out, out.T), "matrix not symmetric")
    last = nb - 1
    pairs = [(a, b) for a in range(block)
             for b in range(last * block, min(g, (last + 1) * block))]
    pairs += [tuple(p) for p in rng.integers(0, g, (2000, 2))]

    def u64(x):
        v = keys[x, :counts[x], 0].astype(np.uint64) | (
            keys[x, :counts[x], 1].astype(np.uint64) << np.uint64(32))
        return np.stack([v, np.zeros_like(v)], 1)

    def merge(ab):
        a, b = ab
        return counts[a] if a == b else native.intersect_sorted(u64(a),
                                                                u64(b))
    got = [int(out[a, b]) for a, b in pairs]
    want = list(pool.map(merge, pairs))
    bad = [(p, x, y) for p, x, y in zip(pairs, got, want) if x != y]
    need(not bad, f"{len(bad)} pairs differ from native merges: {bad[:5]}")
    lead = OUT_OF_CORE["lead_blocks"] * block
    observability.reset_counters()
    t1 = time.perf_counter()
    in_core = allpairs.blocked_all_pairs(keys[:lead], key_bits=key_bits,
                                         device="cuda")
    in_core_wall = time.perf_counter() - t1
    need("blocked_presorts" not in observability.counters(),
         "phase 12c: the first 32 blocks did not take the in-core route")
    need(np.array_equal(in_core, out[:lead, :lead]),
         "phase 12c: the leading block != the in-core route")
    nonzero = sum(x > 0 for x in got)
    print(f"checks: diagonal, symmetry, {len(pairs)} pairs (blocks 0 x "
          f"{last} whole, {nonzero} nonzero) equal native merges, and the "
          f"leading {lead} x {lead} block equals the in-core route "
          f"({in_core_wall:.3f} s) bit for bit, in "
          f"{time.perf_counter() - t0:.3f} s")

    # the sketcher's route; a Sketch holds the keys' two low words, all
    # that the sketcher stacks at window 20 (40-bit keys)
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    sketches = [Sketch(keys=keys[i, :counts[i]], count=int(counts[i]),
                       window=20, mask=sk.mask) for i in range(g)]
    stacked = []
    stack = sk.stack_sketches
    sk.stack_sketches = lambda s: (stacked.append(len(s)), stack(s))[1]
    build.reset_launches()
    observability.reset_counters()
    t0 = time.perf_counter()
    via = sk.all_pairs_intersections(sketches)
    sk_wall = time.perf_counter() - t0
    sk_launches = launch_counts()
    stats = observability.counters()
    print(f"phase 12c: FracMinHashSketcher.all_pairs_intersections over the "
          f"same {g} sketches: {sk_wall:.3f} s wall; "
          f"{stats.get('blocked_presorts', 0)} block presorts, "
          f"{stats.get('blocked_cache_hits', 0)} column-cache hits; launches "
          + json.dumps(sk_launches))
    need(not stacked, "phase 12c: the sketcher stacked the whole slab")
    need((stats.get("blocked_presorts"), stats.get("blocked_cache_hits"))
         == (presorts, hits), "phase 12c: the sketcher's schedule differs")
    need(sk_launches["K5"] > 0 and sk_launches["K10"] == tiles
         and sk_launches["K6"] == tiles,
         "phase 12c: the sketcher's route missed K5, K10 or K6")
    need(np.array_equal(via, out),
         "phase 12c: the sketcher's matrix != blocked_all_pairs'")
    return {"launches": add_launches(launches, sk_launches), "wall_s": wall,
            "sketcher_wall_s": sk_wall, "presorts": presorts,
            "cache_hits": hits, "profile": prof}


# --- phase 13: the multi-GPU layer -------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_card_mesh(shape):
    """An (r, c) mesh whose every slot is cuda:0: the slots run one after
    another, so its walls show no scaling; it drives the halo ring, the
    per-slot presorts and the tile split through the kernels."""
    import torch

    from spaced_kmer_sketching_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape, [torch.device("cuda", 0)] * (shape[0] * shape[1]))


def run_mesh_cli(label: str, paths, out: pathlib.Path, want: bytes,
                 kernels=()) -> dict:
    """13(a), 13(b): the CLI with --mesh auto in this process at world size
    1 (RANK=0 WORLD_SIZE=1, NCCL): a 1 x 1 mesh whose CSV must be `want`
    and whose run must launch `kernels`."""
    import torch

    from spaced_kmer_sketching_tpu_torch.parallel import distributed

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    seen = []
    orig_init, orig_mesh = (distributed.init_distributed,
                            distributed.global_mesh)

    def init(*a, **kw):
        orig_init(*a, **kw)
        seen.append(torch.distributed.get_backend())
        seen.append(torch.distributed.get_world_size())

    def mesh(*a, **kw):
        m = orig_mesh(*a, **kw)
        seen.append(m.shape)
        return m
    distributed.init_distributed, distributed.global_mesh = init, mesh
    os.environ.update(env)
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        _, s_ms, c_ms = run_cli([str(out), *paths, "--window", "20", "--k",
                                 "16", "--device", "cuda", "--mesh", "auto"])
    finally:
        for k in env:
            os.environ.pop(k)
        distributed.init_distributed, distributed.global_mesh = (orig_init,
                                                                 orig_mesh)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(seen == ["nccl", 1, (1, 1)], f"{label}: the job was {seen}")
    need(not torch.distributed.is_initialized(),
         f"{label}: the CLI left its process group")
    need(out.read_bytes() == want, f"{label}: the --mesh CSV differs")
    for key in kernels:
        need(launches[key] > 0, f"{key} was not launched by {label}")
    print(f"{label}: --mesh auto ({seen[0]}, world size {seen[1]}, mesh "
          f"{seen[2]}): {wall:.3f} s wall, sketching {s_ms} ms, comparison "
          f"{c_ms} ms; the CSV is the single-device run's bytes; launches "
          + json.dumps(launches))
    return {"launches": launches, "wall_s": wall, "sketching_ms": s_ms,
            "comparison_ms": c_ms}


def mesh_sketcher(shape=(2, 2), **kw):
    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.parallel.sketcher import MeshSketcher
    return MeshSketcher(SketchConfig(window=20, k=16), one_card_mesh(shape),
                        **kw)


def run_mesh_ring(label: str, paths, pool, shape) -> dict:
    """13(a) and the first part of 13(c): config 1's genomes, past the
    default seq_par_threshold of 2^22 codes, through the compact ring of
    MeshSketcher.sketch_packed on an (r, c) mesh of cuda:0: each sketch
    must equal the native scalar pipeline's."""
    from spaced_kmer_sketching_tpu_torch.ingest.fasta import read_fasta
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    from spaced_kmer_sketching_tpu_torch.utils import native

    sk = mesh_sketcher(shape)
    packed = list(pool.map(read_fasta, paths))
    need(min(pk.codes.size for pk in packed) >= sk.seq_par_threshold,
         f"{label}: a genome is below seq_par_threshold")
    build.reset_launches()
    t0 = time.perf_counter()
    sketches = [sk.sketch_packed(pk, name=p) for p, pk in zip(paths, packed)]
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(launches["K11"] >= shape[0] * shape[1] * len(paths),
         f"{label}: K11 launched {launches['K11']} times, not one a chunk")
    for p, pk, s in zip(paths, packed, sketches):
        want = native.sketch_codes(pk.codes, pk.run_lens, sk.mask.lo,
                                   sk.mask.hi, 20, sk.salt, sk.config.scale,
                                   False)
        need(s.count > 0 and np.array_equal(s.keys_u64(), want),
             f"{label}: the ring's sketch of {p} != native scalar pipeline")
    print(f"{label}: config 1's {len(paths)} genomes "
          f"({[int(pk.codes.size) for pk in packed]} codes) through the "
          f"compact ring of a {shape[0]} x {shape[1]} mesh of cuda:0 "
          f"(MeshSketcher.sketch_packed): {wall:.3f} s wall, "
          f"{[s.count for s in sketches]} keys, each the native scalar "
          "pipeline's; launches " + json.dumps(launches))
    return {"launches": launches, "wall_s": wall}


def run_mesh_streaming(path, want) -> dict:
    """13(c), second part: a config-5 chromosome through the 2 x 2 mesh's
    sketch_file_streaming (17 segments, each over the ring): the sketch
    must be phase 7's."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    sk = mesh_sketcher()
    build.reset_launches()
    t0 = time.perf_counter()
    got = sk.sketch_file_streaming(path, name=path)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(got.count == want.count and np.array_equal(got.keys, want.keys),
         "13c: the mesh's streamed sketch != phase 7's")
    need(launches["K11"] >= 4 * 17, f"13c: K11 launched {launches['K11']} "
         "times, not 4 chunks a segment")
    print(f"phase 13c: {pathlib.Path(path).name} through the 2 x 2 mesh's "
          f"sketch_file_streaming: {wall:.3f} s wall, {got.count} keys, "
          "phase 7's sketch; launches " + json.dumps(launches))
    return {"launches": launches, "wall_s": wall}


def run_mesh_all_pairs(sketches, want) -> dict:
    """13(c), third part: all_pairs_intersections over config 2's sketches
    on the 2 x 2 mesh (mesh_all_pairs_packed: one presort of the slab for
    the one distinct device, the one macro-tile on slot 0): phase 5's
    matrix."""
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build

    sk = mesh_sketcher()
    build.reset_launches()
    t0 = time.perf_counter()
    got = sk.all_pairs_intersections(sketches)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    need(np.array_equal(got, want), "13c: the mesh's matrix != phase 5's")
    for key in ("K5", "K10", "K6"):
        need(launches[key] > 0, f"{key} was not launched by 13c's all-pairs")
    print(f"phase 13c: all_pairs_intersections over config 2's "
          f"{len(sketches)} sketches on the 2 x 2 mesh: {wall:.3f} s wall, "
          "phase 5's matrix; launches " + json.dumps(launches))
    return {"launches": launches, "wall_s": wall}


def run_mesh_pipeline(seed, want) -> dict:
    """13(d): MeshDevicePipeline on phase 8(b)'s CONFIG4_GENOMES device
    genomes, on a 1 x 1 mesh and on the 2 x 2 mesh of cuda:0 (dispatches
    of 512 genomes from phase 8(b)'s 128-genome batches, so the genomes
    are the same): both matrices and counts must be phase 8(b)'s.  Each
    runs once timed and once under torch.profiler."""
    import torch

    from spaced_kmer_sketching_tpu_torch.config import SketchConfig
    from spaced_kmer_sketching_tpu_torch.models.fracminhash import (
        FracMinHashSketcher)
    from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    from spaced_kmer_sketching_tpu_torch.pipeline import (
        MeshDevicePipeline, _DevicePlanes, device_source)

    g, n = CONFIG4_GENOMES, CONFIG4_NT
    src = device_source(g, n, seed=seed, device="cuda")

    def batches_of_128(s0, s1):
        parts = [src(a, min(a + 128, s1)) for a in range(s0, s1, 128)]
        return _DevicePlanes(*(torch.cat([getattr(p, f) for p in parts])
                               for f in ("p", "bounds", "rid0",
                                         "valid_len")))
    sk = FracMinHashSketcher(SketchConfig(window=20, k=16), device="cuda")
    out = {"launches": dict.fromkeys(build.KERNELS, 0)}
    for label, shape in (("1x1", (1, 1)), ("2x2", (2, 2))):
        pipe = MeshDevicePipeline(sk, one_card_mesh(shape))
        source = src if shape == (1, 1) else batches_of_128
        build.reset_launches()
        t0 = time.perf_counter()
        res = pipe.all_pairs(source, g, n)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        need(np.array_equal(res.counts, want["counts"])
             and np.array_equal(res.inter, want["inter"]),
             f"13d: the {label} mesh pipeline's matrix != phase 8(b)'s")
        for key in ("K7", "K5", "K10", "K6"):
            need(launches[key] > 0, f"{key} was not launched by 13d {label}")
        print(f"phase 13d: MeshDevicePipeline on a {label} mesh of cuda:0, "
              f"{g} device genomes of {n} codes (dispatch {pipe.dispatch}):"
              f" {wall:.3f} s wall (phase 8b {want['wall_s']:.3f} s); "
              f"restarts {pipe.restarts}; phases {json.dumps(res.phases)}; "
              f"phase 8b's matrix; launches " + json.dumps(launches))
        prof = profile_path(f"phase 13d {label}",
                            lambda: pipe.all_pairs(source, g, n))
        out[label] = {"wall_s": wall, "profile": prof,
                      "restarts": pipe.restarts}
        out["launches"] = add_launches(out["launches"], launches)
        del res
    return out


def run_two_gloo_ranks(paths, tmp: pathlib.Path, want: bytes) -> dict:
    """13(e): two processes over gloo, both on cuda:0, each running the
    port's driver with --mesh auto on config 2 (rank r owns slot r of a
    1 x 2 mesh; the collectives stage through host memory): both CSVs must
    be phase 5's bytes.  Both start at once: a process takes 7-9 s to
    reach the card."""
    port = str(free_port())
    boot = ("import sys, torch\n"
            "from spaced_kmer_sketching_tpu_torch.parallel.distributed "
            "import init_distributed\n"
            "init_distributed(backend='gloo')\n"
            "from spaced_kmer_sketching_tpu_torch import driver\n"
            "rc = driver.main(sys.argv[1:])\n"
            "torch.distributed.destroy_process_group()\n"
            "sys.exit(rc)\n")
    outs = [tmp / f"config2_gloo_rank{r}.csv" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", boot, str(outs[r]), *paths, "--window", "20",
         "--k", "16", "--device", "cuda", "--mesh", "auto"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0"))
        for r in range(2)]
    try:
        results = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (so, se)) in enumerate(zip(procs, results)):
        need(p.returncode == 0, f"13e: rank {r} exited {p.returncode}: "
             f"{se[-3000:]}")
        need(outs[r].read_bytes() == want, f"13e: rank {r}'s CSV != phase "
             "5's")
    print(f"phase 13e: two gloo ranks on cuda:0, the driver with --mesh auto "
          f"on config 2: {wall:.3f} s wall for both; both CSVs are phase 5's "
          "bytes; rank 0: " + " | ".join(results[0][0].splitlines()))
    return {"wall_s": wall}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from spaced_kmer_sketching_tpu_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from spaced_kmer_sketching_tpu_torch.utils import native
    from spaced_kmer_sketching_tpu_torch.utils.native import BUILD_DIR

    rng = np.random.default_rng(args.seed)

    # phase 1: build
    t0 = time.perf_counter()
    so = build.build()
    build.lib()
    need(native.available(), "native/sketchlib.cpp did not build")
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.3f} s "
          f"({so.name})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    ops = extract_op_counts(so.parent)
    print(f"probe SASS instructions (cuobjdump -sass): "
          f"{json.dumps(ops['sass'])}; the work a window cannot skip: of K1 "
          f"and K7 {ops['K1'][0]} (the slide) + {ops['K1'][1]} if valid "
          f"(select, hash, filter), of K11 {ops['K11'][0]} + "
          f"{ops['K11'][1]} if valid ({time.perf_counter() - t0:.3f} s)")
    print(f"extract kernels' SASS holds no CALL (no division routine): "
          f"{json.dumps(no_division_calls(so))} [instructions]")
    print(f"registers and spill bytes (-Xptxas=-v): "
          + json.dumps(ptxas_usage(so)))
    k6_ops = k6_tensor_cores(so)
    print(f"K6 (gram_mma_kernel, pw 1-5) tensor-core instructions "
          f"(cuobjdump -sass): {json.dumps(k6_ops)}")

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    kres = phase_kernels(dev, rng, time_ms, ops)
    kres.update(phase_gram_kernels(dev, time_ms, args.seed))
    kres.update(phase_k7(dev, rng, time_ms, ops))
    kres.update(phase_seed_and_fallback_kernels(dev, rng, time_ms, ops))
    print(f"phase 2: K1-K11 and the seed-batch modes of K1 and K7 bit-exact "
          f"vs plain in {time.perf_counter() - t0:.3f} s")

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        # phases 3-4: the main path
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            t0 = time.perf_counter()
            paths = write_genomes(pathlib.Path(tmp), rng, GENOMES)
            print(f"data: {GENOMES} FASTAs written in "
                  f"{time.perf_counter() - t0:.3f} s")
            run = run_main_path(paths, pathlib.Path(tmp), "cuda", pool)
            # phase 13(a) and the ring of 13(c): config 1 over a mesh
            t0 = time.perf_counter()
            m13a = run_mesh_cli("phase 13a", paths[:2],
                                pathlib.Path(tmp) / "cfg1_mesh.csv",
                                (pathlib.Path(tmp) / "cfg1_cold.csv")
                                .read_bytes(), ("K1", "K3", "K4"))
            ring13a = run_mesh_ring("phase 13a", paths[:2], pool, (1, 1))
            ring13c = run_mesh_ring("phase 13c", paths[:2], pool, (2, 2))
            print(f"phase 13a, 13c ring: {time.perf_counter() - t0:.3f} s "
                  "in all")
            # phase 9: BASELINE config 3 on config 1's two genomes
            t0 = time.perf_counter()
            cfg3 = run_config3(paths[:2], pool)
            print(f"phase 9: {time.perf_counter() - t0:.3f} s in all")
            # phase 10: the single-genome step and the finish fallbacks
            t0 = time.perf_counter()
            fb = run_fallbacks(paths[0], rng, pool)
            print(f"phase 10: {time.perf_counter() - t0:.3f} s in all")
            # phase 12(a) and (e): a killed and resumed sweep, --profile
            t0 = time.perf_counter()
            resumed = run_resumed_sweep(paths[:2], pathlib.Path(tmp))
            profiled = run_profile_flag(paths[:2], pathlib.Path(tmp))
            print(f"phase 12a, 12e: {time.perf_counter() - t0:.3f} s in all")
        for key in ("K1", "K2", "K3", "K4"):
            need(run["launches"][key] > 0,
                 f"{key} was not launched by the main path")
        for key in ("K7", "K2", "K3", "K4"):
            need(cfg3["launches"][key] > 0,
                 f"{key} was not launched by config 3")
        # phase 5: BASELINE config 2
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cfg2 = run_config2(pathlib.Path(tmp), rng, pool)
            print(f"phase 5: {time.perf_counter() - t0:.3f} s in all")
            # phase 12(b): config 2 with --store, then --pairing ring
            t0 = time.perf_counter()
            store_ring = run_config2_store_and_ring(cfg2["paths"],
                                                    pathlib.Path(tmp))
            print(f"phase 12b: {time.perf_counter() - t0:.3f} s in all")
            # phase 13(b), the all-pairs of 13(c) and 13(e): config 2 over
            # a mesh
            t0 = time.perf_counter()
            want2 = (pathlib.Path(tmp) / "config2.csv").read_bytes()
            m13b = run_mesh_cli("phase 13b", cfg2["paths"],
                                pathlib.Path(tmp) / "config2_mesh.csv", want2,
                                ("K1", "K5", "K10", "K6"))
            ap13c = run_mesh_all_pairs(cfg2.pop("sketches"),
                                       cfg2.pop("inter"))
            g13e = run_two_gloo_ranks(cfg2["paths"], pathlib.Path(tmp), want2)
            print(f"phase 13b, 13c all-pairs, 13e: "
                  f"{time.perf_counter() - t0:.3f} s in all")
        # phase 6: the blocked route at G = 4,096
        t0 = time.perf_counter()
        blk = run_blocked(rng, pool)
        print(f"phase 6: {time.perf_counter() - t0:.3f} s in all")
        # phase 14: the bit-tight transport on phase 6's sketches
        t0 = time.perf_counter()
        tgt = run_tight(blk)
        kres["K12"] = tgt.pop("kernel")
        for key in ("sketcher", "sketches", "inter"):
            del blk[key]
        print(f"phase 14: {time.perf_counter() - t0:.3f} s in all")
        # phase 7: BASELINE config 5, streamed
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cfg5 = run_config5(pathlib.Path(tmp), rng, pool)
            print(f"phase 7: {time.perf_counter() - t0:.3f} s in all")
            # the streaming of 13(c): chromosome A over the mesh's ring
            t0 = time.perf_counter()
            st13c = run_mesh_streaming(cfg5["paths"][0],
                                       cfg5.pop("sketches")[0])
            print(f"phase 13c streaming: {time.perf_counter() - t0:.3f} s "
                  "in all")
        # phase 8: BASELINE config 4, the one-flow device pipeline
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cfg4 = run_config4_cli(pathlib.Path(tmp), args.seed, pool)
        cfg4b = run_config4_device(args.seed, pool)
        print(f"phase 8: {time.perf_counter() - t0:.3f} s in all")
        # phase 13(d): phase 8(b)'s genomes through MeshDevicePipeline
        t0 = time.perf_counter()
        pl13d = run_mesh_pipeline(args.seed, {
            "inter": cfg4b.pop("inter"), "counts": cfg4b.pop("counts"),
            "wall_s": cfg4b["wall_s"]})
        print(f"phase 13d: {time.perf_counter() - t0:.3f} s in all")
        # phase 12(c): the out-of-core schedule past the device budget
        t0 = time.perf_counter()
        ooc = run_out_of_core(rng, pool)
        print(f"phase 12c: {time.perf_counter() - t0:.3f} s in all")
    # phase 11: the port's bench, one subprocess a run
    t0 = time.perf_counter()
    bench = run_bench()
    print(f"phase 11: {time.perf_counter() - t0:.3f} s in all")

    phase13 = (m13a, ring13a, ring13c, m13b, ap13c, st13c, pl13d)
    launches13 = add_launches(*(p["launches"] for p in phase13))
    for key in ("K1", "K3", "K4", "K5", "K6", "K7", "K10", "K11"):
        need(launches13[key] > 0, f"{key} was not launched by phase 13")
    paths = (run, cfg2, blk, cfg5, cfg4, cfg4b, cfg3, fb, bench, resumed,
             store_ring, ooc, profiled, tgt, *phase13)
    kernels = []
    for key, kern in build.KERNELS.items():
        r = kres[key]
        launches = sum(p["launches"][key] for p in paths)
        need(launches > 0, f"{key} was launched by no path")
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": kern.source, "replaces": kern.replaces,
                        "launches": launches,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
        if key == "K4":
            kernels[-1].update(device_launches_per_call=r["device_launches"],
                               grid=r["grid"], ms_by_kw=r["ms_by_kw"],
                               device=r["device"])
        if key == "K7":
            kernels[-1].update(seed_batch=kres["K7 seeds"])
        if key in ("K5", "K10"):
            kernels[-1].update(
                device_launches_per_call=r["device_launches"],
                fraction_of_bound=r["bound_ms"] / r["ms"])
        if key == "K12":
            kernels[-1].update(
                device_launches_per_call=r["device_launches"],
                fraction_of_bound=r["fraction_of_bound"],
                device_ms=r["device_ms"],
                device_ms_cold_l2=r["device_ms_cold_l2"])
        if key in ("K8", "K9"):
            kernels[-1].update(
                device_launches_per_call=r["device_launches"],
                fraction_of_bound=r["bound_ms"] / r["ms"],
                device_ms=r["device_ms"], timed_shapes=r["timed_shapes"])
        if key == "K6":
            kernels[-1].update(device_ms=r["device_ms"],
                               timed_shapes=r["timed_shapes"],
                               tensor_core_sass=k6_ops)
        if key == "K3":
            kernels[-1].update(grid=r["grid"], device_ms=r["device_ms"])
        if key in ("K1", "K2", "K11"):
            kernels[-1].update(device_ms=r["device_ms"])
    seeds, seeds7 = kres["K1 seeds"], kres["K7 seeds"]
    print(f"K1 seed-batch mode ({CONFIG3_SEEDS} seeds, n = 2^23): "
          f"{seeds['ms']} ms (device {seeds['device_ms']} ms), "
          f"{CONFIG3_SEEDS} single-seed launches "
          f"{seeds['singles_ms']} ms, plain {seeds['plain_ms']} ms, bound "
          f"{seeds['bound_ms']} ms ({seeds['bound_by']}); K7 seed-batch mode "
          f"(config 3's path) {seeds7['ms']} ms (device "
          f"{seeds7['device_ms']} ms), plain {seeds7['plain_ms']} "
          f"ms, bound {seeds7['bound_ms']} ms ({seeds7['bound_by']}); {smi}")
    print(json.dumps({"kernels": kernels}))
    print(f"profiled paths ([device ms, launches]; K2's and K3's bytes): "
          f"phase 6 "
          f"(G = {BLOCKED_GENOMES}) {json.dumps(blk['profile'])}; phase 7 "
          f"(config 5) {json.dumps(cfg5['profile'])}; phase 8b "
          f"(G = {CONFIG4_GENOMES}) {json.dumps(cfg4b['profile'])}; {smi}")
    s_ms, c_ms = run["config1_warm"]
    print(f"config 1 (2 genomes, w=20, k=16, warm): sketching {s_ms} ms, "
          f"comparison {c_ms} ms; {smi}")
    print(f"config 2 (100 genomes, w=20, k=16): sketching "
          f"{cfg2['sketching_ms']} ms, comparison {cfg2['comparison_ms']} ms; "
          f"G = {BLOCKED_GENOMES} blocked all-pairs {blk['wall_s']} s; {smi}")
    print(f"config 5 (2 chromosomes, streamed, w=20, k=16): sketching "
          f"{cfg5['sketching_ms']} ms, comparison {cfg5['comparison_ms']} ms; "
          f"{smi}")
    print(f"config 4 ({CONFIG4_FILES} files through the pipeline CLI): "
          f"sketching {cfg4['sketching_ms']} ms, comparison "
          f"{cfg4['comparison_ms']} ms (two-step path: sketching "
          f"{cfg4['two_step_ms'][0]} ms, comparison {cfg4['two_step_ms'][1]} "
          f"ms); G = {CONFIG4_GENOMES} device-source pipeline "
          f"{cfg4b['wall_s']} s; {smi}")
    print(f"config 3 ({CONFIG3_SEEDS} seeds over each of config 1's 2 "
          f"genomes): {cfg3['wall_s']} s wall, {cfg3['rates']} "
          f"window-seeds/s; {smi}")
    dl = cfg4b["download"]
    prof = ooc["profile"]
    print(f"phase 12: the 62-config sweep with --store "
          f"{resumed['wall_s']:.3f} s, resumed from a cut "
          f"{resumed['resume_wall_s']:.3f} s; config 2 with --store "
          f"{store_ring['walls_s'][0]:.3f} s, from the store "
          f"{store_ring['walls_s'][1]:.3f} s, ring "
          f"{store_ring['ring_wall_s']:.3f} s; out of core at G = "
          f"{OUT_OF_CORE['genomes']}: {ooc['wall_s']:.3f} s wall "
          f"(the sketcher's route {ooc['sketcher_wall_s']:.3f} s), "
          f"{ooc['presorts']} presorts, {ooc['cache_hits']} cache hits, "
          f"device sums [ms, launches] K5 {prof['K5']}, K10 {prof['K10']}, "
          f"K6 {prof['K6']}; phase 8b's matrix download in turns "
          f"{json.dumps(dl['turns_ms'])} ms (int32, int16); --profile on "
          f"config 1 "
          f"{profiled['wall_s']:.3f} s; {smi}")
    sums13d = {k: json.dumps({n: p["profile"][n] for n in PATH_KERNELS})
               for k, p in (("1x1", pl13d["1x1"]), ("2x2", pl13d["2x2"]),
                            ("8b", cfg4b))}
    print(f"phase 13 (slots of one card run one after another: no "
          f"scaling): config 1 --mesh auto {m13a['wall_s']:.3f} s "
          f"(sketching {m13a['sketching_ms']} ms, comparison "
          f"{m13a['comparison_ms']} ms); config 2 --mesh auto "
          f"{m13b['wall_s']:.3f} s (sketching {m13b['sketching_ms']} ms, "
          f"comparison {m13b['comparison_ms']} ms); 1 x 1 ring on config 1 "
          f"{ring13a['wall_s']:.3f} s; 2 x 2 ring on config 1 "
          f"{ring13c['wall_s']:.3f} s; chrA streamed over it "
          f"{st13c['wall_s']:.3f} s; config 2 all-pairs on it "
          f"{ap13c['wall_s']:.3f} s; MeshDevicePipeline at G = "
          f"{CONFIG4_GENOMES}: 1x1 {pl13d['1x1']['wall_s']:.3f} s, 2x2 "
          f"{pl13d['2x2']['wall_s']:.3f} s (phase 8b {cfg4b['wall_s']:.3f} "
          f"s), device sums [ms, launches] 1x1 {sums13d['1x1']}, 2x2 "
          f"{sums13d['2x2']}, 8b {sums13d['8b']}"
          f"; two gloo ranks on config 2 {g13e['wall_s']:.3f} s; launches "
          f"{json.dumps(launches13)}; {smi}")
    print(f"phase 14 (G = {BLOCKED_GENOMES}): phase 6 took the {tgt['route']}"
          "; turns " + json.dumps([{k: r[k] for k in ("transport", "wall_s",
                                                     "host_thread_ms",
                                                     "h2d_bytes")}
                                  for r in tgt["turns"]]) + f"; {smi}")
    print("bench (phase 11): " + "; ".join(
        f"{label} {line['metric']} {line['value']} {line['unit']}"
        for label, line in bench["lines"].items()) + f"; {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
