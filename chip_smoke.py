"""Drive the PyTorch port's paths once on one CUDA card: flow + PC1
(Farnebäck), the TV-L1 flow engine, the production pipeline run_full
(decode → ROI-dispatched flow → PC1 → metrics), the cohort runner, the
reference-compatible CLIs, streaming PC1, the JAX bench's bf16 flow config,
the height-sharded flow, the batched metric head, BASELINE config 3 (a
10-minute 1080p recording with checkpoint resume), config 2 (left and right
ROIs on one recording) and config 5 (TV-L1 at clinical frame sizes, and
through run_full).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failed check raises, so the exit code is non-zero):

1. device  — card name and power limit (nvidia-smi), torch / CUDA
             versions, the TF32 flags (both set False);
2. build   — nvcc builds csrc/farneback.cu, csrc/tvl1.cu and
             csrc/filters.cu for sm_90a in parallel (build/kernels/), with
             ptxas' register report;
3. kernels — K1 poly_exp, K2 update_matrices (whole level, and in box
             mode over the bench ROI's level-0 box), K3 update_flow and K4
             update_matrices_tiles (over that box's tiles and over a seeded
             random half of all tiles) against their plain PyTorch versions
             on bench frames at 480×640, B = 8, with CUDA-event medians of
             both; K3's box mode against its plain version; then (3b) K1, K2
             (whole, beside the pre-walk K2 on the same tensors), K4 over the
             ROI box's tiles and K2's box mode (beside K4) and K3 (full frame
             and box mode) at the main path's shape, one 257-frame chunk at
             level 0, with K1's one-call yardstick (F.conv2d with the five
             folded 11×11 filters); (3c) the PC1 head's band-pass cascade
             (sos_cascade_kernel, one sosfilt pass a launch) at the staging
             rows of the benchmark's cells, (2, 64, 3649), (2, 2, 64, 3649)
             and (2, 32, 64, 409), torch.equal to the plain _section_scan
             loop in y and zf and timed in rounds plain, kernel, kernel,
             plain, and a 10-section cascade (two launches) torch.equal;
4. slice   — the bench clip's 512 pairs as two 257-frame chunks through
             roi_body_flow_seq and then pc1_from_flow, with the launch
             counts, the kernel path against the plain path (on the card
             and on the CPU) and pairs/s beside the card's name and power;
5. profile — device time by kernel over one chunk (torch.profiler);
6. TV-L1 kernels — K5 warp_sample and one 30-iteration K6 pd_chain
             against their plain versions on level-0 planes of the TV-L1
             clip (16 pairs of 480×640), with CUDA-event medians; K5 beside
             its one-call yardstick (F.grid_sample, border, align_corners) in
             alternating rounds; K6 (bit-equal at every run) at each pyramid
             level with its default schedule, and at level 0 at every
             compiled depth (depth 1 is one launch per iteration); K6's ε
             step at the 1080p level-0 shape (B=16): one step and its stop
             test bit-equal to the plain iteration and timed against it, the
             kernel alone against its bytes (first and later step), a whole
             ε loop bit-equal with one launch an iteration;
7. TV-L1 slice — tvl1_flow on the 16 pairs with default TVL1Params:
             launch counts against the per-level schedule (15 K5, 15 chains
             of ceil(30 / depth) K6 launches), the kernel path against the
             plain path on the card and on the CPU, clips, frames/s on the
             card (fenced by a synchronise) and with the flow copied to the
             host, then (7b) device time by kernel, the host's largest
             operators and the device busy share of the call (kernel time /
             its time on the card);
8. pipeline — run_full on the 513-frame bench clip (ArraySource, the bench
             ROI, body axes at θ = 0.3, chunks of 256 pairs, PipelineConfig()):
             launches against the schedule derived from the ROI boxes, ROI
             features against phase 4's full-frame ones, PC1 and metrics on
             the card against the CPU, stage times and ROI-frames/s from
             decode, then device time by kernel over one ROI-dispatched chunk;
9. cohort  — run_cohort at the JAX bench's cohort size (32 clips of 129
             frames, render_clip(seed=10 + v), chunks of 128 pairs): the
             batched path on host clips and on clips on the card, and the
             per-video path (ROI-dispatched, two flow workers); every row
             status 0, rows equal across the three, launches of the first
             batched run against the full-frame schedule, one video's row
             against run_full, frames/s and stage seconds;
10. compat — optical_flow → optical_PCA → optical_PC1 main() on the card
             over the bench clip as .npy with its skeleton .npz: the flow
             CLI's launches against its ROI boxes, flow.csv byte-equal to
             run_flow_stage's, flow_pc1.csv against the CPU, a one-row
             summary;
11. PC1 engines — pc1_from_flow with the "scan" and "assoc" band-pass on
             phase 4's features (times, agreement), and pc1_streaming
             ("assoc") on 18000 samples against the full signal;
12. bench config — run_full on the 513-frame clip under the JAX bench's flow
             config (bench.py:150-155: the bf16 warp, iteration schedule
             (3, 3, 2, 1)): launches of K2's bf16 instance (box mode on the
             boxed levels) against the ROI-box schedule, the flow's EPE in the ROI against the fp32
             flow of phase 4's pairs (mean < 0.05 px), PC1 against phase 8's
             (corr ≥ 0.999), ROI-frames/s;
13. sharded — farneback_flow_sharded on 16 pairs at 480×640 over 4 shards
             and at 1080×1920 over 3, on the cards present or an explicit
             cuda:0 layout when there are fewer: launches (K2's row-offset
             instance), max |Δ| against the unsharded flow (≤ 1e-4 px), times;
14. metric head — pc1_metrics_batch against K calls of pc1_metrics on the
             card over phase 9's stage C input (32 rows) and over 128
             synthetic 60-s rows (half 30 fps, half 25 fps: two window
             shapes, 20-row blocks): status and Peak_n equal, the floats
             within rel 1e-6, the blocks, and the median seconds of both;
15. BASELINE config 3 — a 10-minute 1080p recording (18001 frames at 30 fps,
             a rendered 129-frame clip played forward and back) through
             run_full under the JAX bench's flow config, its 1080p ROI and
             chunks of 64 pairs: the launches of one chunk through
             run_flow_stage against the schedule (4 K1, 9 K2 bf16 of which 8
             in box mode, 9 K3, no K4); (15a) at each level of one 64-pair
             chunk K1, K2 bf16 whole and the pre-walk K2, K2 bf16 in box mode
             and K4 bf16 over the box's tiles (boxed levels), K3 (whole and
             box mode) bit-equal to their plain versions, each launch then
             timed at its level (K2 against its earlier design in turns) and
             the chunk's launches back to back beside their bound, and the
             same at level 0 of a 256-pair chunk; (15b) on the first chunk
             ROI against full-frame features, kernel against plain path, bf16
             against fp32 flow EPE in the ROI, and the plain path's features
             through run_flow_stage; (15c)
             run_flow_stage over 2 minutes at chunks of 32/64/128/256 pairs:
             frames/s, peak device memory, launches against the schedule;
             (15d) the 10-minute run_full with a checkpoint store: frames/s,
             stage seconds, peak device memory and host RSS (sampled), its
             first chunk array_equal to 15b's plain path;
             (15e) a run killed by a decode error 40% in and a recording cut
             inside a chunk, each resumed over the whole recording and equal
             to 15d's features, the chunks recomputed counted by K1's
             launches; (15f) pc1_streaming against run_pc1_stage; (15g) a
             profile of two chunks with the device's idle gaps, and the host
             syncs per chunk and the two chunks' time against the level loop
             with its boxed levels on K4's list form;
16. BASELINE config 2 — left and right ROIs on one 1080p recording (a
             two-blob base, 3601 frames = 2 minutes) through run_full under
             the JAX bench's flow config, chunks of 64 pairs: each level's
             union box, one chunk's launches through run_flow_stage against
             the union-box schedule, both ROIs' boxed features against the
             full frame and the kernel path against the plain path on the
             first chunk (0.0), the 2-minute run (launches, frames/s, stage
             seconds, peak memory, both metric rows), and each ROI's features,
             PC1 and metric row array_equal to a run with that ROI alone;
17. BASELINE config 5 — tvl1_flow on 16 pairs of render_clip(seed=2) at
             720×1280 and 1080×1920: the engine of each level (_resident_ok:
             the epsilon loop at 720p level 0 and 1080p levels 0–1, K6 on the
             rest), launches against that schedule (at least one ε step a
             warp on the ε-loop levels), K5 at every level and K6
             at every resident level against their plain versions and timed
             with their bounds (K5 beside F.grid_sample at level 0), the call
             against the plain path, the epsilon loop's iterations per level
             and warp, its host syncs (profiler) and share of the call,
             frames/s and peak memory; then the card against the CPU at
             112×896 (level 0 on the epsilon loop) and the translation of a
             textured 1080p frame (interior EPE);
18. BASELINE config 5 through run_full — PipelineConfig(flow=TVL1Params())
             on 137 frames of a 33-frame 1080p base played forward and back,
             the 1080p ROI, chunks of 16 pairs (the benchmark's cell
             tvl1.hd1080_16pairs): the TV-L1 launches, counted from zero just
             before the run, against 15 K5, 5 K6 chains and 20 K6 launches a
             chunk (the padded tail included) and at least one ε step an ε
             loop (10 a chunk), two cascade launches per
             band-pass, the features against the same run on the plain path
             (max |d| <= 1e-3 px) and PC1 beside it (corr >= 0.999), then K5's
             device time per pyramid level in a profiled run_flow_stage of two
             chunks, its share of the bound per level and over the call,
             beside phase 17's CUDA-event medians.
Phase 3 and 3b also hold K2's and K4's bf16 instances and K2's row-offset
instance against their plain versions; phases 8, 9, 11, 12, 15d and 16
count the band-pass calls of their PC1 head and require two cascade
launches a call (its forward and backward pass); phase 9 runs run_cohort
over a mesh of every card present and, with one card, over a 4-shard
cuda:0 layout (rows equal to the batched run's).  Phases 9–18 print their seconds; the
kernel rows of phase 15's kernels carry its 1080p figures (hd_*), those of
phase 16's its launches (bilateral_*), K5's and K6's phase 17's figures
(tv_<size>_*) and phase 18's launches and traced levels (tv_run_full_*).

Every kernel row of the kernels JSON carries its bound: the larger of the
bytes it must move (each input read once, each output written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s (one H100 SXM, NVIDIA's
data sheet), computed from the shapes of the call it was timed at, with
its share (bound / time) and the time of one PyTorch call that computes the
same function, or null where none does (the reason is printed); the
cascade's row also says why it is latency-bound (bound_note).  The
second-to-last line is the kernels JSON, the last line {"ok": true,
"device": {...}}.  Imports neither JAX nor cv2.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import json
import os
import pathlib
import statistics
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_PAIRS = 512
CHUNK = 256
CHECK_PAIRS = 8
REPS = 20
SOURCE = "btcs_pnes_optical_flow_tpu_torch/csrc/farneback.cu"
TV_SOURCE = "btcs_pnes_optical_flow_tpu_torch/csrc/tvl1.cu"
FLT_SOURCE = "btcs_pnes_optical_flow_tpu_torch/csrc/filters.cu"
PALLAS = "btcs_pnes_optical_flow_tpu/ops/farneback_pallas.py"
TV_PALLAS = "btcs_pnes_optical_flow_tpu/ops/tvl1_pallas.py"
TV_JAX = "btcs_pnes_optical_flow_tpu/ops/tvl1.py"
SPATIAL = "btcs_pnes_optical_flow_tpu/parallel/spatial.py"
JAX_FILTERS = "btcs_pnes_optical_flow_tpu/ops/filters.py"
TV_PAIRS = 16  # the JAX bench's TV-L1 line: render_clip(17, seed=2)
# The JAX bench's cohort line (bench.py:401-496): 32 clips of 129 frames,
# chunks of 128 pairs.
COHORT_VIDEOS, COHORT_FRAMES, COHORT_CHUNK = 32, 129, 128
STREAM_SAMPLES = 18000  # 10 minutes at 30 fps
# The JAX bench's flow config (bench.py:150-155): the bf16 warp, the
# iteration schedule and the coarse reach (ignored by the port's direct
# sampler); run_flow_stage adds the ROI boxes.
BENCH_FLOW = dict(warp_precision="bf16", iter_schedule=(3, 3, 2, 1), warp_coarse_reach=(4, 8, 8))
BENCH_EPE_PX = 0.05  # tests/test_pallas_kernels.py's bf16 gate
PC1_CORR = 0.999  # BASELINE.md's PC1 contract
# Height sharding: 16 pairs (the K2 rows instance's main path) at 480×640 over
# 4 shards and at 1080×1920 over 3 (1080 = 3·8·45), warp_halo 16.
SHARD_PAIRS, WARP_HALO = 16, 16
SHARD_CASES = ((480, 640, 4), (1080, 1920, 3))
SHARD_TOL_PX = 1e-4  # tests/test_spatial.py's sharded-vs-unsharded bar
# (name, K, TPU kernel it replaces, tolerance against the plain version
# relative to the plain output's largest magnitude, and why).
KERNELS = (
    ("poly_exp", "K1", f"{PALLAS}:1542", 0.0,
     "bit-equal: the plain fp32 tap sums in their order, without FMA contraction"),
    ("update_matrices", "K2", f"{PALLAS}:566", 0.0,
     "bit-equal: the plain guard and fp32 operations in their order, without FMA contraction"),
    ("update_flow", "K3", f"{PALLAS}:1802", 0.0,
     "bit-equal: the plain window sums in their order, then the same solve"),
    ("update_matrices_tiles", "K4", f"{PALLAS}:1040", 0.0,
     "bit-equal: K2's device function, the plain version's operations in their order"),
    # warp_precision="bf16": the TPU kernel's bf16 candidate MAC
    # (farneback_pallas.py:313, 470-471, 486-487, 520-532).
    ("update_matrices_bf16", "K2 bf16", f"{PALLAS}:566", 0.0,
     "bit-equal: the plain bf16 lerp (each bf16 step rounded to nearest even) and fp32 "
     "operations in their order, without FMA contraction"),
    # K2's box mode: the TPU kernel's `active` tile range
    # (farneback_pallas.py:566, 612-624), a boxed level of ROI dispatch.
    ("update_matrices_box", "K2 box", f"{PALLAS}:566", 0.0,
     "bit-equal: K2's device function over the box, M outside it untouched"),
    ("update_matrices_box_bf16", "K2 box bf16", f"{PALLAS}:566", 0.0,
     "bit-equal: K2's bf16 device function over the box, M outside it untouched"),
    ("update_matrices_tiles_bf16", "K4 bf16", f"{PALLAS}:1040", 0.0,
     "bit-equal: K2's bf16 device function, the plain version's operations in their order"),
    # K2 on a height shard: parallel/spatial.py's warp and assembly.
    ("update_matrices_rows", "K2 rows", f"{SPATIAL}:103", 0.0,
     "bit-equal: K2's device function with global rows and a halo band, the plain guard and "
     "fp32 operations in their order"),
)
# K2's earlier designs, timed beside it on the same tensors: the whole level
# before the walk (the row-offset instance at offset 0), and a boxed level
# before the box mode (K4 over the box's tile list).
PREWALK = "pre-walk K2: update_matrices_rows_cf at row_off 0, no halo"
K4_LIST = "K4 over the box's tile list"
FLOW_TOL_PX = 1e-3  # the JAX package's fused-vs-exact 480p bar
MAIN_REPS = 10  # CUDA-event repetitions per round at the main path's shape
# One H100 SXM (NVIDIA's data sheet): HBM bytes/s and float32 operations/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The bench ROI (bench.py:106) and body axes (bench.py:107-109).
ROI = np.array([[140.0, 90.0], [520.0, 110.0], [500.0, 400.0], [120.0, 380.0]])
THETA = 0.3
FEATURE_TOL = 1e-6  # px/frame: ROI-dispatched vs full-frame ROI features (0.0 expected)
METRIC_RTOL = 1e-4  # metric head, card vs CPU on the same PC1
# Phase 14: the batched metric head against its row loop on the card.
HEAD_ROWS, HEAD_SEC, HEAD_ROUNDS = 128, 60, 2
HEAD_RTOL = 1e-6
# Phase 15, BASELINE config 3 (bench.py:285-370): a 10-minute 1080p
# recording at 30 fps, played forward and back from a rendered base clip,
# the bench's 1080p ROI (bench.py:301) and axes, its flow config
# (BENCH_FLOW, bench.py:325-330) and run_full's default chunk.
HD_H, HD_W, HD_FPS = 1080, 1920, 30.0
HD_FRAMES = 18001  # 10 minutes
HD_BASE_FRAMES = 129
HD_ROI = np.array([[420.0, 270.0], [1560.0, 330.0], [1500.0, 900.0], [360.0, 840.0]])
HD_CHUNK = 64
HD_PLAIN_PAIRS = 32  # 15a's plain versions at 256 pairs run over slices of this many
HD_SWEEP_FRAMES = 3601  # 2 minutes
HD_SWEEP_CHUNKS = (32, 64, 128, 256)
HD_CRASH_FRAME = 7200  # 15e's decode error, 40% into the recording
HD_TAIL_FRAMES = 7000  # 15e's cut recording: 6999 pairs, a 23-pair tail chunk
STREAM_CORR = 0.9999  # phase 11's streaming bar
# Phase 16, BASELINE config 2: bilateral left/right ROIs on one 1080p
# recording.  A 129-frame base of two blobs, each moving by bench.render_clip's
# law (x / w, Hz), on one texture, played forward and back to 2 minutes (the
# length of a seizure); one polygon around each blob, 600 px apart.
BI_FRAMES = 3601
BI_BLOBS = ((0.25, 3.0), (0.75, 2.5))
BI_ROIS = (np.array([[300.0, 350.0], [660.0, 370.0], [650.0, 730.0], [310.0, 710.0]]),
           np.array([[1260.0, 370.0], [1620.0, 350.0], [1610.0, 710.0], [1270.0, 730.0]]))
# Phase 17, BASELINE config 5: TV-L1 at clinical frame sizes, with the pyramid
# levels that the JAX rule _resident_ok sends to the epsilon loop
# (tests/test_torch_tvl1.py test_pd_engine_resolution_per_level_matches_jax).
TV_CLINICAL = {(720, 1280): [0], (1080, 1920): [0, 1]}
TV_EPS_SIZE = (112, 896)  # card vs CPU where level 0 takes the epsilon loop
TV_SHIFT, TV_EPE_PX = (1.2, -0.7), 0.25  # tests/test_torch_tvl1.py's translation and bar
TV_REPS = 5  # CUDA-event repetitions per round of phase 17's kernel timings
# Phase 18, BASELINE config 5 through run_full, as the benchmark's cell
# tvl1.hd1080_16pairs runs it: chunks of 16 pairs, over 8 chunks and a
# padded 8-pair tail of a 33-frame base played forward and back; the
# profiled run_flow_stage covers 2 chunks.
TV_RUN_CHUNK, TV_RUN_FRAMES, TV_RUN_BASE, TV_RUN_PROFILED = 16, 16 * 8 + 9, 33, 33
# TV-L1: (name, K, TPU kernel it replaces, tolerance, and why).
TV_KERNELS = (
    ("warp_sample", "K5", f"{PALLAS}:1359", 1e-5,
     "relative to max|plain|: the plain clamp, floor and bilinear fp32 "
     "operations in their order, without FMA contraction (bit-equal expected)"),
    ("pd_chain", "K6", f"{TV_PALLAS}:204", 0.0,
     "px absolute over one 30-iteration chain, bit-equal: the plain factored "
     "operations in their order, without FMA contraction, on tiles whose halos "
     "are recomputed exactly"),
    ("pd_eps_step", "K6 eps step", f"no TPU kernel: XLA ops in JAX ({TV_JAX}:225)", 0.0,
     "px absolute over one step and its stop test, bit-equal: K6's depth-1 arithmetic, "
     "the pair's mask, the squared update reduced by the plain loop's own mean"),
)
# Phase 6's ε step: B=TV_PAIRS at 1080p level 0, and its bytes a pixel with
# the squared update written: 6 planes in, u, v, 4 duals and sq out (the
# first step, zero duals), and 4 duals more in after it.
TV_EPS_STEP_BYTES = (4 * (6 + 7), 4 * (10 + 7))


# Phase 3c: the PC1 head's band-pass cascade at the staging rows of the
# benchmark's cells, (2 signals, ROIs, 64 runs, N + 48 samples): a 2-minute
# 1080p recording with one ROI (the one-ROI staging has no ROI axis) and
# with two, and the 480p cohort's 32 rows of 361 frames.
FLT_SHAPES = (("1080p, one ROI", (2, 64, 3649)), ("1080p, two ROIs", (2, 2, 64, 3649)),
              ("480p cohort", (2, 32, 64, 409)))
FLT_LONG_ORDER = 10  # a band-pass of 10 sections: past one launch's 8, two launches
# (name, K, what it replaces, tolerance, and why).
FLT_KERNELS = (
    ("sos_cascade", "sos", f"no TPU kernel: lax.scan in JAX ({JAX_FILTERS}:48)", 0.0,
     "bit-equal: _section_scan's float32 operations in their order, without FMA contraction"),
)


def _median_ms(fn, reps=REPS):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("== 1. device")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from btcs_pnes_optical_flow_tpu_torch.ops import (_build, farneback_cuda, filters_cuda,
                                                      tvl1_cuda)

    print("== 2. build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, started together
        results = list(pool.map(_build.load, ("farneback.cu", "tvl1.cu", "filters.cu")))
    farneback_cuda.library()
    tvl1_cuda.library()
    filters_cuda.library()
    for res in results:
        print(f"nvcc: {' '.join(res.command) if res.command else '(cached) ' + str(res.path)}")
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
        print(f"build {res.seconds:.2f} s -> {res.path.name}")
    print(f"all built in {time.perf_counter() - t0:.2f} s")
    _sass_mix(results[1].path, f"pd_block_kernelILi{tvl1_cuda.PD_DEPTH}E")


def _sass_mix(lib_path, mangled):
    """The instruction mix of one kernel's SASS (cuobjdump), where the
    toolkit has cuobjdump: what K6's time is spent issuing."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"SASS of {mangled}: not read ({exc})")
        return
    for part in sass.split("Function : ")[1:]:
        if mangled not in part.splitlines()[0]:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", part))
        print(f"SASS of {mangled}: {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(16)))


def _rel_err(kern, plain):
    """max|kern - plain| relative to max|plain|, and the raw max."""
    d = float((kern - plain).abs().max())
    return d / max(float(plain.abs().max()), 1e-30), d


def phase_kernels(clip, params, device):
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    print(f"== 3. kernels vs plain at 480x640, B={CHECK_PAIRS}")
    h, w = clip.shape[1:]
    frames = torch.as_tensor(clip[: CHECK_PAIRS + 1], device=device)
    lv, _, _ = fb._level_image(frames.float(), 0, params, h, w)
    lv = lv.contiguous()
    # Realistic level-0 inputs: the plain path's flow for these pairs.
    flow_plain = fb.farneback_flow_seq(frames, params, kernels=False)
    flow_cf = flow_plain.movedim(-1, 1).contiguous()
    poly = fb.poly_exp_cf_plain(lv, params.poly_n, params.poly_sigma)
    r0, r1 = poly[:-1], poly[1:]
    m = fb.update_matrices_cf_plain(r0, r1, flow_cf)
    calls = {
        "poly_exp": (lambda: fc.poly_exp_cf(lv, params.poly_n, params.poly_sigma),
                     lambda: fb.poly_exp_cf_plain(lv, params.poly_n, params.poly_sigma)),
        "update_matrices": (lambda: fc.update_matrices_cf(r0, r1, flow_cf),
                            lambda: fb.update_matrices_cf_plain(r0, r1, flow_cf)),
        "update_flow": (lambda: fc.update_flow_cf(m, params.winsize, params.gaussian_win),
                        lambda: fb.update_flow_cf_plain(m, params.winsize, params.gaussian_win)),
    }
    # K4 over the tiles of the bench ROI's level-0 box (the pipeline's list),
    # then over a seeded random half of all tiles, into an M that holds
    # zero-flow matrices, so that an unlisted tile written by mistake shows.
    box0 = fb.roi_dispatch_params(params, h, w, roi_mask(h, w)).roi_active_px[0]
    tiles0 = fb.box_tiles(box0, h, w)
    th, tw = fb.TILE
    n_tiles = CHECK_PAIRS * (-(-h // th)) * (-(-w // tw))
    rand = np.random.default_rng(0).permutation(n_tiles)[: n_tiles // 2].astype(np.int32)
    base = fb.update_matrices_cf_plain(r0, r1, torch.zeros_like(flow_cf))
    lists = {"ROI box": fb.tile_list(CHECK_PAIRS, tiles0, h, w, device),
             "random half": torch.as_tensor(rand, device=device)}
    print(f"K4 lists: ROI box tiles {tiles0} of the {-(-h // th)}x{-(-w // tw)} lattice "
          f"({lists['ROI box'].numel()} tiles), random half ({rand.size} of {n_tiles})")
    k4_bufs = {}

    def k4_calls(key, precision="fp32"):
        sel = lists[key]
        mk, mp = k4_bufs.setdefault((key, precision), (base.clone(), base.clone()))
        return (lambda: fc.update_matrices_tiles_cf(r0, r1, flow_cf, sel, mk, fb.TILE, precision),
                lambda: fb.update_matrices_tiles_cf_plain(r0, r1, flow_cf, sel, mp, fb.TILE,
                                                          precision))

    calls["update_matrices_tiles"] = k4_calls("ROI box")
    calls["update_matrices_tiles_bf16"] = k4_calls("ROI box", "bf16")
    # K2's box mode over the same box (its pixels: the level loop's box),
    # into the same zero-flow M.
    box_px = fb.tile_box(tiles0, h, w)
    box_bufs = {}

    def box_calls(precision):
        mk, mp = box_bufs.setdefault(precision, (base.clone(), base.clone()))
        return (lambda: fc.update_matrices_cf(r0, r1, flow_cf, precision, box_px, mk),
                lambda: fb.update_matrices_cf_plain(r0, r1, flow_cf, precision, box_px, mp))

    calls["update_matrices_box"] = box_calls("fp32")
    calls["update_matrices_box_bf16"] = box_calls("bf16")
    calls["update_matrices_bf16"] = (lambda: fc.update_matrices_cf(r0, r1, flow_cf, "bf16"),
                                     lambda: fb.update_matrices_cf_plain(r0, r1, flow_cf, "bf16"))
    # K2 rows over the 4 row blocks of these pairs with the sharded path's band.
    rows_args, h_loc, k_rows = _row_blocks(r0, r1, flow_cf, SHARD_CASES[0][2], WARP_HALO)
    calls["update_matrices_rows"] = _rows_calls(rows_args)
    print(f"K2 rows: {len(rows_args)} blocks of {h_loc} rows, halo band {k_rows} rows")
    rows = {}
    for name, kid, replaces, rtol, why in KERNELS:
        rows[name] = _check_and_time(name, kid, SOURCE, replaces, *calls[name],
                                     rtol=rtol, abs_tol=None, why=why)
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == "update_matrices_tiles")
    half = _check_and_time(name, kid, SOURCE, replaces, *k4_calls("random half"),
                           rtol=rtol, abs_tol=None, why=why + "; random half list")
    rows["update_matrices_tiles"]["max_abs_err"] = max(
        rows["update_matrices_tiles"]["max_abs_err"], half["max_abs_err"])
    for (key, prec), bufs in k4_bufs.items():
        listed = fb.tile_mask(lists[key], CHECK_PAIRS, h, w, fb.TILE)[:, None].expand_as(base)
        for buf in bufs:
            if not torch.equal(buf[~listed], base[~listed]):
                raise AssertionError(f"K4 {prec} ({key}) wrote outside its listed tiles")
    print(f"K4: unlisted tiles bitwise unchanged for {sorted(k4_bufs)}")
    y0, y1, x0, x1 = box_px
    inside = torch.zeros_like(base, dtype=torch.bool)
    inside[:, :, y0:y1, x0:x1] = True
    for prec, bufs in box_bufs.items():
        for buf in bufs:
            if not torch.equal(buf[~inside], base[~inside]):
                raise AssertionError(f"K2 box mode ({prec}) wrote outside its box {box_px}")
    print(f"K2 box mode {box_px}: M outside the box bitwise unchanged for {sorted(box_bufs)}")

    px = CHECK_PAIRS * h * w
    n_listed = int(fb.tile_mask(lists["ROI box"], CHECK_PAIRS, h, w, fb.TILE).sum())
    _set_bound(rows["poly_exp"], (CHECK_PAIRS + 1) * h * w, *_k1_cost(params.poly_n), None,
               "timed at the main path's shape in phase 3b")
    _set_bound(rows["update_matrices"], px, *_k2_cost(CHECK_PAIRS), None,
               NO_LIBRARY["update_matrices"])
    _set_bound(rows["update_flow"], px, *_k3_cost(params.winsize, params.gaussian_win), None,
               NO_LIBRARY["update_flow"])
    _set_bound(rows["update_matrices_tiles"], n_listed, *_k2_cost(CHECK_PAIRS), None,
               NO_LIBRARY["update_matrices_tiles"])
    _set_bound(rows["update_matrices_bf16"], px, *_k2_cost(CHECK_PAIRS, "bf16"), None,
               NO_LIBRARY["update_matrices"])
    _set_bound(rows["update_matrices_tiles_bf16"], n_listed, *_k2_cost(CHECK_PAIRS, "bf16"), None,
               NO_LIBRARY["update_matrices_tiles"])
    n_box = CHECK_PAIRS * (y1 - y0) * (x1 - x0)
    _set_bound(rows["update_matrices_box"], n_box, *_k2_cost(CHECK_PAIRS), None,
               NO_LIBRARY["update_matrices_box"])
    _set_bound(rows["update_matrices_box_bf16"], n_box, *_k2_cost(CHECK_PAIRS, "bf16"), None,
               NO_LIBRARY["update_matrices_box"])
    _set_bound(rows["update_matrices_rows"], px, *_k2_rows_cost(h_loc, k_rows), None,
               NO_LIBRARY["update_matrices"])

    # K3 box mode over the level-0 box, against its plain version.
    box = fb.tile_box(tiles0, h, w)
    _check_box_mode(m, params, box, flow_cf)
    return rows, flow_plain, box


def _check_box_mode(m, params, box, flow_cf):
    """K3 in box mode against its plain version (bit-equal), with the flow
    outside the box left as it was; returns the kernel and plain calls."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    out0 = flow_cf.clone()
    kern = fc.update_flow_cf(m, params.winsize, params.gaussian_win, box, out0.clone())
    plain = fb.update_flow_cf_plain(m, params.winsize, params.gaussian_win, box, out0.clone())
    torch.cuda.synchronize()
    d_box = float((kern - plain).abs().max())
    inside = torch.zeros_like(out0, dtype=torch.bool)
    inside[:, :, box[0]:box[1], box[2]:box[3]] = True
    print(f"K3 box mode {box}, B={m.shape[0]}: max_abs_err {d_box:.3e} px against its plain "
          f"version (bar 0.0: bit-equal); flow outside the box unchanged")
    if d_box != 0.0 or not torch.equal(kern[~inside], out0[~inside]):
        raise AssertionError("K3 box mode disagrees with its plain version")
    bufs = (out0.clone(), out0.clone())
    return (lambda: fc.update_flow_cf(m, params.winsize, params.gaussian_win, box, bufs[0]),
            lambda: fb.update_flow_cf_plain(m, params.winsize, params.gaussian_win, box, bufs[1]))


# Bytes and float32 operations per pixel of each kernel, from its plain
# version: every input read once and every output written once.
# bf16 adds per pixel 2 weight roundings and, per channel and row, 2 tap
# roundings, 2 product roundings and a sum rounding (a rounding counts as
# one operation): 2 + 5·2·5.
K2_BF16_EXTRA_OPS = 52


def _k2_cost(b, precision="fp32"):
    """K2 and K4 over b pairs: r0 and r1 are consecutive frames of one
    (b+1)-frame expansion, so 5 planes of b+1 frames are read once, then
    flow in and M out; the warp and the assembly."""
    return 4 * (5 * (b + 1) / b + 2 + 5), 70 + (K2_BF16_EXTRA_OPS if precision == "bf16" else 0)


def _k2_rows_cost(h_loc, k):
    """K2's row-offset instance on a block of h_loc rows: r0, flow in and M
    out for its pixels, r1 over its h_loc + 2k rows; K2's operations."""
    return 4 * (5 + 5 * (h_loc + 2 * k) / h_loc + 2 + 5), 70


def _row_blocks(r0, r1, flow, n_shards, warp_halo):
    """K2 rows instance arguments for each of n_shards row blocks of the
    level (B, ·, H, W) planes, r1 extended by the path's halo band
    (parallel/spatial.py _update_matrices_sharded)."""
    from btcs_pnes_optical_flow_tpu_torch.parallel import halo

    devs = [r0.device] * n_shards
    h = r0.shape[2]
    h_loc = h // n_shards
    k = min(warp_halo, h_loc)
    blocks = zip(halo.split_rows(r0, devs), halo.exchange_rows(halo.split_rows(r1, devs), k),
                 halo.split_rows(flow, devs))
    return [(a.contiguous(), e.contiguous(), f.contiguous(), i * h_loc, h)
            for i, (a, e, f) in enumerate(blocks)], h_loc, k


def _rows_calls(args):
    """Kernel and plain calls of the rows instance over every block."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    return (lambda: tuple(fc.update_matrices_rows_cf(*a) for a in args),
            lambda: tuple(fb.update_matrices_rows_cf_plain(*a) for a in args))


def _k1_cost(n):
    """1 float in, 5 out; 9 correlations of 2n+1 taps and the 5 scalings."""
    return 4 * (1 + 5), 9 * (2 * (2 * n + 1) - 1) + 9


def _k3_cost(winsize, gaussian):
    """5 M floats in, 2 flow floats out; per plane two passes of winsize taps
    (Gaussian: a multiply per tap; box: one final scale), then the solve."""
    per_plane = 2 * (winsize - 1) + (2 * winsize if gaussian else 1)
    return 4 * (5 + 2), 5 * per_plane + 12


def _k5_cost(c):
    """C source floats and 2 flow floats in, C out; clamp, floor and the
    bilinear blend per channel."""
    return 4 * (2 * c + 2), 10 + 6 * c


# K6's float32 operations per pixel, counted from pd_chain_plain with its
# loop invariants hoisted (a square root or a division counts as one):
# per chain max + division for -1/max(|∇I|², 1e-9), its two products with
# I1wx and I1wy, l_t·|∇I|², l_t·I1wx and l_t·I1wy; per iteration rho (2
# multiplies, 2 adds), the two threshold compares, rho·wx_igs and
# rho·wy_igs, two divergences (2 differences and an add each), u and v +
# d + θ·div (2 adds and a multiply each), four forward differences, two
# gradient norms (2 multiplies, an add, a square root), their two
# reciprocal factors (a multiply, an add, a division) and the four dual
# updates (2 multiplies and an add each).
K6_OPS_PER_CHAIN = 7
K6_OPS_PER_ITERATION = 4 + 2 + 2 + 6 + 6 + 4 + 8 + 6 + 12


def _k6_cost(n_iterations):
    """6 planes in, u and v out; the operations above."""
    return 4 * (6 + 2), K6_OPS_PER_CHAIN + K6_OPS_PER_ITERATION * n_iterations


NO_LIBRARY = {
    "update_matrices": "no single PyTorch call does the warp under cv2's guard and the "
                       "normal-equation assembly",
    "update_flow": "no single PyTorch call does the window average and the 2x2 solve",
    "update_matrices_tiles": "no single PyTorch call does K2's warp and assembly over a tile list",
    "update_matrices_box": "no single PyTorch call does K2's warp and assembly over a box, in place",
    "pd_chain": "no single PyTorch call runs the primal-dual chain",
}


def _bound(pixels, bytes_per_px, ops_per_px):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the float32 operations over the float32 rate."""
    t_bytes = pixels * bytes_per_px / HBM_BYTES_PER_S * 1e3
    t_ops = pixels * ops_per_px / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _set_bound(row, pixels, bytes_per_px, ops_per_px, library_ms, why_null=None):
    """Fill a kernel row's bound (``_bound``), share and library time."""
    row["bound_ms"], row["bound_by"] = _bound(pixels, bytes_per_px, ops_per_px)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["library_ms"] = library_ms
    lib = f"{library_ms:.4f} ms" if library_ms is not None else f"null ({why_null})"
    print(f"  {row['name']}: bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({pixels} px x {bytes_per_px:g} B, {ops_per_px} ops), share "
          f"{100 * row['share_of_bound']:.1f}%; library call {lib}")


def _poly_filters(n, sigma, device):
    """The five (2n+1)×(2n+1) filters of K1's output planes: the separable
    products of g, x·g, x²·g folded with the inverse-Gram factors."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb

    g, xg, xxg, (ig11, ig03, ig33, ig55) = fb._poly_exp_tables(n, sigma)
    f = np.stack([ig11 * np.outer(xg, g), ig11 * np.outer(g, xg),
                  ig03 * np.outer(g, g) + ig33 * np.outer(xxg, g),
                  ig03 * np.outer(g, g) + ig33 * np.outer(g, xxg), ig55 * np.outer(xg, xg)])
    return torch.as_tensor(f[:, None].astype(np.float32), device=device)


def phase_kernels_main(clip, params, device, rows, box):
    """K1, K2, K4 (over the ROI box's tiles) and K3 (full frame and box
    mode) at the main path's shape: one chunk of 257 frames / 256 pairs at
    level 0."""
    import torch.nn.functional as F

    from btcs_pnes_optical_flow_tpu_torch.ops import cvx
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    h, w = clip.shape[1:]
    print(f"== 3b. K1, K2, K4 and K3 at the main path's shape: {CHUNK + 1} frames / {CHUNK} "
          f"pairs of {h}x{w}, level 0")
    frames = torch.as_tensor(clip[: CHUNK + 1], device=device)
    lv = fb._level_image(frames.float(), 0, params, h, w)[0].contiguous()
    n, sigma = params.poly_n, params.poly_sigma
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == "poly_exp")
    b8 = rows[name]
    row = _check_and_time(name, kid, SOURCE, replaces, lambda: fc.poly_exp_cf(lv, n, sigma),
                          lambda: fb.poly_exp_cf_plain(lv, n, sigma), rtol=rtol, abs_tol=None,
                          why=why, reps=MAIN_REPS)
    padded = cvx.pad_replicate(lv, n, n)[:, None].contiguous()
    filt = _poly_filters(n, sigma, device)
    lib = F.conv2d(padded, filt)
    d_lib = float((lib - fc.poly_exp_cf(lv, n, sigma)).abs().max())
    lib_ms = _median_ms(lambda: F.conv2d(padded, filt), MAIN_REPS)
    print(f"K1 library yardstick: F.conv2d of the replicate-padded frames with the 5 folded "
          f"{2 * n + 1}x{2 * n + 1} filters (cuDNN, TF32 off; the pad not timed): "
          f"{lib_ms:.4f} ms, max |conv - kernel| {d_lib:.3e} (other summation order)")
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows["poly_exp"] = row
    _set_bound(row, (CHUNK + 1) * h * w, *_k1_cost(n), lib_ms)
    del padded, lib

    poly = fc.poly_exp_cf(lv, n, sigma)
    # Level-0 M of the chunk at its own flow (the kernel path's; K1 and K2
    # are held bit-equal to their plain versions above).
    flow = fb.farneback_flow_seq(frames, params).movedim(-1, 1).contiguous()
    r0, r1 = poly[:-1], poly[1:]
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == "update_matrices")
    b8 = rows[name]
    row = _check_and_time(name, kid, SOURCE, replaces, lambda: fc.update_matrices_cf(r0, r1, flow),
                          lambda: fb.update_matrices_cf_plain(r0, r1, flow), rtol=rtol,
                          abs_tol=None, why=why, reps=MAIN_REPS,
                          old=(PREWALK, lambda: fc.update_matrices_rows_cf(r0, r1, flow, 0, h)))
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows[name] = row
    _set_bound(row, CHUNK * h * w, *_k2_cost(CHUNK), None, NO_LIBRARY[name])
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == "update_matrices_bf16")
    b8 = rows[name]
    row = _check_and_time(name, kid, SOURCE, replaces,
                          lambda: fc.update_matrices_cf(r0, r1, flow, "bf16"),
                          lambda: fb.update_matrices_cf_plain(r0, r1, flow, "bf16"), rtol=rtol,
                          abs_tol=None, why=why, reps=MAIN_REPS,
                          old=(PREWALK, lambda: fc.update_matrices_rows_cf(r0, r1, flow, 0, h,
                                                                           "bf16")))
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows[name] = row
    _set_bound(row, CHUNK * h * w, *_k2_cost(CHUNK, "bf16"), None, NO_LIBRARY["update_matrices"])
    print(f"K2 bf16 vs fp32 at the main path's shape: {row['ms']:.4f} vs "
          f"{rows['update_matrices']['ms']:.4f} ms (the same bytes)")
    m = fc.update_matrices_cf(r0, r1, flow)
    _k4_main(rows, params, poly, flow, m, h, w, device)
    _k4_main(rows, params, poly, flow, m, h, w, device, "bf16")
    del poly
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == "update_flow")
    b8 = rows[name]
    ws, gw = params.winsize, params.gaussian_win
    row = _check_and_time(name, kid, SOURCE, replaces, lambda: fc.update_flow_cf(m, ws, gw),
                          lambda: fb.update_flow_cf_plain(m, ws, gw), rtol=rtol, abs_tol=None,
                          why=why, reps=MAIN_REPS)
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows[name] = row
    _set_bound(row, CHUNK * h * w, *_k3_cost(ws, gw), None, NO_LIBRARY[name])
    kern_fn, plain_fn = _check_box_mode(m, params, box, flow)
    kern_fn(), plain_fn()
    box_ms = statistics.median([_median_ms(kern_fn, MAIN_REPS) for _ in range(2)])
    box_plain_ms = statistics.median([_median_ms(plain_fn, MAIN_REPS) for _ in range(2)])
    box_px = CHUNK * (box[1] - box[0]) * (box[3] - box[2])
    box_bound = box_px * _k3_cost(ws, gw)[0] / HBM_BYTES_PER_S * 1e3
    row.update(box_ms=box_ms, box_plain_ms=box_plain_ms, box_bound_ms=box_bound)
    print(f"K3 box mode at the main path's shape: kernel {box_ms:.4f} ms, plain "
          f"{box_plain_ms:.4f} ms, bound {box_bound:.4f} ms by bytes ({box_px} px), share "
          f"{100 * box_bound / box_ms:.1f}%")
    del m
    _rows_main(clip, params, rows, device)


def _rows_main(clip, params, rows, device):
    """K2 rows at its main path's shape: level 0 of phase 13's 480×640 case,
    16 pairs over 4 row blocks with the 16-row band."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    h, w, n_shards = SHARD_CASES[0]
    frames = torch.as_tensor(clip[: SHARD_PAIRS + 1], device=device)
    lv = fb._level_image(frames.float(), 0, params, h, w)[0].contiguous()
    poly = fc.poly_exp_cf(lv, params.poly_n, params.poly_sigma)
    flow = fb.farneback_flow(frames[:-1], frames[1:], params).movedim(-1, 1).contiguous()
    args, h_loc, k = _row_blocks(poly[:-1].contiguous(), poly[1:].contiguous(), flow, n_shards,
                                 WARP_HALO)
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == "update_matrices_rows")
    b8 = rows[name]
    row = _check_and_time(name, kid, SOURCE, replaces, *_rows_calls(args), rtol=rtol,
                          abs_tol=None, why=why + f"; {n_shards} blocks of {h_loc} rows",
                          reps=MAIN_REPS)
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows[name] = row
    _set_bound(row, SHARD_PAIRS * h * w, *_k2_rows_cost(h_loc, k), None,
               NO_LIBRARY["update_matrices"])


def _k4_main(rows, params, poly, flow, m, h, w, device, precision="fp32"):
    """K4 and K2's box mode at the main path's shape: the 256 pairs of one
    chunk over the bench ROI's level-0 box (K4: its tile list), into the
    chunk's level-0 M."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    b = m.shape[0]
    tiles0 = fb.box_tiles(fb.roi_dispatch_params(params, h, w, roi_mask(h, w)).roi_active_px[0],
                          h, w)
    sel = fb.tile_list(b, tiles0, h, w, device)
    r0, r1 = poly[:-1], poly[1:]
    mk, mp = m.clone(), m.clone()
    key = "update_matrices_tiles" + ("_bf16" if precision == "bf16" else "")
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == key)
    b8 = rows[name]
    row = _check_and_time(
        name, kid, SOURCE, replaces,
        lambda: fc.update_matrices_tiles_cf(r0, r1, flow, sel, mk, fb.TILE, precision),
        lambda: fb.update_matrices_tiles_cf_plain(r0, r1, flow, sel, mp, fb.TILE, precision),
        rtol=rtol, abs_tol=None, why=why + f"; {b} pairs, ROI box list", reps=MAIN_REPS)
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows[name] = row
    n_listed = int(fb.tile_mask(sel, b, h, w, fb.TILE).sum())
    print(f"{kid} at the main path's shape: {sel.numel()} tiles of {fb.TILE} ({n_listed} px; "
          f"the wrapper's time includes its one read-back of sel's range)")
    _set_bound(row, n_listed, *_k2_cost(b, precision), None, NO_LIBRARY["update_matrices_tiles"])
    # K2's box mode over the same box, where the level loop now runs it,
    # against K4's list form of the box (old, new, new, old).
    box = fb.tile_box(tiles0, h, w)
    key = "update_matrices_box" + ("_bf16" if precision == "bf16" else "")
    name, kid, replaces, rtol, why = next(k for k in KERNELS if k[0] == key)
    b8 = rows[name]
    kb, pb, ob = m.clone(), m.clone(), m.clone()
    row = _check_and_time(
        name, kid, SOURCE, replaces,
        lambda: fc.update_matrices_cf(r0, r1, flow, precision, box, kb),
        lambda: fb.update_matrices_cf_plain(r0, r1, flow, precision, box, pb),
        rtol=rtol, abs_tol=None, why=why + f"; {b} pairs, ROI box {box}", reps=MAIN_REPS,
        old=(K4_LIST, lambda: fc.update_matrices_tiles_cf(r0, r1, flow, sel, ob, fb.TILE,
                                                          precision)))
    row.update(b8_ms=b8["ms"], b8_plain_ms=b8["plain_ms"],
               max_abs_err=max(row["max_abs_err"], b8["max_abs_err"]))
    rows[name] = row
    _set_bound(row, n_listed, *_k2_cost(b, precision), None, NO_LIBRARY["update_matrices_box"])
    del mk, mp, kb, pb, ob


def roi_mask(h, w):
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

    return fill_poly_mask(h, w, ROI)


def _check_and_time(name, kid, source, replaces, kern_fn, plain_fn, rtol, abs_tol, why,
                    reps=REPS, old=None):
    """Hold one kernel against its plain version (raise past the bar: abs_tol
    when given, else rtol × max|plain|), then time both with CUDA events;
    returns the kernel's JSON row.  A tuple output is compared stacked.
    old = (label, fn): the kernel's earlier design on the same tensors, held
    to the plain version at the same bar and timed in turns with the kernel
    (old, new, new, old) inside the same rounds (the row's old_ms)."""

    def result(fn):
        out = fn()
        return torch.stack(out) if isinstance(out, tuple) else out

    kern = result(kern_fn)
    plain = result(plain_fn)
    torch.cuda.synchronize()
    rel, abs_err = _rel_err(kern, plain)
    if not torch.isfinite(kern).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    ok = abs_err <= abs_tol if abs_tol is not None else rel <= rtol
    bar = f"{abs_tol} px abs" if abs_tol is not None else f"{rtol} x max|plain|"
    old_ok = True
    if old is not None:
        old_rel, old_abs = _rel_err(result(old[1]), plain)
        old_ok = old_abs <= abs_tol if abs_tol is not None else old_rel <= rtol
    del kern, plain
    for _ in range(3):
        kern_fn(), plain_fn()
        if old is not None:
            old[1]()
    ms_k, ms_p, ms_o = [], [], []
    for _ in range(2):  # plain, (old,) kernel, kernel, (old,) plain
        ms_p.append(_median_ms(plain_fn, reps))
        if old is not None:
            ms_o.append(_median_ms(old[1], reps))
        ms_k.append(_median_ms(kern_fn, reps))
        ms_k.append(_median_ms(kern_fn, reps))
        if old is not None:
            ms_o.append(_median_ms(old[1], reps))
        ms_p.append(_median_ms(plain_fn, reps))
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=0, max_abs_err=abs_err,
               ms=statistics.median(ms_k), plain_ms=statistics.median(ms_p))
    print(f"{kid} {name}: max_abs_err {abs_err:.3e} rel {rel:.3e} (tol {bar}: {why}) "
          f"{'ok' if ok else 'FAIL'}; kernel {row['ms']:.4f} ms "
          f"plain {row['plain_ms']:.4f} ms (median of {reps}, 4 rounds)")
    if old is not None:
        row.update(old_ms=statistics.median(ms_o), old_design=old[0], old_max_abs_err=old_abs)
        print(f"  earlier design ({old[0]}) on the same tensors: {row['old_ms']:.4f} ms, "
              f"max_abs_err {old_abs:.3e} {'ok' if old_ok else 'FAIL'}; new/old "
              f"{row['ms'] / row['old_ms']:.3f}")
    if not ok or not old_ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return row


def phase_cascade(device, smi, rows):
    """3c: the PC1 head's band-pass cascade (sos_cascade_kernel, one
    sosfilt pass a launch) at the benchmark cells' staging shapes against
    the plain _section_scan loop on the card, torch.equal in y and zf, each
    then timed in rounds plain, kernel, kernel, plain; a 10-section cascade
    (two launches) torch.equal too.  The row's ms is the 1080p one-ROI pass."""
    from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
    from btcs_pnes_optical_flow_tpu_torch.ops import filters, filters_cuda

    name, kid, replaces, tol, why = FLT_KERNELS[0]
    pca = PCAParams()
    print(f"== 3c. {kid} {name}: one sosfilt pass of the PC1 band-pass (order {pca.bpf_order}) "
          f"against the plain loop, on the staging rows of the benchmark's cells")

    def case(sos, zi, shape):
        x = torch.as_tensor(np.random.default_rng(sum(shape)).normal(size=shape)
                            .astype(np.float32) * 3, device=device)
        z0 = torch.as_tensor(zi, device=device) * x[..., :1, None]  # _filtfilt_runs' zi·x[0]
        kernel = functools.partial(filters.sosfilt, sos, x, z0, engine="scan")
        plain = functools.partial(filters._cascade, filters._section_scan, sos, x, z0)
        filters_cuda.reset_launch_counts()
        (y, zf), (y_ref, zf_ref) = kernel(), plain()
        launches = filters_cuda.LAUNCHES["sos_cascade"]
        torch.cuda.synchronize()
        err = max(float((y - y_ref).abs().max()), float((zf - zf_ref).abs().max()))
        same = torch.equal(y, y_ref) and torch.equal(zf, zf_ref)
        return kernel, plain, launches, err, same

    row = None
    sos, zi, _ = filters.make_bandpass(pca.bpf_low_hz, pca.bpf_high_hz, pca.fs, pca.bpf_order)
    for label, shape in FLT_SHAPES:
        kernel, plain, launches, err, same = case(sos, zi, shape)
        ms_k, ms_p = [], []
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "plain":
                ms_p.append(_median_ms(plain, 1))
            else:
                ms_k.append(_median_ms(kernel, REPS))
        n_rows, n = int(np.prod(shape[:-1])), shape[-1]
        print(f"{label} {shape}: {n_rows} rows x {n} samples, {launches} launch; torch.equal to "
              f"the plain loop (y, zf) {same}, max |d| {err:.3e} (tol {tol}: {why}); kernel "
              f"{statistics.median(ms_k):.4f} ms (median of {REPS}, rounds {ms_k}), plain "
              f"{statistics.median(ms_p):.2f} ms (one pass a round, {ms_p}) on [{smi}]")
        if launches != 1 or not same:
            raise AssertionError(f"{name} at {shape}: {launches} launches, torch.equal {same}")
        if row is None:
            n_sec = sos.shape[0]
            row = dict(name=name, route="cuda", source=FLT_SOURCE, replaces=replaces, launches=0,
                       max_abs_err=err, ms=statistics.median(ms_k),
                       plain_ms=statistics.median(ms_p), rows=n_rows, samples=n, by_shape={})
            # Each sample of a row: x read and y written (8 B), the state
            # (S, 2) read and written once a row; 9 operations a section.
            print(f"  bound of the {label} pass (a sample counts as a px):")
            _set_bound(row, n_rows * n, 8 + 16 * n_sec / n, 9 * n_sec, None,
                       "no PyTorch call runs a recursive filter")
            row["bound_note"] = (f"latency: a thread walks its row's {n}x{n_sec} dependent "
                                 "section steps in order, so neither bytes nor operations "
                                 "set the time")
            print(f"  {row['bound_note']}")
        row["by_shape"][label] = dict(shape=shape, ms=statistics.median(ms_k),
                                      plain_ms=statistics.median(ms_p))
    sos, zi, _ = filters.make_bandpass(pca.bpf_low_hz, pca.bpf_high_hz, pca.fs, FLT_LONG_ORDER)
    _, _, launches, err, same = case(sos, zi, FLT_SHAPES[-1][1])
    print(f"order {FLT_LONG_ORDER} ({sos.shape[0]} sections, {filters_cuda.MAX_SECTIONS} a "
          f"launch) at {FLT_SHAPES[-1][1]}: {launches} launches, torch.equal {same}, max |d| "
          f"{err:.3e}")
    if launches != -(-sos.shape[0] // filters_cuda.MAX_SECTIONS) or not same:
        raise AssertionError(f"{name}: the {sos.shape[0]}-section cascade disagrees")
    rows[name] = row


@contextlib.contextmanager
def _cascade_launches(what):
    """Count the band-pass calls (filters.bandpass_nanrobust) and the
    cascade kernel's launches inside the block; raise unless there was a
    call and each made exactly two launches, its forward and its backward
    sosfilt pass.  Yields the list of the calls' engines."""
    from btcs_pnes_optical_flow_tpu_torch.ops import filters, filters_cuda

    calls = []
    band_pass = filters.bandpass_nanrobust

    def counted(*args, **kwargs):
        calls.append(kwargs.get("engine"))
        return band_pass(*args, **kwargs)

    filters_cuda.reset_launch_counts()
    filters.bandpass_nanrobust = counted
    try:
        yield calls
    finally:
        filters.bandpass_nanrobust = band_pass
    launches = filters_cuda.LAUNCHES["sos_cascade"]
    print(f"{what}: {len(calls)} band-pass call(s) (engines {calls}), {launches} sos_cascade "
          f"launches (expected 2 a call)")
    if not calls or launches != 2 * len(calls):
        raise AssertionError(f"{what}: {launches} cascade launches for {len(calls)} band-passes")


def phase_slice(clip, params, device, smi, rows, flow_plain):
    from bench import H, W
    from btcs_pnes_optical_flow_tpu_torch.config import PCAParams
    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq, to_device
    from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    print(f"== 4. slice: {N_PAIRS} pairs of {H}x{W}, chunks of {CHUNK}, then PC1")
    # The kernel path against the plain path on the card (first 8 pairs).
    head = torch.as_tensor(clip[: CHECK_PAIRS + 1], device=device)
    flow_kern = fb.farneback_flow_seq(head, params)
    d = float((flow_kern - flow_plain).abs().max())
    print(f"kernel vs plain path on the card, {CHECK_PAIRS} pairs: max |dflow| {d:.3e} px "
          f"(bar {FLOW_TOL_PX})")
    if not d <= FLOW_TOL_PX:
        raise AssertionError("kernel path disagrees with the plain path")
    # ... and against the plain path on the CPU at a small size.
    small = np.ascontiguousarray(clip[:3, ::5, ::5])
    f_cpu = fb.farneback_flow_seq(torch.as_tensor(small), params)
    f_gpu = fb.farneback_flow_seq(torch.as_tensor(small, device=device), params).cpu()
    d_small = float((f_cpu - f_gpu).abs().max())
    print(f"kernel path on the card vs plain path on the CPU, 2 pairs {small.shape[1:]}: "
          f"max |dflow| {d_small:.3e} px (bar {FLOW_TOL_PX})")
    if not d_small <= FLOW_TOL_PX:
        raise AssertionError("card disagrees with the CPU")

    ex = np.tile(np.array([np.cos(THETA), -np.sin(THETA)], np.float32), (CHUNK, 1))
    ey = np.tile(np.array([np.sin(THETA), np.cos(THETA)], np.float32), (CHUNK, 1))
    mask = roi_mask(H, W)[None]
    frames, exd, eyd, masks = to_device(clip, ex, ey, mask, device)
    chunks = [frames[s : s + CHUNK + 1] for s in range(0, N_PAIRS, CHUNK)]
    roi_body_flow_seq(chunks[0][: CHECK_PAIRS + 1], exd[:CHECK_PAIRS], eyd[:CHECK_PAIRS],
                      masks, params)  # warm-up (allocator, einsum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fc.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [roi_body_flow_seq(c, exd, eyd, masks, params) for c in chunks]
    vx_h = torch.cat([f.vx[:, 0] for f, _ in outs]).cpu()
    vy_h = torch.cat([f.vy[:, 0] for f, _ in outs]).cpu()
    mg_h = torch.cat([f.mag[:, 0] for f, _ in outs]).cpu()
    clips = torch.cat([c for _, c in outs]).cpu()
    flow_time = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)

    n_chunks = len(chunks)
    n_lev = params.num_levels(H, W) + 1
    n_it = sum(params.iters_at(k) for k in range(n_lev))
    want = dict(dict.fromkeys(fc.LAUNCHES, 0), poly_exp=n_lev * n_chunks,
                update_matrices=n_it * n_chunks, update_flow=n_it * n_chunks)
    print(f"launches over {n_chunks} chunks: {launches} (expected {want}: "
          f"{n_lev}/{n_it}/{n_it} per chunk)")
    if launches != want:
        raise AssertionError("launch counts differ from the main path's schedule")
    for name in ("poly_exp", "update_matrices", "update_flow"):
        rows[name]["launches"] = launches[name]
    if vx_h.shape != (N_PAIRS,) or clips.shape != (N_PAIRS,):
        raise AssertionError(f"feature shapes {tuple(vx_h.shape)}, clips {tuple(clips.shape)}")
    if int(clips.abs().sum()) != 0:
        raise AssertionError("non-zero clip counts")
    for nm, v in (("vx", vx_h), ("vy", vy_h), ("mag", mg_h)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {nm} features")
    print(f"features finite; |vx| max {float(vx_h.abs().max()):.4f} "
          f"|vy| max {float(vy_h.abs().max()):.4f} px/frame; clips all zero")

    pca = PCAParams()
    nan = torch.tensor([float("nan")])
    vx = torch.cat([nan, vx_h]).to(device)
    vy = torch.cat([nan, vy_h]).to(device)
    pc1_from_flow(vx, vy, pca)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pc1 = pc1_from_flow(vx, vy, pca).cpu()
    pca_time = time.perf_counter() - t0
    expect_nan = torch.zeros(N_PAIRS + 1, dtype=torch.bool)
    expect_nan[0] = True
    if not torch.equal(torch.isnan(pc1), expect_nan):
        raise AssertionError("PC1 is NaN outside index 0, or finite at index 0")
    pc1_cpu = pc1_from_flow(vx.cpu(), vy.cpu(), pca)
    corr = float(np.corrcoef(pc1[1:].numpy(), pc1_cpu[1:].numpy())[0, 1])
    dmax = float((pc1[1:] - pc1_cpu[1:]).abs().max())
    print(f"PC1 {tuple(pc1.shape)} finite past index 0; card vs CPU corr {corr:.9f} max |d| {dmax:.3e}")
    if not corr >= 0.9999:
        raise AssertionError("PC1 on the card disagrees with the CPU")

    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"flow {flow_time:.4f} s ({N_PAIRS / flow_time:.2f} pairs/s), "
          f"PC1 {pca_time:.4f} s, flow+PCA {N_PAIRS / (flow_time + pca_time):.2f} ROI-frames/s, "
          f"peak {peak:.2f} GiB on [{smi}]")
    return chunks[0], exd, eyd, masks, (vx_h, vy_h, mg_h)


def _launch_schedule(params, h, w, n_chunks):
    """Launches per kernel that run_flow_stage makes over n_chunks chunks,
    derived from the ROI boxes: K2 in the instance of params.warp_precision
    at every level, counted again as a box launch on a boxed level; no K4."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    want = dict.fromkeys(fc.LAUNCHES, 0)
    suffix = "_bf16" if params.warp_precision == "bf16" else ""
    for k in range(params.num_levels(h, w) + 1):
        boxed = fb.box_tiles(params.roi_active_px[k], *params.level_size(h, w, k)) is not None
        it = params.iters_at(k)
        want["poly_exp"] += n_chunks
        want["update_matrices" + suffix] += it * n_chunks
        if boxed:
            want["update_matrices_box" + suffix] += it * n_chunks
        want["update_flow"] += it * n_chunks
    return want


def phase_pipeline(clip, device, smi, rows, full_feats):
    from bench import H, W
    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import (
        run_full, run_metrics_stage, run_pc1_stage)
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.ops import filters_cuda
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    n = clip.shape[0]
    cfg = PipelineConfig()
    print(f"== 8. pipeline: run_full on {n} frames of {H}x{W}, chunks of {CHUNK} pairs, "
          f"PipelineConfig(), the bench ROI")
    t = np.arange(n) / 30.0
    skel = Skeleton(time_all=t, fps=30.0,
                    ex=np.tile([np.cos(THETA), -np.sin(THETA)], (n, 1)),
                    ey=np.tile([np.sin(THETA), np.cos(THETA)], (n, 1)))
    flow_p = fb.roi_dispatch_params(cfg.flow, H, W, roi_mask(H, W))
    for k, box in enumerate(flow_p.roi_active_px):
        hk, wk = flow_p.level_size(H, W, k)
        print(f"level {k} ({hk}x{wk}): ROI box {box} -> tiles {fb.box_tiles(box, hk, wk)}")
    n_chunks = -(-(n - 1) // CHUNK)
    want = _launch_schedule(flow_p, H, W, n_chunks)
    # Warm-up on one chunk (allocator, cached tables), then the measured run.
    run_full(ArraySource(clip[: CHUNK + 1], fps=30.0), skel, [ROI], cfg, CHUNK, device=device)
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    timer = StageTimer(device)
    t0 = time.perf_counter()
    with _cascade_launches("run_full's PC1 head"):
        flow, pc1, mets = run_full(ArraySource(clip, fps=30.0), skel, [ROI], cfg, CHUNK,
                                   device=device, timer=timer)
    e2e = time.perf_counter() - t0
    rows["sos_cascade"]["launches"] = filters_cuda.LAUNCHES["sos_cascade"]
    launches = dict(fc.LAUNCHES)
    print(f"launches over {n_chunks} chunks: {launches} (expected from the boxes {want})")
    if launches != want or not launches["update_matrices_box"]:
        raise AssertionError("pipeline launches differ from the ROI-box schedule")
    rows["update_matrices_box"]["launches"] = launches["update_matrices_box"]
    rows["update_matrices_tiles"]["launches"] = launches["update_matrices_tiles"]  # 0: off the path

    if flow.vx.shape != (n, 1) or not np.isnan(flow.vx[0, 0]):
        raise AssertionError(f"flow features {flow.vx.shape}, row 0 {flow.vx[0]}")
    d_feat = max(float(np.abs(getattr(flow, nm)[1:, 0] - ref.numpy()).max())
                 for nm, ref in zip(("vx", "vy", "mag"), full_feats))
    print(f"ROI features vs phase 4's full-frame features, {n - 1} pairs: max |d| "
          f"{d_feat:.3e} px/frame (bar {FEATURE_TOL}); clips zero (run_flow_stage raises "
          f"otherwise)")
    if not d_feat <= FEATURE_TOL:
        raise AssertionError("ROI-dispatched features differ from the full-frame ones")

    pc1_cpu = run_pc1_stage(flow, cfg, device="cpu")
    fin = np.isfinite(pc1_cpu[:, 0])
    if not np.array_equal(np.isfinite(pc1[:, 0]), fin) or fin.sum() < n - 1:
        raise AssertionError("PC1's finite samples differ between the card and the CPU")
    corr = float(np.corrcoef(pc1[fin, 0], pc1_cpu[fin, 0])[0, 1])
    print(f"PC1 {pc1.shape}: card vs CPU corr {corr:.9f}, max |d| "
          f"{float(np.abs(pc1[fin, 0] - pc1_cpu[fin, 0]).max()):.3e}")
    if not corr >= 0.9999:
        raise AssertionError("PC1 on the card disagrees with the CPU")

    m_gpu = mets[0]
    m_cpu = run_metrics_stage(flow.t_sec, pc1, cfg, device="cpu")[0]
    print("metrics, card | CPU on the card's PC1: " + ", ".join(
        f"{f} {float(getattr(m_gpu, f)):.6g} | {float(getattr(m_cpu, f)):.6g}"
        for f in m_gpu._fields))
    for f in ("peak_n", "status"):
        if int(getattr(m_gpu, f)) != int(getattr(m_cpu, f)):
            raise AssertionError(f"metric {f} differs between the card and the CPU")
    if int(m_gpu.status) != 0:
        raise AssertionError(f"metric status {int(m_gpu.status)}")
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        a, b = float(getattr(m_gpu, f)), float(getattr(m_cpu, f))
        if not (np.isnan(a) and np.isnan(b)) and not abs(a - b) <= METRIC_RTOL * abs(b):
            raise AssertionError(f"metric {f}: card {a} vs CPU {b} (rtol {METRIC_RTOL})")

    st = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"stage seconds {st} ({timer.report()}); end to end {e2e:.4f} s from decode, "
          f"{n / e2e:.2f} ROI-frames/s on [{smi}]")
    return flow_p, pc1


def _skeleton(n):
    """Body axes at θ = 0.3 for n frames at 30 fps (bench.py:107-109)."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.contracts import Skeleton

    return Skeleton(time_all=np.arange(n) / 30.0, fps=30.0,
                    ex=np.tile([np.cos(THETA), -np.sin(THETA)], (n, 1)),
                    ey=np.tile([np.sin(THETA), np.cos(THETA)], (n, 1)))


def _rows_equal(a, b, what):
    """Cohort rows equal within tests/test_parallel.py's rtol 1e-6 (exact
    equality expected); returns the largest relative difference."""
    worst = 0.0
    if [list(r) for r in a] != [list(r) for r in b]:
        raise AssertionError(f"{what}: the rows' keys differ")
    for ra, rb in zip(a, b):
        for k, va in ra.items():
            vb = rb[k]
            if isinstance(va, float):
                if np.isnan(va) and np.isnan(vb):
                    continue
                d = abs(va - vb) / max(abs(va), 1e-300)
                worst = max(worst, d)
                if not abs(va - vb) <= 1e-6 * abs(va) + 1e-9:
                    raise AssertionError(f"{what}: {ra['video']} {k} {va} vs {vb}")
            elif va != vb:
                raise AssertionError(f"{what}: {ra['video']} {k} {va!r} vs {vb!r}")
    return worst


def phase_cohort(device, smi, rows):
    """run_cohort at the JAX bench's cohort size (bench.py:401-496): the
    batched path on host clips and on clips on the card, and the per-video
    path, each once after a warm-up; launches of the first batched run
    against the full-frame schedule; one video's row against run_full."""
    from bench import H, W, render_clip
    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models import metrics as metrics_model
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh, make_mesh
    from btcs_pnes_optical_flow_tpu_torch.parallel.runner import CohortItem, run_cohort
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    n_v, n_f, chunk = COHORT_VIDEOS, COHORT_FRAMES, COHORT_CHUNK
    total = n_v * n_f
    print(f"== 9. cohort: run_cohort on {n_v} clips of {n_f} frames at {H}x{W} "
          f"(render_clip(seed=10 + v)), the bench ROI, PipelineConfig(), chunks of {chunk} pairs")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        clips = list(pool.map(lambda v: render_clip(n_f, seed=10 + v), range(n_v)))
    print(f"clips rendered in {time.perf_counter() - t0:.1f} s ({sum(c.nbytes for c in clips) / 1e9:.2f} GB)")
    skel = _skeleton(n_f)
    cfg = PipelineConfig()
    mesh = make_mesh()  # every card present
    print(f"mesh of every card present: {mesh}")

    def items(videos):
        return [CohortItem(f"v{v}", video, skel, [ROI]) for v, video in enumerate(videos)]

    def run(label, videos, **kw):
        timer = StageTimer(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_cohort(items(videos), cfg, chunk, device=device, timer=timer, **kw)
        wall = time.perf_counter() - t0
        bad = [r for r in out if r["status"] != 0 or r["error"]]
        if len(out) != n_v or bad:
            raise AssertionError(f"cohort {label}: {len(out)} rows, failed rows {bad[:2]}")
        st = {k: round(v, 4) for k, v in timer.times.items()}
        print(f"cohort {label}: {wall:.4f} s, {total / wall:.2f} frames/s ({total} frames); stage "
              f"seconds {st} on [{smi}]")
        return out, wall

    run_cohort(items(clips[:2]), cfg, chunk, mesh=mesh, device=device)  # warm-up
    fc.reset_launch_counts()
    # Stage C's input (one length group of 32 PC1 rows) is kept for phase 14.
    head_in = []
    batch_head = metrics_model.pc1_metrics_batch
    metrics_model.pc1_metrics_batch = lambda t, p, *a, **kw: (
        head_in.append((t, p)) or batch_head(t, p, *a, **kw))
    try:
        with _cascade_launches("run_cohort's PC1 head, one length group"):
            batched, _ = run("batched, host clips", clips, mesh=mesh)
    finally:
        metrics_model.pc1_metrics_batch = batch_head
    launches = dict(fc.LAUNCHES)
    n_lev = cfg.flow.num_levels(H, W) + 1
    n_it = sum(cfg.flow.iters_at(k) for k in range(n_lev))
    n_chunks = n_v * -(-(n_f - 1) // chunk)
    want = dict(dict.fromkeys(fc.LAUNCHES, 0), poly_exp=n_lev * n_chunks,
                update_matrices=n_it * n_chunks, update_flow=n_it * n_chunks)
    print(f"launches of the batched run over {n_chunks} chunks: {launches} (expected the "
          f"full-frame schedule {want}: {n_lev}/{n_it}/{n_it} per chunk)")
    if launches != want:
        raise AssertionError("cohort launches differ from the full-frame schedule")
    for name in ("poly_exp", "update_matrices", "update_flow"):
        rows[name]["cohort_launches"] = launches[name]

    t0 = time.perf_counter()
    on_card = [torch.as_tensor(c, device=device) for c in clips]
    torch.cuda.synchronize()
    print(f"clips copied to the card in {time.perf_counter() - t0:.3f} s (not timed below)")
    resident, _ = run("batched, clips on the card", on_card, mesh=mesh)
    del on_card
    per_video, _ = run("per video, ROI-dispatched, 2 flow workers", clips, flow_workers=2)
    d1 = _rows_equal(batched, resident, "host vs card clips")
    d2 = _rows_equal(batched, per_video, "batched vs per video")
    runs = "three"
    if torch.cuda.device_count() == 1:
        # One card: the multi-device path over an explicit 4-shard layout.
        layout = Mesh([device] * 4)
        shards, _ = run(f"sharded over the 4-shard layout {layout}", clips, mesh=layout)
        d2 = max(d2, _rows_equal(batched, shards, "one device vs 4 shards"))
        if repr(shards) != repr(batched):
            raise AssertionError("the 4-shard rows are not the one-device rows")
        runs = "four"
    print(f"rows equal across the {runs} runs (largest relative difference {max(d1, d2):.3e}, "
          f"bar 1e-6); every row status 0, error empty")

    flow, pc1, mets = run_full(ArraySource(clips[0], fps=30.0), skel, [ROI], cfg, chunk,
                               device=device)
    single = {"PC1_area_0_10": mets[0].pc1_area, "ADS_slope_0_10": mets[0].ads_slope,
              "ADS_R2_0_10": mets[0].ads_r2, "Kendall_tau_0_10": mets[0].kendall_tau,
              "Kendall_p_0_10": mets[0].kendall_p, "Peak_n": mets[0].peak_n,
              "status": mets[0].status}
    want_row = dict(batched[0], **{k: (int(v) if k in ("Peak_n", "status") else float(v))
                                   for k, v in single.items()})
    _rows_equal([batched[0]], [want_row], "cohort row v0 vs run_full")
    print(f"row v0 equals run_full on v0 with {chunk}-pair chunks: "
          + ", ".join(f"{k} {batched[0][k]:.6g}" for k in single))
    if len(head_in) != 1 or len(head_in[0][0]) != n_v:
        raise AssertionError(f"stage C ran {len(head_in)} batched calls, expected one of {n_v} rows")
    return head_in[0]


def phase_compat(clip, device, smi):
    """The three reference-compatible CLIs on the card over the bench clip
    written as .npy, with its skeleton as .npz."""
    from bench import H, W
    from btcs_pnes_optical_flow_tpu_torch.compat import optical_flow, optical_PC1, optical_PCA
    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.dataio import contracts
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

    n = clip.shape[0]
    print(f"== 10. compat: optical_flow -> optical_PCA -> optical_PC1 on {n} frames of {H}x{W} "
          f"(.npy + skeleton .npz), the CLI's default ROI")
    import tempfile

    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = {k: os.path.join(tmp, k) for k in (
            "clip.npy", "skeleton_pc1.npz", "flow.csv", "ref_flow.csv", "flow_pc1.csv",
            "cpu_flow_pc1.csv", "summary.csv")}
        np.save(path["clip.npy"], clip)
        skel = _skeleton(n)
        contracts.save_skeleton_npz(path["skeleton_pc1.npz"], skel)
        roi = optical_flow.DEFAULT_ROI
        flow_p = fb.roi_dispatch_params(PipelineConfig().flow, H, W, fill_poly_mask(H, W, roi))
        want = _launch_schedule(flow_p, H, W, -(-(n - 1) // 64))
        fc.reset_launch_counts()
        secs = {}
        t0 = time.perf_counter()
        optical_flow.main([path["clip.npy"], path["skeleton_pc1.npz"], path["flow.csv"]],
                          device=device)
        secs["optical_flow"] = time.perf_counter() - t0
        launches = dict(fc.LAUNCHES)
        print(f"launches of optical_flow.main: {launches} (expected from its ROI boxes {want})")
        if launches != want:
            raise AssertionError("the flow CLI's launches differ from its ROI-box schedule")
        run_flow_stage(path["clip.npy"], skel, [roi], PipelineConfig(), chunk_pairs=64,
                       out_csv=path["ref_flow.csv"], device=device)
        same = (pathlib.Path(path["flow.csv"]).read_bytes()
                == pathlib.Path(path["ref_flow.csv"]).read_bytes())
        print(f"flow.csv byte-equal to run_flow_stage(chunk_pairs=64)'s: {same}")
        if not same:
            raise AssertionError("flow.csv differs from run_flow_stage's")
        t0 = time.perf_counter()
        optical_PCA.main([path["flow.csv"], path["flow_pc1.csv"]], device=device)
        secs["optical_PCA"] = time.perf_counter() - t0
        optical_PCA.main([path["flow.csv"], path["cpu_flow_pc1.csv"]], device="cpu")
        a = contracts.read_pc1_csv(path["flow_pc1.csv"])["pc1_dyn"]
        b = contracts.read_pc1_csv(path["cpu_flow_pc1.csv"])["pc1_dyn"]
        fin = np.isfinite(b)
        corr = float(np.corrcoef(a[fin], b[fin])[0, 1])
        print(f"flow_pc1.csv card vs CPU: NaN pattern equal {np.array_equal(np.isnan(a), ~fin)}, "
              f"corr {corr:.9f} (bar 0.9999), {int(fin.sum())} finite of {len(b)}")
        if not (np.array_equal(np.isnan(a), ~fin) and corr >= 0.9999):
            raise AssertionError("flow_pc1.csv on the card disagrees with the CPU")
        t0 = time.perf_counter()
        optical_PC1.main([path["flow_pc1.csv"], path["summary.csv"]], device=device)
        secs["optical_PC1"] = time.perf_counter() - t0
        with open(path["summary.csv"], newline="") as f:
            summary = list(csv.reader(f))
    print(f"summary: {summary}")
    if summary[0] != contracts.SUMMARY_COLUMNS or len(summary) != 2:
        raise AssertionError("the summary is not one row of SUMMARY_COLUMNS")
    print(f"CLI seconds {({k: round(v, 4) for k, v in secs.items()})} on [{smi}]")


def _long_signal(n, rng):
    """tests/test_streaming.py's _long_signal: a 3 Hz chirp on a slowly
    turning axis with noise, NaN at 0 and over [900, 950)."""
    t = np.arange(n) / 30.0
    phase = 2 * np.pi * (3.0 * t - 0.01 * t * t)
    amp = 2.5 * (1 + 0.3 * np.sin(2 * np.pi * 0.05 * t))
    theta = 0.4 + 0.2 * np.sin(2 * np.pi * 0.02 * t)
    vx = amp * np.sin(phase) * np.cos(theta) + 0.1 * rng.normal(size=n)
    vy = amp * np.sin(phase) * np.sin(theta) + 0.1 * rng.normal(size=n)
    vx[0] = vy[0] = np.nan
    vx[900:950] = np.nan
    vy[900:950] = np.nan
    return vx, vy


def phase_pc1_engines(device, smi, full_feats):
    """pc1_from_flow with the sequential and the associative band-pass on
    phase 4's 513-sample input, then pc1_streaming (assoc) on 10 minutes at
    30 fps against the full signal."""
    from btcs_pnes_optical_flow_tpu_torch.models.pc1 import pc1_from_flow
    from btcs_pnes_optical_flow_tpu_torch.models.streaming import pc1_streaming

    print("== 11. PC1 engines on phase 4's features, then streaming")
    nan = torch.tensor([float("nan")])
    vx = torch.cat([nan, full_feats[0]]).to(device)
    vy = torch.cat([nan, full_feats[1]]).to(device)
    out, secs = {}, {}
    for engine in ("scan", "assoc"):
        with (_cascade_launches("pc1_from_flow (scan)") if engine == "scan"
              else contextlib.nullcontext()):
            pc1_from_flow(vx, vy, engine=engine)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[engine] = pc1_from_flow(vx, vy, engine=engine).cpu().numpy()
            times.append(time.perf_counter() - t0)
        secs[engine] = statistics.median(times)
    fin = np.isfinite(out["scan"])
    corr = float(np.corrcoef(out["scan"][fin], out["assoc"][fin])[0, 1])
    print(f"pc1_from_flow on {vx.numel()} samples: scan {secs['scan']:.4f} s, assoc "
          f"{secs['assoc']:.4f} s (median of 3, with the host copy); NaN pattern equal "
          f"{np.array_equal(np.isnan(out['assoc']), ~fin)}, corr {corr:.9f} (bar 0.999), max |d| "
          f"{float(np.abs(out['scan'][fin] - out['assoc'][fin]).max()):.3e} on [{smi}]")
    if not (np.array_equal(np.isnan(out["assoc"]), ~fin) and corr >= 0.999):
        raise AssertionError("the assoc engine disagrees with the scan engine")

    n = STREAM_SAMPLES
    sx, sy = _long_signal(n, np.random.default_rng(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = pc1_from_flow(torch.as_tensor(sx, dtype=torch.float32, device=device),
                         torch.as_tensor(sy, dtype=torch.float32, device=device),
                         engine="assoc").cpu().numpy()
    full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked = pc1_streaming(sx, sy, engine="assoc", device=device)
    stream_s = time.perf_counter() - t0
    fin = np.isfinite(full)
    same_nan = np.array_equal(np.isnan(chunked), ~fin)
    corr = float(np.corrcoef(chunked[fin], full[fin])[0, 1])
    print(f"pc1_streaming (assoc, chunks of 4096, margin 240) on {n} samples: {stream_s:.4f} s; "
          f"full-signal pc1_from_flow (assoc) {full_s:.4f} s; NaN pattern equal {same_nan}, corr "
          f"{corr:.9f} (bar > 0.9999), max |d| {float(np.abs(chunked[fin] - full[fin]).max()):.3e}")
    if not (same_nan and corr > 0.9999):
        raise AssertionError("streaming PC1 disagrees with the full signal")


def phase_bench_config(clip, device, smi, rows, pc1_fp32):
    """run_full on the bench clip under the JAX bench's flow config (the bf16
    warp, schedule (3, 3, 2, 1)): launches against its ROI-box schedule, the
    flow's EPE in the ROI against the fp32 flow of phase 4's config (and of
    the same schedule), PC1 against phase 8's, ROI-frames/s."""
    from bench import H, W
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import ArraySource
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    n = clip.shape[0]
    cfg = PipelineConfig(flow=dataclasses.replace(FarnebackParams(), **BENCH_FLOW))
    print(f"== 12. the JAX bench's flow config: run_full on {n} frames of {H}x{W}, chunks of "
          f"{CHUNK} pairs, {BENCH_FLOW}")
    mask = roi_mask(H, W)
    flow_p = fb.roi_dispatch_params(cfg.flow, H, W, mask)
    want = _launch_schedule(flow_p, H, W, -(-(n - 1) // CHUNK))
    skel = _skeleton(n)
    run_full(ArraySource(clip[: CHUNK + 1], fps=30.0), skel, [ROI], cfg, CHUNK, device=device)
    torch.cuda.synchronize()
    fc.reset_launch_counts()
    timer = StageTimer(device)
    t0 = time.perf_counter()
    with _cascade_launches("run_full's PC1 head, the bench config"):
        flow, pc1, mets = run_full(ArraySource(clip, fps=30.0), skel, [ROI], cfg, CHUNK,
                                   device=device, timer=timer)
    e2e = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    print(f"launches: {launches} (expected from the boxes {want})")
    if (launches != want or not launches["update_matrices_bf16"]
            or not launches["update_matrices_box_bf16"]):
        raise AssertionError("the bench config's launches differ from its ROI-box schedule")
    for name in ("update_matrices_bf16", "update_matrices_box_bf16", "update_matrices_tiles_bf16"):
        rows[name]["launches"] = launches[name]

    fin = np.isfinite(pc1_fp32[:, 0]) & np.isfinite(pc1[:, 0])
    corr = float(np.corrcoef(pc1[fin, 0], pc1_fp32[fin, 0])[0, 1])
    print(f"PC1 vs phase 8's (PipelineConfig(), fp32): corr {corr:.9f} over {int(fin.sum())} "
          f"samples (bar {PC1_CORR})")
    if not corr >= PC1_CORR or fin.sum() < n - 1:
        raise AssertionError("the bench config's PC1 disagrees with phase 8's")

    # Dense flow of phase 4's pairs in the ROI: the bench config against the
    # fp32 flow of phase 4's config, and of the bench config in fp32.
    inside = torch.as_tensor(mask, device=device)
    fp32_same = dataclasses.replace(flow_p, warp_precision="fp32")
    epe = {"phase 4's fp32 flow": [], "fp32, same schedule": []}
    for s in range(0, n - 1, CHUNK):
        frames = torch.as_tensor(clip[s : s + CHUNK + 1], device=device)
        got = fb.farneback_flow_seq(frames, flow_p)
        for key, ref_p in (("phase 4's fp32 flow", FarnebackParams()),
                           ("fp32, same schedule", fp32_same)):
            e = (got - fb.farneback_flow_seq(frames, ref_p)).norm(dim=-1)[:, inside]
            epe[key].append(e.flatten().cpu())
    for key, parts in epe.items():
        e = torch.cat(parts).numpy()
        mean = float(e.mean(dtype=np.float64))
        print(f"flow EPE in the ROI vs {key}, {n - 1} pairs: mean {mean:.5f} px, p99 "
              f"{float(np.percentile(e, 99)):.5f}, max {float(e.max()):.5f} (bar: mean < "
              f"{BENCH_EPE_PX})")
        if not mean < BENCH_EPE_PX:
            raise AssertionError(f"the bench config's flow EPE vs {key} is past the bar")
    st = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"stage seconds {st}; end to end {e2e:.4f} s from decode, {n / e2e:.2f} ROI-frames/s "
          f"on [{smi}]; metric status {int(mets[0].status)}")


def phase_sharded(clip, device, smi, rows):
    """farneback_flow_sharded on 16 pairs at 480×640 over 4 shards and at
    1080×1920 over 3, on the cards present or, with fewer, an explicit
    layout on cuda:0: launches of the 480×640 run, max |Δ| against the
    unsharded flow, times."""
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.parallel.mesh import Mesh
    from btcs_pnes_optical_flow_tpu_torch.parallel.spatial import farneback_flow_sharded

    p = FarnebackParams()
    cards = torch.cuda.device_count()
    print(f"== 13. height-sharded flow: {SHARD_PAIRS} pairs, warp_halo {WARP_HALO}, {p}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for h, w, n_shards in SHARD_CASES:
        frames = clip[: SHARD_PAIRS + 1] if (h, w) == clip.shape[1:] else render_clip(
            SHARD_PAIRS + 1, h, w, seed=5)
        if cards >= n_shards:
            devs, layout = [torch.device("cuda", i) for i in range(n_shards)], "cards"
        else:
            devs, layout = [device] * n_shards, f"explicit {n_shards}-fold cuda:0 layout"
        mesh = Mesh(devs, ("spatial",))
        prev = torch.as_tensor(frames[:-1], device=device)
        curr = torch.as_tensor(frames[1:], device=device)
        farneback_flow_sharded(prev, curr, p, mesh)  # warm-up
        fc.reset_launch_counts()
        out, t_sh = timed(lambda: farneback_flow_sharded(prev, curr, p, mesh))
        launches = dict(fc.LAUNCHES)
        whole, t_whole = timed(lambda: fb.farneback_flow(prev, curr, p))
        d = float((out - whole).abs().max())
        n_lev = p.num_levels(h, w) + 1
        n_it = sum(p.iters_at(k) for k in range(n_lev))
        want = dict(dict.fromkeys(fc.LAUNCHES, 0), poly_exp=2 * n_shards * n_lev,
                    update_matrices_rows=n_shards * n_it, update_flow=n_shards * n_it)
        print(f"{h}x{w} over {n_shards} shards ({layout}: {list(mesh)}): launches {launches} "
              f"(expected {want}); max |d| vs the unsharded flow {d:.3e} px (bar {SHARD_TOL_PX}); "
              f"sharded {t_sh:.4f} s, unsharded {t_whole:.4f} s (synchronised) on [{smi}]")
        if launches != want:
            raise AssertionError("the sharded flow's launches differ from its schedule")
        if not (d <= SHARD_TOL_PX and torch.isfinite(out).all()):
            raise AssertionError("the sharded flow disagrees with the unsharded flow")
        if (h, w) == SHARD_CASES[0][:2]:
            rows["update_matrices_rows"]["launches"] = launches["update_matrices_rows"]
        del out, whole, prev, curr


def _head_rows(seed=0):
    """HEAD_ROWS PC1-like rows of HEAD_SEC seconds, the first half at 30 fps
    and the rest at 25 fps (NaN-padded to the 30-fps length): decaying,
    slowing oscillations with noise, a NaN gap in every fourth row."""
    rng = np.random.default_rng(seed)
    n = HEAD_SEC * 30
    t_all = np.full((HEAD_ROWS, n), np.nan)
    p_all = np.full((HEAD_ROWS, n), np.nan)
    for i in range(HEAD_ROWS):
        fs = 30.0 if i < HEAD_ROWS // 2 else 25.0
        m = int(HEAD_SEC * fs)
        t = np.arange(m) / fs
        f0, decay, chirp = rng.uniform(2.0, 4.0), rng.uniform(0.05, 0.3), rng.uniform(0.0, 0.1)
        x = (np.exp(-decay * t) * np.sin(2 * np.pi * (f0 * t - 0.5 * chirp * t * t))
             + 0.05 * rng.normal(size=m))
        if i % 4 == 3:
            x[60:75] = np.nan
        t_all[i, :m] = t
        p_all[i, :m] = x
    return t_all, p_all


def _head_agree(a, b, what):
    """Status and Peak_n equal, the float fields within HEAD_RTOL (NaN
    where the other is NaN); returns the largest relative difference."""
    if not (np.array_equal(a.status, b.status) and np.array_equal(a.peak_n, b.peak_n)):
        raise AssertionError(f"{what}: status or Peak_n differ")
    worst = 0.0
    for f in ("pc1_area", "ads_slope", "ads_r2", "kendall_tau", "kendall_p"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            raise AssertionError(f"{what}: {f} NaN in one and not the other")
        fin = np.isfinite(y)
        d = np.abs(x[fin] - y[fin])
        if np.any(d > HEAD_RTOL * np.abs(y[fin])):
            raise AssertionError(f"{what}: {f} differs by more than rtol {HEAD_RTOL}")
        worst = max([worst, *(d / np.maximum(np.abs(y[fin]), 1e-300))])
    return worst


def phase_metric_head(device, smi, cohort_t, cohort_pc1):
    """pc1_metrics_batch against K calls of pc1_metrics on the card, over
    phase 9's stage C input and over HEAD_ROWS synthetic 60-s rows (two
    window shapes, several row blocks): equal, then timed in turns."""
    from btcs_pnes_optical_flow_tpu_torch.config import MetricParams
    from btcs_pnes_optical_flow_tpu_torch.models import metrics as mm

    print("== 14. metric head, batched vs row loop")
    params = MetricParams()
    for label, (t_all, p_all) in (("phase 9's stage C input", (cohort_t, cohort_pc1)),
                                  (f"{HEAD_ROWS} synthetic rows of {HEAD_SEC} s at 30/25 fps",
                                   _head_rows())):
        k, n = t_all.shape

        def batch():
            return mm.pc1_metrics_batch(t_all, p_all, params, device=device)

        def loop():
            rows = [mm.pc1_metrics(t, p, params, device=device) for t, p in zip(t_all, p_all)]
            return mm.PC1Metrics(*(np.array([float(getattr(r, f)) for r in rows])
                                   for f in mm.PC1Metrics._fields))

        blocks = []
        core = mm._pc1_metrics_core_batch
        mm._pc1_metrics_core_batch = lambda t, *a: blocks.append((t.shape[0], a[1:3])) or core(t, *a)
        try:
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            got = batch()
            peak = torch.cuda.max_memory_allocated(device) - base
        finally:
            mm._pc1_metrics_core_batch = core
        worst = _head_agree(got, loop(), f"{label}: batched vs row loop")
        secs = {"batched": [], "row loop": []}
        for _ in range(HEAD_ROUNDS):
            for name, fn in (("batched", batch), ("row loop", loop), ("row loop", loop),
                             ("batched", batch)):
                t0 = time.perf_counter()
                fn()
                secs[name].append(time.perf_counter() - t0)
        med = {name: statistics.median(v) for name, v in secs.items()}
        per_block = max(1, mm.BLOCK_ELEMS // ((n - 1) * n))
        print(f"{label}: {k} rows × N = {n}, status counts "
              f"{ {int(v): int(c) for v, c in zip(*np.unique(got.status, return_counts=True))} }, "
              f"{len(blocks)} blocks of at most {per_block} rows (rows, (k_smooth, p95_win_n)): "
              f"{blocks}; device memory above the inputs {peak / 2**20:.1f} MiB")
        print(f"{label}: batched equals the row loop (status, Peak_n exact; largest relative "
              f"difference {worst:.3e}, bar {HEAD_RTOL}); median s over {2 * HEAD_ROUNDS} runs "
              f"each, in turns: batched {med['batched']:.4f}, row loop {med['row loop']:.4f} "
              f"({med['row loop'] / med['batched']:.1f}×) on [{smi}]")


def phase_profile(title, run, host_top=0, gaps=False, counts=None):
    """Device time by kernel over ``run`` (torch.profiler); with host_top,
    also the host operators with the most self time; with gaps, the
    device's idle gaps between kernels; with counts (a dict of event names),
    the number of each named host event into it.  Returns the total device
    time in ms, or None where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    print(title)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(e):  # named self_cuda_time_total before torch 2.4
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    cuda = torch.autograd.DeviceType.CUDA
    if counts is not None:
        for key in counts:
            counts[key] = sum(e.count for e in prof.key_averages() if e.key == key)
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == cuda]
    total = sum(dev_us(e) for e in events)
    if not total:
        print("profiler recorded no device time")
        return None
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms {100 * dev_us(e) / total:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}")
    print(f"  total device time {total / 1e3:.3f} ms over {len(events)} kernel names")
    if host_top:
        host = [e for e in prof.key_averages() if getattr(e, "device_type", None) != cuda]
        host_total = sum(e.self_cpu_time_total for e in host)
        print(f"  host self time under the profiler {host_total / 1e3:.3f} ms; the largest:")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:host_top]:
            print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}")
    if gaps:
        _device_gaps([(e.time_range.start, e.time_range.end) for e in prof.events()
                      if getattr(e, "device_type", None) == cuda])
    return total / 1e3


def _device_gaps(spans):
    """The device's timeline from its kernels' (start, end) spans in µs:
    busy share of the span from the first kernel's start to the last's end,
    and the idle gaps between kernels, largest first."""
    if not spans:
        print("  device gaps: no kernel spans recorded")
        return
    spans.sort()
    busy, idle = 0.0, []
    lo, hi = spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            idle.append((s - hi, hi - spans[0][0]))
            lo = s
        hi = max(hi, e)
    busy += hi - lo
    span = hi - spans[0][0]
    idle.sort(reverse=True)
    print(f"  device timeline {span / 1e3:.3f} ms: busy {busy / 1e3:.3f} ms "
          f"({100 * busy / span:.1f}%), {len(idle)} idle gaps, "
          f"{sum(g > 1e3 for g, _ in idle)} over 1 ms, summing {sum(g for g, _ in idle) / 1e3:.3f} "
          f"ms; largest (ms at ms): "
          + ", ".join(f"{g / 1e3:.3f} at {t / 1e3:.1f}" for g, t in idle[:8]))


def _tv_level_planes(prev, curr, flow, level, p):
    """Inputs of the TV-L1 kernels at pyramid ``level``: the source planes
    (I1, I1x, I1y) of the blurred, resized frame and the chain's six planes
    from the plain warp at ``flow`` (B, 2, H, W) resized to the level and
    scaled, as ops/tvl1.py tvl1_flow and _tvl1_level build them."""
    from btcs_pnes_optical_flow_tpu_torch.ops import cvx
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv

    hh, ww = tv._pyramid_sizes(*prev.shape[1:], p)[level]
    i0 = cvx.resize_bilinear_mm(cvx.gaussian_blur_reflect101(tv._unit(prev), 5, 0.8), hh, ww)
    i1 = cvx.resize_bilinear_mm(cvx.gaussian_blur_reflect101(tv._unit(curr), 5, 0.8), hh, ww)
    src = torch.stack([i1, *tv._grad(i1)], dim=1)
    scale = p.scale_step ** level
    u, v = (cvx.resize_bilinear_mm(flow[:, k], hh, ww) * scale for k in range(2))
    u, v = u.contiguous(), v.contiguous()
    return src, (u, v, *tv._linearise(i0, src, u, v, tv.warp_sample_cf_plain))


def phase_tvl1_kernels(tv_clip, device):
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    h, w = tv_clip.shape[1:]
    print(f"== 6. TV-L1 kernels vs plain at {h}x{w}, B={TV_PAIRS}")
    p = tv.TVL1Params()
    prev = torch.as_tensor(tv_clip[:-1], device=device)
    curr = torch.as_tensor(tv_clip[1:], device=device)
    # Realistic inputs: the plain path's flow for these pairs, the plain warp
    # of (I1, I1x, I1y) there and the chain inputs built from it.
    t0 = time.perf_counter()
    flow_plain = tv.tvl1_flow(prev, curr, p, kernels=False)
    torch.cuda.synchronize()
    print(f"plain path on the card: {time.perf_counter() - t0:.3f} s (first call)")
    flow_cf = flow_plain.movedim(-1, 1).contiguous()
    src, planes = _tv_level_planes(prev, curr, flow_cf, 0, p)
    args = (p.n_iterations, p.tau, p.lambda_, p.theta)
    calls = {
        "warp_sample": (lambda: tc.warp_sample_cf(src, flow_cf),
                        lambda: tv.warp_sample_cf_plain(src, flow_cf)),
        "pd_chain": (lambda: tc.pd_chain(*planes, *args), lambda: tv.pd_chain_plain(*planes, *args)),
    }
    rows = {}
    for name, kid, replaces, tol, why in TV_KERNELS:
        if name not in calls:
            continue
        rel = name == "warp_sample"
        rows[name] = _check_and_time(name, kid, TV_SOURCE, replaces, *calls[name],
                                     rtol=tol if rel else None,
                                     abs_tol=None if rel else tol, why=why)
    lib_ms = _k5_yardstick(src, flow_cf)
    b, c = src.shape[:2]
    _set_bound(rows["warp_sample"], b * h * w, *_k5_cost(c), lib_ms)
    _set_bound(rows["pd_chain"], b * h * w, *_k6_cost(p.n_iterations), None,
               NO_LIBRARY["pd_chain"])
    _k6_levels_and_depths(rows["pd_chain"], prev, curr, flow_cf, planes, p)
    rows["pd_eps_step"] = _eps_step_1080p(device, p)
    return rows, flow_plain


def _eps_step_1080p(device, p):
    """K6's ε step at the 1080p level-0 shape, B=TV_PAIRS, on the chain
    inputs of the kernel path's flow: one step with its stop test held
    bit-equal to one plain iteration with its stop test and timed against
    it, the kernel alone timed against its bytes at the HBM rate (the first
    step, zero duals; a later one, duals read), and a whole ε loop (30
    iterations, the default ε) bit-equal with one launch an iteration of the
    plain loop."""
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    h, w = HD_H, HD_W
    clip = render_clip(TV_PAIRS + 1, h, w, seed=2)
    prev = torch.as_tensor(clip[:-1], device=device)
    curr = torch.as_tensor(clip[1:], device=device)
    del clip
    flow_cf = tv.tvl1_flow(prev, curr, p).movedim(-1, 1).contiguous()
    _, planes = _tv_level_planes(prev, curr, flow_cf, 0, p)
    del prev, curr, flow_cf
    b = planes[0].shape[0]
    px = planes[0].numel()
    print(f"K6 eps step at 1080p level 0, {tuple(planes[0].shape)}:")
    consts = (p.tau, p.lambda_, p.theta)
    name, kid, replaces, tol, why = next(k for k in TV_KERNELS if k[0] == "pd_eps_step")
    tc.reset_launch_counts()
    row = _check_and_time(name, kid, TV_SOURCE, replaces,
                          lambda: tc.pd_eps_chain(*planes, 1, *consts, p.epsilon),
                          lambda: tv.pd_chain_plain(*planes, 1, *consts, epsilon=p.epsilon),
                          rtol=None, abs_tol=tol, why=why, reps=TV_REPS)
    # The kernel alone: raw launches into preallocated outputs.
    lib = tc.library()
    active = torch.ones((b,), dtype=torch.bool, device=device)
    out_uv = torch.empty((2, *planes[0].shape), device=device)
    duals = torch.empty((2, 4, *planes[0].shape), device=device)
    sq = torch.empty_like(planes[0])
    fixed = [t.data_ptr() for t in planes[2:]]

    def launch(first):
        src = None if first else duals[0].data_ptr()
        tc._launch(lib.tv_pd_eps_step, planes[0].data_ptr(), planes[1].data_ptr(), src, *fixed,
                   active.data_ptr(), out_uv[0].data_ptr(), out_uv[1].data_ptr(),
                   duals[1].data_ptr(), sq.data_ptr(), b, *planes[0].shape[1:],
                   p.lambda_ * p.theta, p.theta, p.tau / p.theta)

    launch(True)
    duals[0].copy_(duals[1])
    alone = {}
    for first, by in zip((True, False), TV_EPS_STEP_BYTES):
        ms = statistics.median([_median_ms(lambda: launch(first), TV_REPS) for _ in range(4)])
        bound = px * by / HBM_BYTES_PER_S * 1e3
        alone["first" if first else "later"] = {"ms": ms, "bound_ms": bound, "bytes_per_px": by}
        print(f"  kernel alone, {'first step (zero duals)' if first else 'later step'}: "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by} B/px at {HBM_BYTES_PER_S:.3g} B/s), "
              f"share {100 * bound / ms:.1f}%")
    first = alone["first"]
    row.update(bound_ms=first["bound_ms"], bound_by="bytes",
               share_of_bound=first["bound_ms"] / first["ms"], library_ms=None,
               kernel_alone=alone)
    print(f"  one step with its stop test {row['ms']:.4f} ms vs the plain iteration "
          f"{row['plain_ms']:.4f} ms ({row['plain_ms'] / row['ms']:.1f}x)")

    # A whole ε loop: one launch an iteration of the plain loop.
    log = []
    with _eps_loop_spy(log):
        tv.pd_chain_plain(*planes, p.n_iterations, *consts, epsilon=p.epsilon)
    plain_its = log[0][1]
    tc.reset_launch_counts()
    kern = tc.pd_eps_chain(*planes, p.n_iterations, *consts, p.epsilon)
    steps = tc.LAUNCHES["pd_eps_step"]
    plain = tv.pd_chain_plain(*planes, p.n_iterations, *consts, epsilon=p.epsilon)
    same = all(torch.equal(k, q) for k, q in zip(kern, plain))
    print(f"  a whole ε loop ({p.n_iterations} iterations at most, epsilon {p.epsilon}): "
          f"{steps} launches, the plain loop {plain_its} iterations; torch.equal {same}")
    if not same or steps != plain_its:
        raise AssertionError("the ε step's loop differs from the plain loop")
    row["launches"] = steps
    return row


def _k5_yardstick(src, flow_cf, reps=REPS):
    """K5 against its library yardstick in alternating rounds: grid_sample
    with border padding and align_corners samples at clamp(x + u, 0, w - 1),
    as K5 does.  Returns grid_sample's median ms."""
    import torch.nn.functional as F

    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    h, w = src.shape[-2:]
    xs = torch.arange(w, device=src.device, dtype=torch.float32)
    ys = torch.arange(h, device=src.device, dtype=torch.float32)[:, None]
    grid = torch.stack([(xs + flow_cf[:, 0]) * (2.0 / (w - 1)) - 1.0,
                        (ys + flow_cf[:, 1]) * (2.0 / (h - 1)) - 1.0], dim=-1)

    def sample():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    d_lib = float((sample() - tc.warp_sample_cf(src, flow_cf)).abs().max())
    k5_ms, lib_rounds = [], []
    for _ in range(3):
        k5_ms.append(_median_ms(lambda: tc.warp_sample_cf(src, flow_cf), reps))
        lib_rounds.append(_median_ms(sample, reps))
    print(f"K5 vs its library yardstick F.grid_sample(bilinear, border, align_corners=True) on "
          f"the same coordinates at {tuple(src.shape)}, alternating rounds: K5 "
          f"{[round(x, 4) for x in k5_ms]} ms, grid_sample {[round(x, 4) for x in lib_rounds]} "
          f"ms; max |grid_sample - kernel| {d_lib:.3e} (its own coordinate arithmetic)")
    return statistics.median(lib_rounds)


def _k6_levels_and_depths(row, prev, curr, flow_cf, planes0, p):
    """K6 at every level of the clip's pyramid with the default schedule,
    and at level 0 at every compiled depth (depth 1: one launch per
    iteration, PR 2's structure); each run held bit-equal to the plain
    chain."""
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    args = (p.n_iterations, p.tau, p.lambda_, p.theta)
    print(f"K6: {K6_OPS_PER_ITERATION} float32 operations per pixel and iteration, "
          f"{K6_OPS_PER_CHAIN} per pixel and chain (the bound's count); default depth "
          f"{tc.PD_DEPTH}, schedule {tc.pd_schedule(p.n_iterations)} for {p.n_iterations} "
          f"iterations")

    def held(pl, depth):
        kern = torch.stack(tc.pd_chain(*pl, *args, depth=depth))
        plain = torch.stack(tv.pd_chain_plain(*pl, *args))
        err = float((kern - plain).abs().max())
        if err != 0.0:
            raise AssertionError(f"K6 at depth {depth}, {tuple(pl[0].shape)}: max err {err}")
        return err

    levels = {}
    for level in range(len(tv._pyramid_sizes(*prev.shape[1:], p))):
        pl = planes0 if level == 0 else _tv_level_planes(prev, curr, flow_cf, level, p)[1]
        held(pl, tc.PD_DEPTH)
        ms = statistics.median([_median_ms(lambda: tc.pd_chain(*pl, *args)) for _ in range(2)])
        bound = _bound(pl[0].numel(), *_k6_cost(p.n_iterations))[0]
        levels[level] = ms
        print(f"K6 level {level} {tuple(pl[0].shape)}: {ms:.4f} ms per chain, bound "
              f"{bound:.4f} ms, share {100 * bound / ms:.1f}%, max_abs_err 0.0")
    sweep = {}
    for depth in tc.PD_DEPTHS:
        held(planes0, depth)
        sweep[depth] = statistics.median(
            [_median_ms(lambda: tc.pd_chain(*planes0, *args, depth=depth)) for _ in range(2)])
    print("K6 level-0 depth sweep (ms per chain, launches): " + ", ".join(
        f"D={d}: {ms:.4f} ({len(tc.pd_schedule(p.n_iterations, d))})" for d, ms in sweep.items()))
    row.update(level_ms=levels, depth_sweep_ms=sweep)


def phase_tvl1_slice(tv_clip, device, smi, rows, flow_plain):
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    h, w = tv_clip.shape[1:]
    p = tv.TVL1Params()
    print(f"== 7. TV-L1 slice: {TV_PAIRS} pairs of {h}x{w}, {p}")
    prev = torch.as_tensor(tv_clip[:-1], device=device)
    curr = torch.as_tensor(tv_clip[1:], device=device)
    tv.tvl1_flow(prev, curr, p)  # warm-up (allocator, cached matrices)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    tc.reset_launch_counts()
    t0 = time.perf_counter()
    flow, clips = tv.tvl1_flow(prev, curr, p, return_clip=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    flow_h, clips_h = flow.cpu(), clips.cpu()
    kern_s = time.perf_counter() - t0
    launches = dict(tc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30

    sizes = tv._pyramid_sizes(h, w, p)
    chains = sum(p.n_warps for s in sizes if tv._resident_ok(*s, p))
    blocks = tc.pd_schedule(p.n_iterations)
    want = {"warp_sample": len(sizes) * p.n_warps, "pd_chain": chains,
            "pd_block": chains * len(blocks)}
    want["pd_eps_step"] = 0  # every level of the clip runs K6
    print(f"launches: {launches} (expected {want}: {len(sizes)} levels x {p.n_warps} warps, "
          f"{chains} chains on K6, each {len(blocks)} launches of depths {blocks})")
    if launches != want or launches["pd_block"] >= chains * p.n_iterations:
        raise AssertionError("TV-L1 launch counts differ from the path's schedule")
    rows["warp_sample"]["launches"] = launches["warp_sample"]
    rows["pd_chain"]["launches"] = launches["pd_block"]
    if flow_h.shape != (TV_PAIRS, h, w, 2) or clips_h.shape != (TV_PAIRS,):
        raise AssertionError(f"flow {tuple(flow_h.shape)}, clips {tuple(clips_h.shape)}")
    if clips_h.dtype != torch.int32 or int(clips_h.abs().sum()) != 0:
        raise AssertionError("TV-L1 clips are not int32 zeros")
    if not torch.isfinite(flow_h).all():
        raise AssertionError("non-finite TV-L1 flow")
    d = float((flow_h - flow_plain.cpu()).abs().max())
    print(f"kernel vs plain path on the card, {TV_PAIRS} pairs: max |dflow| {d:.3e} px "
          f"(bar {FLOW_TOL_PX}); clips all zero; |flow| max {float(flow_h.abs().max()):.4f} px, "
          f"mean {float(flow_h.norm(dim=-1).mean()):.4f} px")
    if not d <= FLOW_TOL_PX:
        raise AssertionError("TV-L1 kernel path disagrees with the plain path")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tv.tvl1_flow(prev, curr, p, kernels=False).cpu()
    plain_s = time.perf_counter() - t0

    # The card against the plain path on the CPU at a small size.  Both
    # sides run the fixed-length chain ("auto" on a CPU tensor would pick
    # the epsilon loop).
    small = np.ascontiguousarray(tv_clip[:3, ::5, ::5])
    pr = dataclasses.replace(p, pd_engine="resident")
    f_cpu = tv.tvl1_flow(torch.as_tensor(small[:-1]), torch.as_tensor(small[1:]), pr)
    f_gpu = tv.tvl1_flow(torch.as_tensor(small[:-1], device=device),
                         torch.as_tensor(small[1:], device=device), pr).cpu()
    d_small = float((f_cpu - f_gpu).abs().max())
    print(f"kernel path on the card vs plain path on the CPU, 2 pairs {small.shape[1:]}: "
          f"max |dflow| {d_small:.3e} px (bar {FLOW_TOL_PX})")
    if not d_small <= FLOW_TOL_PX:
        raise AssertionError("TV-L1 on the card disagrees with the CPU")

    print(f"TV-L1 {kern_s:.4f} s for {TV_PAIRS} pairs with the flow copied to the host "
          f"({TV_PAIRS / kern_s:.2f} frames/s), {card_s:.4f} s on the card, fenced by a "
          f"synchronise ({TV_PAIRS / card_s:.2f} frames/s); plain path {plain_s:.4f} s "
          f"({TV_PAIRS / plain_s:.2f} frames/s, copied to the host), peak {peak:.2f} GiB on "
          f"[{smi}]")
    return prev, curr, p, card_s


def _pingpong_source(base, n_frames, fail_at=None):
    """A VideoSource of n_frames gray frames at 30 fps: the base clip played
    forward and back (0, 1, …, n−1, n−2, …, 1, 0, 1, …), so that no pair
    jumps, with pos_msec = 1000·i/30; host memory holds the base clip only.
    With fail_at, frame fail_at raises RuntimeError (a decode error)."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.video import VideoSource

    class PingPong(VideoSource):
        def frames(self):
            period = 2 * (len(base) - 1)
            for i in range(self.n_frames):
                if i == fail_at:
                    raise RuntimeError(f"decode error at frame {i}")
                j = i % period
                yield base[min(j, period - j)], 1000.0 * i / HD_FPS

    src = PingPong()
    src.fps, src.n_frames, (src.height, src.width) = HD_FPS, n_frames, base.shape[1:]
    return src


def _hd_level_rows(p, h, w):
    """Per level: (k, size, ROI box, tile range or None, iterations)."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb

    out = []
    for k in range(p.num_levels(h, w) + 1):
        hk, wk = p.level_size(h, w, k)
        out.append((k, (hk, wk), p.roi_active_px[k], fb.box_tiles(p.roi_active_px[k], hk, wk),
                    p.iters_at(k)))
    return out


def _box_shares(p, h, w):
    """Print each level's ROI box, its tile range and the share of the
    level the range covers."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb

    for k, (hk, wk), box, tiles, it in _hd_level_rows(p, h, w):
        cover = fb.tile_box(tiles, hk, wk) if tiles else (0, hk, 0, wk)
        share = (cover[1] - cover[0]) * (cover[3] - cover[2]) / (hk * wk)
        print(f"level {k} {hk}x{wk}: box {box}, tiles {tiles} covering {cover} "
              f"({100 * share:.0f}% of the level), {it} iterations")


def phase_hd(device, smi, rows):
    """BASELINE config 3 through the port's run_full: the 1080p kernels,
    agreement on the first chunk, a chunk sweep, the 10-minute run with a
    checkpoint store, crash and short-tail resume, PC1 and streaming PC1,
    and a profile of two chunks."""
    import tempfile

    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask

    h, w = HD_H, HD_W
    cfg = PipelineConfig(flow=dataclasses.replace(FarnebackParams(), **BENCH_FLOW))
    print(f"== 15. BASELINE config 3: {HD_FRAMES} frames of {h}x{w} (10 min at {HD_FPS:g} fps), "
          f"the 1080p ROI (bench.py:301), {BENCH_FLOW}, chunks of {HD_CHUNK} pairs")
    t0 = time.perf_counter()
    base = render_clip(HD_BASE_FRAMES, h, w, seed=1)
    print(f"base clip {base.shape} rendered in {time.perf_counter() - t0:.1f} s "
          f"({base.nbytes / 1e6:.0f} MB), played forward and back")
    mask = fill_poly_mask(h, w, HD_ROI)
    p = fb.roi_dispatch_params(cfg.flow, h, w, mask[None])
    _box_shares(p, h, w)
    per_chunk = _launch_schedule(p, h, w, 1)
    want = dict(dict.fromkeys(fc.LAUNCHES, 0), poly_exp=4, update_matrices_bf16=9,
                update_matrices_box_bf16=8, update_flow=9)
    print(f"launches per {HD_CHUNK}-pair chunk: {per_chunk}")
    if per_chunk != want:
        raise AssertionError(f"the 1080p schedule is not 4 K1 / 9 K2 bf16 (8 box) / 9 K3: {want}")
    fc.reset_launch_counts()
    run_flow_stage(_pingpong_source(base, HD_CHUNK + 1), _skeleton(HD_CHUNK + 1), [HD_ROI], cfg,
                   HD_CHUNK, device=device)
    launches = dict(fc.LAUNCHES)
    print(f"launches of one {HD_CHUNK}-pair chunk through run_flow_stage: {launches}")
    if launches != want:
        raise AssertionError("one 1080p chunk's launches differ from the schedule")
    for name, count in launches.items():
        if count:
            rows[name]["hd_chunk_launches"] = count
    _hd_kernels(base, p, device, rows)
    plain_chunk = _hd_agreement(base, cfg, p, mask, device)
    _hd_sweep(base, cfg, p, device, smi)
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        flow, pc1, mets, timer = _hd_full(base, cfg, p, device, smi, rows,
                                          os.path.join(tmp, "full"), plain_chunk)
        _hd_resume(base, cfg, device, flow, tmp)
    _hd_pc1(flow, pc1, mets, timer, device, smi)
    _hd_profile(base, cfg, device, smi)


def _hd_check(name, kern, plain_of, rows, what, step=None):
    """A kernel's output against its plain version at 1080p: bit-equal.
    plain_of(sl) is the plain version over the batch slice sl (a frame's
    or a pair's output depends on its own inputs only), run over slices of
    ``step`` or over the whole batch; the row's max_abs_err takes the
    larger error."""
    torch.cuda.synchronize()
    n = kern.shape[0]
    err = 0.0
    for s in range(0, n, step or n):
        sl = slice(s, min(n, s + (step or n)))
        err = max(err, float((kern[sl] - plain_of(sl)).abs().max()))
    print(f"  {name} {what}: max_abs_err {err:.3e} (bar 0.0)")
    if err != 0.0 or not torch.isfinite(kern).all():
        raise AssertionError(f"{name} at 1080p disagrees with its plain version")
    rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)


def _in_turns(old_fn, new_fn, reps=MAIN_REPS):
    """CUDA-event medians of two callables on the same tensors, timed in
    turns (old, new, new, old) twice after a warm-up: (old ms, new ms)."""
    old_fn(), new_fn()
    old, new = [], []
    for _ in range(2):
        old.append(_median_ms(old_fn, reps))
        new.append(_median_ms(new_fn, reps))
        new.append(_median_ms(new_fn, reps))
        old.append(_median_ms(old_fn, reps))
    return statistics.median(old), statistics.median(new)


def _hd_kernels(base, p, device, rows):
    """15a: at each level of one 64-pair chunk (65 frames), K1; K2 bf16 over
    the whole level with the pre-walk K2 beside it; where the level is
    boxed, K2 bf16 in box mode over the level's box with K4 bf16 over the
    box's tile list beside it; and K3 (whole, and box mode on K2's box
    output): each bit-equal to its plain version on the tensors that are
    then timed, each launch at its level (K2 against its earlier design in
    turns), then the chunk's launches back to back beside their bound, the
    path's K2 launches against the earlier designs' in turns.  Then the same
    checks and K2 timings at level 0 of a 256-pair chunk, the sweep's
    largest, whose planes pass 2^31 elements, the plain versions over
    slices of HD_PLAIN_PAIRS pairs."""
    from btcs_pnes_optical_flow_tpu_torch.ops import cvx
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    h, w = base.shape[1:]
    n, sigma, ws, gw = p.poly_n, p.poly_sigma, p.winsize, p.gaussian_win
    print(f"== 15a. K1, K2 bf16 (whole and box), K3, and K2's earlier designs (the pre-walk K2, "
          f"K4 bf16 over the box's tiles) at {h}x{w}: one {HD_CHUNK}-pair chunk, level by "
          f"level, against the plain versions and timed; then level 0 at "
          f"{HD_SWEEP_CHUNKS[-1]} pairs")

    def level(frames, k, flow_full):
        """Level k's image, expansion and flow (the kernel path's final flow
        resized to the level and scaled) of the frames' pairs."""
        lv, hk, wk = fb._level_image(frames.float(), k, p, h, w)
        lv = lv.contiguous()
        flow = (cvx.resize_bilinear(flow_full, hk, wk) * p.pyr_scale ** k).contiguous()
        return lv, fc.poly_exp_cf(lv, n, sigma), flow

    def checks(lv, poly, flow, tiles, what, step=None):
        """One level's kernels and K2's earlier designs against their plain
        versions; returns the M planes that the level's K3 reads (K2's box
        output where the level is boxed)."""
        hk, wk = lv.shape[-2:]
        r0, r1 = poly[:-1], poly[1:]
        _hd_check("poly_exp", poly, lambda sl: fb.poly_exp_cf_plain(lv[sl], n, sigma), rows,
                  what, step)

        def k2_plain(sl, box=None):
            out = None if box is None else torch.zeros_like(r0[sl])
            return fb.update_matrices_cf_plain(r0[sl], r1[sl], flow[sl], "bf16", box, out)

        _hd_check("update_matrices_rows", fc.update_matrices_rows_cf(r0, r1, flow, 0, hk, "bf16"),
                  k2_plain, rows, f"{what}, pre-walk K2 bf16", step)
        m = fc.update_matrices_cf(r0, r1, flow, "bf16")
        _hd_check("update_matrices_bf16", m, k2_plain, rows, what, step)
        _hd_check("update_flow", fc.update_flow_cf(m, ws, gw),
                  lambda sl: fb.update_flow_cf_plain(m[sl], ws, gw), rows, f"{what}, whole", step)
        if tiles is None:
            return m
        del m
        box = fb.tile_box(tiles, hk, wk)
        sel = fb.tile_list(flow.shape[0], tiles, hk, wk, device)
        # The plain versions' untouched pixels stay zero, as the kernels' must.
        k4 = fc.update_matrices_tiles_cf(r0, r1, flow, sel, torch.zeros_like(r0), fb.TILE, "bf16")
        _hd_check("update_matrices_tiles_bf16", k4, lambda sl: fb.update_matrices_tiles_cf_plain(
            r0[sl], r1[sl], flow[sl], fb.tile_list(sl.stop - sl.start, tiles, hk, wk, device),
            torch.zeros_like(r0[sl]), fb.TILE, "bf16"), rows,
            f"{what}, {sel.numel()} tiles of {tiles}", step)
        del k4, sel
        m = fc.update_matrices_cf(r0, r1, flow, "bf16", box, torch.zeros_like(r0))
        _hd_check("update_matrices_box_bf16", m, lambda sl: k2_plain(sl, box), rows,
                  f"{what}, box {box}", step)
        # The plain version leaves the flow outside the box as it was.
        _hd_check("update_flow", fc.update_flow_cf(m, ws, gw, box, flow.clone()),
                  lambda sl: fb.update_flow_cf_plain(m[sl], ws, gw, box, flow[sl].clone()), rows,
                  f"{what}, box mode {box}", step)
        return m

    def bound_ms(px, cost):
        return max(px * cost[0] / HBM_BYTES_PER_S, px * cost[1] / FP32_OPS_PER_S) * 1e3

    def k2_turns(k, b, poly, flow, tiles, chunk=None, times=1):
        """K2 bf16 whole against the pre-walk K2 and, where the level is boxed,
        K2's box mode against K4's list, in turns on the level's tensors;
        with chunk, the path's launches (box on a boxed level, else whole)
        and the earlier design's go into the chunk's call lists."""
        hk, wk = poly.shape[-2:]
        r0, r1 = poly[:-1], poly[1:]
        cost = _k2_cost(b, "bf16")
        new = functools.partial(fc.update_matrices_cf, r0, r1, flow, "bf16")
        old = functools.partial(fc.update_matrices_rows_cf, r0, r1, flow, 0, hk, "bf16")
        old_ms, new_ms = _in_turns(old, new)
        bd = bound_ms(b * hk * wk, cost)
        rows["update_matrices_bf16"].setdefault("hd_level_ms", {})[f"{k}@{b}"] = new_ms
        rows["update_matrices_bf16"].setdefault("hd_level_old_ms", {})[f"{k}@{b}"] = old_ms
        print(f"  level {k} K2 bf16 whole, {b} pairs: {new_ms:.4f} ms, pre-walk {old_ms:.4f} ms, "
              f"bound {bd:.4f} ms ({b * hk * wk} px): shares {100 * bd / new_ms:.1f}% and "
              f"{100 * bd / old_ms:.1f}%")
        if tiles is None:
            if chunk is not None:
                chunk["whole"] += [new] * times
                chunk["whole_old"] += [old] * times
                chunk["whole_bound"] += times * bd
            return
        box = y0, y1, x0, x1 = fb.tile_box(tiles, hk, wk)
        m_new, m_old = torch.zeros_like(r0), torch.zeros_like(r0)
        sel = fb.tile_list(b, tiles, hk, wk, device)
        new = functools.partial(fc.update_matrices_cf, r0, r1, flow, "bf16", box, m_new)
        old = functools.partial(fc.update_matrices_tiles_cf, r0, r1, flow, sel, m_old, fb.TILE,
                                "bf16")
        old_ms, new_ms = _in_turns(old, new)
        bd = bound_ms(b * (y1 - y0) * (x1 - x0), cost)
        rows["update_matrices_box_bf16"].setdefault("hd_level_ms", {})[f"{k}@{b}"] = new_ms
        rows["update_matrices_box_bf16"].setdefault("hd_level_old_ms", {})[f"{k}@{b}"] = old_ms
        print(f"  level {k} K2 bf16 box {box}, {b} pairs: {new_ms:.4f} ms, K4 list "
              f"{old_ms:.4f} ms, bound {bd:.4f} ms ({b * (y1 - y0) * (x1 - x0)} px): shares "
              f"{100 * bd / new_ms:.1f}% and {100 * bd / old_ms:.1f}%")
        if chunk is not None:
            chunk["box"] += [new] * times
            chunk["box_old"] += [old] * times
            chunk["box_bound"] += times * bd

    frames = torch.as_tensor(base[: HD_CHUNK + 1], device=device)
    flow_full = fb.farneback_flow_seq(frames, p).movedim(-1, 1).contiguous()
    chunk = dict(box=[], box_old=[], whole=[], whole_old=[], box_bound=0.0, whole_bound=0.0,
                 poly_exp=[], poly_exp_bound=0.0, update_flow=[], update_flow_bound=0.0)
    keep = []  # the tensors the chunk's calls read
    for k, (hk, wk), _, tiles, it in _hd_level_rows(p, h, w):
        lv, poly, flow = level(frames, k, flow_full)
        m = checks(lv, poly, flow, tiles, f"level {k} {hk}x{wk}, {HD_CHUNK} pairs")
        keep += [lv, poly, flow, m]
        fn = functools.partial(fc.poly_exp_cf, lv, n, sigma)
        ms = statistics.median([_median_ms(fn, MAIN_REPS) for _ in range(2)])
        bd = bound_ms((HD_CHUNK + 1) * hk * wk, _k1_cost(n))
        rows["poly_exp"].setdefault("hd_level_ms", {})[k] = ms
        print(f"  level {k} K1: {ms:.4f} ms, bound {bd:.4f} ms, share {100 * bd / ms:.1f}%")
        chunk["poly_exp"].append(fn)
        chunk["poly_exp_bound"] += bd
        k2_turns(k, HD_CHUNK, poly, flow, tiles, chunk, it)
        if tiles is None:
            box, px = None, HD_CHUNK * hk * wk
            fn = functools.partial(fc.update_flow_cf, m, ws, gw)
        else:
            box = y0, y1, x0, x1 = fb.tile_box(tiles, hk, wk)
            px = HD_CHUNK * (y1 - y0) * (x1 - x0)
            fn = functools.partial(fc.update_flow_cf, m, ws, gw, box, flow.clone())
        ms = statistics.median([_median_ms(fn, MAIN_REPS) for _ in range(2)])
        bd = bound_ms(px, _k3_cost(ws, gw))
        rows["update_flow"].setdefault("hd_level_ms", {})[k] = ms
        print(f"  level {k} K3 {'whole' if box is None else f'box mode {box}'}: {ms:.4f} ms x{it}, "
              f"bound {bd:.4f} ms ({px} px), share {100 * bd / ms:.1f}%")
        chunk["update_flow"] += [fn] * it
        chunk["update_flow_bound"] += it * bd

    def run(calls):
        def go():
            for fn in calls:
                fn()
        return go

    total = bound = 0.0
    for name in ("poly_exp", "update_flow"):
        ms = statistics.median([_median_ms(run(chunk[name]), MAIN_REPS) for _ in range(2)])
        total, bound = total + ms, bound + chunk[name + "_bound"]
        rows[name].update(hd_chunk_ms=ms, hd_chunk_bound_ms=chunk[name + "_bound"])
        print(f"  {name}: its {len(chunk[name])} launches of one chunk back to back {ms:.4f} ms "
              f"against a bound of {chunk[name + '_bound']:.4f} ms "
              f"({100 * chunk[name + '_bound'] / ms:.1f}%)")
    for part, name, old_name in (("box", "update_matrices_box_bf16", "update_matrices_tiles_bf16"),
                                 ("whole", "update_matrices_bf16", "update_matrices_rows")):
        old_ms, ms = _in_turns(run(chunk[part + "_old"]), run(chunk[part]))
        bd = chunk[part + "_bound"]
        total, bound = total + ms, bound + bd
        rows[name].update(hd_chunk_ms=ms, hd_chunk_bound_ms=bd, hd_chunk_old_ms=old_ms)
        rows[old_name].update(hd_chunk_ms=old_ms, hd_chunk_bound_ms=bd)
        print(f"  K2 bf16 {part}: its {len(chunk[part])} launches of one chunk back to back "
              f"{ms:.4f} ms, the earlier design ({old_name}) {old_ms:.4f} ms, against a bound of "
              f"{bd:.4f} ms ({100 * bd / ms:.1f}% and {100 * bd / old_ms:.1f}%)")
    warp_old, warp_new = _in_turns(run(chunk["box_old"] + chunk["whole_old"]),
                                   run(chunk["box"] + chunk["whole"]))
    warp_bound = chunk["box_bound"] + chunk["whole_bound"]
    rows["update_matrices_box_bf16"].update(hd_chunk_warp_ms=warp_new, hd_chunk_warp_old_ms=warp_old,
                                            hd_chunk_warp_bound_ms=warp_bound)
    print(f"  the chunk's warp and assembly launches ({len(chunk['box'])} box + "
          f"{len(chunk['whole'])} whole): {warp_new:.4f} ms, the earlier designs {warp_old:.4f} "
          f"ms, bound {warp_bound:.4f} ms ({100 * warp_bound / warp_new:.1f}% and "
          f"{100 * warp_bound / warp_old:.1f}%)")
    print(f"kernel time per {HD_CHUNK}-pair chunk {total:.4f} ms, bound {bound:.4f} ms "
          f"({100 * bound / total:.1f}%)")
    del frames, flow_full, chunk, keep, lv, poly, flow, m
    torch.cuda.empty_cache()

    # The sweep's largest chunk at level 0: the planes' element offsets pass
    # 2^31, where an int index would wrap.
    b = HD_SWEEP_CHUNKS[-1]
    frames = torch.as_tensor(np.stack([f for f, _ in _pingpong_source(base, b + 1).frames()]),
                             device=device)
    flow_full = torch.cat([fb.farneback_flow_seq(frames[s : s + HD_CHUNK + 1], p)
                           for s in range(0, b, HD_CHUNK)]).movedim(-1, 1).contiguous()
    lv, poly, flow = level(frames, 0, flow_full)
    del frames, flow_full
    print(f"  level 0 at {b} pairs: {poly.numel()} elements in the expansion (2^31 = {2**31})")
    tiles0 = fb.box_tiles(p.roi_active_px[0], h, w)
    m = checks(lv, poly, flow, tiles0, f"level 0, {b} pairs", step=HD_PLAIN_PAIRS)
    del m
    k2_turns(0, b, poly, flow, tiles0)
    del lv, poly, flow
    torch.cuda.empty_cache()


def _plain_path_chunk(base, cfg, device):
    """The first chunk's features through run_flow_stage on the card with
    the level loop's steps swapped for their plain versions (the plain
    path, kernels=False)."""
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb

    steps = fb._kernel_steps
    fb._kernel_steps = lambda kernels: steps(False)
    try:
        return run_flow_stage(_pingpong_source(base, HD_CHUNK + 1), _skeleton(HD_CHUNK + 1),
                              [HD_ROI], cfg, HD_CHUNK, device=device)
    finally:
        fb._kernel_steps = steps


def _hd_agreement(base, cfg, p, mask, device):
    """15b: on the first chunk, ROI-dispatched against full-frame features,
    the kernel path against the plain path, and the bench
    config's bf16 flow in the ROI against the fp32 flow.  Returns the
    plain path's features of the chunk through run_flow_stage, which 15d's
    first chunk must equal."""
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams
    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq, to_device
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb

    print(f"== 15b. agreement on the first chunk ({HD_CHUNK} pairs)")
    ex = np.tile(np.array([np.cos(THETA), -np.sin(THETA)], np.float32), (HD_CHUNK, 1))
    ey = np.tile(np.array([np.sin(THETA), np.cos(THETA)], np.float32), (HD_CHUNK, 1))
    frames, exd, eyd, masks = to_device(base[: HD_CHUNK + 1], ex, ey, mask[None], device)
    boxed, _ = roi_body_flow_seq(frames, exd, eyd, masks, p)
    full, _ = roi_body_flow_seq(frames, exd, eyd, masks, cfg.flow)
    d = max(float((a - b).abs().max()) for a, b in zip(boxed, full))
    print(f"ROI-dispatched vs full-frame features: max |d| {d:.3e} px/frame (bar {FEATURE_TOL})")
    if not d <= FEATURE_TOL:
        raise AssertionError("1080p ROI features differ from the full-frame ones")
    got = fb.farneback_flow_seq(frames, p)
    d = float((got - fb.farneback_flow_seq(frames, p, kernels=False)).abs().max())
    print(f"kernel vs plain path, {HD_CHUNK} pairs: max |dflow| {d:.3e} px (bar 1e-6)")
    if not d <= 1e-6:
        raise AssertionError("the 1080p kernel path disagrees with the plain path")
    inside = torch.as_tensor(mask, device=device)
    for key, ref_p in (("PipelineConfig() fp32", FarnebackParams()),
                       ("fp32, same schedule", dataclasses.replace(cfg.flow,
                                                                   warp_precision="fp32"))):
        e = (got - fb.farneback_flow_seq(frames, ref_p)).norm(dim=-1)[:, inside].flatten()
        mean = float(e.double().mean())
        print(f"bf16 flow EPE in the ROI vs {key}, {HD_CHUNK} pairs: mean {mean:.5f} px, max "
              f"{float(e.max()):.5f} (bar: mean < {BENCH_EPE_PX})")
        if not mean < BENCH_EPE_PX:
            raise AssertionError(f"1080p bf16 flow EPE vs {key} is past the bar")
    return _plain_path_chunk(base, cfg, device)


def _hd_sweep(base, cfg, p, device, smi):
    """15c: run_flow_stage over 2 minutes at each chunk size: frames/s,
    peak device memory, launches against the schedule, features against
    the 64-pair run's."""
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    n = HD_SWEEP_FRAMES
    skel = _skeleton(n)
    print(f"== 15c. chunk sweep: run_flow_stage on {n} frames at chunks of {HD_SWEEP_CHUNKS}")
    feats = {}
    for chunk in HD_SWEEP_CHUNKS:
        run_flow_stage(_pingpong_source(base, chunk + 1), skel, [HD_ROI], cfg, chunk,
                       device=device)  # warm-up: the allocator at this chunk's shapes
        n_chunks = -(-(n - 1) // chunk)
        want = _launch_schedule(p, HD_H, HD_W, n_chunks)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_flow_stage(_pingpong_source(base, n), skel, [HD_ROI], cfg, chunk, device=device)
        wall = time.perf_counter() - t0
        launches = dict(fc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"chunk {chunk}: {wall:.4f} s, {n / wall:.2f} frames/s, peak device memory "
              f"{peak:.2f} GiB, {n_chunks} chunks, launches {launches} on [{smi}]")
        if launches != want:
            raise AssertionError(f"chunk {chunk}: launches differ from the schedule {want}")
        if res.vx.shape != (n, 1) or not np.isfinite(res.vx[1:]).all():
            raise AssertionError(f"chunk {chunk}: features {res.vx.shape}, not all finite")
        feats[chunk] = res
    # tests/test_pipeline.py's chunk-size bar: the per-pair flow does not
    # depend on the chunk, the ROI means' reduction order may.
    ref = feats[HD_CHUNK]
    d, worst = 0.0, -np.inf
    for r in feats.values():
        for nm in ("vx", "vy", "mag"):
            a, b = getattr(r, nm)[1:], getattr(ref, nm)[1:]
            d = max(d, float(np.abs(a - b).max()))
            worst = max(worst, float((np.abs(a - b) - 1e-6 * np.abs(b)).max()))
    print(f"features at every chunk size vs {HD_CHUNK}: max |d| {d:.3e} px/frame "
          f"(bar 1e-7 + 1e-6 x |value|)")
    if not worst <= 1e-7:
        raise AssertionError("the flow stage's features depend on the chunk size")


def _hd_full(base, cfg, p, device, smi, rows, ck, plain_chunk):
    """15d: run_full over the 10-minute recording with a checkpoint store;
    its first chunk's features array_equal to the plain path's (15b)."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.checkpoint import ChunkStore
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    n = HD_FRAMES
    n_chunks = -(-(n - 1) // HD_CHUNK)
    want = _launch_schedule(p, HD_H, HD_W, n_chunks)
    print(f"== 15d. run_full on {n} frames ({n_chunks} chunks of {HD_CHUNK} pairs, the last "
          f"padded) with a checkpoint store, StageTimer")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    stop, rss = threading.Event(), []
    sampler = threading.Thread(target=_sample_rss, args=(stop, rss), daemon=True)
    sampler.start()
    timer = StageTimer(device)
    t0 = time.perf_counter()
    with _cascade_launches("the 10-minute run_full's PC1 head"):
        flow, pc1, mets = run_full(_pingpong_source(base, n), _skeleton(n), [HD_ROI], cfg,
                                   HD_CHUNK, checkpoint_dir=ck, device=device, timer=timer)
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stop.set()
    sampler.join()
    rss_text = (f"host RSS {max(rss) / 2**30:.2f} GiB at the run's peak, {rss[0] / 2**30:.2f} at "
                f"its start ({len(rss)} samples, 10 ms apart)" if rss
                else "host RSS not measured (/proc/self/statm unreadable)")
    print(f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the 10-minute run's launches differ from the schedule")
    for name in ("poly_exp", "update_matrices_bf16", "update_matrices_box_bf16", "update_flow"):
        rows[name]["hd_launches"] = launches[name]
    if flow.vx.shape != (n, 1) or not np.isnan(flow.vx[0, 0]) or not np.isfinite(flow.vx[1:]).all():
        raise AssertionError(f"features {flow.vx.shape}: NaN is expected at frame 0 only")
    if pc1.shape != (n, 1) or np.isfinite(pc1[:, 0]).sum() < n - 100 or int(mets[0].status):
        raise AssertionError(f"PC1 {pc1.shape} with {np.isfinite(pc1).sum()} finite, metric "
                             f"status {int(mets[0].status)}")
    stored = ChunkStore(ck).completed_chunks()
    if stored != list(range(0, n - 1, HD_CHUNK)):
        raise AssertionError(f"the store holds {len(stored)} chunks, not {n_chunks}")
    head = slice(0, HD_CHUNK + 1)
    same = all(np.array_equal(getattr(flow, nm)[head], getattr(plain_chunk, nm), equal_nan=True)
               for nm in ("vx", "vy", "mag"))
    print(f"first chunk's features array_equal to the plain path's through run_flow_stage "
          f"(15b): {same}")
    if not same:
        raise AssertionError("the 10-minute run's first chunk differs from the plain path's")
    st = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"10-minute run_full: {wall:.4f} s, {n / wall:.2f} frames/s end to end "
          f"({n / timer.times['flow']:.2f} through the flow stage); stage seconds {st}; peak "
          f"device memory {peak:.2f} GiB; {rss_text}; "
          f"{len(stored)} chunks stored on [{smi}]")
    return flow, pc1, mets, timer


def _sample_rss(stop, out, period=0.01):
    """Append this process's resident set (bytes, /proc/self/statm) to out
    every period seconds until stop is set."""
    page = os.sysconf("SC_PAGE_SIZE")
    while not stop.is_set():
        try:
            with open("/proc/self/statm") as f:
                out.append(int(f.read().split()[1]) * page)
        except OSError:
            return
        stop.wait(period)


def _hd_resume(base, cfg, device, ref, tmp):
    """15e: a run that dies of a decode error 40% in, resumed over the whole
    recording; a recording cut inside a chunk, resumed over the whole.
    Both equal 15d's features; K1 launches count the chunks recomputed."""
    from btcs_pnes_optical_flow_tpu_torch.dataio.checkpoint import ChunkStore
    from btcs_pnes_optical_flow_tpu_torch.models.chunks import _PIPELINE_DEPTH
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    n = HD_FRAMES
    skel = _skeleton(n)
    firsts = list(range(0, n - 1, HD_CHUNK))

    def stage(src, ck):
        return run_flow_stage(src, skel, [HD_ROI], cfg, HD_CHUNK, checkpoint_dir=ck, device=device)

    def resumed(ck, what, recompute):
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        res = stage(_pingpong_source(base, n), ck)
        wall = time.perf_counter() - t0
        same = all(np.array_equal(getattr(res, nm), getattr(ref, nm), equal_nan=True) for nm in (
            "frame", "t_sec", "skel_idx", "axes_ok", "vx", "vy", "mag"))
        k1 = fc.LAUNCHES["poly_exp"]
        print(f"{what}: resumed over the whole recording in {wall:.4f} s, K1 launches {k1} "
              f"(expected 4 x {recompute} chunks recomputed), features array_equal to 15d's: "
              f"{same}")
        if not same or k1 != 4 * recompute:
            raise AssertionError(f"{what}: the resumed run differs from the uninterrupted one")

    print(f"== 15e. crash and resume: a decode error at frame {HD_CRASH_FRAME}, then a recording "
          f"cut at {HD_TAIL_FRAMES} frames")
    ck = os.path.join(tmp, "crash")
    try:
        stage(_pingpong_source(base, n, fail_at=HD_CRASH_FRAME), ck)
    except RuntimeError as exc:  # the injected decode error, and nothing else
        if "decode error" not in str(exc):
            raise
        print(f"the run stopped with: {exc}")
    else:
        raise AssertionError("the decode error did not reach run_flow_stage's caller")
    stored = ChunkStore(ck).completed_chunks()
    dispatched = (HD_CRASH_FRAME - 1) // HD_CHUNK
    print(f"{len(stored)} chunks stored, {dispatched} dispatched: {dispatched - len(stored)} lost "
          f"in flight (at most {_PIPELINE_DEPTH})")
    if stored != firsts[: len(stored)] or not 0 <= dispatched - len(stored) <= _PIPELINE_DEPTH:
        raise AssertionError(f"the crashed run stored {stored[:3]}… ({len(stored)} chunks)")
    resumed(ck, "crash", len(firsts) - len(stored))

    ck = os.path.join(tmp, "tail")
    stage(_pingpong_source(base, HD_TAIL_FRAMES), ck)
    tail = (HD_TAIL_FRAMES - 1) // HD_CHUNK * HD_CHUNK
    stored = ChunkStore(ck).completed_chunks()
    short = len(ChunkStore(ck).load(tail)["vx"])
    print(f"cut recording: {len(stored)} chunks stored, the last at {tail} holding {short} pairs")
    if stored[-1] != tail or short != (HD_TAIL_FRAMES - 1) % HD_CHUNK:
        raise AssertionError("the cut recording's store does not end in its short tail chunk")
    resumed(ck, "short tail", len(firsts) - len(stored) + 1)


def _hd_pc1(flow, pc1, mets, timer, device, smi):
    """15f: run_pc1_stage ("scan", inside 15d's run_full) against
    pc1_streaming over the 10-minute features; the metric row."""
    from btcs_pnes_optical_flow_tpu_torch.models.streaming import pc1_streaming

    print(f"== 15f. PC1 over {len(pc1)} samples: run_pc1_stage vs pc1_streaming")
    t0 = time.perf_counter()
    stream = pc1_streaming(flow.vx[:, 0], flow.vy[:, 0], device=device)
    stream_s = time.perf_counter() - t0
    fin = np.isfinite(pc1[:, 0])
    same_nan = np.array_equal(np.isnan(stream), ~fin)
    corr = float(np.corrcoef(stream[fin], pc1[fin, 0])[0, 1])
    print(f"run_pc1_stage (scan) {timer.times['pc1']:.4f} s, pc1_streaming (scan, chunks of "
          f"4096, margin 240) {stream_s:.4f} s on [{smi}]; NaN pattern equal {same_nan}, corr "
          f"{corr:.9f} (bar > {STREAM_CORR}), max |d| {float(np.abs(stream[fin] - pc1[fin, 0]).max()):.3e}")
    if not (same_nan and corr > STREAM_CORR):
        raise AssertionError("streaming PC1 disagrees with run_pc1_stage at 10 minutes")
    m = mets[0]
    print(f"metric row ({timer.times['metrics']:.4f} s): " + ", ".join(
        f"{f} {float(getattr(m, f)):.6g}" for f in m._fields))


@contextlib.contextmanager
def _k4_boxed_levels():
    """The level loop as it ran boxed levels before K2's box mode: K4 over a
    device-built list of the box's tiles, whose range the wrapper reads
    back before each launch.  Whole levels run K2 as they do now."""
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc

    k2 = fc.update_matrices_cf
    th, tw = fb.TILE

    def um(r0, r1, flow, precision="fp32", box=None, out=None):
        if box is None:
            return k2(r0, r1, flow, precision)
        y0, y1, x0, x1 = box
        hk, wk = r0.shape[-2:]
        tiles = (y0 // th, -(-y1 // th), x0 // tw, -(-x1 // tw))
        sel = fb.tile_list(r0.shape[0], tiles, hk, wk, r0.device)
        return fc.update_matrices_tiles_cf(r0, r1, flow, sel, out, fb.TILE, precision)

    fc.update_matrices_cf = um
    try:
        yield
    finally:
        fc.update_matrices_cf = k2


def _hd_profile(base, cfg, device, smi):
    """15g: two chunks through run_flow_stage under the profiler: device
    time by kernel, the host's largest operators, the device's idle gaps
    and its busy share of an unprofiled run; then the host syncs of the two
    chunks (cudaStreamSynchronize, aten::_local_scalar_dense) against the
    level loop's earlier K4 form of the boxed levels, and the two forms'
    unprofiled times in turns."""
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage

    n = 2 * HD_CHUNK + 1
    skel = _skeleton(n)

    def run():
        return run_flow_stage(_pingpong_source(base, n), skel, [HD_ROI], cfg, HD_CHUNK,
                              device=device)

    def run_k4():
        with _k4_boxed_levels():
            return run()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    syncs = dict.fromkeys(("cudaStreamSynchronize", "aten::_local_scalar_dense",
                           "cudaMemcpyAsync"), 0)
    busy = phase_profile(f"== 15g. device time by kernel, run_flow_stage over {n} frames (two "
                         f"chunks), with decode and copies", run, host_top=10, gaps=True,
                         counts=syncs)
    if busy is not None:
        print(f"device busy share: {busy:.3f} ms of kernel time against {1e3 * wall:.3f} ms "
              f"for an unprofiled run: {100 * busy / (1e3 * wall):.1f}% on [{smi}]")
    syncs_k4 = dict.fromkeys(syncs, 0)
    phase_profile("   the same two chunks with the boxed levels on K4's list form (the level "
                  "loop before K2's box mode)", run_k4, counts=syncs_k4)
    print("host events per chunk, K2 box form vs K4 list form: " + ", ".join(
        f"{key} {syncs[key] / 2:g} vs {syncs_k4[key] / 2:g}" for key in syncs))
    walls = {"K4 list": [], "K2 box": []}
    for label in ("K4 list", "K2 box", "K2 box", "K4 list"):
        fn = run_k4 if label == "K4 list" else run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls[label].append(time.perf_counter() - t0)
    print("two chunks through run_flow_stage, unprofiled, in turns: " + ", ".join(
        f"{label} {1e3 * statistics.mean(v):.3f} ms ({', '.join(f'{1e3 * t:.3f}' for t in v)})"
        for label, v in walls.items()) + f" on [{smi}]")
    if not syncs_k4["cudaStreamSynchronize"]:
        print("the profiler recorded no cudaStreamSynchronize: host syncs not counted")
    elif syncs["cudaStreamSynchronize"] >= syncs_k4["cudaStreamSynchronize"]:
        raise AssertionError("K2's box form did not remove K4's host syncs")


def _render_bilateral(n_frames, h, w, fps=HD_FPS, seed=3):
    """bench.render_clip's law for each blob (x_frac, f) of BI_BLOBS: centre
    x = w·x_frac + 40 e^(-0.05 t) sin(2π f t), y = h/2 + 18 e^(-0.05 t)
    cos(2π f·2.9/3 t), 150 × a Gaussian of 30 × 26 px, on one texture of
    N(0, 6) over 40."""
    rng = np.random.default_rng(seed)
    texture = 40 + rng.normal(0, 6, (h, w))
    xx = np.arange(w, dtype=np.float64)[None, :]
    yy = np.arange(h, dtype=np.float64)[:, None]
    frames = np.empty((n_frames, h, w), np.uint8)
    for i in range(n_frames):
        t, img = i / fps, texture.copy()
        for x_frac, f0 in BI_BLOBS:
            cx = w * x_frac + 40 * np.exp(-0.05 * t) * np.sin(2 * np.pi * f0 * t)
            cy = h * 0.5 + 18 * np.exp(-0.05 * t) * np.cos(2 * np.pi * f0 * 2.9 / 3.0 * t)
            img += 150 * np.exp(-(((yy - cy) / 26.0) ** 2)) * np.exp(-(((xx - cx) / 30.0) ** 2))
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def phase_bilateral(device, smi, rows):
    """BASELINE config 2: two ROIs on one 1080p recording through run_full
    under the JAX bench's flow config: the union boxes, one chunk's
    launches, both ROIs' boxed features against the full frame and the
    kernel path against the plain path on the first chunk, the 2-minute
    run_full, and each ROI's features, PC1 and metric row against a run
    with it alone (array_equal: each mask is reduced on its own)."""
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq, to_device
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage, run_full
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback as fb
    from btcs_pnes_optical_flow_tpu_torch.ops import farneback_cuda as fc
    from btcs_pnes_optical_flow_tpu_torch.ops.cvx import fill_poly_mask
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    h, w, n, rois = HD_H, HD_W, BI_FRAMES, list(BI_ROIS)
    cfg = PipelineConfig(flow=dataclasses.replace(FarnebackParams(), **BENCH_FLOW))
    print(f"== 16. BASELINE config 2: left/right ROIs, {n} frames of {h}x{w} (2 min at "
          f"{HD_FPS:g} fps), {BENCH_FLOW}, chunks of {HD_CHUNK} pairs")
    t0 = time.perf_counter()
    base = _render_bilateral(HD_BASE_FRAMES, h, w)
    print(f"two-blob base {base.shape} rendered in {time.perf_counter() - t0:.1f} s, played "
          f"forward and back; blobs (x/w, Hz) {BI_BLOBS}")
    masks = np.stack([fill_poly_mask(h, w, roi) for roi in rois])
    xs = [np.nonzero(m.any(0))[0] for m in masks]
    print(f"ROIs: x {xs[0].min()}..{xs[0].max()} and {xs[1].min()}..{xs[1].max()}, "
          f"{masks[0].sum()} and {masks[1].sum()} px, gap {xs[1].min() - xs[0].max() - 1} px")
    if (masks[0] & masks[1]).any() or not xs[0].max() < xs[1].min():
        raise AssertionError("the two ROIs overlap or touch")
    p = fb.roi_dispatch_params(cfg.flow, h, w, masks)
    print("the union of the two masks boxed per level (config 3's 1080p ROI: 43/58/82% of "
          "levels 0-2):")
    _box_shares(p, h, w)
    per_chunk = _launch_schedule(p, h, w, 1)
    fc.reset_launch_counts()
    run_flow_stage(_pingpong_source(base, HD_CHUNK + 1), _skeleton(HD_CHUNK + 1), rois, cfg,
                   HD_CHUNK, device=device)
    launches = dict(fc.LAUNCHES)
    print(f"launches of one {HD_CHUNK}-pair chunk through run_flow_stage: {launches} "
          f"(expected from the union boxes {per_chunk})")
    if launches != per_chunk or not launches["update_matrices_box_bf16"]:
        raise AssertionError("the bilateral chunk's launches differ from the union-box schedule")
    for name, count in launches.items():
        if count:
            rows[name]["bilateral_chunk_launches"] = count

    ex = np.tile(np.array([np.cos(THETA), -np.sin(THETA)], np.float32), (HD_CHUNK, 1))
    ey = np.tile(np.array([np.sin(THETA), np.cos(THETA)], np.float32), (HD_CHUNK, 1))
    frames, exd, eyd, masks_d = to_device(base[: HD_CHUNK + 1], ex, ey, masks, device)
    boxed, _ = roi_body_flow_seq(frames, exd, eyd, masks_d, p)
    full, _ = roi_body_flow_seq(frames, exd, eyd, masks_d, cfg.flow)
    d_roi = [max(float((a[:, r] - b[:, r]).abs().max()) for a, b in zip(boxed, full))
             for r in range(2)]
    print(f"ROI-dispatched vs full-frame features on the first chunk, left / right: max |d| "
          f"{d_roi[0]:.3e} / {d_roi[1]:.3e} px/frame (bar 0.0)")
    if d_roi != [0.0, 0.0]:
        raise AssertionError("bilateral ROI features differ from the full-frame ones")
    d = float((fb.farneback_flow_seq(frames, p)
               - fb.farneback_flow_seq(frames, p, kernels=False)).abs().max())
    print(f"kernel vs plain path on the union boxes, {HD_CHUNK} pairs: max |dflow| {d:.3e} px "
          f"(bar 0.0)")
    if d != 0.0:
        raise AssertionError("the bilateral kernel path disagrees with the plain path")
    del frames, exd, eyd, masks_d, boxed, full

    skel = _skeleton(n)
    n_chunks = -(-(n - 1) // HD_CHUNK)
    want = _launch_schedule(p, h, w, n_chunks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    timer = StageTimer(device)
    t0 = time.perf_counter()
    with _cascade_launches("the bilateral run_full's PC1 head, both ROIs"):
        flow, pc1, mets = run_full(_pingpong_source(base, n), skel, rois, cfg, HD_CHUNK,
                                   device=device, timer=timer)
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"run_full, both ROIs: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError("the bilateral run's launches differ from the union-box schedule")
    for name, count in launches.items():
        if count:
            rows[name]["bilateral_launches"] = count
    if (flow.vx.shape != (n, 2) or not np.isnan(flow.vx[0]).all()
            or not np.isfinite(flow.vx[1:]).all() or pc1.shape != (n, 2) or len(mets) != 2):
        raise AssertionError(f"features {flow.vx.shape}, PC1 {pc1.shape}, {len(mets)} metric "
                             "rows; NaN is expected at frame 0 only")
    if any(int(m.status) for m in mets) or (np.isfinite(pc1).sum(0) < n - 100).any():
        raise AssertionError(f"metric status {[int(m.status) for m in mets]}, finite PC1 "
                             f"{np.isfinite(pc1).sum(0)}")
    apart = min(float(np.abs(getattr(flow, nm)[1:, 0] - getattr(flow, nm)[1:, 1]).max())
                for nm in ("vx", "vy", "mag"))
    print(f"left vs right features: smallest max |d| over vx/vy/mag {apart:.4f} px/frame "
          "(a mask mix-up would make them equal)")
    if not apart > 1e-3:
        raise AssertionError("the two ROIs' features are equal")
    st = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"bilateral run_full: {wall:.4f} s, {n / wall:.2f} frames/s end to end "
          f"({n / timer.times['flow']:.2f} through the flow stage); stage seconds {st}; peak "
          f"device memory {peak:.2f} GiB on [{smi}]")
    for side, m in zip(("left", "right"), mets):
        print(f"metric row, {side}: " + ", ".join(
            f"{f} {float(getattr(m, f)):.6g}" for f in m._fields))

    for r, side in enumerate(("left", "right")):
        one, one_pc1, one_mets = run_full(_pingpong_source(base, n), skel, [rois[r]], cfg,
                                          HD_CHUNK, device=device)
        same = {nm: np.array_equal(getattr(flow, nm)[:, r], getattr(one, nm)[:, 0],
                                   equal_nan=True) for nm in ("vx", "vy", "mag")}
        same["pc1"] = np.array_equal(pc1[:, r], one_pc1[:, 0], equal_nan=True)
        same["metrics"] = all(np.array_equal(float(a), float(b), equal_nan=True)
                              for a, b in zip(mets[r], one_mets[0]))
        print(f"{side} ROI, the two-ROI run vs a run with it alone: array_equal {same}")
        if not all(same.values()):
            raise AssertionError(f"the {side} ROI's results depend on the other ROI")


def _texture(h, w, rng, shift=(0.0, 0.0)):
    """tests/test_torch_tvl1.py's texture, shifted by (x, y) px, with its
    own unit noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    xx, yy = xx + shift[0], yy + shift[1]
    img = (np.sin(xx / 6) * np.cos(yy / 7) + 0.6 * np.sin(xx / 11 + yy / 5)) * 55 + 128
    return np.clip(img + rng.normal(0, 1, (h, w)), 0, 255).astype(np.uint8)


@contextlib.contextmanager
def _eps_loop_spy(log):
    """Record each epsilon-loop call of ops/tvl1.py with epsilon > 0 (the
    plain pd_chain_plain, or tvl1_cuda.pd_eps_chain on the kernel path) as
    (level shape, iterations run, seconds): the plain loop's iterations
    counted by its divergence calls (two per iteration), the kernel path's
    by its ε-step launches, the seconds fenced by a synchronise on each
    side."""
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    chain, div, step = tv.pd_chain_plain, tv._div, tc.pd_eps_chain
    divs = [0]

    def counted_div(*args):
        divs[0] += 1
        return div(*args)

    def timed(fn, iterations):
        def spy(u, v, *args, epsilon=0.0):
            if epsilon <= 0:
                return fn(u, v, *args, epsilon=epsilon)
            torch.cuda.synchronize()
            n0 = iterations()
            t0 = time.perf_counter()
            out = fn(u, v, *args, epsilon=epsilon)
            torch.cuda.synchronize()
            log.append((tuple(u.shape[-2:]), iterations() - n0, time.perf_counter() - t0))
            return out

        return spy

    tv.pd_chain_plain, tv._div = timed(chain, lambda: divs[0] // 2), counted_div
    tc.pd_eps_chain = timed(step, lambda: tc.LAUNCHES["pd_eps_step"])
    try:
        yield
    finally:
        tv.pd_chain_plain, tv._div, tc.pd_eps_chain = chain, div, step


def _tv_clinical(h, w, eps_levels, device, smi, rows):
    """TV-L1 on TV_PAIRS pairs of render_clip(seed=2) at h x w: the engine
    table, launches, K5 and K6 at every level where they run against their
    plain versions and timed, the call against the plain path, the epsilon
    loop's iterations, syncs and share, frames/s and peak memory."""
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc

    p = tv.TVL1Params()
    tag = f"{h}x{w}"
    clip = render_clip(TV_PAIRS + 1, h, w, seed=2)
    prev = torch.as_tensor(clip[:-1], device=device)
    curr = torch.as_tensor(clip[1:], device=device)
    del clip
    sizes = tv._pyramid_sizes(h, w, p)
    on_eps = [k for k, s in enumerate(sizes) if not tv._resident_ok(*s, p)]
    print(f"-- {tag}, {TV_PAIRS} pairs: engines by level (_resident_ok at {p.n_iterations} "
          f"iterations): " + ", ".join(
              f"{k} {hh}x{ww} {'epsilon loop' if k in on_eps else 'K6'}"
              for k, (hh, ww) in enumerate(sizes)))
    if on_eps != eps_levels:
        raise AssertionError(f"{tag}: levels {on_eps} take the epsilon loop, not {eps_levels}")

    tv.tvl1_flow(prev, curr, p)  # warm-up (allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    flow = tv.tvl1_flow(prev, curr, p)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    flow_h = flow.cpu()
    host_s = time.perf_counter() - t0
    launches = dict(tc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chains = p.n_warps * (len(sizes) - len(on_eps))
    want = {"warp_sample": len(sizes) * p.n_warps, "pd_chain": chains,
            "pd_block": chains * len(tc.pd_schedule(p.n_iterations))}
    print(f"launches {launches} (expected {want}: {len(sizes)} levels x {p.n_warps} warps of "
          f"K5, K6 chains on the {len(sizes) - len(on_eps)} resident levels; at least one ε "
          f"step a warp on the {len(on_eps)} others)")
    steps = launches.pop("pd_eps_step")
    if (launches != want or not launches["warp_sample"] or not launches["pd_block"]
            or steps < p.n_warps * len(on_eps)):
        raise AssertionError(f"{tag}: TV-L1 launches differ from the schedule")
    rows["warp_sample"][f"tv_{tag}_launches"] = launches["warp_sample"]
    rows["pd_chain"][f"tv_{tag}_launches"] = launches["pd_block"]
    rows["pd_eps_step"][f"tv_{tag}_launches"] = steps
    if flow_h.shape != (TV_PAIRS, h, w, 2) or not torch.isfinite(flow_h).all():
        raise AssertionError(f"{tag}: flow {tuple(flow_h.shape)}, or not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = tv.tvl1_flow(prev, curr, p, kernels=False).cpu()
    plain_s = time.perf_counter() - t0
    d = float((flow_h - plain).abs().max())
    print(f"kernel vs plain path on the card: max |dflow| {d:.3e} px (bar {FLOW_TOL_PX}); "
          f"|flow| max {float(flow_h.abs().max()):.4f} px")
    if not d <= FLOW_TOL_PX:
        raise AssertionError(f"{tag}: the TV-L1 kernel path disagrees with the plain path")
    del plain

    flow_cf = flow.movedim(-1, 1).contiguous()
    del flow
    k5_tol = next(k for k in TV_KERNELS if k[0] == "warp_sample")
    k6_tol = next(k for k in TV_KERNELS if k[0] == "pd_chain")
    args = (p.n_iterations, p.tau, p.lambda_, p.theta)
    levels = {}
    for k in range(len(sizes)):
        src, planes = _tv_level_planes(prev, curr, flow_cf, k, p)
        fl = torch.stack(planes[:2], 1)
        px = planes[0].numel()
        name, kid, replaces, tol, why = k5_tol
        row = _check_and_time(name, kid, TV_SOURCE, replaces,
                              lambda: tc.warp_sample_cf(src, fl),
                              lambda: tv.warp_sample_cf_plain(src, fl),
                              rtol=tol, abs_tol=None, why=why, reps=TV_REPS)
        bound, by = _bound(px, *_k5_cost(src.shape[1]))
        entry = {"shape": list(planes[0].shape), "k5_ms": row["ms"], "k5_plain_ms":
                 row["plain_ms"], "k5_bound_ms": bound, "k5_max_abs_err": row["max_abs_err"]}
        if k == 0:
            entry["k5_library_ms"] = _k5_yardstick(src, fl, TV_REPS)
        print(f"  level {k} {tuple(planes[0].shape)}: K5 bound {bound:.4f} ms by {by}, share "
              f"{100 * bound / row['ms']:.1f}%")
        if k in on_eps:
            print(f"  level {k}: no K6 (the epsilon loop)")
        else:
            name, kid, replaces, tol, why = k6_tol
            row = _check_and_time(name, kid, TV_SOURCE, replaces,
                                  lambda: tc.pd_chain(*planes, *args),
                                  lambda: tv.pd_chain_plain(*planes, *args),
                                  rtol=None, abs_tol=tol, why=why, reps=TV_REPS)
            bound, by = _bound(px, *_k6_cost(p.n_iterations))
            entry.update(k6_ms=row["ms"], k6_plain_ms=row["plain_ms"], k6_bound_ms=bound,
                         k6_max_abs_err=row["max_abs_err"])
            print(f"  level {k}: K6 bound {bound:.4f} ms by {by}, share "
                  f"{100 * bound / row['ms']:.1f}% per chain")
        levels[k] = entry
        del src, planes, fl
    rows["warp_sample"][f"tv_{tag}_levels"] = levels
    del flow_cf

    log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _eps_loop_spy(log):
        tv.tvl1_flow(prev, curr, p)
    torch.cuda.synchronize()
    spy_s = time.perf_counter() - t0
    for k in on_eps:
        its = [n for shape, n, _ in log if shape == sizes[k]]
        ms = [1e3 * s for shape, _, s in log if shape == sizes[k]]
        print(f"epsilon loop, level {k} {sizes[k]}: iterations by warp {its} of "
              f"{p.n_iterations} (epsilon {p.epsilon}), ms by warp {[round(x, 2) for x in ms]}")
    eps_s = sum(s for *_, s in log)
    if len(log) != p.n_warps * len(on_eps):
        raise AssertionError(f"{tag}: {len(log)} epsilon-loop calls recorded")
    counts = dict.fromkeys(("cudaStreamSynchronize", "aten::_local_scalar_dense"), 0)
    busy = phase_profile(f"   {tag}: device time by kernel, one tvl1_flow call", lambda:
                         tv.tvl1_flow(prev, curr, p), counts=counts)
    n_its = sum(n for _, n, _ in log)
    print(f"epsilon loop: {n_its} iterations in {len(log)} calls, {eps_s:.4f} s of a "
          f"{spy_s:.4f} s call fenced around each of them ({100 * eps_s / spy_s:.1f}%); host "
          f"events in one unfenced call: {counts} (one read-back per iteration expected)")
    busy_text = (f", device busy {busy:.3f} ms ({100 * busy / (1e3 * card_s):.1f}% of the call)"
                 if busy is not None else "")
    print(f"TV-L1 {tag}: {TV_PAIRS} pairs in {host_s:.4f} s with the flow copied to the host "
          f"({TV_PAIRS / host_s:.2f} frames/s), {card_s:.4f} s on the card, fenced "
          f"({TV_PAIRS / card_s:.2f} frames/s){busy_text}; plain path {plain_s:.4f} s; peak "
          f"device memory {peak:.2f} GiB on [{smi}]")
    rows["pd_chain"][f"tv_{tag}_eps"] = {"iterations": n_its, "calls": len(log),
                                         "share": eps_s / spy_s}


def phase_tvl1_clinical(device, smi, rows):
    """BASELINE config 5: TV-L1 at 720x1280 and 1080x1920 (_tv_clinical),
    the card against the CPU where level 0 takes the epsilon loop, and the
    translation of a textured 1080p frame."""
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv

    p = tv.TVL1Params()
    print(f"== 17. BASELINE config 5: TV-L1 at {' and '.join(f'{h}x{w}' for h, w in TV_CLINICAL)}"
          f", {p}")
    for (h, w), eps_levels in TV_CLINICAL.items():
        t0 = time.perf_counter()
        _tv_clinical(h, w, eps_levels, device, smi, rows)
        torch.cuda.empty_cache()
        print(f"{h}x{w}: {time.perf_counter() - t0:.1f} s")

    h, w = TV_EPS_SIZE
    pr = dataclasses.replace(p, pd_engine="resident")
    if tv._resident_ok(h, w, pr):
        raise AssertionError(f"level 0 of {h}x{w} does not take the epsilon loop")
    small = render_clip(3, h, w, seed=2)
    f_cpu = tv.tvl1_flow(torch.as_tensor(small[:-1]), torch.as_tensor(small[1:]), pr)
    f_gpu = tv.tvl1_flow(torch.as_tensor(small[:-1], device=device),
                         torch.as_tensor(small[1:], device=device), pr).cpu()
    d = float((f_cpu - f_gpu).abs().max())
    print(f"card vs CPU, 2 pairs of {h}x{w} (level 0 on the epsilon loop, pd_engine "
          f"'resident' on both): max |dflow| {d:.3e} px (bar {FLOW_TOL_PX}; the CPU's torch.sqrt "
          f"is not correctly rounded, and the loop's mean is taken in another order, so its "
          f"exit may move by an iteration)")
    if not d <= FLOW_TOL_PX:
        raise AssertionError("TV-L1 on the card disagrees with the CPU")

    h, w = max(TV_CLINICAL)
    rng = np.random.default_rng(0)
    f0 = torch.as_tensor(_texture(h, w, rng), device=device)
    f1 = torch.as_tensor(_texture(h, w, rng, shift=TV_SHIFT), device=device)
    inner = tv.tvl1_flow(f0, f1, p).cpu().numpy()[12:-12, 12:-12]
    # I1 sampled at x + flow matches I0: the flow is minus the shift.
    epe = float(np.sqrt((inner[..., 0] + TV_SHIFT[0]) ** 2
                        + (inner[..., 1] + TV_SHIFT[1]) ** 2).mean())
    print(f"translation by {TV_SHIFT} px of a textured {h}x{w} frame: interior EPE {epe:.4f} "
          f"px (bar < {TV_EPE_PX})")
    if not epe < TV_EPE_PX:
        raise AssertionError("TV-L1 misses the 1080p translation")


def _tvl1_run_full(base, n, cfg, device, timer=None):
    """run_full over n frames of ``base`` played forward and back, the
    1080p ROI, axes at THETA, TV_RUN_CHUNK-pair chunks."""
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_full

    return run_full(_pingpong_source(base, n), _skeleton(n), [HD_ROI], cfg, TV_RUN_CHUNK,
                    device=device, timer=timer)


def phase_tvl1_run_full(device, smi, rows):
    """BASELINE config 5 through run_full under PipelineConfig(flow=
    TVL1Params()) at 1080p in chunks of 16 pairs: the TV-L1 launches
    against the per-chunk schedule and the PC1 head's cascade launches,
    the features against the same run on the plain path, PC1 beside it,
    and K5's device time per pyramid level in a profiled run_flow_stage
    beside phase 17's event timings."""
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.config import PipelineConfig
    from btcs_pnes_optical_flow_tpu_torch.models import flow as fm
    from btcs_pnes_optical_flow_tpu_torch.models.pipeline import run_flow_stage
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1 as tv
    from btcs_pnes_optical_flow_tpu_torch.ops import tvl1_cuda as tc
    from btcs_pnes_optical_flow_tpu_torch.utils.timing import StageTimer

    h, w, n, chunk = HD_H, HD_W, TV_RUN_FRAMES, TV_RUN_CHUNK
    p = tv.TVL1Params()
    cfg = PipelineConfig(flow=p)
    print(f"== 18. BASELINE config 5 through run_full: {n} frames of {h}x{w}, the 1080p ROI, "
          f"TVL1Params(), chunks of {chunk} pairs")
    base = render_clip(TV_RUN_BASE, h, w, seed=1)
    sizes = tv._pyramid_sizes(h, w, p)
    fixed = [k for k, s in enumerate(sizes) if tv._resident_ok(*s, p)]
    per_chunk = {"warp_sample": len(sizes) * p.n_warps, "pd_chain": len(fixed) * p.n_warps,
                 "pd_block": len(fixed) * p.n_warps * len(tc.pd_schedule(p.n_iterations))}
    if per_chunk != {"warp_sample": 15, "pd_chain": 5, "pd_block": 20}:
        raise AssertionError(f"the 1080p TV-L1 schedule is not 15 K5 / 5 K6 chains of 4 "
                             f"launches: {per_chunk}")
    n_chunks = -(-(n - 1) // chunk)
    want = {k: v * n_chunks for k, v in per_chunk.items()}
    eps_calls = (len(sizes) - len(fixed)) * p.n_warps * n_chunks  # one ε loop a warp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer(device)
    with _cascade_launches("run_full's PC1 head under TV-L1"):
        tc.reset_launch_counts()
        t0 = time.perf_counter()
        flow, pc1, mets = _tvl1_run_full(base, n, cfg, device, timer)
        wall = time.perf_counter() - t0
        launches = dict(tc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = launches.pop("pd_eps_step")
    print(f"launches {launches} (expected {want}: {n_chunks} chunks, the tail padded, of "
          f"{per_chunk}); ε steps {steps} in {eps_calls} ε loops ({steps / eps_calls:.3f} a "
          f"loop, at least 1)")
    if launches != want or steps < eps_calls:
        raise AssertionError("run_full's TV-L1 launches differ from the per-chunk schedule")
    rows["warp_sample"]["tv_run_full_launches"] = launches["warp_sample"]
    rows["pd_chain"]["tv_run_full_launches"] = launches["pd_block"]
    rows["pd_eps_step"]["tv_run_full_launches"] = steps
    if (flow.vx.shape != (n, 1) or not np.isnan(flow.vx[0]).all()
            or not np.isfinite(flow.vx[1:]).all() or pc1.shape != (n, 1) or len(mets) != 1):
        raise AssertionError(f"features {flow.vx.shape}, PC1 {pc1.shape}, {len(mets)} metric "
                             "rows; NaN is expected at frame 0 only")
    st = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"run_full under TV-L1: {wall:.4f} s, {n / wall:.2f} frames/s end to end (first "
          f"call: allocator warm-up inside); stage seconds {st}; peak device memory {peak:.2f} "
          f"GiB on [{smi}]")

    kernel_flow = fm.tvl1_flow
    fm.tvl1_flow = functools.partial(kernel_flow, kernels=False)
    try:
        tc.reset_launch_counts()
        t0 = time.perf_counter()
        plain, plain_pc1, _ = _tvl1_run_full(base, n, cfg, device)
        plain_s = time.perf_counter() - t0
        plain_launches = dict(tc.LAUNCHES)
    finally:
        fm.tvl1_flow = kernel_flow
    if any(plain_launches.values()):
        raise AssertionError(f"the plain run launched TV-L1 kernels: {plain_launches}")
    d = max(float(np.abs(getattr(flow, c)[1:] - getattr(plain, c)[1:]).max())
            for c in ("vx", "vy", "mag"))
    fin = np.isfinite(pc1[:, 0]) & np.isfinite(plain_pc1[:, 0])
    if fin.sum() < 3:
        raise AssertionError(f"{int(fin.sum())} finite PC1 samples")
    corr = float(np.corrcoef(pc1[fin, 0], plain_pc1[fin, 0])[0, 1])
    print(f"kernel vs plain path through run_full ({plain_s:.1f} s): features max |d| "
          f"{d:.3e} px/frame (bar {FLOW_TOL_PX}); PC1 max |d| "
          f"{float(np.abs(pc1[fin, 0] - plain_pc1[fin, 0]).max()):.3e}, corr {corr:.9f} over "
          f"{int(fin.sum())} samples (bar {PC1_CORR})")
    if not d <= FLOW_TOL_PX:
        raise AssertionError("run_full's TV-L1 kernel path disagrees with the plain path")
    if not corr >= PC1_CORR:
        raise AssertionError("run_full's TV-L1 PC1 disagrees with the plain path's")

    # K5's device time per level in a profiled run_flow_stage: each chunk
    # launches n_warps K5 a level, coarsest level first.
    from torch.profiler import ProfilerActivity, profile

    m = TV_RUN_PROFILED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_flow_stage(_pingpong_source(base, m), _skeleton(m), [HD_ROI], cfg, chunk,
                       device=device)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    k5 = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if getattr(e, "device_type", None) == cuda and "warp_sample_kernel" in e.name)
    if not k5:
        print("profiler recorded no K5 launch; no per-level reading")
        return
    n_prof = -(-(m - 1) // chunk) * per_chunk["warp_sample"]
    if len(k5) != n_prof:
        raise AssertionError(f"the profiler recorded {len(k5)} K5 launches, not {n_prof}")
    per_level = {k: [] for k in range(len(sizes))}
    for i, (s, e) in enumerate(k5):
        per_level[len(sizes) - 1 - (i % per_chunk["warp_sample"]) // p.n_warps].append(e - s)
    events = rows["warp_sample"].get(f"tv_{h}x{w}_levels", {})
    total_bound = total_ms = 0.0
    traced = {}
    for k, us in per_level.items():
        bound, _ = _bound(chunk * sizes[k][0] * sizes[k][1], *_k5_cost(3))
        ms = statistics.median(us) / 1e3
        total_bound += bound * len(us)
        total_ms += sum(us) / 1e3
        ev = events.get(k, {}).get("k5_ms")
        traced[k] = {"ms": ms, "bound_ms": bound, "share": bound / ms}
        print(f"  K5 at level {k} {sizes[k]}: {len(us)} launches, median {ms:.4f} ms in the "
              f"trace, share {100 * bound / ms:.1f}% of its bound {bound:.4f} ms; phase 17's "
              f"CUDA-event median " + (f"{ev:.4f} ms ({100 * bound / ev:.1f}%)" if ev else
                                       "not taken"))
    print(f"  K5 over the profiled call: {100 * total_bound / total_ms:.1f}% of its bound "
          f"(the benchmark's k5_roofline reads this way: the bound over the trace's kernel time)")
    rows["warp_sample"]["tv_run_full_traced_levels"] = traced


def main():
    smi = phase_device()
    from bench import render_clip
    from btcs_pnes_optical_flow_tpu_torch.config import FarnebackParams, check_supported

    device = torch.device("cuda", 0)
    params = check_supported(FarnebackParams())
    phase_build()
    t0 = time.perf_counter()
    clip = render_clip(N_PAIRS + 1)
    print(f"bench clip {clip.shape} rendered in {time.perf_counter() - t0:.1f} s")
    rows, flow_plain, box0 = phase_kernels(clip, params, device)
    phase_kernels_main(clip, params, device, rows, box0)
    phase_cascade(device, smi, rows)
    chunk, exd, eyd, masks, full_feats = phase_slice(clip, params, device, smi, rows,
                                                     flow_plain)
    from btcs_pnes_optical_flow_tpu_torch.models.flow import roi_body_flow_seq
    from btcs_pnes_optical_flow_tpu_torch.ops.tvl1 import tvl1_flow

    phase_profile("== 5. device time by kernel, one chunk",
                  lambda: roi_body_flow_seq(chunk, exd, eyd, masks, params))
    tv_clip = render_clip(TV_PAIRS + 1, seed=2)
    tv_rows, tv_flow_plain = phase_tvl1_kernels(tv_clip, device)
    prev, curr, tv_params, tv_wall = phase_tvl1_slice(tv_clip, device, smi, tv_rows,
                                                      tv_flow_plain)
    tv_busy = phase_profile(f"== 7b. TV-L1 device time by kernel, {TV_PAIRS} pairs",
                            lambda: tvl1_flow(prev, curr, tv_params), host_top=10)
    if tv_busy is not None:
        print(f"TV-L1 device busy share: {tv_busy:.3f} ms of kernel time in one call against "
              f"{1e3 * tv_wall:.3f} ms on the card (fenced) in phase 7's unprofiled call: "
              f"{100 * tv_busy / (1e3 * tv_wall):.1f}% on [{smi}]")
    rows.update(tv_rows)
    flow_p, pc1_fp32 = phase_pipeline(clip, device, smi, rows, full_feats)
    phase_profile("== 8b. device time by kernel, one ROI-dispatched chunk",
                  lambda: roi_body_flow_seq(chunk, exd, eyd, masks, flow_p))
    del chunk, exd, eyd, masks
    out = {}
    for number, run in ((9, lambda: phase_cohort(device, smi, rows)),
                        (10, lambda: phase_compat(clip, device, smi)),
                        (11, lambda: phase_pc1_engines(device, smi, full_feats)),
                        (12, lambda: phase_bench_config(clip, device, smi, rows, pc1_fp32)),
                        (13, lambda: phase_sharded(clip, device, smi, rows)),
                        (14, lambda: phase_metric_head(device, smi, *out[9])),
                        (15, lambda: phase_hd(device, smi, rows)),
                        (16, lambda: phase_bilateral(device, smi, rows)),
                        (17, lambda: phase_tvl1_clinical(device, smi, rows)),
                        (18, lambda: phase_tvl1_run_full(device, smi, rows))):
        t0 = time.perf_counter()
        out[number] = run()
        print(f"phase {number}: {time.perf_counter() - t0:.1f} s")
    names = [name for name, *_ in KERNELS + TV_KERNELS + FLT_KERNELS]
    print(json.dumps({"kernels": [rows[name] for name in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
