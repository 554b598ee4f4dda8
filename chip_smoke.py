#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (plslam_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card: name, count, ``nvidia-smi`` name and power limit;
  2. build the hand-written CUDA kernels from ``plslam_tpu_torch/csrc``
     (one nvcc per source, all started together);
  3. every kernel, in every mode the paths launch it, at the paths'
     shapes, compared with its plain PyTorch version on the same inputs on
     the card, timed with CUDA events (the wrapper: host work included)
     and with torch.profiler (the kernels' own device time), beside its
     bound, its plain version's time and a one-call library yardstick: A-C
     on KITTI-size images (376x1241, 40 images a chunk; the blur at the
     four pyramid levels and ORB's moment pair at their four half-res
     levels, the resize to 1/1.2 and 1/2, FAST and its NMS at the four
     pyramid levels; K=1024), D's
     matcher (hamming_scan + hamming_finish) under the stereo gate and
     the f2f window at 20 x 1024 x 1024, the line kernels E-H at both
     detector scales (E's one launch also bit for bit against the chain
     it replaced, whose launches stay as "before" rows; G also as the
     whole refit_roots and merge_segments calls) and D under a mask at 20 x 128 x 128, then I (K13:
     its phase-only form, a GN phase of 20 pairs with and without lines;
     the whole optimize_pose, one launch, at 20 pairs with and without
     lines, the lite pass, one pair, and lines only (K = 0 point terms) at
     20 pairs and one, every PoseResult field held: T,
     the covariance against float64, err, and the decisions exactly or
     within 1e-4 of their threshold; its LM mode, optimize_pose_lm, at 20
     pairs with and without lines, one pair and lines only, also its
     accept sequence and lambda: ``lm_rows``; counted apart, as
     ``pose_gn_optimize@lm``, and 0 on the paths, which never call it), J
     (K14: a chunk's keyframe scan; K16: the 8192 and 1024 landmark
     rings) and D at the map matching's 8192 x 1024 and 1024 x 128; at
     each of D's shapes the
     matrix-based hamming_dist + hamming_match it replaced, on the same
     inputs, as the "before" (no path launches them);
  4. the paths: the flagship point+line chunked VO (``BatchedStereoVO``,
     default ``SlamConfig()``, bench.py's scene: a warm-up chunk, then
     initialize + 2 chunks of 20 frames), the points-only VO the same way,
     the port on the card against its CPU run on two small scenes, then
     the fused SLAM chunk without loop closure (``FusedPLSLAM``,
     ``loop.enabled=False``, bench_slam.py's scene at 1241x376 cut to 1 + 5
     x 20 frames of device-resident uint8 chunks): every frame tracked, ATE
     and keyframes against the CPU run, at least one LBA slot, no LBA
     raising its cost, a map of points and lines, each kernel launched
     exactly as often as the path launches it; then K (K15) launch by
     launch (the landmark index exact; lba_terms' scale, an exact lower
     median, to the bit, also at K = 4096, more than 32,768
     observations), the step after the blocks (``lba_solve``: Schur
     complement, dense solve and landmark steps in two kernels, held to
     float64 and bit-equal launch to launch), one LM step and one whole
     ``run_lba`` on a well-conditioned window problem at the path's
     shapes, and the step and one whole ``run_lba`` on that run's final
     window problem (each ``run_lba`` a replay of its CUDA graph, bit-equal
     to the eager loop of kernels);
  5. the loop path: ``FusedPLSLAM`` with the default ``SlamConfig()``
     (loop closure on) over two laps of a 110-frame loop with
     bench_slam.py's world (``loop_scene``: bench_slam.py's own scene
     closes no loop in the port's runs), 1 + 11 x 20 device-resident uint8
     frames: every frame tracked, at least one closure, keyframes, loop
     events and the funnel against the CPU run, the ATE bound, each kernel
     launched exactly as often as the run's own keyframes, LBA slots,
     verifications, closures and graph solves say; again with the graph
     solve at every closure if no closure cleared the lazy floors, and
     with the PCG solver after the kernels below (each run held against
     its own CPU run); L (K17) on a keyframe of
     that run against the real vocabularies, D at the verification shapes,
     the covisibility gather (K7) and M (K18) launch by launch at Fb = 64
     and 512 (the edge sweep, ``pg_edges`` in both modes and
     ``pg_update`` with and without each order's gradient, ``pg_blocks``
     also at 1,024, and ``pg_pcg`` at all five slot buckets, a cluster of
     16 CTAs at 1,024, with their grids), what ``pg_update`` hands
     on against ``pg_edges``, a rejected step, the library's LU, solve and
     inverse at the solves' sizes, the whole dense and PCG solves against
     float64 and bit for bit against the loop that assembles and solves
     every step (as every solve of the loop runs); then the loop path
     checkpointed after 6 of its 11 chunks and resumed in a new driver
     (the BoW rows rebuilt bit-equal, L launched once a family and
     keyframe; held to a run drained at the same point and to the loop
     run: ``checkpoint_phase``), and KF-slot compaction with pressure
     eviction and closures on tests/test_compact_loops.py's scene
     (512x320, points only, max_kfs 64, 281 frames) held to the port's CPU
     run (``compact_phase``, ``COMPACT_CPU``);
  6. the dataset paths, from files written to a temporary directory: the
     app (``apps/plstvo_dataset.py``) over bench.py's scene as a
     KITTI-layout directory of PNGs (every row filter) at 1241x376,
     chunked (B = 20; equal to the in-memory ``BatchedStereoVO`` on the
     same uint8 frames) and per frame (within 5 mm of chunked); an
     EuRoC-layout raw rig (752x480, radial-tangential, a rotated cam1)
     into the per-frame ``StereoVO`` through the reader's host
     rectification and through ``StereoRectifier`` (N, one launch a pair),
     the two rectifications equal where every tap is inside; every frame
     tracked, ATE bounds, exact launches; N at 752x480 and 1241x376
     against its plain version (bit-equal) and ``F.grid_sample``; the
     SLAM app (``apps/plslam_dataset.py --chunk 20``) over the
     KITTI-layout directory, equal to ``FusedPLSLAM`` in memory on the
     same uint8 frames, and its ``--checkpoint`` / ``--resume`` equal to
     its uninterrupted run (``slam_app_runs``); then the fused SLAM driver
     past ``max_kfs``: bench_slam_long.py's 4,001-frame circuit (10 laps
     of 400 frames, default ``SlamConfig()`` with min_entropy_ratio 0.89,
     one lap rendered by 8 processes and replayed from the card): every
     frame, at most max_kfs keyframes, at least 2 compactions, 8 evicted
     keyframes and 5 closures, the path within 5 circuit radii, no
     tripwire, exact launches; fps, ms per compaction, peak memory, ATE
     overall and per lap (``long_phase``); then the same frames with
     max_kfs 1,024 (the reference's provisioned run): no compaction, a
     graph solve at the 1,024-slot bucket, the same floors. Before the
     circuit, after every phase that reads torch.profiler: the lines-only
     VO (``[lines_only]``: on bench.py's frames, where too few stereo
     lines pass the pose gate, and on the lines scene, chunked and per
     frame; the app's ``--no-points`` runs in the dataset phase) and scan
     mode (``[scan]``: point+line and lines-only), each held to its CPU
     run;
  6c. ``[dist]``, the distributed back end (``parallel/``), in a process
     of its own (``python3 chip_smoke.py --dist``; ``dist_phase``), its
     shards on cuda:0: (a) on ``lba_window_problem`` cut into 2 and 4
     owner shards, every K15 launch of the sharded step on every shard
     against its plain version (lba_schur_corr and lba_solve_reduced, the
     two halves of lba_solve around the collective, by K15's rule, timed
     as JSON rows at 4 shards), the sharded LM's exact launches, its
     states held to the plain versions in float32 and float64 and to the
     CPU run, by direction to run_lba, one step's collectives
     (``comm_bytes_per_step``); (b) ``PLSLAM`` with mapping.distributed
     (4 shards) on tests/test_dist_lba.py's 25-frame scene against the
     single-device run (the slice's main path: its launches join the JSON
     line); (c) loop.distributed on tests/test_dist_vocab.py's 40-frame
     loop scene, the same loop events and keyframes, with PLSLAM,
     FusedPLSLAM (one compaction) and ChunkedPLSLAM; (d)
     ``apps/plslam_multiseq.py --synthetic --distributed``; (e)
     ``parallel/multihost_check.py`` in two processes joined by gloo
     against the in-process 4-shard mesh;
  6d. ``[vocab]``, in a process of its own (``python3 chip_smoke.py
     --vocab``; ``vocab_phase``): the trainer's corpus of 4 scenes a
     family on the card against the CPU's, both vocabularies trained at
     the reference's full corpus, tests/test_vocab_quality.py's
     assertions on them and on the tracked ones, and whether the ORB
     artifact is the tracked one's bytes; after the dataset phase,
     ``[slam_system]``'s PLSLAM sync with and without ``PLSLAM_LC_DEBUG``
     (the staged closure, ``lc_debug_rerun``);
  7. one JSON line of the kernels (launches from the first path run that
     launched each; 0 for the "before" rows and the LM mode, marked
     ``no_path_caller``), then the card line, then the result.

``python3 chip_smoke.py --cpu-ate [vo] [slam] [loops] [pcg] [dataset]
[compact] [lines_only] [scan] [dist]`` runs the paths' frames through the
plain versions on the CPU: the calibration of the ATE, line-count,
keyframe, loop and compaction bounds below (no part named: all; ``pcg``:
the PCG loop run alone; ``compact``: the COMPACT_CPU record;
``lines_only`` and ``scan``: the LINES_ONLY_CPU and SCAN_CPU records;
``dist``: the sharded LM's CPU run, which ``[dist]`` computes itself).
``python3 chip_smoke.py --edge-grids`` prints the grids the profiler sees
of K18's ``pg_edges`` and ``pg_update``, ``--chunk-device-times`` a VO
chunk's device time in each configuration and mode, and ``--pose-graph``
runs ``pose_graph_phase`` and prints its kernel rows (the main run calls
each in a process of its own).
``python3 chip_smoke.py --bench-slam [cuda] [cpu]`` runs bench_slam.py's
own 201-frame scene through the loop path on each device named and
compares their keyframe decisions (``bench_slam_scene``).
``python3 chip_smoke.py --against DIR`` holds this tree's level-0 blur,
ORB's moment pair, FAST score, resize, LBA terms, scale and cost, K13's
GN phase and whole optimize_pose at 20 pairs (and at phase 3's other
whole-call shapes), K2's NMS block max at
level 0, kernel G (refit_roots and merge_segments at both detector
scales), K12's bits (from the half-res images, or a parent's Sobel launch
and lbd_describe; and on given Sobel maps), K14's kf_scan, K15's
landmark index, camera blocks, step and run_lba (and K15's bits of
lba_camera, lba_solve capped and not and run_lba eager and replayed, at
the window and its K = 256 cut: ``k15_bits``), K16's medoid rows, K17's
descent and histogram and K18's normal equations (bit for bit), edge
sweep, PCG and whole solves
against those of another checkout at DIR (for example a ``git archive``
of the parent
commit): outputs and device times (most also every device kernel's,
torch's too, and the wrapper's), and the device kernels of one point
front end (``against``); then K18's solves as the loop closer meets them
on each tree, in processes of their own: the first four calls of each
solver in a fresh process, and the loop path alone (``solve_calls``).

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

import numpy as np

try:
    # the card's peak rates (HBM, f32, int8) and the profiler's records
    from plslam_tpu_torch.utils.devtime import (all_kernels, cuda_ms,
                                                profile_device)
    from plslam_tpu_torch.utils.flops import (F32_OPS_PER_S,
                                              HBM_BYTES_PER_S,
                                              INT8_OPS_PER_S)
except ImportError as e:
    print(f"FAIL: run from the repository root, with PyTorch ({e})",
          file=sys.stderr)
    sys.exit(2)
# __popc: 16 results a clock per SM (the CUDA C++ programming guide's
# arithmetic-instruction throughput table, compute capability 9.0) x 132
# SMs x the H100 SXM's 1.98 GHz boost clock: the floor of the popcount
# algorithm on the CUDA cores, printed beside the card's bound
POPC_PER_S = 16 * 132 * 1.98e9
# f32 and integer instructions outside the tensor cores: 128 lane-operations
# a clock an SM (64 of the lanes also do integer work) x 132 SMs x
# 1.98 GHz. The floor of work that is not fused multiply-adds.
LANE_OPS_PER_S = 128 * 132 * 1.98e9
# The least work of FAST-16 at two thresholds a pixel: per tap a difference,
# 4 threshold tests, 4 bit accumulations into the masks, 2 clamps and 2 sums
# (16 x 13), 4 arc tests, 2 ORs and the score's max: 145 f32 and 70
# integer operations, bound by the instruction rate (the 70 on the 64
# integer lanes take less time than the 215 on all 128)
FAST_OPS = 16 * 13 + 4 + 2 + 1
# entry points whose C code issues a cudaMemsetAsync of its own (counted in
# their device time)
OWN_MEMSETS = {"hamming_scan"}

# ATE bounds of the main paths (m). The port's own CPU run of the same
# scenes and frames (``python3 chip_smoke.py --cpu-ate``: the plain
# versions, device="cpu") measured the *_CPU_MEASURED values; each bound
# leaves a margin of 2x plus 2 cm.
ATE_CPU_MEASURED = 0.012123057406343597          # points only
ATE_BOUND = 0.045
ATE_LINES_CPU_MEASURED = 0.014925030152169932    # point + line (flagship)
ATE_LINES_BOUND = 0.05
# fewest valid stereo lines, and fewest line terms among the pose's
# inliers, in any frame of the flagship path (``ChunkOutput.n_lines``,
# ``n_line_inliers``): the same CPU run's minima (medians 15.5 and 6),
# halved and rounded up
MIN_LINES_CPU_MEASURED = 10
MIN_LINES = 5
MIN_LINE_INLIERS_CPU_MEASURED = 3
MIN_LINE_INLIERS = 2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, memsets: bool = False, iters: int = 10) -> float:
    """Mean device time a call of ``fn`` spends in the hand-written
    kernels (and, with ``memsets``, in the memsets that the entry's own C
    code issues): the kernels' own time, apart from the host's launch path
    that ``cuda_ms`` includes whenever the host is the slower side."""
    from plslam_tpu_torch import native
    return profile_device(fn, lambda k: native.is_own_kernel(k)
                          or (memsets and "Memset" in k), iters)[0]


def launched_grid(fn, kernel: str, tries: int = 6):
    """(grid, block) of a device record of ``kernel`` in a torch.profiler
    trace of three calls of ``fn``, or None where no trace holds such a
    record or gives them; up to ``tries`` traces, as the profiler may lose
    a short kernel's records."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        for ev in trace.get("traceEvents", []):
            args = ev.get("args") or {}
            if ev.get("cat") == "kernel" and kernel in ev.get("name", "") \
                    and "grid" in args:
                return args["grid"], args.get("block")
    return None


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    import torch
    if a.numel() == 0 and b.numel() == 0:     # (B, 0) masks: no entries
        return 0.0
    if a.dtype == torch.bool or not a.is_floating_point():
        return float((a.long() - b.long()).abs().max().item())
    a, b = a.double(), b.double()
    # equal infinities (the -inf padding of block maxima) differ by 0
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max().item())


class Recorder:
    """Rows of the kernels JSON line: agreement, times and bound."""

    def __init__(self):
        self.rows = []

    def __call__(self, name, source, replaces, got, plain, tol, fn, plain_fn,
                 nbytes, ops, library_fn=None, iters=20, entry=None,
                 err_kind="absolute", ops_per_s=F32_OPS_PER_S, before=False,
                 popc_ops=None, library_what=None, errs=None, cluster=None,
                 count=None, no_path_caller=False):
        """``tol`` is one tolerance for every output, or a list of one per
        output (``err_kind`` then names the unit of each). ``errs``: the
        errors, measured by the caller, in place of the largest absolute
        difference of each of ``got`` from ``plain``. ``before``: a
        kernel that a redesign replaced, kept with no main-path caller and
        timed on the same inputs as its successor. ``popc_ops``: the
        popcounts of the CUDA-core algorithm, whose floor the row also
        gives (``popc_bound_ms``) beside the card's bound.
        ``library_what``: what ``library_fn`` computes where that is less
        than the whole function. ``cluster``: the CTAs of a kernel launched
        as a thread-block cluster. ``count``: the key its launches count
        under in ``native.LAUNCHES`` (``entry@mode``; default the entry).
        ``no_path_caller``: a mode that no path launches (its launches 0,
        held so)."""
        if errs is None:
            errs = [max_abs_err(g, p) for g, p in zip(got, plain)]
        tols = (list(tol) if isinstance(tol, (list, tuple))
                else [tol] * len(errs))
        err = max(errs)
        ok = all(e <= t for e, t in zip(errs, tols))
        ms = cuda_ms(fn, iters)
        dev_ms = device_ms(fn, (entry or name) in OWN_MEMSETS)
        plain_ms = cuda_ms(plain_fn, max(iters // 4, 3))
        lib_ms = cuda_ms(library_fn, iters) if library_fn else None
        b_ms, b_by = bound(nbytes, ops, ops_per_s)
        popc_ms = None if popc_ops is None else popc_ops / POPC_PER_S * 1e3
        self.rows.append(dict(
            name=name, entry=entry or name, count=count or entry or name,
            no_path_caller=no_path_caller, route="cuda", source=source,
            replaces=replaces, max_abs_err=err, errs=errs, tols=tols,
            err_kind=err_kind, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ok=ok,
            before=before, **({} if popc_ms is None
                              else {"popc_bound_ms": popc_ms}),
            **({} if library_what is None
               else {"library_what": library_what}),
            **({} if cluster is None else {"cluster": cluster})))
        print(f"[kernel] {name}{' (before: replaced)' if before else ''}"
              f": max_abs_err={err:g} per output "
              f"{[f'{e:g}' for e in errs]} ({err_kind}; tol "
              f"{[f'{t:g}' for t in tols]}) kernel_ms={ms:.4f} "
              f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              + ("" if popc_ms is None else f"popc_bound_ms={popc_ms:.4f} ")
              + f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'}"
              + ("" if library_what is None else f" ({library_what})")
              + ("" if cluster is None else f" cluster={cluster} CTA(s)"),
              flush=True)
        check(ok, f"{name} disagrees with its plain version: {errs} > {tols}")


def orb_sector_floor_ms(levels, uv, octave, theta, size: int = 32) -> float:
    """The distinct ``size``-byte pieces that the 64 samples of each
    keypoint touch (K5's pool, its centre and angle bin as
    orient_and_describe_plain computes them), summed over the keypoints,
    at the card's memory rate."""
    import torch
    from plslam_tpu_torch.ops import orb
    dev = uv.device
    o = octave.long().clamp(0, len(levels) - 1)
    H = torch.tensor([lv.shape[1] for lv in levels], device=dev)[o]
    W = torch.tensor([lv.shape[2] for lv in levels], device=dev)[o]
    u = torch.minimum(torch.round(uv[..., 0]).long().clamp(min=15), W - 16)
    v = torch.minimum(torch.round(uv[..., 1]).long().clamp(min=15), H - 16)
    rot = torch.from_numpy(orb._ROT_TABLES).to(dev).long()
    off = rot[orb.angle_bins(theta).long()]                 # (N, K, 64, 2)
    flat = ((v[..., None] + off[..., 0]) * W[..., None] + u[..., None]
            + off[..., 1])
    sec = torch.sort(flat // (size // 4), dim=-1).values
    n_sec = int((sec[..., 1:] != sec[..., :-1]).sum()) + sec[..., 0].numel()
    return n_sec * size / HBM_BYTES_PER_S * 1e3


def kernel_phase(images, record):
    """Kernels A-D at the points path's shapes against their plain
    versions."""
    import torch
    import torch.nn.functional as F
    from plslam_tpu_torch.ops import fast, image, orb

    dev = images.device
    N, H, W = images.shape                          # 40 x 376 x 1241
    npx = N * H * W

    # Bounds: bytes count each input read once and each output written
    # once; operations count f32 flops (and integer ops) at 67 TFLOP/s.
    # A: gaussian blur (7 taps) of the four pyramid levels (376x1241,
    # 313x1034, 261x862, 218x718: each level resized from the one before,
    # unblurred, as build_pyramid does); 2 passes x 7 taps x (mul + add)
    # per pixel
    k = image.gaussian_kernel1d(1.0, 3)
    k2d = torch.from_numpy(np.outer(k, k)).to(dev)[None, None]
    raw = [images]
    for i in range(1, 4):
        raw.append(image.resize_bilinear(
            raw[-1], (round(H / 1.2 ** i), round(W / 1.2 ** i))))
    for i, lvl in enumerate(raw):
        lpx = lvl.numel()
        record("image_sep_filter" + (f"@l{i}" if i else ""),
               "plslam_tpu_torch/csrc/image.cu", "plslam_tpu/ops/image.py:71",
               [image.separable_filter2d(lvl, k, k)],
               [image.separable_filter2d_plain(lvl, k, k)], 1e-6,
               lambda: image.separable_filter2d(lvl, k, k),
               lambda: image.separable_filter2d_plain(lvl, k, k),
               2 * lpx * 4, 2 * lpx * 7 * 2,
               lambda: F.conv2d(F.pad(lvl[:, None], (3, 3, 3, 3),
                                      mode="replicate"), k2d),
               entry="image_sep_filter")
    levels = image.build_pyramid(images, 4, 1.2)
    # ... and its paired mode at ORB's four half-resolution moment levels
    # (188x620, 156x517, 130x431, 109x359; the 15-tap _d_h / ones pair):
    # one read, two writes; 2 filters x 2 passes x 15 taps x 2 flops a
    # pixel. Library: one F.conv2d with the two 15x15 outer products as
    # its two output channels.
    k2 = torch.from_numpy(np.stack([np.outer(orb._ONES_H, orb._d_h),
                                    np.outer(orb._d_h, orb._ONES_H)])).to(
        dev)[:, None]
    sets = ((orb._d_h, orb._ONES_H), (orb._ONES_H, orb._d_h))
    for i, lvl in enumerate(levels):
        half = image.resize_bilinear(lvl, (lvl.shape[1] // 2,
                                           lvl.shape[2] // 2))
        hpx = half[0].numel()
        m10, m01 = (torch.empty((N, hpx), device=dev) for _ in range(2))

        def moments():
            image.separable_filter2d_pair(half, *sets[0], *sets[1], m10, m01)
            return m10, m01

        def moments_plain():
            return [image.separable_filter2d_plain(half, kx, ky).reshape(
                N, -1) for kx, ky in sets]

        record("image_sep_filter@moments" + (f"_l{i}" if i else ""),
               "plslam_tpu_torch/csrc/image.cu", "plslam_tpu/ops/image.py:71",
               [x.clone() for x in moments()], moments_plain(), 1e-4,
               moments, moments_plain, N * hpx * (4 + 8),
               N * hpx * 2 * 2 * 15 * 2,
               lambda: F.conv2d(F.pad(half[:, None], (7, 7, 7, 7),
                                      mode="replicate"), k2),
               entry="image_sep_filter")
    # the resize, one pass: the pyramid's 1/1.2 and the half-resolution
    # passes' 1/2 (ORB's moment levels, the line detector); 2 x 2 FMAs an
    # output pixel
    for tag, (h1, w1) in (("", (round(H / 1.2), round(W / 1.2))),
                          ("@half", (H // 2, W // 2))):
        out = image.resize_bilinear(images, (h1, w1))
        ref = image.resize_bilinear_plain(images, (h1, w1))
        record("image_resize" + tag, "plslam_tpu_torch/csrc/image.cu",
               "plslam_tpu/ops/image.py:86", [out], [ref], 1e-6,
               lambda: image.resize_bilinear(images, (h1, w1)),
               lambda: image.resize_bilinear_plain(images, (h1, w1)),
               (npx + N * h1 * w1) * 4, N * h1 * w1 * 8,
               lambda: F.interpolate(images[:, None], size=(h1, w1),
                                     mode="bilinear", align_corners=False),
               entry="image_resize")

    # B: FAST score on the four blurred levels, bound by operations:
    # FAST_OPS a pixel at the card's instruction rate (LANE_OPS_PER_S);
    # then NMS + block max/argmax of each level (~40 compares per pixel;
    # 8 x 16 cells, radius 5, border 16). Library for the NMS: two
    # F.max_pool2d calls, the (2r+1)^2 NMS max (-inf pad) and the 8x8
    # block max with its argmax (one threshold's plane).
    th_hi, th_lo = float(np.float32(20 / 255.0)), float(np.float32(7 / 255.0))
    for i, lvl in enumerate(levels):
        lpx = lvl.numel()
        tag = f"@l{i}" if i else ""
        got = fast.fast_score_map2(lvl, th_hi, th_lo)
        ref = fast.fast_score_map2_plain(lvl, th_hi, th_lo)
        record("fast_score" + tag, "plslam_tpu_torch/csrc/fast.cu",
               "plslam_tpu/ops/fast.py:70", list(got), list(ref), 0.0,
               lambda: fast.fast_score_map2(lvl, th_hi, th_lo),
               lambda: fast.fast_score_map2_plain(lvl, th_hi, th_lo),
               lpx * (4 + 1 + 1 + 4), lpx * FAST_OPS,
               ops_per_s=LANE_OPS_PER_S, entry="fast_score")
        chi, clo, score = got
        h, w = lvl.shape[1:]
        cell_h, cell_w = fast._grid_dims(h, w, 8, 16)
        Hb, Wb = cell_h * 8 // 8, cell_w * 16 // 8
        got = fast.nms_block_max(score, chi, clo, 5, 16, Hb, Wb)
        ref = fast.nms_block_max_plain(score, chi, clo, 5, 16, Hb, Wb)
        s1 = score[:, None]
        blocks = score[:, None, :min(Hb * 8, h), :min(Wb * 8, w)]
        record("fast_nms_block" + tag, "plslam_tpu_torch/csrc/fast.cu",
               "plslam_tpu/ops/fast.py:110", list(got), list(ref), 0.0,
               lambda: fast.nms_block_max(score, chi, clo, 5, 16, Hb, Wb),
               lambda: fast.nms_block_max_plain(score, chi, clo, 5, 16, Hb,
                                                Wb),
               lpx * (4 + 1 + 1) + N * Hb * Wb * 20, lpx * 40,
               lambda: (F.max_pool2d(s1, 11, stride=1, padding=5),
                        F.max_pool2d(blocks, 8, stride=8,
                                     return_indices=True)),
               entry="fast_nms_block")

    # C: orientation and bits of K=1024 keypoints an image on the
    # pyramid's 4 levels and their moment maps, as describe_multilevel
    # calls it (keypoints on and off the levels' edges, octaves 0-3): 8
    # bytes of uv, 4 of octave and 8 of moments in, 64 samples of 4 bytes,
    # 256 bit bytes and 4 of theta out; 256 compares and selects. The
    # scattered samples' floor beside it: the distinct 32-byte sectors
    # (and 64-byte pieces) each keypoint's 64 samples touch, at the card's
    # memory rate
    K = 1024
    g = torch.Generator(device="cpu").manual_seed(0)
    m10, m01, halves = orb.moment_maps(levels)
    octv = torch.randint(0, 4, (N, K), generator=g, dtype=torch.int32)
    wh = torch.tensor([lv.shape[:0:-1] for lv in levels],
                      dtype=torch.float32)[octv.long()]
    uv = (torch.rand((N, K, 2), generator=g) * 1.04 - 0.02) * wh
    octv, uv = octv.to(dev), uv.to(dev)
    got = orb.orient_and_describe(levels, m10, m01, halves, uv, octv)
    ref = orb.orient_and_describe_plain(levels, m10, m01, halves, uv, octv)
    record("orb_describe", "plslam_tpu_torch/csrc/orb.cu",
           "plslam_tpu/ops/orb.py:131", list(got), list(ref), 0.0,
           lambda: orb.orient_and_describe(levels, m10, m01, halves, uv,
                                           octv),
           lambda: orb.orient_and_describe_plain(levels, m10, m01, halves,
                                                 uv, octv),
           N * K * (8 + 4 + 8 + 64 * 4 + 256 + 4), N * K * 256 * 2)
    print(f"[k5] orb_describe: floor of the scattered samples "
          f"{orb_sector_floor_ms(levels, uv, octv, got[1]):.4f} ms in "
          f"32-byte sectors, "
          f"{orb_sector_floor_ms(levels, uv, octv, got[1], 64):.4f} ms in "
          f"64-byte pieces", flush=True)

    # D: a chunk's stereo point match (20 frames of 1024 x 1024 bit
    # descriptors, the stereo gate) and its f2f point match (the f2f
    # window with octaves)
    for kind, tag in (("stereo", "@stereo"), ("window_oct", "@f2f")):
        matcher_case(record, g, dev, 20, K, K, kind, tag)
    # ... and the same two gates at the per-frame path's shape (StereoVO:
    # one frame, bit descriptors packed in the kernel)
    for kind, tag in (("stereo", "@frame_stereo"), ("window_oct",
                                                    "@frame_f2f")):
        matcher_case(record, g, dev, 1, K, K, kind, tag)

    # K7, no hand kernel: take() (clamp + torch.gather) at the point
    # terms' shape, 20 x 1024 rows of 2 floats picked by 1024 indices
    from plslam_tpu_torch.ops.gather import take
    vals = torch.rand((20, K, 2), generator=g).to(dev)
    idx = torch.randint(-1, K, (20, K), generator=g).to(torch.int32).to(dev)
    il = idx.long().clamp(0, K - 1)[..., None].expand(20, K, 2)
    ms = cuda_ms(lambda: take(vals, idx), 50)
    lib = cuda_ms(lambda: torch.gather(vals, 1, il), 50)
    b_ms, b_by = bound(20 * K * (4 + 2 * 4 + 2 * 4), 20 * K * 3)
    print(f"[k7] take (clamp + torch.gather, no hand kernel) 20x1024x2: "
          f"ms={ms:.4f} bound_ms={b_ms:.6f} ({b_by}) library_ms "
          f"(torch.gather alone)={lib:.4f}", flush=True)


def matcher_case(record, g, dev, B, N, M, kind, tag, words=False, md=80,
                 ratio=0.75, radius=160.0):
    """Kernel D at (B, N, M) under the gate ``kind`` (``gated_case``):
    hamming_scan and hamming_finish against their plain versions, the pair
    exactly equal to match_gated_plain (idx, dist, valid); then, on the
    same inputs, the matrix-based hamming_dist + hamming_match it replaced,
    with the gate built in torch as the call sites built it (no main-path
    caller)."""
    import torch
    from plslam_tpu_torch.ops import hamming
    src, rep = ("plslam_tpu_torch/csrc/hamming.cu",
                "plslam_tpu/ops/hamming.py:")
    a, b, va, vb, gate = gated_case(g, dev, B, N, M, kind, words, radius)
    dist = hamming._gated_matrix_plain(a, b, va, vb, gate)
    scan = hamming.hamming_scan(a, b, va, vb, gate)
    scan_p = hamming.hamming_scan_plain(dist)
    bits = hamming.unpack_bits if words else (lambda x: x)
    fa, fb = bits(a).float(), bits(b).float()
    # bytes: descriptors, valid flags and gate data in (the mask, where the
    # gate is one), the row results and column keys out; operations: every
    # pair's distance as a 256-deep +-1 product (2 ops a term) at the int8
    # tensor-core rate, the card's fastest means for this function; the 8
    # popcounts of a pair give the CUDA-core algorithm's floor beside it
    desc_b = 32 if words else 256
    gate_b = {"none": 0, "window": 8, "window_oct": 12, "stereo": 12,
              "mask": 0}[kind]
    nbytes = ((B * N + B * M) * (desc_b + 1 + gate_b) + B * N * 12 + B * M * 8
              + (B * N * M if kind == "mask" else 0))
    record("hamming_scan" + tag, src, rep + "30", list(scan), list(scan_p),
           0.0, lambda: hamming.hamming_scan(a, b, va, vb, gate),
           lambda: hamming.hamming_scan_plain(
               hamming._gated_matrix_plain(a, b, va, vb, gate)),
           nbytes, B * N * M * 512, lambda: torch.cdist(fa, fb, p=0),
           entry="hamming_scan", ops_per_s=INT8_OPS_PER_S,
           popc_ops=B * N * M * 8, err_kind="d1, i1, v2, column keys; exact")
    got = hamming.hamming_finish(scan, md, ratio)
    want = hamming.match_gated_plain(a, b, va, vb, gate, md, ratio)
    check(int(want.valid.sum()) > B * M // 20, f"too few matches in D{tag}")
    record("hamming_finish" + tag, src, rep + "57", list(got), list(want),
           0.0, lambda: hamming.hamming_finish(scan, md, ratio),
           lambda: hamming.hamming_finish_plain(scan_p, md, ratio),
           B * N * (12 + 8 + 5), B * N * 6, entry="hamming_finish",
           err_kind="idx, dist, valid against match_gated_plain; exact")

    # before: the gate in torch, then the matrix-based pair
    mask = hamming.gate_mask(gate)
    if mask is None:
        mask = torch.ones((B, N, M), dtype=torch.bool, device=dev)
    old = hamming.hamming_matrix(a, b, va, vb, mask)
    record("hamming_dist" + tag, src, rep + "30", [old], [dist], 0.0,
           lambda: hamming.hamming_matrix(a, b, va, vb, mask),
           lambda: hamming.hamming_matrix_plain(a, b, va, vb, mask),
           B * N * M * (1 + 4) + (B * N + B * M) * desc_b,
           B * N * M * 512, lambda: torch.cdist(fa, fb, p=0),
           entry="hamming_dist", ops_per_s=INT8_OPS_PER_S,
           popc_ops=B * N * M * 8, before=True)
    record("hamming_match" + tag, src, rep + "57",
           list(hamming.match_nnr(old, md, ratio)), list(want), 0.0,
           lambda: hamming.match_nnr(old, md, ratio),
           lambda: hamming.match_nnr_plain(old, md, ratio),
           B * N * M * 4 + B * N * 9, B * N * M * 4, entry="hamming_match",
           before=True)
    glue = cuda_ms(lambda: hamming.gate_mask(gate), 20)
    dev_sum = lambda rs: f"{sum(r['device_ms'] for r in rs):.4f}"
    rows = {r["name"]: r for r in record.rows[-4:]}
    after = rows["hamming_scan" + tag], rows["hamming_finish" + tag]
    prior = rows["hamming_dist" + tag], rows["hamming_match" + tag]
    print(f"[D{tag}] {B}x{N}x{M} {kind}{' words' if words else ''}: before "
          f"(torch gate {glue:.4f} + hamming_dist + hamming_match) "
          f"{glue + sum(r['ms'] for r in prior):.4f} ms wrapper, "
          f"{dev_sum(prior)} ms device; after (hamming_scan + "
          f"hamming_finish) {sum(r['ms'] for r in after):.4f} ms wrapper, "
          f"{dev_sum(after)} ms device; "
          f"{int(want.valid.sum())} matches", flush=True)


GATE_KINDS = ("none", "window", "window_oct", "stereo", "mask")


def gated_case(g, dev, B, N, M, kind, words=False, radius=160.0):
    """Inputs of kernel D's matcher for B frames of N rows and M columns
    under the gate ``kind`` (GATE_KINDS): half of the columns near copies
    of random rows (5% of bits flipped), placed inside their row's gate (a
    disparity of 2-150 px along the row for "stereo", a shift of ~20 px
    within ``radius`` otherwise) with an octave within 1; 10% of rows and
    columns invalid; "mask" is the window and a random 80% of the pairs.
    ``words``: both sets as packed words. Returns (desc_a, desc_b,
    valid_a, valid_b, gate)."""
    import torch
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.ops import hamming
    u8 = torch.uint8
    bits_a = torch.randint(0, 2, (B, N, 256), generator=g, dtype=u8)
    src = torch.randint(0, N, (B, M), generator=g)
    near = torch.gather(bits_a, 1, src[..., None].expand(B, M, 256)) ^ (
        torch.rand((B, M, 256), generator=g) < 0.05).to(u8)
    fresh = torch.rand((B, M), generator=g) < 0.5
    bits_b = torch.where(fresh[..., None], torch.randint(
        0, 2, (B, M, 256), generator=g, dtype=u8), near)
    va = torch.rand((B, N), generator=g) > 0.1
    vb = torch.rand((B, M), generator=g) > 0.1
    pos_a = torch.rand((B, N, 2), generator=g) * torch.tensor([1241., 376.])
    shift = torch.randn((B, M, 2), generator=g) * 20
    if kind == "stereo":
        shift = torch.stack([-(2 + 148 * torch.rand((B, M), generator=g)),
                             torch.rand((B, M), generator=g) * 2 - 1], -1)
    pos_b = torch.gather(pos_a, 1, src[..., None].expand(B, M, 2)) + shift
    oct_a = torch.randint(0, 4, (B, N), generator=g, dtype=torch.int32)
    oct_b = torch.clamp(torch.gather(oct_a, 1, src) + torch.randint(
        -1, 2, (B, M), generator=g, dtype=torch.int32), 0, 3)
    if words:
        bits_a, bits_b = hamming.pack_bits(bits_a), hamming.pack_bits(bits_b)
    bits_a, bits_b, va, vb, pos_a, pos_b, oct_a, oct_b = (
        x.to(dev) for x in (bits_a, bits_b, va, vb, pos_a, pos_b, oct_a,
                            oct_b))
    m = SlamConfig().matching
    gate = {"none": None,
            "window": hamming.Window(pos_a, pos_b, radius),
            "window_oct": hamming.Window(pos_a, pos_b, radius, oct_a, oct_b),
            "stereo": hamming.Stereo(pos_a, pos_b, oct_a, oct_b,
                                     m.stereo_row_tol, m.min_disp,
                                     m.max_disp)}.get(kind)
    if kind == "mask":
        keep = (torch.rand((B, N, M), generator=g) < 0.8).to(dev)
        gate = hamming.Mask(hamming.window_mask(pos_a, pos_b, radius) & keep)
    return bits_a, bits_b, va, vb, gate


def _rel_maps(got, ref):
    """Maps scaled by each reference map's largest magnitude."""
    scales = [r.abs().max().clamp(min=1e-30) for r in ref]
    return ([g / s for g, s in zip(got, scales)],
            [r / s for r, s in zip(ref, scales)])


def tile_moments_chain(img, tile, grad_th, u8_wrap=False):
    """Kernel E as tile_stage launched it before its one launch:
    lines_sobel's planes, lines_moments' orientation pass, torch's unit
    field, lines_moments' reweighted pass."""
    from plslam_tpu_torch.ops import lines
    s = tile // 2
    w, d2x, d2y = lines.gradient_planes(img, grad_th, u8_wrap)
    D2x, D2y = lines.orientation_maps(d2x, d2y, tile, s)
    d2n = lines.sqrt_rn(D2x * D2x + D2y * D2y) + 1e-9
    return lines.reweighted_moments(w, d2x, d2y, D2x / d2n, D2y / d2n, tile,
                                    s)


def detector_case(record, img, kw, tag, min_ok_per_image):
    """Kernels E, F and G at one scale of the line detector, each fed by
    the one before, with that scale's settings ``kw``
    (``stereo_lines.detect_kwargs``); rows are named with ``tag``."""
    import torch
    import torch.nn.functional as F
    from plslam_tpu_torch.ops import lines

    dev = img.device
    N, H, W = img.shape
    npx = N * H * W
    tile = kw["tile"]
    s = tile // 2
    Th, Tw = lines.tile_grid(H, W, tile)
    nt = N * Th * Tw
    th = kw["grad_th"]
    src_t, src_l = ("plslam_tpu_torch/csrc/lines_tile.cu",
                    "plslam_tpu_torch/csrc/lines_label.cu")
    src_s = "plslam_tpu_torch/csrc/lines_segments.cu"
    rel = "relative to each map's largest magnitude"

    # E on the path: one launch from the image to the eight reweighted
    # window maps (tile_moments), against its plain version (relative 1e-5:
    # the block sums' order) and, bit for bit, against the four-step chain
    # it replaced (tile_moments_chain: lines_sobel, lines_moments, torch's
    # unit field, lines_moments). Bytes: the image in, 32 a window out;
    # operations: ~25 a pixel for the Sobel taps and planes, 2 for the
    # orientation sums, and ~24 for the ratio and the eight sums of each
    # pixel on the support (w > 0: the others add +0), ~70 a window for
    # the unit field and the shifts. Library: the reweighted pass's
    # F.conv2d below (no one call computes the function)
    tkw = (tile, th)
    got = lines.tile_moments(img, *tkw)
    ref = lines.tile_moments_plain(img, *tkw)
    chain = tile_moments_chain(img, *tkw)
    diff = [int((g != c).sum()) for g, c in zip(got, chain)]
    check(sum(diff) == 0, f"lines_tile_moments{tag}: maps differ from the "
          f"chain it replaced in {diff} windows")
    w, d2x, d2y = lines.gradient_planes_plain(img, th)
    n_sup = int((w > 0).sum())
    loc = torch.arange(tile, dtype=torch.float32)
    lx, ly = loc[None, :].expand(tile, tile), loc[:, None].expand(tile, tile)
    one = torch.ones(tile, tile)
    wk = torch.zeros(8, 3, tile, tile)
    for o, kk in enumerate((one, lx, ly, lx * lx, ly * ly, lx * ly)):
        wk[o, 0] = kk
    wk[6, 1] = one
    wk[7, 2] = one
    wk = wk.to(dev)
    planes = torch.stack([w, d2x, d2y], 1)
    g_rel, r_rel = _rel_maps(got, ref)
    record("lines_tile_moments" + tag, src_t,
           "plslam_tpu/ops/lines.py:330-375", g_rel, r_rel, 1e-5,
           lambda: lines.tile_moments(img, *tkw),
           lambda: lines.tile_moments_plain(img, *tkw),
           npx * 4 + nt * 32, npx * 27 + n_sup * 24 + nt * 70,
           lambda: F.conv2d(planes, wk, stride=s),
           entry="lines_tile_moments",
           err_kind=rel + "; the chain it replaced: exact, checked",
           library_what="the reweighted pass's window sums of given planes")
    new_dev = record.rows[-1]["device_ms"]
    print(f"[E{tag}] lines_tile_moments on {N} x {H}x{W} ({nt} windows, "
          f"{n_sup} support pixels): bit-equal to the chain in every map; "
          f"device {new_dev:.4f} ms", flush=True)

    # before (no path caller since the one launch): E launch 1, Sobel +
    # support planes; ~25 flops per pixel, 1 plane in, 3 out. Library:
    # F.conv2d of the two 3x3 Sobel kernels (gx, gy only)
    got = lines.gradient_planes(img, th)
    ref = lines.gradient_planes_plain(img, th)
    sob = sobel_weights(dev)
    record("lines_sobel" + tag, src_t, "plslam_tpu/ops/image.py:113",
           list(got), list(ref), 0.0,
           lambda: lines.gradient_planes(img, th),
           lambda: lines.gradient_planes_plain(img, th),
           npx * 16, npx * 25,
           lambda: F.conv2d(F.pad(img[:, None], (1, 1, 1, 1),
                                  mode="replicate"), sob),
           entry="lines_sobel", before=True)

    # before: E launch 2, orientation pass: window sums of the two
    # double-angle planes; 2 adds per pixel and plane, 4 per window.
    # Library: a grouped F.conv2d(stride=s) with 2s x 2s kernels of ones
    got = lines.orientation_maps(d2x, d2y, tile, s)
    ref = lines.orientation_maps_plain(d2x, d2y, tile, s)
    ones = torch.ones((2, 1, tile, tile), device=dev)
    p2 = torch.stack([d2x, d2y], 1)
    g_rel, r_rel = _rel_maps(got, ref)
    record("lines_orientation" + tag, src_t, "plslam_tpu/ops/lines.py:167",
           g_rel, r_rel, 1e-5,
           lambda: lines.orientation_maps(d2x, d2y, tile, s),
           lambda: lines.orientation_maps_plain(d2x, d2y, tile, s),
           npx * 8 + nt * 8, npx * 4 + nt * 8,
           lambda: F.conv2d(p2, ones, stride=s, groups=2),
           entry="lines_moments", err_kind=rel, before=True)

    # before: E launch 2, the reweighted pass: ~8 flops for the ratio and
    # 8 multiply-adds per pixel. Library: F.conv2d(stride=s) of the three
    # planes with eight 2s x 2s window-local coordinate kernels
    D2x, D2y = ref
    d2n = torch.sqrt(D2x * D2x + D2y * D2y) + 1e-9
    u = (D2x / d2n, D2y / d2n)
    got = lines.reweighted_moments(w, d2x, d2y, *u, tile, s)
    ref = lines.reweighted_moments_plain(w, d2x, d2y, *u, tile, s)
    g_rel, r_rel = _rel_maps(got, ref)
    record("lines_moments" + tag, src_t, "plslam_tpu/ops/lines.py:84",
           g_rel, r_rel, 1e-5,
           lambda: lines.reweighted_moments(w, d2x, d2y, *u, tile, s),
           lambda: lines.reweighted_moments_plain(w, d2x, d2y, *u, tile, s),
           npx * 12 + nt * 4 * 10, npx * 24 + nt * 40,
           lambda: F.conv2d(planes, wk, stride=s),
           entry="lines_moments", err_kind=rel, before=True)
    rows = {r["name"]: r for r in record.rows}
    old_dev = sum(rows[k + tag]["device_ms"] for k in (
        "lines_sobel", "lines_orientation", "lines_moments"))
    print(f"[E{tag}] one launch {new_dev:.4f} ms device; the chain's three "
          f"launches (lines_sobel, lines_moments twice) {old_dev:.4f} ms, "
          f"torch's unit field between them not counted", flush=True)
    S = ref

    # F: the gates and labels in one launch: 32 bytes in, 21 + 4 out a
    # tile; ~60 flops a tile's gates, 4 forward tests (~12 ops each) a
    # gated-in tile, and this run's sweeps of 8 neighbour reads + a hop
    # over the linked tiles. Plain: tile_gates + propagate_labels_plain
    iters = kw["merge_iters"]
    ang_th, dist_th = kw["merge_ang_th"], kw["merge_dist_th"]
    gargs = (*S, tile, kw["min_support"], kw["elong_th"],
             kw["perp_spread_th"], kw["coherence_th"], ang_th, dist_th,
             iters)
    got = lines.gates_and_labels(*gargs)
    gates = lines.gates_and_labels_plain(*gargs)
    tile_ok, lab_ref = gates[0], gates[-1]
    n_ok = int(tile_ok.sum())
    own = lab_ref == torch.arange(Th * Tw, device=dev).reshape(Th, Tw)
    sizes = torch.zeros((N, Th * Tw + 8), dtype=torch.long, device=dev)
    sizes.scatter_add_(1, lab_ref.reshape(N, -1).long(),
                       tile_ok.reshape(N, -1).long())
    n_linked = int((tile_ok & (sizes.gather(
        1, lab_ref.reshape(N, -1).long()).reshape(N, Th, Tw) > 1)).sum())
    check(n_ok >= min_ok_per_image * N, f"too few gated-in tiles{tag}: {n_ok}")
    print(f"[k9] lines_label{tag}: {n_ok} gated-in tiles, {n_linked} in "
          f"components of more than one tile, {int(own.sum())} roots, of "
          f"{nt} tiles ({N} images of {Th}x{Tw})", flush=True)
    record("lines_label" + tag, src_l, "plslam_tpu/ops/lines.py:320",
           list(got), list(gates), 0.0,
           lambda: lines.gates_and_labels(*gargs),
           lambda: lines.gates_and_labels_plain(*gargs),
           nt * (32 + 21 + 4),
           nt * 60 + n_ok * 4 * 12 + n_linked * iters * 10,
           entry="lines_label",
           err_kind="tile_ok, cx, cy, cx_l, cy_l, l1, labels: exact")

    # G launch 1: refit of the top-R roots, linear in the tiles: the labels
    # are read once, the 12 member planes (and tile_ok) of the member tiles
    # only, the root ids and the outputs once; 2 ops a tile for its slot,
    # ~80 a member (payload, sums, projection), ~60 a slot. Endpoints in
    # px: the image-centre moments cancel in f32, so summation order
    # (the plain version's index_add_ on the card is atomic) moves them by
    # ~0.01 px; scores (support masses) relative to the largest
    ts = lines.TileStage(lab_ref, tile_ok, *S[:6], *gates[1:6])
    len_th = min(0.75 * tile + s, kw["min_length"])
    ml = kw["max_lines"]
    rargs = lines.refit_inputs(ts, H, W, ml)
    root_id = rargs[0]
    got = lines.refit(ts, root_id, H, W, len_th)
    ref = lines.refit_plain(*rargs, H, W, len_th)
    R, n = root_id.shape[1], Th * Tw
    n_roots = int((root_id >= 0).sum())
    is_root_id = torch.zeros((N, n + 1), dtype=torch.bool, device=dev)
    is_root_id.scatter_(1, torch.where(root_id >= 0, root_id.long(), n),
                        True)
    is_root_id[:, n] = False
    lab_f = lab_ref.reshape(N, n).long()
    n_members = int(is_root_id.gather(1, torch.where(lab_f < n, lab_f, n)
                                      ).sum())
    seg = ref[2] > 0
    check(torch.equal(got[2] > 0, seg), f"refit{tag}: kernel and plain "
          "disagree on which root slots are segments")
    smax = ref[2].abs().max()
    refit_bytes = N * n * 4 + N * R * 4 + n_members * (12 * 4 + 1) \
        + N * R * 5 * 4
    refit_ops = N * n * 2 + n_members * 80 + N * R * 60
    record("lines_refit" + tag, src_s, "plslam_tpu/ops/lines.py:474",
           [got[0][seg], got[1][seg], got[2] / smax],
           [ref[0][seg], ref[1][seg], ref[2] / smax], [0.05, 0.05, 1e-5],
           lambda: lines.refit(ts, root_id, H, W, len_th),
           lambda: lines.refit_plain(*rargs, H, W, len_th),
           refit_bytes, refit_ops, entry="lines_refit",
           err_kind="sp, ep in px; score relative to the largest")

    # the whole public call: root ids (key, stable sort), the launch, the
    # candidate top_k and takes; plain: the torch glue + refit_plain
    M = 2 * ml
    min_len = kw["min_length"]

    def roots_plain():
        sp_p, ep_p, sc_p = lines.refit_plain(
            *lines.refit_inputs(ts, H, W, ml), H, W, len_th)
        c_s, c_i = lines.top_k(sc_p, M)
        return lines.take(sp_p, c_i), lines.take(ep_p, c_i), c_s

    got = lines.refit_roots(ts, H, W, tile, ml, min_len)
    ref = roots_plain()
    cand = ref[2] > 0
    check(torch.equal(got[2] > 0, cand), f"refit_roots{tag}: kernel and "
          "plain disagree on the candidates")
    record("refit_roots" + tag, "plslam_tpu_torch/ops/lines.py",
           "plslam_tpu/ops/lines.py:474",
           [got[0][cand], got[1][cand], got[2] / smax],
           [ref[0][cand], ref[1][cand], ref[2] / smax], [0.05, 0.05, 1e-5],
           lambda: lines.refit_roots(ts, H, W, tile, ml, min_len),
           roots_plain, refit_bytes + N * n * 5, refit_ops + N * n * 2,
           entry="lines_refit",
           err_kind="sp, ep in px; score relative to the largest")

    # G launch 2: merge of the 2 * max_lines candidates, which the kernel
    # compacts to the valid ones: their table (~60 ops a segment) and
    # refit (~30), and the pair tests of this run's valid candidates (~16
    # ops: both directions and their AND); the sweeps over the set bits
    # are small. Its inputs: the plain refit's candidates (the contiguous
    # scores); the whole call below takes refit_roots's as detect_segments
    # passes them
    sp_c, ep_c, top_s = (x.contiguous() for x in ref)
    valid_c = top_s > 0
    margs = (sp_c, ep_c, top_s, valid_c, 2.0 * ang_th, dist_th,
             kw["merge_gap_th"])
    got = lines.merge_segments(*margs)
    table = lines._segment_table(sp_c, ep_c, top_s, valid_c)
    ref = lines.merge_plain(table, valid_c, *margs[4:], 8)
    root = ref[4]
    check(int(root.sum()) >= N, f"too few merged segments{tag}")

    def merge_work(valid):
        per_image = valid.sum(1)
        return (N * M * (5 * 4 + 1) + N * M * (4 * 4 + 4 + 4 + 1 + 4),
                int((per_image * per_image).sum()) * 16
                + int(per_image.sum()) * (60 + 30))

    merge_tols = [0.0, 0.0, 1e-2, 1e-2, 1e-2]
    merge_kind = "roots, labels exact; sp, ep in px; angle in rad"
    record("lines_merge" + tag, src_s, "plslam_tpu/ops/lines.py:214",
           [got[4], got[5], got[0][root], got[1][root], got[2][root]],
           [ref[4], ref[5], ref[0][root], ref[1][root], ref[2][root]],
           merge_tols, lambda: lines.merge_segments(*margs),
           lambda: lines.merge_plain(table, valid_c, *margs[4:], 8),
           *merge_work(valid_c), entry="lines_merge", err_kind=merge_kind)

    # the whole public call as detect_segments makes it: refit_roots's
    # candidates, its scores a strided view; plain: _segment_table +
    # merge_plain on the same candidates
    c_sp, c_ep, c_s = lines.refit_roots(ts, H, W, tile, ml, min_len)
    c_v = c_s > 0
    pargs = (2.0 * ang_th, dist_th, kw["merge_gap_th"])
    got = lines.merge_segments(c_sp, c_ep, c_s, c_v, *pargs)
    ref = lines.merge_plain(lines._segment_table(c_sp, c_ep, c_s, c_v), c_v,
                            *pargs, 8)
    root = ref[4]
    record("merge_segments" + tag, "plslam_tpu_torch/ops/lines.py",
           "plslam_tpu/ops/lines.py:214",
           [got[4], got[5], got[0][root], got[1][root], got[2][root]],
           [ref[4], ref[5], ref[0][root], ref[1][root], ref[2][root]],
           merge_tols, lambda: lines.merge_segments(c_sp, c_ep, c_s, c_v,
                                                    *pargs),
           lambda: lines.merge_plain(lines._segment_table(c_sp, c_ep, c_s,
                                                          c_v), c_v,
                                     *pargs, 8),
           *merge_work(c_v), entry="lines_merge", err_kind=merge_kind)
    print(f"[lines{tag}] gated-in tiles {n_ok} of {nt}, real roots "
          f"{n_roots}, candidate segments {int(valid_c.sum())}, merged "
          f"roots {int(root.sum())} over {N} images", flush=True)


def sobel_weights(dev):
    """The two 3x3 Sobel kernels (x, y) of the F.conv2d yardstick."""
    import torch
    sm, df = torch.tensor([0.25, 0.5, 0.25]), torch.tensor([-0.5, 0.0, 0.5])
    return torch.stack([torch.outer(sm, df),
                        torch.outer(df, sm)])[:, None].to(dev)


def line_kernel_phase(images, cfg, record):
    """Kernels E-G at both scales of the flagship detector (full res, then
    the half-res image), H on the path's segments and half-res gradients,
    and D at the line path's 128 x 128."""
    import torch
    import torch.nn.functional as F
    from plslam_tpu_torch.frontend import stereo_lines
    from plslam_tpu_torch.ops import image, lbd

    l = cfg.lines
    N, H, W = images.shape
    diag = math.hypot(H, W)
    small = image.resize_bilinear(images, (H // 2, W // 2))
    detector_case(record, images, stereo_lines.detect_kwargs(l, False, diag),
                  "", 10)
    detector_case(record, small, stereo_lines.detect_kwargs(l, True, diag),
                  "@half", 2)

    # E launch 1 without the planes: the half-res gradients that LBD read
    # before it formed them itself (no path caller since then; the
    # gradient mode of H below reads them), ~10 flops per pixel, 1 plane
    # in, 2 out
    gx, gy = image.sobel_gradients(small)
    ref = image.sobel_gradients_plain(small)
    sob = sobel_weights(small.device)
    nsm = small.numel()
    record("lines_sobel_grad@half", "plslam_tpu_torch/csrc/lines_tile.cu",
           "plslam_tpu/ops/image.py:113", [gx, gy], list(ref), 0.0,
           lambda: image.sobel_gradients(small),
           lambda: image.sobel_gradients_plain(small), nsm * 12, nsm * 10,
           lambda: F.conv2d(F.pad(small[:, None], (1, 1, 1, 1),
                                  mode="replicate"), sob),
           entry="lines_sobel", before=True)

    # H: LBD bits of the path's (fused) segments on the half-res image, one
    # launch from the image (describe_lines_image): the image read once,
    # the endpoints in and the bits out; ~170 flops a sample (its 2 x 2
    # taps' Sobel from the 4 x 4 patch, bf16 rounding, bilinear weights,
    # the rotation), 36 band sums of 48 (max and add), 256 compares a
    # segment. Its plain version is the composition it replaced:
    # sobel_gradients_plain, then describe_lines_plain.
    segs, _ = stereo_lines.detect_and_describe_lines(images, cfg)
    sp_h, ep_h = segs.sp * 0.5, segs.ep * 0.5
    bw = max(l.lbd_band_width // 2, 3)
    lkw = (l.lbd_bands, bw, l.lbd_samples, l.lbd_band_samples)
    got = lbd.describe_lines_image(small, sp_h, ep_h, *lkw)
    ref = lbd.describe_lines_image_plain(small, sp_h, ep_h, *lkw)
    L = sp_h.shape[1]
    n_seg = N * L
    n_samp = l.lbd_samples * l.lbd_bands * l.lbd_band_samples
    band_ops = 8 * n_samp     # 4 statistics a sample, max and add
    record("lbd_describe", "plslam_tpu_torch/csrc/lbd.cu",
           "plslam_tpu/ops/lbd.py:51", [got], [ref], 0.0,
           lambda: lbd.describe_lines_image(small, sp_h, ep_h, *lkw),
           lambda: lbd.describe_lines_image_plain(small, sp_h, ep_h, *lkw),
           nsm * 4 + n_seg * (16 + 256),
           n_seg * (n_samp * 170 + band_ops + 256))
    grid = launched_grid(lambda: lbd.describe_lines_image(small, sp_h, ep_h,
                                                          *lkw), "lbd_kernel")
    print(f"[lbd] describe_lines_image at {N} x {L} segments on "
          f"{small.shape[1]}x{small.shape[2]}: launched with grid, block "
          f"{grid if grid else 'not recorded by the profiler'} (a warp a "
          f"segment, 4 a CTA)", flush=True)
    check(grid is None or (list(grid[0]) == [-(-n_seg // 4), 1, 1]
                           and list(grid[1]) == [128, 1, 1]),
          f"lbd_describe: grid, block {grid}, expected {-(-n_seg // 4)} "
          "CTAs of 128 threads")
    # ... and its gradient mode (describe_lines, no path caller) on the
    # Sobel maps above: both maps read, 8 taps a sample
    largs = (gx, gy, sp_h, ep_h, *lkw)
    record("lbd_describe@grad", "plslam_tpu_torch/csrc/lbd.cu",
           "plslam_tpu/ops/lbd.py:51", [lbd.describe_lines(*largs)], [ref],
           0.0, lambda: lbd.describe_lines(*largs),
           lambda: lbd.describe_lines_plain(*largs),
           2 * nsm * 4 + n_seg * (16 + 256),
           n_seg * (n_samp * 90 + band_ops + 256), entry="lbd_describe")
    rows = {r["name"]: r for r in record.rows}
    pair = ("lines_sobel_grad@half", "lbd_describe@grad")
    fused = rows["lbd_describe"]["device_ms"]
    print(f"[lbd] from the image: one launch {fused:.4f} ms device; the "
          f"Sobel launch and the gradient mode "
          f"{sum(rows[k]['device_ms'] for k in pair):.4f} ms", flush=True)
    print(f"[lines] segments after the fusion of the two scales "
          f"{int(segs.valid.sum())} over {N} images", flush=True)

    # D at the line path's shapes: 20 pairs x 128 x 128 under an explicit
    # mask (the line matchers' angle and overlap gates stay torch)
    g = torch.Generator(device="cpu").manual_seed(5)
    matcher_case(record, g, images.device, 20, cfg.lines.max_lines,
                 cfg.lines.max_lines, "mask", "@128", md=90, ratio=0.9)


CHUNK = 20


@functools.lru_cache(maxsize=None)
def main_scene(lines: bool):
    """bench.py's scene at full KITTI width: the main paths (rendered once
    a process; the dataset phase writes it to disk)."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic

    cfg = SlamConfig() if lines else SlamConfig().with_updates(
        {"lines": {"has_lines": False}})
    cam = StereoCamera.from_config(cfg.camera)
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cam, n_frames=2 * CHUNK + 1, seed=0,
                                  n_points=500, n_lines=60 if lines else 0,
                                  noise=0.003, step=0.25)
    print(f"[main] rendered {2 * CHUNK + 1} frames in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return cfg, cam, seq


# Launches of each kernel in one extraction (``extract_stereo_frame`` of a
# batch: 4 pyramid levels blurred and 3 resized, ORB's 4 half-res moment
# levels (both maps in one paired filter launch), FAST on 4 levels, one
# stereo match each of points and lines; the line detector at 2 scales,
# each its window moments in one launch, labels, refit and merge, the half-res
# resize and LBD from the half-res image, its Sobel taps formed inside the
# launch) and in one chunk's tracking (chunk_passes=2:
# two f2f matches of points and, with lines, two of lines). The main
# path's timed run, initialize + 2 chunks, is 3 extractions and 2
# trackings.
EXTRACT_POINTS = {"image_sep_filter": 8, "image_resize": 7, "fast_score": 4,
                  "fast_nms_block": 4, "orb_describe": 1, "hamming_scan": 1,
                  "hamming_finish": 1}
EXTRACT_LINES = {"image_resize": 1, "lines_tile_moments": 2,
                 "lines_label": 2, "lines_refit": 2, "lines_merge": 2,
                 "lbd_describe": 1, "hamming_scan": 1, "hamming_finish": 1}
TRACK = {"hamming_scan": 2, "hamming_finish": 2}
GN = {"pose_gn_optimize": 2}  # 2 passes, one optimize_pose launch each


def expected_launches(lines: bool, points: bool = True, scan: bool = False,
                      chunks: int = 2) -> dict:
    """Each kernel's launches in a chunked run of initialize + ``chunks``
    chunks (the main path's timed run: 2): 1 + ``chunks`` extractions;
    a chunk's tracking batched (two passes) or, in scan mode, a pair at a
    time (each family's f2f match and one optimize_pose a frame). The
    lines-only configuration (``points`` False) extracts and matches no
    points."""
    from collections import Counter
    track, gn, times = ((TRACK_PAIR, GN_PAIR, CHUNK * chunks) if scan
                        else (TRACK, GN, chunks))
    n = Counter()
    for table, k in ((EXTRACT_POINTS if points else {}, 1 + chunks),
                     (EXTRACT_LINES if lines else {}, 1 + chunks),
                     (track if points else {}, times),
                     (track if lines else {}, times), (gn, times)):
        for name, v in table.items():
            n[name] += v * k
    return dict(n)


def run_counts(outs):
    """Per-frame inliers, stereo lines and line inliers of chunk outputs
    (host arrays; stereo lines None on the points-only path)."""
    import torch
    cat = lambda f: torch.cat([getattr(o, f) for o in outs]).cpu().numpy()
    return (cat("n_inliers"),
            cat("n_lines") if outs[0].n_lines is not None else None,
            cat("n_line_inliers"))


def cpu_reference_ate(parts) -> None:
    """The main paths' scenes through the port's plain versions on the
    CPU: the calibration run of the ATE, line-count, keyframe and loop
    bounds. ``parts``: any of vo, slam, loops, pcg, dataset, compact,
    slam_system (or one of its runs: plslam_sync, plslam_async,
    chunked_sync), lines_only, scan, dist (none: all)."""
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    if not parts or "dist" in parts:
        from plslam_tpu_torch.config import SlamConfig
        from plslam_tpu_torch.core.camera import StereoCamera
        cfg = SlamConfig()
        cam = StereoCamera.from_config(cfg.camera)
        cpu_dist_lm(lba_window_problem("cpu", cfg, cam), cam, cfg)
        if parts and set(parts) == {"dist"}:
            return
    vo_parts = [p for p in ("lines_only", "scan") if not parts or p in parts]
    if vo_parts:
        cpu_vo_runs(vo_parts)
        if parts and set(parts) <= {"lines_only", "scan"}:
            return
    tags = [t for t, _, _ in SYSTEM_RUNS[:3]
            if not parts or "slam_system" in parts or t in parts]
    if tags:
        cpu_system_runs(tags)
        if parts and set(parts) <= {"slam_system", *tags}:
            return
    if not parts or "dataset" in parts:
        cpu_dataset_runs()
    if not parts or "compact" in parts:
        cpu_compact_run()
    for lines in ((True, False) if not parts or "vo" in parts else ()):
        cfg, cam, seq = main_scene(lines)
        vo = BatchedStereoVO(cfg, cam, device="cpu")
        t0 = time.perf_counter()
        vo.initialize(seq.images_l[0], seq.images_r[0])
        outs = [vo.process_chunk(seq.images_l[lo:lo + CHUNK],
                                 seq.images_r[lo:lo + CHUNK])
                for lo in (1, 1 + CHUNK)]
        good = np.concatenate([o.good.numpy() for o in outs])
        ate = ate_rmse(np.stack(vo.trajectory), seq.poses)
        msg = (f"[cpu] lines={lines} good={int(good.sum())}/{len(good)} "
               f"ate_m={ate!r} ({time.perf_counter() - t0:.1f} s)")
        if lines:
            _, n, n_li = run_counts(outs)
            msg += (f" stereo_lines min/median={n.min()}/{np.median(n)}"
                    f" line_inliers min/median={n_li.min()}/"
                    f"{np.median(n_li)}")
        print(msg, flush=True)
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    if parts and "slam" not in parts:
        return cpu_loop_runs(parts)
    cfg, cam, seq, il, ir = slam_scene()
    slam = FusedPLSLAM(cfg, cam, device="cpu")
    t0 = time.perf_counter()
    est = drive_slam(slam, il, ir)
    flags, good, margin = decisions(slam, cfg)
    recs = slam.summaries
    print(f"[cpu] slam good={int(good.sum())}/{len(good)} "
          f"ate_m={float(ate_rmse(est, seq.poses[:len(est)]))!r} keyframes="
          f"{len(recs)} kf_frames={np.nonzero(flags)[0].tolist()} "
          f"smallest decision margin {margin.min():.6g} landmarks "
          f"{slam.n_landmarks()} lba costs "
          f"{[(r.lba_cost0, r.lba_cost1) for r in recs if r.lba_cost0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    cpu_loop_runs(parts)


def cpu_loop_runs(parts) -> None:
    """The loop path on the CPU, as ``main`` runs it on the card: with the
    default floors, with floors 0 (the graph solve at every closure) if no
    default closure solved, and with the PCG solver: the LOOP_CPU values.
    ``parts``: "loops" (all three) or "pcg" (the PCG run alone, with the
    floors LOOP_CPU's record implies)."""
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    tags = [t for t, part in (("default", "loops"), ("solve", "loops"),
                              ("pcg", "pcg"))
            if not parts or "loops" in parts or part in parts]
    if not tags:
        return
    global LOOP_SCENE
    LOOP_SCENE = loop_scene()
    cfg0, cam, seq, il, ir = LOOP_SCENE
    solve = SOLVE_ALWAYS if "solve" in LOOP_CPU else {}
    for tag in tags:
        if tag == "solve" and not solve:
            continue            # the default run solved: no second run
        upd = {"default": {}, "solve": SOLVE_ALWAYS,
               "pcg": pcg_updates(solve)}[tag]
        cfg = cfg0.with_updates(upd) if upd else cfg0
        slam = FusedPLSLAM(cfg, cam, device="cpu")
        t0 = time.perf_counter()
        est = drive_slam(slam, il, ir, None, LOOP_CHUNKS)
        kf_frames, events, funnel, good, margin = loop_summary(slam, cfg)
        ate = float(ate_rmse(est, seq.poses[:len(est)]))
        print(f"[cpu] loops {tag}: good={int(good.sum())}/{len(good)} "
              f"events {slam.loop_closer.events} smallest decision margin "
              f"{margin.min():.6g} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        print(f"[cpu] LOOP_CPU[{tag!r}] = " + json.dumps(dict(
            kf_frames=kf_frames, events=events, funnel=funnel, ate=ate)),
              flush=True)
        if tag == "default":
            solve = ({} if any(e.graph_cost0 > 0
                               for e in slam.loop_closer.events)
                     else SOLVE_ALWAYS)


def main_path(dev, lines: bool):
    """Chunked VO at full KITTI width, 2 chunks of 20, after a warm-up
    chunk; returns the launches of the timed run."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse

    tag = "main" if lines else "points"
    cfg, cam, seq = main_scene(lines)
    chunk = CHUNK
    il = torch.from_numpy(seq.images_l).to(dev)
    ir = torch.from_numpy(seq.images_r).to(dev)

    warm = BatchedStereoVO(cfg, cam)
    warm.initialize(il[0], ir[0])
    out = warm.process_chunk(il[1:1 + chunk], ir[1:1 + chunk])
    check(bool(out.good.all()), f"{tag}: tracking failed in the warm-up")

    vo = BatchedStereoVO(cfg, cam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    t0 = time.perf_counter()
    vo.initialize(il[0], ir[0])
    outs = [vo.submit_chunk(il[lo:lo + chunk], ir[lo:lo + chunk])
            for lo in (1, 1 + chunk)]
    vo.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    good = torch.cat([o.good for o in outs]).cpu().numpy()
    n_inl, n_lines, n_line_inl = run_counts(outs)
    ate = ate_rmse(np.stack(vo.trajectory), seq.poses)
    fps = 2 * chunk / wall
    bound_m = ATE_LINES_BOUND if lines else ATE_BOUND
    cpu_m = ATE_LINES_CPU_MEASURED if lines else ATE_CPU_MEASURED
    print(f"[{tag}] frames={2 * chunk} good={int(good.sum())} "
          f"inliers min/median={int(n_inl.min())}/{int(np.median(n_inl))} "
          f"ate_m={ate:.6f} (bound {bound_m}; CPU run {cpu_m})", flush=True)
    print(f"[{tag}] fps={fps:.2f} ms_per_frame={1e3 * wall / (2 * chunk):.3f}"
          f" (host clock, initialize + 2 chunks, ends in synchronize) "
          f"max_memory_allocated_bytes={peak}", flush=True)
    want = expected_launches(lines)
    print(f"[{tag}] launches={json.dumps(launches, sort_keys=True)}",
          flush=True)
    check(bool(good.all()), f"{tag}: frames not tracked: "
          f"{np.nonzero(~good)[0]}")
    check(bound_m is not None and math.isfinite(ate) and ate < bound_m,
          f"{tag}: ATE {ate} m outside its bound {bound_m} m")
    check(launches == want, f"{tag}: launches {launches} differ from the "
          f"path's {want}")
    if lines:
        print(f"[{tag}] stereo lines per frame min/median="
              f"{int(n_lines.min())}/{float(np.median(n_lines))} (bound >= "
              f"{MIN_LINES}; CPU run {MIN_LINES_CPU_MEASURED}); line inliers "
              f"per frame min/median={int(n_line_inl.min())}/"
              f"{float(np.median(n_line_inl))} (bound >= {MIN_LINE_INLIERS};"
              f" CPU run {MIN_LINE_INLIERS_CPU_MEASURED})", flush=True)
        check(int(n_lines.min()) >= MIN_LINES,
              f"{tag}: a frame has {int(n_lines.min())} stereo lines")
        check(int(n_line_inl.min()) >= MIN_LINE_INLIERS,
              f"{tag}: a frame's pose has {int(n_line_inl.min())} line "
              "inliers")
    else:
        check(n_lines is None and int(n_line_inl.max()) == 0,
              f"{tag}: line terms on the points-only path")
    return launches


def small_scene_vo(dev, cfg, seed, n_points, n_lines, n_frames, step):
    """extract_one + vo_chunk of a small scene on ``dev``."""
    import torch
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.tracking.batch_vo import vo_chunk, extract_one
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=n_frames, seed=seed,
                                  n_points=n_points, n_lines=n_lines,
                                  noise=0.003, step=step)
    il = torch.from_numpy(seq.images_l).to(dev)
    ir = torch.from_numpy(seq.images_r).to(dev)
    p0, l0 = extract_one(il[0], ir[0], cam, cfg)
    out = vo_chunk(il[1:], ir[1:], p0, l0, torch.eye(4, device=dev), cam,
                   cfg)
    return p0, l0, out


SMALL = {"camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
                    "cx": 320.0, "cy": 192.0, "baseline": 0.3},
         "points": {"max_kpts": 512, "orb_nlevels": 2}}


def small_agreement(dev):
    """The port on the card against the port on the CPU (plain versions)
    on a small points-only scene: same tracking, keypoints and poses."""
    from plslam_tpu_torch.config import SlamConfig
    cfg = SlamConfig().with_updates(dict(SMALL, lines={"has_lines": False}))
    res = {d: small_scene_vo(d, cfg, 7, 260, 0, 5, 0.12) for d in ("cpu", dev)}
    (pc, _, oc), (pg, _, og) = res["cpu"], res[dev]
    v = pc.valid.numpy()
    same = ((pc.uv.numpy() == pg.uv.cpu().numpy()).all(-1)
            & (pc.desc.numpy() == pg.desc.cpu().numpy()).all(-1))[v].mean()
    dpose = float((oc.DT - og.DT.cpu()).abs().max())
    print(f"[agree] card vs CPU, 640x384 scene: keypoints identical "
          f"{same:.4f}, good {oc.good.tolist()} vs {og.good.tolist()}, "
          f"max pose entry diff {dpose:.3g}", flush=True)
    check(bool(oc.good.all()) and oc.good.tolist() == og.good.tolist(),
          "card and CPU disagree on tracking")
    check(same >= 0.97, f"card and CPU keypoints agree only {same:.4f}")
    check(dpose < 1e-3, f"card and CPU poses differ by {dpose}")


def small_line_agreement(dev):
    """The same on tests/test_batch_vo.py's point+line scene (seed 3, 220
    points, 40 lines, max_lines=64): >= 95% of the CPU run's valid stereo
    lines in the same slot within 0.05 px, >= 99% of their descriptor
    bits identical (the JAX parity rule: window sums run in another order
    on the card), identical ``good``, poses within 1e-3."""
    from plslam_tpu_torch.config import SlamConfig
    cfg = SlamConfig().with_updates(dict(SMALL, lines={"has_lines": True,
                                                       "max_lines": 64}))
    res = {d: small_scene_vo(d, cfg, 3, 220, 40, 7, 0.12)
           for d in ("cpu", dev)}
    (_, lc, oc), (_, lg, og) = res["cpu"], res[dev]
    fr = {}
    for name, a, b in (("first", lc, lg), ("last", oc.last_lns,
                                            og.last_lns)):
        v = a.valid.numpy()
        d = np.maximum(np.abs(a.sp.numpy() - b.sp.cpu().numpy()).max(-1),
                       np.abs(a.ep.numpy() - b.ep.cpu().numpy()).max(-1))
        same = v & (d < 0.05) & b.valid.cpu().numpy()
        bits = (a.desc.numpy() == b.desc.cpu().numpy())[same].mean()
        fr[name] = (float(same.sum() / max(v.sum(), 1)), float(bits),
                    int(v.sum()), float(d[v].max()))
    dpose = float((oc.DT - og.DT.cpu()).abs().max())
    print(f"[agree] card vs CPU, 640x384 line scene: stereo lines (share "
          f"within 0.05 px, share of bits identical, count, max endpoint "
          f"diff px) {fr}, good {oc.good.tolist()} vs {og.good.tolist()}, "
          f"line inliers {oc.n_line_inliers.tolist()} vs "
          f"{og.n_line_inliers.tolist()}, max pose entry diff {dpose:.3g}",
          flush=True)
    check(bool(oc.good.all()) and oc.good.tolist() == og.good.tolist(),
          "card and CPU disagree on line tracking")
    for name, (seg, bits, n, _) in fr.items():
        check(n >= 8 and seg >= 0.95 and bits >= 0.99,
              f"card and CPU lines agree only {seg:.4f}/{bits:.4f} ({name})")
    check(dpose < 1e-3, f"card and CPU poses differ by {dpose} (lines)")



# -- slice 3: the fused SLAM chunk without loop closure --------------------

# the least work of kernel I a term and iteration: a point's residual and
# Jacobian (~70 flops) and its weighted 27-entry normal-equation update
# (~80); a line's twice that; and ~10 operations a norm for a linear-time
# selection of the median
GN_OPS_POINT, GN_OPS_LINE, GN_OPS_SELECT = 150, 300, 10
# optimize_pose's decisions (inlier masks, n_inliers, good) may differ from
# the plain version's only where the plain version's own quantity lies
# within this fraction of its threshold
DECISION_MARGIN = 1e-4


def gn_ops(B, K, L, iters):
    """Operations of ``iters`` iterations' terms, medians and normal
    equations (optimize_pose: its iterations + the gate + the final
    statistics)."""
    return iters * B * (K * GN_OPS_POINT + L * GN_OPS_LINE
                        + (K + 2 * L) * GN_OPS_SELECT)


def pose_margins(T0, cam, pts, lns, cfg):
    """The plain version's decisions, each with its relative margin to
    its threshold: the inlier gate of every point (B, K) and line (B, L)
    (|max |r| - k sigma| / k sigma at the robust phase's pose) and the
    closest of the ``good`` gates (B,) (n_inliers against min_features
    and min_inlier_ratio x n_total, err against max_optim_error, the
    rotation's orthonormality and determinant against their tolerance).
    Returns (margins, the plain result, its final statistics run in
    float64 from its pose and inliers: H (B, 6, 6), sse (B,))."""
    import torch
    from plslam_tpu_torch.core import robust
    from plslam_tpu_torch.tracking import pose_gn
    t = cfg.tracking
    lns = pose_gn._no_lines(pts) if lns is None else lns
    T1 = pose_gn.gn_iters_plain(T0, cam, pts, lns, t.max_iters)
    _, _, n_pt = pose_gn.point_terms_rj(T1, cam, pts)
    _, _, a_ln = pose_gn.line_terms_rj(T1, cam, lns)
    sigma = torch.clamp(robust.mad_scale_zero_centered(
        torch.cat([n_pt, a_ln.flatten(-2)], -1),
        torch.cat([pts.valid, lns.valid.repeat_interleave(2, -1)], -1)),
        min=0.25)
    thr = (t.inlier_k * sigma).double()
    m_pt = (n_pt.double() - thr[:, None]).abs() / thr[:, None]
    m_ln = (a_ln.amax(-1).double() - thr[:, None]).abs() / thr[:, None]
    res = pose_gn.optimize_pose_plain(T0, cam, pts, lns, cfg)
    H, sse = pose_gn.final_normal_eqs(
        res.T.double(), cam, _as_f64(pts._replace(valid=res.inlier_pt)),
        _as_f64(lns._replace(valid=res.inlier_ln)))
    n = res.n_inliers.double()
    n_total = (pts.valid.sum(-1) + lns.valid.sum(-1)).clamp(min=1).double()
    R = res.T[:, :3, :3].double()
    ortho = (R @ R.transpose(-1, -2) - torch.eye(3, dtype=R.dtype,
                                                 device=R.device)).abs()
    rel = lambda x, c: (x - c).abs() / abs(c)
    m_good = torch.stack([
        rel(n, t.min_features), rel(n, t.min_inlier_ratio * n_total),
        rel(res.err.double(), t.max_optim_error),
        rel(ortho.amax((-1, -2)), 1e-3),
        rel((torch.linalg.det(R) - 1.0).abs(), 1e-3)], -1).amin(-1)
    return (m_pt, m_ln, m_good), res, H, sse


def hold_pose(got, ref, margins, H, sse):
    """optimize_pose on the card (``got``) against the plain version
    (``ref``, ``pose_margins``: its float64 statistics H, sse): [T's
    largest difference; the covariance's and err's largest ratio of their
    distance from the float64 values (cov = sse / max(2 n - 6, 1) (H +
    1e-6 I)^-1, err = sqrt(sse / max(2 n, 1))), and from the plain
    version's, to F64_FACTOR x the plain version's own distance from the
    float64 values + F64_FLOOR x their largest magnitude, K15's rule; the
    decisions that differ with a margin of at
    least DECISION_MARGIN], the smallest margin of any decision, err's
    largest relative difference from the plain version's err, and the
    pairs whose inlier masks differ (left out of the float checks)."""
    import torch
    m_pt, m_ln, m_good = margins
    d_pt = got.inlier_pt != ref.inlier_pt
    d_ln = got.inlier_ln != ref.inlier_ln
    same = ~(d_pt.any(-1) | d_ln.any(-1))
    far = lambda d, m: int((d & (m >= DECISION_MARGIN)).sum())
    bad = (far(d_pt, m_pt) + far(d_ln, m_ln)
           + far(got.good != ref.good, m_good)
           + int(((got.n_inliers != ref.n_inliers) & same).sum()))
    valid = lambda m, v: m[v] if v.any() else m.new_tensor([math.inf])
    smallest = min(float(valid(m_pt, ref.inlier_pt | got.inlier_pt).min()),
                   float(valid(m_ln, ref.inlier_ln | got.inlier_ln).min()),
                   float(m_good.min()))
    n_res = 2.0 * ref.n_inliers.double()
    eye = torch.eye(6, dtype=torch.float64, device=H.device)
    cov64 = (sse / (n_res - 6.0).clamp(min=1.0))[:, None, None] * (
        torch.linalg.inv(H + 1e-6 * eye))
    err64 = torch.sqrt(sse / n_res.clamp(min=1.0))
    dist = lambda c, x: (c.double() - x.double()).abs().amax((-1, -2))
    r_cov = torch.maximum(dist(got.cov, cov64), dist(got.cov, ref.cov)) / (
        F64_FACTOR * dist(ref.cov, cov64)
        + F64_FLOOR * cov64.abs().amax((-1, -2)))
    d_err = lambda e, x: (e.double() - x.double()).abs()
    r_err = torch.maximum(d_err(got.err, err64), d_err(got.err, ref.err)) / (
        F64_FACTOR * d_err(ref.err, err64) + F64_FLOOR * err64.abs())
    err_rel = (got.err.double() - ref.err.double()).abs() / (
        ref.err.double().abs().clamp(min=1e-30))
    s = lambda x: float(x[same].max()) if same.any() else 0.0
    errs = [max_abs_err(got.T[same], ref.T[same]) if same.any() else 0.0,
            s(r_cov), s(r_err), float(bad)]
    return errs, smallest, s(err_rel), (~same).nonzero().flatten().tolist()


# K13 with lines only (K = 0): T within 1e-5 of the plain version, the
# decisions exact (or within 1e-4 of their threshold), and cov and err
# within 1e-3 of the plain version's, relative. The float64 rule of the
# other rows anchors its statistics at the plain version's pose, but with
# lines only err moves ~1e-3 relative a 1e-6 twist of the pose, the
# distance of either f32 pose from a float64 solve of the same problems
# (the [k13] lines print both), so a pose difference well inside f32
# rounding fails that rule
LINES_ONLY_GN_TOLS = [1e-5, 1e-3, 1e-3, 0]
LINES_ONLY_GN_KIND = ("T abs; cov relative to its largest entry, err "
                      "relative, against the plain version; decisions "
                      "beyond 1e-4 of their threshold")


def lines_only_cov_rel(got, ref, differ) -> float:
    """The covariances' largest difference relative to the plain one's
    largest entry, over the pairs whose inlier masks agree."""
    same = [b for b in range(got.cov.shape[0]) if b not in differ]
    d = ((got.cov[same].double() - ref.cov[same].double()).abs()
         .amax((-1, -2)) / ref.cov[same].double().abs().amax((-1, -2)))
    return float(d.max()) if same else 0.0


def lm_ops(B, K, L, cfg):
    """gn_ops of optimize_pose_lm: one evaluation of the terms (norms,
    median, normal equations with the cost) at the start and one an LM
    iteration (the trial pose's, whose H and g are the next iteration's
    when it is accepted), then the tail's 1 + max_iters_ref iterations,
    gate and final statistics."""
    t = cfg.tracking
    return gn_ops(B, K, L, 1 + 2 * t.max_iters + 1 + t.max_iters_ref + 2)


def hold_lm(got, ref):
    """The LM iterations on the card (``got``, an LMTrace) against the
    plain version's (``ref``): per pair, the first iteration whose lambda
    differs (so whose accept decision differs) must be one where the plain
    version's trial cost lies within DECISION_MARGIN of its cost, relative.
    Returns (the count of pairs that break this, the pairs whose sequence
    differs, the smallest margin of any decision, the largest relative
    difference of the trial costs over the pairs that agree)."""
    import torch
    c, c_try = ref.cost[..., 0].double(), ref.cost[..., 1].double()
    margin = ((c_try - c).abs() / c.abs().clamp(min=1e-30))
    margin = torch.where(torch.isfinite(margin), margin,
                         torch.full_like(margin, math.inf))
    bad, differ = 0, []
    for b in range(got.lam.shape[0]):
        d = (got.lam[b] != ref.lam[b]).nonzero()
        if len(d):
            differ.append(b)
            bad += int(margin[b, int(d[0])] >= DECISION_MARGIN)
    keep = [b for b in range(got.lam.shape[0]) if b not in differ]
    rel = ((got.cost[keep].double() - ref.cost[keep].double()).abs()
           / ref.cost[keep].double().abs().clamp(min=1e-30))
    rel = float(rel[torch.isfinite(rel)].max()) if rel.numel() else 0.0
    return bad, differ, float(margin.min()) if margin.numel() else math.inf, \
        rel


def lm_rows(dev, record, cfg):
    """Kernel I's LM mode (optimize_pose_lm, one launch) at K13's shapes:
    20 pairs with and without lines (K 1,024, L 128), one pair, lines only
    (K = 0) at 20 pairs: every PoseResult field held by K13's whole-call
    rule (the lines-only rule at K = 0), and the accept sequence and
    lambda by ``hold_lm``."""
    import torch
    from plslam_tpu_torch.tracking import pose_gn
    K, L_max = cfg.points.max_kpts, cfg.lines.max_lines
    tail = pose_gn._lm_tail_cfg(cfg)
    n_lm = 2 * cfg.tracking.max_iters
    for B, K_, L, tag in ((CHUNK, K, L_max, ""), (CHUNK, K, 0, "_points"),
                          (1, K, L_max, "_b1"),
                          (CHUNK, 0, L_max, "_lines_only")):
        cam, pts, lns = gn_inputs(dev, B, K_, L, seed=7 + L + B,
                                  line_px=0.0 if K_ else 0.5)
        lns = lns if L else None
        T0 = torch.eye(4, device=dev).expand(B, 4, 4)
        T_lm, tr_ref = pose_gn.lm_iters_plain(
            T0, cam, pts, pose_gn._no_lines(pts) if lns is None else lns,
            n_lm, cfg.tracking.lm_init_lambda)
        # the plain version's tail from its own LM pose: optimize_pose_plain
        # with a first phase of one iteration, and its decisions' margins
        margins, ref, H, sse = pose_margins(T_lm, cam, pts, lns, tail)
        got, tr = pose_gn.optimize_pose_lm(T0, cam, pts, lns, cfg,
                                           trace=True)
        bad_lm, lm_differ, lm_margin, c_rel = hold_lm(tr, tr_ref)
        errs, smallest, err_rel, differ = hold_pose(got, ref, margins, H,
                                                    sse)
        n_acc = int((tr.lam[:, 1:] < tr.lam[:, :-1]).sum()
                    + (tr.lam[:, 0] < cfg.tracking.lm_init_lambda).sum())
        print(f"[k13] optimize_pose_lm{tag}: B={B} K={K_} L={L} good "
              f"{int(got.good.sum())}/{B} (plain {int(ref.good.sum())}); "
              f"{n_acc} of {B * n_lm} LM steps accepted; pairs whose "
              f"accept sequence differs {lm_differ} (smallest LM decision "
              f"margin {lm_margin:.3g}, beyond 1e-4: {bad_lm}); trial costs' "
              f"largest relative difference {c_rel:.3g}; smallest tail "
              f"decision margin {smallest:.6g}; pairs whose inlier masks "
              f"differ {differ}", flush=True)
        tols, kind = [1e-5, 1.0, 1.0, 0, 0], (
            "T abs; cov and err: distance from float64 / (3 x the plain "
            "version's + 1e-5 of the float64 value); tail decisions beyond "
            "1e-4 of their threshold; LM accept decisions beyond 1e-4")
        if not K_:
            errs = [errs[0], lines_only_cov_rel(got, ref, differ), err_rel,
                    errs[3]]
            tols, kind = LINES_ONLY_GN_TOLS + [0], (
                LINES_ONLY_GN_KIND + "; LM accept decisions beyond 1e-4")
        record("pose_gn_optimize@lm" + tag, "plslam_tpu_torch/csrc/pose_gn.cu",
               "plslam_tpu/tracking/pose_gn.py:198", None, None, tols,
               lambda: pose_gn.optimize_pose_lm(T0, cam, pts, lns, cfg),
               lambda: pose_gn.optimize_pose_lm_plain(T0, cam, pts, lns, cfg),
               B * (64 * 2 + K_ * 22 + L * 38 + 144 + 9),
               lm_ops(B, K_, L, cfg), entry="pose_gn_optimize",
               count="pose_gn_optimize@lm", no_path_caller=True,
               errs=errs + [float(bad_lm)], err_kind=kind)


def gn_inputs(dev, B, K, L, seed, line_px=0.0):
    """B tracking problems at the main path's term counts: K point terms
    (15% gross outliers, 5% invalid) and L line terms (2 behind the camera,
    15% invalid), as tests/test_torch_pose_gn.py builds them. ``line_px``
    > 0: the observed lines through endpoints with that pixel noise, a
    tenth of them 40 px off (the lines-only problems, whose scale the
    lines alone set; else the lines are exact)."""
    import torch
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.features import line_equation
    from plslam_tpu_torch.tracking import pose_gn
    cam = StereoCamera.from_config(SlamConfig().camera)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    box = lambda n, zlo, zhi: t(np.stack([rng.uniform(-8, 8, (B, n)),
                                          rng.uniform(-3, 3, (B, n)),
                                          rng.uniform(zlo, zhi, (B, n))], -1))
    P = box(K, 4, 40)
    T = lie.exp_se3(t(rng.normal(size=(B, 6))
                      * [0.05, 0.05, 0.3, 0.01, 0.03, 0.01]))
    uv = cam.project(lie.transform_points(T, P)) + t(
        rng.normal(0, 0.5, (B, K, 2)))
    uv[:, :int(0.15 * K)] += t(rng.normal(0, 40, (B, int(0.15 * K), 2)))
    sP = box(L, 4, 30)
    d = rng.normal(size=(B, L, 3))
    eP = sP + t(2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True))
    us = cam.project(lie.transform_points(T, sP))
    ue = cam.project(lie.transform_points(T, eP))
    if line_px:
        n_out = L // 10
        us, ue = (u + t(rng.normal(0, line_px, (B, L, 2))) for u in (us, ue))
        us[:, :n_out] += t(rng.normal(0, 40, (B, n_out, 2)))
    le = line_equation(us, ue)
    sP[:, :2, 2] = -1.0
    mask = lambda n, p: torch.from_numpy(rng.random((B, n)) > p).to(dev)
    pts = pose_gn.PointTerms(P.to(dev), uv.to(dev), mask(K, 0.05))
    lns = pose_gn.LineTerms(sP.to(dev), eP.to(dev), le.to(dev),
                            mask(L, 0.15))
    return cam, pts, lns


def medoid_inputs(g, N, R, dev):
    """Rings of N landmarks (R packed members each, a quarter with a
    repeated member: ties), counts 0..6 (0 and above R), three quarters of
    the rows valid, and the rows' old descriptors."""
    import torch
    ring = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, R, 8), generator=g,
                         dtype=torch.int64).to(torch.int32)
    ring[: N // 4, R - 1] = ring[: N // 4, 0]              # ties
    count = torch.randint(0, 7, (N,), generator=g).to(torch.int32)
    valid = torch.rand((N,), generator=g) < 0.75
    desc = torch.randint(0, 2, (N, 256), generator=g, dtype=torch.uint8)
    return tuple(x.to(dev) for x in (ring, count, valid, desc))


def slam_kernel_phase(dev, record):
    """Kernels I (K13, both configurations), J (K14, K16) and D at the map
    matching's shapes, against their plain versions on the card."""
    import torch
    from plslam_tpu_torch.backend import fused_slam, map as tmap
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.tracking import pose_gn

    cfg = SlamConfig()
    t = cfg.tracking
    K = cfg.points.max_kpts
    # I, phase-only form (gn_iters): one GN phase of the 20 pairs of a
    # chunk, K = 1024 point and L = 128 line terms (L = 0 points only): the
    # final pass's 8 iterations, and the lite pass's 6
    T0 = torch.eye(4, device=dev).expand(CHUNK, 4, 4)
    for L, n_it, tag in ((cfg.lines.max_lines, t.max_iters, ""),
                         (0, t.max_iters, "_points"),
                         (cfg.lines.max_lines, t.lite_pass_iters, "_lite")):
        cam, pts, lns = gn_inputs(dev, CHUNK, K, L, seed=3 + L)
        got = pose_gn.gn_iters(T0, cam, pts, lns, n_it)
        ref = pose_gn.gn_iters_plain(T0, cam, pts, lns, n_it)
        record("pose_gn_optimize@phase" + tag,
               "plslam_tpu_torch/csrc/pose_gn.cu",
               "plslam_tpu/tracking/pose_gn.py:144", [got], [ref], 1e-5,
               lambda: pose_gn.gn_iters(T0, cam, pts, lns, n_it),
               lambda: pose_gn.gn_iters_plain(T0, cam, pts, lns, n_it),
               CHUNK * (64 * 2 + K * 21 + L * 37),
               gn_ops(CHUNK, K, L, n_it), entry="pose_gn_optimize",
               err_kind="pose entries")
    # I, whole (optimize_pose, one launch): the chunk's final pass (8 + 8
    # iterations) with and without lines, its lite pass (6 + 4), and one
    # pair (B = 1: a per-frame step, a loop verification, a scan-mode
    # frame); lines only (K = 0 point terms) at 20 pairs and one
    L_max = cfg.lines.max_lines
    lite = cfg.with_updates({"tracking": {
        "max_iters": t.lite_pass_iters,
        "max_iters_ref": t.lite_pass_iters_ref}})
    for B, K, L, c, tag in ((CHUNK, K, L_max, cfg, ""),
                            (CHUNK, K, 0, cfg, "@points"),
                            (CHUNK, K, L_max, lite, "@lite"),
                            (1, K, L_max, cfg, "@b1"),
                            (CHUNK, 0, L_max, cfg, "@lines_only"),
                            (1, 0, L_max, cfg, "@lines_only_b1")):
        cam, pts, lns = gn_inputs(dev, B, K, L, seed=5 + L + B,
                                  line_px=0.0 if K else 0.5)
        lns = lns if L else None
        T0 = torch.eye(4, device=dev).expand(B, 4, 4)
        margins, ref, H, sse = pose_margins(T0, cam, pts, lns, c)
        got = pose_gn.optimize_pose(T0, cam, pts, lns, c)
        errs, smallest, err_rel, differ = hold_pose(got, ref, margins, H,
                                                    sse)
        print(f"[k13] optimize_pose{tag}: B={B} K={K} L={L} good "
              f"{int(got.good.sum())}/{B} (plain {int(ref.good.sum())}); "
              f"smallest decision margin {smallest:.6g}; err's largest "
              f"relative difference from the plain version's {err_rel:.3g}"
              f"; pairs whose inlier masks differ {differ}; cov and err "
              f"against the float64 statistics at the plain version's pose "
              f"{errs[1]:.3g}, {errs[2]:.3g} of K15's bound", flush=True)
        n_it = c.tracking.max_iters + c.tracking.max_iters_ref
        tols, kind = [1e-5, 1.0, 1.0, 0], (
            "T abs; cov and err: distance from float64 / (3 x the plain "
            "version's + 1e-5 of the float64 value); decisions beyond 1e-4 "
            "of their threshold")
        if not K:
            errs = [errs[0], lines_only_cov_rel(got, ref, differ), err_rel,
                    errs[3]]
            tols, kind = LINES_ONLY_GN_TOLS, LINES_ONLY_GN_KIND
            r64 = pose_gn.optimize_pose_plain(T0.double(), cam, _as_f64(pts),
                                              _as_f64(lns), c)
            d_T = lambda r: float((r.T.double() - r64.T).abs().max())
            d_e = lambda r: float(((r.err.double() - r64.err).abs()
                                   / r64.err).max())
            print(f"[k13] optimize_pose{tag}: from a float64 solve of the "
                  f"same problems: T kernel {d_T(got):.3g}, plain "
                  f"{d_T(ref):.3g}; err (relative) kernel {d_e(got):.3g}, "
                  f"plain {d_e(ref):.3g}", flush=True)
        record("pose_gn_optimize" + tag, "plslam_tpu_torch/csrc/pose_gn.cu",
               "plslam_tpu/tracking/pose_gn.py:130", None, None, tols,
               lambda: pose_gn.optimize_pose(T0, cam, pts, lns, c),
               lambda: pose_gn.optimize_pose_plain(T0, cam, pts, lns, c),
               B * (64 * 2 + K * 22 + L * 38 + 144 + 9),
               gn_ops(B, K, L, n_it + 2), entry="pose_gn_optimize",
               errs=errs, err_kind=kind)
    # I, LM mode (optimize_pose_lm, one launch)
    lm_rows(dev, record, cfg)

    # J, kf_scan: a chunk of 20 tracked frames against the carry
    rng = np.random.default_rng(4)
    xi = rng.normal(size=(CHUNK, 6)) * [0.05, 0.02, 0.4, 0.01, 0.03, 0.01]
    DT = lie.exp_se3(torch.from_numpy(xi.astype(np.float32))).to(dev)
    A = rng.normal(size=(CHUNK, 6, 6)) * 1e-3
    cov = torch.from_numpy((A @ A.transpose(0, 2, 1) + 1e-6 * np.eye(6))
                           .astype(np.float32)).to(dev)
    good = torch.from_numpy(rng.random(CHUNK) > 0.1).to(dev)
    carry = fused_slam.init_crit_carry(dev)
    kmax = cfg.system.kf_batch
    got = fused_slam.kf_scan(DT, cov, good, carry, cfg, kmax)
    ref = fused_slam.kf_scan_plain(DT, cov, good, carry, cfg, kmax)
    # bytes: DT, cov and good in, flags, T_accs, ratios and blocked out,
    # the carry's 282 bytes of fields in and out
    record("kf_scan", "plslam_tpu_torch/csrc/slam.cu",
           "plslam_tpu/backend/fused_slam.py:83", list(got[:4]),
           list(ref[:4]), [0.0, 1e-5, 1e-4, 0.0],
           lambda: fused_slam.kf_scan(DT, cov, good, carry, cfg, kmax),
           lambda: fused_slam.kf_scan_plain(DT, cov, good, carry, cfg, kmax),
           CHUNK * (64 + 144 + 1) + CHUNK * (1 + 64 + 4 + 1) + 2 * 282,
           CHUNK * 2500, err_kind="flags, blocked exact; T_acc, ratio")
    check(fused_slam._packed_base(got[4]) is not None,
          "kf_scan: the carry out is not packed")
    grid = launched_grid(lambda: fused_slam.kf_scan(DT, cov, good, carry,
                                                    cfg, kmax),
                         "kf_scan_kernel")
    print(f"[kf_scan] B={CHUNK}: launched with grid, block "
          f"{grid if grid else 'not recorded by the profiler'} (one CTA, "
          "five warps scan)", flush=True)
    check(grid is None or (list(grid[0]) == [1, 1, 1]
                           and list(grid[1]) == [256, 1, 1]),
          f"kf_scan: grid, block {grid}, expected 1 CTA of 256 threads")

    # J, medoid: the 4-deep rings of the 8192 map points and 1024 lines,
    # gated and unpacked into the map's (N, 256) rows in the same launch
    g = torch.Generator(device="cpu").manual_seed(6)
    R = cfg.mapping.desc_ring
    for N, tag in ((cfg.mapping.max_points, "@points"),
                   (cfg.mapping.max_lines, "@lines")):
        ring, count, valid, desc = medoid_inputs(g, N, R, dev)
        n_valid = int(valid.sum())
        # bytes: a valid row reads its ring, count and flag, an invalid one
        # its flag and desc row; every row writes 256 bytes. Operations: R^2
        # x 8 words (xor, popcount, add) a valid row
        record("medoid" + tag, "plslam_tpu_torch/csrc/slam.cu",
               "plslam_tpu/backend/map.py:112, :242-244, :303-306",
               [tmap._medoid_bits(ring, count, valid, desc)],
               [tmap._medoid_bits_plain(ring, count, valid, desc)], 0.0,
               lambda: tmap._medoid_bits(ring, count, valid, desc),
               lambda: tmap._medoid_bits_plain(ring, count, valid, desc),
               n_valid * (R * 32 + 4 + 1) + (N - n_valid) * (1 + 256)
               + N * 256, n_valid * R * R * 8 * 3, entry="medoid",
               err_kind="rows, exact")

    # D at the map matching's shapes: 8192 map points x 1024 features,
    # 1024 map lines x 128 segments, packed words, the f2f window
    for N, M, tag, md, ratio in (
            (cfg.mapping.max_points, cfg.points.max_kpts, "@map", 80, 0.75),
            (cfg.mapping.max_lines, cfg.lines.max_lines, "@map_lines", 90,
             0.9)):
        matcher_case(record, g, dev, 1, N, M, "window", tag, words=True,
                     md=md, ratio=ratio, radius=cfg.matching.f2f_window)


# ATE bound of the SLAM path (m), its keyframe count and keyframe frames:
# the port's own CPU run of the same frames (``--cpu-ate``: the plain
# versions, device="cpu"); the bound leaves a margin of 2x plus 2 cm
SLAM_ATE_CPU_MEASURED = 0.03782223584693017
SLAM_KF_FRAMES_CPU = [3, 7, 11, 15, 20, 24, 28, 32, 40, 44, 48, 52, 60, 64,
                      68, 72, 80, 84, 88, 92]
SLAM_CHUNKS = 5
THRESHOLD_MARGIN = 1e-4


def slam_scene():
    """bench_slam.py's scene (seed 0, loop, 400 points, 60 lines, noise
    0.004, step 0.15) at the full KITTI width, cut to 1 + 5 x 20 frames,
    as uint8 frames the way bench_slam.py feeds them."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cfg = SlamConfig().with_updates({"loop": {"enabled": False}})
    cam = StereoCamera.from_config(cfg.camera)
    n = 1 + SLAM_CHUNKS * CHUNK
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cam, n_frames=n, seed=0, kind="loop",
                                  n_points=400, n_lines=60, noise=0.004,
                                  step=0.15)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    print(f"[slam] rendered {n} frames in {time.perf_counter() - t0:.1f} s "
          "(host)", flush=True)
    return cfg, cam, seq, u8(np.asarray(seq.images_l)), u8(
        np.asarray(seq.images_r))


def drive_slam(slam, il, ir, dev_chunks=None, n_chunks=SLAM_CHUNKS):
    slam.initialize(il[0], ir[0])
    for c in range(n_chunks):
        lo = 1 + c * CHUNK
        if dev_chunks is not None:
            slam.process_chunk(dev_chunks[c])
        else:
            slam.process_chunk(il[lo:lo + CHUNK], ir[lo:lo + CHUNK])
    return slam.finish()


def decisions(slam, cfg):
    """Per frame: (keyframe flag, margin of its closest threshold)."""
    rows = np.concatenate(slam.frame_rows)
    k = cfg.keyframe
    T = rows[:, 16:32].reshape(-1, 4, 4).astype(np.float64)
    t = np.linalg.norm(T[:, :3, 3], axis=-1)
    r = np.arccos(np.clip((np.trace(T[:, :3, :3], axis1=1, axis2=2) - 1)
                          * 0.5, -1, 1))
    ratio = rows[:, 36]
    margin = np.minimum(np.abs(np.nan_to_num(ratio - k.min_entropy_ratio,
                                             nan=np.inf)),
                        np.minimum(np.abs(t - k.max_kf_t_dist),
                                   np.abs(r - np.deg2rad(k.max_kf_r_dist))))
    return rows[:, 33] > 0.5, rows[:, 32] > 0.5, margin


# launches of one window LBA (6 LM iterations: per iteration one step of 4
# launches and a trial cost of 1, plus the initial cost, the landmark index
# and the post-hoc flags; lba_solve's entry launches two kernels, the Schur
# complement with the solve and the landmark steps). A graph replay of
# run_lba counts the same launches.
PER_LBA = {"lba_terms": 14, "lba_camera": 6, "lba_index": 1, "lba_bin": 6,
           "lba_solve": 6}
# a keyframe's insertion: a medoid and a map match for points and lines
PER_KF = {"medoid": 2, "hamming_scan": 2, "hamming_finish": 2}


def expected_slam_launches(n_kfs: int, n_lba: int,
                           n_chunks: int = SLAM_CHUNKS) -> dict:
    """Launches of the SLAM path: initialize (one extraction and one
    keyframe insertion), ``n_chunks`` chunks (extraction, tracking with 2
    optimize_pose launches, kf_scan), every keyframe's insertion (a medoid
    and a map match for points and for lines) and every window LBA
    (``PER_LBA``)."""
    from collections import Counter
    n = Counter()
    for table, times in ((EXTRACT_POINTS, n_chunks + 1),
                         (EXTRACT_LINES, n_chunks + 1),
                         (TRACK, 2 * n_chunks), (GN, n_chunks),
                         ({"kf_scan": 1}, n_chunks),
                         (PER_KF, n_kfs), (PER_LBA, n_lba)):
        for k, v in table.items():
            n[k] += v * times
    return dict(n)


def n_lba_slots(flags, n_chunks, cfg) -> int:
    """The window LBAs of a run from its keyframe flags, chunk by chunk."""
    from plslam_tpu_torch.backend.chunk_backend import lba_slot_flags
    kmax = cfg.system.kf_batch
    return sum(sum(lba_slot_flags([True] * int(f.sum())
                                  + [False] * (kmax - int(f.sum())),
                                  cfg.mapping.lba_kf_stride))
               for f in np.split(flags, n_chunks))


def slam_path(dev):
    """FusedPLSLAM (loops off) on the 101 frames: a warm-up run, then the
    timed run with device-resident chunks; returns (launches, slam)."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse

    cfg, cam, seq, il, ir = slam_scene()
    dev_chunks = [torch.from_numpy(np.stack([il[lo:lo + CHUNK],
                                             ir[lo:lo + CHUNK]])).to(dev)
                  for lo in range(1, 1 + SLAM_CHUNKS * CHUNK, CHUNK)]
    warm = FusedPLSLAM(cfg, cam)
    warm.initialize(il[0], ir[0])
    for c in dev_chunks[:2]:
        warm.process_chunk(c)
    warm.finish()

    slam = FusedPLSLAM(cfg, cam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    t0 = time.perf_counter()
    est = drive_slam(slam, il, ir, dev_chunks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_frames = SLAM_CHUNKS * CHUNK
    flags, good, margin = decisions(slam, cfg)
    kf_frames = np.nonzero(flags)[0]
    ate = float(ate_rmse(est, seq.poses[:len(est)]))
    recs = slam.summaries
    n_lba = n_lba_slots(flags, SLAM_CHUNKS, cfg)
    n_pts, n_lns = slam.n_landmarks()
    print(f"[slam] frames={n_frames} good={int(good.sum())} keyframes="
          f"{len(recs)} (frames {kf_frames.tolist()}) lba_slots={n_lba} "
          f"map points={n_pts} lines={n_lns} ate_m={ate:.6f}", flush=True)
    print(f"[slam] fps={n_frames / wall:.2f} ms_per_frame="
          f"{1e3 * wall / n_frames:.3f} (host clock, initialize + 5 chunks "
          f"+ finish, ends in synchronize) max_memory_allocated_bytes={peak}",
          flush=True)
    print(f"[slam] smallest keyframe-decision margin {margin.min():.6g} "
          f"(frame {int(np.argmin(margin))})", flush=True)
    lba_recs = [r for r in recs if r.lba_cost0 != 0.0]
    costs = [(r.lba_cost0, r.lba_cost1) for r in lba_recs]
    print(f"[slam] lba cost0 -> cost1 per LBA slot: {costs}", flush=True)
    print(f"[slam] launches={json.dumps(launches, sort_keys=True)}",
          flush=True)
    check(bool(good.all()), f"slam: frames not tracked: "
          f"{np.nonzero(~good)[0]}")
    if SLAM_ATE_CPU_MEASURED is not None:
        bound_m = 2 * SLAM_ATE_CPU_MEASURED + 0.02
        check(math.isfinite(ate) and ate < bound_m,
              f"slam: ATE {ate} m outside its bound {bound_m} m")
    if SLAM_KF_FRAMES_CPU is not None:
        cpu = np.zeros(n_frames, bool)
        cpu[SLAM_KF_FRAMES_CPU] = True
        differ = np.nonzero(cpu != flags)[0]
        if differ.size:
            first = int(differ[0])
            print(f"[slam] first keyframe decision that differs from the CPU "
                  f"run: frame {first}, margin {margin[first]:.6g}",
                  flush=True)
        check(len(kf_frames) == int(cpu.sum())
              or (differ.size and margin[differ[0]] <= THRESHOLD_MARGIN),
              f"slam: {len(kf_frames)} keyframes, the CPU run "
              f"{int(cpu.sum())}")
    check(n_lba >= 1 and len(lba_recs) == n_lba,
          f"slam: {n_lba} LBA slots, {len(lba_recs)} with costs")
    check(all(r.lba_cost1 <= r.lba_cost0 for r in lba_recs),
          "slam: an LBA raised its cost")
    check(n_pts > 0 and n_lns > 0, "slam: empty map")
    want = expected_slam_launches(1 + len(recs), n_lba)
    check(launches == want, f"slam: launches {launches} differ from the "
          f"path's {want}")
    return launches, slam


def lba_window_problem(dev, cfg, cam, seed=5, K=None):
    """A well-conditioned window problem at the SLAM path's LBA shapes
    (W = window_kfs + fixed_kfs = 10 poses, K = 1024 unless given, L = 128,
    P = 4096 points, Q = 1024 endpoints of 512 lines), built as
    tests/test_lba.py::make_lba_problem builds its own: each KF sees a
    sliding run of the landmark ids, so every landmark has two or three
    observations, all inside the 1241x376 image; 0.3 px of noise, 10% of the observations detached, the
    oldest fixed_kfs KFs fixed and exact, the free ones perturbed by 0.03
    (rad, m) and the landmarks by 5 cm. Its MAD scale stays far above the
    1e-4 floor."""
    import torch
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.core import lie
    m = cfg.mapping
    W = m.window_kfs + m.fixed_kfs
    K, L = K or cfg.points.max_kpts, cfg.lines.max_lines
    P, M = m.lba_max_points, m.lba_max_lines
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)
    # in the frustum of every KF: the last is 2.7 m further on
    frustum = lambda n, z: np.stack([z * u(-0.4, 0.4, n),
                                     z * u(-0.15, 0.15, n), z], -1)
    pts = frustum(P, u(8, 40, P))
    eps = frustum(2 * M, u(8, 40, 2 * M))
    xi = np.array([[0.05 * w, 0.01 * w, -0.3 * w, 0.0, 0.015 * w, 0.0]
                   for w in range(W)], np.float32)
    poses = lie.exp_se3(torch.from_numpy(xi)).numpy().astype(np.float64)
    noisy = lambda a: a + 0.3 * rng.normal(size=a.shape)

    def proj(T, X):
        Pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * Pc[:, 0] / Pc[:, 2] + cam.cx,
                         cam.fy * Pc[:, 1] / Pc[:, 2] + cam.cy], -1), Pc[:, 2]
    obs_id = np.stack([(w * (P // W) + np.arange(K)) % P for w in range(W)])
    lines = np.stack([(w * (M // W) + np.arange(L)) % M for w in range(W)])
    uv, disp, les = [], [], []
    for w, T in enumerate(poses):
        uv_w, z = proj(T, pts[obs_id[w]])
        uv.append(noisy(uv_w))
        disp.append(noisy(cam.fx * cam.b / z))
        sp = noisy(proj(T, eps[2 * lines[w]])[0])
        ep = noisy(proj(T, eps[2 * lines[w] + 1])[0])
        le = np.stack([sp[:, 1] - ep[:, 1], ep[:, 0] - sp[:, 0],
                       sp[:, 0] * ep[:, 1] - sp[:, 1] * ep[:, 0]], -1)
        les.append(le / np.linalg.norm(le[:, :2], axis=-1, keepdims=True))
    obs_id[rng.random(obs_id.shape) < 0.1] = -1
    sid = 2 * lines
    sid[rng.random(sid.shape) < 0.1] = -1
    eid = np.where(sid >= 0, sid + 1, -1)
    fixed = np.arange(W) < m.fixed_kfs
    dpose = rng.normal(size=(W, 6)) * 0.03
    dpose[fixed] = 0.0
    kf_pose = (lie.exp_se3(torch.from_numpy(dpose.astype(np.float32))).numpy()
               @ poses.astype(np.float32))
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(
        dev).to(dt)
    i32 = torch.int32
    return lba.LBAProblem(
        kf_pose=t(kf_pose), kf_fixed=t(fixed, torch.bool),
        kf_valid=t(np.ones(W, bool), torch.bool),
        pt_pos=t(pts + 0.05 * rng.normal(size=pts.shape)),
        ep_pos=t(eps + 0.05 * rng.normal(size=eps.shape)),
        obs_pt_uv=t(np.stack(uv)), obs_pt_disp=t(np.stack(disp)),
        obs_pt_id=t(obs_id, i32), obs_ln_le=t(np.stack(les)),
        obs_ln_sid=t(sid, i32), obs_ln_eid=t(eid, i32))


def _rel_d(a, c) -> float:
    """Largest entry of |a - c| over c's largest magnitude, in float64."""
    return float((a.double() - c.double()).abs().max()
                 / c.double().abs().max().clamp(min=1e-30))


def _as_f64(nt):
    """A NamedTuple of tensors with its float fields in float64."""
    return type(nt)(*(x.double() if x.is_floating_point() else x
                      for x in nt))


# K15 on the well-conditioned window: each float output's distance from
# the plain version run in float64 on the card, relative to the output's
# largest magnitude, is held to F64_FACTOR times the plain version's own
# distance plus F64_FLOOR; so is its distance from the plain version. That
# bound must stay a tenth of what it measures: of 1 for the outputs of
# one LM step, and of how far run_lba moved each state.
F64_FACTOR = 3.0
F64_FLOOR = 1e-5


def f64_gauge(name, got, ref, truth, typical=None, hold=False, tag="lba"):
    """K15's rule: prints each output's distances (kernel from float64,
    plain from float64, kernel from plain; relative to each output's
    largest magnitude); with ``typical`` or ``hold``, holds the first and
    the last to F64_FACTOR x the second + F64_FLOOR, a bound that with
    ``typical`` must stay under a tenth of it. Returns the bounds."""
    d_k = [_rel_d(g, x) for g, x in zip(got, truth)]
    d_p = [_rel_d(r, x) for r, x in zip(ref, truth)]
    d_kp = [_rel_d(g, r) for g, r in zip(got, ref)]
    tols = [F64_FACTOR * p + F64_FLOOR for p in d_p]
    fmt = lambda xs: [f"{x:.3g}" for x in xs]
    print(f"[{tag}] {name} (relative to each output's largest magnitude): "
          f"kernel from float64 {fmt(d_k)}, plain from float64 {fmt(d_p)}, "
          f"kernel from plain {fmt(d_kp)}; bound {fmt(tols)}"
          + ("" if typical is None else f", against {fmt(typical)}"),
          flush=True)
    if typical is not None or hold:
        typical = typical or [math.inf] * len(tols)
        check(all(k <= t and kp <= t and t <= 0.1 * x for k, kp, t, x
                  in zip(d_k, d_kp, tols, typical)),
              f"{name}: kernel from float64 {d_k}, from plain {d_kp}, "
              f"bound {tols}, against {typical}")
    return tols


def lba_phase(dev, record, slam):
    """Kernel K (K15) on two window problems at the path's shapes.

    ``lba_window_problem`` (well conditioned): each launch against its
    plain version on the card (the JSON rows), one LM step and one whole
    ``run_lba``; the Schur pass, the back-substitution, the step and
    ``run_lba`` are held against the plain version in float64 as
    ``F64_FACTOR`` says.

    The SLAM run's final window: one whole ``run_lba``, kernels against
    plain versions, holding the cost (not raised; the kernels' final cost
    within a tenth of the plain run's decrease of the plain run's) and the
    inlier flags. Its MAD scale sits at the 1e-4 floor (most window
    landmarks have one exactly triangulated observation), so the step is
    ill conditioned: f32 in any summation order lands far from float64.
    The script prints that, the Schur gradient's distances from float64
    and how far the LBA moved the state, but holds no state tolerance
    there."""
    import torch
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.backend.map_handler import _build_window_problem
    cfg, cam = slam.cfg, slam.cam
    prob = lba_window_problem(dev, cfg, cam)
    W, K = prob.obs_pt_id.shape
    L = prob.obs_ln_sid.shape[1]
    P, Q = prob.pt_pos.shape[0], prob.ep_pos.shape[0]
    n_lm, NP, NL = P + Q, W * K, W * L
    src, rep = "plslam_tpu_torch/csrc/lba.cu", "plslam_tpu/backend/lba.py:"
    n_obs = int((prob.obs_pt_id >= 0).sum()) + int(
        (prob.obs_ln_sid >= 0).sum()) * 2
    print(f"[lba] window problem: W={W} K={K} L={L} P={P} Q={Q}, "
          f"{n_obs} observations attached", flush=True)
    rel = "relative to each output's largest magnitude"

    def scaled(got, ref, keep=()):
        """Float outputs relative to the plain one's largest magnitude,
        but for those in ``keep``."""
        s = [r.abs().max().clamp(min=1e-30)
             if r.is_floating_point() and i not in keep else None
             for i, r in enumerate(ref)]
        return ([g / x if x is not None else g for g, x in zip(got, s)],
                [r / x if x is not None else r for r, x in zip(ref, s)])

    t, sig, cost = lba.lba_terms_sigma(prob, cam)
    tp, sig_p, _ = lba.lba_terms_sigma_plain(prob, cam)
    check(float(sig_p) > 100 * 1e-4,
          f"lba: the window's MAD scale {float(sig_p)} is near its floor")
    # residuals and norms in px: each cancels projections of up to 1241
    # px, where an f32 ulp is 1.2e-4 px and the two versions' roundings
    # differ by up to a few ulps, so 4e-4 px; Jacobians relative;
    # validity exact. The scale and the cost against the plain version on
    # the kernel's own terms: the scale (a lower median) to the bit, the
    # cost within 1e-5 of itself.
    g_, r_ = scaled(list(t), list(tp), keep=(0, 4, 5))
    sig_t, cost_t = lba.lba_sigma_plain(t, prob)
    nv = NP + 2 * NL
    allr = torch.cat([t.rn.reshape(-1), t.r_ln.abs().reshape(-1)])
    valid_r = allr[torch.cat([t.ok_pt.reshape(-1), t.ok_ln.reshape(-1)])]
    med = torch.median(valid_r)
    check(torch.equal(sig, torch.clamp(1.4826 * med, min=1e-4)),
          "lba_terms: the scale is not torch.median's lower median")
    record("lba_terms", src, rep + "79", g_ + [sig, cost / cost_t],
           r_ + [sig_t, cost_t / cost_t],
           [4e-4, 1e-5, 1e-5, 0.0, 4e-4, 4e-4, 1e-5, 1e-5, 0.0, 0.0, 1e-5],
           lambda: lba.lba_terms_sigma(prob, cam),
           lambda: lba.lba_terms_sigma_plain(prob, cam),
           W * 64 + (P + Q) * 12 + NP * 16 + NL * 20
           + NP * (12 + 72 + 36 + 1 + 4) + 2 * NL * (4 + 24 + 12 + 1) + 8,
           NP * 120 + 2 * NL * 70 + nv * (10 + 8),
           lambda: torch.median(valid_r),
           library_what="torch.median of the valid |r| (the median alone)",
           err_kind="r_pt, rn, r_ln in px; Jacobians " + rel
           + "; sigma exact; cost relative")
    # a window of more than 32,768 observations (K = 4,096): the scale to
    # the bit, the cost within 1e-5
    wide = lba_window_problem(dev, cfg, cam, K=4096)
    tw, sig_w, cost_w = lba.lba_terms_sigma(wide, cam)
    sig_wp, cost_wp = lba.lba_sigma_plain(tw, wide)
    n_wide = wide.obs_pt_id.numel() + 2 * wide.obs_ln_sid.numel()
    wide_ms = device_ms(lambda: lba.lba_terms_sigma(wide, cam))
    print(f"[lba] lba_terms at W={W} K=4096 L={L} ({n_wide} observations): "
          f"sigma {float(sig_w)!r} (plain {float(sig_wp)!r}), cost "
          f"{float(cost_w)!r} (plain {float(cost_wp)!r}), device_ms="
          f"{wide_ms:.4f}", flush=True)
    check(n_wide > 32768 and torch.equal(sig_w, sig_wp)
          and abs(float(cost_w) - float(cost_wp)) <= 1e-5 * float(cost_wp),
          "lba_terms disagrees with its plain version at K = 4096")
    # the landmark index of that window (every point seen by every pose):
    # exact
    idx_w = lba.lba_index(wide)
    check(all(torch.equal(x, y) for x, y in zip(
        idx_w, lba.lba_index_plain(wide))),
        "lba_index disagrees with its plain version at K = 4096")
    print(f"[lba] lba_index at W={W} K=4096 L={L} ({n_wide} observations, "
          f"layout {lba.index_layout(W, 4096, L, P, Q)}): off and lists "
          f"equal to the plain version's, device_ms="
          f"{device_ms(lambda: lba.lba_index(wide)):.4f}", flush=True)
    del wide, tw, idx_w
    free = lba._free(prob)
    lam = torch.tensor(cfg.mapping.lambda_init, device=dev)
    sigma = sig_p
    # the landmark index: exact; bytes the id tables in, offsets and lists
    # out; operations a count, a fill and a rank per observation; the
    # yardstick the stable sort of the slot keys (the lists alone)
    idx = lba.lba_index(prob)
    C_i, S_i = lba.index_layout(W, K, L, P, Q)
    grid = launched_grid(lambda: lba.lba_index(prob), "lba_index_kernel")
    print(f"[lba] lba_index at W={W} K={K} L={L} P={P} Q={Q}: {C_i} CTAs of "
          f"{S_i} slots; launched with grid, block "
          f"{grid if grid else 'not recorded by the profiler'}", flush=True)
    check(grid is None or (list(grid[0]) == [C_i, 1, 1]
                           and list(grid[1]) == [1024, 1, 1]),
          f"lba_index: grid, block {grid}, expected {C_i} CTAs of 1024")
    pt_ids, ln_ids = prob.obs_pt_id.reshape(-1).long(), torch.stack(
        [prob.obs_ln_sid, prob.obs_ln_eid], dim=1).reshape(-1).long()
    keys = torch.cat([torch.where(pt_ids >= 0, pt_ids, n_lm),
                      torch.where(ln_ids >= 0, ln_ids + P, n_lm)])
    record("lba_index", src, rep + "182", list(idx),
           list(lba.lba_index_plain(prob)), 0.0,
           lambda: lba.lba_index(prob), lambda: lba.lba_index_plain(prob),
           (NP + 2 * NL) * 4 * 2 + (n_lm + 1) * 4, (NP + 2 * NL) * 8,
           lambda: torch.sort(keys, stable=True),
           err_kind="offsets, lists; exact")
    b = lba.lba_blocks(tp, prob, sigma, free, lam, idx)
    bp = lba.lba_blocks_plain(tp, prob, sigma, free, lam)
    g_, r_ = scaled(list(b[2:]), list(bp[2:]))
    ids = torch.clamp(prob.obs_pt_id.reshape(-1), min=0).long()
    payload = torch.randn((NP, 30), device=dev)
    bin_bytes = ((NP + 2 * NL) * 4 + NP * (72 + 36 + 12 + 5)
                 + 2 * NL * (40 + 1) + n_lm * 21 * 4 + W * n_lm * 72)
    bin_ops = NP * 180 + 2 * NL * 80 + n_lm * 60
    bin_lib = lambda: torch.zeros((P, 30), device=dev).index_add_(0, ids,
                                                                  payload)
    record("lba_bin", src, rep + "182", g_, r_, [1e-5, 1e-3, 1e-5, 1e-5],
           lambda: lba.lba_bin(tp, prob, sigma, free, lam, idx),
           lambda: lba.lba_bin_plain(tp, prob, sigma, free, lam),
           bin_bytes, bin_ops, bin_lib,
           err_kind="H_ll, H_inv, g_l, H_cl " + rel)
    b64 = _as_f64(bp)

    def graph_vs_eager(problem, res):
        """run_lba (a replay of its CUDA graph: the SLAM path captured this
        shape) bit-equal to the eager loop of kernels; both timed, with
        their device kernels."""
        eager = lambda: lba._run(problem, cam, cfg, lba._KERNELS)
        check(all(torch.equal(x, y) for x, y in zip(res, eager())),
              "run_lba's graph replay differs from the eager kernel loop")
        run = lambda: lba.run_lba(problem, cam, cfg)
        # the replay launches lba_camera's clusters: the grid the profiler
        # saw inside the graph
        Wp, Kp = problem.obs_pt_id.shape
        C, _, T = lba.camera_layout(Wp, Kp, problem.obs_ln_sid.shape[1])
        grid = launched_grid(run, "camera_kernel")
        print(f"[lba] run_lba's graph replay launched lba_camera with grid, "
              f"block {grid if grid else 'not recorded by the profiler'}; "
              f"cluster {C}", flush=True)
        check(grid is None or (list(grid[0]) == [C, Wp, 1]
                               and list(grid[1]) == [T, 1, 1]),
              f"run_lba's replay: lba_camera grid, block {grid}")
        g_ms, e_ms = cuda_ms(run, 10), cuda_ms(eager, 10)
        (g_dev, g_n), (e_dev, e_n) = all_kernels(run, 3), all_kernels(eager, 3)
        print(f"[lba] run_lba as a graph replay {g_ms:.4f} ms ({g_n:g} "
              f"device kernels, {g_dev:.4f} ms device), eagerly {e_ms:.4f} ms "
              f"({e_n:g}, {e_dev:.4f} ms device); bit-equal", flush=True)

    # the sums over observations (camera blocks, Schur pass, back-
    # substitution) are held against float64 sums of the same f32 inputs
    tols = f64_gauge("lba_camera (H_cc, g_c)", b[:2], bp[:2],
                     lba.lba_camera_plain(_as_f64(tp), sigma.double(), free),
                     [1, 1])
    g_, r_ = scaled(list(b[:2]), list(bp[:2]))
    # a thread-block cluster of C CTAs of T threads a pose: the grid the
    # profiler saw is (C, W) CTAs (inside run_lba's graph too: the SLAM
    # path's replays launch it)
    C, S, T = lba.camera_layout(W, K, L)
    grid = launched_grid(lambda: lba.lba_camera(tp, sigma, free),
                         "camera_kernel")
    print(f"[lba] lba_camera launched with grid, block "
          f"{grid if grid else 'not recorded by the profiler'}; cluster {C} "
          f"CTA(s) a pose, {S} observations a CTA", flush=True)
    check(grid is None or (list(grid[0]) == [C, W, 1]
                           and list(grid[1]) == [T, 1, 1]),
          f"lba_camera: grid, block {grid}, expected ({C}, {W}) CTAs of {T} "
          "threads")
    record("lba_camera", src, rep + "226", g_, r_, tols,
           lambda: lba.lba_camera(tp, sigma, free),
           lambda: lba.lba_camera_plain(tp, sigma, free),
           NP * (72 + 12 + 5) + 2 * NL * (24 + 5) + W * 168,
           NP * 3 * 27 * 2 + 2 * NL * 27 * 2,
           err_kind=rel + f", tolerance {F64_FACTOR:g}x the plain one's "
           f"distance from float64 + {F64_FLOOR:g}", cluster=C)
    # one step after the blocks (lba_solve: the Schur complement over the
    # observed pose pairs, the damped 6W x 6W solve and the landmark steps)
    # on the plain blocks, held to float64; two launches bit-equal. Bytes:
    # the observed blocks of H_cl, H_inv, g_l, H_ll's diagonal, H_cc, g_c,
    # the index, the outputs; operations: B = C H_inv and its gradient and
    # landmark-step products per observed pair, B C^T per observed pose
    # pair w <= v, the LU of the free poses' block and its triangular
    # solves, the landmark steps.
    # The yardstick: the library's dense solve of the reduced system alone.
    Sp, gp = lba.lba_schur_plain(bp, free, lam)
    solve = lambda: lba.lba_solve(bp, prob, free, lam, idx)
    got = solve()
    ref = lba.lba_solve_plain(bp, free, lam, P)
    tols = f64_gauge("lba_solve (dxi, d_pt, d_ep)", got, ref,
                     lba.lba_solve_plain(b64, free, lam.double(), P),
                     [1, 1, 1])
    check(all(torch.equal(x, y) for x, y in zip(got, solve())),
          "lba_solve: two launches on the same blocks differ")
    total = int(idx.off[-1])
    g_obs = idx.obs[:total].long()
    pose = torch.where(g_obs < W * K, g_obs // K, (g_obs - W * K) // (2 * L))
    lm_of = torch.repeat_interleave(torch.arange(n_lm, device=dev),
                                    (idx.off[1:] - idx.off[:-1]).long())
    seen = torch.zeros((n_lm, W), dtype=torch.bool, device=dev)
    seen[lm_of, pose] = True
    seen &= free[None, :]
    per_lm = seen.sum(1)
    n_obs_pairs = int(per_lm.sum())
    n_pose_pairs = int((per_lm * (per_lm + 1) // 2).sum())
    n6, nf = 6 * W, 6 * int(free.sum())
    solve_bytes = (n_obs_pairs * 72 + n_lm * (36 + 12 + 12 + 12)
                   + (n_lm + 1 + total) * 4 + W * (144 + 24 + 1 + 24) + 4)
    solve_ops = (n_obs_pairs * (108 + 36 + 36) + n_pose_pairs * 216
                 + 2 * nf ** 3 // 3 + 2 * nf ** 2 + n_lm * 28)
    print(f"[lba] lba_solve: {n_obs_pairs} observed (landmark, free pose) "
          f"pairs, {n_pose_pairs} pose pairs w <= v over the landmarks; the "
          f"LU of the free poses' {nf}x{nf} block of the {n6}x{n6} system "
          f"is a chain of {nf} pivot steps, each behind a barrier of the "
          f"block, that no roofline covers", flush=True)
    g_, r_ = scaled(got, ref)
    record("lba_solve", src, rep + "270", g_, r_, tols, solve,
           lambda: lba.lba_solve_plain(bp, free, lam, P), solve_bytes,
           solve_ops, lambda: torch.linalg.solve_ex(Sp, gp[:, None]),
           library_what=f"torch.linalg.solve_ex of the {n6}x{n6} reduced "
           "system alone",
           err_kind=rel + f", tolerance {F64_FACTOR:g}x the plain one's "
           f"distance from float64 + {F64_FLOOR:g}")

    # one LM step and one whole run_lba, kernels against plain versions
    p64 = _as_f64(prob)
    step = lba._step(prob, cam, lam, lba._KERNELS, idx)
    idx_p = lba.lba_index_plain(prob)
    step_p = lba._step(prob, cam, lam, lba._PLAIN, idx_p)
    step_t = lba._step(p64, cam, lam, lba._PLAIN, idx_p)
    f64_gauge("one LM step (dxi, d_pt, d_ep)", step, step_p, step_t,
              [1, 1, 1])
    fields = ("kf_pose", "pt_pos", "ep_pos")
    res, res_p = lba.run_lba(prob, cam, cfg), lba.run_lba_plain(prob, cam, cfg)
    res_t = lba.run_lba_plain(p64, cam, cfg)
    graph_vs_eager(prob, res)
    moved = [_rel_d(getattr(res_t, f), getattr(prob, f)) for f in fields]
    same_inl = float((res.obs_pt_inlier == res_p.obs_pt_inlier).float().mean())
    print(f"[lba] run_lba: cost {float(res.cost0):.6g} -> "
          f"{float(res.cost1):.6g} (plain {float(res_p.cost1):.6g}, float64 "
          f"{float(res_t.cost1):.6g}); point inlier flags identical "
          f"{same_inl:.5f}", flush=True)
    f64_gauge("run_lba (poses, points, endpoints; bound against how far "
              "it moved each)", [getattr(res, f) for f in fields],
              [getattr(res_p, f) for f in fields],
              [getattr(res_t, f) for f in fields], moved)
    check(float(res.cost1) < float(res.cost0), "run_lba did not lower the "
          "cost")
    check(same_inl >= 0.999, "run_lba's inlier flags differ from the plain "
          f"version's: {same_inl}")

    # the SLAM run's final window
    prob, _ = _build_window_problem(slam.state, cam, cfg)
    n_obs = int((prob.obs_pt_id >= 0).sum()) + int(
        (prob.obs_ln_sid >= 0).sum()) * 2
    p64 = _as_f64(prob)
    idx_p = lba.lba_index_plain(prob)
    step_p = lba._step(prob, cam, lam, lba._PLAIN, idx_p)
    step_t = lba._step(p64, cam, lam, lba._PLAIN, idx_p)
    tp, sig_w, _ = lba.lba_terms_sigma_plain(prob, cam)
    bp = lba.lba_blocks_plain(tp, prob, sig_w, lba._free(prob), lam)
    b64 = _as_f64(bp)
    free = lba._free(prob)
    P = prob.pt_pos.shape[0]
    f64_gauge("SLAM window lba_solve (dxi, d_pt, d_ep)",
              lba.lba_solve(bp, prob, free, lam, lba.lba_index(prob)),
              lba.lba_solve_plain(bp, free, lam, P),
              lba.lba_solve_plain(b64, free, lam.double(), P), hold=True)
    res, res_p = lba.run_lba(prob, cam, cfg), lba.run_lba_plain(prob, cam, cfg)
    res_t = lba.run_lba_plain(p64, cam, cfg)
    graph_vs_eager(prob, res)
    f64_gauge("SLAM window run_lba (poses, points, endpoints)",
              [getattr(res, f) for f in fields],
              [getattr(res_p, f) for f in fields],
              [getattr(res_t, f) for f in fields], hold=True)
    d_run = [_rel_d(getattr(res, f), getattr(res_p, f)) for f in fields]
    moved = [_rel_d(getattr(res_p, f), getattr(prob, f)) for f in fields]
    same_inl = float((res.obs_pt_inlier == res_p.obs_pt_inlier).float().mean())
    c0, c1, c1_p = float(res.cost0), float(res.cost1), float(res_p.cost1)
    print(f"[lba] SLAM window: {n_obs} observations attached, MAD scale "
          f"{float(sig_w):.3g}; one LM step, plain vs float64 (dxi, d_pt, "
          f"d_ep; {rel}) "
          f"{[f'{_rel_d(c, x):.3g}' for c, x in zip(step_p, step_t)]}; "
          f"run_lba cost {c0:.6g} -> {c1:.6g} (plain {c1_p:.6g}, float64 "
          f"{float(res_t.cost1):.6g}); poses, points, endpoints: kernel vs "
          f"plain {[f'{x:.3g}' for x in d_run]}, moved by "
          f"{[f'{x:.3g}' for x in moved]}; point inlier flags identical "
          f"{same_inl:.5f}", flush=True)
    check(c1 <= c0, "run_lba raised the SLAM window's cost")
    check(abs(c1 - c1_p) <= 0.1 * (float(res_p.cost0) - c1_p),
          f"run_lba on the SLAM window: final cost {c1} against the plain "
          f"run's {c1_p} from {float(res_p.cost0)}")
    check(same_inl >= 0.999, "run_lba's inlier flags on the SLAM window "
          f"differ from the plain version's: {same_inl}")


# -- slice 4: loop closure ---------------------------------------------------

LOOP_CHUNKS = 11
LOOP_LAP = 110
# The loop path's CPU run (``--cpu-ate loops``: the port's plain versions,
# device="cpu", the same frames): keyframe frames, loop events (from, to,
# inliers), the funnel (candidates, votes, rejections by geometry,
# uncertainty, correction, closures) and the ATE, one entry per run that
# ``main`` makes on the card ("solve" only where no default closure
# solved); a run without its entry fails.
LOOP_CPU = {"default": {
    "kf_frames": [4, 9, 14, 19, 24, 29, 34, 39, 44, 49, 54, 59, 64, 69, 74,
                  79, 84, 89, 94, 99, 104, 109, 114, 119, 124, 129, 134, 139,
                  144, 149, 154, 159, 164, 169, 174, 179, 184, 189, 194, 199,
                  204, 209, 214, 219],
    "events": [[1, 23, 252], [13, 35, 259]], "funnel": [18, 4, 2, 0, 0, 2],
    "ate": 0.022807961584485874}, "pcg": {
    "kf_frames": [4, 9, 14, 19, 24, 29, 34, 39, 44, 49, 54, 59, 64, 69, 74,
                  79, 84, 89, 94, 99, 104, 109, 114, 119, 124, 129, 134, 139,
                  144, 149, 154, 159, 164, 169, 174, 179, 184, 189, 194, 199,
                  204, 209, 214, 219],
    "events": [[1, 23, 252], [13, 35, 259]], "funnel": [18, 4, 2, 0, 0, 2],
    "ate": 0.0228104777856262}}
# floors 0: "always solve" (LoopClosureConfig.lc_min_correction_t/r)
SOLVE_ALWAYS = {"loop": {"lc_min_correction_t": 0.0,
                         "lc_min_correction_r": 0.0}}


def pcg_updates(solve):
    """The PCG run's settings: those of the run that solved (``solve``: {}
    or SOLVE_ALWAYS) with ``pose_graph_solver="pcg"``."""
    return {"loop": dict(solve.get("loop", {}), pose_graph_solver="pcg")}


def loop_lap():
    """loop_scene's setting: (the default SlamConfig(), its camera, the
    world, the lap's poses, the generator that renders the frames, in the
    lap's order)."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng, n_points=400, n_lines=60, layout="ring")
    step = synthetic._exp_se3_np(np.array(
        [0, 0, 0.15, 0, 2 * np.pi / LOOP_LAP, 0], np.float32))
    T = np.eye(4, dtype=np.float32)
    lap = []
    for _ in range(LOOP_LAP):
        lap.append(T)
        T = (T @ step).astype(np.float32)
    lap = np.stack(lap)
    c = lap[:, :3, 3].mean(0)
    world = world._replace(points=world.points + c, line_sp=world.line_sp + c,
                           line_ep=world.line_ep + c)
    return cfg, cam, world, lap, rng


def loop_keyframe_descriptors(dev):
    """The packed ORB and LBD descriptors of the loop path's first
    keyframe, which its probe descends (``bow_descend``), each with the
    valid mask its probe's ``bow_hist`` takes: loop_scene's
    first frame, rendered alone (the scene renders it first), through
    ``FusedPLSLAM(SlamConfig()).initialize``."""
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.io import synthetic
    cfg, cam, world, lap, rng = loop_lap()
    il, ir = synthetic.render_frame(world, lap[0], cam, rng, noise=0.004)
    slam = FusedPLSLAM(cfg, cam, device=dev)
    slam.initialize(to_u8(il), to_u8(ir))
    st = slam.state
    return {"orb": (st.kf_pt_desc[0].cpu(), (st.obs_pt_disp[0] > 0).cpu()),
            "lbd": (st.kf_ln_desc[0].cpu(), (st.obs_ln_lm[0] >= 0).cpu())}


def loop_scene():
    """The loop path's scene: two laps of tests/test_compact_loops.py's lap
    trajectory (a lap rendered once, then replayed, so the second lap
    revisits the first's views exactly) at the full KITTI width with
    bench_slam.py's world (a ring of 400 points and 60 lines around the
    lap's centre, noise 0.004, step 0.15 m) and the default SlamConfig()
    (loop closure on): 1 + 11 x 20 uint8 frames. A lap is 110 frames
    (3.27 deg of yaw a frame), so the 15 deg rotation cap makes ~22
    keyframes a lap, more than the 20 of min_kf_separation: each second-lap
    keyframe's twin is a candidate. bench_slam.py's own scene closes no
    loop with the default settings (26 keyframes; its revisit spans slots
    22-25, which may only match slots 0-5)."""
    from plslam_tpu_torch.io import synthetic
    n = 1 + LOOP_CHUNKS * CHUNK
    t0 = time.perf_counter()
    cfg, cam, world, lap, rng = loop_lap()
    frames = [synthetic.render_frame(world, P, cam, rng, noise=0.004)
              for P in lap]
    idx = np.arange(n) % LOOP_LAP
    il = np.stack([to_u8(f[0]) for f in frames])[idx]
    ir = np.stack([to_u8(f[1]) for f in frames])[idx]
    seq = synthetic.SyntheticSequence(world, lap[idx], None, None)
    print(f"[loop] rendered a lap of {LOOP_LAP} frames in "
          f"{time.perf_counter() - t0:.1f} s (host), {n} frames", flush=True)
    return cfg, cam, seq, il, ir


class LoopProbe:
    """Counts and times the loop closer's steps on the card (each timed
    call is bracketed by synchronizes) and records the candidate margins
    and each pose-graph solve's graph and result (``hold_solves`` holds
    them, after the run, bit-equal to ``per_step_solve``). Installed
    around the module-level functions the closer calls; it changes nothing
    they compute."""

    def __init__(self):
        import plslam_tpu_torch.loop.loop_closer as tlc
        self.mod = tlc
        self.saved = {}
        self.n = {}
        self.ms = {}
        self.solves = []    # (name, function, args, kwargs, result)
        self.margin = math.inf       # smallest |rel - lc_mat|
        self.gap = math.inf          # smallest gap between ranked candidates
        for name in ("verify_loop_geometry", "_post_loop_update",
                     "optimize_pose_graph", "optimize_pose_graph_pcg"):
            self._wrap(name)
        orig = tlc.select_candidates
        self.saved["select_candidates"] = orig

        def select(scores, slot, cfg):
            out, base = orig(scores, slot, cfg)
            lc = cfg.loop
            elig = scores.copy()
            elig[max(slot - lc.min_kf_separation, 0):] = 0.0
            rel = elig[elig > 0] / base
            if rel.size:
                self.margin = min(self.margin,
                                  float(np.abs(rel - lc.lc_mat).min()))
                top = np.sort(rel)[::-1][:lc.max_loop_candidates + 1]
                if top.size > 1:
                    self.gap = min(self.gap, float(np.diff(top).__abs__()
                                                   .min()))
            return out, base
        tlc.select_candidates = select

    def _wrap(self, name):
        import torch
        orig = getattr(self.mod, name)
        self.saved[name] = orig

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            self.n[name] = self.n.get(name, 0) + 1
            self.ms.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))
            if name.startswith("optimize_pose_graph"):
                # host copies (the graph's poses are a view of the map's),
                # bound to the signature after the run: no device memory
                host = lambda x: (x._replace(**{f: getattr(x, f).cpu()
                                                for f in x._fields})
                                  if hasattr(x, "_fields") else x)
                self.solves.append((name, orig, [host(x) for x in a],
                                    {n: host(x) for n, x in k.items()},
                                    [x.cpu() for x in out]))
            return out
        setattr(self.mod, name, timed)

    def hold_solves(self, dev) -> int:
        """Each recorded solve against the loop that assembles and solves
        every GN step on the same graph, bit for bit; returns their count."""
        import inspect
        import torch
        from plslam_tpu_torch.loop import pose_graph as pg
        for name, fn, a, k, out in self.solves:
            kw = inspect.signature(fn).bind(*a, **k)
            kw.apply_defaults()
            kw = kw.arguments
            g = kw["g"]._replace(**{f: getattr(kw["g"], f).to(dev)
                                    for f in kw["g"]._fields})
            out = [x.to(dev) for x in out]
            freeze = torch.from_numpy(pg.frozen_mask(g)).to(g.poses.device)
            want = per_step_solve(
                pg, "pcg" if name.endswith("pcg") else "dense", g, freeze,
                kw["iters"], kw.get("cg_iters", 96), kw["fix_first"])
            check(all(torch.equal(x, y) for x, y in zip(out, want)),
                  f"{name}: the solve differs from the loop that assembles "
                  "and solves every GN step")
        return len(self.solves)

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


# K18's hand launches a solve at 12 GN iterations: H (dense) or its diagonal
# blocks (PCG) and the first gradient once, each later gradient from
# pg_update
SOLVE_LAUNCHES = {"dense": {"pg_edges": 1, "pg_assemble": 1, "pg_update": 12},
                  "pcg": {"pg_edges": 1, "pg_blocks": 1, "pg_pcg": 12,
                          "pg_update": 12}}


def expected_loop_launches(n_kfs, n_lba, p: LoopProbe, n_closed,
                           n_chunks: int = LOOP_CHUNKS) -> dict:
    """The loop path's launches: the loops-off path's
    (``expected_slam_launches``) and the loop closer's (``_loop_part``)."""
    from collections import Counter
    return _loop_part(Counter(expected_slam_launches(n_kfs, n_lba, n_chunks)),
                      n_kfs, p, n_closed)


def loop_summary(slam, cfg):
    """(keyframe frames, events [(from, to, inliers)], funnel, good,
    decision margins) of a finished loop run."""
    flags, good, margin = decisions(slam, cfg)
    lc = slam.loop_closer
    events = [(e.kf_from, e.kf_to, e.n_inliers) for e in lc.events]
    funnel = (lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom,
              lc.n_rej_unc, lc.n_rej_corr, lc.n_loops_closed)
    return np.nonzero(flags)[0].tolist(), events, funnel, good, margin


def loop_path(dev, tag, updates=None, cpu=None):
    """FusedPLSLAM(SlamConfig()) with loops on over ``loop_scene``'s two
    laps, 1 + 11 x 20 device-resident uint8 frames, after a warm-up of one
    chunk;
    ``updates`` changes the loop settings. Returns (launches, slam, probe
    counts)."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse

    cfg, cam, seq, il, ir = LOOP_SCENE
    if updates:
        cfg = cfg.with_updates(updates)
    dev_chunks = [torch.from_numpy(np.stack([il[lo:lo + CHUNK],
                                             ir[lo:lo + CHUNK]])).to(dev)
                  for lo in range(1, 1 + LOOP_CHUNKS * CHUNK, CHUNK)]
    warm = FusedPLSLAM(cfg, cam)
    warm.initialize(il[0], ir[0])
    warm.process_chunk(dev_chunks[0])
    warm.finish()

    slam = FusedPLSLAM(cfg, cam)
    probe = LoopProbe()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    t0 = time.perf_counter()
    try:
        est = drive_slam(slam, il, ir, dev_chunks, LOOP_CHUNKS)
        torch.cuda.synchronize()
    finally:
        probe.close()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_frames = LOOP_CHUNKS * CHUNK
    kf_frames, events, funnel, good, margin = loop_summary(slam, cfg)
    flags = np.zeros(n_frames, bool)
    flags[kf_frames] = True
    ate = float(ate_rmse(est, seq.poses[:len(est)]))
    recs = slam.summaries
    n_lba = n_lba_slots(flags, LOOP_CHUNKS, cfg)
    lc = slam.loop_closer
    ms = {k: [round(x, 3) for x in v] for k, v in probe.ms.items()}
    print(f"[{tag}] frames={n_frames} good={int(good.sum())} keyframes="
          f"{len(recs)} lba_slots={n_lba} ate_m={ate:.6f} closures="
          f"{lc.n_loops_closed} events={lc.events}", flush=True)
    print(f"[{tag}] funnel (candidates, votes, rejected geometry, "
          f"uncertainty, correction, closed)={funnel} graph edges odo/covis/"
          f"loop={len(lc.odo_edges)}/{len(lc.covis_edges)}/"
          f"{len(lc.loop_edges)} frozen_events={lc.n_frozen_events} "
          f"edges_dropped={lc.n_edges_dropped}", flush=True)
    print(f"[{tag}] fps={n_frames / wall:.2f} ms_per_frame="
          f"{1e3 * wall / n_frames:.3f} (host clock, initialize + "
          f"{LOOP_CHUNKS} chunks + finish, ends in synchronize; timed loop "
          f"steps synchronize) max_memory_allocated_bytes={peak}", flush=True)
    print(f"[{tag}] ms per call (host clock between synchronizes): {ms}",
          flush=True)
    print(f"[{tag}] smallest candidate margin |rel - lc_mat| = "
          f"{probe.margin:.6g}, smallest gap between ranked candidates "
          f"{probe.gap:.6g}, smallest keyframe-decision margin "
          f"{margin.min():.6g}", flush=True)
    print(f"[{tag}] launches={json.dumps(launches, sort_keys=True)}; "
          f"{probe.hold_solves(dev)} pose-graph solve(s) bit-equal to the "
          "loop that assembles and solves every GN step", flush=True)
    check(bool(good.all()), f"{tag}: frames not tracked: "
          f"{np.nonzero(~good)[0]}")
    check(lc.n_loops_closed >= 1, f"{tag}: no loop closed")
    check(cpu is not None, f"{tag}: no CPU record of this run in LOOP_CPU "
          "(python3 chip_smoke.py --cpu-ate loops)")
    same = (kf_frames == cpu["kf_frames"]
            and [list(e) for e in events] == cpu["events"]
            and list(funnel) == cpu["funnel"])
    near = min(margin.min(), probe.margin, probe.gap)
    print(f"[{tag}] CPU run: keyframes {len(cpu['kf_frames'])}, events "
          f"{cpu['events']}, funnel {cpu['funnel']}, ATE {cpu['ate']}; "
          f"identical: {same}", flush=True)
    check(same or near < THRESHOLD_MARGIN,
          f"{tag}: keyframes, events or funnel differ from the CPU run "
          f"with the smallest margin {near}")
    bound_m = 2 * cpu["ate"] + 0.02
    check(math.isfinite(ate) and ate < bound_m,
          f"{tag}: ATE {ate} m outside its bound {bound_m} m")
    want = expected_loop_launches(1 + len(recs), n_lba, probe,
                                  lc.n_loops_closed)
    check(launches == want, f"{tag}: launches {launches} differ from the "
          f"path's {want}")
    return launches, slam, dict(probe.n)


# M's graphs (``synthetic.drift_circle_graph``: slots, keyframes, extra
# chords) at the loop closer's five slot buckets (E = 4 Fb; 512: a 400-KF
# loop graph; 1,024: the provisioned long run's bucket, a 700-KF graph whose
# 3,100 used edges fill 3/4 of its 4,096 edge slots)
PG_BUCKETS = ((64, 40, 60), (128, 100, 300), (256, 200, 800),
              (512, 400, 1600), (1024, 700, 2400))


def loop_kernel_phase(dev, record, slam):
    """Kernels L (K17) on a keyframe of the loop run against the real
    vocabularies, D at the verification and fusion shapes ((1, 1024, 1024)
    and (1, 128, 128) on packed words, mutual), the covisibility gather
    (K7), and M (K18) launch by launch at Fb = 64 (E = 256) and Fb = 512
    (E = 2,048, a 400-KF loop graph; pg_edges in both modes, pg_pcg and
    pg_update at every bucket of PG_BUCKETS, with the grids the profiler
    saw), each against its plain version on the card, pg_edges and the
    whole solves also against the plain version in float64; what
    pg_update hands on against pg_edges, and a rejected step."""
    import torch
    from plslam_tpu_torch.loop import vocabulary as voc
    from plslam_tpu_torch.loop.loop_closer import covisibility_counts
    from plslam_tpu_torch.ops.gather import take

    st, db = slam.state, slam.loop_closer.db
    slot = 1
    src_l, rep_l = "plslam_tpu_torch/csrc/bow.cu", "plslam_tpu/loop/vocabulary.py:"
    for kind, v, desc, valid in (
            ("orb", db.voc_p, st.kf_pt_desc[slot], st.obs_pt_disp[slot] > 0),
            ("lbd", db.voc_l, st.kf_ln_desc[slot], st.obs_ln_lm[slot] >= 0)):
        N = desc.shape[0]
        leaves = voc.transform_leaves(v, desc)
        ref = voc.transform_leaves_plain(v, desc)
        # bytes: the descriptors, the leaves, and the centroid rows this
        # run's descent reads (k children of each distinct node it passes);
        # operations: L levels x k children x 8 words (xor, popc, add)
        lv = ref.long().cpu()
        rows = v.k * sum(int(torch.unique(lv // v.k ** (v.levels - l)).numel())
                         for l in range(v.levels))
        record(f"bow_descend@{kind}", src_l, rep_l + "129", [leaves], [ref],
               0.0, lambda: voc.transform_leaves(v, desc),
               lambda: voc.transform_leaves_plain(v, desc),
               N * (32 + 4) + rows * 32, N * v.levels * v.k * 8 * 3,
               entry="bow_descend", err_kind="leaf ids, exact")
        grid = launched_grid(lambda: voc.transform_leaves(v, desc),
                             "bow_descend_kernel")
        print(f"[bow] {kind}: the descent of {N} descriptors reads {rows} of "
              f"{int(v.flat.shape[0])} centroid rows; launched with grid, "
              f"block {grid if grid else 'not recorded by the profiler'} "
              f"(8 lanes a descriptor)", flush=True)
        check(grid is None or (list(grid[0]) == [-(-N // 16), 1, 1]
                               and list(grid[1]) == [128, 1, 1]),
              f"bow_descend: grid, block {grid}, expected {-(-N // 16)} CTAs "
              "of 128 threads")
        got = voc.bow_hist(v, leaves, valid)
        ref = voc.bow_hist_plain(v, leaves, valid.to(torch.float32))
        top = ref.abs().max()
        bows = db.bows_p if kind == "orb" else db.bows_l
        s_got, s_ref = voc.l1_score(bows, got[None]), voc.l1_score(bows, ref[None])
        check(torch.equal(got == 0, ref == 0),
              f"bow_hist@{kind}: zeros differ from the plain version's")
        # bytes: leaves and valid in, the idf entry of each distinct valid
        # leaf gathered, the vector out; operations: a count a valid
        # descriptor, a product, an abs, an add and a divide a distinct leaf
        n_dist = int(torch.unique(leaves[valid]).numel())
        record(f"bow_hist@{kind}", src_l, rep_l + "145",
               [got / top, s_got], [ref / top, s_ref], [1e-6, 1e-6],
               lambda: voc.bow_hist(v, leaves, valid),
               lambda: voc.bow_hist_plain(v, leaves, valid.to(torch.float32)),
               N * 5 + n_dist * 4 + v.n_leaves * 4,
               int(valid.sum()) + 4 * n_dist, entry="bow_hist",
               err_kind="BoW vector relative to its largest entry; its L1 "
               "scores against the database, absolute")
        grid = launched_grid(lambda: voc.bow_hist(v, leaves, valid),
                             "bow_hist_kernel")
        ctas = voc.hist_layout(v.n_leaves)[0]
        print(f"[bow] {kind}: bow_hist over {n_dist} distinct leaves of "
              f"{v.n_leaves}; launched with grid, block "
              f"{grid if grid else 'not recorded by the profiler'} "
              f"({ctas} CTAs, a slice of the vector each)", flush=True)
        check(grid is None or (list(grid[0]) == [ctas, 1, 1]
                               and list(grid[1]) == [voc.HIST_NT, 1, 1]),
              f"bow_hist: grid, block {grid}, expected {ctas} CTAs of "
              f"{voc.HIST_NT} threads")
        ms = cuda_ms(lambda: voc.l1_score(bows, got[None]), 20)
        b_ms, b_by = bound(bows.numel() * 4 + v.n_leaves * 4,
                           3 * bows.numel())
        print(f"[bow] {kind}: {int(valid.sum())} valid of {N} descriptors; "
              f"l1_score over the {tuple(bows.shape)} database (torch, no "
              f"hand kernel): ms={ms:.4f} bound_ms={b_ms:.4f} ({b_by})",
              flush=True)

    # D at the verification and fusion shapes, on the stored packed words,
    # no gate
    g = torch.Generator(device="cpu").manual_seed(9)
    for N, tag, md, ratio in ((st.kf_pt_desc.shape[1], "@verify", 80, 0.75),
                              (st.kf_ln_desc.shape[1], "@verify_lines", 90,
                               0.9)):
        matcher_case(record, g, dev, 1, N, N, "none", tag, words=True, md=md,
                     ratio=ratio)

    # K7: covisibility over the (512, 1024) observation table
    F, K = st.obs_pt_lm.shape
    P = slam.cfg.mapping.max_points
    ms = cuda_ms(lambda: covisibility_counts(st.obs_pt_lm, slot, P), 20)
    member = torch.rand(P, device=dev)
    lib = cuda_ms(lambda: take(member.expand(F, P), st.obs_pt_lm), 20)
    b_ms, b_by = bound(F * K * 4 + P * 4 + F * 4, F * K * 2)
    print(f"[k7] covisibility_counts over ({F}, {K}) (scatter-max + clamped "
          f"torch.gather + sum, no hand kernel): ms={ms:.4f} bound_ms="
          f"{b_ms:.4f} ({b_by}) library_ms (the gather alone)={lib:.4f}",
          flush=True)

    pose_graph_child(record)


def pose_graph_child(record) -> None:
    """``pose_graph_phase`` in a process of its own (``python3
    chip_smoke.py --pose-graph``): late in a long process torch.profiler
    keeps no device record of M's short kernels in most traces, in a new
    one it keeps them. Its output passes through; its kernel rows join
    ``record``'s; its failure fails the run."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--pose-graph"],
        cwd=here, capture_output=True, text=True, timeout=1200)
    lines = out.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(out.returncode == 0, "the pose-graph phase failed: "
          + out.stderr.strip()[-2000:])
    record.rows.extend(json.loads(lines[-1]))


def pose_graph_phase(dev, record):
    """M (K18) launch by launch at the five slot buckets of PG_BUCKETS (the
    dense system's blocks at Fb 64 and 512, PCG's at 64, 512 and 1,024;
    ``pg_update`` with
    each order's gradient; the library's LU, solve and inverse; the edge
    sweep's grids from ``--edge-grids`` in a process of its own), then the
    whole solves against float64 and against ``per_step_solve`` (bit for
    bit; dense up to Fb 128), with every hand kernel's device time in a
    solve."""
    import os
    from collections import Counter
    import torch
    from plslam_tpu_torch import convert, native
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg

    src_m, rep_m = ("plslam_tpu_torch/csrc/pose_graph.cu",
                    "plslam_tpu/loop/pose_graph.py:")
    rel = "relative to each output's largest magnitude"
    here = os.path.dirname(os.path.abspath(__file__))
    grids = json.loads(subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--edge-grids"],
        cwd=here, capture_output=True, text=True, check=True,
        timeout=600).stdout.strip().splitlines()[-1])
    for F, n, extra in PG_BUCKETS:
        d, n_edges = synthetic.drift_circle_graph(F, n, extra, seed=F)
        gd = convert.pose_graph_from_numpy(d, dev)
        E = 4 * F
        C, threads, smem = pg.pcg_layout(F, E)
        ctas, nt = pg.edge_layout(E)
        used = gd.edge_w > 0
        # the poses an edge sweep must read: the used edges' end nodes
        n_nodes = int(torch.unique(torch.cat([gd.edge_i[used],
                                              gd.edge_j[used]])).numel())
        print(f"[pose_graph] Fb={F}: {n} KFs, {n_edges} of {E} edge slots "
              f"used ({n_nodes} end nodes); pg_pcg cluster {C} CTA(s) of "
              f"{threads} threads, {smem} bytes of shared memory each; "
              f"pg_edges and pg_update {ctas} CTAs of {nt} threads",
              flush=True)
        # the dense system's blocks at 64 and 512, PCG's also at 1,024
        every, blocks_too = F in (64, 512), F in (64, 512, 1024)
        sc = lambda xs: [x / x.abs().max().clamp(min=1e-30) for x in xs]
        rp, Jp, cp = pg.edges_plain(gd)
        freeze = torch.zeros(F, dtype=torch.bool, device=dev)
        diag = pg._diag(gd, freeze, True)
        inc = pg._incidence(gd)
        gbp, Hdp = pg.blocks_plain(gd, rp, Jp, diag)
        g64 = gd._replace(poses=gd.poses.double(), edge_T=gd.edge_T.double(),
                          edge_w=gd.edge_w.double())
        # pg_edges at every bucket, both modes: the kernel and the plain
        # version against the plain version in float64, the kernel held to
        # K18's rule (3x the plain one's distance + 1e-5); the rows hold it
        # within 1e-5 (Ji 1e-6) of the plain version, except at Fb 128,
        # where the two differ by more than 1e-5 in r while equally far
        # from float64 (PERF.md): there the rows hold the kernel's distance
        # from float64. Bytes: Tm and w of every slot, the used edges' ends
        # and their poses, r (and Ji) of every slot; operations ~700 an
        # used edge's residual, ~50 a slot's Ji
        r, J, c = pg.edges(gd)
        truth = pg.edges_plain(g64)
        dist = lambda xs, ys: [_rel_d(x, y) for x, y in zip(xs, ys)]
        d_k, d_p = dist((r, J, c), truth), dist((rp, Jp, cp), truth)
        d_kp = dist((r, J, c), (rp, Jp, cp))
        f64_tols = [F64_FACTOR * x + F64_FLOOR for x in d_p]
        fmt = lambda xs: [f"{x:.3g}" for x in xs]
        print(f"[pose_graph] pg_edges Fb={F} (r, Ji, cost {rel}): kernel "
              f"from float64 {fmt(d_k)}, plain from float64 {fmt(d_p)}, "
              f"kernel from plain {fmt(d_kp)}; float64 bound "
              f"{fmt(f64_tols)}", flush=True)
        check(all(x <= t for x, t in zip(d_k, f64_tols)),
              f"pg_edges at Fb={F}: {d_k} from float64, bound {f64_tols}")
        near = F != 128
        f64_kind = ("" if near else ": the kernel from float64, tolerance "
                    f"{F64_FACTOR:g}x the plain one's distance + "
                    f"{F64_FLOOR:g}")
        record(f"pg_edges@{F}", src_m, rep_m + "89", sc([r, J, c]),
               sc([rp, Jp, cp]), [1e-5, 1e-6, 1e-5] if near else f64_tols,
               lambda: pg.edges(gd), lambda: pg.edges_plain(gd),
               n_nodes * 64 + E * (64 + 4) + n_edges * 8 + E * (24 + 144)
               + 4, n_edges * 700 + E * 50,
               errs=None if near else d_k, entry="pg_edges",
               err_kind="r, Ji, cost " + rel + f64_kind)
        r2, J2, c2 = pg.edges(gd, jac=False)
        check(J2 is None and torch.equal(r2, r) and torch.equal(c2, c),
              f"pg_edges at Fb={F}: the mode without Ji gives other r or "
              "cost bits")
        record(f"pg_edges_r@{F}", src_m, rep_m + "89", sc([r2, c2]),
               sc([rp, cp]), [1e-5, 1e-5] if near
               else [f64_tols[0], f64_tols[2]],
               lambda: pg.edges(gd, jac=False),
               lambda: pg.edges_plain(gd, jac=False),
               n_nodes * 64 + E * 4 + n_edges * (64 + 8) + E * 24 + 4,
               n_edges * 700, errs=None if near else [d_k[0], d_k[2]],
               entry="pg_edges", err_kind="r, cost " + rel + f64_kind)
        if every:
            # bytes of pg_assemble and pg_blocks: the used edges' Ji, r, w
            # and ends (the lists hold no other edge), diag, H or Hd and g
            # out; operations: each used edge's products and sums
            H, gv = pg.assemble(gd, rp, Jp, diag, inc)
            Hp, gvp = pg.assemble_plain(gd, rp, Jp, diag)
            off = lambda M: M - torch.diag(torch.diag(M))
            blocks = torch.randn((E, 36), device=dev)
            flat_idx = (gd.edge_i.long() * F + gd.edge_j.long())
            record(f"pg_assemble@{F}", src_m, rep_m + "125",
                   sc([off(H), torch.diag(H), gv]),
                   sc([off(Hp), torch.diag(Hp), gvp]), [1e-5, 1e-6, 1e-5],
                   lambda: pg.assemble(gd, rp, Jp, diag, inc),
                   lambda: pg.assemble_plain(gd, rp, Jp, diag),
                   n_edges * 180 + F * 4 + (6 * F) ** 2 * 4 + 6 * F * 4,
                   n_edges * (36 * 12 + 36 * 2 + 6 * 14),
                   lambda: torch.zeros((F * F, 36), device=dev).index_add_(
                       0, flat_idx, blocks),
                   entry="pg_assemble",
                   err_kind="H off its diagonal, H's diagonal (the pins), g "
                   + rel, library_what="the (F·F, 36) block scatter alone")
        if blocks_too:
            gb, Hd = pg.blocks(gd, rp, Jp, diag, inc)
            record(f"pg_blocks@{F}", src_m, rep_m + "227", sc([gb, Hd]),
                   sc([gbp, Hdp]), [1e-5, 1e-6],
                   lambda: pg.blocks(gd, rp, Jp, diag, inc),
                   lambda: pg.blocks_plain(gd, rp, Jp, diag),
                   n_edges * 180 + F * (4 + 168),
                   n_edges * (36 * 12 + 6 * 14),
                   entry="pg_blocks", err_kind="g, Hd " + rel)
        # the library calls of the solves: the dense system's LU once and a
        # solve from it each step (the parent's solve_ex each step: both
        # bits checked equal), the PCG blocks' batched inverse once; and a
        # memset of H, the store rate pg_assemble's band meets
        lib = {"inv_ex": cuda_ms(lambda: torch.linalg.inv_ex(Hdp), 20)}
        if F in (64, 128, 512):
            Hp, gvp = pg.assemble_plain(gd, rp, Jp, diag)
            lu = pg.lu_factor(Hp)
            check(torch.equal(pg.lu_step(lu, gvp), torch.linalg.solve_ex(
                Hp, gvp[:, None])[0][:, 0]), f"Fb={F}: the LU's solve differs "
                  "from torch.linalg.solve_ex's bits")
            Z = torch.empty_like(Hp)
            lib.update(solve_ex=cuda_ms(lambda: torch.linalg.solve_ex(
                Hp, gvp[:, None]), 5), lu_factor_ex=cuda_ms(
                lambda: torch.linalg.lu_factor_ex(Hp), 5),
                lu_solve=cuda_ms(lambda: pg.lu_step(lu, gvp), 20),
                zero_=cuda_ms(lambda: Z.zero_(), 20))
        # bounds: the LU 2/3 n^3 operations, a solve from it 2 n^2 (its n^2
        # floats read), the inverse 2 x 6^3 a block (the blocks in and out)
        n6 = 6 * F
        bounds = {"inv_ex": bound(F * 36 * 4 * 2, F * 2 * 216),
                  "solve_ex": bound(n6 * n6 * 4, 2 / 3 * n6 ** 3 + 2 * n6 ** 2),
                  "lu_factor_ex": bound(2 * n6 * n6 * 4, 2 / 3 * n6 ** 3),
                  "lu_solve": bound(n6 * n6 * 4, 2 * n6 ** 2),
                  "zero_": bound(n6 * n6 * 4, 0)}
        print(f"[library] Fb={F}: " + ", ".join(
            f"{k} {v:.4f} ms (bound {bounds[k][0]:.3g}, {bounds[k][1]})"
            for k, v in lib.items()) + f" (the {n6}x{n6} system; inv_ex of "
              f"the ({F}, 6, 6) blocks; CUDA events)", flush=True)
        Minv = torch.linalg.inv_ex(Hdp)[0]
        dx = pg.pcg(gd, Jp, Minv, diag, gbp, 96, inc)
        dxp = pg.pcg_plain(gd, Jp, Minv, diag, gbp, 96)
        grid = launched_grid(lambda: pg.pcg(gd, Jp, Minv, diag, gbp, 96, inc),
                             "pg_pcg_kernel")
        print(f"[pose_graph] pg_pcg at Fb={F} launched with grid, block "
              f"{grid if grid else 'not recorded by the profiler'}; "
              f"cluster {C}", flush=True)
        check(grid is None or (list(grid[0]) == [C, 1, 1]
                               and list(grid[1]) == [threads, 1, 1]),
              f"pg_pcg at Fb={F}: grid, block {grid}, expected {C} CTAs of "
              f"{threads} threads")
        record(f"pg_pcg@{F}", src_m, rep_m + "251", sc([dx]), sc([dxp]),
               1e-3, lambda: pg.pcg(gd, Jp, Minv, diag, gbp, 96, inc),
               lambda: pg.pcg_plain(gd, Jp, Minv, diag, gbp, 96),
               E * 156 + F * (144 + 4 + 24) + F * 24,
               96 * (n_edges * 160 + 6 * F * 20), iters=5,
               entry="pg_pcg", err_kind="dx " + rel + " (96 CG steps)",
               cluster=C)
        # pg_update at every bucket: the step, the residuals there, the
        # cost and the accept. Bytes: poses, step and valid in, the used
        # edges' Tm and ends, w of every slot, poses and r of every slot
        # out, r_in where the step is rejected; operations ~300 a pose's
        # trial, ~700 an used edge's residual
        P1, c1, r1 = pg.update(gd, cp, dx, 1.0, r)
        Pp, c1p, _ = pg.update_plain(gd, cp, dx, 1.0)
        rej = torch.equal(P1, gd.poses)
        record(f"pg_update@{F}", src_m, rep_m + "155", sc([P1, c1]),
               sc([Pp, c1p]), [1e-5, 1e-5],
               lambda: pg.update(gd, cp, dx, 1.0, r),
               lambda: pg.update_plain(gd, cp, dx, 1.0),
               F * (64 * 2 + 24 + 1) + n_edges * (64 + 8) + E * (4 + 24)
               + 8 + (E * 24 if rej else 0), F * 300 + n_edges * 700,
               entry="pg_update", err_kind="poses, cost " + rel)
        # pg_update with the next step's gradient, in each order: poses and
        # cost against update_plain, g against gradient_plain at the
        # residuals handed on, and the bits of pg_assemble's or pg_blocks'
        # there. Bytes: as pg_update, and Ji of the used edges, each used
        # edge's list entries and w twice, u and r of the used edges, g
        # out; operations: as pg_update, u = Ji^T r (72 an edge) and 4 an
        # entry
        for mode, tag, line in (("dense", "g", "135"), ("pcg", "gp", "228")):
            g_in = torch.zeros((6 * F,), device=dev)
            if mode == "pcg":
                g_in = g_in.reshape(F, 6)
            g_out = torch.empty_like(g_in)
            grad = (mode, Jp, g_in, g_out, inc)
            Pg, cg, rg, gg = pg.update(gd, cp, dx, 1.0, r, None, grad)
            want = (pg.assemble(gd, rg, Jp, diag, inc)[1] if mode == "dense"
                    else pg.blocks(gd, rg, Jp, diag, inc)[0])
            check(torch.equal(gg, want), f"pg_update@{F} ({mode} gradient): "
                  "g differs from the one-launch kernel's bits")
            Pq, cq, _ = pg.update_plain(gd, cp, dx, 1.0)
            record(f"pg_update_{tag}@{F}", src_m, rep_m + line,
                   sc([Pg, cg, gg]),
                   sc([Pq, cq, pg.gradient_plain(gd, rg, Jp, mode)]),
                   [1e-5, 1e-5, 1e-5],
                   lambda: pg.update(gd, cp, dx, 1.0, r, None, grad),
                   lambda: pg.update_plain(gd, cp, dx, 1.0, None, grad),
                   F * (64 * 2 + 24 + 1) + n_edges * (64 + 8) + E * (4 + 24)
                   + 8 + n_edges * (144 + 2 * 8 + 2 * 24) + F * 24,
                   F * 300 + n_edges * (700 + 72 + 8),
                   entry="pg_update", err_kind="poses, cost, g " + rel
                   + f" (the gradient in the {mode} order)")
        # what pg_update hands on: the bits of pg_edges at the poses it
        # returns; the reversed step raises the cost and is rejected, and
        # the launch hands back the poses, the residuals and the cost
        re_, _, ce = pg.edges(gd._replace(poses=P1), jac=False)
        check(torch.equal(r1, re_) and torch.equal(c1, ce),
              f"pg_update at Fb={F}: the residuals or the cost it hands on "
              "differ from pg_edges' at its poses")
        Pb, cb, rb = pg.update(gd, cp, dx, -1.0, r)
        check(torch.equal(Pb, gd.poses) and torch.equal(cb, cp)
              and torch.equal(rb, r), f"pg_update at Fb={F}: a rejected "
              "step did not hand back the poses, residuals and cost")
        print(f"[pose_graph] pg_update Fb={F}: the step "
              f"{'rejected' if rej else 'accepted'}, its residuals and cost "
              "the bits of pg_edges at its poses; the reversed step "
              "rejected, poses, residuals and cost handed back exactly",
              flush=True)
        for kern in ("pg_edges_kernel", "pg_update_kernel"):
            grid = grids[f"{kern}@{F}"]
            print(f"[pose_graph] {kern} at Fb={F} launched with grid, block "
                  f"{grid} (--edge-grids); edge_layout {ctas} CTAs of {nt} "
                  "threads", flush=True)
            check(grid is not None and list(grid[0]) == [ctas, 1, 1]
                  and list(grid[1]) == [nt, 1, 1],
                  f"{kern} at Fb={F}: grid, block {grid}, expected {ctas} "
                  f"CTAs of {nt} threads")
        check(F != 64 or ctas > 1, "the edge sweep at Fb 64 runs on one CTA")
        # whole solves: the kernels against the loop that assembles and
        # solves every step (bit for bit), the plain version and float64;
        # every hand kernel's device time in a solve.
        # The float64 rule's bound comes from the plain version on the CPU:
        # on the card its dense assembly (index_put_ with accumulate) sums
        # with atomics, and its distance from float64 moves between runs
        # (dense Fb 128 on an H100: 3.1e-7 to 2.0e-5 of the largest entry,
        # the kernel's 1.99e-5 each time); the card's is printed beside it
        solvers = [("pcg", lambda g, plain: pg._optimize_pcg(g, freeze, 12,
                                                             96))]
        if F <= 128:
            solvers.append(("dense", lambda g, plain: pg._optimize_dense(
                g, freeze, 12)))
        g_cpu = gd._replace(**{f: getattr(gd, f).cpu()
                               for f in pg.PoseGraph._fields})
        for name, solve in solvers:
            got = solve(gd, False)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(
                got, per_step_solve(pg, name, gd, freeze))),
                f"{name} solve at Fb={F}: differs from the loop that "
                "assembles and solves every GN step")
            plain = _plain_solve(pg, name, g_cpu, freeze.cpu())
            plain_card = _plain_solve(pg, name, gd, freeze)
            truth = _plain_solve(pg, name, g64, freeze)
            ms = cuda_ms(lambda: solve(gd, False), 3)
            # each hand kernel's device time in a solve: its mean record
            # (the profiler may lose records) times its launches
            before = Counter(native.LAUNCHES)
            solve(gd, False)
            launched = dict(Counter(native.LAUNCHES) - before)
            kern_ms = {}
            for entry, times in launched.items():
                k_ms, per = profile_device(
                    lambda: solve(gd, False),
                    lambda k: f"::{entry}_kernel" in k, 3)
                kern_ms[entry] = k_ms / per * times
            d_k = _rel_d(got[0], truth[0])
            d_p = _rel_d(plain[0], truth[0].cpu())
            d_pc = _rel_d(plain_card[0], truth[0])
            tol = F64_FACTOR * d_p + F64_FLOOR
            print(f"[pose_graph] {name} solve Fb={F}: {ms:.3f} ms; the hand "
                  f"kernels {sum(kern_ms.values()):.4f} ms device ("
                  + ", ".join(f"{launched[k]} {k} {v:.4f}"
                              for k, v in kern_ms.items())
                  + f"); the same bits as the loop that assembles and "
                  f"solves every step; cost {float(got[1]):.6g} -> "
                  f"{float(got[2]):.6g} (plain {float(plain[2]):.6g}, "
                  f"float64 {float(truth[2]):.6g}); poses from float64 "
                  f"({rel}): kernel {d_k:.3g}, plain {d_p:.3g} (on the card "
                  f"{d_pc:.3g}), bound {tol:.3g}", flush=True)
            check(launched == SOLVE_LAUNCHES[name],
                  f"{name} solve at Fb={F}: launches {launched}, expected "
                  f"{SOLVE_LAUNCHES[name]}")
            check(float(got[2]) < 0.5 * float(got[1]),
                  f"{name} solve at Fb={F} did not lower the cost")
            check(d_k <= tol, f"{name} solve at Fb={F}: {d_k} from float64, "
                  f"bound {tol}")


def edge_sweep_grids() -> None:
    """``python3 chip_smoke.py --edge-grids``: one JSON line of the grid
    and block that torch.profiler saw of ``pg_edges`` and ``pg_update`` at
    every bucket of PG_BUCKETS (``launched_grid``). ``pose_graph_phase``
    runs it in a process of its own: late in a chip_smoke.py run the
    profiler keeps no record of these short kernels in most traces, in a
    new process it keeps one in each."""
    import torch
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg
    dev = torch.device("cuda", 0)
    out = {}
    for F, n, extra in PG_BUCKETS:
        gd = convert.pose_graph_from_numpy(
            synthetic.drift_circle_graph(F, n, extra, seed=F)[0], dev)
        r, _, c = pg.edges(gd)
        dx = torch.zeros((F, 6), device=dev)
        for kern, fn in (("pg_edges_kernel", lambda: pg.edges(gd)),
                         ("pg_update_kernel",
                          lambda: pg.update(gd, c, dx, 1.0, r))):
            out[f"{kern}@{F}"] = launched_grid(fn, kern)
    print(json.dumps(out))


def per_step_solve(pg, name, g, freeze, iters=12, cg_iters=96,
                    fix_first=True):
    """A solve as the loop that assembles and solves every GN step on the
    card: pg_edges once, then per step pg_assemble and
    torch.linalg.solve_ex (dense) or pg_blocks, torch.linalg.inv_ex and
    pg_pcg (PCG), and pg_update without a gradient: (poses, cost0,
    cost1)."""
    import torch
    F = g.poses.shape[0]
    diag = pg._diag(g, freeze, fix_first)
    inc = pg._incidence(g)
    r, J, c0 = pg.edges(g)
    c = c0
    for _ in range(iters):
        if name == "dense":
            H, gv = pg.assemble(g, r, J, diag, inc)
            st = torch.linalg.solve_ex(H, gv[:, None])[0][:, 0]
            P, c, r = pg.update(g, c, st.reshape(F, 6), -1.0, r)
        else:
            gv, Hd = pg.blocks(g, r, J, diag, inc)
            st = pg.pcg(g, J, torch.linalg.inv_ex(Hd)[0], diag, gv, cg_iters,
                        inc)
            P, c, r = pg.update(g, c, st, 1.0, r)
        g = g._replace(poses=P)
    return g.poses, c0, c


def _plain_solve(pg, name, g, freeze):
    """The plain version of a whole solve on the card's tensors."""
    import unittest.mock as mock
    with mock.patch.multiple(pg, edges=pg.edges_plain,
                             assemble=lambda g, r, J, d, inc=None:
                             pg.assemble_plain(g, r, J, d),
                             blocks=lambda g, r, J, d, inc:
                             pg.blocks_plain(g, r, J, d),
                             pcg=lambda g, J, M, d, gv, it, inc=None:
                             pg.pcg_plain(g, J, M, d, gv, it),
                             update=lambda g, c, s, sc, r=None, r_out=None,
                             grad=None: pg.update_plain(g, c, s, sc, r, grad),
                             _incidence=lambda g: None):
        if name == "pcg":
            return pg._optimize_pcg(g, freeze.to(g.poses.device), 12, 96)
        return pg._optimize_dense(g, freeze.to(g.poses.device), 12)


# -- the dataset paths: the app over files on disk, the raw-rig rectifier -----

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, samples, color=0, depth=8, palette=None, trns=None,
              ftypes=(0, 1, 2, 3, 4)):
    """Encode (H, W[, C]) integer samples as a PNG, row y with filter
    ``ftypes[y % len(ftypes)]`` (None, Sub, Up, Average, Paeth), so a
    reader has to undo all five."""
    import struct
    import zlib
    s = np.asarray(samples)
    H, W = s.shape[:2]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    s = s.reshape(H, W * ch)
    if depth == 16:
        raw = s.astype(">u2").view(np.uint8).reshape(H, -1)
    elif depth == 8:
        raw = s.astype(np.uint8)
    else:
        bits = (s[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        raw = np.packbits(bits.astype(np.uint8).reshape(H, -1), axis=1)
    bpp = max(1, ch * depth // 8)
    x = raw.astype(np.int32)
    n = x.shape[1]
    up = np.vstack([np.zeros((1, n), np.int32), x[:-1]])
    left = np.hstack([np.zeros((H, bpp), np.int32), x[:, :-bpp]])
    ul = np.hstack([np.zeros((H, bpp), np.int32), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, paeth]
    f = np.array([ftypes[y % len(ftypes)] for y in range(H)])
    pred = np.choose(f[:, None], preds)
    rows = np.hstack([f[:, None], (x - pred) & 0xFF]).astype(np.uint8)
    body = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color,
                                            0, 0, 0))]
    if palette is not None:
        body.append(_png_chunk(b"PLTE", np.asarray(palette,
                                                   np.uint8).tobytes()))
    if trns is not None:
        body.append(_png_chunk(b"tRNS", trns))
    body.append(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
    body.append(_png_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + b"".join(body))


def to_u8(img):
    """The app's 8-bit transport rule, clip(f * 255 + 0.5)."""
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_kitti(root, seq):
    """bench.py's scene as a KITTI odometry directory: 8-bit PNG
    image_0/ and image_1/, poses.txt."""
    import os
    for d, ims in (("image_0", seq.images_l), ("image_1", seq.images_r)):
        os.makedirs(os.path.join(root, d))
        for i, im in enumerate(ims):
            write_png(os.path.join(root, d, f"{i:06d}.png"), to_u8(im))
    n = len(seq.poses)
    np.savetxt(os.path.join(root, "poses.txt"),
               seq.poses[:, :3, :].reshape(n, 12))


# An EuRoC-shaped raw rig (EuRoC MAV's published cam0/cam1 sensor.yaml
# values, rounded): 752x480, radial-tangential distortion, about 1 deg of
# relative rotation and a 0.11 m baseline, cam0's body-to-camera T_BS.
EUROC_W, EUROC_H = 752, 480
EUROC_K = (np.array([[458.654, 0, 367.215], [0, 457.296, 248.375],
                     [0, 0, 1.0]]),
           np.array([[457.587, 0, 379.999], [0, 456.134, 255.238],
                     [0, 0, 1.0]]))
EUROC_D = ((-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
           (-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05))
EUROC_T_BS0 = np.array([[0.0148655429818, -0.999880929698, 0.00414029679422,
                         -0.0216401454975],
                        [0.999557249008, 0.0149672133247, 0.025715529948,
                         -0.064676986768],
                        [-0.0257744366974, 0.00375618835797, 0.999660727178,
                         0.00981073058949],
                        [0.0, 0.0, 0.0, 1.0]])
EUROC_FRAMES = 21                       # 1 + 20
WIDE = (1080, 760)                      # the pinhole render, W x H


def _rot(rx, ry, rz):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def euroc_rig():
    """T_10 (x_c1 = T_10 x_c0): 1.0 deg of rotation, 0.11 m baseline."""
    T_10 = np.eye(4)
    T_10[:3, :3] = _rot(0.01, -0.012, 0.008)
    T_10[:3, 3] = T_10[:3, :3] @ np.array([-0.11, 0.0, 0.0])
    return T_10


def _undistort_map(K, d):
    """For every raw pixel, the pinhole (undistorted) normalized point
    that the radial-tangential model sends there: fixed-point iteration
    x_u = (x_d - tangential(x_u)) / radial(x_u)."""
    k1, k2, p1, p2 = d
    vs, us = np.mgrid[0:EUROC_H, 0:EUROC_W].astype(np.float64)
    xd = (us - K[0, 2]) / K[0, 0]
    yd = (vs - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(40):
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2
        x = (xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / rad
        y = (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / rad
    return x, y


def _bilinear(img, u, v):
    """Host bilinear sample with clamped coordinates (for rendering)."""
    H, W = img.shape
    u = np.clip(u, 0, W - 1.0001)
    v = np.clip(v, 0, H - 1.0001)
    x0, y0 = u.astype(np.int64), v.astype(np.int64)
    fx, fy = u - x0, v - y0
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def write_euroc(root, seed=11):
    """A raw-rig EuRoC ASL directory: 1 + 20 frames of a forward flight
    through bench.py's kind of world, each eye rendered as a wide pinhole
    image and warped to the distorted raw image; sensor.yaml (with
    EuRoC's own ``%YAML:1.0`` header) and the ground truth in
    state_groundtruth_estimate0/data.csv."""
    import os
    from plslam_tpu_torch.io import synthetic
    rng = np.random.default_rng(seed)
    world = synthetic.make_world(rng, n_points=500, n_lines=60,
                                 depth=(2.5, 14.0), extent=7.0)
    poses = synthetic.make_trajectory(EUROC_FRAMES, kind="forward",
                                      step=0.1, rng=rng)
    T_10 = euroc_rig()
    mav = os.path.join(root, "mav0")
    fw = float(EUROC_K[0][0, 0])

    class Wide:
        fx = fy = fw
        cx, cy = WIDE[0] / 2.0, WIDE[1] / 2.0
        b = 0.0
        width, height = WIDE

    eyes = []
    for c, (K, d, T_rel) in enumerate(zip(EUROC_K, EUROC_D,
                                          (np.eye(4), T_10))):
        cam = f"cam{c}"
        os.makedirs(os.path.join(mav, cam, "data"))
        T_BS = EUROC_T_BS0 @ np.linalg.inv(T_rel)
        with open(os.path.join(mav, cam, "sensor.yaml"), "w") as f:
            f.write("%YAML:1.0\n# General sensor definitions.\n"
                    f"sensor_type: camera\ncomment: raw rig {cam}\n\n"
                    "# Sensor extrinsics wrt. the body-frame.\nT_BS:\n"
                    "  cols: 4\n  rows: 4\n  data: ["
                    + ",\n         ".join(
                        ", ".join(repr(float(v)) for v in row)
                        for row in T_BS) + "]\n\n"
                    f"rate_hz: 20\nresolution: [{EUROC_W}, {EUROC_H}]\n"
                    "camera_model: pinhole\nintrinsics: ["
                    f"{K[0, 0]}, {K[1, 1]}, {K[0, 2]}, {K[1, 2]}] "
                    "#fu, fv, cu, cv\ndistortion_model: radial-tangential\n"
                    f"distortion_coefficients: {list(d)}\n")
        xu, yu = _undistort_map(K, d)
        eyes.append((cam, T_rel, fw * xu + Wide.cx, fw * yu + Wide.cy))
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i, T_wc0 in enumerate(poses):
        ns = 1403636579763555584 + i * 50000000
        for cam, T_rel, uw, vw in eyes:
            wide, _ = synthetic.render_frame(
                world, T_wc0 @ np.linalg.inv(T_rel), Wide, rng, noise=0.003)
            write_png(os.path.join(mav, cam, "data", f"{ns}.png"),
                      to_u8(_bilinear(wide, uw, vw)))
        T_WB = T_wc0 @ np.linalg.inv(EUROC_T_BS0)
        R = T_WB[:3, :3]
        w = np.sqrt(max(1 + np.trace(R), 0)) / 2
        q = (w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w))
        rows.append(f"{ns}," + ",".join(repr(float(v))
                                        for v in (*T_WB[:3, 3], *q)))
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"))
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("\n".join(rows) + "\n")


# The port's own CPU runs of the dataset paths (``python3 chip_smoke.py
# --cpu-ate dataset``, plain versions, device="cpu"): ATE in m of the
# KITTI-layout app per frame and chunked, and of the EuRoC-layout per-frame
# VO over host- and device-rectified frames. Each bound is 2x + 2 cm.
DATASET_CPU = {"kitti_frame": 0.015001279747805839,
               "kitti_chunk": 0.015215122199535067,
               "euroc_host": 0.003719064313032753,
               "euroc_device": 0.003719509190102203}
# the reference's own bound between the chunked and the per-frame driver
# (tests/test_batch_vo.py:117)
CHUNK_VS_FRAME_M = 5e-3
# one pair's f2f match of one feature family, and its optimize_pose, in the
# per-frame driver
TRACK_PAIR = {"hamming_scan": 1, "hamming_finish": 1}
GN_PAIR = {"pose_gn_optimize": 1}


def expected_frame_launches(n_frames: int, remaps: int = 0,
                            points: bool = True) -> dict:
    """Each kernel's launches in a per-frame run with lines: n_frames
    extractions, n_frames - 1 tracked pairs (points and lines; lines only
    without ``points``), and ``remaps`` launches of N."""
    from collections import Counter
    n = Counter()
    for table, times in ((EXTRACT_POINTS if points else {}, n_frames),
                         (EXTRACT_LINES, n_frames),
                         (TRACK_PAIR, (1 + points) * (n_frames - 1)),
                         (GN_PAIR, n_frames - 1)):
        for k, v in table.items():
            n[k] += v * times
    if remaps:
        n["remap_bilinear"] = remaps
    return dict(n)


def _ate_check(tag, ate):
    cpu = DATASET_CPU[tag]
    bound_m = None if cpu is None else 2 * cpu + 0.02
    print(f"[{tag}] ate_m={ate:.6f} (bound {bound_m}; CPU run {cpu})",
          flush=True)
    check(bound_m is not None and math.isfinite(ate) and ate < bound_m,
          f"{tag}: ATE {ate} m outside its bound {bound_m} m")


def kitti_app_runs(device, root, flags=(), prefix="kitti"):
    """The port's app over the KITTI-layout directory with ``flags``,
    chunked (B = 20) and per frame (``{prefix}_chunk``, ``{prefix}_frame``);
    returns each run's record with its launches and ATE."""
    import os
    from plslam_tpu_torch import native
    from plslam_tpu_torch.apps import plstvo_dataset
    from plslam_tpu_torch.io.dataset import open_dataset
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    gt = open_dataset(root).gt_poses
    out = {}
    for tag, extra in ((prefix + "_chunk", ["--chunk", str(CHUNK)]),
                       (prefix + "_frame", [])):
        rec = {}
        native.reset_counts()
        t0 = time.perf_counter()
        rc = plstvo_dataset.main([root, "--quiet", "--device", device,
                                  "--out", os.path.join(root, tag + ".txt"),
                                  *flags, *extra], record=rec)
        rec["wall"] = time.perf_counter() - t0
        rec["launches"] = dict(native.LAUNCHES)
        check(rc == 0, f"{tag}: the app returned {rc}")
        rec["ate"] = float(ate_rmse(rec["est"], gt[:len(rec["est"])]))
        out[tag] = rec
    return out


def euroc_vo(device, frames, cam, cfg, n_frames=EUROC_FRAMES):
    """The per-frame StereoVO with lines over ``frames(i)`` pairs, i <
    ``n_frames``; returns the trajectory, the per-frame good flags and the
    launches."""
    from plslam_tpu_torch import native
    from plslam_tpu_torch.frontend.stereo_frame import make_extractor
    from plslam_tpu_torch.tracking.frame_handler import StereoVO
    vo = StereoVO(cfg, cam, make_extractor(cam, cfg, device=device),
                  device=device)
    native.reset_counts()
    t0 = time.perf_counter()
    vo.initialize(*frames(0))
    good = [vo.insert_stereo_pair(*frames(i)).good
            for i in range(1, n_frames)]
    return dict(est=np.stack(vo.trajectory), good=np.array(good),
                launches=dict(native.LAUNCHES),
                ms=1e3 * (time.perf_counter() - t0) / n_frames)


def euroc_runs(device, root):
    """``open_dataset`` (host rectification) into the per-frame VO, then
    the same raw pairs rectified by ``StereoRectifier`` (kernel N, one
    launch a pair) into the per-frame VO. Returns both runs and the
    dataset (the caller closes it)."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera, StereoRectifier
    from plslam_tpu_torch.io.dataset import open_dataset
    from plslam_tpu_torch.io.imageio import load_gray
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    ds = open_dataset(root)
    check(len(ds) == EUROC_FRAMES and ds.rect_maps is not None
          and ds.gt_poses is not None, "EuRoC layout: wrong dataset")
    cam = StereoCamera.from_config(ds.camera)
    cfg = SlamConfig().with_updates({"camera": {
        k: getattr(ds.camera, k) for k in ("width", "height", "fx", "fy",
                                           "cx", "cy", "baseline")}})
    raw = [(load_gray(l), load_gray(r)) for l, r in zip(ds.left, ds.right)]
    rect = StereoRectifier(*ds.rect_maps, device=device)
    out = {"euroc_host": euroc_vo(device, ds.frame, cam, cfg),
           "euroc_device": euroc_vo(device, lambda i: rect(*raw[i]), cam,
                                    cfg)}
    for r in out.values():
        r["ate"] = float(ate_rmse(r["est"], ds.gt_poses))
    return out, ds, raw


def cpu_dataset_runs() -> None:
    """The dataset paths on the CPU: the DATASET_CPU values."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        kitti, euroc = dataset_dirs(tmp)
        t0 = time.perf_counter()
        runs = kitti_app_runs("cpu", kitti)
        eu, ds, _ = euroc_runs("cpu", euroc)
        ds.close()
        runs.update(eu)
        for k, r in runs.items():
            print(f"[cpu] {k}: good={int(r['good'].sum())}/"
                  f"{len(r['good'])} ate_m={r['ate']!r}", flush=True)
        print("[cpu] DATASET_CPU = " + json.dumps(
            {k: runs[k]["ate"] for k in DATASET_CPU})
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def dataset_dirs(tmp):
    """Write the KITTI-layout and the EuRoC-layout directories."""
    import os
    t0 = time.perf_counter()
    kitti, euroc = os.path.join(tmp, "kitti"), os.path.join(tmp, "euroc")
    _, _, seq = main_scene(lines=True)
    write_kitti(kitti, seq)
    write_euroc(euroc)
    print(f"[dataset] wrote the KITTI-layout ({len(seq.poses)} pairs, "
          f"1241x376) and EuRoC-layout ({EUROC_FRAMES} raw pairs, "
          f"{EUROC_W}x{EUROC_H}) directories in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return kitti, euroc


def kitti_rig():
    """A KITTI-shaped distorted rig (1241x376, 0.537 m) for kernel N's
    second shape."""
    from plslam_tpu_torch.core.camera import stereo_rectify
    K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157],
                  [0, 0, 1.0]])
    d = (-0.05, 0.01, 0.0002, -0.0001)
    R = _rot(0.004, -0.006, 0.003)
    return stereo_rectify(K, d, K, d, R, R @ np.array([-0.537, 0, 0]), 376,
                          1241)[:2]


def remap_case(record, dev, pair, maps, tag):
    """Kernel N on one pair with its two maps against its plain version
    (bit-equal), beside its bound and F.grid_sample."""
    import torch
    import torch.nn.functional as F
    from plslam_tpu_torch.core import camera
    img = torch.from_numpy(np.stack(pair)).to(dev)
    m = torch.from_numpy(np.stack(maps)).to(dev)
    N, H, W = img.shape
    Ho, Wo = m.shape[1:3]
    got = camera.remap_bilinear(img, m)
    plain = camera.remap_bilinear_plain(img, m)
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=dev)
    grid = m * scale - 1.0
    record("remap_bilinear" + tag, "plslam_tpu_torch/csrc/remap.cu",
           "plslam_tpu/core/camera.py:203", [got], [plain], 0.0,
           lambda: camera.remap_bilinear(img, m),
           lambda: camera.remap_bilinear_plain(img, m),
           N * (Ho * Wo * (8 + 4) + H * W * 4), N * Ho * Wo * 13,
           library_fn=lambda: F.grid_sample(
               img[:, None], grid, mode="bilinear", padding_mode="zeros",
               align_corners=True), entry="remap_bilinear",
           err_kind="bit-equal")
    lib = F.grid_sample(img[:, None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)[:, 0]
    print(f"[remap{tag}] {N} x {H}x{W} -> {Ho}x{Wo}; F.grid_sample "
          f"(align_corners, zeros) differs from the kernel by "
          f"{max_abs_err(lib, got):.3g}", flush=True)


def dataset_path(dev, record):
    """The app over a KITTI-layout directory at the flagship width, per
    frame and chunked; the EuRoC-layout raw rig through host and device
    rectification; kernel N at both shapes. Returns the launches of the
    device-rectified run (the path of N)."""
    import glob
    import tempfile
    from plslam_tpu_torch.core.camera import StereoRectifier
    from plslam_tpu_torch.io.imageio import _remap_np, load_gray
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    with tempfile.TemporaryDirectory() as tmp:
        kitti, euroc = dataset_dirs(tmp)

        # the KITTI-layout app, chunked and per frame
        runs = kitti_app_runs(dev.type, kitti)
        cfg, cam, seq = main_scene(lines=True)
        n = len(seq.poses)
        ul, ur = to_u8(seq.images_l), to_u8(seq.images_r)
        inv = np.float32(1.0) / np.float32(255.0)
        vo = BatchedStereoVO(cfg, cam, device=dev)
        vo.initialize(ul[0].astype(np.float32) * inv,
                      ur[0].astype(np.float32) * inv)
        vo.process_chunk(ul[1:1 + CHUNK], ur[1:1 + CHUNK])
        vo.submit_chunk(ul[1 + CHUNK:], ur[1 + CHUNK:])
        vo.drain()
        d_mem = float(np.abs(np.stack(vo.trajectory)
                             - runs["kitti_chunk"]["est"]).max())
        d_cf = float(np.linalg.norm(
            runs["kitti_chunk"]["est"][:, :3, 3]
            - runs["kitti_frame"]["est"][:, :3, 3], axis=1).max())
        for tag, want in (("kitti_chunk", expected_launches(True)),
                          ("kitti_frame", expected_frame_launches(n))):
            r = runs[tag]
            per = sum(r["launches"].values()) / (n - 1)
            print(f"[{tag}] frames={n} good={int(r['good'].sum())}/"
                  f"{len(r['good'])} fps={r['fps']:.2f} (the app's clock) "
                  f"run {r['wall']:.2f} s; {per:.1f} kernel launches a "
                  f"frame", flush=True)
            if "timer" in r:
                print(f"[{tag}] stage ms a frame: {r['timer']}", flush=True)
            _ate_check(tag, r["ate"])
            check(bool(r["good"].all()) and len(r["good"]) == n - 1,
                  f"{tag}: frames not tracked")
            check(r["launches"] == want, f"{tag}: launches {r['launches']}"
                  f" differ from the path's {want}")
        print(f"[kitti] chunked app vs in-memory BatchedStereoVO on the "
              f"same uint8 frames: {d_mem:.3g}; chunked vs per frame: "
              f"{d_cf:.3g} m (bound {CHUNK_VS_FRAME_M})", flush=True)
        check(d_mem == 0.0, "the chunked app differs from the in-memory "
              f"run by {d_mem}")
        check(d_cf < CHUNK_VS_FRAME_M, f"chunked vs per frame {d_cf} m")

        # the app's --no-points (lines only), chunked and per frame
        lo = kitti_app_runs(dev.type, kitti, ["--no-points"], "app")
        for tag, want in (("app_chunk", expected_launches(True,
                                                          points=False)),
                          ("app_frame", expected_frame_launches(
                              n, points=False))):
            r = lo[tag]
            print(f"[lines_only {tag}] fps={r['fps']:.2f} (the app's clock)"
                  f" run {r['wall']:.2f} s; launches="
                  f"{json.dumps(r['launches'], sort_keys=True)}", flush=True)
            hold_cpu(f"lines_only {tag}", r, seq.poses,
                     LINES_ONLY_CPU[tag])
            check(r["launches"] == want, f"lines_only {tag}: launches "
                  f"{r['launches']} differ from the path's {want}")
        print(f"[slam_app] phase {slam_app_runs(dev, kitti):.1f} s",
              flush=True)

        # the EuRoC-layout raw rig, host and device rectification
        eu, ds, raw = euroc_runs(dev.type, euroc)
        for tag, remaps in (("euroc_host", 0),
                            ("euroc_device", EUROC_FRAMES)):
            r = eu[tag]
            print(f"[{tag}] frames={EUROC_FRAMES} good="
                  f"{int(r['good'].sum())}/{len(r['good'])} {r['ms']:.2f} ms "
                  "a frame (host clock; the host run waits on the "
                  "prefetcher's decode and rectification, the device run "
                  "on N, its raw frames decoded before)", flush=True)
            _ate_check(tag, r["ate"])
            check(bool(r["good"].all()), f"{tag}: frames not tracked")
            want = expected_frame_launches(EUROC_FRAMES, remaps)
            check(r["launches"] == want, f"{tag}: launches "
                  f"{r['launches']} differ from the path's {want}")

        # the two border rules agree wherever all four taps are inside
        ml, mr = ds.rect_maps
        W, H = EUROC_W, EUROC_H
        inside = []
        for m in (ml, mr):
            u, v = m[..., 0], m[..., 1]
            inside.append((u >= 0) & (v >= 0) & (u <= W - 1.001)
                          & (v <= H - 1.001))
        rect = StereoRectifier(ml, mr, device=dev)
        d_rule = 0.0
        for i in range(EUROC_FRAMES):
            got = [t.cpu().numpy() for t in rect(*raw[i])]
            for g, h, k in zip(got, ds.frame(i), inside):
                d_rule = max(d_rule, float(np.abs(g - h)[k].max()))
        ds.close()
        print(f"[euroc] device (N, out-of-bounds taps 0) vs host "
              f"(clamped) rectification where all four taps are inside "
              f"({100 * np.mean(inside):.2f}% of the pixels): {d_rule:.3g} "
              f"(bound 1e-6)", flush=True)
        check(d_rule <= 1e-6, f"device vs host rectification {d_rule}")

        # host decode and rectification a frame, beside the device
        paths = sorted(glob.glob(f"{kitti}/image_0/*.png"))
        t0 = time.perf_counter()
        for p in paths[:10]:
            load_gray(p)
        dec = (time.perf_counter() - t0) / 10 * 1e3
        t0 = time.perf_counter()
        for l, r in raw[:5]:
            _remap_np(l, ml)
            _remap_np(r, mr)
        rec_ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"[dataset] host: decode {dec:.3f} ms a 1241x376 PNG, "
              f"rectify {rec_ms:.3f} ms a 752x480 pair (_remap_np)",
              flush=True)

        # kernel N at the path's shapes
        remap_case(record, dev, raw[0], (ml, mr), "")
        remap_case(record, dev,
                   (seq.images_l[0], seq.images_r[0]), kitti_rig(),
                   "@1241x376")
    return eu["euroc_device"]["launches"]


# -- slice 20: KF-slot compaction, checkpoints, the SLAM app ------------------

class Tripwires:
    """stdout passed through, counting the settle tripwires' lines
    (``[fused_slam] WARNING``)."""

    def __init__(self, out):
        self.out = out
        self.n = 0

    def write(self, s):
        self.n += s.count("[fused_slam] WARNING")
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def watch_compactions(slam, sync=True):
    """Wraps ``slam._compact``: each event's ms (the drain included, host
    clock between synchronizes on the card) and the frames settled when it
    ended. Returns the two lists, filled as the run goes."""
    import torch
    ms, frames = [], []
    orig = slam._compact

    def timed():
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig()
        if sync:
            torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        frames.append(len(slam.trajectory))
    slam._compact = timed
    return ms, frames


# (b): tests/test_compact_loops.py's scene and settings: 512x320, points
# only, max_kfs 64, a keyframe every frame, loops on; 7 laps of a 40-frame
# lap in chunks of 10 (281 frames)
COMPACT_LAP, COMPACT_LAPS, COMPACT_CHUNK = 40, 7, 10
COMPACT_UPDATES = {
    "camera": {"width": 512, "height": 320, "fx": 400.0, "fy": 400.0,
               "cx": 256.0, "cy": 160.0, "baseline": 0.3},
    "points": {"max_kpts": 384, "orb_nlevels": 2},
    "lines": {"has_lines": False},
    "matching": {"f2f_window": 128.0},
    "mapping": {"max_kfs": 64, "max_points": 4096, "max_lines": 256,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 5},
    "keyframe": {"min_entropy_ratio": 2.0},
    "system": {"async_mapping": False, "kf_batch": 4},
    "loop": {"enabled": True, "min_kf_separation": 12,
             "consistency_window": 2, "lc_inl": 15,
             "lc_trs": 3.0, "lc_rot": 60.0, "lc_cooldown": 5}}
# The port's own CPU run of (b) (``python3 chip_smoke.py --cpu-ate
# compact``: the plain versions, device="cpu", the same frames): keyframe
# frames, the frames at which each compaction ended, the eviction events
# (frame, slots), loop events (from, to, inliers), the funnel and the ATE.
COMPACT_CPU = {
    "kf_frames": [0, 1, 2, 3, 10, 11, 12, 13, 20, 21, 22, 23, 30, 31, 32, 33,
        40, 41, 42, 43, 50, 51, 52, 53, 60, 61, 62, 63, 70, 71, 72, 73, 80,
        81, 82, 83, 90, 91, 92, 93, 100, 101, 102, 103, 110, 111, 112, 113,
        120, 121, 122, 123, 130, 131, 132, 133, 140, 141, 142, 143, 150, 151,
        152, 153, 160, 161, 162, 163, 170, 171, 172, 173, 180, 181, 182, 183,
        190, 191, 192, 193, 200, 201, 202, 203, 210, 211, 212, 213, 220, 221,
        222, 223, 230, 231, 232, 233, 240, 241, 242, 243, 250, 251, 252, 253,
        260, 261, 262, 263, 270, 271, 272, 273],
    "compactions": [161, 211, 241, 271],
    "evictions": [[161, [1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23]], [211,
        [1, 3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23]], [241, [1, 3, 5, 7, 9,
        11, 13, 15, 17, 19, 21, 23]], [271, [1, 3, 5, 7, 9, 11, 13, 15, 17,
        19, 21, 23]]],
    "events": [[1, 17, 140], [6, 22, 136], [11, 27, 143], [16, 32, 167], [5,
        37, 132], [10, 42, 149], [16, 48, 167], [6, 54, 136], [12, 60, 143],
        [1, 47, 160], [37, 52, 141], [14, 58, 141], [18, 63, 160], [12, 55,
        146], [3, 61, 144], [2, 55, 147], [31, 61, 149], [24, 54, 167]],
    "funnel": [119, 20, 2, 0, 0, 18],
    "ate": 0.10339306082482994}


def circuit(lap, step, seed, n_pts, n_lns, r_in, r_out, r_min, y):
    """A lap of ``lap`` poses, ``step`` m a frame around a ring, and a ring
    of ``n_pts`` points and ``n_lns`` lines at radii from max(R - r_in,
    r_min) to R + r_out about the circuit's centre and heights within
    +-``y``, R the circuit radius, from a generator of seed ``seed``:
    (world, the lap's poses, R, the generator, for the frames' noise)."""
    from plslam_tpu_torch.io import synthetic
    S = synthetic._exp_se3_np(
        np.array([0, 0, step, 0, 2.0 * np.pi / lap, 0], np.float32))
    T, lap_poses = np.eye(4, dtype=np.float32), []
    for _ in range(lap):
        lap_poses.append(T)
        T = (T @ S).astype(np.float32)
    lap_poses = np.stack(lap_poses)
    center = lap_poses[:, :3, 3].mean(0)
    R_cam = float(np.linalg.norm(lap_poses[0, :3, 3] - center))
    rng = np.random.default_rng(seed)

    def ring(n):
        ang = rng.uniform(0, 2 * np.pi, n)
        rad = rng.uniform(max(R_cam - r_in, r_min), R_cam + r_out, n)
        return np.stack([center[0] + rad * np.sin(ang),
                         rng.uniform(-y, y, n),
                         center[2] + rad * np.cos(ang)], -1).astype(np.float32)
    pts = ring(n_pts)
    sp = ep = np.zeros((0, 3), np.float32)
    if n_lns:
        sp = ring(n_lns)
        d = rng.normal(size=(n_lns, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        ep = (sp + d * rng.uniform(1.0, 4.0, (n_lns, 1))).astype(np.float32)
    world = synthetic.SyntheticWorld(pts, sp, ep,
                                     rng.integers(0, 2 ** 31 - 1, n_pts))
    return world, lap_poses, R_cam, rng


def compact_scene():
    """(cfg, cam, lap frames l and r (uint8), the run's ground truth, the
    circuit radius), rendered as tests/test_compact_loops.py renders them."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cfg = SlamConfig().with_updates(COMPACT_UPDATES)
    cam = StereoCamera.from_config(cfg.camera)
    lap = COMPACT_LAP
    world, lap_poses, R_cam, rng = circuit(lap, 0.3, 3, 700, 0, 8.0, 10.0,
                                           1.5, 2.5)
    poses = np.concatenate([lap_poses] * COMPACT_LAPS + [lap_poses[:1]])
    il = np.empty((lap, cam.height, cam.width), np.uint8)
    ir = np.empty_like(il)
    for i in range(lap):
        l_, r_ = synthetic.render_frame(world, lap_poses[i], cam, rng,
                                        noise=0.004)
        il[i], ir[i] = to_u8(l_), to_u8(r_)
    return cfg, cam, il, ir, poses, R_cam


def compact_run(device):
    """(b) on ``device``: returns the run's record (decisions, events,
    compactions, ATE, the floors' measures)."""
    import torch
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    cfg, cam, il, ir, poses, R_cam = compact_scene()
    n = COMPACT_LAPS * COMPACT_LAP + 1
    sync = torch.device(device).type == "cuda"
    slam = FusedPLSLAM(cfg, cam, device=device)
    ms, comp_frames = watch_compactions(slam, sync)
    t0 = time.perf_counter()
    slam.initialize(il[0], ir[0])
    for g in range(1, n, COMPACT_CHUNK):
        idx = np.arange(g, g + COMPACT_CHUNK) % COMPACT_LAP
        slam.process_chunk(il[idx], ir[idx])
    est = slam.finish()
    if sync:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kf_frames, events, funnel, good, margin = loop_summary(slam, cfg)
    lc = slam.loop_closer
    return dict(
        kf_frames=kf_frames, compactions=comp_frames,
        evictions=[[f, s] for f, s in slam.eviction_events],
        events=[list(e) for e in events], funnel=list(funnel),
        ate=float(ate_rmse(est, poses[:len(est)])),
        max_pos=float(np.abs(est[:, :3, 3]).max()), R_cam=R_cam,
        n_frames=len(est), n_evicted=slam.n_evicted_kfs,
        loops=lc.n_loops_closed, good=good, margin=margin, ms=ms,
        wall=wall, n_kfs=int(slam.state.n_kfs), max_kfs=cfg.mapping.max_kfs)


def compact_floors(tag, r) -> None:
    """tests/test_compact_loops.py's floors."""
    check(r["n_frames"] == COMPACT_LAPS * COMPACT_LAP + 1,
          f"{tag}: {r['n_frames']} frames in the trajectory")
    check(len(r["compactions"]) >= 2, f"{tag}: compactions "
          f"{r['compactions']}")
    check(r["n_evicted"] >= 8, f"{tag}: {r['n_evicted']} evicted")
    check(r["loops"] >= 5, f"{tag}: {r['loops']} closures")
    check(r["max_pos"] < 5 * r["R_cam"], f"{tag}: |t| {r['max_pos']} m, "
          f"circuit radius {r['R_cam']} m")
    check(r["ate"] < 1.0, f"{tag}: ATE {r['ate']} m")


def cpu_compact_run() -> None:
    """(b) on the CPU: the COMPACT_CPU values."""
    t0 = time.perf_counter()
    r = compact_run("cpu")
    print(f"[cpu] compact: good={int(r['good'].sum())}/{len(r['good'])} "
          f"smallest decision margin {r['margin'].min():.6g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    compact_floors("[cpu] compact", r)
    print("[cpu] COMPACT_CPU = " + json.dumps({
        k: r[k] for k in ("kf_frames", "compactions", "evictions", "events",
                          "funnel", "ate")}), flush=True)


def compact_phase(dev) -> float:
    """(b) on the card against COMPACT_CPU; returns the phase's seconds."""
    t0 = time.perf_counter()
    probe = LoopProbe()
    try:
        r = compact_run(dev)
    finally:
        probe.close()
    cpu = COMPACT_CPU
    print(f"[compact] frames={r['n_frames']} good={int(r['good'].sum())}/"
          f"{len(r['good'])} keyframes={len(r['kf_frames'])} compactions at "
          f"frames {r['compactions']} ({[round(x, 1) for x in r['ms']]} ms) "
          f"evictions {r['evictions']} closures={r['loops']} events="
          f"{r['events']} funnel={r['funnel']} ate_m={r['ate']:.6f} "
          f"max|t|={r['max_pos']:.3f} m (radius {r['R_cam']:.3f}) n_kfs="
          f"{r['n_kfs']}/{r['max_kfs']} fps="
          f"{(r['n_frames'] - 1) / r['wall']:.2f}", flush=True)
    check(cpu is not None, "compact: no CPU record (python3 chip_smoke.py "
          "--cpu-ate compact)")
    keys = ("kf_frames", "compactions", "evictions", "events", "funnel")
    same = all(r[k] == cpu[k] for k in keys)
    near = min(r["margin"].min(), probe.margin, probe.gap)
    print(f"[compact] CPU run: keyframes {len(cpu['kf_frames'])}, "
          f"compactions {cpu['compactions']}, evictions {cpu['evictions']}, "
          f"events {cpu['events']}, funnel {cpu['funnel']}, ATE "
          f"{cpu['ate']}; identical: {same} "
          f"({[k for k in keys if r[k] != cpu[k]]} differ); smallest margin "
          f"{near:.6g}", flush=True)
    check(bool(r["good"].all()), "compact: frames not tracked")
    check(same or near < THRESHOLD_MARGIN, "compact: decisions differ from "
          f"the CPU run with the smallest margin {near}")
    bound_m = 2 * cpu["ate"] + 0.02
    check(r["ate"] <= bound_m, f"compact: ATE {r['ate']} m outside its "
          f"bound {bound_m} m")
    compact_floors("compact", r)
    return time.perf_counter() - t0


# (c): loop_scene checkpointed after 6 of its 11 chunks
CK_CHUNKS = 6
# the resumed run's positions against the loop path's run, which does not
# drain at the checkpoint: tests/test_torch_checkpoint.py's 1 cm
CK_FULL_M = 0.01


def _funnel(lc):
    return np.array((lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom,
                     lc.n_rej_unc, lc.n_rej_corr))


def checkpoint_phase(dev, full) -> float:
    """(c): ``FusedPLSLAM(SlamConfig())`` over loop_scene's first 6 chunks,
    ``save_checkpoint``, ``resume`` in a new driver (the BoW rows rebuilt
    bit-equal, L's launches one a family and keyframe), the last 5 chunks;
    held to a run that drains its pipeline at the same point, as
    ``save_checkpoint`` does (everything equal), and to the loop path's
    run ``full`` (keyframes, events and funnel equal and positions within
    ``CK_FULL_M``, or under the margin rule). Returns the phase's seconds."""
    import os
    import tempfile
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    t_phase = time.perf_counter()
    cfg, cam, seq, il, ir = LOOP_SCENE
    dev_chunks = [torch.from_numpy(np.stack([il[lo:lo + CHUNK],
                                             ir[lo:lo + CHUNK]])).to(dev)
                  for lo in range(1, 1 + LOOP_CHUNKS * CHUNK, CHUNK)]
    drive = lambda s, lo, hi: [s.process_chunk(c) for c in dev_chunks[lo:hi]]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "loop.npz")
        half = FusedPLSLAM(cfg, cam)
        half.initialize(il[0], ir[0])
        drive(half, 0, CK_CHUNKS)
        t0 = time.perf_counter()
        half.save_checkpoint(path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(path)
        db0 = half.loop_closer.db
        saved = {k: getattr(db0, k).clone() for k in ("bows_p", "bows_l",
                                                      "ln_valid")}
        f0, ev0 = _funnel(half.loop_closer), list(half.loop_closer.events)
        n_kfs = int(half.state.n_kfs)
        del half
        torch.cuda.synchronize()
        native.reset_counts()
        t0 = time.perf_counter()
        res = FusedPLSLAM.resume(path, cam)
        torch.cuda.synchronize()
        resume_ms = 1e3 * (time.perf_counter() - t0)
        rebuild = dict(native.LAUNCHES)
    db = res.loop_closer.db
    rows_equal = all(torch.equal(getattr(db, k), v) for k, v in saved.items())
    drive(res, CK_CHUNKS, LOOP_CHUNKS)
    est = res.finish()
    drained = FusedPLSLAM(cfg, cam)
    drained.initialize(il[0], ir[0])
    drive(drained, 0, CK_CHUNKS)
    drained.online_pose(drain=True)
    drive(drained, CK_CHUNKS, LOOP_CHUNKS)
    est_d = drained.finish()
    torch.cuda.synchronize()
    lr, ld, lf = res.loop_closer, drained.loop_closer, full.loop_closer
    ev = lambda e: [(x.kf_from, x.kf_to, x.n_inliers) for x in e]
    flags_r, _, margin_r = decisions(res, cfg)
    flags_d, _, margin_d = decisions(drained, cfg)
    flags_f, _, margin_f = decisions(full, cfg)
    cut = CK_CHUNKS * CHUNK
    print(f"[checkpoint] saved {n_kfs} keyframes after {cut + 1} frames in "
          f"{save_ms:.1f} ms ({size} bytes, npz); resume {resume_ms:.1f} ms "
          f"with the BoW rebuild's launches {rebuild}; rows bit-equal: "
          f"{rows_equal}", flush=True)
    d_drained = float(np.abs(est - est_d).max())
    d_full = float(np.linalg.norm(est[:, :3, 3] - full.finish()[:, :3, 3],
                                  axis=1).max())
    same_d = (np.array_equal(flags_r, flags_d[cut:])
              and ev(ev0) + ev(lr.events) == ev(ld.events)
              and (f0 + _funnel(lr) == _funnel(ld)).all())
    same_f = (np.array_equal(flags_r, flags_f[cut:])
              and ev(ev0) + ev(lr.events) == ev(lf.events)
              and (f0 + _funnel(lr) == _funnel(lf)).all())
    ate = float(ate_rmse(est, seq.poses[:len(est)]))
    print(f"[checkpoint] resumed: events {ev(ev0)} + {ev(lr.events)}, "
          f"funnel {f0.tolist()} + {_funnel(lr).tolist()}, ate_m={ate:.6f}; "
          f"against the run drained at the checkpoint: decisions equal "
          f"{same_d}, trajectory max difference {d_drained:.3g}; against "
          f"the loop path's run: decisions equal {same_f}, positions within "
          f"{d_full:.3g} m", flush=True)
    check(rebuild == {"bow_descend": 2 * n_kfs, "bow_hist": 2 * n_kfs},
          f"checkpoint: the BoW rebuild launched {rebuild}, not one "
          f"bow_descend and bow_hist a family and keyframe ({n_kfs})")
    check(rows_equal, "checkpoint: the rebuilt BoW rows differ from the "
          "saved driver's")
    near_d = min(margin_r.min(), margin_d.min())
    check((same_d and d_drained == 0.0) or near_d < THRESHOLD_MARGIN,
          "checkpoint: the resumed run differs from the run drained at the "
          f"checkpoint (trajectory {d_drained}) with the smallest margin "
          f"{near_d}")
    near_f = min(margin_r.min(), margin_f.min())
    check((same_f and d_full < CK_FULL_M) or near_f < THRESHOLD_MARGIN,
          "checkpoint: keyframes, events or funnel differ from the loop "
          f"path's run, or positions by {d_full} m (bound {CK_FULL_M}), with "
          f"the smallest margin {near_f}")
    bound_m = 2 * LOOP_CPU["default"]["ate"] + 0.02
    check(ate < bound_m, f"checkpoint: ATE {ate} m outside {bound_m} m")
    return time.perf_counter() - t_phase


def slam_app_runs(dev, kitti) -> float:
    """(d): the SLAM app (``--chunk 20``, the default SlamConfig()) over the
    KITTI-layout directory, held to ``FusedPLSLAM`` in memory on the same
    uint8 frames; its ``--checkpoint`` after 21 frames, then ``--resume``,
    held to the uninterrupted app run; the per-frame app (``--chunk 0``,
    the default: PLSLAM with the mapping worker) held to ``PLSLAM`` in
    memory on the same frames; the host-KF app (``--config`` with
    ``system.fused_slam: false``: ChunkedPLSLAM) every frame and its ATE
    bound. Returns the phase's seconds."""
    import os
    from plslam_tpu_torch.apps import plslam_dataset
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.backend.slam_system import PLSLAM
    from plslam_tpu_torch.io.dataset import open_dataset
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    t0 = time.perf_counter()
    cfg, cam, seq = main_scene(lines=True)
    n = len(seq.poses)
    half = CHUNK + 1
    host_kf = os.path.join(kitti, "host_kf.yaml")
    with open(host_kf, "w") as f:
        f.write("system:\n  fused_slam: false\n")
    runs = {}
    for tag, extra in (("app", ["--chunk", str(CHUNK), "--out",
                                os.path.join(kitti, "slam.txt")]),
                       ("app_half", ["--chunk", str(CHUNK), "--frames",
                                     str(half), "--checkpoint",
                                     os.path.join(kitti, "half.npz")]),
                       ("app_resumed", ["--chunk", str(CHUNK), "--resume",
                                        os.path.join(kitti, "half.npz")]),
                       ("app_frame", []),
                       ("app_host_kf", ["--chunk", str(CHUNK), "--config",
                                        host_kf])):
        rec = {}
        t1 = time.perf_counter()
        rc = plslam_dataset.main([kitti, "--quiet", "--device", dev.type,
                                  *extra], record=rec)
        check(rc == 0, f"{tag}: the SLAM app returned {rc}")
        rec["wall_all"] = time.perf_counter() - t1
        runs[tag] = rec
    ul, ur = to_u8(seq.images_l), to_u8(seq.images_r)
    inv = np.float32(1.0) / np.float32(255.0)
    mem = FusedPLSLAM(cfg, cam, device=dev)
    mem.initialize(ul[0].astype(np.float32) * inv,
                   ur[0].astype(np.float32) * inv)
    for lo in range(1, n, CHUNK):
        mem.process_chunk(ul[lo:lo + CHUNK], ur[lo:lo + CHUNK],
                          n_valid=min(CHUNK, n - lo))
    est_mem = mem.finish()
    per = PLSLAM(cfg, cam, device=dev)
    per.initialize(ul[0].astype(np.float32) * inv,
                   ur[0].astype(np.float32) * inv)
    for i in range(1, n):
        per.process(ul[i].astype(np.float32) * inv,
                    ur[i].astype(np.float32) * inv)
    est_per = per.finish()
    app, res = runs["app"], runs["app_resumed"]
    frame, hkf = runs["app_frame"], runs["app_host_kf"]
    gt = open_dataset(kitti).gt_poses
    d_mem = float(np.abs(app["est"] - est_mem).max())
    d_res = float(np.abs(app["est"] - res["est"]).max())
    d_per = float(np.abs(frame["est"] - est_per).max())
    ate = {k: float(ate_rmse(runs[k]["est"], gt[:n]))
           for k in ("app", "app_frame", "app_host_kf")}
    print(f"[slam_app] frames={n} keyframes={app['slam']._kf_slot + 1} "
          f"ate_m={ate['app']:.6f} fps="
          f"{app['fps']:.2f} (the app's clock), the run "
          f"{app['wall_all']:.2f} s; against FusedPLSLAM in memory on the "
          f"same uint8 frames: {d_mem:.3g}; --checkpoint after {half} "
          f"frames then --resume ({res['wall_all']:.2f} s) against the "
          f"uninterrupted run: {d_res:.3g}", flush=True)
    print(f"[slam_app] --chunk 0 (PLSLAM): {frame['n_good']}/{n - 1} "
          f"tracked, keyframes={frame['slam']._kf_slot + 1} ate_m="
          f"{ate['app_frame']:.6f} fps={frame['fps']:.2f} (the app's clock),"
          f" against PLSLAM in memory on the same frames: {d_per:.3g}; "
          f"fused_slam=false (ChunkedPLSLAM): keyframes="
          f"{hkf['slam']._kf_slot + 1} ate_m={ate['app_host_kf']:.6f} fps="
          f"{hkf['fps']:.2f}", flush=True)
    check(len(app["est"]) == n == len(res["est"]), "slam_app: frames missing")
    check(d_mem == 0.0, f"slam_app: the app differs from the in-memory run "
          f"by {d_mem}")
    check(d_res == 0.0, f"slam_app: the resumed app run differs from the "
          f"uninterrupted one by {d_res}")
    check(len(frame["est"]) == n == len(hkf["est"])
          and frame["n_good"] == n - 1, "slam_app: per-frame or host-KF "
          "frames missing or untracked")
    check(d_per == 0.0, f"slam_app: the per-frame app differs from PLSLAM "
          f"in memory by {d_per}")
    for k in ("app_frame", "app_host_kf"):
        bound_m = 2 * DATASET_CPU["kitti_frame"] + 0.02
        check(ate[k] < bound_m, f"slam_app: {k} ATE {ate[k]} m outside "
              f"{bound_m} m")
    return time.perf_counter() - t0


# (a): bench_slam_long.py's circuit (:88-125): 10 laps of 400 frames at
# 0.3 m a frame around a ring of 1,600 points and 240 lines (seed 7), noise
# 0.004, keyframe.min_entropy_ratio 0.89, chunks of 20 (4,001 frames)
LONG_LAP, LONG_LAPS, LONG_STEP, LONG_MINENT = 400, 10, 0.3, 0.89
LONG_RENDERERS = 8


def long_circuit():
    """(world, the lap's poses, the circuit radius), as bench_slam_long.py
    makes them."""
    world, lap_poses, R_cam, _ = circuit(LONG_LAP, LONG_STEP, 7, 1600, 240,
                                         12.0, 14.0, 2.0, 3.5)
    return world, lap_poses, R_cam


def render_long(span):
    """Frames ``span`` (lo, hi) of the circuit's lap as uint8 (2, n, H, W);
    frame i's sensor noise from its own generator (seed (7, i)), so that
    processes can share the lap."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cam = StereoCamera.from_config(SlamConfig().camera)
    world, lap_poses, _ = long_circuit()
    lo, hi = span
    out = np.empty((2, hi - lo, cam.height, cam.width), np.uint8)
    for i in range(lo, hi):
        l_, r_ = synthetic.render_frame(world, lap_poses[i], cam,
                                        np.random.default_rng([7, i]),
                                        noise=0.004)
        out[0, i - lo], out[1, i - lo] = to_u8(l_), to_u8(r_)
    return out


def long_run(dev, cfg, cam, lap_t, lap_poses, tag):
    """One ``FusedPLSLAM`` run over the 4,001-frame circuit, every chunk
    gathered from the lap on the card (no warm-up): prints its counts and
    returns them."""
    import contextlib
    from collections import Counter
    from types import SimpleNamespace
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse, umeyama_alignment
    lap, n = LONG_LAP, LONG_LAPS * LONG_LAP + 1
    poses = np.concatenate([lap_poses] * LONG_LAPS + [lap_poses[:1]])
    slam = FusedPLSLAM(cfg, cam)
    ms, comp_frames = watch_compactions(slam)
    next_slots = []
    probe = LoopProbe()
    tw = Tripwires(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tw):
            slam.initialize(lap_t[0, 0], lap_t[1, 0])
            for g in range(1, n, CHUNK):
                idx = torch.arange(g, g + CHUNK, device=dev) % lap
                slam.process_chunk(lap_t[:, idx])
                next_slots.append(slam._next_slot)
            est = slam.finish()
            torch.cuda.synchronize()
    finally:
        probe.close()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_chunks = (n - 1) // CHUNK
    flags, good, margin = decisions(slam, cfg)
    n_lba = n_lba_slots(flags, n_chunks, cfg)
    recs = slam.summaries
    lc = slam.loop_closer
    ate = float(ate_rmse(est, poses[:len(est)]))
    p_est, p_gt = est[:, :3, 3], poses[:len(est), :3, 3]
    Ra, ta, _ = umeyama_alignment(p_est, p_gt)
    err = np.linalg.norm(p_est @ Ra.T + ta - p_gt, axis=-1)
    ate_lap = [round(float(np.sqrt((err[k * lap:(k + 1) * lap] ** 2).mean())),
                     4) for k in range(LONG_LAPS)]
    ate_shape = [round(float(ate_rmse(est[k * lap:(k + 1) * lap],
                                      poses[k * lap:(k + 1) * lap])), 4)
                 for k in range(LONG_LAPS)]
    # each pose-graph solve's slot bucket (Fb) and host ms (synchronized)
    fb = [("pcg" if name.endswith("pcg") else "dense",
           int((a[0] if a else k["g"]).poses.shape[0]))
          for name, _, a, k, _ in probe.solves]
    buckets = Counter(b for _, b in fb)
    solve_ms = {}
    for (kind, b), x in zip(fb, [probe.ms[name].pop(0)
                                 for name, *_ in probe.solves]):
        solve_ms.setdefault(f"{kind}@{b}", []).append(round(x, 2))
    F = cfg.mapping.max_kfs
    print(f"[{tag}] frames={n - 1} good={int(good.sum())} keyframes="
          f"{len(recs)} lba_slots={n_lba}", flush=True)
    print(f"[{tag}] fps={(n - 1) / wall:.2f} ms_per_frame="
          f"{1e3 * wall / (n - 1):.3f} (host clock, initialize + {n_chunks} "
          f"chunks + finish, ends in synchronize; timed loop steps and "
          f"compactions synchronize) max_memory_allocated_bytes={peak}",
          flush=True)
    print(f"[{tag}] compactions={slam.n_compactions} at frames "
          f"{comp_frames} ms each (drain included) "
          f"{[round(x, 1) for x in ms]} evicted={slam.n_evicted_kfs} in "
          f"{len(slam.eviction_events)} events at frames "
          f"{[f for f, _ in slam.eviction_events]}; n_kfs settled max "
          f"{max(next_slots)} / {F}, final {int(slam.state.n_kfs)}",
          flush=True)
    print(f"[{tag}] closures={lc.n_loops_closed} funnel (candidates, votes, "
          f"rejected geometry, uncertainty, correction, closed)="
          f"{loop_summary(slam, cfg)[2]} graph edges odo/covis/loop="
          f"{len(lc.odo_edges)}/{len(lc.covis_edges)}/{len(lc.loop_edges)} "
          f"edges_dropped={lc.n_edges_dropped} frozen_events="
          f"{lc.n_frozen_events} solves dense/pcg="
          f"{probe.n.get('optimize_pose_graph', 0)}/"
          f"{probe.n.get('optimize_pose_graph_pcg', 0)} by slot bucket "
          f"{dict(sorted(buckets.items()))}; solve ms (host clock) "
          f"{json.dumps(solve_ms)}", flush=True)
    print(f"[{tag}] ate_m={ate:.6f} per lap (global alignment) {ate_lap} "
          f"per lap (each aligned alone) {ate_shape}; max|t|="
          f"{float(np.abs(p_est).max()):.2f} m; tripwires {tw.n}", flush=True)
    want = expected_loop_launches(1 + len(recs), n_lba, probe,
                                  lc.n_loops_closed, n_chunks)
    print(f"[{tag}] launches={json.dumps(launches, sort_keys=True)}; "
          f"{probe.hold_solves(dev)} pose-graph solve(s) bit-equal to the "
          "loop that assembles and solves every GN step", flush=True)
    return SimpleNamespace(
        slam=slam, n=n, est=est, good=good, next_slots=next_slots,
        launches=launches, want=want, ate=ate, ate_lap=ate_lap,
        fps=(n - 1) / wall, peak=peak, tripwires=tw.n, buckets=buckets,
        max_pos=float(np.abs(p_est).max()), compaction_ms=ms)


def long_phase(dev) -> float:
    """(a): the default SlamConfig() (KITTI calibration at 1241x376, lines
    and loops on, kf_batch 4) with min_entropy_ratio 0.89 over the
    4,001-frame circuit: one lap rendered (8 processes) and kept on the
    card as uint8 (2, 400, 376, 1241), every chunk gathered from it; run
    with max_kfs 512 (compactions and evictions) and again on the same lap
    with max_kfs 1,024 (the reference's provisioned configuration:
    bench_slam_long.py's PLSLAM_LONG_MAXKFS=1024; no compaction, its graphs
    solved at the 1,024-slot bucket with PCG). Returns the phase's
    seconds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    from plslam_tpu_torch.core.camera import StereoCamera
    t_phase = time.perf_counter()
    cfg = flagship({"keyframe": {"min_entropy_ratio": LONG_MINENT}})
    cam = StereoCamera.from_config(cfg.camera)
    _, lap_poses, R_cam = long_circuit()
    bounds = np.linspace(0, LONG_LAP, LONG_RENDERERS + 1).astype(int)
    with ProcessPoolExecutor(
            LONG_RENDERERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(render_long, zip(bounds[:-1], bounds[1:])))
    lap_t = torch.from_numpy(np.concatenate(parts, axis=1)).to(dev)
    del parts
    print(f"[long] rendered a lap of {LONG_LAP} frames in "
          f"{time.perf_counter() - t_phase:.1f} s ({LONG_RENDERERS} "
          f"processes, host), {lap_t.numel()} bytes on the card; circuit "
          f"radius {R_cam:.2f} m", flush=True)
    runs = {}
    for tag, F in (("long", 512), ("long_1024", 1024)):
        c = cfg.with_updates({"mapping": {"max_kfs": F}})
        r = runs[tag] = long_run(dev, c, cam, lap_t, lap_poses, tag)
        slam, lc = r.slam, r.slam.loop_closer
        check(len(r.est) == r.n, f"{tag}: {len(r.est)} frames in the "
              "trajectory")
        check(bool(r.good.all()), f"{tag}: frames not tracked: "
              f"{np.nonzero(~r.good)[0][:20]}")
        check(max(r.next_slots) <= F and int(slam.state.n_kfs) <= F,
              f"{tag}: more than max_kfs={F} keyframes")
        if F == 512:
            check(slam.n_compactions >= 2 and slam.n_evicted_kfs >= 8,
                  f"{tag}: {slam.n_compactions} compactions, "
                  f"{slam.n_evicted_kfs} evicted")
        else:
            check(slam.n_compactions == 0 and slam.n_evicted_kfs == 0,
                  f"{tag}: {slam.n_compactions} compactions, "
                  f"{slam.n_evicted_kfs} evicted")
            check(r.buckets.get(1024, 0) >= 1, f"{tag}: no pose-graph solve"
                  f" at the 1,024-slot bucket ({dict(r.buckets)})")
        check(lc.n_loops_closed >= 5, f"{tag}: {lc.n_loops_closed} closures")
        check(r.max_pos < 5 * R_cam, f"{tag}: |t| {r.max_pos} m beyond 5 x "
              f"the circuit radius {R_cam} m")
        check(r.tripwires == 0, f"{tag}: the settle tripwires printed "
              f"{r.tripwires} time(s)")
        check(r.launches == r.want, f"{tag}: launches {r.launches} differ "
              f"from the path's {r.want}")
        del slam, lc
        runs[tag].slam = None
    a, b = runs["long"], runs["long_1024"]
    print(f"[long] max_kfs 512 vs 1,024 on the same frames: ATE "
          f"{a.ate:.6f} vs {b.ate:.6f} m; per lap (global alignment) "
          f"{list(zip(a.ate_lap, b.ate_lap))}; fps {a.fps:.2f} vs "
          f"{b.fps:.2f}; peak bytes {a.peak} vs {b.peak}", flush=True)
    return time.perf_counter() - t_phase


# -- slice 21: the per-frame and host-KF drivers, run_concurrent, the band ---

# frames of [slam_system]'s per-frame runs: 1 + 7 x 20 of loop_scene (the
# second lap starts at frame 110; the fused run's first closure is at its
# keyframe 23, frame 115); the host-KF runs take all 1 + 11 x 20
SYSTEM_PER_FRAME = 1 + 7 * CHUNK
# (tag, driver, async mapping) of the [slam_system] runs
SYSTEM_RUNS = (("plslam_sync", "PLSLAM", False),
               ("plslam_async", "PLSLAM", True),
               ("chunked_sync", "ChunkedPLSLAM", False),
               ("chunked_async", "ChunkedPLSLAM", True))
# The [slam_system] runs' CPU record (``--cpu-ate slam_system``: the port's
# plain versions, device="cpu", the same frames): keyframe frames, loop
# events (from, to, inliers), the funnel and the ATE of the first three
# runs; the host-KF async run is held to the sync run's ATE
_PF_KF = list(range(5, 141, 5))
SYSTEM_CPU = {
    "plslam_sync": {"kf_frames": _PF_KF, "events": [[1, 23, 252]],
                    "funnel": [6, 1, 0, 0, 0, 1],
                    "ate": 0.01936535637057954},
    "plslam_async": {"kf_frames": _PF_KF, "events": [[1, 23, 252]],
                     "funnel": [6, 1, 0, 0, 0, 1],
                     "ate": 0.019168474539823153},
    "chunked_sync": {"kf_frames": list(range(5, 221, 5)),
                     "events": [[1, 23, 252], [13, 35, 259]],
                     "funnel": [18, 4, 2, 0, 0, 2],
                     "ate": 0.020055909667509947}}


class CritRecorder:
    """Wraps a ``KeyframeCriterion``'s ``update``: per decided frame its
    good flag, keyframe flag and the margin of its closest threshold (as
    ``decisions``). It changes nothing the criterion computes."""

    def __init__(self, crit, cfg):
        k = cfg.keyframe
        self.good, self.flags, self.margins = [], [], []
        orig = crit.update

        def update(DT, cov, good, T_from_kf):
            is_kf, ratio = orig(DT, cov, good, T_from_kf)
            T = np.asarray(T_from_kf, np.float64)
            t = float(np.linalg.norm(T[:3, 3]))
            r = float(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) * 0.5,
                                        -1, 1)))
            self.good.append(bool(good))
            self.flags.append(bool(is_kf))
            self.margins.append(min(
                abs(ratio - k.min_entropy_ratio) if np.isfinite(ratio)
                else math.inf, abs(t - k.max_kf_t_dist),
                abs(r - np.deg2rad(k.max_kf_r_dist))))
            return is_kf, ratio
        crit.update = update


def system_run(device, tag, n_frames, updates=None):
    """One [slam_system] run over loop_scene's first ``n_frames`` frames:
    ``PLSLAM`` a float pair at a time (the app's frames: uint8 / 255), or
    ``ChunkedPLSLAM`` initialized on the float first pair, then uint8
    chunks of 20 (the app's way); ``updates`` on loop_scene's config.
    Returns what the holds read."""
    import torch
    from plslam_tpu_torch.backend.chunk_backend import lba_slot_flags
    from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM, PLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    kind, async_mapping = {t: (k, a) for t, k, a in SYSTEM_RUNS}[tag]
    cfg, cam, seq, il, ir = LOOP_SCENE
    cfg = cfg.with_updates({"system": {"async_mapping": async_mapping}})
    if updates:
        cfg = cfg.with_updates(updates)
    per_frame = kind == "PLSLAM"
    slam = (PLSLAM if per_frame else ChunkedPLSLAM)(cfg, cam, device=device)
    rec = CritRecorder(slam.vo.kf_criterion if per_frame
                       else slam.kf_criterion, cfg)
    inv = np.float32(1.0) / np.float32(255.0)
    f32 = lambda a: a.astype(np.float32) * inv
    t0 = time.perf_counter()
    slam.initialize(f32(il[0]), f32(ir[0]))
    if per_frame:
        for i in range(1, n_frames):
            slam.process(f32(il[i]), f32(ir[i]))
    else:
        for lo in range(1, n_frames, CHUNK):
            slam.process_chunk(il[lo:lo + CHUNK], ir[lo:lo + CHUNK])
    est = slam.finish()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    recs = slam.map.summaries
    if per_frame:
        n_lba = len(recs) - 1          # every keyframe but the first
    else:
        kmax, stride = cfg.system.kf_batch, cfg.mapping.lba_kf_stride
        n_lba = sum(sum(lba_slot_flags([True] * len(r) + [False] * (
            kmax - len(r)), stride)) for r in slam.map._records
            if isinstance(r, list))
    lc = slam.loop_closer
    return dict(
        slam=slam, cfg=cfg, est=est, wall=wall, n_frames=n_frames,
        per_frame=per_frame, recs=recs, n_lba=n_lba,
        good=np.array(rec.good), margins=np.array(rec.margins),
        kf_frames=[i + 1 for i, f in enumerate(rec.flags) if f],
        events=[[e.kf_from, e.kf_to, e.n_inliers] for e in lc.events],
        funnel=[lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom,
                lc.n_rej_unc, lc.n_rej_corr, lc.n_loops_closed],
        ate=float(ate_rmse(est, seq.poses[:len(est)])))


def _loop_part(n, n_kfs, p: LoopProbe, n_closed) -> dict:
    """Add the loop closer's launches to ``n``: per probe (every keyframe,
    the first included) the BoW descent and histogram of each family; per
    verification D twice (ORB, LBD) and one optimize_pose (K13); per
    closure the landmark fusion (D twice); per dense solve one pg_edges,
    one pg_assemble and 12 pg_update; per PCG solve one pg_edges, one
    pg_blocks and 12 x (pg_pcg, pg_update); per post-closure update one
    window LBA (K15)."""
    g = lambda k: p.n.get(k, 0)
    for table, times in (
            ({"bow_descend": 2, "bow_hist": 2}, n_kfs),
            ({"hamming_scan": 2, "hamming_finish": 2, "pose_gn_optimize": 1},
             g("verify_loop_geometry")),
            ({"hamming_scan": 2, "hamming_finish": 2}, n_closed),
            (SOLVE_LAUNCHES["dense"], g("optimize_pose_graph")),
            (SOLVE_LAUNCHES["pcg"], g("optimize_pose_graph_pcg")),
            (PER_LBA, g("_post_loop_update"))):
        for k, v in table.items():
            n[k] += v * times
    return {k: v for k, v in n.items() if v}


def expected_system_launches(r, p: LoopProbe) -> dict:
    """A [slam_system] run's launches: per frame an extraction and (after
    the first) a tracked pair (``expected_frame_launches``), or per chunk
    an extraction and a chunk's tracking (the first pair extracted alone);
    every keyframe's insertion (``PER_KF``); each window LBA (the per-KF
    cadence: every keyframe but the first; the host-KF step: its slots by
    ``lba_kf_stride``); and the loop closer's (``_loop_part``). No kf_scan:
    these drivers decide keyframes on the host."""
    from collections import Counter
    n_frames = r["n_frames"]
    n_chunks = (n_frames - 1) // CHUNK
    if r["per_frame"]:
        n = Counter(expected_frame_launches(n_frames))
    else:
        n = Counter()
        for table, times in ((EXTRACT_POINTS, n_chunks + 1),
                             (EXTRACT_LINES, n_chunks + 1),
                             (TRACK, 2 * n_chunks), (GN, n_chunks)):
            for k, v in table.items():
                n[k] += v * times
    n_kfs = len(r["recs"])
    for table, times in ((PER_KF, n_kfs), (PER_LBA, r["n_lba"])):
        for k, v in table.items():
            n[k] += v * times
    return _loop_part(n, n_kfs, p, r["slam"].loop_closer.n_loops_closed)


def cpu_system_runs(tags) -> None:
    """The [slam_system] runs on the CPU: the SYSTEM_CPU values."""
    global LOOP_SCENE
    if LOOP_SCENE is None:
        LOOP_SCENE = loop_scene()
    for tag in tags:
        kind = {t: k for t, k, _ in SYSTEM_RUNS}[tag]
        t0 = time.perf_counter()
        r = system_run("cpu", tag, SYSTEM_PER_FRAME if kind == "PLSLAM"
                       else 1 + LOOP_CHUNKS * CHUNK)
        print(f"[cpu] {tag}: good={int(r['good'].sum())}/{len(r['good'])} "
              f"keyframes={len(r['recs'])} events {r['events']} smallest "
              f"decision margin {r['margins'].min():.6g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        print(f"[cpu] SYSTEM_CPU[{tag!r}] = " + json.dumps({
            k: r[k] for k in ("kf_frames", "events", "funnel", "ate")}),
            flush=True)


def slam_system_phase(dev) -> float:
    """[slam_system]: loop_scene (1241x376, the default SlamConfig(): lines
    and loops on) through PLSLAM sync and async (SYSTEM_PER_FRAME frames)
    and ChunkedPLSLAM sync and async (221 frames, chunks of 20), after a
    short async warm-up run of each driver (the LBA graphs captured on
    its mapping worker). Holds every frame tracked, no LBA
    raising its cost, exact launches, the keyframes, loop events and
    funnel of the CPU run (or a decision within THRESHOLD_MARGIN of its
    threshold) and the ATE bound; the host-KF async run (its probe
    flushes timed by the worker's queue) at least one closure and the sync
    CPU run's ATE bound. Prints fps and peak bytes. Returns the phase's
    seconds."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend import lba
    t_phase = time.perf_counter()
    # warm-ups, the LBA's CUDA graphs dropped first: each window shape is
    # captured anew on a mapping worker thread
    lba._GRAPHS.clear()
    for tag, n in (("plslam_async", 1 + CHUNK // 2),
                   ("chunked_async", 1 + 2 * CHUNK)):
        system_run(dev, tag, n)
    for tag, kind, async_mapping in SYSTEM_RUNS:
        n_frames = (SYSTEM_PER_FRAME if kind == "PLSLAM"
                    else 1 + LOOP_CHUNKS * CHUNK)
        probe = LoopProbe()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        native.reset_counts()
        try:
            r = system_run(dev, tag, n_frames)
        finally:
            probe.close()
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        lba = [(s.lba_cost0, s.lba_cost1) for s in r["recs"]
               if s.lba_cost0 != 0.0]
        near = min(r["margins"].min(), probe.margin, probe.gap)
        print(f"[{tag}] frames={n_frames} good={int(r['good'].sum())}/"
              f"{len(r['good'])} keyframes={len(r['recs'])} (frames "
              f"{r['kf_frames']}) lba_runs={r['n_lba']} ate_m="
              f"{r['ate']:.6f} events={r['events']} funnel (candidates, "
              f"votes, rejected geometry, uncertainty, correction, closed)="
              f"{r['funnel']}", flush=True)
        print(f"[{tag}] fps={n_frames / r['wall']:.2f} ms_per_frame="
              f"{1e3 * r['wall'] / n_frames:.3f} (host clock, initialize + "
              f"{n_frames - 1} frames + finish, ends in synchronize; timed "
              f"loop steps synchronize) max_memory_allocated_bytes={peak}; "
              f"smallest decision margin {near:.6g}", flush=True)
        want = expected_system_launches(r, probe)
        print(f"[{tag}] launches={json.dumps(launches, sort_keys=True)}; "
              f"{probe.hold_solves(dev)} pose-graph solve(s) bit-equal to "
              "the loop that assembles and solves every GN step", flush=True)
        check(bool(r["good"].all()) and len(r["good"]) == n_frames - 1,
              f"{tag}: frames not tracked: {np.nonzero(~r['good'])[0]}")
        check(len(lba) == r["n_lba"] >= 1, f"{tag}: {r['n_lba']} window "
              f"LBAs, {len(lba)} with costs")
        check(all(c1 <= c0 for c0, c1 in lba), f"{tag}: an LBA raised its "
              "cost")
        check(launches == want, f"{tag}: launches {launches} differ from "
              f"the run's {want}")
        if tag == "chunked_async":
            cpu = SYSTEM_CPU.get("chunked_sync")
            check(r["funnel"][5] >= 1, f"{tag}: no loop closed")
        else:
            cpu = SYSTEM_CPU.get(tag)
            check(cpu is not None, f"{tag}: no CPU record of this run in "
                  "SYSTEM_CPU (python3 chip_smoke.py --cpu-ate slam_system)")
            same = all(r[k] == cpu[k] for k in ("kf_frames", "events",
                                                "funnel"))
            print(f"[{tag}] CPU run: keyframes {len(cpu['kf_frames'])}, "
                  f"events {cpu['events']}, funnel {cpu['funnel']}, ATE "
                  f"{cpu['ate']}; identical: {same}", flush=True)
            check(same or near < THRESHOLD_MARGIN,
                  f"{tag}: keyframes, events or funnel differ from the CPU "
                  f"run with the smallest margin {near}")
        bound_m = 2 * cpu["ate"] + 0.02
        check(math.isfinite(r["ate"]) and r["ate"] < bound_m,
              f"{tag}: ATE {r['ate']} m outside its bound {bound_m} m")
        del r
    return time.perf_counter() - t_phase


# the largest distance (m) of a keyframe position between the staged
# closure (PLSLAM_LC_DEBUG) and the fused one
LC_DEBUG_M = 1e-3


def lc_debug_rerun(dev) -> None:
    """[slam_system]'s PLSLAM sync over SYSTEM_PER_FRAME frames with the
    graph solve at every closure (SOLVE_ALWAYS, so a closure takes
    _close_loop's correction branch), then again with PLSLAM_LC_DEBUG=1
    (the staged correction, ``LoopCloser._close_staged``): the staged
    branch ran, and the events and funnel are the same, the keyframe poses
    within LC_DEBUG_M. It runs after the dataset phase, the last to read
    torch.profiler in this process: run before it, its two PLSLAM runs'
    launches made the profiler lose that phase's device records."""
    import os
    from plslam_tpu_torch.loop.loop_closer import LoopCloser
    runs, staged = [], []
    orig = LoopCloser._close_staged

    def count(self, *a):
        staged.append(a[2:4])
        return orig(self, *a)

    LoopCloser._close_staged = count
    try:
        for debug in (False, True):
            if debug:
                os.environ["PLSLAM_LC_DEBUG"] = "1"
            try:
                r = system_run(dev, "plslam_sync", SYSTEM_PER_FRAME,
                               SOLVE_ALWAYS)
            finally:
                os.environ.pop("PLSLAM_LC_DEBUG", None)
            runs.append((r["events"], r["funnel"], r["slam"].map.kf_poses()))
            del r
    finally:
        LoopCloser._close_staged = orig
    (ev0, fu0, kp0), (ev1, fu1, kp1) = runs
    d = (float(np.abs(kp0[:, :3, 3] - kp1[:, :3, 3]).max())
         if kp0.shape == kp1.shape else math.inf)
    print(f"[slam_system] PLSLAM_LC_DEBUG rerun (plslam_sync, graph solve "
          f"at every closure): staged closures {staged}; events {ev1} "
          f"(without it {ev0}), funnel {fu1} ({fu0}); keyframe positions "
          f"{d:.3g} m apart", flush=True)
    check(len(staged) >= 1, "PLSLAM_LC_DEBUG: no closure took the staged "
          "branch")
    check(ev0 == ev1 and fu0 == fu1 and d <= LC_DEBUG_M,
          f"PLSLAM_LC_DEBUG: the staged run differs: events {ev1} vs {ev0}, "
          f"funnel {fu1} vs {fu0}, keyframes {d} m")


def multiseq_phase(dev) -> float:
    """[multiseq]: run_concurrent over two sessions on two scenes this
    script renders (loop_scene and the main paths' scene, their first 41
    frames as uint8): FusedPLSLAM with the default SlamConfig(), then
    ChunkedPLSLAM with loops off (two mapping workers; the LBA's CUDA graphs
    are captured anew during that run, on a worker thread). Each session's
    trajectory equals the same session run alone, bit for bit. Returns the
    phase's seconds."""
    from types import SimpleNamespace
    import torch
    from plslam_tpu_torch.apps.plslam_multiseq import run_concurrent
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    t_phase = time.perf_counter()
    cfg, cam, seq_loop, il, ir = LOOP_SCENE
    _, _, seq_main = main_scene(lines=True)
    n = len(seq_main.poses)
    scenes = [SimpleNamespace(images_l=il[:n], images_r=ir[:n],
                              poses=seq_loop.poses[:n]),
              SimpleNamespace(images_l=to_u8(seq_main.images_l),
                              images_r=to_u8(seq_main.images_r),
                              poses=seq_main.poses)]
    for tag, make in (
            ("fused", lambda: FusedPLSLAM(cfg, cam)),
            ("chunked", lambda: ChunkedPLSLAM(
                cfg.with_updates({"loop": {"enabled": False}}), cam))):
        if tag == "chunked":
            # the LBA graphs dropped: a mapping worker captures the first
            # window LBA while the other session's tracker runs
            lba._GRAPHS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        both = run_concurrent([make(), make()], scenes, CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        alone = [run_concurrent([make()], [s], CHUNK)[0] for s in scenes]
        d = [float(np.abs(a - b).max()) for a, b in zip(both, alone)]
        ate = [float(ate_rmse(t, s.poses[:len(t)]))
               for t, s in zip(both, scenes)]
        print(f"[multiseq] {tag}: 2 sessions x {n} frames, {2 * n / wall:.2f} "
              f"fps together (host clock, ends in synchronize); ATE "
              f"{[round(a, 6) for a in ate]}; each against the session run "
              f"alone: {d}", flush=True)
        check(all(len(t) == n for t in both) and d == [0.0, 0.0],
              f"multiseq {tag}: a session differs from its run alone by {d}")
    return time.perf_counter() - t_phase


# [knob_band]: tests/test_knob_parity.py's scene and variants (:29-53) on
# the card: 501 frames at 384x240, seed 13, kind "loop", 600 points, noise
# 0.004, step 0.05, uint8 frames in chunks of 20 (the port's io/synthetic.py
# renders the reference's frames bit for bit: checked once on the CPU; the
# hash of the left then the right uint8 stack)
KNOB_N = 501
KNOB_SHA256 = ("01e1704f16de1208cf1b2cdc5c13e2f3"
               "c59ec71c2294ee5be0c4ac07a4c10738")
KNOB_BASE = {
    "camera": {"width": 384, "height": 240, "fx": 300.0, "fy": 300.0,
               "cx": 192.0, "cy": 120.0, "baseline": 0.25},
    "points": {"max_kpts": 256, "orb_nlevels": 2},
    "lines": {"has_lines": False},
    "matching": {"f2f_window": 96.0},
    "mapping": {"max_kfs": 128, "max_points": 8192, "max_lines": 128,
                "window_kfs": 5, "fixed_kfs": 3, "lba_iters": 5,
                "lba_max_points": 2048, "lba_max_lines": 64},
    "loop": {"enabled": True, "min_kf_separation": 15,
             "consistency_window": 2, "lc_inl": 15,
             "lc_trs": 3.0, "lc_rot": 60.0},
    "system": {"kf_batch": 4},
}
KNOB_VARIANTS = {
    "baseline": {},
    "stride1": {"mapping": {"lba_kf_stride": 1}},
    "stride5": {"mapping": {"lba_kf_stride": 5}},
    "no_lite": {"tracking": {"lite_pass_iters": 0}},
    "kf_batch2": {"system": {"kf_batch": 2}},
    "kf_batch8": {"system": {"kf_batch": 8}},
}
# the JAX package's own run of the test's _child_main on a CPU (JAX_PLATFORMS
# =cpu, 8 host devices): (ATE m, loops, keyframes) a variant. CPU figures of
# the reference, not the card's.
KNOB_JAX_CPU = {"baseline": (0.150916, 2, 62), "stride1": (0.146405, 2, 62),
                "stride5": (0.150950, 2, 62), "no_lite": (0.151032, 2, 62),
                "kf_batch2": (0.160231, 1, 51),
                "kf_batch8": (0.150916, 2, 62)}


def render_knob(path: str) -> None:
    """The knob scene's uint8 frames, (2, KNOB_N, 240, 384), to ``path``
    (.npy): run in a process of its own while the card works."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cam = StereoCamera.from_config(SlamConfig().with_updates(
        KNOB_BASE).camera)
    seq = synthetic.make_sequence(cam, n_frames=KNOB_N, seed=13, kind="loop",
                                  n_points=600, n_lines=0, noise=0.004,
                                  step=0.05)
    np.save(path + ".tmp.npy", np.stack([to_u8(seq.images_l),
                                         to_u8(seq.images_r)]))
    np.save(path + ".poses.npy", np.asarray(seq.poses))
    import os
    os.replace(path + ".tmp.npy", path)


def start_knob_render():
    """Start render_knob in a spawned process; returns (process, path)."""
    import multiprocessing
    import os
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="knob_"), "frames.npy")
    proc = multiprocessing.get_context("spawn").Process(
        target=render_knob, args=(path,), daemon=True)
    proc.start()
    return proc, path


def knob_band_phase(dev, render) -> float:
    """[knob_band]: the six variants through the port's FusedPLSLAM on the
    card, held to tests/test_knob_parity.py's own assertions (:107-138),
    and the baseline within the band around the JAX package's CPU
    baseline (KNOB_JAX_CPU) with its loop count. Returns the phase's
    seconds."""
    import hashlib
    import os
    import shutil
    import torch
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    t_phase = time.perf_counter()
    proc, path = render
    proc.join(timeout=900)
    check(proc.exitcode == 0 and os.path.exists(path),
          f"knob_band: the render process ended with {proc.exitcode}")
    frames = np.load(path)
    gt = np.load(path + ".poses.npy")
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    il, ir = frames[0], frames[1]
    h = hashlib.sha256()
    h.update(il.tobytes())
    h.update(ir.tobytes())
    check(h.hexdigest() == KNOB_SHA256, f"knob_band: the frames' hash "
          f"{h.hexdigest()} is not the reference frames' {KNOB_SHA256}")
    base = SlamConfig().with_updates(KNOB_BASE)
    cam = StereoCamera.from_config(base.camera)
    stats = {}
    for name, upd in KNOB_VARIANTS.items():
        cfg = base.with_updates(upd) if upd else base
        slam = FusedPLSLAM(cfg, cam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam.initialize(il[0], ir[0])
        for lo in range(1, KNOB_N, CHUNK):
            slam.process_chunk(il[lo:lo + CHUNK], ir[lo:lo + CHUNK])
        est = slam.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats[name] = {"ate": float(ate_rmse(est, gt[:len(est)])),
                       "loops": slam.loop_closer.n_loops_closed,
                       "kfs": slam._kf_slot + 1,
                       "fps": round((KNOB_N - 1) / wall, 2)}
        slam.close()
        del slam
    print("[knob_band] KNOB_STATS " + json.dumps(stats), flush=True)
    b = stats["baseline"]
    jax_ate, jax_loops, _ = KNOB_JAX_CPU["baseline"]
    jax_band = max(1.15 * jax_ate, jax_ate + 0.01)
    band = max(1.15 * b["ate"], b["ate"] + 0.01)
    print(f"[knob_band] baseline ATE {b['ate']:.6f} m, {b['loops']} loops, "
          f"{b['kfs']} KFs (the JAX package on a CPU: {KNOB_JAX_CPU}; its "
          f"band {jax_band:.6f} m); the variants' band {band:.6f} m",
          flush=True)
    check(b["loops"] >= 1 and b["ate"] < 0.30, f"knob_band: baseline {b}")
    check(b["ate"] < jax_band and b["loops"] == jax_loops,
          f"knob_band: the baseline {b} is outside the band {jax_band} m "
          f"around the JAX package's, or closes other than {jax_loops} loops")
    for name, v in stats.items():
        if name == "baseline":
            continue
        check(v["ate"] < band, f"knob_band: {name} ATE {v['ate']} outside "
              f"the baseline's band {band}")
        if name == "kf_batch2":
            check(v["loops"] >= 1 and v["kfs"] <= b["kfs"],
                  f"knob_band: {name} {v}")
            continue
        check(v["loops"] == b["loops"], f"knob_band: {name} closes "
              f"{v['loops']} loops, the baseline {b['loops']}")
        check(abs(v["kfs"] - b["kfs"]) <= max(2, b["kfs"] // 20),
              f"knob_band: {name} {v['kfs']} keyframes, the baseline "
              f"{b['kfs']}")
    return time.perf_counter() - t_phase


# -- slice 22: lines-only VO, scan mode -------------------------------------

# SlamConfig() updates: the lines-only configuration and scan mode
LINES_ONLY = {"points": {"has_points": False}}
SCAN = {"tracking": {"batched_chunks": False}}
# frames of [lines_only]'s per-frame run (10 tracked pairs)
LINES_ONLY_FRAMES = 11
# The [lines_only] and [scan] runs' CPU record (``python3 chip_smoke.py
# --cpu-ate lines_only scan``: the port's plain versions, device="cpu", the
# same frames): each run's untracked frames and its ATE. A run without its
# record fails. On bench.py's scene (``chunk``, the app's) the 500 point
# patches leave 10-21 stereo lines a frame and 4-8 line inliers, below the
# pose gate's min_features 12: no frame tracks there, on the CPU as on the
# card. Lines-only tracking runs on the lines scene (``lines_scene``).
LINES_ONLY_CPU = {"chunk": {"bad": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39], "ate": 2.9665989115070417}, "lines_chunk": {"bad": [], "ate": 0.04301205457784803}, "lines_frame": {"bad": [], "ate": 0.009258958394456663}, "app_chunk": {"bad": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39], "ate": 2.9665989115070417}, "app_frame": {"bad": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39], "ate": 2.9665989115070417}}
SCAN_CPU = {"lines": {"bad": [], "ate": 0.014731720530925203}, "lines_only": {"bad": [], "ate": 0.013192395387722242}}


@functools.lru_cache(maxsize=None)
def lines_scene():
    """The lines-only runs' scene at 1241x376, 1 + 2 x 20 frames: bench.py's
    seed and noise with no point patches, 200 lines and 0.12 m a frame
    (tests/test_lines_frontend.py's step), 33-55 stereo lines a frame
    (with 60 lines or at 0.25 m a frame too few pass the pose gate to
    track); rendered once a process, ~5 s on the host."""
    from plslam_tpu_torch.io import synthetic
    _, cam, _ = main_scene(lines=True)
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cam, n_frames=2 * CHUNK + 1, seed=0,
                                  n_points=0, n_lines=200, noise=0.003,
                                  step=0.12)
    print(f"[lines_only] rendered the lines scene ({2 * CHUNK + 1} frames) "
          f"in {time.perf_counter() - t0:.1f} s (host)", flush=True)
    return seq


def flagship(*updates):
    """SlamConfig() with ``updates`` applied in order."""
    from plslam_tpu_torch.config import SlamConfig
    cfg = SlamConfig()
    for u in updates:
        cfg = cfg.with_updates(u)
    return cfg


def chunked_vo(device, cfg, cam, il, ir, n_chunks):
    """``BatchedStereoVO`` over initialize + ``n_chunks`` chunks of 20 of
    the frames (device tensors, or host arrays): the trajectory, ``good``,
    the launches, the host seconds (ending in a synchronize on the card),
    the peak device bytes, and the stereo lines and line inliers a
    frame."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    cuda = torch.device(device).type == "cuda"
    vo = BatchedStereoVO(cfg, cam, device=device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    t0 = time.perf_counter()
    vo.initialize(il[0], ir[0])
    outs = [vo.submit_chunk(il[lo:lo + CHUNK], ir[lo:lo + CHUNK])
            for lo in range(1, 1 + n_chunks * CHUNK, CHUNK)]
    vo.drain()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, n_lines, n_li = run_counts(outs)
    return dict(est=np.stack(vo.trajectory), launches=dict(native.LAUNCHES),
                good=torch.cat([o.good for o in outs]).cpu().numpy(),
                wall=wall, n_lines=n_lines, n_line_inl=n_li,
                peak=torch.cuda.max_memory_allocated() if cuda else 0)


def cpu_record(r, poses):
    """A run's record: its untracked frames and its ATE."""
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    return dict(bad=np.nonzero(~r["good"])[0].tolist(),
                ate=float(ate_rmse(r["est"], poses[:len(r["est"])])))


def hold_cpu(tag, r, poses, cpu):
    """A card run against its CPU record: the same untracked frames, ATE
    <= 2 x CPU + 2 cm."""
    check(cpu is not None, f"{tag}: no CPU record (python3 chip_smoke.py "
          "--cpu-ate lines_only scan)")
    got = cpu_record(r, poses)
    bound_m = 2 * cpu["ate"] + 0.02
    print(f"[{tag}] frames={len(r['good'])} good={int(r['good'].sum())} "
          f"ate_m={got['ate']:.6f} (bound {bound_m:.6f}; CPU run "
          f"{cpu['ate']:.6f}); untracked {got['bad']} (CPU {cpu['bad']})",
          flush=True)
    check(got["bad"] == cpu["bad"], f"{tag}: untracked frames "
          f"{got['bad']}, the CPU run's {cpu['bad']}")
    check(math.isfinite(got["ate"]) and got["ate"] < bound_m,
          f"{tag}: ATE {got['ate']} m outside its bound {bound_m} m")


def cpu_vo_runs(parts) -> dict:
    """[lines_only] and [scan] on the CPU: prints and returns the
    LINES_ONLY_CPU and SCAN_CPU records (``parts``: lines_only, scan)."""
    import os
    import tempfile
    _, cam, seq = main_scene(lines=True)
    ln = lines_scene()
    t0 = time.perf_counter()
    out = {}
    if "lines_only" in parts:
        cfg = flagship(LINES_ONLY)
        runs = {"chunk": chunked_vo("cpu", cfg, cam, seq.images_l,
                                    seq.images_r, 2),
                "lines_chunk": chunked_vo("cpu", cfg, cam, ln.images_l,
                                          ln.images_r, 2),
                "lines_frame": euroc_vo(
                    "cpu", lambda i: (ln.images_l[i], ln.images_r[i]), cam,
                    cfg, LINES_ONLY_FRAMES)}
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "kitti")
            write_kitti(root, seq)
            runs.update(kitti_app_runs("cpu", root, ["--no-points"], "app"))
        out["LINES_ONLY_CPU"] = {
            k: cpu_record(r, (ln if k.startswith("lines") else seq).poses)
            for k, r in runs.items()}
    if "scan" in parts:
        runs = {"lines": chunked_vo("cpu", flagship(SCAN), cam, seq.images_l,
                                    seq.images_r, 2),
                "lines_only": chunked_vo("cpu", flagship(SCAN, LINES_ONLY),
                                         cam, ln.images_l, ln.images_r, 1)}
        out["SCAN_CPU"] = {k: cpu_record(r, (ln if k == "lines_only"
                                             else seq).poses)
                           for k, r in runs.items()}
    for name, rec in out.items():
        print(f"[cpu] {name} = {json.dumps(rec)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def lines_only_phase(dev) -> float:
    """[lines_only]: ``BatchedStereoVO`` with SlamConfig()'s lines-only
    configuration at 1241x376 (no point kernel A-C, no point match:
    ``expected_launches``): over the main paths' frames (bench.py's scene),
    then over the lines scene after a warm-up chunk, initialize + 2 chunks
    of 20 each; the per-frame ``StereoVO`` with the line extractor over the
    lines scene's first 11 frames; each held to its CPU run (the app's
    ``--no-points`` runs in the dataset phase). Returns the phase's
    seconds."""
    import torch
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    t_phase = time.perf_counter()
    _, cam, seq = main_scene(lines=True)
    ln = lines_scene()
    cfg = flagship(LINES_ONLY)
    for tag, sc in (("chunk", seq), ("lines_chunk", ln)):
        il = torch.from_numpy(sc.images_l).to(dev)
        ir = torch.from_numpy(sc.images_r).to(dev)
        if tag == "lines_chunk":
            warm = BatchedStereoVO(cfg, cam)
            warm.initialize(il[0], ir[0])
            warm.process_chunk(il[1:1 + CHUNK], ir[1:1 + CHUNK])
        r = chunked_vo(dev, cfg, cam, il, ir, 2)
        n = 2 * CHUNK
        print(f"[lines_only {tag}] fps={n / r['wall']:.2f} ms_per_frame="
              f"{1e3 * r['wall'] / n:.3f} (host clock, initialize + 2 "
              f"chunks, ends in synchronize) max_memory_allocated_bytes="
              f"{r['peak']}; stereo lines per frame min/median="
              f"{int(r['n_lines'].min())}/{float(np.median(r['n_lines']))}"
              f", line inliers min/median={int(r['n_line_inl'].min())}/"
              f"{float(np.median(r['n_line_inl']))}; launches="
              f"{json.dumps(r['launches'], sort_keys=True)}", flush=True)
        hold_cpu(f"lines_only {tag}", r, sc.poses, LINES_ONLY_CPU[tag])
        check(tag == "chunk" or int(r["good"].sum()) >= 0.75 * n,
              f"lines_only {tag}: {int(r['good'].sum())} of {n} frames "
              "tracked on the lines scene")
        want = expected_launches(True, points=False)
        check(r["launches"] == want, f"lines_only {tag}: launches "
              f"{r['launches']} differ from the path's {want}")
    f = euroc_vo(dev.type, lambda i: (ln.images_l[i], ln.images_r[i]),
                 cam, cfg, LINES_ONLY_FRAMES)
    print(f"[lines_only lines_frame] {f['ms']:.2f} ms a frame (host clock, "
          f"{LINES_ONLY_FRAMES} frames, the first's extraction included)",
          flush=True)
    hold_cpu("lines_only lines_frame", f, ln.poses,
             LINES_ONLY_CPU["lines_frame"])
    want = expected_frame_launches(LINES_ONLY_FRAMES, points=False)
    check(f["launches"] == want, f"lines_only per frame: launches "
          f"{f['launches']} differ from the path's {want}")
    return time.perf_counter() - t_phase


def scan_phase(dev) -> float:
    """[scan]: scan mode (``tracking.batched_chunks=False``) at 1241x376:
    point+line over the main paths' frames, initialize + 2 chunks of 20,
    and lines-only over the lines scene, initialize + 1 chunk, each after a
    warm-up chunk, held to its CPU run and to ``expected_launches``' scan
    form (20 K13 launches at B = 1 a chunk); the point+line run within 5 mm
    of the batched run on the same frames (the reference's own bound
    between per-frame and chunked tracking, tests/test_batch_vo.py:117).
    Then a chunk's device time in each mode (``chunk_device_times``).
    Returns the phase's seconds."""
    import os
    import torch
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    t_phase = time.perf_counter()
    _, cam, seq = main_scene(lines=True)
    on_card = lambda sc: (torch.from_numpy(sc.images_l).to(dev),
                          torch.from_numpy(sc.images_r).to(dev))
    frames = {"main": (seq, *on_card(seq))}
    ln = lines_scene()
    frames["lines"] = (ln, *on_card(ln))
    _, il, ir = frames["main"]
    batched = chunked_vo(dev, flagship(), cam, il, ir, 2)
    for tag, upd, n_chunks, scene in (("lines", {}, 2, "main"),
                                      ("lines_only", LINES_ONLY, 1,
                                       "lines")):
        sc, il, ir = frames[scene]
        cfg = flagship(SCAN, upd)
        warm = BatchedStereoVO(cfg, cam)
        warm.initialize(il[0], ir[0])
        warm.process_chunk(il[1:1 + CHUNK], ir[1:1 + CHUNK])
        r = chunked_vo(dev, cfg, cam, il, ir, n_chunks)
        n = n_chunks * CHUNK
        print(f"[scan] {tag}: fps={n / r['wall']:.2f} ms_per_frame="
              f"{1e3 * r['wall'] / n:.3f} (host clock, initialize + "
              f"{n_chunks} chunk(s), ends in synchronize) "
              f"max_memory_allocated_bytes={r['peak']}; launches="
              f"{json.dumps(r['launches'], sort_keys=True)}", flush=True)
        hold_cpu(f"scan {tag}", r, sc.poses, SCAN_CPU[tag])
        want = expected_launches(True, points=not upd, scan=True,
                                 chunks=n_chunks)
        check(r["launches"] == want, f"scan {tag}: launches "
              f"{r['launches']} differ from the path's {want}")
        if tag == "lines":
            d = float(np.linalg.norm(r["est"][:, :3, 3]
                                     - batched["est"][:, :3, 3],
                                     axis=1).max())
            print(f"[scan] lines: positions within {d:.3g} m of the batched"
                  f" run on the same frames (bound {CHUNK_VS_FRAME_M})",
                  flush=True)
            check(d < CHUNK_VS_FRAME_M, f"scan vs batched: {d} m")

    # a chunk's device time by mode, in a process of its own (the
    # profiler keeps fewer records late in a long process)
    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         "--chunk-device-times"], cwd=here, capture_output=True, text=True,
        check=True, timeout=600).stdout.strip(), flush=True)
    return time.perf_counter() - t_phase


def chunk_device_times() -> None:
    """``python3 chip_smoke.py --chunk-device-times``: the device time of
    one chunk of 20 of bench.py's frames in each configuration and mode
    (``vo_chunk`` from the first frame's features: every device kernel,
    the hand kernels, K13's; and the front end, ``extract_stereo_frame``
    of the chunk, alone). ``scan_phase`` runs it in a process of its own."""
    import torch
    from plslam_tpu_torch.frontend.stereo_frame import extract_stereo_frame
    from plslam_tpu_torch.tracking.batch_vo import extract_one, vo_chunk
    dev = torch.device("cuda", 0)
    _, cam, seq = main_scene(lines=True)
    il = torch.from_numpy(seq.images_l).to(dev)
    ir = torch.from_numpy(seq.images_r).to(dev)
    f32 = lambda x: x[1:1 + CHUNK].to(torch.float32)
    for tag, cfg in (("batched", flagship()),
                     ("batched lines_only", flagship(LINES_ONLY)),
                     ("scan", flagship(SCAN)),
                     ("scan lines_only", flagship(SCAN, LINES_ONLY))):
        p0, l0 = extract_one(il[0], ir[0], cam, cfg)
        T0 = torch.eye(4, device=dev)
        chunk = lambda: vo_chunk(il[1:1 + CHUNK], ir[1:1 + CHUNK], p0, l0,
                                 T0, cam, cfg)
        all_ms, n_k = all_kernels(chunk, iters=5)
        own = device_ms(chunk, iters=5)
        gn_ms, n_gn = profile_device(
            chunk, lambda k: "pose_optimize_kernel" in k, 5)
        fe_ms, _ = all_kernels(lambda: extract_stereo_frame(
            f32(il), f32(ir), cam, cfg), iters=5)
        print(f"[scan] device ms a chunk of {CHUNK}, {tag}: all "
              f"{all_ms:.4f} ({n_k} device kernels), hand kernels "
              f"{own:.4f}, K13 {gn_ms:.4f} ({n_gn} launches), front end "
              f"{fe_ms:.4f} (torch.profiler)", flush=True)


def bench_slam_scene(devices) -> None:
    """bench_slam.py's own scene (201 frames, seed 0, loop, 400 points, 60
    lines, noise 0.004, step 0.15, uint8 frames in chunks of 20) through
    ``FusedPLSLAM(SlamConfig())`` (loops on) on each of ``devices`` ("cuda",
    "cpu": the plain versions): keyframes and their frames, loops, the
    funnel, the ATE and the smallest keyframe-decision margin; with two
    devices, the first keyframe decision that differs and its margin in
    each run. Not a phase of ``main``:
    ``python3 chip_smoke.py --bench-slam cuda cpu``."""
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    n_chunks = 10
    seq = synthetic.make_sequence(cam, n_frames=1 + n_chunks * CHUNK, seed=0,
                                  kind="loop", n_points=400, n_lines=60,
                                  noise=0.004, step=0.15)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    il, ir = u8(np.asarray(seq.images_l)), u8(np.asarray(seq.images_r))
    runs = {}
    for device in devices:
        slam = FusedPLSLAM(cfg, cam, device=device)
        t0 = time.perf_counter()
        est = drive_slam(slam, il, ir, None, n_chunks)
        kf_frames, events, funnel, good, margin = loop_summary(slam, cfg)
        ate = float(ate_rmse(est, seq.poses[:len(est)]))
        runs[device] = (np.asarray(kf_frames), margin)
        print(f"[bench_slam] {device}: good={int(good.sum())}/{len(good)} "
              f"keyframes={len(slam.summaries)} kf_frames={kf_frames} "
              f"loops={len(events)} events={events} funnel={funnel} "
              f"ate_m={ate!r} smallest keyframe-decision margin "
              f"{margin.min():.6g} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if len(runs) == 2:
        (fa, ma), (fb, mb) = runs.values()
        n = len(ma)
        flags = [np.isin(np.arange(n), f) for f in (fa, fb)]
        differ = np.nonzero(flags[0] != flags[1])[0]
        if differ.size:
            i = int(differ[0])
            print(f"[bench_slam] first keyframe decision that differs: frame "
                  f"{i}, margins {ma[i]:.6g} ({devices[0]}) and {mb[i]:.6g} "
                  f"({devices[1]})", flush=True)
        else:
            print("[bench_slam] identical keyframe decisions", flush=True)


def _orb_after_filters_before(orb, image, levels, uv, octave):
    """What a tree without ``orient_and_describe`` ran in
    describe_multilevel after its moment filters: the levels
    concatenated, the torch glue of the orientation, the bins and the
    centres, and its pool_bits launch. Returns the call; the moment maps
    are made here, outside it."""
    import torch
    N, dev = uv.shape[0], uv.device
    n_lvl = len(levels)
    full = [tuple(lv.shape[-2:]) for lv in levels]
    halves = [image.resize_bilinear(lv, (h // 2, w // 2))
              for lv, (h, w) in zip(levels, full)]
    half = [tuple(x.shape[-2:]) for x in halves]
    hb = orb._bases(half)
    m10 = torch.empty((N, sum(h * w for h, w in half)), device=dev)
    m01 = torch.empty_like(m10)
    for x, b, (hh, hw) in zip(halves, hb, half):
        image.separable_filter2d_pair(x, orb._d_h, orb._ONES_H, orb._ONES_H,
                                      orb._d_h, m10[:, b:b + hh * hw],
                                      m01[:, b:b + hh * hw])

    def fn():
        flat = torch.cat([lv.reshape(N, -1) for lv in levels], dim=1)
        tab = lambda v: orb._on(np.asarray(v, np.int32), dev)
        o = torch.clamp(octave, 0, n_lvl - 1).long()
        fW, fH = tab([s[1] for s in full])[o], tab([s[0] for s in full])[o]
        fB = tab(orb._bases(full))[o]
        hW, hH = tab([s[1] for s in half])[o], tab([s[0] for s in half])[o]
        hB = tab(hb)[o]
        u2 = torch.minimum(torch.clamp(torch.round(uv[..., 0] * 0.5).to(
            torch.int32), min=0), hW - 1)
        v2 = torch.minimum(torch.clamp(torch.round(uv[..., 1] * 0.5).to(
            torch.int32), min=0), hH - 1)
        hidx = (hB + v2 * hW + u2).long()
        theta = torch.atan2(torch.gather(m01, 1, hidx),
                            torch.gather(m10, 1, hidx))
        u = torch.minimum(torch.clamp(torch.round(uv[..., 0]).to(
            torch.int32), min=15), fW - 16)
        v = torch.minimum(torch.clamp(torch.round(uv[..., 1]).to(
            torch.int32), min=15), fH - 16)
        center = (fB + v * fW + u).to(torch.int32)
        bits = orb.pool_bits(flat, center, fW.to(torch.int32).contiguous(),
                             orb.angle_bins(theta).contiguous())
        return [bits, theta]
    return fn


def k15_bits(dev, cfg, cam, lam) -> dict:
    """K15's single-device launches for ``--against``'s bit comparison, on
    the plain terms and blocks of ``lba_window_problem`` and of its K = 256
    cut (a shard's point slots at 4 shards): ``lba_camera``, ``lba_solve``
    capped and not, and ``run_lba`` twice (the process's first call
    eager, then its CUDA graph's replay). Returns
    {"out": {name: outputs on the host}, "launches": the launches made}."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend import lba
    out = {}
    native.reset_counts()
    for K in (None, 256):
        prob = lba_window_problem(dev, cfg, cam, K=K)
        free = lba._free(prob)
        t, sigma, _ = lba.lba_terms_sigma_plain(prob, cam)
        b = lba.lba_blocks_plain(t, prob, sigma, free, lam)
        idx = lba.lba_index(prob)
        tag = f"K={K or cfg.points.max_kpts}"
        out[f"{tag} lba_camera"] = lba.lba_camera(t, sigma, free)
        for cap in (True, False):
            out[f"{tag} lba_solve cap={cap}"] = lba.lba_solve(
                b, prob, free, lam, idx, cap=cap)
        for run in ("eager", "replay"):
            out[f"{tag} run_lba {run}"] = tuple(lba.run_lba(prob, cam, cfg))
    torch.cuda.synchronize()
    return {"out": {k: [x.cpu() for x in v] for k, v in out.items()},
            "launches": dict(native.LAUNCHES)}


def _use_tree(root: str) -> None:
    """Import plslam_tpu_torch from the checkout at ``root`` from here on:
    the package this script imported at its start (the profiler helpers
    and the card's rates) is dropped from ``sys.modules``, so no module of
    this tree stands in for the other tree's."""
    sys.path.insert(0, root)
    for m in [m for m in sys.modules if m == "plslam_tpu_torch"
              or m.startswith("plslam_tpu_torch.")]:
        del sys.modules[m]


def against_side(root: str, out_path: str, desc_path: str) -> None:
    """One process of ``--against``: on 40 seeded 376x1241 images, through
    the plslam_tpu_torch of the checkout at ``root`` (its kernels built
    there): the level-0 blur, ORB's moment pair at 188x620 (a tree without
    the paired filter runs two single filters), fast_score on level 0 (its
    input the plain blur), image_resize at the pyramid's and the
    half-resolution shapes, the LBA's terms, scale and cost, its camera
    blocks (``lba_camera``, with their distances from float64), its step
    after the blocks (``lba_solve``, or a parent's ``lba_schur``, library
    solve and ``lba_backsub``) and the whole ``run_lba`` on
    ``lba_window_problem``, the sharded step's ``lba_schur_corr`` and
    ``lba_solve_reduced`` on shard 0 of 4 (``dist_plain_inputs``) and the
    sharded LM's host clock (LM_HOST_CALLS warm calls at each of
    DIST_SHARDS), the GN phase (8 iterations) and the whole
    optimize_pose at 20 x (1024 points, 128 lines) (``gn_inputs``) and
    at phase 3's other whole-call shapes (points only, lite, one pair,
    lines only at 20 pairs and one), the
    NMS block max at level 0, K5 (the whole ``describe_multilevel`` on
    the pyramid of the 40 images at 1,024 seeded keypoints an image, and
    what it runs after its moment filters: ``orient_and_describe``, or a
    parent's torch glue and ``pool_bits``), kernel E on the line scene's
    40 images at full and half resolution (``tile_moments``, or a parent's
    four-step chain, ``tile_moments_chain``: the maps' bits equal), K9 on
    the same images (the whole ``tile_stage``, and its
    gates and labels alone: ``gates_and_labels``, or a parent's
    ``tile_gates`` + ``propagate_labels``), kernel G (``refit_roots`` on
    the TileStage of the line scene's 40 images through kernels E and F,
    and
    ``merge_segments`` on candidates of the plain refit on the CPU, at full
    and half resolution), K16's medoid rows at 8192 and 1024 landmarks
    (``medoid_inputs``; a parent's medoid, ``unpack_bits`` and
    ``torch.where``), K18's ``pg_assemble`` and ``pg_blocks`` on the plain
    inputs, ``pg_edges`` (with Ji, and its mode without:
    a tree with one mode runs it), ``pg_update`` on the plain PCG step,
    ``pg_pcg`` and the whole PCG solve at ``PG_BUCKETS`` and the dense
    solve up to Fb 128 (with each GN step's accept decision and its
    margin, ``_gn_decisions``), K17's descent (``bow_descend``) of the ORB and LBD
    descriptors at ``desc_path`` (``loop_keyframe_descriptors``) and its
    histogram (``bow_hist``) of their plain leaves under their valid
    masks, K14's ``kf_scan`` on slam_kernel_phase's chunk of 20 frames
    from the first carry, K15's ``lba_index`` on ``lba_window_problem``,
    K12 on the line scene's half-res images at 128 seeded segments an
    image (``describe_lines_image``, or a parent's ``sobel_gradients`` and
    ``describe_lines``; and ``describe_lines`` on the plain Sobel maps),
    the grids the profiler saw of ``lba_camera``, ``bow_descend``,
    ``bow_hist``, ``kf_scan``, ``lba_index`` and ``lbd_describe``, and the
    device kernels
    (all of them, torch's too) of one point front end
    (``detect_and_describe``) under torch.profiler;
    saves the outputs and each call's device time (torch.profiler, the
    hand kernels; for K13, K2, K5, E, K9, G, K14, K16, K17 and K18 also every
    device kernel's time and count, ``all_kernels``; for K5, E, K9, G, K12,
    K14, K15's index, camera blocks and step, K16, K17 and K18 the
    wrapper's time, CUDA events) to ``out_path``."""
    _use_tree(root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.stereo_points import detect_and_describe
    from plslam_tpu_torch.ops import fast, image, orb
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(
        0, 1, (40, 376, 1241)).astype(np.float32)).to(dev)
    half = torch.from_numpy(rng.uniform(
        0, 1, (40, 188, 620)).astype(np.float32)).to(dev)
    res, gauges, grids = {}, {}, {}
    k = image.gaussian_kernel1d(1.0, 3)
    fn = lambda: [image.separable_filter2d(images, k, k)]
    res["image_sep_filter"] = ([x.cpu() for x in fn()],
                               device_ms(fn, iters=20))
    sets = ((orb._d_h, orb._ONES_H), (orb._ONES_H, orb._d_h))
    if hasattr(image, "separable_filter2d_pair"):
        m = [torch.empty((40, 188 * 620), device=dev) for _ in sets]
        fn = lambda: (image.separable_filter2d_pair(half, *sets[0], *sets[1],
                                                    *m), m)[1]
    else:                   # a tree with no paired mode: two single filters
        fn = lambda: [image.separable_filter2d(half, kx, ky)
                      for kx, ky in sets]
    res["image_sep_filter@moments"] = ([x.reshape(40, -1).cpu()
                                        for x in fn()],
                                       device_ms(fn, iters=20))
    lvl0 = image.separable_filter2d_plain(images, k, k)
    th_hi, th_lo = float(np.float32(20 / 255.0)), float(np.float32(7 / 255.0))
    fn = lambda: fast.fast_score_map2(lvl0, th_hi, th_lo)
    res["fast_score"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20))
    for tag, shape in (("image_resize", (313, 1034)),
                       ("image_resize@half", (188, 620))):
        fn = lambda: [image.resize_bilinear(images, shape)]
        res[tag] = ([x.cpu() for x in fn()], device_ms(fn, iters=20))
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    prob = lba_window_problem(dev, cfg, cam)
    if hasattr(lba, "lba_terms_sigma"):
        fn = lambda: lba.lba_terms_sigma(prob, cam)
    else:                   # a tree whose scale is a launch of its own
        fn = lambda: (lambda t: (t, *lba.lba_sigma(t, prob)))(
            lba.lba_terms(prob, cam))
    t, sig, cost = fn()
    res["lba_terms+sigma"] = ([x.cpu() for x in (*t, sig, cost)],
                              device_ms(fn, iters=20))
    # K15's step after the blocks on the plain blocks (the same on both
    # trees): lba_solve, or a parent's lba_schur, the library's solve and
    # lba_backsub; then the whole run_lba (a parent's eager loop)
    free = lba._free(prob)
    lam = torch.tensor(cfg.mapping.lambda_init, device=dev)
    res["k15_bits"] = k15_bits(dev, cfg, cam, lam) if hasattr(
        lba, "lba_solve") else None
    tp, sg, _ = lba.lba_terms_sigma_plain(prob, cam)
    bp = lba.lba_blocks_plain(tp, prob, sg, free, lam)
    idx = lba.lba_index(prob)
    # K15's landmark index: offsets and lists
    fn = lambda: list(lba.lba_index(prob))
    res["lba_index"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                        *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    grids["lba_index"] = launched_grid(fn, "lba_index_kernel")
    if hasattr(lba, "lba_solve"):
        fn = lambda: list(lba.lba_solve(bp, prob, free, lam, idx))
    else:
        def fn():
            Sm, gm = lba.lba_schur(bp, free, lam)
            dxi = -torch.linalg.solve_ex(Sm, gm[:, None])[0][:, 0]
            dxi = torch.where(free[:, None], dxi.reshape(-1, 6), 0.0)
            return list(lba.lba_backsub(bp, dxi, prob.pt_pos.shape[0]))
    res["lba_step"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                       *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    # K15's camera blocks on the plain terms (the same on both trees), with
    # their distances from the plain version in float64 and the plain
    # version's own; the grid the profiler saw
    fn = lambda: list(lba.lba_camera(tp, sg, free))
    res["lba_camera"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                         *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    truth = lba.lba_camera_plain(_as_f64(tp), sg.double(), free)
    gauges["lba_camera"] = (
        [_rel_d(x, y) for x, y in zip(fn(), truth)],
        [_rel_d(x, y) for x, y in zip(lba.lba_camera_plain(tp, sg, free),
                                      truth)])
    grids["lba_camera"] = launched_grid(fn, "camera_kernel")
    # K15's sharded step on shard 0 of 4 (dist_plain_inputs: the same
    # inputs on both trees): lba_schur_corr, then lba_solve_reduced on the
    # plain sums all-reduced, each with its distances from float64 and the
    # plain version's own
    mesh, probs, _, _, frees, H_ccs, g_cs, bps, corrs, g_corrs, lam_d = (
        dist_plain_inputs(dev, cfg, cam, prob, 4))
    p0, f0, b0 = probs[0], frees[0], bps[0]
    idx0 = lba.lba_index(p0)
    scr = lba.new_solve_scratch(b0.H_cl.shape[0], b0.H_cl.shape[1], dev)
    b64 = _as_f64(b0)
    fn = lambda: list(lba.lba_schur_corr(b0, p0, f0, idx0, scr))
    res["lba_schur_corr"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                             *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    truth = lba.lba_schur_corr_plain(b64, f0)
    gauges["lba_schur_corr"] = (
        [_rel_d(x, y) for x, y in zip(fn(), truth)],
        [_rel_d(x, y) for x, y in zip(lba.lba_schur_corr_plain(b0, f0),
                                      truth)])
    args = (H_ccs[0], g_cs[0], corrs[0], g_corrs[0], b0)
    P0 = p0.pt_pos.shape[0]
    fn = lambda: list(lba.lba_solve_reduced(*args, p0, f0, lam_d,
                                            scratch=scr))
    res["lba_solve_reduced"] = ([x.cpu() for x in fn()],
                                device_ms(fn, iters=20),
                                *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    truth = lba.lba_solve_reduced_plain(*(x.double() for x in args[:4]), b64,
                                        f0, lam_d.double(), P0)
    gauges["lba_solve_reduced"] = (
        [_rel_d(x, y) for x, y in zip(fn(), truth)],
        [_rel_d(x, y) for x, y in zip(lba.lba_solve_reduced_plain(
            *args, f0, lam_d, P0), truth)])
    # the sharded LM's host clock at each of DIST_SHARDS: one call to warm
    # up, then LM_HOST_CALLS calls, each ending in synchronize
    res["lm_host"] = {}
    for n in DIST_SHARDS:
        dist_lm(prob, cam, cfg, n, dev)
        ms = []
        for _ in range(LM_HOST_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist_lm(prob, cam, cfg, n, dev)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        res["lm_host"][n] = ms
    fn = lambda: list(lba.run_lba(prob, cam, cfg))
    fn()
    res["run_lba"] = ([x.cpu() for x in fn()], device_ms(fn, iters=5),
                      *all_kernels(fn, iters=5), cuda_ms(fn, 10))
    # K13: the GN phase (8 iterations, 20 pairs, K = 1024, L = 128) and
    # the whole optimize_pose (8 + 8) on the same inputs; K2: the NMS block
    # max at level 0 (fast_score's masks of the plain blur)
    from plslam_tpu_torch.tracking import pose_gn
    cam_k, pts, lns = gn_inputs(dev, CHUNK, cfg.points.max_kpts,
                                cfg.lines.max_lines, seed=3)
    T0 = torch.eye(4, device=dev).expand(CHUNK, 4, 4)
    chi, clo, score = fast.fast_score_map2(lvl0, th_hi, th_lo)
    for key, fn in (
            ("gn_phase@8", lambda: [pose_gn.gn_iters(
                T0, cam_k, pts, lns, cfg.tracking.max_iters)]),
            ("optimize_pose", lambda: list(pose_gn.optimize_pose(
                T0, cam_k, pts, lns, cfg))),
            ("nms_block_max@l0", lambda: list(fast.nms_block_max(
                score, chi, clo, 5, 16, 48, 160)))):
        res[key] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                    *all_kernels(fn, iters=20))
    # K13's other whole-call shapes, on phase 3's inputs: points only, the
    # lite pass, one pair, lines only at 20 pairs and one
    tk = cfg.tracking
    lite = cfg.with_updates({"tracking": {
        "max_iters": tk.lite_pass_iters,
        "max_iters_ref": tk.lite_pass_iters_ref}})
    K, L_max = cfg.points.max_kpts, cfg.lines.max_lines
    for B, K_, L, c, tag in ((CHUNK, K, 0, cfg, "@points"),
                             (CHUNK, K, L_max, lite, "@lite"),
                             (1, K, L_max, cfg, "@b1"),
                             (CHUNK, 0, L_max, cfg, "@lines_only"),
                             (1, 0, L_max, cfg, "@lines_only_b1")):
        cam_w, pts_w, lns_w = gn_inputs(dev, B, K_, L, seed=5 + L + B,
                                        line_px=0.0 if K_ else 0.5)
        lns_w = lns_w if L else None
        T0_w = torch.eye(4, device=dev).expand(B, 4, 4)
        fn = functools.partial(
            lambda *a: list(pose_gn.optimize_pose(*a)), T0_w, cam_w, pts_w,
            lns_w, c)
        res["optimize_pose" + tag] = ([x.cpu() for x in fn()],
                                      device_ms(fn, iters=20),
                                      *all_kernels(fn, iters=20))
    # K5 on the pyramid of the 40 images, 1,024 seeded keypoints an image
    # (octaves 0-3, on and off the levels' edges): the whole
    # describe_multilevel, and what it runs after its moment filters
    # (orient_and_describe, or a parent's torch glue and pool_bits)
    levels = image.build_pyramid(images, 4, 1.2)
    g = torch.Generator(device="cpu").manual_seed(5)
    octv = torch.randint(0, 4, (40, 1024), generator=g, dtype=torch.int32)
    wh = torch.tensor([lv.shape[:0:-1] for lv in levels],
                      dtype=torch.float32)[octv.long()]
    uv = ((torch.rand((40, 1024, 2), generator=g) * 1.04 - 0.02) * wh
          ).to(dev)
    octv = octv.to(dev)
    fn = lambda: list(orb.describe_multilevel(levels, uv, octv))
    res["describe_multilevel"] = ([x.cpu() for x in fn()],
                                  device_ms(fn, iters=20),
                                  *all_kernels(fn, iters=20),
                                  cuda_ms(fn, 50))
    if hasattr(orb, "orient_and_describe"):
        m10, m01, halves = orb.moment_maps(levels)
        fn = lambda: list(orb.orient_and_describe(levels, m10, m01, halves,
                                                  uv, octv))
    else:
        fn = _orb_after_filters_before(orb, image, levels, uv, octv)
    res["orb_after_filters"] = ([x.cpu() for x in fn()],
                                device_ms(fn, iters=20),
                                *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    # kernel G on the line scene's 40 images (kernel_phase's), full and
    # half res, the TileStage through kernels E and F: refit_roots, then
    # merge_segments on candidates from the plain refit on the CPU (the
    # same on both trees)
    from plslam_tpu_torch.frontend import stereo_lines
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.ops import lines
    seq = synthetic.make_sequence(cam, n_frames=20, seed=1, n_points=500,
                                  n_lines=60, noise=0.003, step=0.25)
    limgs = torch.from_numpy(np.concatenate([seq.images_l, seq.images_r])
                             ).to(dev)
    N, H, W = limgs.shape
    for tag, img, half in (("", limgs, False), ("@half", image.resize_bilinear(
            limgs, (H // 2, W // 2)), True)):
        kw = stereo_lines.detect_kwargs(cfg.lines, half, math.hypot(H, W))
        h, w = img.shape[1:]
        tile, ml, min_len = kw["tile"], kw["max_lines"], kw["min_length"]
        tkw = {k: kw[k] for k in (
            "tile", "grad_th", "min_support", "elong_th", "perp_spread_th",
            "coherence_th", "merge_iters", "merge_ang_th", "merge_dist_th")}
        ts = lines.tile_stage(img, **tkw)
        # kernel E: the eight window maps from the image, one
        # lines_tile_moments launch, or a parent's four-step chain
        # (tile_moments_chain); every map's bits equal, checked
        if hasattr(lines, "tile_moments"):
            fn = lambda: list(lines.tile_moments(img, tile, kw["grad_th"]))
        else:
            fn = lambda: list(tile_moments_chain(img, tile, kw["grad_th"]))
        res["tile_moments" + tag] = ([x.cpu() for x in fn()],
                                     device_ms(fn, iters=20),
                                     *all_kernels(fn, iters=20),
                                     cuda_ms(fn, 50))
        # K9: the whole tile_stage, and its gates and labels alone on the
        # window moments (kernel E's, the same on both trees): this tree's
        # gates_and_labels, or a parent's tile_gates + propagate_labels;
        # outputs (tile_ok, cx, cy, cx_l, cy_l, l1, labels)
        fn = lambda: list(lines.tile_stage(img, **tkw))
        res["tile_stage" + tag] = ([x.cpu() for x in fn()],
                                   device_ms(fn, iters=20),
                                   *all_kernels(fn, iters=20),
                                   cuda_ms(fn, 50))
        wp, d2x, d2y = lines.gradient_planes(img, kw["grad_th"])
        D2x, D2y = lines.orientation_maps(d2x, d2y, tile, tile // 2)
        d2n = lines.sqrt_rn(D2x * D2x + D2y * D2y) + 1e-9
        maps = lines.reweighted_moments(wp, d2x, d2y, D2x / d2n, D2y / d2n,
                                        tile, tile // 2)
        gkw = [tkw[k] for k in ("min_support", "elong_th", "perp_spread_th",
                                "coherence_th")]
        mkw = [tkw[k] for k in ("merge_ang_th", "merge_dist_th",
                                "merge_iters")]
        if hasattr(lines, "gates_and_labels"):
            fn = lambda: list(lines.gates_and_labels(*maps, tile, *gkw,
                                                     *mkw))
        else:
            def fn():
                gt = lines.tile_gates(*maps, tile, *gkw)
                lab = lines.propagate_labels(*gt[:6], *mkw)
                return [gt[0], gt[2], gt[3], gt[6], gt[7], gt[8], lab]
        res["gates_and_labels" + tag] = ([x.cpu() for x in fn()],
                                         device_ms(fn, iters=20),
                                         *all_kernels(fn, iters=20),
                                         cuda_ms(fn, 50))
        len_th = min(0.75 * tile + tile // 2, min_len)
        fn = lambda: list(lines.refit_roots(ts, h, w, tile, ml, min_len))
        res["refit_roots" + tag] = ([x.cpu() for x in fn()],
                                    device_ms(fn, iters=20),
                                    *all_kernels(fn, iters=20),
                                    cuda_ms(fn, 50))
        cts = lines.TileStage(*(x.cpu() for x in ts))
        sp_p, ep_p, sc_p = lines.refit_plain(
            *lines.refit_inputs(cts, h, w, ml), h, w, len_th)
        c_s, c_i = lines.top_k(sc_p, 2 * ml)
        cand = [x.to(dev) for x in (lines.take(sp_p, c_i),
                                    lines.take(ep_p, c_i), c_s)]
        fn = lambda: list(lines.merge_segments(
            *cand, cand[2] > 0, 2.0 * kw["merge_ang_th"],
            kw["merge_dist_th"], kw["merge_gap_th"]))
        res["merge_segments" + tag] = ([x.cpu() for x in fn()],
                                       device_ms(fn, iters=20),
                                       *all_kernels(fn, iters=20),
                                       cuda_ms(fn, 50))
    # K12 on the line scene's half-res images (the plain resize, the same
    # on both trees) at 128 seeded segments an image: this tree's one
    # launch from the image, or a parent's Sobel launch and lbd_describe
    # on its gradients; and describe_lines on the plain Sobel maps
    from plslam_tpu_torch.ops import lbd
    small = image.resize_bilinear_plain(limgs.cpu(), (H // 2, W // 2))
    gxy = [x.to(dev) for x in image.sobel_gradients_plain(small)]
    small = small.to(dev)
    g = np.random.default_rng(8)
    sp = torch.from_numpy(g.uniform(0, [W // 2, H // 2], (N, 128, 2))
                          .astype(np.float32)).to(dev)
    ep = sp + torch.from_numpy(g.normal(0, 40, (N, 128, 2))
                               .astype(np.float32)).to(dev)
    l = cfg.lines
    lkw = (l.lbd_bands, max(l.lbd_band_width // 2, 3), l.lbd_samples,
           l.lbd_band_samples)
    if hasattr(lbd, "describe_lines_image"):
        fn = lambda: [lbd.describe_lines_image(small, sp, ep, *lkw)]
    else:
        fn = lambda: [lbd.describe_lines(*image.sobel_gradients(small), sp,
                                         ep, *lkw)]
    res["lbd@image"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                        *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    grids["lbd"] = launched_grid(fn, "lbd_kernel")
    fn = lambda: [lbd.describe_lines(*gxy, sp, ep, *lkw)]
    res["lbd@grad"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                       *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    # K16 at the map's two shapes: this tree's one launch, or a parent's
    # packed medoid, unpack_bits and torch.where; K18's edge sweep, pg_pcg
    # and the whole solves at the four slot buckets
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.backend import map as tmap
    from plslam_tpu_torch.loop import pose_graph as pg
    from plslam_tpu_torch.ops import hamming
    g = torch.Generator(device="cpu").manual_seed(6)
    for N, tag in ((cfg.mapping.max_points, "@points"),
                   (cfg.mapping.max_lines, "@lines")):
        ring, count, valid, desc = medoid_inputs(g, N, cfg.mapping.desc_ring,
                                                 dev)
        if hasattr(tmap, "_medoid_bits"):
            fn = lambda: [tmap._medoid_bits(ring, count, valid, desc)]
        else:
            fn = lambda: [torch.where(valid[:, None], hamming.unpack_bits(
                tmap._medoid_desc(ring, count)), desc)]
        res["medoid" + tag] = ([x.cpu() for x in fn()],
                               device_ms(fn, iters=20),
                               *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    import inspect
    jac_mode = "jac" in inspect.signature(pg.edges).parameters
    carry = "r" in inspect.signature(pg.update).parameters
    decisions = {}
    for F, n, extra in PG_BUCKETS:
        gd = convert.pose_graph_from_numpy(
            synthetic.drift_circle_graph(F, n, extra, seed=F)[0], dev)
        freeze = torch.zeros(F, dtype=torch.bool, device=dev)
        diag = pg._diag(gd, freeze, True)
        inc = pg._incidence(gd)
        rp, Jp, cp = pg.edges_plain(gd)
        gbp, Hdp = pg.blocks_plain(gd, rp, Jp, diag)
        Minv = torch.linalg.inv_ex(Hdp)[0]
        # the edge sweep: pg_edges (r, Ji, cost), its mode without Ji (a
        # tree without it: its one mode, r and cost kept), pg_update on
        # the plain PCG step (a tree that hands on no residuals: poses and
        # cost)
        fn = lambda: list(pg.edges(gd))
        res[f"pg_edges@{F}"] = ([x.cpu() for x in fn()],
                                device_ms(fn, iters=20),
                                *all_kernels(fn, iters=20), cuda_ms(fn, 50))
        r = pg.edges(gd)[0]
        fn = ((lambda: [x for x in pg.edges(gd, jac=False) if x is not None])
              if jac_mode else (lambda: (lambda o: [o[0], o[2]])(
                  pg.edges(gd))))
        res[f"pg_edges_r@{F}"] = ([x.cpu() for x in fn()],
                                  device_ms(fn, iters=20),
                                  *all_kernels(fn, iters=20),
                                  cuda_ms(fn, 50))
        dxp = pg.pcg_plain(gd, Jp, Minv, diag, gbp, 96)
        fn = lambda: list(pg.update(gd, cp, dxp, 1.0,
                                    *([r] if carry else [])))
        res[f"pg_update@{F}"] = ([x.cpu() for x in fn()],
                                 device_ms(fn, iters=20),
                                 *all_kernels(fn, iters=20), cuda_ms(fn, 50))
        # the normal equations on the plain inputs (the same on both trees):
        # H and g, g and Hd, whose bits the trees share
        for key, fn in (("pg_assemble", lambda: list(pg.assemble(
                gd, rp, Jp, diag, inc))), ("pg_blocks", lambda: list(
                    pg.blocks(gd, rp, Jp, diag, inc)))):
            res[f"{key}@{F}"] = ([x.cpu() for x in fn()],
                                 device_ms(fn, iters=20),
                                 *all_kernels(fn, iters=20), cuda_ms(fn, 50))
        fn = lambda: [pg.pcg(gd, Jp, Minv, diag, gbp, 96, inc)]
        res[f"pg_pcg@{F}"] = ([x.cpu() for x in fn()],
                              device_ms(fn, iters=5),
                              *all_kernels(fn, iters=5), cuda_ms(fn, 10))
        solves = [("optimize_pcg", lambda: list(pg._optimize_pcg(
            gd, freeze, 12, 96)))]
        if F <= 128:
            solves.append(("optimize_dense", lambda: list(pg._optimize_dense(
                gd, freeze, 12))))
        for key, fn in solves:
            res[f"{key}@{F}"] = ([x.cpu() for x in fn()],
                                 device_ms(fn, iters=3),
                                 *all_kernels(fn, iters=3), cuda_ms(fn, 3))
            decisions[f"{key}@{F}"] = _gn_decisions(pg, fn)
    res["decisions"] = decisions
    # K17's descent of the loop path's first keyframe's descriptors
    # (loop_keyframe_descriptors, computed once by ``against``)
    from plslam_tpu_torch.loop import vocabulary as voc
    for kind, (words, valid) in torch.load(desc_path).items():
        v = voc.default_vocabulary(kind, 10, 4, dev)
        words, valid = words.to(dev), valid.to(dev)
        fn = lambda: [voc.transform_leaves(v, words)]
        res["bow_descend@" + kind] = ([x.cpu() for x in fn()],
                                      device_ms(fn, iters=20),
                                      *all_kernels(fn, iters=20),
                                      cuda_ms(fn, 50))
        check(torch.equal(fn()[0], voc.transform_leaves_plain(v, words)),
              f"bow_descend@{kind} differs from its plain version")
        grids["bow_descend@" + kind] = launched_grid(fn, "bow_descend_kernel")
        # K17's histogram of those leaves (the plain descent's, the same on
        # both trees) under the probe's valid mask
        leaves = voc.transform_leaves_plain(v, words)
        fn = lambda: [voc.bow_hist(v, leaves, valid)]
        res["bow_hist@" + kind] = ([x.cpu() for x in fn()],
                                   device_ms(fn, iters=20),
                                   *all_kernels(fn, iters=20),
                                   cuda_ms(fn, 50))
        grids["bow_hist@" + kind] = launched_grid(fn, "bow_hist_kernel")
    # K14 on slam_kernel_phase's chunk of 20 frames from the first carry:
    # flags, T_accs, ratios, blocked and the carry's seven fields
    from plslam_tpu_torch.backend import fused_slam
    from plslam_tpu_torch.core import lie
    rng = np.random.default_rng(4)
    xi = rng.normal(size=(CHUNK, 6)) * [0.05, 0.02, 0.4, 0.01, 0.03, 0.01]
    DT = lie.exp_se3(torch.from_numpy(xi.astype(np.float32))).to(dev)
    A = rng.normal(size=(CHUNK, 6, 6)) * 1e-3
    cov = torch.from_numpy((A @ A.transpose(0, 2, 1) + 1e-6 * np.eye(6))
                           .astype(np.float32)).to(dev)
    good = torch.from_numpy(rng.random(CHUNK) > 0.1).to(dev)
    carry = fused_slam.init_crit_carry(dev)
    fn = lambda: (lambda o: [*o[:4], *o[4]])(fused_slam.kf_scan(
        DT, cov, good, carry, cfg, cfg.system.kf_batch))
    res["kf_scan"] = ([x.cpu() for x in fn()], device_ms(fn, iters=20),
                      *all_kernels(fn, iters=20), cuda_ms(fn, 50))
    grids["kf_scan"] = launched_grid(fn, "kf_scan_kernel")
    res["gauges"], res["grids"] = gauges, grids
    detect_and_describe(images, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        detect_and_describe(images, cfg)
        torch.cuda.synchronize()
    res["front_end_kernels"] = sum(e.count for e in prof.key_averages()
                                   if e.device_type != DeviceType.CPU)
    torch.save(res, out_path)


def _gn_decisions(pg, solve):
    """Each GN step of ``solve()`` (``pg.update`` wrapped): whether it was
    accepted, and |c_try - c| / c with c_try the plain version's cost at
    the step's trial poses (on the card)."""
    import unittest.mock as mock
    import torch
    from plslam_tpu_torch.core import lie
    out, orig = [], pg.update

    def update(g, c, step, scale, *rest, **kw):
        res = orig(g, c, step, scale, *rest, **kw)
        dx = torch.where(g.pose_valid[:, None], scale * step, 0.0)
        c_try = pg.edges_plain(g._replace(poses=g.poses @ lie.exp_se3(dx)))[2]
        out.append((not torch.equal(res[0], g.poses),
                    float((c_try - c).abs() / c)))
        return res
    with mock.patch.object(pg, "update", update):
        solve()
        torch.cuda.synchronize()
    return out


def _hold_pose_graph(a, b) -> None:
    """K18's normal equations, edge sweep and whole solves between two trees
    (``a`` the other's results, ``b`` this one's): pg_assemble's H and g
    and pg_blocks' g and Hd the same bits; r and Ji of pg_edges, and
    pg_update's poses, the same bits or within 1e-6 of the largest entry,
    the costs within 1e-6 relative; a solve's poses the same bits, or
    within 1e-5 of the largest translation where the first accept
    decision that differs lies within 1e-6 of its threshold on both trees
    (after it the two solves take other steps; every differing decision
    is printed)."""
    import torch
    for F, _, _ in PG_BUCKETS:
        for key in (f"pg_assemble@{F}", f"pg_blocks@{F}"):
            same = [torch.equal(x, y) for x, y in zip(b[key][0], a[key][0])]
            print(f"[against] {key}: the same bits per output {same}",
                  flush=True)
            check(all(same), f"{key}: the two trees' normal equations differ")
        for key in (f"pg_edges@{F}", f"pg_edges_r@{F}", f"pg_update@{F}"):
            xs, ys = b[key][0], a[key][0]
            rels = [max_abs_err(x, y) / max(float(y.abs().max()), 1e-30)
                    for x, y in zip(xs, ys)]
            same = [torch.equal(x, y) for x, y in zip(xs, ys)]
            print(f"[against] {key}: the same bits per output {same}; "
                  f"|this - other| relative to the other's largest entry "
                  f"{[f'{x:g}' for x in rels]}", flush=True)
            check(all(x <= 1e-6 for x in rels), f"{key}: the two trees "
                  f"differ by more than 1e-6 of the largest entry: {rels}")
        for key in (f"optimize_pcg@{F}", f"optimize_dense@{F}"):
            if key not in a:
                continue
            P, Q = b[key][0][0], a[key][0][0]
            if torch.equal(P, Q):
                print(f"[against] {key}: poses the same bits on both trees",
                      flush=True)
                continue
            da, db = a["decisions"][key], b["decisions"][key]
            flips = [(k, x[1], y[1]) for k, (x, y) in enumerate(zip(da, db))
                     if x[0] != y[0]]
            scale = float(Q[:, :3, 3].abs().max())
            d = max_abs_err(P, Q) / scale
            print(f"[against] {key}: poses differ by {d:g} of the largest "
                  f"translation; accept decisions that differ (step, "
                  f"|c_try - c| / c other, this): {flips}", flush=True)
            check(d <= 1e-5 and bool(flips) and max(flips[0][1:]) < 1e-6,
                  f"{key}: poses {d:g} of the largest translation apart, "
                  f"decisions {flips}")


def against(other: str) -> None:
    """``python3 chip_smoke.py --against DIR``: ``against_side`` of the
    checkout at DIR and of this one, in turns (DIR, this, this, DIR), each
    in a process of its own; prints each output's largest difference
    between the two trees (the scale's and the cost's as bits too), every
    device time, the point front end's device kernels and the sharded
    LM's warm host clock (``_lm_host``); fails where K5's
    or K12's bits, kernel E's maps, K9's tile_ok or labels or K15's
    landmark index differ between the trees, or K18's edge sweep and
    solves break ``_hold_pose_graph``'s rule; then ``_against_solves``."""
    import os
    import tempfile
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"other": os.path.abspath(other), "this": here}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        desc_path = os.path.join(tmp, "desc.pt")
        torch.save(loop_keyframe_descriptors(torch.device("cuda", 0)),
                   desc_path)
        for i, who in enumerate(("other", "this", "this", "other")):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--against-side", roots[who], out, desc_path],
                           check=True, cwd=roots[who], timeout=600)
            runs.append((who, torch.load(out)))
    (_, a), (_, b) = runs[0], runs[1]
    for key in a:
        if key in ("front_end_kernels", "gauges", "grids", "decisions",
                   "k15_bits", "lm_host"):
            continue
        errs = [max_abs_err(x, y) for x, y in zip(a[key][0], b[key][0])]
        if all(x.is_floating_point() for x in a[key][0]):
            rels = [e / max(float(y.double().abs().max()), 1e-30)
                    for e, y in zip(errs, a[key][0])]
            print(f"[against] {key}: largest |this - other| relative to the "
                  f"other's largest magnitude per output "
                  f"{[f'{r:g}' for r in rels]}", flush=True)
        times = {who: [r[key][1] for w, r in runs if w == who]
                 for who in ("other", "this")}
        print(f"[against] {key}: largest |this - other| per output "
              f"{[f'{e:g}' for e in errs]}; device_ms this "
              f"{[f'{x:.4f}' for x in times['this']]}, other "
              f"{[f'{x:.4f}' for x in times['other']]}", flush=True)
        if len(a[key]) > 2:     # every device kernel, torch's too
            alls = {who: [(r[key][2], r[key][3]) for w, r in runs
                          if w == who] for who in ("other", "this")}
            print(f"[against] {key}: all device kernels (ms, kernels a "
                  f"call) this {[(f'{m:.4f}', n) for m, n in alls['this']]}"
                  f", other {[(f'{m:.4f}', n) for m, n in alls['other']]}",
                  flush=True)
        if len(a[key]) > 4:     # the wrapper: CUDA events, host included
            wr = {who: [f"{r[key][4]:.4f}" for w, r in runs if w == who]
                  for who in ("other", "this")}
            print(f"[against] {key}: wrapper ms this {wr['this']}, other "
                  f"{wr['other']}", flush=True)
    # K5's and K12's bits, kernel E's maps, K9's tile_ok and labels and
    # K15's landmark index equal on both trees
    for key, idx in (("describe_multilevel", (0,)),
                     ("orb_after_filters", (0,)),
                     ("tile_moments", range(8)), ("tile_moments@half",
                                                  range(8)),
                     ("tile_stage", (0, 1)), ("tile_stage@half", (0, 1)),
                     ("gates_and_labels", (0, 6)),
                     ("gates_and_labels@half", (0, 6)),
                     ("lbd@image", (0,)), ("lbd@grad", (0,)),
                     ("lba_index", (0, 1))):
        check(all(torch.equal(a[key][0][i], b[key][0][i]) for i in idx),
              f"{key}: the two trees' bits, maps, tile_ok, labels or lists "
              "differ")
        same = [torch.equal(x, y) for x, y in zip(a[key][0], b[key][0])]
        print(f"[against] {key}: bits / maps / tile_ok / labels / lists "
              f"equal on both trees; the same bits per output {same}",
              flush=True)
    _k15_bits(runs)
    _lm_host(runs)
    for key in ("lbd", "lba_index"):
        print(f"[against] {key}: grid, block this {b['grids'].get(key)}, "
              f"other {a['grids'].get(key)}", flush=True)
    # K15's camera blocks and the sharded step's two entries within K15's
    # float64 rule on both trees; K17's leaf ids equal on both trees; each
    # launch's grid
    for who, r in runs[:2]:
        for key in ("lba_camera", "lba_schur_corr", "lba_solve_reduced"):
            d_k, d_p = r["gauges"][key]
            tols = [F64_FACTOR * p + F64_FLOOR for p in d_p]
            print(f"[against] {key} ({who}): from float64 "
                  f"{[f'{x:.3g}' for x in d_k]}, the plain version's "
                  f"{[f'{x:.3g}' for x in d_p]}, bound "
                  f"{[f'{x:.3g}' for x in tols]}"
                  + (f"; grid, block {r['grids'].get(key)}"
                     if key == "lba_camera" else ""), flush=True)
            check(all(x <= t for x, t in zip(d_k, tols)),
                  f"{key} ({who}) outside the float64 rule: {d_k} > {tols}")
    for kind in ("orb", "lbd"):
        key = "bow_descend@" + kind
        check(torch.equal(a[key][0][0], b[key][0][0]),
              f"{key}: the two trees' leaf ids differ")
        print(f"[against] {key}: {a[key][0][0].numel()} leaf ids equal on "
              f"both trees; grid, block this {b['grids'][key]}, other "
              f"{a['grids'][key]}", flush=True)
        # K17's vector: within 1e-6 of the other tree's largest entry,
        # with the same zeros
        key = "bow_hist@" + kind
        x, y = b[key][0][0], a[key][0][0]
        rel = max_abs_err(x, y) / max(float(y.abs().max()), 1e-30)
        check(torch.equal(x == 0, y == 0) and rel <= 1e-6,
              f"{key}: the two trees' vectors differ: {rel:g} of the "
              "largest entry, or in their zeros")
        print(f"[against] {key}: |this - other| {rel:g} of the largest "
              f"entry, zeros equal, bits {'equal' if torch.equal(x, y) else 'differ'}"
              f"; grid, block this {b['grids'][key]}, other "
              f"{a['grids'][key]}", flush=True)
    # K14: flags and blocked exact between the trees; whether T_accs,
    # ratios and the carry are the same bits
    x, y = b["kf_scan"][0], a["kf_scan"][0]
    check(torch.equal(x[0], y[0]) and torch.equal(x[3], y[3]),
          "kf_scan: the two trees' flags or blocked differ")
    same = [torch.equal(p, q) for p, q in zip(x, y)]
    print(f"[against] kf_scan: flags and blocked equal; the same bits per "
          f"output (flags, T_accs, ratios, blocked, then the carry's "
          f"fields) {same}; grid, block this {b['grids']['kf_scan']}, "
          f"other {a['grids']['kf_scan']}", flush=True)
    _hold_pose_graph(a, b)
    sig_cost = [(r["lba_terms+sigma"][0][-2], r["lba_terms+sigma"][0][-1])
                for _, r in runs[:2]]
    bits = [[x.view(torch.int32).item() for x in sc] for sc in sig_cost]
    print(f"[against] sigma, cost bits: other {bits[0]}, this {bits[1]}: "
          f"{'equal' if bits[0] == bits[1] else 'DIFFERENT'}", flush=True)
    kernels = {who: [r["front_end_kernels"] for w, r in runs if w == who]
               for who in ("other", "this")}
    print(f"[against] device kernels of one point front end "
          f"(detect_and_describe, 40 images): this {kernels['this']}, "
          f"other {kernels['other']}", flush=True)
    _against_solves(roots)


def _lm_host(runs) -> None:
    """Prints the sharded LM's warm host-clock calls in each of
    ``--against``'s four runs (other, this, this, other), and each tree's
    median and range over its two runs."""
    import statistics
    for n in DIST_SHARDS:
        for who, r in runs:
            ms = r["lm_host"][n]
            print(f"[against] sharded LM at {n} shards ({who}), host ms of "
                  f"{len(ms)} warm calls: {[f'{x:.3f}' for x in ms]}",
                  flush=True)
        for who in ("other", "this"):
            ms = [x for w, r in runs if w == who for x in r["lm_host"][n]]
            print(f"[against] sharded LM at {n} shards ({who}): median "
                  f"{statistics.median(ms):.3f} ms host, range "
                  f"{min(ms):.3f}-{max(ms):.3f} over {len(ms)} calls",
                  flush=True)


def _k15_bits(runs) -> None:
    """Prints, of ``k15_bits`` in each of ``--against``'s four runs, each
    tree's launches and which outputs differ from the first run's bit for
    bit (a tree that changes K15's arithmetic on purpose differs here)."""
    import torch
    if any(r["k15_bits"] is None for _, r in runs):
        print("[against] K15 bits: a tree without lba_solve", flush=True)
        return
    first = runs[0][1]["k15_bits"]["out"]
    differ = [(who, k) for who, r in runs
              for k, v in r["k15_bits"]["out"].items()
              if k not in first or not all(
                  torch.equal(x, y) for x, y in zip(v, first[k]))]
    for who, r in runs:
        print(f"[against] K15 bits ({who}): launches "
              f"{r['k15_bits']['launches']}", flush=True)
    print(f"[against] K15 bits: {len(first)} outputs (lba_camera, lba_solve "
          f"capped and not, run_lba eager and replayed, at K = 1024 and "
          f"256) x 4 runs; differing from the first run: {differ or 'none'}",
          flush=True)


def solve_calls(root: str, what: str) -> None:
    """One process of ``--against``, in the checkout at ``root``: the first
    four calls of its ``optimize_pose_graph`` (``what`` "dense") or
    ``optimize_pose_graph_pcg`` ("pcg") at Fb 64, host clock between
    synchronizes (the first pays the library's and the kernels' first
    use), or ("loop") its chip_smoke.py's loop path, dense then PCG."""
    _use_tree(root)
    import torch
    from plslam_tpu_torch import convert, native
    native.lib()
    dev = torch.device("cuda", 0)
    if what == "loop":
        import chip_smoke as cs           # root's
        cs.LOOP_SCENE = cs.loop_scene()
        cs.loop_path(dev, "loop", cpu=cs.LOOP_CPU.get("default"))
        cs.loop_path(dev, "loop_pcg", cs.pcg_updates({}),
                     cpu=cs.LOOP_CPU.get("pcg"))
        return
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg
    F, n, extra = PG_BUCKETS[0]
    g = convert.pose_graph_from_numpy(
        synthetic.drift_circle_graph(F, n, extra, seed=F)[0], dev)
    pg.edges(g)                       # the kernels loaded, a first launch
    fn = (pg.optimize_pose_graph if what == "dense"
          else pg.optimize_pose_graph_pcg)
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(g)
        torch.cuda.synchronize()
        ms.append(round(1e3 * (time.perf_counter() - t0), 3))
    print(f"[against] {what} solve at Fb {F}, calls 1-4 of a fresh "
          f"process: {ms} ms", flush=True)


def _against_solves(roots: dict) -> None:
    """``solve_calls`` on both trees in turns (other, this, this, other),
    each in processes of its own; prints the timing lines."""
    import os
    keep = ("[against] ", "] fps=", "] ms per call ", "] CPU run:")
    for who in ("other", "this", "this", "other"):
        for what in ("dense", "pcg", "loop"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--against-solves", roots[who], what], cwd=roots[who],
                capture_output=True, text=True, timeout=900)
            check(out.returncode == 0, f"--against-solves {what} on the "
                  f"{who} tree failed:\n{out.stderr[-4000:]}")
            for line in out.stdout.splitlines():
                if any(k in line for k in keep):
                    line = line.removeprefix("[against] ")
                    print(f"[against] ({who}) {line}", flush=True)


# -- the distributed back end ---------------------------------------------------

DIST_SHARDS = (2, 4)
LM_HOST_CALLS = 9      # --against's warm calls of the sharded LM a tree
# tests/test_dist_lba.py:210's live scene and configuration (512x320, 25
# frames, seed 5, points only) and tests/test_dist_vocab.py:104's loop scene
# (40 frames, seed 21, a keyframe a frame)
DIST_BASE = {
    "camera": {"width": 512, "height": 320, "fx": 400.0, "fy": 400.0,
               "cx": 256.0, "cy": 160.0, "baseline": 0.3},
    "points": {"max_kpts": 256, "orb_nlevels": 2},
    "lines": {"has_lines": False},
    "matching": {"f2f_window": 128.0},
    "mapping": {"max_kfs": 32, "max_points": 4096, "max_lines": 256,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 5,
                "lba_max_points": 1024, "lba_max_lines": 64},
    "keyframe": {"min_entropy_ratio": 0.97},
    "loop": {"enabled": False},
    "system": {"async_mapping": False},
}
DIST_LOOP = {
    "camera": DIST_BASE["camera"],
    "points": {"max_kpts": 384, "orb_nlevels": 2},
    "lines": {"has_lines": False},
    "matching": {"f2f_window": 128.0},
    "mapping": {"max_kfs": 64, "max_points": 4096, "max_lines": 256,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 5},
    "keyframe": {"min_entropy_ratio": 2.0},
    "system": {"async_mapping": False},
    "loop": {"enabled": True, "min_kf_separation": 12,
             "consistency_window": 2, "lc_inl": 15, "lc_trs": 3.0,
             "lc_rot": 60.0},
}
MULTIHOST_PROCS = 2


def dist_lm(prob, cam, cfg, n, device, ops=None):
    """make_dist_lba_lm over n shards on ``device`` of ``prob`` bucketed by
    owner (its landmarks back in the original order): (kf_pose, pt_pos,
    ep_pos, cost0, cost1) and the mesh."""
    from plslam_tpu_torch.parallel import dist_lba as D
    from plslam_tpu_torch.parallel.mesh import make_mesh
    m = cfg.mapping
    b = D.bucket_problem_by_owner(prob, n)
    mesh = make_mesh(n, ("lm",), device)
    out = D.make_dist_lba_lm(mesh, cam, m.lba_iters, m.lambda_init,
                             m.lambda_factor, ops=ops or D.KERNELS)(b.problem)
    return (out[0], D.unbucket_landmarks(out[1], b.pt_perm),
            D.unbucket_landmarks(out[2], b.ep_perm), *out[3:]), mesh


def cpu_dist_lm(prob, cam, cfg):
    """The sharded LM of ``lba_window_problem`` through the plain versions
    on the CPU at each of DIST_SHARDS (``--cpu-ate dist``): {n: outputs on
    the CPU}."""
    cpu = type(prob)(*(x.cpu() for x in prob))
    out = {}
    for n in DIST_SHARDS:
        t0 = time.perf_counter()
        out[n] = dist_lm(cpu, cam, cfg, n, "cpu")[0]
        print(f"[cpu] dist LM at {n} shards: cost {float(out[n][3])!r} -> "
              f"{float(out[n][4])!r} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def dist_plain_inputs(dev, cfg, cam, prob, n):
    """The sharded step's launches' inputs on every shard of n of ``prob``
    (bucketed by owner) through the plain versions, at lambda_init: (mesh,
    shards, terms, the global MAD scale, free masks, then a list a shard of
    H_cc, g_c (all-reduced), the blocks (contiguous), corr and g_corr
    (lba_schur_corr_plain's, all-reduced), and lam)."""
    import torch
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.parallel import dist_lba as D
    from plslam_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(n, ("lm",), dev)
    probs = D.shard_problem(mesh, D.bucket_problem_by_owner(prob, n).problem)
    lam = torch.tensor(cfg.mapping.lambda_init, device=dev)
    tp = [lba.lba_terms_plain(p, cam) for p in probs]
    sigma = D._shard_scale(mesh, tp, "lm")
    free = [lba._free(p) for p in probs]
    cams = [lba.lba_camera_plain(t, s, f) for t, s, f in zip(tp, sigma, free)]
    H_cc = mesh.psum([c[0] for c in cams], "lm")
    g_c = mesh.psum([c[1] for c in cams], "lm")
    # contiguous, as the sharded LM hands the blocks to the kernels (the
    # plain einsums may give permuted views, which the wrappers would copy)
    bp = [lba.LandmarkBlocks(*(x.contiguous() for x in (
              h, g, *lba.lba_bin_plain(t, p, s, f, lam))))
          for h, g, t, p, s, f in zip(H_cc, g_c, tp, probs, sigma, free)]
    sums = [lba.lba_schur_corr_plain(b, f) for b, f in zip(bp, free)]
    corr = mesh.psum([x[0] for x in sums], "lm")
    g_corr = mesh.psum([x[1] for x in sums], "lm")
    return mesh, probs, tp, sigma, free, H_cc, g_c, bp, corr, g_corr, lam


def dist_kernel_holds(dev, record, cfg, cam, prob, n):
    """Each K15 launch of the sharded step on every shard of n, against its
    plain version on the same inputs (the plain terms, the global scale
    and the all-reduced sums of the plain versions): lba_terms (masks
    exact, floats 1e-5 of each output's largest magnitude), lba_index
    (exact), lba_bin (lba_phase's tolerances), lba_camera, lba_schur_corr
    and lba_solve_reduced by K15's rule (float64 the truth). At 4 shards
    shard 0's two new launches are timed as the JSON rows."""
    import torch
    from plslam_tpu_torch.backend import lba
    mesh, probs, tp, sigma, free, H_cc, g_c, bp, corr, g_corr, lam = (
        dist_plain_inputs(dev, cfg, cam, prob, n))
    print(f"[dist] {n} shards placed on {[str(d) for d in mesh.devices]} "
          "(shard i on visible device i % count)", flush=True)
    rel = lambda a, b: _rel_d(a, b)
    for i, (p, t, s, f, b) in enumerate(zip(probs, tp, sigma, free, bp)):
        # lba_phase's tolerances: residuals and norms 4e-4 px, Jacobians
        # 1e-5 of their largest magnitude, masks exact
        tk = lba.lba_terms_sigma(p, cam)[0]
        check(all(torch.equal(x, y) if not x.is_floating_point() else (
            max_abs_err(x, y) <= 4e-4 if j in (0, 4, 5) else rel(x, y) <= 1e-5)
            for j, (x, y) in enumerate(zip(tk, t))),
            f"dist: lba_terms on shard {i} of {n} disagrees")
        idx = lba.lba_index(p)
        check(all(torch.equal(x, y) for x, y in zip(
            idx, lba.lba_index_plain(p))), f"dist: lba_index, shard {i}")
        b64 = _as_f64(b)
        f64_gauge(f"{n} shards, shard {i}: lba_camera", lba.lba_camera(
            t, s, f), lba.lba_camera_plain(t, s, f), lba.lba_camera_plain(
            _as_f64(t), s.double(), f), hold=True, tag="dist")
        kb = lba.lba_bin(t, p, s, f, lam, idx)
        check(all(rel(x, y) <= tol for x, y, tol in zip(
            kb, b[2:], (1e-5, 1e-3, 1e-5, 1e-5))),
            f"dist: lba_bin on shard {i} of {n} disagrees")
        scratch = lba.new_solve_scratch(b.H_cl.shape[0], b.H_cl.shape[1], dev)
        ks = lba.lba_schur_corr(b, p, f, idx, scratch)
        f64_gauge(f"{n} shards, shard {i}: lba_schur_corr (corr, g_corr)",
                  ks, lba.lba_schur_corr_plain(b, f),
                  lba.lba_schur_corr_plain(b64, f), hold=True, tag="dist")
        P = p.pt_pos.shape[0]
        args = (H_cc[i], g_c[i], corr[i], g_corr[i], b)
        ksol = lba.lba_solve_reduced(*args, p, f, lam, scratch=scratch)
        f64_gauge(f"{n} shards, shard {i}: lba_solve_reduced (dxi, d_pt, "
                  "d_ep)", ksol, lba.lba_solve_reduced_plain(
                      *args, f, lam, P), lba.lba_solve_reduced_plain(
                      *(x.double() for x in args[:4]), b64, f, lam.double(),
                      P), hold=True, tag="dist")
        if n != 4 or i != 0:
            continue
        # the JSON rows: bytes each input read once and each output
        # written once (the observed blocks of H_cl, H_inv, g_l, the index;
        # corr and g_corr out; then H_cc, g_c, corr, g_corr, H_ll's
        # diagonal, the blocks again for the landmark steps, dxi and the
        # landmark steps); operations: lba_solve's row's counts split
        # between the two (the products and sums over observed pairs; the
        # LU of the free poses' block, its solves and the landmark steps)
        W, n_lm = b.H_cl.shape[:2]
        total = int(idx.off[-1])
        K, L = p.obs_pt_id.shape[1], p.obs_ln_sid.shape[1]
        g_obs = idx.obs[:total].long()
        pose = torch.where(g_obs < W * K, g_obs // K,
                           (g_obs - W * K) // (2 * L))
        lm_of = torch.repeat_interleave(torch.arange(n_lm, device=dev),
                                        (idx.off[1:] - idx.off[:-1]).long())
        seen = torch.zeros((n_lm, W), dtype=torch.bool, device=dev)
        seen[lm_of, pose] = True
        seen &= f[None, :]
        per_lm = seen.sum(1)
        n_obs_pairs = int(per_lm.sum())
        n_pose_pairs = int((per_lm * (per_lm + 1) // 2).sum())
        nf = 6 * int(f.sum())
        print(f"[dist] shard 0 of 4: W={W} K={K} L={L} P={P} "
              f"Q={p.ep_pos.shape[0]}; {n_obs_pairs} observed (landmark, "
              f"free pose) pairs, {n_pose_pairs} pose pairs", flush=True)
        src = "plslam_tpu_torch/csrc/lba.cu"
        rep = "plslam_tpu/parallel/dist_lba.py:"
        pk = lambda xs, ys: ([x / y.abs().max().clamp(min=1e-30)
                              for x, y in zip(xs, ys)],
                             [y / y.abs().max().clamp(min=1e-30) for y in ys])
        ref = lba.lba_schur_corr_plain(b, f)
        tols = f64_gauge("lba_schur_corr row", ks, ref,
                         lba.lba_schur_corr_plain(b64, f), tag="dist")
        g_, r_ = pk(ks, ref)
        record("lba_schur_corr", src, rep + "297", g_, r_, tols,
               lambda: lba.lba_schur_corr(b, p, f, idx, scratch),
               lambda: lba.lba_schur_corr_plain(b, f),
               n_obs_pairs * 72 + n_lm * 48 + (n_lm + 1 + total) * 4 + W
               + W * W * 144 + W * 24,
               n_obs_pairs * (108 + 36) + n_pose_pairs * 216 + n_lm * 24,
               cluster=lba.schur_corr_layout(W, n_lm)[0],
               err_kind="relative to each output's largest magnitude, "
               f"tolerance {F64_FACTOR:g}x the plain one's distance from "
               f"float64 + {F64_FLOOR:g}")
        ref = lba.lba_solve_reduced_plain(*args, f, lam, P)
        tols = f64_gauge("lba_solve_reduced row", ksol, ref,
                         lba.lba_solve_reduced_plain(
                             *(x.double() for x in args[:4]), b64, f,
                             lam.double(), P), tag="dist")
        g_, r_ = pk(ksol, ref)
        Sm, gm = lba._reduced_system(*args[:4], f, lam, lba.PIN_WEIGHT)
        record("lba_solve_reduced", src, rep + "304", g_, r_, tols,
               lambda: lba.lba_solve_reduced(*args, p, f, lam,
                                             scratch=scratch),
               lambda: lba.lba_solve_reduced_plain(*args, f, lam, P),
               W * 168 + W * W * 144 + W * 24 + n_obs_pairs * 72
               + n_lm * (36 + 12 + 12 + 4 + 12) + W * 24 + 4,
               2 * nf ** 3 // 3 + 2 * nf ** 2 + n_obs_pairs * 36 + n_lm * 28,
               lambda: torch.linalg.solve_ex(Sm, gm[:, None]),
               library_what=f"torch.linalg.solve_ex of the {6 * W}x{6 * W} "
               "reduced system alone",
               cluster=lba.solve_reduced_cluster(n_lm),
               err_kind="relative to each output's largest magnitude, "
               f"tolerance {F64_FACTOR:g}x the plain one's distance from "
               f"float64 + {F64_FLOOR:g}")


def dist_lm_phase(dev, cfg, cam, prob):
    """(a) the sharded LM on ``lba_window_problem`` at each of DIST_SHARDS:
    each kernel's exact launches, the states held by K15's rule to the
    plain versions on the card in float32 and float64, and to the CPU run
    (``cpu_dist_lm``: within F64_FACTOR x the card plain version's distance
    from float64 plus the CPU run's own, plus F64_FLOOR), each bound a
    tenth of how far the LM moved the state; the LM's movement of the
    poses, points and endpoints against run_lba's by direction (cos >
    0.99, magnitude ratio in (0.7, 1.4): the scales differ, mean |r|
    against the median; one step's direction printed); the collectives of
    one step, comm_bytes_per_step(W) bytes."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.parallel import dist_lba as D
    from plslam_tpu_torch.parallel.mesh import make_mesh
    m = cfg.mapping
    W = prob.kf_pose.shape[0]
    cpu = cpu_dist_lm(prob, cam, cfg)
    p64 = _as_f64(prob)
    single = lba.run_lba(prob, cam, cfg)
    lam = torch.tensor(m.lambda_init, device=dev)
    dense = lba._assemble_and_solve(prob, cam, lam)
    fields = ("poses", "points", "endpoints")

    def direction(tag, a, b, hold=True):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        cos = float(a @ b / (a.norm() * b.norm()).clamp(min=1e-30))
        ratio = float(a.norm() / b.norm().clamp(min=1e-30))
        print(f"[dist] {tag}: cos {cos:.6f}, magnitude ratio {ratio:.4f}",
              flush=True)
        check(not hold or (cos > 0.99 and 0.7 < ratio < 1.4),
              f"dist: {tag}: cos {cos}, ratio {ratio}")
    for n in DIST_SHARDS:
        native.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, mesh = dist_lm(prob, cam, cfg, n, dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(native.LAUNCHES)
        it = m.lba_iters
        want = {"lba_terms": (1 + 2 * it) * n, "lba_index": n,
                "lba_camera": it * n, "lba_bin": it * n,
                "lba_schur_corr": it * n, "lba_solve_reduced": it * n}
        print(f"[dist] LM at {n} shards: cost {float(out[3]):.6g} -> "
              f"{float(out[4]):.6g} (single-device run_lba "
              f"{float(single.cost0):.6g} -> {float(single.cost1):.6g}), "
              f"{wall:.2f} ms host clock (first call; ends in synchronize), "
              f"launches {counts}, collectives {mesh.reduce_bytes} bytes "
              f"over {it} iterations", flush=True)
        check(counts == want, f"dist LM at {n} shards: launches {counts}, "
              f"expected {want}")
        check(float(out[4]) < float(out[3]), "dist LM raised the cost")
        plain = dist_lm(prob, cam, cfg, n, dev, D.PLAIN)[0]
        truth = dist_lm(p64, cam, cfg, n, dev, D.PLAIN)[0]
        moved = [_rel_d(x, y) for x, y in zip(truth[:3], p64[:1] + p64[3:5])]
        f64_gauge(f"LM at {n} shards (poses, points, endpoints; bound "
                  "against how far it moved each)", out[:3], plain[:3],
                  truth[:3], moved, tag="dist")
        c = [x.to(dev) for x in cpu[n][:3]]
        for name, k, p_, t, cc, mv in zip(fields, out, plain, truth, c,
                                          moved):
            d_c = _rel_d(cc, t)
            bound = F64_FACTOR * _rel_d(p_, t) + d_c + F64_FLOOR
            print(f"[dist] LM at {n} shards, {name}: card from the CPU run "
                  f"{_rel_d(k, cc):.3g} (CPU from float64 {d_c:.3g}), bound "
                  f"{bound:.3g}, moved {mv:.3g}", flush=True)
            check(_rel_d(k, cc) <= bound and bound <= 0.1 * mv,
                  f"dist LM at {n} shards: {name} from the CPU run")
        for name, k, x0, x1 in zip(fields, out, prob[:1] + prob[3:5],
                                   single):
            direction(f"LM at {n} shards against run_lba, {name}' movement",
                      k - x0, x1 - x0)
        b = D.bucket_problem_by_owner(prob, n)
        smesh = make_mesh(n, ("lm",), dev)
        dxi, d_pt, _ = D.make_dist_lba_step(smesh, cam)(b.problem, lam)
        check(smesh.reduce_bytes == D.comm_bytes_per_step(W),
              f"dist: one step's collectives moved {smesh.reduce_bytes} "
              f"bytes, comm_bytes_per_step({W}) = "
              f"{D.comm_bytes_per_step(W)}")
        print(f"[dist] one step at {n} shards: collectives "
              f"{smesh.reduce_bytes} bytes = comm_bytes_per_step({W})",
              flush=True)
        # printed only: one step at lambda 1e-3 of this window, where a
        # tenth of the observations are detached, parts more from the
        # dense step than the LM's result does (d_pt's cos 0.978 in the
        # CPU run)
        direction(f"one step at {n} shards against the dense step, dxi",
                  dxi, dense[0], hold=False)
        direction(f"one step at {n} shards against the dense step, d_pt",
                  D.unbucket_landmarks(d_pt, b.pt_perm), dense[1], hold=False)


def dist_live_runs(dev):
    """(b) PLSLAM with mapping.distributed (4 shards) on
    tests/test_dist_lba.py:210's scene, against the single-device run and
    a 1-shard run: the same keyframes, ATE within max(1.5 x, + 1 cm) of
    the single-device run's, 4 shards within 1 mm of 1; (c) loop.distributed
    (4 shards) on tests/test_dist_vocab.py:104's loop scene: the loop
    events and keyframes of the single-device run, the trajectory within
    1 mm. Returns the launches of the 4-shard mapping run (the slice's
    main path)."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.backend.slam_system import PLSLAM
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    base = SlamConfig().with_updates(DIST_BASE)
    cam = StereoCamera.from_config(base.camera)
    seq = synthetic.make_sequence(cam, n_frames=25, seed=5, n_points=500,
                                  n_lines=0, noise=0.004, step=0.25)

    def run(cfg, s, n):
        slam = PLSLAM(cfg, cam, device=dev)
        slam.initialize(s.images_l[0], s.images_r[0])
        for i in range(1, n):
            slam.process(s.images_l[i], s.images_r[i])
        est = slam.finish()
        torch.cuda.synchronize()
        return est, slam
    est_1, s1 = run(base, seq, 25)
    native.reset_counts()
    t0 = time.perf_counter()
    est_d, sd = run(base.with_updates({"mapping": {
        "distributed": True, "dist_devices": 4}}), seq, 25)
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    est_d1, sd1 = run(base.with_updates({"mapping": {
        "distributed": True, "dist_devices": 1}}), seq, 25)
    kfs = [s._kf_slot + 1 for s in (s1, sd, sd1)]
    d = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
            for a, b in zip(est_d, est_d1))
    a1 = float(ate_rmse(est_1, seq.poses[:len(est_1)]))
    ad = float(ate_rmse(est_d, seq.poses[:len(est_d)]))
    n_lm = launches.get("lba_index", 0)
    it = base.mapping.lba_iters
    print(f"[dist] (b) PLSLAM mapping.distributed, 4 shards: 25 frames in "
          f"{wall:.2f} s host clock; keyframes {kfs} (single device, 4 "
          f"shards, 1 shard); ATE {ad:.6f} m against the single-device "
          f"{a1:.6f} m; 4 shards against 1: {d:.3g} m; {n_lm // 4} sharded "
          f"LMs; launches {launches}", flush=True)
    check(kfs[0] == kfs[1] == kfs[2], f"dist (b): keyframes {kfs}")
    check(d < 1e-3, f"dist (b): 4 shards {d} m from 1 shard")
    check(ad < max(1.5 * a1, a1 + 0.01), f"dist (b): ATE {ad} against {a1}")
    check(n_lm > 0 and n_lm % 4 == 0 and all(
        launches.get(k, 0) == it * n_lm for k in (
            "lba_camera", "lba_bin", "lba_schur_corr", "lba_solve_reduced"))
        and launches.get("lba_solve", 0) == 0,
        f"dist (b): launches {launches}")

    loop = SlamConfig().with_updates(DIST_LOOP)
    lseq = synthetic.make_sequence(cam, n_frames=40, seed=21, kind="loop",
                                   n_points=700, n_lines=0, noise=0.004,
                                   step=0.35)
    res = []
    for cfg in (loop, loop.with_updates({"loop": {"distributed": True,
                                                  "dist_devices": 4}})):
        est, slam = run(cfg, lseq, 40)
        lc = slam.loop_closer
        res.append((est, lc.n_loops_closed,
                    [(e.kf_from, e.kf_to) for e in lc.events],
                    slam._kf_slot + 1))
    d = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
            for a, b in zip(res[0][0], res[1][0]))
    print(f"[dist] (c) loop.distributed, 4 shards: loops {res[1][1]} "
          f"(single device {res[0][1]}), events {res[1][2]} "
          f"({res[0][2]}), keyframes {res[1][3]} ({res[0][3]}); "
          f"trajectories {d:.3g} m apart", flush=True)
    check(res[0][1] >= 1 and res[1][1:] == res[0][1:] and d < 1e-3,
          "dist (c): the sharded retrieval's run differs")
    dist_chunk_drivers(dev, cam, loop, lseq)
    return launches


def dist_chunk_drivers(dev, cam, loop, lseq):
    """(c) for the chunk drivers, which flush several keyframes' probes
    a settle (``on_probe_batches``, ``_handle_probe_result``):
    ``FusedPLSLAM`` at max_kfs 40 (a compaction, with a pressure
    eviction, between two settles) and ``ChunkedPLSLAM``, kf_batch 4,
    over the loop scene with and without loop.distributed (4 shards):
    the same loop events (slots, inliers), funnel counters, frame anchors
    and compactions, the trajectory within 1 mm, at least one closure
    and (fused) one compaction, and the sharded database's rows the bits
    of the host database's."""
    import torch
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM
    B, N = 4, lseq.images_l.shape[0]
    for cls, mk in ((FusedPLSLAM, 40), (ChunkedPLSLAM,
                                        loop.mapping.max_kfs)):
        cfg = loop.with_updates({"mapping": {"max_kfs": mk},
                                 "system": {"kf_batch": B}})
        res = []
        for c in (cfg, cfg.with_updates({"loop": {"distributed": True,
                                                  "dist_devices": 4}})):
            slam = cls(c, cam, device=dev)
            slam.initialize(lseq.images_l[0], lseq.images_r[0])
            t0 = time.perf_counter()
            for lo in range(1, N, B):
                slam.process_chunk(lseq.images_l[lo:lo + B],
                                   lseq.images_r[lo:lo + B])
            est = slam.finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            lc = slam.loop_closer
            res.append((est, [(e.kf_from, e.kf_to, e.n_inliers)
                              for e in lc.events],
                        (lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom,
                         lc.n_rej_unc, lc.n_rej_corr, lc.n_loops_closed,
                         len(lc.odo_edges), len(lc.covis_edges),
                         len(lc.loop_edges)),
                        [a for a, _ in slam._frame_anchor],
                        getattr(slam, "n_compactions", 0), wall))
        rows_equal = torch.equal(torch.cat(lc._dist.bows_p), lc.db.bows_p)
        d = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
                for a, b in zip(res[0][0], res[1][0]))
        print(f"[dist] (c) {cls.__name__} loop.distributed, 4 shards: "
              f"events {res[1][1]} ({res[0][1]}), funnel {res[1][2]} "
              f"({res[0][2]}), compactions {res[1][4]} ({res[0][4]}), "
              f"last KF slot {max(res[1][3])}; trajectories {d:.3g} m "
              f"apart; sharded rows = host rows: {rows_equal}; "
              f"{N - 1} frames in {res[1][5]:.2f} s ({res[0][5]:.2f} s) "
              "host clock", flush=True)
        check(res[1][1:5] == res[0][1:5] and d < 1e-3 and rows_equal,
              f"dist (c): {cls.__name__}'s sharded retrieval run differs")
        check(res[0][2][5] >= 1 and (cls is ChunkedPLSLAM or res[0][4] >= 1),
              f"dist (c): {cls.__name__} closed no loop or never compacted")


def dist_multiseq():
    """(d) plslam_multiseq --synthetic --distributed, 2 sessions of 40
    frames, 4 shards (mapping.dist_devices from a --config file), to its
    end."""
    import os
    import tempfile
    from plslam_tpu_torch.apps import plslam_multiseq
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dist.yaml")
        with open(path, "w") as f:
            f.write("mapping:\n  dist_devices: 4\n")
        t0 = time.perf_counter()
        rc = plslam_multiseq.main(["--synthetic", "--distributed",
                                   "--frames", "40", "--config", path])
    print(f"[dist] (d) plslam_multiseq --synthetic --distributed: exit {rc} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    check(rc == 0, "dist (d): plslam_multiseq --distributed failed")


def dist_multihost(dev):
    """(e) parallel/multihost_check.py in MULTIHOST_PROCS processes joined
    by gloo (two shards each, all on cuda:0), against the in-process
    4-shard mesh and the plain versions in float64: each output within 4x
    the larger of the in-process kernels' and plain version's distances
    from float64, plus F64_FLOOR (the cross-process sum adds the
    processes' partial sums: another f32 order); the collectives of its
    step, comm_bytes_per_step(W)."""
    import os
    import tempfile
    import torch
    from plslam_tpu_torch.convert import lba_problem_from_numpy
    from plslam_tpu_torch.parallel import dist_lba as D
    from plslam_tpu_torch.parallel import multihost_check as mh
    from plslam_tpu_torch.parallel.mesh import make_mesh
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "plslam_tpu_torch.parallel.multihost_check",
             "--rank", str(r), "--nprocs", str(MULTIHOST_PROCS), "--init",
             f"file://{os.path.join(tmp, 'rendezvous')}", "--out", tmp,
             "--local-shards", "2", "--backend", "gloo", "--device", "cuda"],
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(MULTIHOST_PROCS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            check(p.returncode == 0, f"dist (e): a rank failed:\n{log[-2000:]}")
        z = np.load(os.path.join(tmp, "rank0.npz"))
        wall = time.perf_counter() - t0
    n = int(z["n_shards"])
    one = mh.dist_step(make_mesh(n, ("lm",), dev), dev)
    tb = D.bucket_problem_by_owner(lba_problem_from_numpy(
        mh.make_problem_np(), dev), n)
    mk = lambda ops, p: D.make_dist_lba_step(
        make_mesh(n, ("lm",), dev), mh.camera(), ops=ops)(p, 1e-3)
    un = lambda o: [o[0], o[1][tb.pt_perm], o[2][tb.ep_perm]]
    plain = un(mk(D.PLAIN, tb.problem))
    truth = un(mk(D.PLAIN, _as_f64(tb.problem)))
    dists = []
    for name, got, o, p_, t in zip(("dxi", "d_pt", "d_ep"),
                                   (z["dxi"], z["d_pt"], z["d_ep"]), one,
                                   plain, truth):
        got, o = torch.from_numpy(got), torch.from_numpy(o)
        t = t.cpu()
        bound = 4 * max(_rel_d(o, t), _rel_d(p_.cpu(), t)) + F64_FLOOR
        d = (_rel_d(got, t), _rel_d(got, o))
        dists.append((name, d, bound))
        check(max(d) <= bound, f"dist (e): {name} {d} against {bound}")
    print(f"[dist] (e) multihost_check: {MULTIHOST_PROCS} processes x 2 "
          f"shards on cuda:0 (gloo, host copies), {wall:.1f} s; its step's "
          f"collectives {int(z['reduce_bytes'])} bytes; (from float64, from "
          f"the in-process {n}-shard mesh), bound: {dists}", flush=True)
    check(int(z["reduce_bytes"]) == D.comm_bytes_per_step(4),
          "dist (e): collectives")


def dist_phase(record) -> dict:
    """[dist]: the distributed back end on the card (``python3
    chip_smoke.py --dist``): (a) K15's launches on the shards and the
    sharded LM (``dist_kernel_holds``, ``dist_lm_phase``), (b) and (c)
    the live mapping.distributed and loop.distributed runs
    (``dist_live_runs``), (d) ``dist_multiseq``, (e) ``dist_multihost``.
    Returns the launches of (b)'s 4-shard run."""
    import torch
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    prob = lba_window_problem(dev, cfg, cam)
    for n in DIST_SHARDS:
        dist_kernel_holds(dev, record, cfg, cam, prob, n)
    dist_lm_phase(dev, cfg, cam, prob)
    print(f"[dist] (a) {time.perf_counter() - t0:.1f} s", flush=True)
    launches = dist_live_runs(dev)
    dist_multiseq()
    dist_multihost(dev)
    print(f"[dist] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def dist_child(record, runs) -> None:
    """``dist_phase`` in a process of its own (``python3 chip_smoke.py
    --dist``), so that its launches leave this process's profiler records
    alone; its output passes through, its kernel rows join ``record``'s
    and its main-path launches join ``runs``; its failure fails the
    run."""
    import os
    from collections import Counter
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--dist"],
        cwd=here, capture_output=True, text=True, timeout=900)
    lines = out.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(out.returncode == 0, "the dist phase failed: "
          + out.stderr.strip()[-2000:])
    res = json.loads(lines[-1])
    record.rows.extend(res["rows"])
    runs.append((Counter(res["launches"]),))


# -- [vocab]: the vocabulary trainer on the card's front end ------------------

# scenes of each family whose card corpus is held to the CPU's
VOCAB_CHECK_SCENES = 4
# tests/test_vocab_quality.py's assertions: the share of leaves at the
# largest idf (empty or singleton), the idf spread, held-out revisits found
VOCAB_STARVING, VOCAB_SPREAD, VOCAB_REVISITS, VOCAB_HITS = 0.20, 1.0, 20, 19


def vocab_quality(voc_p, voc_l, revisits, tag) -> None:
    """tests/test_vocab_quality.py's assertions on an ORB and an LBD
    vocabulary: starving leaves < 20% and an idf spread > 1 in each, and
    the held-out revisits (``revisits``: the BoW inputs of frames 0 and 5
    of 20 unseen scenes) found top-1 at least 19 times with the ORB one."""
    import torch
    from plslam_tpu_torch.loop import vocabulary as V
    for kind, voc in (("orb", voc_p), ("lbd", voc_l)):
        idf = voc.idf.cpu().numpy()
        starving = float(np.mean(idf >= idf.max() - 1e-6))
        spread = float(idf.max() - idf.min())
        print(f"[vocab] {tag} {kind}: starving leaves {starving * 100:.2f}% "
              f"(< {VOCAB_STARVING * 100:.0f}%), idf spread {spread:.3f} "
              f"(> {VOCAB_SPREAD})", flush=True)
        check(starving < VOCAB_STARVING and spread > VOCAB_SPREAD,
              f"[vocab] {tag} {kind}: starving {starving}, spread {spread}")
    visits = torch.stack([V.bow_vector(voc_p, d, v) for d, v in revisits[0]])
    hits = sum(int(torch.argmax(V.l1_score(visits, V.bow_vector(
        voc_p, d, v)[None])) == s) for s, (d, v) in enumerate(revisits[1]))
    print(f"[vocab] {tag}: held-out revisits top-1 {hits}/{VOCAB_REVISITS} "
          f"(>= {VOCAB_HITS})", flush=True)
    check(hits >= VOCAB_HITS, f"[vocab] {tag}: revisits {hits}")


# tests/test_vocab_quality.py's configuration of the held-out scenes
VOCAB_REVISIT_CFG = {
    "camera": {"width": 512, "height": 320, "fx": 400.0, "fy": 400.0,
               "cx": 256.0, "cy": 160.0, "baseline": 0.3},
    "points": {"max_kpts": 512, "orb_nlevels": 3}}


def render_revisit(s: int) -> np.ndarray:
    """Frames 0 and 5 of held-out scene ``s`` (seed 5000 + s), (2, 320,
    512) float32."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cam = StereoCamera.from_config(
        SlamConfig().with_updates(VOCAB_REVISIT_CFG).camera)
    seq = synthetic.make_sequence(
        cam, n_frames=6, seed=5000 + s, n_points=250, n_lines=40,
        step=0.25, degrade=synthetic.Degradation(texture=0.06, noise=0.012))
    return np.asarray(seq.images_l[[0, 5]], np.float32)


def vocab_revisits(dev):
    """tests/test_vocab_quality.py's held-out scenes (512x320, seeds
    5000+, 6 frames; rendered by 8 processes) through the port's ORB front
    end on the card: (frame 0's, frame 5's) (desc, valid) a scene."""
    import torch
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.frontend.stereo_points import detect_and_describe
    from plslam_tpu_torch.loop.vocabulary import render_pool
    cfg = SlamConfig().with_updates(VOCAB_REVISIT_CFG)
    out = ([], [])
    pool = render_pool(8)
    try:
        frames = pool.map(render_revisit, range(VOCAB_REVISITS))
    finally:
        pool.terminate()
        pool.join()
    for f in frames:
        imgs = torch.from_numpy(f).to(dev)
        _, desc, _, _, _, valid = detect_and_describe(imgs, cfg)
        for i in range(2):
            out[i].append((desc[i], valid[i]))
    return out


def _sha(*arrays) -> str:
    """The first 16 hex digits of the SHA-256 of the arrays' bytes."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def vocab_phase() -> None:
    """[vocab] (``python3 chip_smoke.py --vocab``): the first
    VOCAB_CHECK_SCENES scenes of each family's corpus described on the card
    and on the CPU (equal row counts, >= 99.98% of bits equal; ORB
    predicted bit-equal); both vocabularies trained at the reference's
    full corpus (120 ORB, 400 LBD scenes; rendered by 8 processes) into a
    temporary directory; tests/test_vocab_quality.py's assertions on them
    and on the tracked artifacts; whether the ORB artifact is byte-equal to
    the tracked one (predicted, not held; else the first differing level
    and row)."""
    import os
    import tempfile
    import torch
    from plslam_tpu_torch.loop import vocabulary as V
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for kind in ("orb", "lbd"):
        card = V.build_default_corpus(kind, VOCAB_CHECK_SCENES, device=dev)
        cpu = V.build_default_corpus(kind, VOCAB_CHECK_SCENES, device="cpu")
        frac = (float((card == cpu).mean()) if card.shape == cpu.shape
                else 0.0)
        print(f"[vocab] {kind}: {VOCAB_CHECK_SCENES} scenes, card "
              f"{card.shape[0]} rows, CPU {cpu.shape[0]}; bits equal "
              f"{frac:.6f}; bit-equal {card.shape == cpu.shape and frac == 1}",
              flush=True)
        check(card.shape == cpu.shape and frac >= 0.9998,
              f"[vocab] {kind}: the card's corpus differs from the CPU's")
    revisits = vocab_revisits(dev)
    tracked = [V.load_vocabulary(V.default_path(k), dev)
               for k in ("orb", "lbd")]
    vocab_quality(*tracked, revisits, "tracked")
    with tempfile.TemporaryDirectory() as tmp:
        vocs = []
        for kind in ("orb", "lbd"):
            t1 = time.perf_counter()
            desc = V.build_default_corpus(kind, device=dev, workers=8)
            t2 = time.perf_counter()
            voc = V.build_vocabulary(desc, k=10, levels=4, seed=1,
                                     device=dev)
            path = os.path.join(tmp, os.path.basename(V.default_path(kind)))
            V.save_vocabulary(voc, path)
            idf = voc.idf.cpu().numpy()
            z = np.load(path)
            print(f"[vocab] {kind}: corpus {desc.shape[0]} descriptors "
                  f"({t2 - t1:.1f} s, sha256 {_sha(desc)}), trained in "
                  f"{time.perf_counter() - t2:.1f} s; idf [{idf.min():.2f}, "
                  f"{idf.max():.2f}] median {np.median(idf):.2f}; the "
                  f"artifact's arrays' sha256 "
                  f"{_sha(*(z[k] for k in sorted(z.files)))}", flush=True)
            vocs.append(V.load_vocabulary(path, dev))
            if kind == "orb":
                same = (open(path, "rb").read()
                        == open(V.default_path(kind), "rb").read())
                where = ""
                if not same:
                    a, b = np.load(path), np.load(V.default_path(kind))
                    rows = {}
                    for key in [f"level_{i}" for i in range(4)] + ["idf"]:
                        d = np.nonzero(np.any((a[key] != b[key]).reshape(
                            len(a[key]), -1), -1))[0]
                        rows[key] = (f"{len(d)} rows, the first {d[0]}"
                                     if len(d) else "equal")
                    where = f"; differing rows by key {rows}"
                print(f"[vocab] orb: artifact byte-equal to the tracked "
                      f"one: {same}{where}", flush=True)
        vocab_quality(*vocs, revisits, "trained")
    print(f"[vocab] phase {time.perf_counter() - t0:.1f} s", flush=True)


def vocab_child() -> float:
    """``vocab_phase`` in a process of its own; its output passes
    through, its failure fails the run. Returns its seconds."""
    import os
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "chip_smoke.py"), "--vocab"],
        cwd=here, capture_output=True, text=True, timeout=900)
    print(out.stdout.strip(), flush=True)
    check(out.returncode == 0, "the vocab phase failed: "
          + out.stderr.strip()[-2000:])
    return time.perf_counter() - t0


LOOP_SCENE = None


def main() -> int:
    if sys.argv[1:2] == ["--cpu-ate"]:
        cpu_reference_ate(sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--bench-slam"]:
        bench_slam_scene(sys.argv[2:] or ["cuda"])
        return 0
    if sys.argv[1:2] == ["--against"]:
        against(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--against-side"]:
        against_side(*sys.argv[2:5])
        return 0
    if sys.argv[1:2] == ["--against-solves"]:
        solve_calls(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--pose-graph"]:
        from plslam_tpu_torch import native
        import torch
        native.lib()
        record = Recorder()
        pose_graph_phase(torch.device("cuda", 0), record)
        print(json.dumps(record.rows))
        return 0
    if sys.argv[1:2] == ["--dist"]:
        from plslam_tpu_torch import native
        native.lib()
        record = Recorder()
        launches = dist_phase(record)
        print(json.dumps({"rows": record.rows, "launches": launches}))
        return 0
    if sys.argv[1:2] == ["--vocab"]:
        vocab_phase()
        return 0
    if sys.argv[1:2] == ["--chunk-device-times"]:
        chunk_device_times()
        return 0
    if sys.argv[1:2] == ["--edge-grids"]:
        edge_sweep_grids()
        return 0
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from plslam_tpu_torch import native

    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {name} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)

    # the knob band's frames render on the host while the card works
    knob_render = start_knob_render()

    # 2. build
    native.lib()
    print(f"[build] kernels built in {native.BUILD_SECONDS or 0.0:.1f} s "
          f"(nvcc, sm_90a, {len(native.SOURCES)} sources in parallel)",
          flush=True)

    # 3. kernels at main-path shapes, on a line scene's 40 images
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=20, seed=1, n_points=500,
                                  n_lines=60, noise=0.003, step=0.25)
    images = torch.from_numpy(np.concatenate(
        [seq.images_l, seq.images_r])).to(dev)
    record = Recorder()
    kernel_phase(images, record)
    line_kernel_phase(images, cfg, record)
    del images
    slam_kernel_phase(dev, record)

    # 4. the flagship VO path, the points-only path, card-vs-CPU agreement
    # on small scenes, then the SLAM path and K15 on its final map
    main_path(dev, lines=True)
    main_path(dev, lines=False)
    small_agreement(dev)
    small_line_agreement(dev)
    launches, slam = slam_path(dev)
    lba_phase(dev, record, slam)
    del slam

    # 5. the loop path: the default SlamConfig() (lazy floors), then, if no
    # closure cleared the floors, with the graph solve at every closure;
    # L, D, K7 and M at the path's shapes; then the path with the PCG solver
    global LOOP_SCENE
    LOOP_SCENE = loop_scene()
    runs = [loop_path(dev, "loop", cpu=LOOP_CPU.get("default"))]
    solve = {}
    if not runs[0][2].get("optimize_pose_graph"):
        solve = SOLVE_ALWAYS
        runs.append(loop_path(dev, "loop_solve", solve,
                              cpu=LOOP_CPU.get("solve")))
    loop_kernel_phase(dev, record, runs[0][1])
    runs.append(loop_path(dev, "loop_pcg", pcg_updates(solve),
                          cpu=LOOP_CPU.get("pcg")))
    # the loop path checkpointed and resumed, then compaction with pressure
    # eviction and closures held to the CPU run
    print(f"[checkpoint] phase {checkpoint_phase(dev, runs[0][1]):.1f} s",
          flush=True)
    print(f"[compact] phase {compact_phase(dev):.1f} s", flush=True)
    # the per-frame and host-KF drivers (the mapping worker), two sessions
    # through run_concurrent, the north star's band on the knob scene
    print(f"[slam_system] phase {slam_system_phase(dev):.1f} s", flush=True)
    print(f"[multiseq] phase {multiseq_phase(dev):.1f} s", flush=True)
    # the distributed back end and the vocabulary trainer, each in a
    # process of its own
    dist_child(record, runs)
    print(f"[vocab] child {vocab_child():.1f} s", flush=True)
    print(f"[knob_band] phase {knob_band_phase(dev, knob_render):.1f} s",
          flush=True)

    # 6. the dataset paths: the VO app over a KITTI-layout directory, the
    # EuRoC-layout raw rig through host and device rectification, N; the
    # SLAM app over the KITTI-layout directory
    runs.append((dataset_path(dev, record),))
    lc_debug_rerun(dev)
    # 6a. the lines-only configuration and scan mode on the main paths'
    # frames; after every phase that reads torch.profiler, which keeps
    # fewer device records the more a process has launched
    print(f"[lines_only] phase {lines_only_phase(dev):.1f} s", flush=True)
    print(f"[scan] phase {scan_phase(dev):.1f} s", flush=True)
    # 6b. the fused SLAM driver past max_kfs: 4,001 frames at full width
    print(f"[long] phase {long_phase(dev):.1f} s", flush=True)
    entries = set(r["entry"] for r in record.rows)
    check(entries == set(native._SIGNATURES),
          f"kernels not checked: {set(native._SIGNATURES) - entries}")

    # 7. results: launches from the first path run that launched each
    # kernel (the loop path's default run launches A-L; the dense and PCG
    # graph solves may need the later runs; N the device-rectified dataset
    # run)
    rows = record.rows
    for r in rows:
        r["launches"] = next((run[0][r["count"]] for run in runs
                              if run[0].get(r["count"])), 0)
        if r["before"]:
            check(r["launches"] == 0, f"{r['entry']}, replaced, still "
                  "launches on a path")
        elif r["no_path_caller"]:
            check(r["launches"] == 0, f"{r['count']}: a path launches it")
        else:
            check(r["launches"] > 0, f"{r['entry']} never launched on a path")
    print(f"[chip_smoke] the whole script {time.perf_counter() - t_start:.1f}"
          " s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
