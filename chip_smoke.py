#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (plslam_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card: name, count, ``nvidia-smi`` name and power limit;
  2. build the hand-written CUDA kernels from ``plslam_tpu_torch/csrc``;
  3. every kernel, in every mode the main path launches it, at the main
     path's shapes, compared with its plain PyTorch version on the same
     inputs on the card, timed with CUDA events, beside its bound, its
     plain version's time and a one-call library yardstick: A-D on
     KITTI-size images (376x1241, 40 images a chunk; K=1024; B=20 x 1024
     x 1024), then the line kernels on a rendered line scene, each fed by
     the one before: E, F and G at both scales of the detector (the 40
     images, then their 188x620 halves), E's gradients-only mode and H on
     the half-res maps and the path's segments, and D at the line path's
     B=20 x 128 x 128;
  4. the main path: the flagship point+line chunked VO
     (``BatchedStereoVO``) at the full width of the default
     ``SlamConfig()`` on bench.py's scene (seed 0, 500 points, 60 lines,
     step 0.25): a warm-up chunk, then initialize + 2 chunks of 20 frames,
     every frame tracked, ATE within its bound, stereo lines and line
     inliers in every frame of that run, each kernel launched exactly as
     often as the path launches it; then the points-only path
     (``lines.has_lines=False``) the same way; then the port on the card
     against its CPU run on two small scenes (points; points + lines);
  5. one JSON line of the kernels, then the card line, then the result.

``python3 chip_smoke.py --cpu-ate`` runs the main paths' frames through
the plain versions on the CPU: the calibration of the ATE and line-count
bounds below.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM f32, outside the tensor cores

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


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    import torch
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
                 err_kind="absolute"):
        """``tol`` is one tolerance for every output, or a list of one per
        output (``err_kind`` then names the unit of each)."""
        tols = list(tol) if isinstance(tol, (list, tuple)) else [tol] * len(got)
        errs = [max_abs_err(g, p) for g, p in zip(got, plain)]
        err = max(errs)
        ok = all(e <= t for e, t in zip(errs, tols))
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain_fn, max(iters // 4, 3))
        lib_ms = cuda_ms(library_fn, iters) if library_fn else None
        b_ms, b_by = bound(nbytes, ops)
        self.rows.append(dict(
            name=name, entry=entry or name, route="cuda", source=source,
            replaces=replaces, max_abs_err=err, errs=errs, tols=tols,
            err_kind=err_kind, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, ok=ok))
        print(f"[kernel] {name}: max_abs_err={err:g} per output "
              f"{[f'{e:g}' for e in errs]} ({err_kind}; tol "
              f"{[f'{t:g}' for t in tols]}) kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'}",
              flush=True)
        check(ok, f"{name} disagrees with its plain version: {errs} > {tols}")


def kernel_phase(images, record):
    """Kernels A-D at the points path's shapes against their plain
    versions."""
    import torch
    import torch.nn.functional as F
    from plslam_tpu_torch.ops import fast, hamming, image, orb

    dev = images.device
    N, H, W = images.shape                          # 40 x 376 x 1241
    npx = N * H * W

    # Bounds: bytes count each input read once and each output written
    # once; operations count f32 flops (and integer ops) at 67 TFLOP/s.
    # A: gaussian blur (7 taps) of level 0, and level 0 -> level 1 resize;
    # 2 passes x 7 taps x (mul + add) per pixel
    k = image.gaussian_kernel1d(1.0, 3)
    out = image.separable_filter2d(images, k, k)
    ref = image.separable_filter2d_plain(images, k, k)
    k2d = torch.from_numpy(np.outer(k, k)).to(dev)[None, None]
    record("image_sep_filter", "plslam_tpu_torch/csrc/image.cu",
           "plslam_tpu/ops/image.py:71", [out], [ref], 1e-6,
           lambda: image.separable_filter2d(images, k, k),
           lambda: image.separable_filter2d_plain(images, k, k),
           2 * npx * 4, 2 * npx * 7 * 2,
           lambda: F.conv2d(F.pad(images[:, None], (3, 3, 3, 3),
                                  mode="replicate"), k2d))
    h1, w1 = round(H / 1.2), round(W / 1.2)
    out = image.resize_bilinear(images, (h1, w1))
    ref = image.resize_bilinear_plain(images, (h1, w1))
    record("image_resize", "plslam_tpu_torch/csrc/image.cu",
           "plslam_tpu/ops/image.py:86", [out], [ref], 1e-6,
           lambda: image.resize_bilinear(images, (h1, w1)),
           lambda: image.resize_bilinear_plain(images, (h1, w1)),
           (npx + N * h1 * w1) * 4, 3 * (N * h1 * W + N * h1 * w1),
           lambda: F.interpolate(images[:, None], size=(h1, w1),
                                 mode="bilinear", align_corners=False))

    # B: FAST score on the blurred level 0 (~300 ops per pixel: 16 taps x
    # 15, four arc tests of ~18), then NMS + block max/argmax (~40
    # compares per pixel)
    lvl0 = image.separable_filter2d(images, k, k)
    th_hi, th_lo = float(np.float32(20 / 255.0)), float(np.float32(7 / 255.0))
    got = fast.fast_score_map2(lvl0, th_hi, th_lo)
    ref = fast.fast_score_map2_plain(lvl0, th_hi, th_lo)
    record("fast_score", "plslam_tpu_torch/csrc/fast.cu",
           "plslam_tpu/ops/fast.py:70", list(got), list(ref), 0.0,
           lambda: fast.fast_score_map2(lvl0, th_hi, th_lo),
           lambda: fast.fast_score_map2_plain(lvl0, th_hi, th_lo),
           npx * (4 + 1 + 1 + 4), npx * 300)
    chi, clo, score = got
    cell_h, cell_w = fast._grid_dims(H, W, 8, 16)
    Hb, Wb = cell_h * 8 // 8, cell_w * 16 // 8      # 8 x 16 cells
    got = fast.nms_block_max(score, chi, clo, 5, 16, Hb, Wb)
    ref = fast.nms_block_max_plain(score, chi, clo, 5, 16, Hb, Wb)
    record("fast_nms_block", "plslam_tpu_torch/csrc/fast.cu",
           "plslam_tpu/ops/fast.py:110", list(got), list(ref), 0.0,
           lambda: fast.nms_block_max(score, chi, clo, 5, 16, Hb, Wb),
           lambda: fast.nms_block_max_plain(score, chi, clo, 5, 16, Hb, Wb),
           npx * (4 + 1 + 1) + N * Hb * Wb * 20, npx * 40)

    # C: pool gather + pair tests for K=1024 keypoints on 4 levels: 64
    # samples, 3 ints in, 256 bit bytes out, 256 compares and selects
    levels = image.build_pyramid(images, 4, 1.2)
    flat = torch.cat([lv.reshape(N, -1) for lv in levels], dim=1)
    K = 1024
    g = torch.Generator(device="cpu").manual_seed(0)
    octv = torch.randint(0, 4, (N, K), generator=g)
    shapes = [lv.shape[-2:] for lv in levels]
    base = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
    fW = torch.tensor([s[1] for s in shapes])[octv]
    fH = torch.tensor([s[0] for s in shapes])[octv]
    u = (torch.rand((N, K), generator=g) * (fW - 31)).long() + 15
    v = (torch.rand((N, K), generator=g) * (fH - 31)).long() + 15
    center = (torch.tensor(base)[octv] + v * fW + u).to(torch.int32).to(dev)
    width = fW.to(torch.int32).to(dev)
    bins = torch.randint(0, 32, (N, K), generator=g).to(torch.int32).to(dev)
    got = orb.pool_bits(flat, center, width, bins)
    ref = orb.pool_bits_plain(flat, center, width, bins)
    record("orb_describe", "plslam_tpu_torch/csrc/orb.cu",
           "plslam_tpu/ops/orb.py:131", [got], [ref], 0.0,
           lambda: orb.pool_bits(flat, center, width, bins),
           lambda: orb.pool_bits_plain(flat, center, width, bins),
           N * K * (64 * 4 + 12 + 256), N * K * 256 * 2)

    # D: 20 frame pairs of 1024 x 1024 descriptors with a window mask;
    # per entry 8 x (xor, popc, add), one mask byte in, 4 bytes out
    hamming_case(record, g, dev, B=20, M=1024, radius=160.0, name="")

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


def hamming_case(record, g, dev, B, M, radius, name, angle_mask=False):
    """Kernel D (both launches) on B pairs of M x M descriptors."""
    import torch
    from plslam_tpu_torch.ops import hamming
    bits_a = torch.randint(0, 2, (B, M, 256), generator=g, dtype=torch.uint8)
    flip = torch.rand((B, M, 256), generator=g) < 0.05
    va = torch.rand((B, M), generator=g) > 0.1
    vb = torch.rand((B, M), generator=g) > 0.1
    perm = torch.randperm(M, generator=g)
    bits_b = bits_a[:, perm] ^ flip.to(torch.uint8)
    pos_a = torch.rand((B, M, 2), generator=g) * torch.tensor([1241., 376.])
    pos_b = pos_a[:, perm] + torch.randn((B, M, 2), generator=g) * 20
    bits_a, bits_b, va, vb = (x.to(dev) for x in (bits_a, bits_b, va, vb))
    mask = hamming.window_mask(pos_a.to(dev), pos_b.to(dev), radius)
    if angle_mask:
        # the line path's undirected angle gate (dang < 0.3)
        from plslam_tpu_torch.frontend.stereo_lines import pair_dang
        ang_a = torch.rand((B, M), generator=g) * math.pi - math.pi / 2
        ang_b = (ang_a[:, perm] + torch.randn((B, M), generator=g) * 0.05)
        mask = mask & (pair_dang(ang_a, ang_b) < 0.3).to(dev)
    dist = hamming.hamming_matrix(bits_a, bits_b, va, vb, mask)
    ref = hamming.hamming_matrix_plain(bits_a, bits_b, va, vb, mask)
    fa, fb = bits_a.float(), bits_b.float()
    record("hamming_dist" + name, "plslam_tpu_torch/csrc/hamming.cu",
           "plslam_tpu/ops/hamming.py:30", [dist], [ref], 0.0,
           lambda: hamming.hamming_matrix(bits_a, bits_b, va, vb, mask),
           lambda: hamming.hamming_matrix_plain(bits_a, bits_b, va, vb, mask),
           B * M * M * (1 + 4) + 2 * B * M * 256, B * M * M * 24,
           lambda: torch.cdist(fa, fb, p=0), entry="hamming_dist")
    max_d, ratio = (90, 0.9) if angle_mask else (80, 0.75)
    got = hamming.match_nnr(dist, max_d, ratio)
    ref = hamming.match_nnr_plain(dist, max_d, ratio)
    check(int(ref.valid.sum()) > B * M // 20, f"too few matches in D{name}")
    record("hamming_match" + name, "plslam_tpu_torch/csrc/hamming.cu",
           "plslam_tpu/ops/hamming.py:57", list(got), list(ref), 0.0,
           lambda: hamming.match_nnr(dist, max_d, ratio),
           lambda: hamming.match_nnr_plain(dist, max_d, ratio),
           B * M * M * 4 + B * M * 9, B * M * M * 4, entry="hamming_match")


def _rel_maps(got, ref):
    """Maps scaled by each reference map's largest magnitude."""
    scales = [r.abs().max().clamp(min=1e-30) for r in ref]
    return ([g / s for g, s in zip(got, scales)],
            [r / s for r, s in zip(ref, scales)])


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

    # E launch 1: Sobel + support planes; ~25 flops per pixel, 1 plane in,
    # 3 out. Library: F.conv2d of the two 3x3 Sobel kernels (gx, gy only)
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
           entry="lines_sobel")
    w, d2x, d2y = ref

    # E launch 2, orientation pass: window sums of the two double-angle
    # planes; 2 adds per pixel and plane, 4 per window. Library: a grouped
    # F.conv2d(stride=s) with 2s x 2s kernels of ones
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
           entry="lines_moments", err_kind=rel)

    # E launch 2, the reweighted pass: ~8 flops for the ratio and 8
    # multiply-adds per pixel. Library: F.conv2d(stride=s) of the three
    # planes with eight 2s x 2s window-local coordinate kernels
    D2x, D2y = ref
    d2n = torch.sqrt(D2x * D2x + D2y * D2y) + 1e-9
    u = (D2x / d2n, D2y / d2n)
    got = lines.reweighted_moments(w, d2x, d2y, *u, tile, s)
    ref = lines.reweighted_moments_plain(w, d2x, d2y, *u, tile, s)
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
    record("lines_moments" + tag, src_t, "plslam_tpu/ops/lines.py:84",
           g_rel, r_rel, 1e-5,
           lambda: lines.reweighted_moments(w, d2x, d2y, *u, tile, s),
           lambda: lines.reweighted_moments_plain(w, d2x, d2y, *u, tile, s),
           npx * 12 + nt * 4 * 10, npx * 24 + nt * 40,
           lambda: F.conv2d(planes, wk, stride=s),
           entry="lines_moments", err_kind=rel)
    S = ref

    # F: labels on the gated tiles; 4 forward tests (~12 ops each) and
    # merge_iters sweeps of 8 neighbour reads + a hop per tile
    iters = kw["merge_iters"]
    ang_th, dist_th = kw["merge_ang_th"], kw["merge_dist_th"]
    gates = lines.tile_gates(*S, tile, kw["min_support"], kw["elong_th"],
                             kw["perp_spread_th"], kw["coherence_th"])
    targs = gates[:6]
    lab = lines.propagate_labels(*targs, ang_th, dist_th, iters)
    lab_ref = lines.propagate_labels_plain(*targs, ang_th, dist_th, iters)
    n_ok = int(targs[0].sum())
    check(n_ok >= min_ok_per_image * N, f"too few gated-in tiles{tag}: {n_ok}")
    record("lines_label" + tag, src_l, "plslam_tpu/ops/lines.py:320",
           [lab], [lab_ref], 0.0,
           lambda: lines.propagate_labels(*targs, ang_th, dist_th, iters),
           lambda: lines.propagate_labels_plain(*targs, ang_th, dist_th,
                                                iters),
           nt * (1 + 5 * 4 + 4), nt * (4 * 12 + iters * 10),
           entry="lines_label")

    # G launch 1: refit of the top-R roots; work is the walks over the
    # labels of the real roots (2 compares per tile each) and the members'
    # 7-float sums and projections. Endpoints in px: the image-centre
    # moments cancel in f32, so summation order moves them by ~0.01 px;
    # scores (support masses) relative to the largest
    ts = lines.TileStage(lab_ref, gates[0], *S[:6], gates[2], gates[3],
                         gates[6], gates[7], gates[8])
    len_th = min(0.75 * tile + s, kw["min_length"])
    rargs = lines.refit_inputs(ts, H, W, kw["max_lines"])
    got = lines.refit(*rargs, H, W, len_th)
    ref = lines.refit_plain(*rargs, H, W, len_th)
    root_id, lab_f = rargs[0], rargs[1]
    R, n = root_id.shape[1], lab_f.shape[1]
    n_roots = int((root_id >= 0).sum())
    n_members = int((lab_f < n).sum())
    seg = ref[2] > 0
    check(torch.equal(got[2] > 0, seg), f"refit{tag}: kernel and plain "
          "disagree on which root slots are segments")
    smax = ref[2].abs().max()
    record("lines_refit" + tag, src_s, "plslam_tpu/ops/lines.py:474",
           [got[0][seg], got[1][seg], got[2] / smax],
           [ref[0][seg], ref[1][seg], ref[2] / smax], [0.05, 0.05, 1e-5],
           lambda: lines.refit(*rargs, H, W, len_th),
           lambda: lines.refit_plain(*rargs, H, W, len_th),
           N * n * (4 + 7 * 4 + 3 * 4) + N * R * (4 + 5 * 4),
           2 * n * n_roots + 20 * n_members, entry="lines_refit",
           err_kind="sp, ep in px; score relative to the largest")

    # G launch 2: merge of the 2 * max_lines candidates; M^2 pair tests
    # (~15 ops), iters x M^2 label reads, 2 M^2 refit walks per image
    top_s, top_i = lines.top_k(ref[2], 2 * kw["max_lines"])
    sp_c, ep_c = lines.take(ref[0], top_i), lines.take(ref[1], top_i)
    valid_c = top_s > 0
    M = sp_c.shape[1]
    margs = (sp_c, ep_c, top_s, valid_c, 2.0 * ang_th, dist_th,
             kw["merge_gap_th"])
    got = lines.merge_segments(*margs)
    table = lines._segment_table(sp_c, ep_c, top_s, valid_c)
    ref = lines.merge_plain(table, valid_c, *margs[4:], 8)
    root = ref[4]
    check(int(root.sum()) >= N, f"too few merged segments{tag}")
    record("lines_merge" + tag, src_s, "plslam_tpu/ops/lines.py:214",
           [got[4], got[5], got[0][root], got[1][root], got[2][root]],
           [ref[4], ref[5], ref[0][root], ref[1][root], ref[2][root]],
           [0.0, 0.0, 1e-2, 1e-2, 1e-2],
           lambda: lines.merge_segments(*margs),
           lambda: lines.merge_plain(table, valid_c, *margs[4:], 8),
           N * M * (13 * 4 + 1) + N * M * (4 * 4 + 4 + 4 + 1 + 4),
           N * M * M * (15 + 8 + 4), entry="lines_merge",
           err_kind="roots, labels exact; sp, ep in px; angle in rad")
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

    # E launch 1 without the planes: LBD's half-res gradients, ~10 flops
    # per pixel, 1 plane in, 2 out
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
           entry="lines_sobel")

    # H: LBD bits of the path's (fused) segments on the half-res
    # gradients; 432 samples x ~45 flops, 36 band sums of 48, 256
    # compares per segment
    segs, _ = stereo_lines.detect_and_describe_lines(images, cfg)
    sp_h, ep_h = segs.sp * 0.5, segs.ep * 0.5
    bw = max(l.lbd_band_width // 2, 3)
    largs = (gx, gy, sp_h, ep_h, l.lbd_bands, bw, l.lbd_samples,
             l.lbd_band_samples)
    got = lbd.describe_lines(*largs)
    ref = lbd.describe_lines_plain(*largs)
    L = sp_h.shape[1]
    n_seg = N * L
    n_samp = l.lbd_samples * l.lbd_bands * l.lbd_band_samples
    record("lbd_describe", "plslam_tpu_torch/csrc/lbd.cu",
           "plslam_tpu/ops/lbd.py:51", [got], [ref], 0.0,
           lambda: lbd.describe_lines(*largs),
           lambda: lbd.describe_lines_plain(*largs),
           2 * nsm * 4 + n_seg * (16 + 256),
           n_seg * (n_samp * 45 + 4 * l.lbd_bands * 48 * 2 + 256))
    print(f"[lines] segments after the fusion of the two scales "
          f"{int(segs.valid.sum())} over {N} images", flush=True)

    # D at the line path's shapes: 20 pairs x 128 x 128 with the f2f
    # window and angle masks
    g = torch.Generator(device="cpu").manual_seed(5)
    hamming_case(record, g, images.device, B=20, M=2 * 64, radius=160.0,
                 name="@128", angle_mask=True)


CHUNK = 20


def main_scene(lines: bool):
    """bench.py's scene at full KITTI width: the main paths."""
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
# levels (2 filters each), FAST on 4 levels, one stereo match each of
# points and lines; the line detector at 2 scales, each 2 Sobel/moment
# launches, labels, refit and merge, the half-res resize and LBD's
# gradients) and in one chunk's tracking (chunk_passes=2: two f2f matches
# of points and, with lines, two of lines). The main path's timed run,
# initialize + 2 chunks, is 3 extractions and 2 trackings.
EXTRACT_POINTS = {"image_sep_filter": 12, "image_resize": 7, "fast_score": 4,
                  "fast_nms_block": 4, "orb_describe": 1, "hamming_dist": 1,
                  "hamming_match": 1}
EXTRACT_LINES = {"image_resize": 1, "lines_sobel": 3, "lines_moments": 4,
                 "lines_label": 2, "lines_refit": 2, "lines_merge": 2,
                 "lbd_describe": 1, "hamming_dist": 1, "hamming_match": 1}
TRACK = {"hamming_dist": 2, "hamming_match": 2}


def expected_launches(lines: bool) -> dict:
    """Each kernel's launches in the main path's timed run."""
    from collections import Counter
    n = Counter()
    for table, times in ((EXTRACT_POINTS, 3), (TRACK, 2),
                         (EXTRACT_LINES if lines else {}, 3),
                         (TRACK if lines else {}, 2)):
        for k, v in table.items():
            n[k] += v * times
    return dict(n)


def run_counts(outs):
    """Per-frame inliers, stereo lines and line inliers of chunk outputs
    (host arrays; stereo lines None on the points-only path)."""
    import torch
    cat = lambda f: torch.cat([getattr(o, f) for o in outs]).cpu().numpy()
    return (cat("n_inliers"),
            cat("n_lines") if outs[0].n_lines is not None else None,
            cat("n_line_inliers"))


def cpu_reference_ate() -> None:
    """The main paths' scenes through the port's plain versions on the
    CPU: the calibration run of the ATE and line-count bounds."""
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    for lines in (True, False):
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


def main() -> int:
    if sys.argv[1:] == ["--cpu-ate"]:
        cpu_reference_ate()
        return 0
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    try:
        from plslam_tpu_torch import native
    except ImportError as e:
        print(f"FAIL: run from the repository root ({e})", file=sys.stderr)
        return 2

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
    entries = set(r["entry"] for r in record.rows)
    check(entries == set(native._SIGNATURES),
          f"kernels not checked: {set(native._SIGNATURES) - entries}")
    del images

    # 4. the flagship main path, the points-only path, then card-vs-CPU
    # agreement on small scenes
    launches = main_path(dev, lines=True)
    main_path(dev, lines=False)
    small_agreement(dev)
    small_line_agreement(dev)

    # 5. results
    rows = record.rows
    for r in rows:
        r["launches"] = launches[r["entry"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
