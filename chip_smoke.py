#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (plslam_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card: name, count, ``nvidia-smi`` name and power limit;
  2. build the hand-written CUDA kernels from ``plslam_tpu_torch/csrc``;
  3. every kernel at the main path's shapes (KITTI 376x1241, 40 images a
     chunk; K=1024; B=20 x 1024 x 1024): compared with its plain PyTorch
     version on the same inputs, timed with CUDA events, beside its
     bound, its plain version's time and a one-call library yardstick;
  4. the main path: points-only chunked VO (``BatchedStereoVO``) at the
     full width of ``SlamConfig()`` with ``lines.has_lines=False``, on
     the synthetic scene of bench.py (seed 0, 500 points, step 0.25):
     initialize + 2 chunks of 20 frames, every frame tracked, ATE within
     its bound, every kernel launched; then the same port on the card
     against its CPU run on a small scene;
  5. one JSON line of the kernels, then the card line, then the result.

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

# ATE bound of the main path (m). The port's own CPU run of the same
# scene and frames (``python3 chip_smoke.py --cpu-ate``: the plain
# versions, device="cpu") measured ATE_CPU_MEASURED; the bound leaves a
# margin of 2x plus 2 cm.
ATE_CPU_MEASURED = 0.012123057406343597
ATE_BOUND = 0.045


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


def kernel_phase(images):
    """Each kernel at main-path shapes against its plain version."""
    import torch
    import torch.nn.functional as F
    from plslam_tpu_torch import native
    from plslam_tpu_torch.ops import fast, hamming, image, orb

    dev = images.device
    rows = []

    def record(name, source, replaces, got, plain, tol, fn, plain_fn,
               nbytes, ops, library_fn=None, iters=20):
        errs = [max_abs_err(g, p) for g, p in zip(got, plain)]
        err = max(errs)
        ok = err <= tol
        ms = cuda_ms(fn, iters)
        plain_ms = cuda_ms(plain_fn, max(iters // 4, 3))
        lib_ms = cuda_ms(library_fn, iters) if library_fn else None
        b_ms, b_by = bound(nbytes, ops)
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=err, tol=tol,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, ok=ok))
        print(f"[kernel] {name}: max_abs_err={err:g} (tol {tol:g}) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) library_ms="
              f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}", flush=True)
        check(ok, f"{name} disagrees with its plain version: {err} > {tol}")

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
    B, M = 20, 1024
    bits_a = torch.randint(0, 2, (B, M, 256), generator=g, dtype=torch.uint8)
    flip = torch.rand((B, M, 256), generator=g) < 0.05
    va = torch.rand((B, M), generator=g) > 0.1
    vb = torch.rand((B, M), generator=g) > 0.1
    perm = torch.randperm(M, generator=g)
    bits_b = bits_a[:, perm] ^ flip.to(torch.uint8)
    pos_a = torch.rand((B, M, 2), generator=g) * torch.tensor([1241., 376.])
    pos_b = pos_a[:, perm] + torch.randn((B, M, 2), generator=g) * 20
    bits_a, bits_b, va, vb = (x.to(dev) for x in (bits_a, bits_b, va, vb))
    mask = hamming.window_mask(pos_a.to(dev), pos_b.to(dev), 160.0)
    dist = hamming.hamming_matrix(bits_a, bits_b, va, vb, mask)
    ref = hamming.hamming_matrix_plain(bits_a, bits_b, va, vb, mask)
    fa, fb = bits_a.float(), bits_b.float()
    record("hamming_dist", "plslam_tpu_torch/csrc/hamming.cu",
           "plslam_tpu/ops/hamming.py:30", [dist], [ref], 0.0,
           lambda: hamming.hamming_matrix(bits_a, bits_b, va, vb, mask),
           lambda: hamming.hamming_matrix_plain(bits_a, bits_b, va, vb, mask),
           B * M * M * (1 + 4) + 2 * B * M * 256, B * M * M * 24,
           lambda: torch.cdist(fa, fb, p=0))
    got = hamming.match_nnr(dist, 80, 0.75)
    ref = hamming.match_nnr_plain(dist, 80, 0.75)
    check(int(ref.valid.sum()) > 1000, "too few matches in the D case")
    record("hamming_match", "plslam_tpu_torch/csrc/hamming.cu",
           "plslam_tpu/ops/hamming.py:57", list(got), list(ref), 0.0,
           lambda: hamming.match_nnr(dist, 80, 0.75),
           lambda: hamming.match_nnr_plain(dist, 80, 0.75),
           B * M * M * 4 + B * M * 9, B * M * M * 4)
    check(set(r["name"] for r in rows) == set(native._SIGNATURES),
          "a kernel was not checked")
    return rows


CHUNK = 20


def main_scene():
    """bench.py's scene at full KITTI width, points only: the main path."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic

    cfg = SlamConfig().with_updates({"lines": {"has_lines": False}})
    cam = StereoCamera.from_config(cfg.camera)
    t0 = time.perf_counter()
    seq = synthetic.make_sequence(cam, n_frames=2 * CHUNK + 1, seed=0,
                                  n_points=500, n_lines=0, noise=0.003,
                                  step=0.25)
    print(f"[main] rendered {2 * CHUNK + 1} frames in "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)
    return cfg, cam, seq


def cpu_reference_ate() -> float:
    """The main path's scene through the port's plain versions on the
    CPU: the calibration run of ATE_BOUND (``--cpu-ate``)."""
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    cfg, cam, seq = main_scene()
    vo = BatchedStereoVO(cfg, cam, device="cpu")
    vo.initialize(seq.images_l[0], seq.images_r[0])
    goods = []
    for lo in (1, 1 + CHUNK):
        out = vo.process_chunk(seq.images_l[lo:lo + CHUNK],
                               seq.images_r[lo:lo + CHUNK])
        goods += out.good.tolist()
    ate = ate_rmse(np.stack(vo.trajectory), seq.poses)
    print(f"[cpu] good={sum(goods)}/{len(goods)} ate_m={ate!r}", flush=True)
    return ate


def main_path(dev):
    """Points-only chunked VO at full KITTI width, 2 chunks of 20."""
    import torch
    from plslam_tpu_torch import native
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse

    cfg, cam, seq = main_scene()
    chunk = CHUNK
    il = torch.from_numpy(seq.images_l).to(dev)
    ir = torch.from_numpy(seq.images_r).to(dev)

    warm = BatchedStereoVO(cfg, cam)
    warm.initialize(il[0], ir[0])
    out = warm.process_chunk(il[1:1 + chunk], ir[1:1 + chunk])
    check(bool(out.good.all()), "tracking failed in the warm-up chunk")

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
    good = torch.cat([o.good for o in outs]).cpu().numpy()
    n_inl = torch.cat([o.n_inliers for o in outs]).cpu().numpy()
    ate = ate_rmse(np.stack(vo.trajectory), seq.poses)
    fps = 2 * chunk / wall
    print(f"[main] frames={2 * chunk} good={int(good.sum())} "
          f"inliers min/median={int(n_inl.min())}/{int(np.median(n_inl))} "
          f"ate_m={ate:.6f} (bound {ATE_BOUND}; CPU run "
          f"{ATE_CPU_MEASURED:.6f})", flush=True)
    print(f"[main] fps={fps:.2f} ms_per_frame={1e3 * wall / (2 * chunk):.3f} "
          f"(host clock, initialize + 2 chunks, ends in synchronize) "
          f"max_memory_allocated_bytes={torch.cuda.max_memory_allocated()}",
          flush=True)
    print(f"[main] launches={json.dumps(launches, sort_keys=True)}",
          flush=True)
    check(bool(good.all()), f"frames not tracked: {np.nonzero(~good)[0]}")
    check(math.isfinite(ate) and ate < ATE_BOUND,
          f"ATE {ate} m outside its bound {ATE_BOUND} m")
    missing = [k for k in native._SIGNATURES if launches.get(k, 0) == 0]
    check(not missing, f"kernels not launched on the main path: {missing}")
    return launches


def small_agreement(dev):
    """The port on the card against the port on the CPU (plain versions)
    on a small scene: same tracking, keypoints and poses."""
    import torch
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.tracking.batch_vo import vo_chunk, extract_one

    cfg = SlamConfig().with_updates({
        "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
                   "cx": 320.0, "cy": 192.0, "baseline": 0.3},
        "points": {"max_kpts": 512, "orb_nlevels": 2},
        "lines": {"has_lines": False}})
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=5, seed=7, n_points=260,
                                  n_lines=0, noise=0.003, step=0.12)
    res = {}
    for d in ("cpu", dev):
        il = torch.from_numpy(seq.images_l).to(d)
        ir = torch.from_numpy(seq.images_r).to(d)
        p0, _ = extract_one(il[0], ir[0], cam, cfg)
        out = vo_chunk(il[1:5], ir[1:5], p0, None,
                       torch.eye(4, device=d), cam, cfg)
        res[d] = (p0, out)
    (pc, oc), (pg, og) = res["cpu"], res[dev]
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
          f"(nvcc, sm_90a, 4 sources in parallel)", flush=True)

    # 3. kernels at main-path shapes, on the scene's level-0 images
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    cam = StereoCamera.from_config(SlamConfig().camera)
    seq = synthetic.make_sequence(cam, n_frames=20, seed=1, n_points=500,
                                  n_lines=0, noise=0.003, step=0.25)
    images = torch.from_numpy(np.concatenate(
        [seq.images_l, seq.images_r])).to(dev)
    rows = kernel_phase(images)
    del images

    # 4. the main path, then card-vs-CPU agreement on a small scene
    launches = main_path(dev)
    small_agreement(dev)

    # 5. results
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
