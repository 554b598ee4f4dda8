"""Stereo VO CLI (no mapping, no loop closure): port of
``plslam_tpu/apps/plstvo_dataset.py``.

Runs StVO over a dataset directory (KITTI, EuRoC or params-yaml layout;
PNG, PGM or PPM images) or an in-memory synthetic scene, prints per-stage
timings, reports ATE/RPE when there is ground truth, and saves the
trajectory in TUM format. The default is the per-frame driver
(``StereoVO``); ``--chunk B`` tracks B frames per call
(``BatchedStereoVO``). Runs on the CUDA device unless ``--device cpu``.

Usage:
  python -m plslam_tpu_torch.apps.plstvo_dataset <dataset_dir> [options]
  python -m plslam_tpu_torch.apps.plstvo_dataset --synthetic [options]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from plslam_tpu_torch.config import SlamConfig


def build_argparser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("dataset", nargs="?", default=None,
                    help="dataset directory (KITTI / EuRoC / params-yaml "
                         "layout)")
    ap.add_argument("--synthetic", action="store_true",
                    help="run on an in-memory synthetic ground-truth scene")
    ap.add_argument("--config", default=None,
                    help="SlamConfig YAML overrides (needs PyYAML)")
    ap.add_argument("--frames", type=int, default=None, help="frame count")
    ap.add_argument("--offset", type=int, default=0, help="first frame index")
    ap.add_argument("--step", type=int, default=1, help="frame stride")
    ap.add_argument("--lines", action="store_true",
                    help="force line features on (default: on)")
    ap.add_argument("--no-lines", action="store_true",
                    help="disable line features (point-only StVO)")
    ap.add_argument("--no-points", action="store_true",
                    help="disable points")
    ap.add_argument("--out", default=None,
                    help="trajectory output path (TUM format)")
    ap.add_argument("--seed", type=int, default=0, help="synthetic scene seed")
    ap.add_argument("--trajectory", default="forward",
                    choices=["forward", "arc", "loop"],
                    help="synthetic motion")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (CPU and CUDA) to "
                         "DIR/trace.json (Chrome trace format)")
    ap.add_argument("--chunk", type=int, default=0, metavar="B",
                    help="throughput mode: track B frames per call "
                         "(batched extraction and tracking, two chunks in "
                         "flight)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default: the CUDA device; cpu runs "
                         "the plain PyTorch versions of the kernels)")
    return ap


def load_config(args) -> SlamConfig:
    cfg = SlamConfig()
    if args.config:
        cfg = SlamConfig.from_yaml(args.config, base=cfg)
    updates = {}
    if args.synthetic and not args.config:
        updates["camera"] = {"width": 640, "height": 384, "fx": 450.0,
                             "fy": 450.0, "cx": 320.0, "cy": 192.0,
                             "baseline": 0.3}
        updates["points"] = {"max_kpts": 512, "orb_nlevels": 2}
    cfg = cfg.with_updates(updates) if updates else cfg
    # points+lines is the flagship configuration (reference default);
    # --no-lines / --no-points select the reduced variants
    has_lines = (cfg.lines.has_lines or args.lines) and not args.no_lines
    cfg = cfg.with_updates({"lines": {"has_lines": has_lines},
                            "points": {"has_points": not args.no_points}})
    return cfg


def open_frames(args, cfg: SlamConfig):
    from plslam_tpu_torch.io.dataset import open_dataset, synthetic_dataset
    if args.synthetic:
        n = args.frames or 30
        return synthetic_dataset(cfg, n_frames=n, seed=args.seed,
                                 kind=args.trajectory,
                                 n_points=0 if args.no_points else 300,
                                 n_lines=60 if cfg.lines.has_lines else 0)
    if not args.dataset:
        print("error: provide a dataset dir or --synthetic", file=sys.stderr)
        sys.exit(2)
    return open_dataset(args.dataset, cfg.camera, start=args.offset,
                        count=args.frames, step=args.step)


def _main_chunked(args, cfg, ds, record) -> int:
    """Chunked VO: chunks of B pairs as one batch, two chunks in flight;
    frames stream through the prefetcher."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse, rpe

    cam = StereoCamera.from_config(ds.camera)
    vo = BatchedStereoVO(cfg, cam, device=args.device)
    n = len(ds)
    B = args.chunk
    img_l, img_r = ds.frame(0)
    vo.initialize(img_l, img_r)
    i = 1
    t_start = None
    n_timed = 0
    outs = []

    def as_u8(frames):
        # 8-bit transport: 4x less host -> device traffic
        return np.stack([np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
                         for f in frames])

    while i < n:
        j = min(i + B, n)
        ls, rs = zip(*(ds.frame(k) for k in range(i, j)))
        if j - i < B:                      # fixed shapes: pad the last chunk
            pad = B - (j - i)
            ls = ls + (ls[-1],) * pad
            rs = rs + (rs[-1],) * pad
        ls, rs = as_u8(ls), as_u8(rs)
        if i == 1:
            # the first chunk synchronously: warm-up stays out of the
            # throughput clock
            outs.append(vo.process_chunk(ls, rs))
            t_start = time.perf_counter()
        else:
            outs.append(vo.submit_chunk(ls, rs))
            n_timed += j - i
            if len(vo._pending) >= 2:
                vo._integrate(vo._pending[0], update_prior=False)
        i = j
    vo.drain()
    wall = time.perf_counter() - t_start if t_start else 0.0
    est = np.stack(vo.trajectory)[:n]      # drop pad frames

    fps = n_timed / wall if wall > 0 and n_timed else float("nan")
    if record is not None:
        good = (np.concatenate([o.good.cpu().numpy() for o in outs])[:n - 1]
                if outs else np.zeros(0, bool))
        record.update(est=est, good=good, fps=fps, n_timed=n_timed,
                      wall=wall)
    print(f"\nStVO (chunked B={B}): {n} frames, "
          f"{fps:.1f} fps (wall, steady-state incl. IO)")
    if ds.gt_poses is not None:
        a = ate_rmse(est, ds.gt_poses[:len(est)])
        t_r, r_r = rpe(est, ds.gt_poses[:len(est)])
        print(f"ATE RMSE: {a:.4f} m | RPE: {t_r:.4f} m / "
              f"{np.rad2deg(r_r):.4f} deg")
    if args.out:
        save_tum(args.out, est)
        print("trajectory saved to", args.out)
    return 0


def save_tum(path: str, poses: np.ndarray) -> None:
    with open(path, "w") as f:
        for i, T in enumerate(poses):
            # quaternion from rotation matrix (TUM order x y z qx qy qz qw)
            R = T[:3, :3]
            t = T[:3, 3]
            tr = np.trace(R)
            if tr > 0:
                s = np.sqrt(tr + 1.0) * 2
                qw, qx, qy, qz = 0.25 * s, (R[2, 1] - R[1, 2]) / s, \
                    (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s
            else:
                k = np.argmax(np.diag(R))
                if k == 0:
                    s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
                    qw, qx, qy, qz = (R[2, 1] - R[1, 2]) / s, 0.25 * s, \
                        (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
                elif k == 1:
                    s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
                    qw, qx, qy, qz = (R[0, 2] - R[2, 0]) / s, \
                        (R[0, 1] + R[1, 0]) / s, 0.25 * s, \
                        (R[1, 2] + R[2, 1]) / s
                else:
                    s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
                    qw, qx, qy, qz = (R[1, 0] - R[0, 1]) / s, \
                        (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, \
                        0.25 * s
            f.write(f"{i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def main(argv=None, record=None) -> int:
    """Run the app. ``record``, a dict, receives the run's trajectory
    (``est``), per-frame ``good`` flags and throughput, for callers that
    check a run."""
    args = build_argparser(__doc__).parse_args(argv)
    cfg = load_config(args)
    ds = open_frames(args, cfg)
    if args.chunk > 0:
        return _main_chunked(args, cfg, ds, record)

    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.tracking.frame_handler import StereoVO
    from plslam_tpu_torch.utils.evaluation import ate_rmse, rpe
    from plslam_tpu_torch.utils.timing import StageTimer, maybe_profile

    cam = StereoCamera.from_config(ds.camera)
    extract_fn = None
    if cfg.lines.has_lines:
        from plslam_tpu_torch.frontend.stereo_frame import make_extractor
        extract_fn = make_extractor(cam, cfg, device=args.device)
    vo = StereoVO(cfg, cam, extract_fn=extract_fn, device=args.device)
    timer = StageTimer()

    n = len(ds)
    img_l, img_r = ds.frame(0)
    vo.initialize(img_l, img_r)
    t_start = time.perf_counter()
    good = []
    with maybe_profile(args.profile):
        for i in range(1, n):
            timer.start("io")
            img_l, img_r = ds.frame(i)
            timer.stop("io")
            timer.start("frame")
            fr = vo.insert_stereo_pair(img_l, img_r)
            timer.stop("frame")          # fr is on the host: synchronized
            good.append(fr.good)
            if not args.quiet and (i % 10 == 0 or not fr.good):
                print(f"[{i:4d}/{n}] good={fr.good} inl={fr.n_inliers:4d} "
                      f"err={fr.err:6.3f} kf={fr.is_kf} "
                      f"t=({fr.T_wc[0, 3]:+.2f},{fr.T_wc[1, 3]:+.2f},"
                      f"{fr.T_wc[2, 3]:+.2f})")
    wall = time.perf_counter() - t_start

    est = np.stack(vo.trajectory)
    n_good = int(sum(good))
    if record is not None:
        record.update(est=est, good=np.array(good, bool),
                      fps=(n - 1) / wall, wall=wall, timer=timer.summary())
    print(f"\nStVO: {n} frames, {n_good}/{n-1} tracked, "
          f"{(n-1)/wall:.1f} fps (wall, incl. warmup)")
    print("stage timing:", timer.report())
    if ds.gt_poses is not None:
        a = ate_rmse(est, ds.gt_poses[:len(est)])
        t_r, r_r = rpe(est, ds.gt_poses[:len(est)])
        print(f"ATE RMSE: {a:.4f} m | RPE: {t_r:.4f} m / "
              f"{np.rad2deg(r_r):.4f} deg")
    if args.out:
        save_tum(args.out, est)
        print("trajectory saved to", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
