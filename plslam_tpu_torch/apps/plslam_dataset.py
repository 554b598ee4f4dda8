"""Full SLAM CLI: stereo point-line SLAM with mapping and loop closure.

Port of ``plslam_tpu/apps/plslam_dataset.py``. By default (``--chunk 0``)
the per-frame driver (``backend.slam_system.PLSLAM``): the tracker a frame
at a time, keyframes to the mapping worker (``--sync``: inline, with
``system.async_mapping`` false), the LBA and loop corrections re-anchoring
the odometry. With ``--chunk B`` the fused driver
(``backend.fused_slam.FusedPLSLAM``: B frames a chunk, the keyframe
criterion, mapping and the BoW probe in one step, KF-slot compaction past
``mapping.max_kfs``; ``--resume`` continues a checkpointed run after its
last saved frame), or with ``system.fused_slam: false`` the host-KF driver
(``backend.slam_system.ChunkedPLSLAM``). Prints the run's keyframes,
landmarks, loops and throughput, ATE, RPE and the KITTI odometry error
when there is ground truth; saves the trajectory (TUM), a render of the
scene (``--viz``, needs matplotlib) and a checkpoint (``--checkpoint``).
Runs on the CUDA device unless ``--device cpu``.

Usage:
  python -m plslam_tpu_torch.apps.plslam_dataset <dataset_dir> [--sync]
  python -m plslam_tpu_torch.apps.plslam_dataset <dataset_dir> --chunk 20
  python -m plslam_tpu_torch.apps.plslam_dataset --synthetic --chunk 20
"""

from __future__ import annotations

import sys
import time

import numpy as np

from plslam_tpu_torch.apps.plstvo_dataset import (build_argparser,
                                                  load_config, open_frames,
                                                  save_tum)


def _main_chunked(args, cfg, ds, record) -> int:
    """Chunked full SLAM, B frames a chunk: the fused driver, or with
    ``system.fused_slam: false`` the host-KF driver with the mapping
    worker."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.utils.evaluation import (ate_rmse,
                                                   kitti_odometry_error, rpe)

    cam = StereoCamera.from_config(ds.camera)
    resumed = bool(args.resume)
    if not cfg.system.fused_slam:
        if resumed:
            print("--resume requires the fused driver "
                  "(system.fused_slam=true)", file=sys.stderr)
            return 2
        from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM
        slam = ChunkedPLSLAM(cfg, cam, enable_loops=not args.no_loops,
                             device=args.device)
    elif resumed:
        from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
        slam = FusedPLSLAM.resume(args.resume, cam,
                                  enable_loops=not args.no_loops,
                                  device=args.device)
        print(f"resumed from {args.resume}: {len(slam.trajectory)} frames, "
              f"{slam._kf_slot + 1} KFs in map")
    else:
        from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
        slam = FusedPLSLAM(cfg, cam, enable_loops=not args.no_loops,
                           device=args.device)
    n = len(ds)
    B = args.chunk
    if resumed:
        i = len(slam.trajectory)    # continue after the last saved frame
        if i >= n:
            print("checkpoint already covers the whole sequence")
    else:
        img_l, img_r = ds.frame(0)
        slam.initialize(img_l, img_r)
        i = 1
    t_start = None
    n_timed = 0

    def as_u8(frames):
        # 8-bit transport: 4x less host -> device traffic
        return np.stack([np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
                         for f in frames])

    while i < n:
        j = min(i + B, n)
        ls, rs = zip(*(ds.frame(k) for k in range(i, j)))
        n_real = j - i
        if n_real < B:                     # fixed shapes: pad the last chunk
            ls = ls + (ls[-1],) * (B - n_real)
            rs = rs + (rs[-1],) * (B - n_real)
        slam.process_chunk(as_u8(ls), as_u8(rs), n_valid=n_real)
        if t_start is None:
            t_start = time.perf_counter()     # the first chunk: warm-up
        else:
            n_timed += n_real
        i = j
    est = slam.finish()
    wall = time.perf_counter() - t_start if t_start else 0.0
    fps = n_timed / wall if wall > 0 and n_timed else float("nan")

    holder = slam if cfg.system.fused_slam else slam.map
    n_pts, n_lns = holder.n_landmarks()
    n_loops = slam.loop_closer.n_loops_closed if slam.loop_closer else 0
    if record is not None:
        record.update(est=est, slam=slam, fps=fps, n_timed=n_timed,
                      wall=wall)
    mode = "fused" if cfg.system.fused_slam else "chunked"
    print(f"\nPL-SLAM ({mode} B={B}): {n} frames, {slam._kf_slot + 1} KFs, "
          f"{n_pts} map points, {n_lns} map lines, {n_loops} loops, "
          f"{fps:.1f} fps (wall, steady-state incl. IO + mapping)")
    if ds.gt_poses is not None:
        a = ate_rmse(est, ds.gt_poses[:len(est)])
        t_r, r_r = rpe(est, ds.gt_poses[:len(est)])
        print(f"ATE RMSE: {a:.4f} m | RPE: {t_r:.4f} m / "
              f"{np.rad2deg(r_r):.4f} deg")
        t_pct, r_dm, n_seg = kitti_odometry_error(est, ds.gt_poses[:len(est)])
        if n_seg:   # needs >= 100 m of ground-truth path
            print(f"KITTI odometry error: {t_pct:.2f} % / "
                  f"{r_dm:.4f} deg/m over {n_seg} segments")
    _outputs(args, cfg, ds, est, slam, holder)
    return 0


def _outputs(args, cfg, ds, est, slam, holder) -> None:
    """--out, --viz and --checkpoint of a finished run (``holder``: the
    object holding the map state)."""
    if args.out:
        save_tum(args.out, est)
        print("trajectory saved to", args.out)
    if args.viz:
        from plslam_tpu_torch.utils.viz import plot_map_handler
        gt = ds.gt_poses[:len(est)] if ds.gt_poses is not None else None
        plot_map_handler(holder, path=args.viz, gt_poses=gt,
                         loop_closer=slam.loop_closer)
        print("scene rendered to", args.viz)
    if args.checkpoint:
        if hasattr(slam, "save_checkpoint"):
            slam.save_checkpoint(args.checkpoint)
        else:
            from plslam_tpu_torch.backend.checkpoint import save_map
            save_map(args.checkpoint, holder.state, cfg,
                     extra={"trajectory": est})
        print("map checkpoint saved to", args.checkpoint)


def _main_per_frame(args, cfg, ds, record) -> int:
    """The per-frame driver (PLSLAM), one stereo pair at a time."""
    from plslam_tpu_torch.backend.slam_system import PLSLAM
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.utils.evaluation import ate_rmse, rpe
    from plslam_tpu_torch.utils.timing import StageTimer, maybe_profile

    cam = StereoCamera.from_config(ds.camera)
    slam = PLSLAM(cfg, cam, device=args.device)
    timer = StageTimer()
    n = len(ds)
    img_l, img_r = ds.frame(0)
    slam.initialize(img_l, img_r)
    t_start = time.perf_counter()
    n_good, n_kfs = 0, 1
    with maybe_profile(args.profile):
        for i in range(1, n):
            timer.start("io")
            img_l, img_r = ds.frame(i)
            timer.stop("io")
            timer.start("frame")
            out = slam.process(img_l, img_r)
            timer.stop("frame")      # the frame's result is on the host
            fr = out.frame
            n_good += int(fr.good)
            n_kfs += int(out.kf_slot is not None)
            if not args.quiet and (i % 10 == 0 or not fr.good):
                t = fr.T_wc[:3, 3]
                print(f"[{i:4d}/{n}] good={fr.good} inl={fr.n_inliers:4d} "
                      f"kf={out.kf_slot is not None} "
                      f"t=({t[0]:+.2f},{t[1]:+.2f},{t[2]:+.2f})")
    est = slam.finish()
    wall = time.perf_counter() - t_start

    n_pts, n_lns = slam.map.n_landmarks()
    n_loops = slam.loop_closer.n_loops_closed if slam.loop_closer else 0
    if record is not None:
        record.update(est=est, slam=slam, fps=(n - 1) / wall, wall=wall,
                      n_good=n_good, timer=timer.summary())
    print(f"\nPL-SLAM: {n} frames, {n_good}/{n-1} tracked, {n_kfs} KFs, "
          f"{n_pts} map points, {n_lns} map lines, {n_loops} loops, "
          f"{(n-1)/wall:.1f} fps (wall)")
    print("stage timing:", timer.report())
    if ds.gt_poses is not None:
        a = ate_rmse(est, ds.gt_poses[:len(est)])
        t_r, r_r = rpe(est, ds.gt_poses[:len(est)])
        print(f"ATE RMSE: {a:.4f} m | RPE: {t_r:.4f} m / "
              f"{np.rad2deg(r_r):.4f} deg")
    _outputs(args, cfg, ds, est, slam, slam.map)
    return 0


def main(argv=None, record=None) -> int:
    """Run the app. ``record``, a dict, receives the run's trajectory
    (``est``), the driver (``slam``) and throughput, for callers that
    check a run."""
    ap = build_argparser(__doc__)
    ap.add_argument("--no-loops", action="store_true",
                    help="disable loop closure")
    ap.add_argument("--sync", action="store_true",
                    help="synchronous mapping (no mapping thread)")
    ap.add_argument("--viz", default=None, metavar="PNG",
                    help="render the final 3D scene to this PNG")
    ap.add_argument("--checkpoint", default=None, metavar="NPZ",
                    help="save the final map state to this npz")
    ap.add_argument("--resume", default=None, metavar="NPZ",
                    help="resume a fused-driver run from this checkpoint "
                         "(continues after its last saved frame)")
    args = ap.parse_args(argv)
    cfg = load_config(args)
    if args.sync:
        cfg = cfg.with_updates({"system": {"async_mapping": False}})
    if args.no_loops:
        cfg = cfg.with_updates({"loop": {"enabled": False}})
    ds = open_frames(args, cfg)
    if args.chunk > 0:
        return _main_chunked(args, cfg, ds, record)
    return _main_per_frame(args, cfg, ds, record)


if __name__ == "__main__":
    sys.exit(main())
