"""Concurrent multi-sequence SLAM: N independent sessions on one card.

Port of ``plslam_tpu/apps/plslam_multiseq.py`` (``run_concurrent``,
``main``): each session has its own map, loop closer and (with
``ChunkedPLSLAM``) mapping worker, and the sessions' chunks interleave in
the card's stream. The driver is ``FusedPLSLAM`` by default and
``ChunkedPLSLAM`` with ``system.fused_slam=false``. ``--distributed``
routes every session's window LBA through the owner-sharded solve
(``mapping.distributed``): per-frame ``PLSLAM`` sessions with sync mapping,
their frames interleaved (``mapping.dist_devices`` from ``--config`` sets
the shards). Runs on the CUDA device unless ``--device cpu``.

Usage:
  python -m plslam_tpu_torch.apps.plslam_multiseq --synthetic \\
      --sequences 2 --frames 80 --chunk 20
"""

from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np


def run_concurrent(slams: List, sequences: List, chunk: int
                   ) -> List[np.ndarray]:
    """Interleave the sequences' chunks; returns each session's
    trajectory."""
    n_frames = min(len(s.images_l) for s in sequences)
    for slam, seq in zip(slams, sequences):
        slam.initialize(seq.images_l[0], seq.images_r[0])
    for lo in range(1, n_frames, chunk):
        for slam, seq in zip(slams, sequences):
            slam.process_chunk(seq.images_l[lo:lo + chunk],
                               seq.images_r[lo:lo + chunk])
    return [slam.finish() for slam in slams]


def run_interleaved(slams: List, sequences: List) -> List[np.ndarray]:
    """Per-frame sessions, their frames interleaved; returns each
    session's trajectory."""
    n_frames = min(len(s.images_l) for s in sequences)
    for slam, seq in zip(slams, sequences):
        slam.initialize(seq.images_l[0], seq.images_r[0])
    for i in range(1, n_frames):
        for slam, seq in zip(slams, sequences):
            slam.process(seq.images_l[i], seq.images_r[i])
    return [slam.finish() for slam in slams]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--sequences", type=int, default=2)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--config", default=None,
                    help="YAML overrides of SlamConfig (PyYAML); "
                         "system.fused_slam: false runs ChunkedPLSLAM")
    ap.add_argument("--distributed", action="store_true",
                    help="every session's window LBA on the sharded "
                         "multi-device solver (mapping.distributed)")
    args = ap.parse_args(argv)

    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.utils.evaluation import ate_rmse

    cfg = SlamConfig.from_yaml(args.config) if args.config else SlamConfig()
    if args.distributed:
        # the sharded LBA lives on the per-KF mapping path: per-frame
        # PLSLAM sessions route every window solve through
        # map_handler.mapping_step_distributed, mapping in sync
        cfg = cfg.with_updates({"mapping": {"distributed": True},
                                "system": {"async_mapping": False}})
        from plslam_tpu_torch.backend.slam_system import PLSLAM as Driver
    elif cfg.system.fused_slam:
        from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM as Driver
    else:
        from plslam_tpu_torch.backend.slam_system import (
            ChunkedPLSLAM as Driver)
    cam = StereoCamera.from_config(cfg.camera)
    seqs = [synthetic.make_sequence(cam, n_frames=args.frames, seed=10 + s,
                                    kind="loop" if s % 2 else "forward",
                                    n_points=400, n_lines=60, noise=0.004,
                                    step=0.15)
            for s in range(args.sequences)]
    slams = [Driver(cfg, cam, enable_loops=not args.no_loops,
                    device=args.device) for _ in range(args.sequences)]
    t0 = time.perf_counter()
    if args.distributed:
        trajs = run_interleaved(slams, seqs)
    else:
        trajs = run_concurrent(slams, seqs, args.chunk)
    wall = time.perf_counter() - t0
    total = sum(len(t) for t in trajs)
    for s, (traj, seq) in enumerate(zip(trajs, seqs)):
        a = ate_rmse(traj, seq.poses[:len(traj)])
        nl = slams[s].loop_closer.n_loops_closed if slams[s].loop_closer else 0
        print(f"seq {s}: {len(traj)} frames, ATE {a:.4f} m, loops {nl}")
    print(f"aggregate: {total} frames in {wall:.2f}s = "
          f"{total / wall:.1f} fps across {args.sequences} sessions")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
