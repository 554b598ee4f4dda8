"""Multi-process check of the sharded LBA step.

Port of ``plslam_tpu/parallel/multihost_check.py``: N processes joined by
``torch.distributed`` (``parallel/mesh.py::init_multihost``), each holding
``--local-shards`` shards of one global mesh ('lm' axis, the process axis
folded in), run ``make_dist_lba_step`` on ``make_problem``'s problem, the
same on every rank, and rank 0 writes the gathered step, in the original
landmark order, to DIR/rank0.npz for its parent to compare with a
one-process mesh of as many shards.

Usage (each rank):
  python -m plslam_tpu_torch.parallel.multihost_check --rank R \\
      --nprocs N --init file:///tmp/rdv --out DIR [--local-shards 2] \\
      [--backend gloo] [--device cpu]

``--init`` is the process group's init method (``file://`` or
``tcp://localhost:PORT``); the backend is the caller's choice (two ranks
on one card take gloo: NCCL refuses them).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def make_problem_np(W: int = 4, Pn: int = 64, Q: int = 32, seed: int = 7):
    """The reference's ``make_problem``: a deterministic, geometrically
    consistent small LBA problem (real projections + small noise, the
    first KF fixed, the state perturbed), as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    fx = fy = 500.0
    cx, cy, b = 320.0, 240.0, 0.4
    pt = np.stack([rng.uniform(-6, 6, Pn), rng.uniform(-4, 4, Pn),
                   rng.uniform(8, 25, Pn)], -1).astype(f32)
    ep = np.stack([rng.uniform(-6, 6, Q), rng.uniform(-4, 4, Q),
                   rng.uniform(8, 25, Q)], -1).astype(f32)
    pose = np.tile(np.eye(4, dtype=f32), (W, 1, 1))
    pose[:, 2, 3] = (0.3 * np.arange(W)).astype(f32)   # forward motion

    def proj(T, X):
        Xc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                         fy * Xc[:, 1] / Xc[:, 2] + cy], -1), Xc[:, 2]

    obs_uv = np.zeros((W, Pn, 2), f32)
    obs_disp = np.zeros((W, Pn), f32)
    for w in range(W):
        uv, z = proj(pose[w], pt)
        obs_uv[w] = uv + rng.normal(0, 0.3, uv.shape)
        obs_disp[w] = fx * b / z + rng.normal(0, 0.3, z.shape)
    obs_id = np.broadcast_to(np.arange(Pn, dtype=np.int32), (W, Pn)).copy()
    obs_id[rng.uniform(size=(W, Pn)) < 0.15] = -1

    L = Q // 2
    sid = np.broadcast_to(np.arange(0, Q, 2, dtype=np.int32), (W, L)).copy()
    eid = sid + 1
    le = np.zeros((W, L, 3), f32)
    for w in range(W):
        sp, _ = proj(pose[w], ep[0::2])
        epx, _ = proj(pose[w], ep[1::2])
        sp = sp + rng.normal(0, 0.3, sp.shape)
        epx = epx + rng.normal(0, 0.3, epx.shape)
        h = np.cross(np.concatenate([sp, np.ones((L, 1))], -1),
                     np.concatenate([epx, np.ones((L, 1))], -1))
        le[w] = (h / np.maximum(np.linalg.norm(h[:, :2], axis=-1,
                                               keepdims=True), 1e-9)
                 ).astype(f32)

    pt_noisy = pt + rng.normal(0, 0.05, pt.shape).astype(f32)
    ep_noisy = ep + rng.normal(0, 0.05, ep.shape).astype(f32)
    return dict(
        kf_pose=pose, kf_fixed=np.eye(1, W, 0, dtype=bool)[0],
        kf_valid=np.ones((W,), bool), pt_pos=pt_noisy, ep_pos=ep_noisy,
        obs_pt_uv=obs_uv, obs_pt_disp=obs_disp, obs_pt_id=obs_id,
        obs_ln_le=le, obs_ln_sid=sid, obs_ln_eid=eid)


def camera():
    """The check's camera (640x480, f 500, baseline 0.4)."""
    from plslam_tpu_torch.convert import camera_from_numpy
    return camera_from_numpy(500.0, 500.0, 320.0, 240.0, 0.4, 640, 480)


def dist_step(mesh, device, lam: float = 1e-3):
    """``make_dist_lba_step`` on ``make_problem_np``'s problem over
    ``mesh``: (dxi, d_pt, d_ep) as numpy, landmarks in the original
    order."""
    from plslam_tpu_torch.convert import lba_problem_from_numpy
    from plslam_tpu_torch.parallel.dist_lba import (bucket_problem_by_owner,
                                                    make_dist_lba_step,
                                                    unbucket_landmarks)
    b = bucket_problem_by_owner(
        lba_problem_from_numpy(make_problem_np(), device), mesh.size)
    dxi, d_pt, d_ep = make_dist_lba_step(mesh, camera())(b.problem, lam)
    return (dxi.cpu().numpy(),
            unbucket_landmarks(d_pt, b.pt_perm).cpu().numpy(),
            unbucket_landmarks(d_ep, b.ep_perm).cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="init method: file:///path or tcp://host:port")
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from plslam_tpu_torch.parallel.mesh import init_multihost, make_global_mesh
    init_multihost(args.init, args.nprocs, args.rank, args.backend)
    try:
        mesh = make_global_mesh(axes=("lm",), n_local=args.local_shards,
                                device=args.device)
        dxi, d_pt, d_ep = dist_step(mesh, args.device)
        if args.rank == 0:
            np.savez(os.path.join(args.out, "rank0.npz"), dxi=dxi, d_pt=d_pt,
                     d_ep=d_ep, n_shards=np.asarray(mesh.size),
                     reduce_bytes=np.asarray(mesh.reduce_bytes))
        dist.barrier()              # every rank reaches here
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
