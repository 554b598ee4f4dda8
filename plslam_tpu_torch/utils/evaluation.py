"""Trajectory evaluation: ATE / RPE.

The port's own numpy copy of ``plslam_tpu/utils/evaluation.py``.
The reference evaluates accuracy offline with standard ATE/RPE tooling
against dataset ground truth (SURVEY.md §4); this module provides the
same metrics in-repo so every run can report them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning x (N,3) onto y (N,3).

    Returns (R, t, s) with y ~ s R x + t. Standard Umeyama 1991.
    """
    mu_x = x.mean(0)
    mu_y = y.mean(0)
    xc, yc = x - mu_x, y - mu_y
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc ** 2).sum() / len(x)
        s = float(np.trace(np.diag(D) @ S) / var_x)
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE between (F,4,4) pose arrays (uses
    translation components; SE(3) alignment unless align=False)."""
    p_est = est[:, :3, 3]
    p_gt = gt[:, :3, 3]
    if align:
        R, t, _ = umeyama_alignment(p_est, p_gt)
        p_est = p_est @ R.T + t
    err = p_est - p_gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Relative pose error over frame gaps of ``delta``.

    Returns (translational RMSE in m, rotational RMSE in rad).
    """
    ts, rs = [], []
    for i in range(len(est) - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        ts.append(np.linalg.norm(e[:3, 3]))
        ang = np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))
        rs.append(ang)
    return float(np.sqrt(np.mean(np.array(ts) ** 2))), \
        float(np.sqrt(np.mean(np.array(rs) ** 2)))


def kitti_odometry_error(est: np.ndarray, gt: np.ndarray,
                         lengths=(100.0, 200.0, 300.0, 400.0, 500.0,
                                  600.0, 700.0, 800.0)):
    """KITTI odometry benchmark metric: average translational error (%)
    and rotational error (deg/m) over all subsequences of the standard
    lengths — the headline accuracy numbers of the PL-SLAM paper's
    KITTI tables (reference evaluation protocol; SURVEY §6).

    est/gt: (N, 4, 4) camera-to-world poses. Returns
    (t_err_percent, r_err_deg_per_m, n_segments); NaNs if the
    trajectory is shorter than the smallest segment length.
    """
    n = min(len(est), len(gt))
    est, gt = np.asarray(est[:n]), np.asarray(gt[:n])
    # cumulative ground-truth path length per frame
    steps = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)
    dist = np.concatenate([[0.0], np.cumsum(steps)])

    t_errs, r_errs = [], []
    step = 10  # start a segment every 10 frames (KITTI protocol)
    for first in range(0, n, step):
        for seg_len in lengths:
            # first frame at >= seg_len further along the path
            target = dist[first] + seg_len
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            dgt = np.linalg.inv(gt[first]) @ gt[last]
            dest = np.linalg.inv(est[first]) @ est[last]
            err = np.linalg.inv(dest) @ dgt
            t_err = np.linalg.norm(err[:3, 3])
            r_err = np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2,
                                      -1.0, 1.0))
            t_errs.append(t_err / seg_len)
            r_errs.append(r_err / seg_len)
    if not t_errs:
        return float("nan"), float("nan"), 0
    return (100.0 * float(np.mean(t_errs)),
            float(np.degrees(np.mean(r_errs))), len(t_errs))
