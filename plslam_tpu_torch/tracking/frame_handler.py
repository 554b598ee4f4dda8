"""Frame-to-frame stereo VO (port of
``plslam_tpu/tracking/frame_handler.py``).

``match_f2f_points``, ``match_f2f_lines``, ``build_point_terms`` and
``build_line_terms`` are batched over B frame pairs (the chunked VO runs
them at B = 20). The per-frame driver ``StereoVO`` runs them at B = 1:
``track_step`` matches one pair and solves its pose (kernel D at
1 x K^2, kernel I at B = 1), ``KeyframeCriterion`` decides keyframes on
the host in numpy, as the reference's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from plslam_tpu_torch import resolve_device
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.frontend.stereo_frame import _frame
from plslam_tpu_torch.frontend.stereo_lines import pair_dang
from plslam_tpu_torch.frontend.stereo_points import extract_stereo_points
from plslam_tpu_torch.ops import hamming
from plslam_tpu_torch.ops.gather import take
from plslam_tpu_torch.tracking import pose_gn


def match_f2f_points(prev: PointObservations, cur: PointObservations,
                     T_prior: torch.Tensor, cam: StereoCamera,
                     cfg: SlamConfig) -> hamming.MatchResult:
    """matchF2FPoints: search the current frame in a window around the
    position predicted by the constant-velocity prior (B, 4, 4)."""
    m = cfg.matching
    uv_pred = cam.project(lie.transform_points(T_prior, prev.P))
    gate = hamming.Window(uv_pred, cur.uv, m.f2f_window, prev.octave,
                          cur.octave)
    return hamming.match_gated(prev.desc, cur.desc, prev.valid, cur.valid,
                               gate, m.max_hamming_p, m.min_ratio_12_p,
                               mutual=m.best_lr_matches)


def match_f2f_lines(prev: LineObservations, cur: LineObservations,
                    T_prior: torch.Tensor, cam: StereoCamera,
                    cfg: SlamConfig) -> hamming.MatchResult:
    """matchF2FLines: LBD NN within a window around the predicted
    midpoint, gated on angular consistency (undirected segments)."""
    m = cfg.matching
    mid_prev = 0.5 * (prev.sP + prev.eP)
    mid_pred = cam.project(lie.transform_points(T_prior, mid_prev))
    mid_cur = 0.5 * (cur.sp + cur.ep)
    win = hamming.window_mask(mid_pred, mid_cur, m.f2f_window)
    ang_ok = pair_dang(prev.angle, cur.angle) < 0.3
    return hamming.match_gated(prev.desc, cur.desc, prev.valid, cur.valid,
                               hamming.Mask(win & ang_ok), m.max_hamming_l,
                               m.min_ratio_12_l, mutual=m.best_lr_matches)


def build_point_terms(prev: PointObservations, cur: PointObservations,
                      mres: hamming.MatchResult) -> pose_gn.PointTerms:
    uv_obs = take(cur.uv, torch.clamp(mres.idx, min=0))
    return pose_gn.PointTerms(prev.P, uv_obs, mres.valid & prev.valid)


def build_line_terms(prev: LineObservations, cur: LineObservations,
                     mres: hamming.MatchResult) -> pose_gn.LineTerms:
    le_obs = take(cur.le, torch.clamp(mres.idx, min=0))
    return pose_gn.LineTerms(prev.sP, prev.eP, le_obs,
                             mres.valid & prev.valid)


class TrackOutput(NamedTuple):
    pose: pose_gn.PoseResult    # one pair: no batch axis
    n_matches_pt: torch.Tensor
    n_matches_ln: torch.Tensor
    match_idx_pt: torch.Tensor  # (K,) prev -> cur index or -1
    match_idx_ln: torch.Tensor  # (L,) prev -> cur index or -1


def _batch1(feats):
    return None if feats is None else type(feats)(*(x[None] for x in feats))


def track_step(prev_pts: PointObservations,
               prev_lns: Optional[LineObservations],
               cur_pts: PointObservations, cur_lns: Optional[LineObservations],
               T_prior: torch.Tensor, cam: StereoCamera, cfg: SlamConfig
               ) -> TrackOutput:
    """f2fTracking + optimizePose for one pair (features without a batch
    axis, ``T_prior`` (4, 4)), run as a batch of 1."""
    dev = T_prior.device
    prev_p, cur_p = _batch1(prev_pts), _batch1(cur_pts)
    T = T_prior[None]
    if cfg.points.has_points and prev_pts.uv.shape[0] > 0:
        mp = match_f2f_points(prev_p, cur_p, T, cam, cfg)
        pt_terms = build_point_terms(prev_p, cur_p, mp)
        mp_idx, n_pt = mp.idx[0], mp.valid[0].sum()
    else:
        pt_terms = pose_gn.no_point_terms(1, dev)
        mp_idx = torch.zeros((0,), dtype=torch.int32, device=dev)
        n_pt = torch.zeros((), dtype=torch.int64, device=dev)
    if prev_lns is not None and cfg.lines.has_lines:
        prev_l, cur_l = _batch1(prev_lns), _batch1(cur_lns)
        ml = match_f2f_lines(prev_l, cur_l, T, cam, cfg)
        ln_terms = build_line_terms(prev_l, cur_l, ml)
        ml_idx, n_ln = ml.idx[0], ml.valid[0].sum()
    else:
        ln_terms = None
        ml_idx = torch.zeros((0,), dtype=torch.int32, device=dev)
        n_ln = torch.zeros((), dtype=torch.int64, device=dev)
    res = pose_gn.optimize_pose(T, cam, pt_terms, ln_terms, cfg)
    return TrackOutput(_frame(res, 0), n_pt, n_ln, mp_idx, ml_idx)


class KeyframeCriterion:
    """currFrameIsKF, on the host: the covariance-entropy ratio of the
    motion accumulated since the last KF (adjoint-compounded) against the
    first post-KF frame, plus the max translation / rotation caps."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.cov_kf: Optional[np.ndarray] = None
        self.entropy_first: Optional[float] = None
        self.frames_since_kf = 0

    def reset(self) -> None:
        self.cov_kf = None
        self.entropy_first = None
        self.frames_since_kf = 0

    @staticmethod
    def _adjoint_np(T: np.ndarray) -> np.ndarray:
        R = T[:3, :3]
        t = T[:3, 3]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]], T.dtype)
        out = np.zeros((6, 6), T.dtype)
        out[:3, :3] = R
        out[:3, 3:] = tx @ R
        out[3:, 3:] = R
        return out

    def update(self, DT: np.ndarray, cov: np.ndarray, good: bool,
               T_from_kf: np.ndarray) -> Tuple[bool, float]:
        """Feed one tracked frame; returns (is_kf, entropy_ratio)."""
        self.frames_since_kf += 1
        if self.cov_kf is None:
            self.cov_kf = cov
        else:
            Adj = self._adjoint_np(np.asarray(DT))
            self.cov_kf = Adj @ self.cov_kf @ Adj.T + cov
        sign, logdet = np.linalg.slogdet(self.cov_kf)
        h = 0.5 * logdet if sign > 0 else -np.inf
        if self.entropy_first is None:
            self.entropy_first = h
        ratio = h / self.entropy_first if self.entropy_first != 0 else 1.0

        t_dist = float(np.linalg.norm(T_from_kf[:3, 3]))
        r_dist = float(np.arccos(np.clip(
            (np.trace(T_from_kf[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)))
        k = self.cfg.keyframe
        is_kf = good and self.frames_since_kf >= k.min_kf_n_frames and (
            ratio < k.min_entropy_ratio
            or t_dist > k.max_kf_t_dist
            or r_dist > np.deg2rad(k.max_kf_r_dist))
        if is_kf:
            self.reset()
        return is_kf, ratio


class FrameResult(NamedTuple):
    """Host-side per-frame output (numpy scalars / small arrays)."""
    T_wc: np.ndarray        # (4, 4) camera-to-world pose of this frame
    DT: np.ndarray          # (4, 4) relative pose prev->cur (prev coords)
    good: bool
    is_kf: bool
    n_inliers: int
    err: float
    entropy_ratio: float


class StereoVO:
    """The per-frame driver (StereoFrameHandler): keeps the previous
    frame's features on the device and the trajectory on the host.

    ``extract_fn(img_l, img_r) -> (pts, lns)`` extracts one pair (e.g.
    ``stereo_frame.make_extractor`` for points and lines); the default is
    the points-only front end. Runs on ``device`` (default: the CUDA
    device; raises without one)."""

    def __init__(self, cfg: SlamConfig, cam: Optional[StereoCamera] = None,
                 extract_fn=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam if cam is not None else StereoCamera.from_config(
            cfg.camera)
        self._extract = extract_fn or self._extract_points
        self.prev_pts: Optional[PointObservations] = None
        self.prev_lns: Optional[LineObservations] = None
        self.T_wc = np.eye(4, dtype=np.float32)
        self.DT_prev = np.eye(4, dtype=np.float32)
        self.kf_criterion = KeyframeCriterion(cfg)
        self.T_kf = np.eye(4, dtype=np.float32)   # pose of the last KF
        self.trajectory = []     # list of (4, 4) np poses

    def _put(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32).to(self.device)

    def _extract_points(self, img_l, img_r):
        pts = extract_stereo_points(self._put(img_l)[None],
                                    self._put(img_r)[None], self.cam,
                                    self.cfg)
        return _frame(pts, 0), None

    def initialize(self, img_l, img_r) -> FrameResult:
        self.prev_pts, self.prev_lns = self._extract(img_l, img_r)
        self.trajectory = [self.T_wc.copy()]
        return FrameResult(self.T_wc.copy(), np.eye(4, dtype=np.float32),
                           True, True, 0, 0.0, 1.0)

    def insert_stereo_pair(self, img_l, img_r) -> FrameResult:
        assert self.prev_pts is not None, "call initialize() first"
        cur_pts, cur_lns = self._extract(img_l, img_r)
        out = track_step(self.prev_pts, self.prev_lns, cur_pts, cur_lns,
                         torch.from_numpy(self.DT_prev).to(self.device),
                         self.cam, self.cfg)
        res = out.pose
        good = bool(res.good)
        if good:
            DT = res.T.cpu().numpy()
            cov = res.cov.cpu().numpy()
        else:
            # tracking failure: keep the prior, flag the frame
            DT = self.DT_prev.copy()
            cov = np.eye(6, dtype=np.float32) * 1e3

        # updateFrame
        self.T_wc = (self.T_wc @ np.linalg.inv(DT)).astype(np.float32)
        self.DT_prev = DT
        self.prev_pts, self.prev_lns = cur_pts, cur_lns
        self.trajectory.append(self.T_wc.copy())

        T_from_kf = np.linalg.inv(self.T_kf) @ self.T_wc
        is_kf, ratio = self.kf_criterion.update(DT, cov, good, T_from_kf)
        if is_kf:
            self.T_kf = self.T_wc.copy()
        return FrameResult(self.T_wc.copy(), DT, good, is_kf,
                           int(res.n_inliers), float(res.err), ratio)

    @property
    def current_features(self
                         ) -> Tuple[PointObservations,
                                    Optional[LineObservations]]:
        return self.prev_pts, self.prev_lns
