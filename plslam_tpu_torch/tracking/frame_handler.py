"""Frame-to-frame matching and term building (port of
``plslam_tpu/tracking/frame_handler.py``: ``match_f2f_points``,
``match_f2f_lines``, ``build_point_terms``, ``build_line_terms``),
batched over B frame pairs. The per-frame driver ``StereoVO`` is not
ported yet.
"""

from __future__ import annotations

import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.frontend.stereo_lines import pair_dang
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
    win = hamming.window_mask(uv_pred, cur.uv, m.f2f_window)
    oct_ok = torch.abs(prev.octave[..., :, None] - cur.octave[..., None, :]
                       ) <= 1
    dist = hamming.hamming_matrix(prev.desc, cur.desc, prev.valid, cur.valid,
                                  win & oct_ok)
    return hamming.match_nnr(dist, m.max_hamming_p, m.min_ratio_12_p,
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
    dist = hamming.hamming_matrix(prev.desc, cur.desc, prev.valid, cur.valid,
                                  win & ang_ok)
    return hamming.match_nnr(dist, m.max_hamming_l, m.min_ratio_12_l,
                             mutual=m.best_lr_matches)


def build_point_terms(prev: PointObservations, cur: PointObservations,
                      mres: hamming.MatchResult) -> pose_gn.PointTerms:
    uv_obs = take(cur.uv, torch.clamp(mres.idx, min=0))
    return pose_gn.PointTerms(prev.P, uv_obs, mres.valid & prev.valid)


def build_line_terms(prev: LineObservations, cur: LineObservations,
                     mres: hamming.MatchResult) -> pose_gn.LineTerms:
    le_obs = take(cur.le, torch.clamp(mres.idx, min=0))
    return pose_gn.LineTerms(prev.sP, prev.eP, le_obs,
                             mres.valid & prev.valid)
