"""Point front end: multi-scale detection, description, stereo matching.

Port of ``plslam_tpu/frontend/stereo_points.py`` (``_level_capacities``,
``detect_and_describe``, ``match_stereo_points``,
``extract_stereo_points``), batched over images.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import PointObservations
from plslam_tpu_torch.ops import fast, hamming, orb
from plslam_tpu_torch.ops.gather import take
from plslam_tpu_torch.ops.image import _on, build_pyramid


def _level_capacities(total: int, n_levels: int, scale: float) -> List[int]:
    """Static per-level detection capacities, proportional to level area."""
    w = np.array([(1.0 / scale**2) ** i for i in range(n_levels)])
    caps = np.maximum((w / w.sum() * total).astype(int), 16)
    return [int(c) for c in caps]


def detect_and_describe(imgs: torch.Tensor, cfg: SlamConfig
                        ) -> Tuple[torch.Tensor, ...]:
    """Monocular ORB stage on N images (N, H, W).

    Returns (uv (N, K, 2) level-0 coords, desc (N, K, 256), octave (N, K),
    angle (N, K), score (N, K), valid (N, K)) with K = cfg.points.max_kpts.
    """
    p = cfg.points
    N = imgs.shape[0]
    levels = build_pyramid(imgs, p.orb_nlevels, p.orb_scale_factor)
    caps = _level_capacities(2 * p.max_kpts, p.orb_nlevels,
                             p.orb_scale_factor)
    uvs, octs, scores, valids = [], [], [], []
    for i, lvl in enumerate(levels):
        uv_i, s_i, v_i = fast.detect_fast(
            lvl, caps[i], th=p.fast_th / 255.0, th_min=p.fast_min_th / 255.0,
            adaptive=p.adaptative_fast, nms_radius=p.nms_radius,
            grid_rows=p.grid_rows, grid_cols=p.grid_cols,
            border=orb.PATCH_HALF + 1)
        inv_scale = float(np.float32(1.0 / p.orb_scale_factor ** i))
        uvs.append(uv_i)                                  # level-local
        octs.append(torch.full((N, caps[i]), i, dtype=torch.int32,
                               device=imgs.device))
        # slight preference for finer levels on ties
        scores.append(torch.where(v_i, s_i, -float("inf")) * inv_scale)
        valids.append(v_i)
    uv_lvl = torch.cat(uvs, dim=1)
    octave = torch.cat(octs, dim=1)
    score = torch.cat(scores, dim=1)
    valid = torch.cat(valids, dim=1)
    # global top-K across levels first; only the K winners are described
    top_s, top_i = fast.top_k(score, p.max_kpts)
    uv_sel = take(uv_lvl, top_i)
    oct_sel = take(octave, top_i)
    val_sel = take(valid, top_i)
    desc, angle = orb.describe_multilevel(levels, uv_sel, oct_sel)
    scale_tab = _on(np.asarray([p.orb_scale_factor ** i
                                for i in range(p.orb_nlevels)], np.float32),
                    imgs.device)
    uv0 = uv_sel * scale_tab[oct_sel.long()][..., None]
    finite = torch.isfinite(top_s)
    return (uv0, desc, oct_sel, angle,
            torch.where(finite, top_s, 0.0), val_sel & finite)


def match_stereo_points(uv_l, desc_l, oct_l, valid_l,
                        uv_r, desc_r, oct_r, valid_r,
                        cfg: SlamConfig) -> hamming.MatchResult:
    """Rectified stereo correspondence, batched over B frames: same-row
    window, disparity in [min_disp, max_disp], octaves within 1, Hamming
    NN + ratio + mutual best."""
    m = cfg.matching
    gate = hamming.Stereo(uv_l, uv_r, oct_l, oct_r, m.stereo_row_tol,
                          m.min_disp, m.max_disp)
    return hamming.match_gated(desc_l, desc_r, valid_l, valid_r, gate,
                               m.max_hamming_p, m.min_ratio_12_p,
                               mutual=m.best_lr_matches)


def extract_stereo_points(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                          cam: StereoCamera, cfg: SlamConfig
                          ) -> PointObservations:
    """The stereo point front end for B rectified pairs (B, H, W): the
    left and right images go through the detector as one batch of 2B,
    then each pair is matched on its rows and triangulated."""
    return stereo_points_of(torch.cat([imgs_l, imgs_r]), cam, cfg)


def stereo_points_of(both: torch.Tensor, cam: StereoCamera,
                     cfg: SlamConfig) -> PointObservations:
    """:func:`extract_stereo_points` of the (2B, H, W) left-then-right
    batch."""
    B = both.shape[0] // 2
    uv, desc, octv, ang, sc, val = detect_and_describe(both, cfg)
    uv_l, uv_r = uv[:B], uv[B:]
    mres = match_stereo_points(uv_l, desc[:B], octv[:B], val[:B],
                               uv_r, desc[B:], octv[B:], val[B:], cfg)
    uv_rm = take(uv_r, torch.clamp(mres.idx, min=0))
    disp = uv_l[..., 0] - uv_rm[..., 0]
    valid = mres.valid & val[:B] & (disp > cfg.matching.min_disp)
    P = cam.back_project(uv_l, torch.where(valid, disp, 1.0))
    return PointObservations(uv=uv_l, uv_r=uv_rm, disp=disp, P=P,
                             desc=desc[:B], octave=octv[:B], angle=ang[:B],
                             score=sc[:B], valid=valid)
