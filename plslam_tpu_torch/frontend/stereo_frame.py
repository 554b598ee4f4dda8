"""Stereo frame extraction, points and lines (port of
``plslam_tpu/frontend/stereo_frame.py::extract_stereo_frame``).

Batched over B stereo pairs: the B left and B right images go through the
point and the line front ends as one batch of 2B each, then the
left/right sets of each pair are matched on the rectified rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.frontend.stereo_lines import (
    detect_and_describe_lines, match_stereo_lines)
from plslam_tpu_torch.frontend.stereo_points import (detect_and_describe,
                                                     match_stereo_points)
from plslam_tpu_torch.ops.gather import take


def extract_stereo_frame(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                         cam: StereoCamera, cfg: SlamConfig,
                         u8_wrap: bool = False
                         ) -> Tuple[PointObservations,
                                    Optional[LineObservations]]:
    """(B, H, W) f32 left/right images -> points and (with
    ``lines.has_lines``) lines, each with a leading B axis. ``u8_wrap``:
    the images are uint8 values taken unscaled, and the line detector's
    full-resolution Sobel wraps as the reference's uint8 subtraction."""
    if not cfg.points.has_points:
        raise NotImplementedError(
            "the lines-only configuration (points.has_points=False) is "
            "ROADMAP Queue 1 of the port")
    B = imgs_l.shape[0]
    both = torch.cat([imgs_l, imgs_r])
    lns = None
    if cfg.lines.has_lines:
        segs, d = detect_and_describe_lines(both, cfg, u8_wrap)
        segs_l = type(segs)(*(x[:B] for x in segs))
        segs_r = type(segs)(*(x[B:] for x in segs))
        lns = match_stereo_lines(segs_l, d[:B], segs_r, d[B:], cam, cfg)
    uv, desc, octv, ang, sc, val = detect_and_describe(both, cfg)
    uv_l, uv_r = uv[:B], uv[B:]
    mres = match_stereo_points(uv_l, desc[:B], octv[:B], val[:B],
                               uv_r, desc[B:], octv[B:], val[B:], cfg)
    uv_rm = take(uv_r, torch.clamp(mres.idx, min=0))
    disp = uv_l[..., 0] - uv_rm[..., 0]
    valid = mres.valid & val[:B] & (disp > cfg.matching.min_disp)
    P = cam.back_project(uv_l, torch.where(valid, disp, 1.0))
    pts = PointObservations(uv=uv_l, uv_r=uv_rm, disp=disp, P=P,
                            desc=desc[:B], octave=octv[:B], angle=ang[:B],
                            score=sc[:B], valid=valid)
    return pts, lns
