"""Stereo frame extraction, points and lines (port of
``plslam_tpu/frontend/stereo_frame.py``: ``extract_stereo_frame``,
``make_extractor``; and ``tracking/batch_vo.py::extract_one``).

Batched over B stereo pairs: the B left and B right images go through the
point and the line front ends as one batch of 2B each, then the
left/right sets of each pair are matched on the rectified rows. One pair
is a batch of 1 (``extract_one``, ``make_extractor``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from plslam_tpu_torch import resolve_device
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.frontend.stereo_lines import (
    detect_and_describe_lines, match_stereo_lines)
from plslam_tpu_torch.frontend.stereo_points import stereo_points_of


def extract_stereo_frame(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                         cam: StereoCamera, cfg: SlamConfig,
                         u8_wrap: bool = False
                         ) -> Tuple[PointObservations,
                                    Optional[LineObservations]]:
    """(B, H, W) f32 left/right images -> points and (with
    ``lines.has_lines``) lines, each with a leading B axis. ``u8_wrap``:
    the images are uint8 values taken unscaled, and the line detector's
    full-resolution Sobel wraps as the reference's uint8 subtraction.
    Without ``points.has_points`` (the lines-only configuration) the
    points are a zero-capacity set and the point front end does not run."""
    B = imgs_l.shape[0]
    both = torch.cat([imgs_l, imgs_r])
    lns = None
    if cfg.lines.has_lines:
        segs, d = detect_and_describe_lines(both, cfg, u8_wrap)
        segs_l = type(segs)(*(x[:B] for x in segs))
        segs_r = type(segs)(*(x[B:] for x in segs))
        lns = match_stereo_lines(segs_l, d[:B], segs_r, d[B:], cam, cfg)
    if not cfg.points.has_points:
        return no_points(B, imgs_l.device), lns
    return stereo_points_of(both, cam, cfg), lns


def no_points(B: int, device) -> PointObservations:
    """The lines-only configuration's point set: capacity 0, a leading B
    axis, the reference's fields and dtypes."""
    z = lambda *s, dtype=torch.float32: torch.zeros((B, 0) + s, dtype=dtype,
                                                    device=device)
    return PointObservations(uv=z(2), uv_r=z(2), disp=z(), P=z(3),
                             desc=z(256, dtype=torch.uint8),
                             octave=z(dtype=torch.int32), angle=z(),
                             score=z(), valid=z(dtype=torch.bool))


def _frame(feats, i):
    """One frame of a batched feature tuple (None stays None)."""
    return None if feats is None else type(feats)(*(x[i] for x in feats))


def extract_one(img_l: torch.Tensor, img_r: torch.Tensor, cam: StereoCamera,
                cfg: SlamConfig
                ) -> Tuple[PointObservations, Optional[LineObservations]]:
    """One (H, W) stereo pair -> its features (no batch axis). A uint8
    pair is taken UNSCALED (0..255 as f32), as the reference's
    ``extract_one`` takes it, uint8 arithmetic included: its line
    detector's Sobel y difference wraps modulo 256. Only the chunk steps
    scale uint8 to [0, 1]."""
    f32 = lambda x: x.to(torch.float32)[None]
    pts, lns = extract_stereo_frame(f32(img_l), f32(img_r), cam, cfg,
                                    u8_wrap=img_l.dtype == torch.uint8)
    return _frame(pts, 0), _frame(lns, 0)


def make_extractor(cam: StereoCamera, cfg: SlamConfig, device=None):
    """Extractor closure for the per-frame driver: ``fn(img_l, img_r) ->
    (pts, lns)`` for one pair (numpy or tensors), extracted on ``device``
    (default: the CUDA device; raises without one) as a batch of 1."""
    dev = resolve_device(device)

    def fn(img_l, img_r):
        return extract_one(torch.as_tensor(img_l).to(dev),
                           torch.as_tensor(img_r).to(dev), cam, cfg)
    return fn
