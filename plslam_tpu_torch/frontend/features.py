"""Fixed-capacity feature containers (port of
``plslam_tpu/frontend/features.py``).

Struct-of-arrays with validity masks. The port's tensors may carry a
leading batch dimension (frames of a chunk) before the capacity axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointObservations(NamedTuple):
    """Stereo-matched point features of one frame (capacity K, masked)."""
    uv: torch.Tensor        # (K, 2) left pixel, level-0 coords
    uv_r: torch.Tensor      # (K, 2) right pixel
    disp: torch.Tensor      # (K,)
    P: torch.Tensor         # (K, 3) 3D in this frame's left-camera frame
    desc: torch.Tensor      # (K, 256) uint8 bits
    octave: torch.Tensor    # (K,) int32
    angle: torch.Tensor     # (K,)
    score: torch.Tensor     # (K,)
    valid: torch.Tensor     # (K,) bool — detected AND stereo-matched


class LineObservations(NamedTuple):
    """Stereo-matched line segments (capacity L, masked). A type only in
    this slice: the line front end is not ported yet."""
    sp: torch.Tensor        # (L, 2) start endpoint, left image
    ep: torch.Tensor        # (L, 2) end endpoint, left image
    le: torch.Tensor        # (L, 3) normalized line equation sp x ep
    angle: torch.Tensor     # (L,)
    sdisp: torch.Tensor     # (L,)
    edisp: torch.Tensor     # (L,)
    sP: torch.Tensor        # (L, 3) 3D start
    eP: torch.Tensor        # (L, 3) 3D end
    desc: torch.Tensor      # (L, 256) uint8 LBD bits
    score: torch.Tensor     # (L,) detector support strength
    valid: torch.Tensor     # (L,) bool
