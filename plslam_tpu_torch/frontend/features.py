"""Fixed-capacity feature containers (port of
``plslam_tpu/frontend/features.py``).

Struct-of-arrays with validity masks. The port's tensors may carry a
leading batch dimension (frames of a chunk) before the capacity axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from plslam_tpu_torch.ops.lines import sqrt_rn


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
    """Stereo-matched line segments (capacity L, masked)."""
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


def line_equation(sp: torch.Tensor, ep: torch.Tensor) -> torch.Tensor:
    """Normalized homogeneous 2D line through two pixels: le = sp x ep,
    scaled so (le_0, le_1) is a unit normal; le . (u, v, 1) is then the
    signed perpendicular distance (the line residual)."""
    # the cross product of (x0, y0, 1) and (x1, y1, 1), in the reference's
    # operation order (jnp.cross)
    x0, y0 = sp[..., 0], sp[..., 1]
    x1, y1 = ep[..., 0], ep[..., 1]
    le = torch.stack([y0 - y1, x1 - x0, x0 * y1 - y0 * x1], dim=-1)
    n = sqrt_rn(le[..., 0] ** 2 + le[..., 1] ** 2)
    return le / torch.clamp(n, min=1e-9)[..., None]
