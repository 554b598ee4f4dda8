"""Rectified pinhole stereo camera (port of ``plslam_tpu/core/camera.py``).

The intrinsics are Python floats rounded to f32, so every product with an
f32 tensor rounds as the reference's f32 scalars do. ``remap_bilinear``
(undistort/rectify) is not on the points-only VO path and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


class StereoCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    b: float                # baseline, metres
    width: int
    height: int

    @staticmethod
    def from_config(cam_cfg) -> "StereoCamera":
        return StereoCamera(
            fx=_f32(cam_cfg.fx), fy=_f32(cam_cfg.fy), cx=_f32(cam_cfg.cx),
            cy=_f32(cam_cfg.cy), b=_f32(cam_cfg.baseline),
            width=int(cam_cfg.width), height=int(cam_cfg.height))

    @property
    def fxb(self) -> float:
        """fx * b rounded as the reference's f32 product."""
        return float(np.float32(self.fx) * np.float32(self.b))

    @staticmethod
    def _safe_z(z: torch.Tensor) -> torch.Tensor:
        return torch.where(torch.abs(z) < 1e-7, torch.full_like(z, 1e-7), z)

    def project(self, P: torch.Tensor) -> torch.Tensor:
        """(..., 3) camera-frame points -> (..., 2) left-image pixels."""
        z = self._safe_z(P[..., 2])
        u = self.fx * P[..., 0] / z + self.cx
        v = self.fy * P[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)

    def back_project(self, uv: torch.Tensor, disp: torch.Tensor
                     ) -> torch.Tensor:
        """(..., 2) left pixels + (...,) disparity -> (..., 3) 3D points."""
        # tensor / tensor: ``float / tensor`` is reciprocal-then-multiply
        # in PyTorch, which rounds differently from the reference's divide
        d = self._safe_z(disp)
        z = torch.full_like(d, self.fxb) / d
        x = (uv[..., 0] - self.cx) * z / self.fx
        y = (uv[..., 1] - self.cy) * z / self.fy
        return torch.stack([x, y, z], dim=-1)

    def in_image(self, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
        return ((uv[..., 0] >= margin) & (uv[..., 0] < self.width - margin)
                & (uv[..., 1] >= margin) & (uv[..., 1] < self.height - margin))

    def project_jacobian(self, P: torch.Tensor) -> torch.Tensor:
        """d(pixel)/d(camera point): (..., 2, 3)."""
        x, y = P[..., 0], P[..., 1]
        iz = 1.0 / self._safe_z(P[..., 2])
        iz2 = iz * iz
        zz = torch.zeros_like(x)
        row0 = torch.stack([self.fx * iz, zz, -self.fx * x * iz2], dim=-1)
        row1 = torch.stack([zz, self.fy * iz, -self.fy * y * iz2], dim=-1)
        return torch.stack([row0, row1], dim=-2)
