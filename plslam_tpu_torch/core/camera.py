"""Pinhole stereo camera and rectification (port of
``plslam_tpu/core/camera.py``).

The intrinsics are Python floats rounded to f32, so every product with an
f32 tensor rounds as the reference's f32 scalars do. The rectification
maps are built on the host in numpy (``build_rectify_map``,
``stereo_rectify``: copies of the reference's functions); applying a map
on the device is ``remap_bilinear``, kernel N (``csrc/remap.cu``), behind
``StereoRectifier``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from plslam_tpu_torch import native, resolve_device
from plslam_tpu_torch.config import CameraConfig


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


# -- rectification (host precompute + device gather) -------------------------

def radtan_distort(xn: np.ndarray, d: Tuple[float, ...]) -> np.ndarray:
    """Apply radial-tangential distortion to normalized coords (N, 2)."""
    k1, k2, p1, p2, k3 = (list(d) + [0.0] * 5)[:5]
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1)


def build_rectify_map(K_new: np.ndarray, K_orig: np.ndarray,
                      d: Tuple[float, ...], R_rect: np.ndarray, height: int,
                      width: int) -> np.ndarray:
    """Host-side undistort-rectify map (cv::initUndistortRectifyMap).

    Returns (H, W, 2) float32 source pixel coordinates (u, v) in the raw
    image for every rectified output pixel.
    """
    vs, us = np.mgrid[0:height, 0:width].astype(np.float64)
    xn = (us - K_new[0, 2]) / K_new[0, 0]
    yn = (vs - K_new[1, 2]) / K_new[1, 1]
    pts = np.stack([xn, yn, np.ones_like(xn)], axis=-1) @ R_rect  # R^T
    pts = pts[..., :2] / pts[..., 2:3]
    dist = radtan_distort(pts, d)
    u_src = K_orig[0, 0] * dist[..., 0] + K_orig[0, 2]
    v_src = K_orig[1, 1] * dist[..., 1] + K_orig[1, 2]
    return np.stack([u_src, v_src], axis=-1).astype(np.float32)


def _rot_sqrt(R: np.ndarray) -> np.ndarray:
    """Principal square root of a rotation matrix (half the rotation)."""
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-12:
        return np.eye(3)
    w = (1.0 / (2.0 * np.sin(theta))) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    half = 0.5 * theta
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(half) * K
            + (1 - np.cos(half)) * (K @ K)).astype(np.float64)


def stereo_rectify(K0: np.ndarray, d0: Tuple[float, ...],
                   K1: np.ndarray, d1: Tuple[float, ...],
                   R: np.ndarray, t: np.ndarray, height: int, width: int
                   ) -> Tuple[np.ndarray, np.ndarray, CameraConfig]:
    """Full stereo rectification of a raw (distorted, unaligned) rig
    (cv::stereoRectify + initUndistortRectifyMap, as
    pinholeStereoCamera.cpp::rectifyImagesLR uses them).

    ``R, t`` map left-camera coords to right-camera coords,
    ``x_r = R x_l + t``. Returns two (H, W, 2) gather maps and the
    rectified :class:`CameraConfig` (fx = fy, no distortion, baseline
    |t|). Both cameras turn by half of R; a common rotation then takes the
    halved baseline to the -x axis, so ``x_r' = x_l' - [b, 0, 0]``.
    """
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64).reshape(3)
    Rh = _rot_sqrt(R)                    # R ** 0.5
    t_mid = Rh.T @ t                     # baseline seen from the mid frame
    b = float(np.linalg.norm(t))
    e1 = -t_mid / np.linalg.norm(t_mid)
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    n = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n < 1e-9 else e2 / n
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3], axis=0)
    R1 = Rw @ Rh                         # applied to left-camera coords
    R2 = Rw @ Rh.T                       # = Rw R**-0.5, applied to right

    f_new = 0.5 * (float(K0[0, 0]) + float(K0[1, 1]))
    K_new = np.array([[f_new, 0, width / 2.0],
                      [0, f_new, height / 2.0],
                      [0, 0, 1.0]])
    map_l = build_rectify_map(K_new, np.asarray(K0, np.float64), tuple(d0),
                              R1, height, width)
    map_r = build_rectify_map(K_new, np.asarray(K1, np.float64), tuple(d1),
                              R2, height, width)
    cam_cfg = CameraConfig(width=width, height=height, fx=f_new, fy=f_new,
                           cx=width / 2.0, cy=height / 2.0, baseline=b)
    return map_l, map_r, cam_cfg


def _remap_shapes(img: torch.Tensor, mapping: torch.Tensor):
    """(N, H, W) view of ``img`` and whether ``mapping`` holds one map per
    image: (H', W', 2) is shared, (*lead, H', W', 2) is one per image."""
    lead = img.shape[:-2]
    if mapping.ndim == 3:
        per_image = False
    elif mapping.shape[:-3] == lead:
        per_image = True
    else:
        raise ValueError(f"remap_bilinear: map {tuple(mapping.shape)} fits "
                         f"neither (H', W', 2) nor images {tuple(lead)}")
    if mapping.shape[-1] != 2:
        raise ValueError("remap_bilinear: the map's last axis must be (u, v)")
    return img.reshape((-1,) + img.shape[-2:]), per_image


def remap_bilinear_plain(img: torch.Tensor, mapping: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of kernel N (the reference's arithmetic)."""
    flat, per_image = _remap_shapes(img, mapping)
    N, H, W = flat.shape
    Ho, Wo = mapping.shape[-3:-1]
    m = mapping.reshape((N if per_image else 1, Ho * Wo, 2))
    u, v = m[..., 0], m[..., 1]
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    fu = u - u0.to(torch.float32)
    fv = v - v0.to(torch.float32)
    src = flat.reshape(N, H * W)

    def tap(vi, ui):
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        idx = (torch.clamp(vi, 0, H - 1) * W
               + torch.clamp(ui, 0, W - 1)).long()
        val = torch.gather(src, 1, idx.expand(N, -1))
        return torch.where(inb, val, 0.0)

    p00 = tap(v0, u0)
    p01 = tap(v0, u0 + 1)
    p10 = tap(v0 + 1, u0)
    p11 = tap(v0 + 1, u0 + 1)
    top = p00 * (1 - fu) + p01 * fu
    bot = p10 * (1 - fu) + p11 * fu
    out = top * (1 - fv) + bot * fv
    return out.reshape(img.shape[:-2] + (Ho, Wo))


def remap_bilinear(img: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """Bilinear remap, the gather form of cv::remap: (..., H, W) f32
    images and a (H', W', 2) f32 (u, v) map, or one map per image
    (*lead, H', W', 2), -> (..., H', W'). A tap outside the image reads
    0. Kernel N on a CUDA tensor, the plain version on a CPU tensor."""
    if img.device.type == "cpu":
        return remap_bilinear_plain(img, mapping)
    flat, per_image = _remap_shapes(img, mapping)
    N, H, W = flat.shape
    Ho, Wo = mapping.shape[-3:-1]
    native.require(flat, "remap_bilinear img", torch.float32)
    native.require(mapping, "remap_bilinear map", torch.float32)
    if mapping.data_ptr() % 8:
        raise ValueError("remap_bilinear: the map must be 8-byte aligned "
                         "(it is read as float2)")
    out = torch.empty((N, Ho, Wo), dtype=torch.float32, device=img.device)
    native.launch("remap_bilinear", flat, mapping, out, N, H, W, Ho, Wo,
                  int(per_image))
    return out.reshape(img.shape[:-2] + (Ho, Wo))


class StereoRectifier:
    """Device-side raw -> rectified warp of a stereo pair (the cv::remap
    stage of rectifyImagesLR). The two maps stay on ``device`` (default:
    the CUDA device; raises without one); each pair is one launch of
    kernel N, left and right a batch of two, each with its own map."""

    def __init__(self, map_l: np.ndarray, map_r: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.maps = torch.from_numpy(np.stack(
            [np.asarray(map_l, np.float32),
             np.asarray(map_r, np.float32)])).to(self.device)

    def __call__(self, img_l, img_r) -> Tuple[torch.Tensor, torch.Tensor]:
        pair = torch.stack([torch.as_tensor(img_l, dtype=torch.float32),
                            torch.as_tensor(img_r, dtype=torch.float32)]
                           ).to(self.device)
        out = remap_bilinear(pair, self.maps)
        return out[0], out[1]
