"""SE(3)/SO(3) Lie-group operations on batched f32 tensors.

Port of ``plslam_tpu/core/lie.py``: same conventions and the same
small-angle guards.

Conventions:
  * Poses are 4x4 homogeneous matrices ``T = [[R, t], [0, 1]]``.
  * Twists are 6-vectors ``xi = (v, w)`` — translation first.
  * ``exp_se3`` is left-multiplicative: an update is ``T <- exp_se3(dxi) @ T``.

Every product here is a tiny (3x3/4x4) f32 matmul; TF32 is off package-wide
(``plslam_tpu_torch/__init__.py``), so they run in full f32 as the
reference's HIGHEST-precision ``mm``.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8
# small-angle switch on theta^2 (the Taylor branch below t = 0.01)
_SMALL_THETA2 = 1e-4


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _sinc_terms(theta2: torch.Tensor):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (1-A)/t^2 with Taylor fallbacks."""
    small = theta2 < _SMALL_THETA2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / t2)
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        like.shape[:-2] + (3, 3))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    A, B, _ = _sinc_terms(torch.sum(w * w, dim=-1))
    W = skew(w)
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector (stable
    on [0, pi); near pi the axis comes from the symmetric part)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    small = theta < 1e-5
    near_pi = cos_t < -0.99
    safe_sin = torch.where(torch.abs(sin_t) < _EPS, torch.ones_like(sin_t),
                           sin_t)
    scale_gen = torch.where(small, 0.5 + theta * theta / 12.0,
                            theta / (2.0 * safe_sin))
    w_gen = scale_gen[..., None] * v
    s = torch.clamp(0.5 * torch.linalg.norm(v, dim=-1), 0.0, 1.0)
    theta_pi = math.pi - torch.arcsin(s)
    one_mc = torch.clamp(1.0 - cos_t, min=_EPS)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    n_abs = torch.sqrt(torch.clamp((diag - cos_t[..., None])
                                   / one_mc[..., None], 0.0, 1.0))
    k = torch.argmax(n_abs, dim=-1)
    Rsym = R + R.transpose(-1, -2)
    row_k = torch.take_along_dim(
        Rsym, k[..., None, None].expand(k.shape + (1, 3)), dim=-2)[..., 0, :]
    sign_j = torch.where(row_k >= 0, 1.0, -1.0)
    is_k = torch.arange(3, device=R.device) == k[..., None]
    sign_j = torch.where(is_k, 1.0, sign_j)
    axis = n_abs * sign_j
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=_EPS)
    sgn = torch.where(torch.sum(axis * v, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w_pi = theta_pi[..., None] * axis * sgn
    return torch.where(near_pi[..., None], w_pi, w_gen)


def _left_jacobian_V(w: torch.Tensor) -> torch.Tensor:
    _, B, C = _sinc_terms(torch.sum(w * w, dim=-1))
    W = skew(w)
    return _eye3(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _compose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist (v, w) -> (..., 4, 4) pose."""
    v, w = xi[..., :3], xi[..., 3:]
    t = (_left_jacobian_V(w) @ v[..., None])[..., 0]
    return _compose(exp_so3(w), t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose -> (..., 6) twist."""
    t = T[..., :3, 3]
    w = log_so3(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_terms(theta2)
    W = skew(w)
    small = theta2 < _SMALL_THETA2
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / t2)
    Vinv = _eye3(W) - 0.5 * W + coef[..., None, None] * (W @ W)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], dim=-1)


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid-motion inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _compose(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform_points(T: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    return P @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form Cholesky inverse of SPD (..., 3, 3) matrices, scale-
    normalised first (the reference's op order: its landmark blocks may be
    ~1e-7 I or ill-conditioned, where the adjugate form cancels)."""
    s = torch.clamp(torch.amax(torch.abs(M), dim=(-2, -1)), min=1e-30)
    M = M / s[..., None, None]
    eps = 1e-20
    a11, a21, a31 = M[..., 0, 0], M[..., 1, 0], M[..., 2, 0]
    a22, a32, a33 = M[..., 1, 1], M[..., 2, 1], M[..., 2, 2]
    l11 = torch.sqrt(torch.clamp(a11, min=eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a33 - l31 * l31 - l32 * l32, min=eps))
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -l21 * i11 * i22
    i32 = -l32 * i22 * i33
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    m11 = i11 * i11 + i21 * i21 + i31 * i31
    m12 = i21 * i22 + i31 * i32
    m13 = i31 * i33
    m22 = i22 * i22 + i32 * i32
    m23 = i32 * i33
    m33 = i33 * i33
    inv = torch.stack([torch.stack([m11, m12, m13], -1),
                       torch.stack([m12, m22, m23], -1),
                       torch.stack([m13, m23, m33], -1)], -2)
    return inv / s[..., None, None]


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6, 6) adjoint in the (v, w) ordering."""
    R = T[..., :3, :3]
    top = torch.cat([R, skew(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_distance(T: torch.Tensor):
    """Translation norm (m) and rotation angle (rad) of a relative pose."""
    t = torch.linalg.norm(T[..., :3, 3], dim=-1)
    trace = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    return t, torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def is_valid_rotation(R: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """Orthonormality + det(+1) check, batched."""
    ortho = torch.amax(torch.abs(R @ R.transpose(-1, -2) - _eye3(R)),
                       dim=(-1, -2)) < tol
    # cofactor expansion: a 3x3 determinant needs no LU factorisation
    det3 = (R[..., 0, 0] * (R[..., 1, 1] * R[..., 2, 2]
                            - R[..., 1, 2] * R[..., 2, 1])
            - R[..., 0, 1] * (R[..., 1, 0] * R[..., 2, 2]
                              - R[..., 1, 2] * R[..., 2, 0])
            + R[..., 0, 2] * (R[..., 1, 0] * R[..., 2, 1]
                              - R[..., 1, 1] * R[..., 2, 0]))
    return ortho & (torch.abs(det3 - 1.0) < tol)
