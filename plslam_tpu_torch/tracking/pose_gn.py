"""Robust Gauss-Newton SE(3) pose optimisation, batched over frame pairs.

Port of ``plslam_tpu/tracking/pose_gn.py`` (``point_terms_rj``,
``line_terms_rj``, ``_weights``, ``_assemble_normal_eqs``,
``optimize_pose``): every tensor carries a leading B axis (the frame pairs
of a chunk). On CUDA tensors ``optimize_pose`` (K13) is one launch of
kernel I (``csrc/pose_gn.cu``) for all B pairs: both GN phases (residuals,
Jacobians, the joint lower-median MAD scale, t-student weights, the 6x6
normal equations, the damped solve and the exp update, every iteration),
the outlier gate, the final statistics, the covariance and the gates.
``gn_iters`` launches the same kernel's phase-only form. Their plain
versions, ``optimize_pose_plain`` and ``gn_iters_plain`` (f32 ``einsum``s
and batched ``torch.linalg`` solves), run only for CPU tensors.
``optimize_pose_lm`` is not ported yet.

Residual/Jacobian conventions (left-multiplicative perturbation, twist
ordering (v, w) as in core.lie):
  point:  r = pi(T P) - uv_obs                       (2 scalars)
          dr/dxi = dpi/dPc @ [ I  -skew(Pc) ]        (2x6)
  line:   r_s = le . (u_s, v_s, 1),  r_e likewise    (2 scalars)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie, robust
from plslam_tpu_torch.core.camera import StereoCamera


class PointTerms(NamedTuple):
    """Matched f2f point terms: previous-frame 3D vs current observation."""
    P: torch.Tensor         # (B, K, 3) 3D in previous frame
    uv_obs: torch.Tensor    # (B, K, 2) observed pixel in current frame
    valid: torch.Tensor     # (B, K) bool


class LineTerms(NamedTuple):
    """Matched f2f line terms: previous 3D endpoints vs current 2D line."""
    sP: torch.Tensor        # (B, L, 3)
    eP: torch.Tensor        # (B, L, 3)
    le_obs: torch.Tensor    # (B, L, 3) normalized observed line equation
    valid: torch.Tensor     # (B, L) bool


class PoseResult(NamedTuple):
    T: torch.Tensor          # (B, 4, 4) optimized relative pose
    cov: torch.Tensor        # (B, 6, 6) pose covariance
    n_inliers: torch.Tensor  # (B,) int32 (points + line segments)
    err: torch.Tensor        # (B,) f32 robust RMS residual of inliers
    inlier_pt: torch.Tensor  # (B, K) bool
    inlier_ln: torch.Tensor  # (B, L) bool
    good: torch.Tensor       # (B,) bool — isGoodSolution gates


def _se3_point_jacobian(cam: StereoCamera, Pc: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) transformed points -> (..., N, 2, 6) d(pixel)/d(twist)."""
    Jproj = cam.project_jacobian(Pc)                       # (..., 2, 3)
    eye = torch.eye(3, dtype=Pc.dtype, device=Pc.device).expand(
        Pc.shape[:-1] + (3, 3))
    return Jproj @ torch.cat([eye, -lie.skew(Pc)], dim=-1)


def point_terms_rj(T: torch.Tensor, cam: StereoCamera, terms: PointTerms
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> residuals (B, K, 2), jacobians (B, K, 2, 6), norms (B, K)."""
    Pc = lie.transform_points(T, terms.P)
    ok = terms.valid & ~(Pc[..., 2] < 0.1)
    r = torch.where(ok[..., None], cam.project(Pc) - terms.uv_obs, 0.0)
    J = torch.where(ok[..., None, None], _se3_point_jacobian(cam, Pc), 0.0)
    norm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    return r, J, norm


def line_terms_rj(T: torch.Tensor, cam: StereoCamera, terms: LineTerms
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> residuals (B, L, 2), jacobians (B, L, 2, 6), |r| (B, L, 2)."""
    le = terms.le_obs

    def endpoint(P3):
        Pc = lie.transform_points(T, P3)
        uv = cam.project(Pc)
        r = le[..., 0] * uv[..., 0] + le[..., 1] * uv[..., 1] + le[..., 2]
        J = torch.einsum("...i,...ij->...j", le[..., :2],
                         _se3_point_jacobian(cam, Pc))
        return r, J, Pc[..., 2] < 0.1

    r_s, J_s, bs = endpoint(terms.sP)
    r_e, J_e, be = endpoint(terms.eP)
    ok = terms.valid & ~bs & ~be
    r = torch.where(ok[..., None], torch.stack([r_s, r_e], dim=-1), 0.0)
    J = torch.where(ok[..., None, None], torch.stack([J_s, J_e], dim=-2), 0.0)
    return r, J, torch.abs(r)


def _assemble_normal_eqs(r_pt, J_pt, w_pt, r_ln, J_ln, w_ln):
    """Weighted (B, 6, 6) H and (B, 6) g from point and line terms."""
    H = (torch.einsum("bk,bkip,bkiq->bpq", w_pt, J_pt, J_pt)
         + torch.einsum("bli,blip,bliq->bpq", w_ln, J_ln, J_ln))
    g = (torch.einsum("bk,bkip,bki->bp", w_pt, J_pt, r_pt)
         + torch.einsum("bli,blip,bli->bp", w_ln, J_ln, r_ln))
    return H, g


def _weights(norm_pt, valid_pt, abs_ln, valid_ln):
    """Robust per-term weights from one joint MAD scale."""
    all_norms = torch.cat([norm_pt, abs_ln.flatten(-2)], dim=-1)
    all_valid = torch.cat([valid_pt, valid_ln.repeat_interleave(2, dim=-1)],
                          dim=-1)
    sigma = robust.mad_scale_zero_centered(all_norms, all_valid)
    w_pt = torch.where(valid_pt,
                       robust.tstudent_weight(norm_pt, sigma[..., None]), 0.0)
    w_ln = torch.where(valid_ln[..., None],
                       robust.tstudent_weight(abs_ln, sigma[..., None, None]),
                       0.0)
    return w_pt, w_ln, sigma


def _no_lines(pts: PointTerms) -> LineTerms:
    z = pts.P.new_zeros(pts.P.shape[:-2] + (0, 3))
    return LineTerms(z, z, z, pts.valid.new_zeros(pts.valid.shape[:-1] + (0,)))


def no_point_terms(B: int, device) -> PointTerms:
    """Zero-capacity point terms of B pairs: the lines-only
    configuration's (K = 0)."""
    z = lambda *s, dtype=torch.float32: torch.zeros((B, 0) + s, dtype=dtype,
                                                    device=device)
    return PointTerms(z(3), z(2), z(dtype=torch.bool))


_DAMP = 1e-6   # tiny Tikhonov term: the GN solve stays defined


def gn_iters_plain(T: torch.Tensor, cam: StereoCamera, pts: PointTerms,
                   lns: LineTerms, n_iters: int) -> torch.Tensor:
    damp = _DAMP * torch.eye(6, dtype=T.dtype, device=T.device)
    for _ in range(n_iters):
        r_pt, J_pt, n_pt = point_terms_rj(T, cam, pts)
        r_ln, J_ln, a_ln = line_terms_rj(T, cam, lns)
        w_pt, w_ln, _ = _weights(n_pt, pts.valid, a_ln, lns.valid)
        H, g = _assemble_normal_eqs(r_pt, J_pt, w_pt, r_ln, J_ln, w_ln)
        # solve_ex: no host sync on a singular system; the finiteness
        # guard below keeps the pose unchanged if the solve exploded
        dxi = -torch.linalg.solve_ex(H + damp, g[..., None])[0][..., 0]
        ok = torch.all(torch.isfinite(dxi), dim=-1)
        T = torch.where(ok[:, None, None], lie.exp_se3(dxi) @ T, T)
    return T


# dynamic shared memory a block of kernel I may take: 4 bytes a key
# (K + 2L) and a byte a mask (K + L), beside its ~18 KB of static shared
# memory, within the H100's 227 KB a block
_GN_SMEM_MAX = 200 * 1024


def _launch_gn(T: torch.Tensor, cam: StereoCamera, pts: PointTerms,
               lns: LineTerms, n_iters: int, n_ref: int,
               tcfg) -> Tuple[torch.Tensor, ...]:
    """One launch of kernel I: ``tcfg`` None is the phase-only form (the
    pose after ``n_iters`` iterations), else the whole optimize_pose."""
    B, K = pts.valid.shape
    L = lns.valid.shape[1]
    smem = 4 * (K + 2 * L) + K + L
    if smem > _GN_SMEM_MAX:
        raise ValueError(f"pose_gn_optimize: {K} point and {L} line terms "
                         f"need {smem} bytes of shared memory a block, more "
                         f"than {_GN_SMEM_MAX}")
    f = lambda x: x.to(torch.float32).contiguous()
    # a bool mask is bytes of 0 or 1 already: viewed, not copied
    u8 = lambda x: (x.contiguous().view(torch.uint8) if x.dtype == torch.bool
                    else x.to(torch.uint8).contiguous())
    args = (f(T), f(pts.P), f(pts.uv_obs), u8(pts.valid), f(lns.sP),
            f(lns.eP), f(lns.le_obs), u8(lns.valid))
    for name, t, shape in zip(("T", "P", "uv", "valid", "sP", "eP", "le",
                               "line valid"), args,
                              ((B, 4, 4), (B, K, 3), (B, K, 2), (B, K),
                               (B, L, 3), (B, L, 3), (B, L, 3), (B, L))):
        native.require(t, f"pose_gn_optimize {name}", t.dtype, shape)
    dev = T.device
    outs = [torch.empty((B, 4, 4), dtype=torch.float32, device=dev)]
    gates = (0, 0.0, 0.0, 0.0)
    if tcfg is not None:
        outs += [torch.empty((B, 6, 6), dtype=torch.float32, device=dev),
                 torch.empty((B,), dtype=torch.int32, device=dev),
                 torch.empty((B,), dtype=torch.float32, device=dev),
                 torch.empty((B, K), dtype=torch.bool, device=dev),
                 torch.empty((B, L), dtype=torch.bool, device=dev),
                 torch.empty((B,), dtype=torch.bool, device=dev)]
        gates = (int(tcfg.min_features), float(tcfg.inlier_k),
                 float(tcfg.min_inlier_ratio), float(tcfg.max_optim_error))
    native.launch("pose_gn_optimize", *args, *outs, *(None,) * (7 - len(outs)),
                  B, K, L, int(n_iters), int(n_ref), int(tcfg is not None),
                  gates[0], cam.fx, cam.fy, cam.cx, cam.cy, *gates[1:])
    return tuple(outs)


def gn_iters(T: torch.Tensor, cam: StereoCamera, pts: PointTerms,
             lns: LineTerms, n_iters: int) -> torch.Tensor:
    """``n_iters`` robust GN iterations (B, 4, 4) -> (B, 4, 4) on the terms
    whose ``valid`` is set: one launch of kernel I's phase-only form for a
    CUDA tensor."""
    if n_iters <= 0:
        return T
    if T.device.type == "cpu":
        return gn_iters_plain(T, cam, pts, lns, n_iters)
    return _launch_gn(T, cam, pts, lns, n_iters, 0, None)[0]


def final_normal_eqs(T: torch.Tensor, cam: StereoCamera, pts: PointTerms,
                     lns: LineTerms) -> Tuple[torch.Tensor, ...]:
    """optimize_pose's final statistics at ``T`` on the inlier terms (their
    ``valid``): the weighted H (B, 6, 6) and the robust sse (B,)."""
    r_pt, J_pt, n_pt = point_terms_rj(T, cam, pts)
    r_ln, J_ln, a_ln = line_terms_rj(T, cam, lns)
    w_pt, w_ln, _ = _weights(n_pt, pts.valid, a_ln, lns.valid)
    H, _ = _assemble_normal_eqs(r_pt, J_pt, w_pt, r_ln, J_ln, w_ln)
    sse = (torch.sum(w_pt * n_pt ** 2, dim=-1)
           + torch.sum(w_ln * a_ln ** 2, dim=(-2, -1)))
    return H, sse


def optimize_pose_plain(T0: torch.Tensor, cam: StereoCamera,
                        pts: PointTerms, lns: Optional[LineTerms],
                        cfg: SlamConfig) -> PoseResult:
    tcfg = cfg.tracking
    if lns is None:
        lns = _no_lines(pts)
    damp = _DAMP * torch.eye(6, dtype=T0.dtype, device=T0.device)

    T1 = gn_iters_plain(T0, cam, pts, lns, tcfg.max_iters)

    # outlier gate on the robust scale, floored at a quarter pixel
    _, _, n_pt = point_terms_rj(T1, cam, pts)
    _, _, a_ln = line_terms_rj(T1, cam, lns)
    all_norms = torch.cat([n_pt, a_ln.flatten(-2)], dim=-1)
    all_valid = torch.cat([pts.valid, lns.valid.repeat_interleave(2, dim=-1)],
                          dim=-1)
    sigma = torch.clamp(
        robust.mad_scale_zero_centered(all_norms, all_valid), min=0.25)
    inlier_pt = pts.valid & (n_pt < tcfg.inlier_k * sigma[:, None])
    inlier_ln = lns.valid & torch.all(
        a_ln < tcfg.inlier_k * sigma[:, None, None], dim=-1)

    pts_in = pts._replace(valid=inlier_pt)
    lns_in = lns._replace(valid=inlier_ln)
    T2 = gn_iters_plain(T1, cam, pts_in, lns_in, tcfg.max_iters_ref)

    # final statistics, covariance, gates (isGoodSolution)
    H, sse = final_normal_eqs(T2, cam, pts_in, lns_in)
    n_inl = (inlier_pt.sum(-1) + inlier_ln.sum(-1)).to(torch.int32)
    n_res = 2.0 * n_inl.to(torch.float32)
    sigma2 = sse / torch.clamp(n_res - 6.0, min=1.0)
    cov = sigma2[:, None, None] * torch.linalg.inv_ex(H + damp)[0]
    err = torch.sqrt(sse / torch.clamp(n_res, min=1.0))
    n_total = torch.clamp(pts.valid.sum(-1) + lns.valid.sum(-1), min=1)
    good = ((n_inl >= tcfg.min_features)
            & (n_inl >= tcfg.min_inlier_ratio * n_total)
            & (err < tcfg.max_optim_error)
            & torch.all(torch.isfinite(T2).flatten(-2), dim=-1)
            & lie.is_valid_rotation(T2[..., :3, :3]))
    return PoseResult(T2, cov, n_inl, err, inlier_pt, inlier_ln, good)


def optimize_pose(T0: torch.Tensor, cam: StereoCamera, pts: PointTerms,
                  lns: Optional[LineTerms], cfg: SlamConfig) -> PoseResult:
    """optimizePose: robust GN -> outlier cut -> refinement -> gates,
    for B independent problems at once: one launch of kernel I for a CUDA
    tensor. ``lns=None`` is the points-only configuration (zero-capacity
    line terms)."""
    if T0.device.type == "cpu":
        return optimize_pose_plain(T0, cam, pts, lns, cfg)
    tcfg = cfg.tracking
    return PoseResult(*_launch_gn(T0, cam, pts,
                                  _no_lines(pts) if lns is None else lns,
                                  tcfg.max_iters, tcfg.max_iters_ref, tcfg))
