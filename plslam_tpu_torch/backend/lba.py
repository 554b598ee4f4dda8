"""Local bundle adjustment: robust LM with an explicit Schur complement (K15).

Port of ``plslam_tpu/backend/lba.py``: W window poses (T_cw, updated by
``T <- exp(dxi) T``), P point landmarks and Q line-endpoint landmarks
(3x3 blocks each), stereo (u, v, d) point residuals and scalar
point-to-line endpoint residuals, t-student weights on one joint MAD
scale, the reduced camera system S = H_cc - sum H_cl H_ll^-1 H_lc with
the damping of the ORIGINAL H_cc diagonal and the support-gated pins,
back-substitution with the landmark-move floors, the trust-region caps
and the lost-observation charge of the cost.

On CUDA tensors each stage is a launch of kernel K (``csrc/lba.cu``):
``lba_terms`` (residuals, Jacobians, validity, norms per observation, and
in the same launch the exact lower-median MAD scale over all
observations, a radix select, and the robust cost), ``lba_camera`` (H_cc,
g_c per pose: a thread-block cluster a pose, ``camera_layout``),
``lba_bin`` (the landmark blocks, damped inverses and H_cl, one warp per
landmark walking its observations in order: no float atomics) and
``lba_solve`` (the Schur complement over the pose pairs that observe each
landmark, the damped and pinned 6W x 6W solve by LU with partial pivoting
inside the launch, where the reference calls ``jnp.linalg.solve``, and
the landmark steps: two kernels, float64 inside); ``lba_index`` lists
each landmark's observations once a ``run_lba`` (the ids do not change
between its LM steps) for every ``lba_bin`` and ``lba_solve``.
``run_lba`` replays the whole LM loop as one CUDA graph. The owner-sharded
LBA (``parallel/dist_lba.py``) splits ``lba_solve`` around its collective:
``lba_schur_corr`` (a shard's Schur sums) and ``lba_solve_reduced`` (the
solve of the all-reduced system and the shard's landmark steps), the same
device code.
The ``*_plain`` functions are the reference's arithmetic in PyTorch (the
one-hot binning included, which is deterministic on the card too; the
dense solve ``torch.linalg.solve_ex``) and run only for CPU tensors.

Landmarks are indexed in one space: points [0, P), endpoints [P, P + Q).
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, NamedTuple, Tuple

import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie, robust
from plslam_tpu_torch.core.camera import StereoCamera

_MAX_POSE_STEP = 1.0      # twist-norm cap per LM iteration (m / rad)
_MAX_LM_STEP = 10.0       # landmark step cap per LM iteration (m)
PIN_WEIGHT = 1e8


class LBAProblem(NamedTuple):
    """Static-shape LBA inputs (see the reference's LBAProblem)."""
    kf_pose: torch.Tensor      # (W, 4, 4) T_cw
    kf_fixed: torch.Tensor     # (W,) bool — contribute residuals, not vars
    kf_valid: torch.Tensor     # (W,) bool
    pt_pos: torch.Tensor       # (P, 3) world points
    ep_pos: torch.Tensor       # (Q, 3) world line endpoints
    obs_pt_uv: torch.Tensor    # (W, K, 2)
    obs_pt_disp: torch.Tensor  # (W, K) observed disparity (<= 0: none)
    obs_pt_id: torch.Tensor    # (W, K) int32 in [-1, P)
    obs_ln_le: torch.Tensor    # (W, L, 3) normalized observed line eqs
    obs_ln_sid: torch.Tensor   # (W, L) int32 in [-1, Q)
    obs_ln_eid: torch.Tensor   # (W, L) int32 in [-1, Q)


class LBAResult(NamedTuple):
    kf_pose: torch.Tensor      # (W, 4, 4) optimized T_cw
    pt_pos: torch.Tensor       # (P, 3)
    ep_pos: torch.Tensor       # (Q, 3)
    cost0: torch.Tensor
    cost1: torch.Tensor
    obs_pt_inlier: torch.Tensor  # (W, K) bool
    obs_ln_inlier: torch.Tensor  # (W, L) bool


class LBATerms(NamedTuple):
    """Per-observation residuals of one problem state."""
    r_pt: torch.Tensor       # (W, K, 3)
    Jc_pt: torch.Tensor      # (W, K, 3, 6)
    Jp_pt: torch.Tensor      # (W, K, 3, 3)
    ok_pt: torch.Tensor      # (W, K) bool
    rn: torch.Tensor         # (W, K) point residual norms
    r_ln: torch.Tensor       # (2, W, L) start / end endpoint residuals
    Jc_ln: torch.Tensor      # (2, W, L, 6)
    Jp_ln: torch.Tensor      # (2, W, L, 3)
    ok_ln: torch.Tensor      # (2, W, L) bool


class LBAIndex(NamedTuple):
    """Each landmark slot's observations, CSR: ``obs[off[n]:off[n + 1]]``
    in ascending id, points g = w K + k first, then endpoints g = W K +
    (2 w + family) L + k, so each list runs in (pose, family, k) order;
    detached ids are left out and the tail of ``obs`` is -1."""
    off: torch.Tensor        # (P + Q + 1,) int32
    obs: torch.Tensor        # (W K + 2 W L,) int32


class LandmarkBlocks(NamedTuple):
    """Normal-equation blocks binned onto the n = P + Q landmarks."""
    H_cc: torch.Tensor       # (W, 6, 6)
    g_c: torch.Tensor        # (W, 6)
    H_ll: torch.Tensor       # (n, 3, 3) undamped
    H_inv: torch.Tensor      # (n, 3, 3) inverse of the damped block
    g_l: torch.Tensor        # (n, 3)
    H_cl: torch.Tensor       # (W, n, 6, 3)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _point_rj(kf_pose, pt_pos, obs_uv, obs_disp, obs_id, cam: StereoCamera):
    """Stereo (u, v, d) residuals r (W,K,3), Jc (W,K,3,6), Jp (W,K,3,3),
    valid (W,K)."""
    Xw = pt_pos[torch.clamp(obs_id, min=0).long()]
    R = kf_pose[:, :3, :3]
    Pc = torch.einsum("wab,wkb->wka", R, Xw) + kf_pose[:, None, :3, 3]
    ok = (obs_id >= 0) & (Pc[..., 2] > 0.1)
    uv = cam.project(Pc)
    z = torch.clamp(Pc[..., 2], min=1e-6)
    disp = torch.full_like(z, cam.fxb) / z
    has_d = obs_disp > 0
    r_d = torch.where(has_d, disp - obs_disp, 0.0)
    r = torch.where(ok[..., None], torch.cat([uv - obs_uv, r_d[..., None]],
                                             dim=-1), 0.0)
    Jproj = cam.project_jacobian(Pc)
    zz = torch.zeros_like(z)
    Jd = torch.stack([zz, zz, torch.full_like(z, -cam.fxb) / (z * z)],
                     dim=-1)[..., None, :]
    Jd = torch.where(has_d[..., None, None], Jd, 0.0)
    Jproj3 = torch.cat([Jproj, Jd], dim=-2)
    Jse3 = torch.cat([_eye(3, Pc).expand(Pc.shape[:-1] + (3, 3)),
                      -lie.skew(Pc)], dim=-1)
    Jc = Jproj3 @ Jse3
    Jp = torch.einsum("wkab,wbc->wkac", Jproj3, R)
    Jc = torch.where(ok[..., None, None], Jc, 0.0)
    Jp = torch.where(ok[..., None, None], Jp, 0.0)
    return r, Jc, Jp, ok


def _endpoint_rj(kf_pose, ep_pos, obs_le, obs_id, cam: StereoCamera):
    """Point-to-line residuals of one endpoint family: r (W,L), Jc
    (W,L,6), Jp (W,L,3), valid (W,L)."""
    Xw = ep_pos[torch.clamp(obs_id, min=0).long()]
    R = kf_pose[:, :3, :3]
    Pc = torch.einsum("wab,wlb->wla", R, Xw) + kf_pose[:, None, :3, 3]
    ok = (obs_id >= 0) & (Pc[..., 2] > 0.1)
    uv = cam.project(Pc)
    r = (obs_le[..., 0] * uv[..., 0] + obs_le[..., 1] * uv[..., 1]
         + obs_le[..., 2])
    r = torch.where(ok, r, 0.0)
    Jpix = torch.einsum("wli,wlic->wlc", obs_le[..., :2],
                        cam.project_jacobian(Pc))
    Jse3 = torch.cat([_eye(3, Pc).expand(Pc.shape[:-1] + (3, 3)),
                      -lie.skew(Pc)], dim=-1)
    Jc = torch.einsum("wlc,wlcs->wls", Jpix, Jse3)
    Jp = torch.einsum("wlc,wcb->wlb", Jpix, R)
    Jc = torch.where(ok[..., None], Jc, 0.0)
    Jp = torch.where(ok[..., None], Jp, 0.0)
    return r, Jc, Jp, ok


def lba_terms_plain(problem: LBAProblem, cam: StereoCamera) -> LBATerms:
    r, Jc, Jp, ok = _point_rj(problem.kf_pose, problem.pt_pos,
                              problem.obs_pt_uv, problem.obs_pt_disp,
                              problem.obs_pt_id, cam)
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    fam = [_endpoint_rj(problem.kf_pose, problem.ep_pos, problem.obs_ln_le,
                        ids, cam)
           for ids in (problem.obs_ln_sid, problem.obs_ln_eid)]
    return LBATerms(r, Jc, Jp, ok, rn, *(torch.stack([a, b])
                                          for a, b in zip(*fam)))


# lba_terms' select scratch (csrc/lba.cu SelScratch: a 2048-bin histogram,
# two counts and a ticket), one per device, zeroed here once and left
# zeroed by every launch; the launches run on one stream, one at a time
_SCRATCH: Dict[torch.device, torch.Tensor] = {}


def lba_terms_sigma(problem: LBAProblem, cam: StereoCamera
                    ) -> Tuple[LBATerms, torch.Tensor, torch.Tensor]:
    """Residuals, Jacobians and validity of every observation, the robust
    MAD scale over them and the robust cost with the lost-observation
    charge (0-d tensors on the device): one ``lba_terms`` launch."""
    if problem.kf_pose.device.type == "cpu":
        return lba_terms_sigma_plain(problem, cam)
    W, K = problem.obs_pt_id.shape
    L = problem.obs_ln_sid.shape[1]
    P, Q = problem.pt_pos.shape[0], problem.ep_pos.shape[0]
    dev = problem.kf_pose.device
    args = (_f32(problem.kf_pose), _f32(problem.pt_pos), _f32(problem.ep_pos),
            _f32(problem.obs_pt_uv), _f32(problem.obs_pt_disp),
            _i32(problem.obs_pt_id), _f32(problem.obs_ln_le),
            _i32(problem.obs_ln_sid), _i32(problem.obs_ln_eid))
    for name, x, shape in zip(
            ("kf_pose", "pt_pos", "ep_pos", "obs_pt_uv", "obs_pt_disp",
             "obs_pt_id", "obs_ln_le", "obs_ln_sid", "obs_ln_eid"), args,
            ((W, 4, 4), (P, 3), (Q, 3), (W, K, 2), (W, K), (W, K),
             (W, L, 3), (W, L), (W, L))):
        native.require(x, f"lba_terms {name}", x.dtype, shape)
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
    out = LBATerms(e(W, K, 3), e(W, K, 3, 6), e(W, K, 3, 3),
                   e(W, K, dt=torch.uint8), e(W, K), e(2, W, L),
                   e(2, W, L, 6), e(2, W, L, 3), e(2, W, L, dt=torch.uint8))
    sigma, cost = e(), e()
    scratch = _SCRATCH.get(dev)
    if scratch is None:
        scratch = torch.zeros(2048 + 3, dtype=torch.int32, device=dev)
        _SCRATCH[dev] = scratch
    native.launch("lba_terms", *args, *out, sigma, cost, scratch,
                  W, K, L, P, Q, cam.fx, cam.fy, cam.cx, cam.cy, cam.fxb)
    return (out._replace(ok_pt=out.ok_pt.view(torch.bool),
                         ok_ln=out.ok_ln.view(torch.bool)), sigma, cost)


def _f32(x):
    return x.to(torch.float32).contiguous()


def _i32(x):
    return x.to(torch.int32).contiguous()


def _robust_sigma(rn, ok_pt, r_ln, ok_ln):
    allr = torch.cat([rn.reshape(-1), torch.abs(r_ln).reshape(-1)])
    allv = torch.cat([ok_pt.reshape(-1), ok_ln.reshape(-1)])
    return robust.mad_scale_zero_centered(allr, allv)


def _weights(t: LBATerms, sigma):
    w = torch.where(t.ok_pt, robust.tstudent_weight(t.rn, sigma), 0.0)
    w_ln = torch.where(t.ok_ln, robust.tstudent_weight(torch.abs(t.r_ln),
                                                       sigma), 0.0)
    return w, w_ln


def lba_sigma_plain(t: LBATerms, problem: LBAProblem):
    sigma = _robust_sigma(t.rn, t.ok_pt, t.r_ln, t.ok_ln)
    w_pt, w_ln = _weights(t, sigma)
    n_lost = (torch.sum((problem.obs_pt_id >= 0) & ~t.ok_pt)
              + torch.sum((problem.obs_ln_sid >= 0) & ~t.ok_ln[0])
              + torch.sum((problem.obs_ln_eid >= 0) & ~t.ok_ln[1]))
    lost_penalty = 6.0 * sigma * sigma    # (dof+1) sigma^2 saturation
    cost = (torch.sum(w_pt * t.rn ** 2) + torch.sum(w_ln[0] * t.r_ln[0] ** 2)
            + torch.sum(w_ln[1] * t.r_ln[1] ** 2) + lost_penalty * n_lost)
    return sigma, cost


def lba_terms_sigma_plain(problem: LBAProblem, cam: StereoCamera):
    t = lba_terms_plain(problem, cam)
    return (t, *lba_sigma_plain(t, problem))


def lba_cost(problem: LBAProblem, cam: StereoCamera) -> torch.Tensor:
    """Robust total cost for LM accept/reject: observations that exist but
    fail the behind-camera gate are charged (dof+1) sigma^2 each."""
    return _cost(problem, cam, _KERNELS)


def _bin_landmark_blocks(obs_id, n_lm: int, c_hh, c_g, c_ch):
    """One-hot contraction of per-observation (Hxx 3x3 | g 3 | H_cx 6x3)
    payloads onto landmark slots (deterministic; obs_id < 0 bins nowhere).
    Returns (Hxx (n,3,3), g (n,3), H_cx (W,n,6,3))."""
    W, K = obs_id.shape
    payload = torch.cat([c_hh.reshape(W, K, 9), c_g, c_ch.reshape(W, K, 18)],
                        dim=-1)
    onehot = (obs_id[..., None] == torch.arange(
        n_lm, dtype=obs_id.dtype, device=obs_id.device)).to(payload.dtype)
    out = torch.einsum("wkn,wkc->wnc", onehot, payload)
    return (torch.sum(out[..., :9], dim=0).reshape(n_lm, 3, 3),
            torch.sum(out[..., 9:12], dim=0),
            out[..., 12:].reshape(W, n_lm, 6, 3))


def _damped_inv(H, lam):
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    return lie.inv3(H + (lam * torch.clamp(diag, min=1e-3))[..., None]
                    * _eye(3, H))


def lba_camera_plain(t: LBATerms, sigma, free):
    w, w_ln = _weights(t, sigma)
    Jc = torch.where(free[:, None, None, None], t.Jc_pt, 0.0)
    Jcl = torch.where(free[None, :, None, None], t.Jc_ln, 0.0)
    H_cc = (torch.einsum("wk,wkia,wkib->wab", w, Jc, Jc)
            + torch.einsum("wl,wla,wlb->wab", w_ln[0], Jcl[0], Jcl[0])
            + torch.einsum("wl,wla,wlb->wab", w_ln[1], Jcl[1], Jcl[1]))
    g_c = (torch.einsum("wk,wkia,wki->wa", w, Jc, t.r_pt)
           + torch.einsum("wl,wla,wl->wa", w_ln[0], Jcl[0], t.r_ln[0])
           + torch.einsum("wl,wla,wl->wa", w_ln[1], Jcl[1], t.r_ln[1]))
    return H_cc, g_c


def lba_bin_plain(t: LBATerms, problem: LBAProblem, sigma, free, lam):
    P, Q = problem.pt_pos.shape[0], problem.ep_pos.shape[0]
    w, w_ln = _weights(t, sigma)
    Jc = torch.where(free[:, None, None, None], t.Jc_pt, 0.0)
    Jcl = torch.where(free[None, :, None, None], t.Jc_ln, 0.0)
    Hpp, g_p, H_cp = _bin_landmark_blocks(
        problem.obs_pt_id, P,
        torch.einsum("wk,wkia,wkib->wkab", w, t.Jp_pt, t.Jp_pt),
        torch.einsum("wk,wkia,wki->wka", w, t.Jp_pt, t.r_pt),
        torch.einsum("wk,wkia,wkib->wkab", w, Jc, t.Jp_pt))
    Hqq = g_q = H_cq = 0.0
    for f, ids in enumerate((problem.obs_ln_sid, problem.obs_ln_eid)):
        ww, Jcx, Jpx, rx = w_ln[f], Jcl[f], t.Jp_ln[f], t.r_ln[f]
        Hq1, gq1, Hcq1 = _bin_landmark_blocks(
            ids, Q, torch.einsum("wl,wla,wlb->wlab", ww, Jpx, Jpx),
            torch.einsum("wl,wla,wl->wla", ww, Jpx, rx),
            torch.einsum("wl,wla,wlb->wlab", ww, Jcx, Jpx))
        Hqq, g_q, H_cq = Hqq + Hq1, g_q + gq1, H_cq + Hcq1
    H_ll = torch.cat([Hpp, Hqq])
    return H_ll, _damped_inv(H_ll, lam), torch.cat([g_p, g_q]), torch.cat(
        [H_cp, H_cq], dim=1)


def lba_blocks_plain(t: LBATerms, problem: LBAProblem, sigma, free, lam
                     ) -> LandmarkBlocks:
    return LandmarkBlocks(*lba_camera_plain(t, sigma, free),
                          *lba_bin_plain(t, problem, sigma, free, lam))


# lba_camera's launch: a thread-block cluster of up to CAM_MAX_C CTAs a pose
# (the portable cluster size), each taking a slice of at least CAM_MIN_SLICE
# of the pose's K + 2L observations, one a thread, CAM_MAX_T threads at most
CAM_MAX_C, CAM_MIN_SLICE, CAM_MAX_T = 8, 64, 256


def camera_layout(W: int, K: int, L: int) -> Tuple[int, int, int]:
    """(C, S, T): ``lba_camera``'s cluster of C CTAs a pose, S of the
    pose's K + 2L observations a CTA (rank c takes [c S, (c + 1) S)), T
    threads a CTA, which takes its slice in rounds of T, one observation a
    thread. Raises for a shape the launch cannot take."""
    N = K + 2 * L
    if not (1 <= W <= 65535 and K >= 0 and L >= 0 and N >= 1):
        raise ValueError(f"lba_camera: no launch for W={W}, K={K}, L={L}")
    C = min(CAM_MAX_C, -(-N // CAM_MIN_SLICE))
    S = -(-N // C)
    return C, S, min(CAM_MAX_T, -(-S // 32) * 32)


def lba_camera(t: LBATerms, sigma, free):
    """Camera blocks H_cc (W,6,6), g_c (W,6): one ``lba_camera`` launch, a
    thread-block cluster a pose (``camera_layout``)."""
    if t.rn.device.type == "cpu":
        return lba_camera_plain(t, sigma, free)
    W, K = t.rn.shape
    L = t.r_ln.shape[2]
    dev = t.rn.device
    H_cc = torch.empty((W, 6, 6), dtype=torch.float32, device=dev)
    g_c = torch.empty((W, 6), dtype=torch.float32, device=dev)
    native.launch("lba_camera", *(x.contiguous() for x in (
        t.Jc_pt, t.r_pt, t.rn, t.ok_pt, t.Jc_ln, t.r_ln, t.ok_ln)),
        _f32(sigma.reshape(())), free.to(torch.uint8).contiguous(), H_cc,
        g_c, W, K, L, *camera_layout(W, K, L))
    return H_cc, g_c


def lba_index_plain(problem: LBAProblem) -> LBAIndex:
    """A stable sort of the observation ids by landmark slot."""
    P, Q = problem.pt_pos.shape[0], problem.ep_pos.shape[0]
    n = P + Q
    pt = problem.obs_pt_id.reshape(-1).long()
    ln = torch.stack([problem.obs_ln_sid, problem.obs_ln_eid],
                     dim=1).reshape(-1).long()                # (W, 2, L)
    slot = torch.cat([torch.where((pt >= 0) & (pt < P), pt, n),
                      torch.where((ln >= 0) & (ln < Q), ln + P, n)])
    order = torch.sort(slot, stable=True).indices
    counts = torch.bincount(slot, minlength=n + 1)[:n]
    off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    ids = torch.arange(slot.shape[0], device=slot.device)
    obs = torch.where(ids < off[-1], order, -1)
    return LBAIndex(off.to(torch.int32), obs.to(torch.int32))


# lba_index's launch (csrc/lba.cu): CTAs of IDX_NT threads, each owning at
# most IDX_SLOTS landmark slots (each CTA reads every id, so more CTAs
# shorten only the work on the owned ones: 20 at the path's window were
# the fastest of 1-20 on the H100); observation ids and slots held as
# uint16; a CTA's dynamic shared memory, (S + 1) ints and 2 T uint16s,
# within IDX_MAX_SMEM (the C IDX_NT, IDX_MAX_T, IDX_MAX_N, IDX_MAX_SMEM)
IDX_NT, IDX_SLOTS, IDX_MAX_T, IDX_MAX_N = 1024, 256, 0xFFFF, 0xFFFF
IDX_MAX_SMEM = 227 * 1024 - 1024


def index_layout(W: int, K: int, L: int, P: int, Q: int) -> Tuple[int, int]:
    """(C, S): ``lba_index``'s C CTAs of S landmark slots each (CTA c owns
    slots [c S, (c + 1) S)). Raises for a shape the launch cannot take."""
    T, N = W * K + 2 * W * L, P + Q
    C = max(1, -(-N // IDX_SLOTS))
    S = -(-N // C)
    if (min(W, K, L, P, Q) < 0 or T > IDX_MAX_T or N > IDX_MAX_N
            or 4 * (S + 1) + 4 * T > IDX_MAX_SMEM):
        raise ValueError(f"lba_index: no launch for W={W}, K={K}, L={L}, "
                         f"P={P}, Q={Q}")
    return C, S


def lba_index(problem: LBAProblem) -> LBAIndex:
    """Each landmark's observations: one ``lba_index`` launch
    (``index_layout``)."""
    if problem.obs_pt_id.device.type == "cpu":
        return lba_index_plain(problem)
    W, K = problem.obs_pt_id.shape
    L = problem.obs_ln_sid.shape[1]
    P, Q = problem.pt_pos.shape[0], problem.ep_pos.shape[0]
    layout = index_layout(W, K, L, P, Q)
    dev = problem.obs_pt_id.device
    off = torch.empty((P + Q + 1,), dtype=torch.int32, device=dev)
    obs = torch.empty((W * K + 2 * W * L,), dtype=torch.int32, device=dev)
    native.launch("lba_index", _i32(problem.obs_pt_id),
                  _i32(problem.obs_ln_sid), _i32(problem.obs_ln_eid), off,
                  obs, W, K, L, P, Q, *layout)
    return LBAIndex(off, obs)


def _bin_outputs(t: LBATerms, problem: LBAProblem):
    W = t.rn.shape[0]
    n = problem.pt_pos.shape[0] + problem.ep_pos.shape[0]
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=t.rn.device)
    return e(n, 3, 3), e(n, 3, 3), e(n, 3), e(W, n, 6, 3)


def lba_bin(t: LBATerms, problem: LBAProblem, sigma, free, lam,
            index: LBAIndex):
    """Landmark blocks (H_ll, H_inv, g_l, H_cl): one ``lba_bin`` launch
    over ``index``, the problem's ``lba_index``."""
    if t.rn.device.type == "cpu":
        return lba_bin_plain(t, problem, sigma, free, lam)
    W, K = t.rn.shape
    L = t.r_ln.shape[2]
    P, Q = problem.pt_pos.shape[0], problem.ep_pos.shape[0]
    out = _bin_outputs(t, problem)
    native.launch("lba_bin", index.off, index.obs, t.Jc_pt, t.Jp_pt,
                  t.r_pt, t.rn, t.ok_pt, t.Jc_ln, t.Jp_ln, t.r_ln, t.ok_ln,
                  _f32(sigma.reshape(())), free.to(torch.uint8).contiguous(),
                  _f32(lam.reshape(())), *out, W, K, L, P, Q)
    return out


def lba_blocks(t: LBATerms, problem: LBAProblem, sigma, free, lam,
               index: LBAIndex) -> LandmarkBlocks:
    """Camera blocks and landmark blocks of one problem state."""
    return LandmarkBlocks(*lba_camera(t, sigma, free),
                          *lba_bin(t, problem, sigma, free, lam, index))


def _schur_sums(b: LandmarkBlocks):
    """sum_n B_wn C_vn^T (W, W, 6, 6) and sum_n B_wn g_l[n] (W, 6), B = C
    H_inv, C = H_cl."""
    B = torch.einsum("wnab,nbc->wnac", b.H_cl, b.H_inv)
    return (torch.einsum("wnab,vncb->wvac", B, b.H_cl),
            torch.einsum("wnab,nb->wa", B, b.g_l))


def lba_schur_plain(b: LandmarkBlocks, free, lam,
                    pin_weight: float = PIN_WEIGHT):
    return _reduced_system(b.H_cc, b.g_c, *_schur_sums(b), free, lam,
                           pin_weight)


def _reduced_system(H_cc, g_c, corr, g_corr, free, lam, pin_weight):
    """S = H_cc - corr, g_red = g_c - g_corr, damped and pinned, as the
    (6W, 6W) matrix and its (6W,) right-hand side."""
    W = H_cc.shape[0]
    S = -corr
    idx = torch.arange(W, device=S.device)
    S[idx, idx] += H_cc
    g_red = g_c - g_corr
    # LM damps the diagonal of the ORIGINAL H_cc (the Schur step equals
    # the damped dense step); pins hold fixed/invalid poses and free
    # poses without residual support (no information => do not move)
    diag = torch.diagonal(H_cc, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(diag, min=1e-3)
    eye6 = _eye(6, S)
    S[idx, idx] += damp[..., None] * eye6 + 1e-6 * eye6
    support = diag.sum(-1)
    pin = torch.where(free & (support > 1.0), 0.0, pin_weight)
    S[idx, idx] += pin[:, None, None] * eye6
    return S.transpose(1, 2).reshape(W * 6, W * 6), g_red.reshape(W * 6)


def _cap_steps(dxi, d_pt, d_ep):
    """Per-variable trust-region caps, direction preserved."""
    n = torch.linalg.norm(dxi, dim=-1, keepdim=True)
    dxi = dxi * torch.clamp(_MAX_POSE_STEP / torch.clamp(n, min=1e-12),
                            max=1.0)
    npt = torch.linalg.norm(d_pt, dim=-1, keepdim=True)
    d_pt = d_pt * torch.clamp(_MAX_LM_STEP / torch.clamp(npt, min=1e-12),
                              max=1.0)
    ne = torch.linalg.norm(d_ep, dim=-1, keepdim=True)
    d_ep = d_ep * torch.clamp(_MAX_LM_STEP / torch.clamp(ne, min=1e-12),
                              max=1.0)
    return dxi, d_pt, d_ep


def lba_backsub_plain(b: LandmarkBlocks, dxi, P: int, cap: bool = True):
    rhs = b.g_l + torch.einsum("wnab,wa->nb", b.H_cl, dxi)
    d = -torch.einsum("nab,nb->na", b.H_inv, rhs)
    # only landmarks with meaningful support move (round-5 guard)
    d = torch.where((torch.diagonal(b.H_ll, dim1=-2, dim2=-1).sum(-1)
                     > 1e-2)[:, None], d, 0.0)
    if not cap:
        return dxi, d[:P], d[P:]
    return _cap_steps(dxi, d[:P], d[P:])


def lba_solve_plain(b: LandmarkBlocks, free, lam, P: int,
                    pin_weight: float = PIN_WEIGHT, cap: bool = True):
    """The reduced system, its dense solve (the reference's
    ``jnp.linalg.solve``: LU with partial pivoting; ``solve_ex`` does not
    raise on a singular system, whose non-finite step the LM rejects), the
    free mask and the back-substitution."""
    return _solve_system(lba_schur_plain(b, free, lam, pin_weight), b, free,
                         P, cap)


def _solve_system(system, b: LandmarkBlocks, free, P: int, cap: bool):
    Sm, gm = system
    dxi = -torch.linalg.solve_ex(Sm, gm[:, None])[0][:, 0].reshape(-1, 6)
    dxi = torch.where(free[:, None], dxi, 0.0)
    return lba_backsub_plain(b, dxi, P, cap)


def lba_schur_corr_plain(b: LandmarkBlocks, free):
    """A shard's Schur sums for the collective (``lba_schur_corr``):
    corr (W, W, 6, 6) = sum_n B_wn C_vn^T and g_corr (W, 6) = sum_n B_wn
    g_l[n] over the shard's landmarks, zero where a pose is not free."""
    corr, g_corr = _schur_sums(b)
    pair = free[:, None] & free[None, :]
    return (torch.where(pair[..., None, None], corr, 0.0),
            torch.where(free[:, None], g_corr, 0.0))


def lba_solve_reduced_plain(H_cc, g_c, corr, g_corr, b: LandmarkBlocks,
                            free, lam, P: int,
                            pin_weight: float = PIN_WEIGHT,
                            cap: bool = True):
    """The step from the all-reduced H_cc, g_c and Schur sums
    (``lba_solve_reduced``): the damped and pinned reduced system, its
    dense solve, the free mask and the back-substitution of the landmarks
    of ``b`` (a shard's blocks; its H_cc and g_c are not read)."""
    return _solve_system(_reduced_system(H_cc, g_c, corr, g_corr, free, lam,
                                         pin_weight), b, free, P, cap)


# lba_solve's scratch (csrc/lba.cu SolveScratch), one per device and size,
# zeroed once and left so by every launch. A captured run_lba holds its
# address: never freed.
_SOLVE_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_SOLVE_CH, _SOLVE_PW, _SOLVE_HEAD, _SOLVE_SLOT = 64, 5, 196, 42


def _solve_words(W: int, n: int) -> int:
    """Words of lba_solve's scratch for W poses and n landmarks (its
    partials are float64, after one word of padding at most)."""
    G = -(-n // _SOLVE_CH)
    return (_SOLVE_HEAD + n + G * _SOLVE_PW + 1
            + 2 * G * (W * (W + 1) // 2) * _SOLVE_SLOT)


def new_solve_scratch(W: int, n: int, dev) -> torch.Tensor:
    """A zeroed scratch of lba_solve's size for W poses and n landmarks: a
    shard's own, for its ``lba_schur_corr`` and ``lba_solve_reduced``,
    whose launches leave it zeroed but for the pose masks that the first
    hands the second."""
    return torch.zeros(_solve_words(W, n), dtype=torch.int32, device=dev)


def _require_blocks(b: LandmarkBlocks, entry: str, W: int, n: int
                    ) -> LandmarkBlocks:
    b = LandmarkBlocks(*(_f32(x) for x in b))
    for name, x, shape in zip(b._fields, b, ((W, 6, 6), (W, 6), (n, 3, 3),
                                             (n, 3, 3), (n, 3), (W, n, 6, 3))):
        native.require(x, f"{entry} {name}", torch.float32, shape)
    return b


def lba_schur_corr(b: LandmarkBlocks, problem: LBAProblem, free,
                   index: LBAIndex, scratch: torch.Tensor):
    """A shard's Schur sums (corr (W, W, 6, 6), g_corr (W, 6); float32,
    for the collective) over ``index``, the shard's ``lba_index``: one
    ``lba_schur_corr`` launch, ``lba_solve``'s sums. ``scratch``: the
    shard's ``new_solve_scratch``, which its ``lba_solve_reduced`` then
    reads (no other launch may use it in between)."""
    if b.H_cc.device.type == "cpu":
        return lba_schur_corr_plain(b, free)
    W, n = b.H_cl.shape[:2]
    K, L = problem.obs_pt_id.shape[1], problem.obs_ln_sid.shape[1]
    if W > 16:
        raise ValueError(f"lba_schur_corr: at most 16 poses, got {W}")
    dev = b.H_cc.device
    b = _require_blocks(b, "lba_schur_corr", W, n)
    words = _solve_words(W, n)
    native.require(scratch, "lba_schur_corr scratch", torch.int32, (words,))
    corr = torch.empty((W, W, 6, 6), dtype=torch.float32, device=dev)
    g_corr = torch.empty((W, 6), dtype=torch.float32, device=dev)
    native.launch("lba_schur_corr", index.off, index.obs, b.H_inv, b.g_l,
                  b.H_cl, free.to(torch.uint8).contiguous(), corr, g_corr,
                  scratch, words, W, K, L, n)
    return corr, g_corr


def lba_solve_reduced(H_cc, g_c, corr, g_corr, b: LandmarkBlocks,
                      problem: LBAProblem, free, lam,
                      pin_weight: float = PIN_WEIGHT, cap: bool = True,
                      scratch: torch.Tensor = None):
    """The shard's step from the all-reduced H_cc, g_c, corr and g_corr:
    (dxi (W,6), d_pt (P,3), d_ep (Q,3)) of the shard's landmarks, masked,
    floored and (``cap``) capped as ``lba_solve``'s: one
    ``lba_solve_reduced`` launch (the solve in one block, then the
    landmark steps from the pose masks that the shard's ``lba_schur_corr``
    left in ``scratch``)."""
    P = problem.pt_pos.shape[0]
    if H_cc.device.type == "cpu":
        return lba_solve_reduced_plain(H_cc, g_c, corr, g_corr, b, free, lam,
                                       P, pin_weight, cap)
    W, n = b.H_cl.shape[:2]
    if W > 16:
        raise ValueError(f"lba_solve_reduced: at most 16 poses, got {W}")
    dev = H_cc.device
    b = _require_blocks(b._replace(H_cc=H_cc, g_c=g_c), "lba_solve_reduced",
                        W, n)
    corr, g_corr = _f32(corr), _f32(g_corr)
    native.require(corr, "lba_solve_reduced corr", torch.float32,
                   (W, W, 6, 6))
    native.require(g_corr, "lba_solve_reduced g_corr", torch.float32, (W, 6))
    words = _solve_words(W, n)
    native.require(scratch, "lba_solve_reduced scratch", torch.int32,
                   (words,))
    dxi = torch.empty((W, 6), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    native.launch("lba_solve_reduced", b.H_cc, b.g_c, corr, g_corr, b.H_ll,
                  b.H_inv, b.g_l, b.H_cl, _f32(lam.reshape(())),
                  free.to(torch.uint8).contiguous(), dxi, d, scratch, words,
                  W, n, float(pin_weight), int(cap))
    return dxi, d[:P], d[P:]


def lba_solve(b: LandmarkBlocks, problem: LBAProblem, free, lam,
              index: LBAIndex, pin_weight: float = PIN_WEIGHT,
              cap: bool = True):
    """One LM step from the blocks: the Schur complement over ``index``
    (the problem's ``lba_index``), the damped and pinned 6W x 6W solve and
    the landmark steps, (dxi (W,6), d_pt (P,3), d_ep (Q,3)) masked, floored
    and (``cap``) capped: one call of the ``lba_solve`` entry, which
    launches two kernels (``csrc/lba.cu``: the sums and the LU in float64,
    the LU over the free poses' rows alone, whose rows of S are the only
    ones coupled)."""
    P = problem.pt_pos.shape[0]
    if b.H_cc.device.type == "cpu":
        return lba_solve_plain(b, free, lam, P, pin_weight, cap)
    W, n = b.H_cl.shape[:2]
    K, L = problem.obs_pt_id.shape[1], problem.obs_ln_sid.shape[1]
    if W > 16:
        raise ValueError(f"lba_solve: at most 16 poses, got {W}")
    dev = b.H_cc.device
    b = _require_blocks(b, "lba_solve", W, n)
    words = _solve_words(W, n)
    scratch = _SOLVE_SCRATCH.get((dev, words))
    if scratch is None:
        scratch = torch.zeros(words, dtype=torch.int32, device=dev)
        _SOLVE_SCRATCH[(dev, words)] = scratch
    dxi = torch.empty((W, 6), dtype=torch.float32, device=dev)
    d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    native.launch("lba_solve", index.off, index.obs, b.H_cc, b.g_c, b.H_ll,
                  b.H_inv, b.g_l, b.H_cl, _f32(lam.reshape(())),
                  free.to(torch.uint8).contiguous(), dxi, d, scratch, words,
                  W, K, L, n, float(pin_weight), int(cap))
    return dxi, d[:P], d[P:]


def _free(problem: LBAProblem):
    return (~problem.kf_fixed) & problem.kf_valid


class _Ops(NamedTuple):
    terms: object      # (problem, cam) -> (LBATerms, sigma, cost)
    index: object
    blocks: object
    solve: object


# the launches (each dispatching on the device of its tensors), and the
# plain versions: run_lba_plain holds the whole LM loop of kernels against
# the same loop of plain versions on the card (whose one-hot binning and
# dense Schur pass read no index)
_KERNELS = _Ops(lba_terms_sigma, lba_index, lba_blocks, lba_solve)
_PLAIN = _Ops(lba_terms_sigma_plain, lba_index_plain,
              lambda t, problem, sigma, free, lam, index: lba_blocks_plain(
                  t, problem, sigma, free, lam),
              lambda b, problem, free, lam, index, pin_weight, cap:
              lba_solve_plain(b, free, lam, problem.pt_pos.shape[0],
                              pin_weight, cap))


def _step(problem: LBAProblem, cam: StereoCamera, lam, ops: _Ops,
          index: LBAIndex, pin_weight: float = PIN_WEIGHT, cap: bool = True):
    """One damped LM step; ``index``: the problem's ``ops.index``.
    ``lam``: a float, or a float32 tensor on the problem's device (then
    used as it is: no copy from the host inside a captured run)."""
    if not isinstance(lam, torch.Tensor):
        lam = torch.full((), lam, dtype=torch.float32,
                         device=problem.kf_pose.device)
    t, sigma, _ = ops.terms(problem, cam)
    free = _free(problem)
    b = ops.blocks(t, problem, sigma, free, lam, index)
    return ops.solve(b, problem, free, lam, index, pin_weight, cap)


def _assemble_and_solve(problem: LBAProblem, cam: StereoCamera, lam,
                        pin_weight: float = PIN_WEIGHT):
    """One damped step before the trust-region caps (the reference's
    return value): (dxi (W,6), d_pt (P,3), d_ep (Q,3))."""
    return _step(problem, cam, lam, _KERNELS, lba_index(problem), pin_weight,
                 cap=False)


def _cost(problem, cam, ops: _Ops):
    return ops.terms(problem, cam)[2]


def _run(problem: LBAProblem, cam: StereoCamera, cfg: SlamConfig,
         ops: _Ops) -> LBAResult:
    mcfg = cfg.mapping
    cost0 = _cost(problem, cam, ops)
    lam = torch.full((), mcfg.lambda_init, dtype=torch.float32,
                     device=cost0.device)
    prob, cost = problem, cost0
    # the observation ids stay as they are through the LM loop
    index = ops.index(problem)
    for _ in range(mcfg.lba_iters):
        dxi, d_pt, d_ep = _step(prob, cam, lam, ops, index)
        trial = prob._replace(kf_pose=lie.exp_se3(dxi) @ prob.kf_pose,
                              pt_pos=prob.pt_pos + d_pt,
                              ep_pos=prob.ep_pos + d_ep)
        c_try = _cost(trial, cam, ops)
        finite = (torch.isfinite(c_try) & torch.all(torch.isfinite(dxi))
                  & torch.all(torch.isfinite(d_pt))
                  & torch.all(torch.isfinite(d_ep)))
        accept = finite & (c_try < cost)
        prob = LBAProblem(*(torch.where(accept, a, b)
                            for a, b in zip(trial, prob)))
        lam = torch.where(accept, lam * (1.0 / mcfg.lambda_factor),
                          lam * mcfg.lambda_factor)
        cost = torch.where(accept, c_try, cost)
    pt_inl, ln_inl = _posthoc(prob, cam, cfg, ops)
    return LBAResult(prob.kf_pose, prob.pt_pos, prob.ep_pos, cost0, cost,
                     pt_inl, ln_inl)


class _Graph(NamedTuple):
    """A captured ``_run``: its static inputs and outputs, and the hand
    launches one replay makes."""
    graph: object
    inputs: LBAProblem
    outputs: LBAResult
    launches: Counter


# one captured run per device, shapes, dtypes and the Python values the
# capture bakes in (the camera, the LM's settings)
_GRAPHS: Dict[tuple, _Graph] = {}
# held for a lookup with its capture, and for a replay's copy-in, replay
# and clone: the graphs and their static buffers are shared by every
# caller in the process (the tracker thread and the mapping workers)
_GRAPH_LOCK = threading.Lock()


def _graph_key(problem: LBAProblem, cam: StereoCamera, cfg: SlamConfig):
    m = cfg.mapping
    return (problem.kf_pose.device,
            tuple((tuple(x.shape), x.dtype) for x in problem),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.fxb, m.lba_iters,
            m.lambda_init, m.lambda_factor, m.lba_min_sigma, m.lba_inlier_k)


def _capture(problem: LBAProblem, cam: StereoCamera, cfg: SlamConfig
             ) -> _Graph:
    """Capture ``_run`` with the kernels on static copies of ``problem``.
    A capture executes nothing: its launches are recorded for the replays
    and not counted in ``native.LAUNCHES``. The capture mode is the
    thread's own, so another thread's allocations, synchronizes and
    fetches while it is open neither fail nor spoil it. Raises if capture
    fails."""
    inputs = LBAProblem(*(x.clone() for x in problem))
    graph = torch.cuda.CUDAGraph()
    with native.counting_into(Counter()) as launches:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outputs = _run(inputs, cam, cfg, _KERNELS)
    return _Graph(graph, inputs, outputs, launches)


def run_lba(problem: LBAProblem, cam: StereoCamera, cfg: SlamConfig
            ) -> LBAResult:
    """Robust LM with accept/reject (levMarquardtOptimizationLBA), a fixed
    number of iterations, every decision on the device: per iteration one
    step (``lba_terms``, ``lba_camera``, ``lba_bin``, ``lba_solve``) and the
    trial cost (``lba_terms``); one ``lba_index`` before the loop.

    On a CUDA device the whole loop is one CUDA graph replay, the port's
    counterpart of the reference's single jitted program: the first call
    of a shape runs the loop eagerly (building the kernels and their
    scratch) and then captures it; later calls copy the problem into the
    graph's inputs, replay it and clone its outputs, all on the caller's
    stream and under ``_GRAPH_LOCK``. ``native.LAUNCHES`` counts each
    replay's launches, as an eager run would."""
    if problem.kf_pose.device.type == "cpu":
        return _run(problem, cam, cfg, _KERNELS)
    key = _graph_key(problem, cam, cfg)
    with _GRAPH_LOCK:
        g = _GRAPHS.get(key)
        if g is None:
            res = _run(problem, cam, cfg, _KERNELS)
            _GRAPHS[key] = _capture(problem, cam, cfg)
            return res
        for x, y in zip(g.inputs, problem):
            x.copy_(y)
        g.graph.replay()
        native.add_counts(g.launches)
        return LBAResult(*(x.clone() for x in g.outputs))


def run_lba_plain(problem: LBAProblem, cam: StereoCamera, cfg: SlamConfig
                  ) -> LBAResult:
    return _run(problem, cam, cfg, _PLAIN)


def _posthoc(problem1, cam, cfg, ops: _Ops):
    mcfg = cfg.mapping
    t, sigma, _ = ops.terms(problem1, cam)
    # the gate's scale floored at the detector's pixel noise: on near-
    # perfect data an unfloored MAD would flag every observation
    sigma = torch.clamp(sigma, min=mcfg.lba_min_sigma)
    k = mcfg.lba_inlier_k
    pt_inl = t.ok_pt & (t.rn < k * sigma)
    a = torch.abs(t.r_ln)
    ln_inl = (t.ok_ln[0] & t.ok_ln[1] & (a[0] < k * sigma)
              & (a[1] < k * sigma))
    return pt_inl, ln_inl


def posthoc_inliers(problem1: LBAProblem, cam: StereoCamera,
                    cfg: SlamConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-hoc outlier flags at the solved state (markers, no re-solve)."""
    return _posthoc(problem1, cam, cfg, _KERNELS)
