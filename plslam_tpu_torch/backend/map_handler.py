"""Windowed LBA over the map state and the per-KF mapping step.

Port of ``plslam_tpu/backend/map_handler.py`` (``_compact_landmarks``,
``_build_window_problem``, ``run_window_lba``, ``_apply_lba_result``,
``mapping_step_traced_lba``, ``KeyFrameSummary``): the
last window + fixed KF slots and the landmarks they touched, compacted
(newest-touched first, stable sort as the reference's ``argsort``), solved
by ``backend/lba.py::run_lba`` and scattered back with the solved
outliers detached. The reference's ``lax.cond`` around the LBA of a slot
becomes a host branch on the (host-known) flag; the periodic global
KF sweep stays a device decision (``remove_redundant_kfs_global``'s
``enabled``). The reference's ``mapping_step`` is
``mapping_step_traced_lba`` with ``lba_flag=False`` on the one path that
calls it (the first keyframe). ``DistLBA``, the distributed path and the
worker-thread ``MapHandler`` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.backend import lba
from plslam_tpu_torch.backend.map import (MapState, _set_drop, add_keyframe,
                                          cull_landmarks,
                                          remove_redundant_kfs,
                                          remove_redundant_kfs_global)


def _compact_landmarks(valid, last_kf, start, cap: int):
    """Pick <= cap window-touched landmark slots, newest-touched first.
    Returns (ids (cap,), sel (cap,) bool, remap (N,) -> [-1, cap),
    n_overflow)."""
    touched = valid & (last_kf >= start)
    key = torch.where(touched, -last_kf, 2 ** 30)
    ids = torch.sort(key, stable=True).indices[:cap].to(torch.int32)
    sel = touched[ids.long()]
    n = valid.shape[0]
    remap = _set_drop(torch.full((n,), -1, dtype=torch.int32,
                                 device=valid.device),
                      torch.where(sel, ids, n),
                      torch.arange(cap, dtype=torch.int32,
                                   device=valid.device))
    n_overflow = torch.clamp(torch.sum(touched) - cap, min=0)
    return ids, sel, remap, n_overflow


def _build_window_problem(state: MapState, cam: StereoCamera,
                          cfg: SlamConfig):
    """The compact window problem and what ``_apply_lba_result`` needs."""
    m = cfg.mapping
    span = m.window_kfs + m.fixed_kfs
    F = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    start = torch.clamp(state.n_kfs - span, 0, max(F - span, 0))
    slots = (start + torch.arange(span, device=dev)).long()
    kf_pose_w = state.kf_pose[slots]
    T_cw = lie.inverse_se3(kf_pose_w)
    kf_valid = state.kf_valid[slots]
    # non-local (older than the last window_kfs) and the first KF stay
    # fixed: gauge + the reference's fixed-KF scheme
    fixed = (slots < state.n_kfs - m.window_kfs) | (slots == 0)
    P_loc = min(m.lba_max_points, state.pt_pos.shape[0])
    M_loc = min(m.lba_max_lines, state.ln_spos.shape[0])

    ids_pt, sel_pt, remap_pt, pt_over = _compact_landmarks(
        state.pt_valid, state.pt_last_kf, start, P_loc)
    obs_pt_orig = state.obs_pt_lm[slots]
    obs_pt_id = torch.where(obs_pt_orig >= 0,
                            remap_pt[torch.clamp(obs_pt_orig, min=0)], -1)
    ids_ln, sel_ln, remap_ln, ln_over = _compact_landmarks(
        state.ln_valid, state.ln_last_kf, start, M_loc)
    il = ids_ln.long()
    ep_loc = torch.stack([state.ln_spos[il], state.ln_epos[il]],
                         dim=1).reshape(2 * M_loc, 3)
    ln_lm = state.obs_ln_lm[slots]
    lm_loc = torch.where(ln_lm >= 0, remap_ln[torch.clamp(ln_lm, min=0)], -1)
    sid = torch.where(lm_loc >= 0, 2 * lm_loc, -1)
    eid = torch.where(lm_loc >= 0, 2 * lm_loc + 1, -1)
    prob = lba.LBAProblem(
        kf_pose=T_cw, kf_fixed=fixed, kf_valid=kf_valid,
        pt_pos=state.pt_pos[ids_pt.long()], ep_pos=ep_loc,
        obs_pt_uv=state.obs_pt_uv[slots],
        obs_pt_disp=state.obs_pt_disp[slots], obs_pt_id=obs_pt_id,
        obs_ln_le=state.obs_ln_le[slots], obs_ln_sid=sid, obs_ln_eid=eid)
    ctx = dict(slots=slots, kf_valid=kf_valid, kf_pose_w=kf_pose_w,
               ids_pt=ids_pt, sel_pt=sel_pt, obs_pt_orig=obs_pt_orig,
               obs_pt_id=obs_pt_id, ids_ln=ids_ln, sel_ln=sel_ln,
               ln_lm=ln_lm, sid=sid, pt_over=pt_over, ln_over=ln_over)
    return prob, ctx


def _apply_lba_result(state: MapState, res: lba.LBAResult, ctx):
    """Scatter an LBAResult back: poses, landmark positions, outlier
    observations detached (an observation that never entered the solve
    stays attached). Returns (state, cost0, cost1, diag)."""
    slots = ctx["slots"]
    P = state.pt_pos.shape[0]
    Ml = state.ln_spos.shape[0]
    M_loc = res.ep_pos.shape[0] // 2
    new_pose_w = lie.inverse_se3(res.kf_pose)
    kf_pose = state.kf_pose.index_copy(0, slots, torch.where(
        ctx["kf_valid"][:, None, None], new_pose_w, ctx["kf_pose_w"]))
    pt_pos = _set_drop(state.pt_pos, torch.where(ctx["sel_pt"], ctx["ids_pt"],
                                                 P), res.pt_pos)
    eps = res.ep_pos.reshape(M_loc, 2, 3)
    lidx = torch.where(ctx["sel_ln"], ctx["ids_ln"], Ml)
    obs_pt_lm = state.obs_pt_lm.index_copy(0, slots, torch.where(
        res.obs_pt_inlier | (ctx["obs_pt_id"] < 0), ctx["obs_pt_orig"], -1))
    obs_ln_lm = state.obs_ln_lm.index_copy(0, slots, torch.where(
        res.obs_ln_inlier | (ctx["sid"] < 0), ctx["ln_lm"], -1))
    new_state = state._replace(
        kf_pose=kf_pose, pt_pos=pt_pos,
        ln_spos=_set_drop(state.ln_spos, lidx, eps[:, 0]),
        ln_epos=_set_drop(state.ln_epos, lidx, eps[:, 1]),
        obs_pt_lm=obs_pt_lm, obs_ln_lm=obs_ln_lm)
    diag = {"lba_pt_overflow": ctx["pt_over"],
            "lba_ln_overflow": ctx["ln_over"]}
    return new_state, res.cost0, res.cost1, diag


def run_window_lba(state: MapState, cam: StereoCamera, cfg: SlamConfig
                   ) -> Tuple[MapState, torch.Tensor, torch.Tensor, dict]:
    """Compact window problem -> robust LM -> scatter back."""
    prob, ctx = _build_window_problem(state, cam, cfg)
    return _apply_lba_result(state, lba.run_lba(prob, cam, cfg), ctx)


def mapping_step_traced_lba(state: MapState, pts, lns, T_w_kf: torch.Tensor,
                            cam: StereoCamera, cfg: SlamConfig,
                            lba_flag: bool):
    """The mapping step of the strided-LBA mode: KF insertion + map
    matching + triangulation always; the window LBA and KF retirement only
    where ``lba_flag`` (the global sweep fires when a multiple of
    ``global_kf_sweep_every`` fell in the last ``lba_kf_stride``
    insertions); landmark culling always. Returns (state, diag, c0, c1,
    pt_overflow, ln_overflow)."""
    state, diag = add_keyframe(state, pts, lns, T_w_kf, cam, cfg)
    dev = T_w_kf.device
    c0 = c1 = torch.zeros((), dtype=torch.float32, device=dev)
    pt_ov = ln_ov = torch.zeros((), dtype=torch.int64, device=dev)
    if lba_flag:
        state, c0, c1, lba_diag = run_window_lba(state, cam, cfg)
        pt_ov, ln_ov = lba_diag["lba_pt_overflow"], lba_diag["lba_ln_overflow"]
        state, _ = remove_redundant_kfs(state, cfg)
        every = cfg.mapping.global_kf_sweep_every
        if every > 0:
            stride = max(int(cfg.mapping.lba_kf_stride), 1)
            state, _ = remove_redundant_kfs_global(
                state, cfg,
                enabled=torch.remainder(state.n_kfs, every) < stride)
    state = cull_landmarks(state, cfg)
    return state, diag, c0, c1, pt_ov, ln_ov


class KeyFrameSummary(NamedTuple):
    slot: int
    T_w_kf: np.ndarray          # corrected pose after LBA
    n_map_matches: int
    n_new_points: int
    lba_cost0: float
    lba_cost1: float
    lba_pt_overflow: int = 0    # window observations dropped by compaction
    lba_ln_overflow: int = 0
