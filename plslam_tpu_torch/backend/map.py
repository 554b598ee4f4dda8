"""Global map state, keyframe insertion with map matching and
triangulation, redundant-KF retirement and landmark culling.

Port of ``plslam_tpu/backend/map.py`` (``MapState``, ``init_map_state``,
``_medoid_desc``, ``_view_dirs``, ``_allocate_slots``, ``add_keyframe``,
``remove_redundant_kfs``, ``remove_redundant_kfs_global``,
``force_retire_kfs``, ``compact_keyframes``, ``cull_landmarks``): the
same fixed-capacity slot arrays, functional updates (every function
returns a new state and leaves its input alone), every scatter of the
reference's ``mode="drop"`` kind dropped at an out-of-range index, never
clamped. Packed descriptors are 8 int32 words
holding the reference's uint32 bit patterns (``ops/hamming.pack_bits``).
Scalar decisions (room for a KF, which KF retires, the pool-pressure
tier) stay device tensors: no function here waits for the device.

The representative descriptors (K16: the reference's ``_medoid_desc``,
its unpack and the select after it, ``_medoid_bits``) are one launch of
kernel J's ``medoid`` (``csrc/slam.cu``) on CUDA tensors. Slot
allocation is a stable ``torch.sort`` + ``cumsum``, and the reference's
``lax.top_k`` a stable descending sort: both break ties by the lowest
index, as the reference does. Map matching runs kernel D at (1, P, K) and
(1, M, L). ``fuse_loop_landmarks`` (the loop slice) matches the two loop
KFs' stored descriptors with kernel D at (1, K, K) and (1, L, L).
Pressure eviction (``force_retire_kfs``, its observer counts K7's
``take``) and KF-slot compaction (``compact_keyframes``) are rare
stop-the-world events of the driver and run in native torch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.ops import hamming
from plslam_tpu_torch.ops.gather import take


class MapState(NamedTuple):
    # keyframes
    kf_pose: torch.Tensor        # (F, 4, 4) T_w_kf (kf-to-world)
    kf_valid: torch.Tensor       # (F,) bool
    n_kfs: torch.Tensor          # () int32 — next slot
    # map points
    pt_pos: torch.Tensor         # (P, 3) world
    pt_desc: torch.Tensor        # (P, 256) uint8 representative descriptor
    pt_valid: torch.Tensor       # (P,) bool
    pt_nobs: torch.Tensor        # (P,) int32
    pt_last_kf: torch.Tensor     # (P,) int32
    pt_first_kf: torch.Tensor    # (P,) int32
    pt_desc_ring: torch.Tensor   # (P, R, 8) int32 words — last R observations
    pt_ring_n: torch.Tensor      # (P,) int32 monotonic ring-write count
    pt_dir: torch.Tensor         # (P, 3) mean viewing direction (unit)
    # map lines (3D endpoint pairs)
    ln_spos: torch.Tensor        # (M, 3)
    ln_epos: torch.Tensor        # (M, 3)
    ln_desc: torch.Tensor        # (M, 256) uint8
    ln_valid: torch.Tensor
    ln_nobs: torch.Tensor
    ln_last_kf: torch.Tensor
    ln_first_kf: torch.Tensor
    ln_desc_ring: torch.Tensor   # (M, R, 8) int32 words
    ln_ring_n: torch.Tensor      # (M,) int32
    ln_dir: torch.Tensor         # (M, 3)
    # per-KF observations (the sparse observation graph, dense-slotted)
    obs_pt_uv: torch.Tensor      # (F, K, 2)
    obs_pt_disp: torch.Tensor    # (F, K)
    obs_pt_lm: torch.Tensor      # (F, K) int32 -> point slot or -1
    obs_ln_le: torch.Tensor      # (F, L, 3)
    obs_ln_lm: torch.Tensor      # (F, L) int32 -> line slot or -1
    obs_ln_ends: torch.Tensor    # (F, L, 6) sp(2) ep(2) sdisp edisp
    # packed per-KF descriptors (for loop closure)
    kf_pt_desc: torch.Tensor     # (F, K, 8) int32 words
    kf_ln_desc: torch.Tensor     # (F, L, 8) int32 words


def require_points(cfg: SlamConfig, driver: str) -> None:
    """The SLAM drivers' refusal of the lines-only configuration: the
    reference's keyframe insertion cannot take a zero-capacity point set
    (``plslam_tpu/backend/map.py:193``, add_keyframe's map-point match
    raises on it), so no driver of either package maps without points."""
    if not cfg.points.has_points:
        raise NotImplementedError(
            f"{driver}: points.has_points=False (lines-only) runs the VO "
            "drivers only; the reference's add_keyframe (backend/map.py:193)"
            " fails on a zero-capacity point set, so there is no lines-only "
            "SLAM to port (ROADMAP.md, reference behaviours)")


def init_map_state(cfg: SlamConfig, device) -> MapState:
    m = cfg.mapping
    F, P, M = m.max_kfs, m.max_points, m.max_lines
    K, L, R = cfg.points.max_kpts, cfg.lines.max_lines, m.desc_ring
    f32, i32 = torch.float32, torch.int32
    z = lambda *s, dt=f32: torch.zeros(s, dtype=dt, device=device)
    neg = lambda *s: torch.full(s, -1, dtype=i32, device=device)
    return MapState(
        kf_pose=torch.eye(4, dtype=f32, device=device).repeat(F, 1, 1),
        kf_valid=z(F, dt=torch.bool), n_kfs=z(dt=i32),
        pt_pos=z(P, 3), pt_desc=z(P, 256, dt=torch.uint8),
        pt_valid=z(P, dt=torch.bool), pt_nobs=z(P, dt=i32),
        pt_last_kf=neg(P), pt_first_kf=neg(P), pt_desc_ring=z(P, R, 8, dt=i32),
        pt_ring_n=z(P, dt=i32), pt_dir=z(P, 3),
        ln_spos=z(M, 3), ln_epos=z(M, 3), ln_desc=z(M, 256, dt=torch.uint8),
        ln_valid=z(M, dt=torch.bool), ln_nobs=z(M, dt=i32),
        ln_last_kf=neg(M), ln_first_kf=neg(M), ln_desc_ring=z(M, R, 8, dt=i32),
        ln_ring_n=z(M, dt=i32), ln_dir=z(M, 3),
        obs_pt_uv=z(F, K, 2), obs_pt_disp=z(F, K), obs_pt_lm=neg(F, K),
        obs_ln_le=z(F, L, 3), obs_ln_lm=neg(F, L), obs_ln_ends=z(F, L, 6),
        kf_pt_desc=z(F, K, 8, dt=i32), kf_ln_desc=z(F, L, 8, dt=i32))


# -- scatter helpers with the reference's mode="drop" ---------------------

def _set_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` along axis 0 (an index
    outside [0, len) writes nothing)."""
    n = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
    ii = torch.where((idx >= 0) & (idx < n), idx, n).long()
    out[ii] = vals if torch.is_tensor(vals) else torch.as_tensor(
        vals, dtype=arr.dtype, device=arr.device)
    return out[:n]


def _add_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].add(vals, mode="drop")`` (integer or exact adds)."""
    n = arr.shape[0]
    out = torch.cat([arr, arr.new_zeros((1,))])
    ii = torch.where((idx >= 0) & (idx < n), idx, n).long()
    v = torch.as_tensor(vals, dtype=arr.dtype, device=arr.device)
    return out.index_add(0, ii, v.expand(ii.shape))[:n]


def _set_row(arr: torch.Tensor, slot: torch.Tensor, val,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``arr.at[slot].set(val)`` for a 0-d slot; where ``keep`` is True the
    row keeps its old value (the reference's dropped write)."""
    idx = slot.reshape(1).long()
    if keep is not None:
        val = torch.where(keep, arr.index_select(0, idx)[0], val)
    return arr.index_copy(0, idx, val[None])


def _stable_top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the k largest, ties by the lowest index."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


# -- K16 and slot allocation ----------------------------------------------

def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its uint32 pattern)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _medoid_desc_plain(ring: torch.Tensor, count: torch.Tensor):
    R = ring.shape[1]
    x = torch.bitwise_xor(ring[:, :, None, :], ring[:, None, :, :])
    d = _popcount32(x).sum(-1)                            # (N, R, R)
    valid = (torch.arange(R, device=ring.device)[None, :]
             < torch.clamp(count, max=R)[:, None])
    mask = valid[:, :, None] & valid[:, None, :]
    dsum = torch.sum(torch.where(mask, d, 0), dim=1)
    dsum = torch.where(valid, dsum, 2 ** 30)
    mi = torch.argmin(dsum, dim=1)          # first index on ties
    return torch.take_along_dim(ring, mi[:, None, None], dim=1)[:, 0]


def _medoid_bits_plain(ring, count, valid, desc):
    return torch.where(valid[:, None],
                       hamming.unpack_bits(_medoid_desc_plain(ring, count)),
                       desc)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy of it where its data is not 16-byte
    aligned (the kernel's vector loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _medoid_bits(ring: torch.Tensor, count: torch.Tensor,
                 valid: torch.Tensor, desc: torch.Tensor) -> torch.Tensor:
    """The representative descriptors as the map stores them: for a valid
    landmark the bits (N, 256) of its ring member (N, R, 8) with the least
    summed Hamming distance to the other ``count`` stored observations
    (updateAverageDescDir's median descriptor), else its ``desc`` row. On
    CUDA one ``medoid`` launch (medoid, unpack and select)."""
    if ring.device.type == "cpu":
        return _medoid_bits_plain(ring, count, valid, desc)
    N, R, _ = ring.shape
    ring = _aligned16(ring.to(torch.int32).contiguous())
    count = count.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous().view(torch.uint8)
    desc = _aligned16(desc.contiguous())
    native.require(ring, "medoid ring", torch.int32, (N, R, 8))
    native.require(count, "medoid count", torch.int32, (N,))
    native.require(valid, "medoid valid", torch.uint8, (N,))
    native.require(desc, "medoid desc", torch.uint8, (N, hamming.N_BITS))
    if not 1 <= R <= 8:
        raise ValueError(f"medoid: a ring of {R} (1..8)")
    out = torch.empty((N, hamming.N_BITS), dtype=torch.uint8,
                      device=ring.device)
    if N:
        native.launch("medoid", ring, count, valid, desc, out, N, R)
    return out


def _view_dirs(pos: torch.Tensor, cam_center: torch.Tensor) -> torch.Tensor:
    """Unit viewing directions camera-center -> landmark, (N, 3)."""
    v = pos - cam_center[None, :]
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def _allocate_slots(free: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The j-th wanted item gets the j-th free slot, or -1 when the pool
    is exhausted: (N,) free, (K,) want -> (K,) int32."""
    order = torch.sort((~free).to(torch.uint8), stable=True).indices
    n_free = torch.sum(free)
    rank = torch.cumsum(want.to(torch.int32), dim=0) - 1
    slot = torch.where(want & (rank < n_free),
                       order[torch.clamp(rank, 0, free.shape[0] - 1)], -1)
    return slot.to(torch.int32)


# -- insertion --------------------------------------------------------------

def _match_into_kf(lm_desc, proj_ok, f_desc, f_valid, pred, f_pos, window,
                   max_dist, ratio):
    """Map landmarks -> this KF's features (both packed words): kernel D at
    (1, N, K) with the f2f window around each landmark's prediction."""
    res = hamming.match_gated(lm_desc[None], f_desc[None], proj_ok[None],
                              f_valid[None],
                              hamming.Window(pred[None], f_pos[None], window),
                              max_dist, ratio, mutual=True)
    return res.idx[0], res.valid[0]


def _insert_family(state_pos, valid, nobs, first, last, ring, ring_n, dirs,
                   desc, matched, feat_of, f_packed, new_slot, pos_new,
                   vdir, vnew, slot):
    """Shared landmark update of add_keyframe (points, or lines with two
    position arrays in ``state_pos``/``pos_new``)."""
    n = valid.shape[0]
    R = ring.shape[1]
    ok_new = new_slot >= 0
    sidx = torch.where(ok_new, new_slot, n)
    pos = tuple(_set_drop(p, sidx, v) for p, v in zip(state_pos, pos_new))
    valid2 = _set_drop(valid, sidx, True)
    nobs2 = _set_drop(nobs, sidx, 1)
    first2 = _set_drop(first, sidx, slot)
    last2 = _set_drop(last, sidx, slot)
    ring2 = ring.clone()
    ring2[:, 0] = _set_drop(ring[:, 0], sidx, f_packed)
    ring_n2 = _set_drop(ring_n, sidx, 1)
    dirs2 = _set_drop(dirs, sidx, vnew)
    # refresh matched landmarks: ring slot, counters, mean direction
    ar = torch.arange(n, device=valid.device)
    midx = torch.where(matched, ar, n)
    rpos = torch.remainder(ring_n, R)
    ring2 = _set_drop(ring2.reshape(n * R, 8),
                      torch.where(matched, midx * R + rpos, n * R),
                      f_packed[feat_of]).reshape(n, R, 8)
    ring_n2 = _add_drop(ring_n2, midx, 1)
    dir_upd = dirs * nobs[:, None].to(torch.float32) + vdir
    dir_upd = dir_upd / torch.clamp(torch.linalg.norm(dir_upd, dim=-1,
                                                      keepdim=True), min=1e-9)
    dirs2 = torch.where(matched[:, None], dir_upd, dirs2)
    nobs2 = _add_drop(nobs2, midx, 1)
    last2 = _set_drop(last2, midx, slot)
    desc2 = _medoid_bits(ring2, ring_n2, valid2, desc)
    return pos, valid2, nobs2, first2, last2, ring2, ring_n2, dirs2, desc2


def add_keyframe(state: MapState, pts: PointObservations,
                 lns: Optional[LineObservations], T_w_kf: torch.Tensor,
                 cam: StereoCamera, cfg: SlamConfig
                 ) -> Tuple[MapState, dict]:
    """addKeyFrame + lookForCommonMatches + landmark expansion: the KF
    record, map matching of existing landmarks into the new KF's features
    (projective window + descriptor NN), new landmarks from unmatched
    stereo features, refreshed representative descriptors and counters.
    ``pts``/``lns`` are one frame's features (no batch axis)."""
    mcfg = cfg.mapping
    mtch = cfg.matching
    F = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    # capacity guard: at slot == F the insert is a no-op (dropped writes,
    # n_kfs frozen at F), never a clamped write onto slot F-1
    has_room = state.n_kfs < F
    slot = torch.clamp(state.n_kfs, max=F - 1)
    T_cw = lie.inverse_se3(T_w_kf)
    cam_center = T_w_kf[:3, 3]

    # ---- match existing map points into this KF --------------------------
    Pc = lie.transform_points(T_cw, state.pt_pos)
    uv_pred = cam.project(Pc)
    recent = state.pt_last_kf >= slot - mcfg.window_kfs - mcfg.fixed_kfs
    vdir_pt = _view_dirs(state.pt_pos, cam_center)
    dir_ok = ((state.pt_nobs < 1)
              | (torch.sum(state.pt_dir * vdir_pt, dim=-1) > mcfg.view_cos_th))
    proj_ok = (state.pt_valid & recent & dir_ok & (Pc[..., 2] > 0.5)
               & cam.in_image(uv_pred, margin=-20.0))
    pts_packed = hamming.pack_bits(pts.desc)                       # (K, 8)
    m_idx, m_valid = _match_into_kf(
        state.pt_desc, proj_ok, pts_packed, pts.valid, uv_pred, pts.uv,
        mtch.f2f_window, mtch.max_hamming_p, mtch.min_ratio_12_p)
    pt_matched = m_valid & has_room
    feat_of_pt = torch.clamp(m_idx, min=0).long()
    K = pts.uv.shape[0]
    P_slots = state.pt_pos.shape[0]
    feat_lm = _set_drop(torch.full((K,), -1, dtype=torch.int32, device=dev),
                        torch.where(pt_matched, feat_of_pt, K),
                        torch.arange(P_slots, dtype=torch.int32, device=dev))

    # ---- new landmarks from unmatched stereo features --------------------
    want_new = pts.valid & (feat_lm < 0) & has_room
    new_slot = _allocate_slots(~state.pt_valid, want_new)
    P_world = lie.transform_points(T_w_kf, pts.P)
    feat_lm = torch.where(new_slot >= 0, new_slot, feat_lm)
    ((pt_pos,), pt_valid, pt_nobs, pt_first, pt_last, pt_ring, pt_ring_n,
     pt_dir, pt_desc) = _insert_family(
        (state.pt_pos,), state.pt_valid, state.pt_nobs, state.pt_first_kf,
        state.pt_last_kf, state.pt_desc_ring, state.pt_ring_n, state.pt_dir,
        state.pt_desc, pt_matched, feat_of_pt, pts_packed, new_slot,
        (P_world,), vdir_pt, _view_dirs(P_world, cam_center), slot)
    no_room = ~has_room

    # ---- lines -----------------------------------------------------------
    if lns is not None:
        mid_w = 0.5 * (state.ln_spos + state.ln_epos)
        Pm = lie.transform_points(T_cw, mid_w)
        mid_pred = cam.project(Pm)
        lrecent = state.ln_last_kf >= slot - mcfg.window_kfs - mcfg.fixed_kfs
        vdir_ln = _view_dirs(mid_w, cam_center)
        ldir_ok = ((state.ln_nobs < 1)
                   | (torch.sum(state.ln_dir * vdir_ln, dim=-1)
                      > mcfg.view_cos_th))
        lproj_ok = (state.ln_valid & lrecent & ldir_ok & (Pm[..., 2] > 0.5)
                    & cam.in_image(mid_pred, margin=-40.0))
        lns_packed = hamming.pack_bits(lns.desc)
        l_idx, l_valid = _match_into_kf(
            state.ln_desc, lproj_ok, lns_packed, lns.valid, mid_pred,
            0.5 * (lns.sp + lns.ep), mtch.f2f_window, mtch.max_hamming_l,
            mtch.min_ratio_12_l)
        ln_matched = l_valid & has_room
        feat_of_ln = torch.clamp(l_idx, min=0).long()
        L = lns.sp.shape[0]
        M_slots = state.ln_spos.shape[0]
        lfeat_lm = _set_drop(
            torch.full((L,), -1, dtype=torch.int32, device=dev),
            torch.where(ln_matched, feat_of_ln, L),
            torch.arange(M_slots, dtype=torch.int32, device=dev))
        lwant_new = lns.valid & (lfeat_lm < 0) & has_room
        lnew_slot = _allocate_slots(~state.ln_valid, lwant_new)
        lfeat_lm = torch.where(lnew_slot >= 0, lnew_slot, lfeat_lm)
        sP_w = lie.transform_points(T_w_kf, lns.sP)
        eP_w = lie.transform_points(T_w_kf, lns.eP)
        ((ln_spos, ln_epos), ln_valid, ln_nobs, ln_first, ln_last, ln_ring,
         ln_ring_n, ln_dir, ln_desc) = _insert_family(
            (state.ln_spos, state.ln_epos), state.ln_valid, state.ln_nobs,
            state.ln_first_kf, state.ln_last_kf, state.ln_desc_ring,
            state.ln_ring_n, state.ln_dir, state.ln_desc, ln_matched,
            feat_of_ln, lns_packed, lnew_slot, (sP_w, eP_w), vdir_ln,
            _view_dirs(0.5 * (sP_w + eP_w), cam_center), slot)
        obs_ln_le = _set_row(state.obs_ln_le, slot, lns.le, no_room)
        obs_ln_lm = _set_row(state.obs_ln_lm, slot,
                             torch.where(lns.valid, lfeat_lm, -1), no_room)
        # disparities masked to 0 for invalid detections: downstream
        # consumers use ends[:, 4] > 0 as validity
        ends = torch.cat([lns.sp, lns.ep,
                          torch.where(lns.valid, lns.sdisp, 0.0)[:, None],
                          torch.where(lns.valid, lns.edisp, 0.0)[:, None]],
                         dim=-1)
        obs_ln_ends = _set_row(state.obs_ln_ends, slot, ends, no_room)
        kf_ln_desc = _set_row(state.kf_ln_desc, slot, lns_packed, no_room)
        n_ln_matched = torch.sum(ln_matched)
    else:
        ln_spos, ln_epos = state.ln_spos, state.ln_epos
        ln_desc, ln_valid = state.ln_desc, state.ln_valid
        ln_nobs, ln_last, ln_first = (state.ln_nobs, state.ln_last_kf,
                                      state.ln_first_kf)
        ln_ring, ln_ring_n, ln_dir = (state.ln_desc_ring, state.ln_ring_n,
                                      state.ln_dir)
        obs_ln_le, obs_ln_lm = state.obs_ln_le, state.obs_ln_lm
        obs_ln_ends, kf_ln_desc = state.obs_ln_ends, state.kf_ln_desc
        n_ln_matched = torch.zeros((), dtype=torch.int64, device=dev)

    # ---- the KF record ---------------------------------------------------
    new_state = state._replace(
        kf_pose=_set_row(state.kf_pose, slot, T_w_kf, no_room),
        kf_valid=_set_row(state.kf_valid, slot,
                          torch.ones((), dtype=torch.bool, device=dev),
                          no_room),
        n_kfs=state.n_kfs + has_room.to(torch.int32),
        pt_pos=pt_pos, pt_desc=pt_desc, pt_valid=pt_valid, pt_nobs=pt_nobs,
        pt_last_kf=pt_last, pt_first_kf=pt_first,
        pt_desc_ring=pt_ring, pt_ring_n=pt_ring_n, pt_dir=pt_dir,
        ln_spos=ln_spos, ln_epos=ln_epos, ln_desc=ln_desc, ln_valid=ln_valid,
        ln_nobs=ln_nobs, ln_last_kf=ln_last, ln_first_kf=ln_first,
        ln_desc_ring=ln_ring, ln_ring_n=ln_ring_n, ln_dir=ln_dir,
        obs_pt_uv=_set_row(state.obs_pt_uv, slot, pts.uv, no_room),
        obs_pt_disp=_set_row(state.obs_pt_disp, slot,
                             torch.where(pts.valid, pts.disp, 0.0), no_room),
        obs_pt_lm=_set_row(state.obs_pt_lm, slot,
                           torch.where(pts.valid, feat_lm, -1), no_room),
        obs_ln_le=obs_ln_le, obs_ln_lm=obs_ln_lm, obs_ln_ends=obs_ln_ends,
        kf_pt_desc=_set_row(state.kf_pt_desc, slot, pts_packed, no_room),
        kf_ln_desc=kf_ln_desc,
    )
    diag = {"n_map_matches": torch.sum(pt_matched & pts.valid[feat_of_pt]),
            "n_new_points": torch.sum(new_slot >= 0),
            "n_ln_matches": n_ln_matched,
            "kf_slot": slot}
    return new_state, diag


# -- retirement and culling ---------------------------------------------------

def _detach_kf(state: MapState, slot, do) -> MapState:
    """Retire KF ``slot`` where ``do``: its observations detach (counters
    decremented) and it stops being a BA variable."""
    P = state.pt_pos.shape[0]
    M = state.ln_spos.shape[0]
    idx = slot.reshape(1).long()
    lm = state.obs_pt_lm.index_select(0, idx)[0]
    llm = state.obs_ln_lm.index_select(0, idx)[0]
    pt_nobs = _add_drop(state.pt_nobs, torch.where((lm >= 0) & do, lm, P), -1)
    ln_nobs = _add_drop(state.ln_nobs, torch.where((llm >= 0) & do, llm, M),
                        -1)
    return state._replace(
        kf_valid=_set_row(state.kf_valid, slot, torch.zeros_like(
            state.kf_valid[0]), ~do),
        obs_pt_lm=_set_row(state.obs_pt_lm, slot, torch.full_like(lm, -1),
                           ~do),
        obs_ln_lm=_set_row(state.obs_ln_lm, slot, torch.full_like(llm, -1),
                           ~do),
        pt_nobs=pt_nobs, ln_nobs=ln_nobs)


def remove_redundant_kfs(state: MapState, cfg: SlamConfig
                         ) -> Tuple[MapState, torch.Tensor]:
    """removeRedundantKFs: the most redundant window KF (most of its
    landmarks seen by >= 4 KFs) retires; the newest and the first never
    do. Returns (state, n_removed)."""
    m = cfg.mapping
    F = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    slots = torch.clamp(state.n_kfs - 1 - torch.arange(
        1, m.window_kfs, device=dev), 0, F - 1)
    lm = state.obs_pt_lm[slots]                                 # (S, K)
    ok = lm >= 0
    well = ok & (state.pt_nobs[torch.clamp(lm, min=0)] >= 4)
    fracs = torch.sum(well, dim=1) / torch.clamp(torch.sum(ok, dim=1), min=1)
    removable = ((fracs > m.max_common_fts_kf) & (slots > 0)
                 & state.kf_valid[slots])
    best = torch.argmax(torch.where(removable, fracs, -1.0))
    do = torch.any(removable)
    return _detach_kf(state, slots[best], do), do.to(torch.int32)


def remove_redundant_kfs_global(state: MapState, cfg: SlamConfig,
                                max_retire: int = 4,
                                enabled: Optional[torch.Tensor] = None
                                ) -> Tuple[MapState, torch.Tensor]:
    """The GLOBAL redundant-KF sweep: up to ``max_retire`` KFs anywhere in
    the map, most redundant first, with the stricter observer threshold
    max_retire + min_lm_obs. ``enabled`` (a device bool) gates the whole
    sweep, as the reference's ``lax.cond`` around it. Returns (state,
    n_removed)."""
    m = cfg.mapping
    F = state.kf_pose.shape[0]
    slots_arr = torch.arange(F, device=state.kf_pose.device)
    newest = state.n_kfs - 1
    lm = state.obs_pt_lm
    ok = lm >= 0
    nobs = state.pt_nobs[torch.clamp(lm, min=0)]
    well = ok & (nobs >= max_retire + m.min_lm_obs)
    frac = torch.sum(well, dim=1) / torch.clamp(torch.sum(ok, dim=1), min=1)
    removable = ((frac > m.max_common_fts_kf) & state.kf_valid
                 & (slots_arr > 0) & (slots_arr != newest)
                 & (slots_arr < state.n_kfs))
    vals, cand = _stable_top_k(torch.where(removable, frac, -1.0), max_retire)
    do = vals > 0
    if enabled is not None:
        do = do & enabled
    for j in range(max_retire):
        state = _detach_kf(state, cand[j], do[j])
    return state, torch.sum(do)


def force_retire_kfs(state: MapState, cfg: SlamConfig, n_retire: int
                     ) -> Tuple[MapState, torch.Tensor]:
    """Memory-pressure eviction: retire up to ``n_retire`` keyframes even
    below the redundancy bar, most redundant first (the fraction of a KF's
    landmarks with at least min_lm_obs observers), odd slots before even
    ones among comparably redundant KFs, oldest on ties. Protected: slot
    0, the LBA window and its fixed span, the newest KF. The score is the
    reference's float32 expression in its order, and the top ``n_retire``
    take ``lax.top_k``'s tie order. Returns (state, n_removed)."""
    m = cfg.mapping
    F = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    f32 = torch.float32
    slots = torch.arange(F, device=dev)
    span = m.window_kfs + m.fixed_kfs
    lm = state.obs_pt_lm                                         # (F, K)
    ok = lm >= 0
    nobs = take(state.pt_nobs.expand(F, -1), lm)                 # K7
    well = ok & (nobs >= m.min_lm_obs)
    frac = torch.sum(well, dim=1) / torch.clamp(torch.sum(ok, dim=1), min=1)
    removable = (state.kf_valid & (slots > 0) & (slots < state.n_kfs - span)
                 & (slots != state.n_kfs - 1))
    score = torch.where(
        removable,
        frac + torch.tensor(0.1, dtype=f32) * (slots % 2).to(f32)
        - torch.tensor(1e-4, dtype=f32) * slots.to(f32), -torch.inf)
    vals, cand = _stable_top_k(score, n_retire)
    do = torch.isfinite(vals)
    P = state.pt_pos.shape[0]
    M = state.ln_spos.shape[0]
    rows_p = state.obs_pt_lm[cand]
    rows_l = state.obs_ln_lm[cand]
    # the candidates are distinct slots: one integer index_add a family
    pt_nobs = _add_drop(state.pt_nobs, torch.where(
        (rows_p >= 0) & do[:, None], rows_p, P).reshape(-1), -1)
    ln_nobs = _add_drop(state.ln_nobs, torch.where(
        (rows_l >= 0) & do[:, None], rows_l, M).reshape(-1), -1)
    hit = _set_drop(torch.zeros_like(state.kf_valid), cand, do)
    return state._replace(
        kf_valid=state.kf_valid & ~hit, pt_nobs=pt_nobs, ln_nobs=ln_nobs,
        obs_pt_lm=torch.where(hit[:, None], -1, state.obs_pt_lm),
        obs_ln_lm=torch.where(hit[:, None], -1, state.obs_ln_lm)
    ), torch.sum(do).to(torch.int32)


def compact_keyframes(state: MapState) -> Tuple[MapState, torch.Tensor,
                                                torch.Tensor, torch.Tensor]:
    """Order-preserving KF-slot compaction: the valid slots below n_kfs
    move down in their order, the tail is freed (identity poses, -1
    landmark ids, 0 elsewhere). Returns (state, exact_map (F,),
    floor_map (F,), n_valid): exact_map[old] is the new slot or -1 for a
    dropped one, floor_map[old] the new slot of the nearest surviving KF
    at or before ``old`` (-1 if none), through which the landmarks' first
    and last KFs are remapped."""
    F = state.kf_pose.shape[0]
    dev = state.kf_pose.device
    i32 = torch.int32
    idx = torch.arange(F, dtype=i32, device=dev)
    valid = state.kf_valid & (idx < state.n_kfs)
    inc = torch.cumsum(valid.to(i32), 0, dtype=i32)               # inclusive
    n_valid = inc[-1]
    exact_map = torch.where(valid, inc - 1, -1)
    floor_map = torch.where(inc > 0, inc - 1, -1)
    # survivors in their order, then the dropped slots
    perm = torch.sort(torch.where(valid, idx, F + idx), stable=True).indices
    live = idx < n_valid

    def g(a, fill):
        return torch.where(live.reshape((F,) + (1,) * (a.ndim - 1)), a[perm],
                           torch.tensor(fill, dtype=a.dtype, device=dev))

    eye = torch.eye(4, dtype=state.kf_pose.dtype, device=dev)
    remap_time = lambda t: torch.where(
        t >= 0, floor_map[torch.clamp(t, 0, F - 1).long()], -1)
    return state._replace(
        kf_pose=torch.where(live[:, None, None], state.kf_pose[perm], eye),
        kf_valid=live, n_kfs=n_valid,
        pt_first_kf=remap_time(state.pt_first_kf),
        pt_last_kf=remap_time(state.pt_last_kf),
        ln_first_kf=remap_time(state.ln_first_kf),
        ln_last_kf=remap_time(state.ln_last_kf),
        obs_pt_uv=g(state.obs_pt_uv, 0.0),
        obs_pt_disp=g(state.obs_pt_disp, 0.0),
        obs_pt_lm=g(state.obs_pt_lm, -1),
        obs_ln_le=g(state.obs_ln_le, 0.0),
        obs_ln_lm=g(state.obs_ln_lm, -1),
        obs_ln_ends=g(state.obs_ln_ends, 0.0),
        kf_pt_desc=g(state.kf_pt_desc, 0),
        kf_ln_desc=g(state.kf_ln_desc, 0),
    ), exact_map, floor_map, n_valid


def cull_landmarks(state: MapState, cfg: SlamConfig) -> MapState:
    """removeBadMapLandmarks: drop landmarks that stopped being observed
    before reaching min_lm_obs observations, plus the pool-pressure tier
    (past the high water mark the weakest mature landmarks retire), and
    detach every observation of a culled landmark."""
    m = cfg.mapping
    cur = state.n_kfs - 1
    grace = 2
    bad_pt = (state.pt_valid & (state.pt_nobs < m.min_lm_obs)
              & (state.pt_last_kf < cur - grace))
    bad_ln = (state.ln_valid & (state.ln_nobs < m.min_lm_obs)
              & (state.ln_last_kf < cur - grace))
    span = m.window_kfs + m.fixed_kfs

    def pressure(valid, nobs, last_kf, already_bad):
        P = valid.shape[0]
        n_evict = max(int(m.lm_pool_evict_frac * P), 1)
        occ = torch.sum((valid & ~already_bad).to(torch.int32))
        over = occ > int(m.lm_pool_high_water * P)
        removable = valid & ~already_bad & (last_kf < cur - span)
        score = torch.where(
            removable, -(nobs.to(torch.float32) * (2.0 * P)
                         + last_kf.to(torch.float32)), -torch.inf)
        vals, idx = _stable_top_k(score, n_evict)
        hit = _set_drop(torch.zeros_like(valid), idx, torch.isfinite(vals))
        return hit & over

    bad_pt = bad_pt | pressure(state.pt_valid, state.pt_nobs,
                               state.pt_last_kf, bad_pt)
    bad_ln = bad_ln | pressure(state.ln_valid, state.ln_nobs,
                               state.ln_last_kf, bad_ln)
    o, lo = state.obs_pt_lm, state.obs_ln_lm
    obs_pt_lm = torch.where((o >= 0) & bad_pt[torch.clamp(o, min=0)], -1, o)
    obs_ln_lm = torch.where((lo >= 0) & bad_ln[torch.clamp(lo, min=0)], -1,
                            lo)
    return state._replace(pt_valid=state.pt_valid & ~bad_pt,
                          ln_valid=state.ln_valid & ~bad_ln,
                          obs_pt_lm=obs_pt_lm, obs_ln_lm=obs_ln_lm)


# -- loop closure: duplicate-landmark fusion -----------------------------------

def _fusion_remap(n: int, fuse, keep, dup) -> torch.Tensor:
    """``arange(n).at[where(fuse, dup, n)].set(where(fuse, keep, 0),
    mode="drop")`` made transitive by two pointer-jumping hops. A slot that
    is the dup of several fused pairs takes the keep of the LAST such pair
    in row order, as the reference's in-order CPU scatter leaves it
    (``index_put_`` with repeated indices is undefined on CUDA)."""
    dev = keep.device
    rows = torch.arange(keep.shape[0], dtype=torch.int64, device=dev)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, torch.where(fuse, dup, n), rows, "amax")[:n]
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    remap = torch.where(last >= 0, keep[torch.clamp(last, min=0)], ar)
    remap = remap[remap]
    return remap[remap]


def _fuse_family(lm_a, lm_b, desc_a, desc_b, pos, valid, nobs, obs_lm,
                 max_dist, ratio):
    """One landmark family of ``fuse_loop_landmarks``: (obs_lm, valid,
    nobs, n_fused). ``pos`` maps landmark slots to the positions whose
    squared distance must stay below 0.25 (0.5 m)."""
    n = valid.shape[0]
    ok_a, ok_b = lm_a >= 0, lm_b >= 0
    mres = hamming.match_gated(desc_a[None], desc_b[None], ok_a[None],
                               ok_b[None], None, max_dist, ratio, mutual=True)
    lbm = lm_b[torch.clamp(mres.idx[0], min=0).long()]
    la = torch.clamp(lm_a, min=0).long()
    lb = torch.clamp(lbm, min=0).long()
    close = torch.sum((pos(la) - pos(lb)) ** 2, dim=-1) < 0.25
    fuse = mres.valid[0] & ok_a & (lbm >= 0) & close & (la != lb)
    keep, dup = torch.minimum(la, lb), torch.maximum(la, lb)
    remap = _fusion_remap(n, fuse, keep, dup)
    obs = torch.where(obs_lm >= 0, remap[torch.clamp(obs_lm, min=0).long()],
                      -1).to(obs_lm.dtype)
    ar = torch.arange(n, dtype=torch.int64, device=remap.device)
    new_nobs = _add_drop(nobs, torch.where(fuse, keep, n),
                         torch.where(fuse, nobs[dup], 0))
    return obs, valid & (remap == ar), new_nobs, torch.sum(fuse)


def fuse_loop_landmarks(state: MapState, slot_a, slot_b, cfg: SlamConfig
                        ) -> Tuple[MapState, torch.Tensor]:
    """loopClosureFuseLandmarks parity (fusion half): landmarks observed by
    the two loop KFs that match by descriptor (mutual NN + ratio, kernel D
    on the stored packed words) and lie within 0.5 m are duplicates: merge
    into the older slot and redirect every observation table entry. Points
    by position, lines by segment midpoint. Returns (state, n_fused)."""
    dev = state.kf_pose.device
    sa = torch.as_tensor(slot_a, device=dev).reshape(1).long()
    sb = torch.as_tensor(slot_b, device=dev).reshape(1).long()
    row = lambda x, s: x.index_select(0, s)[0]
    m = cfg.matching
    obs_pt_lm, pt_valid, pt_nobs, n_pt = _fuse_family(
        row(state.obs_pt_lm, sa), row(state.obs_pt_lm, sb),
        row(state.kf_pt_desc, sa), row(state.kf_pt_desc, sb),
        lambda i: state.pt_pos[i], state.pt_valid, state.pt_nobs,
        state.obs_pt_lm, m.max_hamming_p, m.min_ratio_12_p)
    mid = lambda i: 0.5 * (state.ln_spos[i] + state.ln_epos[i])
    obs_ln_lm, ln_valid, ln_nobs, n_ln = _fuse_family(
        row(state.obs_ln_lm, sa), row(state.obs_ln_lm, sb),
        row(state.kf_ln_desc, sa), row(state.kf_ln_desc, sb), mid,
        state.ln_valid, state.ln_nobs, state.obs_ln_lm, m.max_hamming_l,
        m.min_ratio_12_l)
    state = state._replace(obs_pt_lm=obs_pt_lm, pt_valid=pt_valid,
                           pt_nobs=pt_nobs, obs_ln_lm=obs_ln_lm,
                           ln_valid=ln_valid, ln_nobs=ln_nobs)
    return state, n_pt + n_ln
