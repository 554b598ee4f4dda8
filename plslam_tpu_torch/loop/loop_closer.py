"""Loop closure: retrieval -> geometric verification -> pose-graph
optimisation -> map correction.

Port of ``plslam_tpu/loop/loop_closer.py``: ``verify_loop_geometry`` (kernel
D on the two KFs' stored descriptors with mutual matching, then K13's
``optimize_pose`` with B = 1), ``covisibility_counts``,
``apply_graph_correction``, ``probe_core`` (the per-KF BoW insert and query,
kernel L), ``_post_loop_update``, ``floored_uncertainty``, ``LoopEvent`` and
``LoopCloser`` with the lazy-correction branch and ``_optimize_graph``
(kernel M). The host logic (edges, candidates, votes, gates, the graph's
slot bucket and edge cap, tail propagation, the un-crop) is the
reference's numpy, copied.

The probe writes a keyframe's row of the BoW matrices in place
(``index_copy_``; the reference's ``.at[slot].set`` is functional and
would copy 2 x 20 MB per keyframe). ``remap_slots`` follows a KF-slot
compaction. The host-KF driver's hooks are ported too:
``closure_imminent`` (the mapping worker's switch to strict ordering) and
``on_probe_batch(es)`` (the probe rows of one or more chunk-backend
dispatches, fetched once). The reference's ``_make_kf_probe`` is only a
``jax.jit`` of ``probe_core``, which ``on_keyframe`` calls directly here.
With ``loop.distributed=True`` the candidates come from the sharded
database (``parallel/dist_vocab.py::DistRetrieval``): each keyframe's BoW
rows are mirrored into it, it answers the query, and it follows
compactions. With ``PLSLAM_LC_DEBUG`` set in the environment a closure
applies its correction in stages (the reference's map-corruption hunt):
the same three steps as ``_post_loop_update``, each stage's largest
keyframe translation read back and printed where one passes 1e4.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.convert import host_copies
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.loop import vocabulary
from plslam_tpu_torch.loop.database import (BowDatabase, ConsistencyVoter,
                                            LoopCandidate, select_candidates)
from plslam_tpu_torch.loop.pose_graph import (PoseGraph, frozen_mask,
                                              optimize_pose_graph,
                                              optimize_pose_graph_pcg)
from plslam_tpu_torch.ops import hamming
from plslam_tpu_torch.ops.gather import take
from plslam_tpu_torch.tracking import pose_gn


def _row(x: torch.Tensor, slot) -> torch.Tensor:
    """``x[slot]`` for a host int or a 0-d device tensor (no host wait)."""
    idx = torch.as_tensor(slot, device=x.device).reshape(1).long()
    return x.index_select(0, idx)[0]


def verify_loop_geometry(kf_desc_a, obs_uv_a, obs_disp_a, kf_desc_b, obs_uv_b,
                         ln_desc_a, ln_ends_a, ln_desc_b, ln_ends_b, ln_le_b,
                         cam: StereoCamera, cfg: SlamConfig):
    """isLoopClosure geometric half: match the stored ORB and LBD
    descriptors of candidate KF a and current KF b (mutual NN + ratio),
    then the robust GN solve of T_ab mapping a-frame 3D points and line
    endpoints onto b's observations. Returns (PoseResult without the batch
    axis, n_matches)."""
    valid_a = obs_disp_a > 0
    valid_b = torch.any(obs_uv_b != 0, dim=-1)
    mres = hamming.match_gated(kf_desc_a[None], kf_desc_b[None],
                               valid_a[None], valid_b[None], None,
                               cfg.matching.max_hamming_p,
                               cfg.matching.min_ratio_12_p, mutual=True)
    idx = torch.clamp(mres.idx[0], min=0).long()
    P_a = cam.back_project(obs_uv_a, torch.where(valid_a, obs_disp_a, 1.0))
    terms = pose_gn.PointTerms(P_a[None], obs_uv_b[idx][None],
                               (mres.valid[0] & valid_a)[None])
    ln_terms = None
    n_ln = torch.zeros((), dtype=torch.int64, device=obs_uv_a.device)
    if cfg.lines.has_lines:
        lva = (ln_ends_a[:, 4] > 0) & (ln_ends_a[:, 5] > 0)
        lvb = (ln_ends_b[:, 4] > 0) & (ln_ends_b[:, 5] > 0)
        lres = hamming.match_gated(ln_desc_a[None], ln_desc_b[None],
                                   lva[None], lvb[None], None,
                                   cfg.matching.max_hamming_l,
                                   cfg.matching.min_ratio_12_l, mutual=True)
        lidx = torch.clamp(lres.idx[0], min=0).long()
        sP_a = cam.back_project(ln_ends_a[:, 0:2],
                                torch.where(lva, ln_ends_a[:, 4], 1.0))
        eP_a = cam.back_project(ln_ends_a[:, 2:4],
                                torch.where(lva, ln_ends_a[:, 5], 1.0))
        ln_terms = pose_gn.LineTerms(sP_a[None], eP_a[None],
                                     ln_le_b[lidx][None],
                                     (lres.valid[0] & lva)[None])
        n_ln = torch.sum(lres.valid)
    T0 = torch.eye(4, dtype=torch.float32, device=obs_uv_a.device)[None]
    res = pose_gn.optimize_pose(T0, cam, terms, ln_terms, cfg)
    return (pose_gn.PoseResult(*(x[0] for x in res)),
            torch.sum(mres.valid) + n_ln)


def covisibility_counts(obs_pt_lm: torch.Tensor, slot,
                        max_points: int) -> torch.Tensor:
    """(F,) shared-landmark counts between KF ``slot`` and every KF: a
    membership vector over landmark slots (an order-free scatter-max; a
    landmark seen twice in the row counts once) and one clamped gather
    (K7) over the (F, K) observation table."""
    lm_slot = _row(obs_pt_lm, slot)
    member = torch.zeros((max_points,), dtype=torch.float32,
                         device=obs_pt_lm.device).scatter_reduce(
        0, torch.clamp(lm_slot, 0, max_points - 1).long(),
        (lm_slot >= 0).to(torch.float32), "amax")
    F = obs_pt_lm.shape[0]
    hits = torch.where(obs_pt_lm >= 0,
                       take(member.expand(F, max_points), obs_pt_lm), 0.0)
    return torch.sum(hits, dim=-1)


def apply_graph_correction(state, new_poses: torch.Tensor):
    """Re-anchor landmarks to the corrected KF poses: each landmark moves
    with the pose delta of its first observing KF
    (loopClosureFuseLandmarks re-anchoring half)."""
    old = state.kf_pose
    delta = new_poses @ lie.inverse_se3(old)                  # (F, 4, 4)

    def move(pos, first_kf):
        d = delta[torch.clamp(first_kf, min=0).long()]
        moved = (d[:, :3, :3] @ pos[:, :, None])[:, :, 0] + d[:, :3, 3]
        return torch.where((first_kf >= 0)[:, None], moved, pos)

    def rot(dirs, first_kf):
        d = delta[torch.clamp(first_kf, min=0).long()][:, :3, :3]
        moved = (d @ dirs[:, :, None])[:, :, 0]
        return torch.where((first_kf >= 0)[:, None], moved, dirs)

    return state._replace(
        kf_pose=torch.where(state.kf_valid[:, None, None], new_poses,
                            state.kf_pose),
        pt_pos=move(state.pt_pos, state.pt_first_kf),
        pt_dir=rot(state.pt_dir, state.pt_first_kf),
        ln_spos=move(state.ln_spos, state.ln_first_kf),
        ln_epos=move(state.ln_epos, state.ln_first_kf),
        ln_dir=rot(state.ln_dir, state.ln_first_kf))


def probe_core(voc_p, voc_l, cfg: SlamConfig, has_lines: bool, state,
               bows_p, bows_l, slot, ln_valid=None):
    """insertKFBowVectorP/L + the database query + covisibility counts for
    KF ``slot`` (host int or 0-d device tensor). The BoW rows are written
    in place, and the slot's line mask into ``ln_valid`` (F, L) where it
    is given (``BowDatabase.ln_valid``). Returns (bows_p, bows_l, scores
    (F,), covis (F,), pose)."""
    idx = torch.as_tensor(slot, device=bows_p.device).reshape(1).long()
    vp = vocabulary.bow_vector(voc_p, _row(state.kf_pt_desc, idx),
                               _row(state.obs_pt_disp, idx) > 0)
    bows_p.index_copy_(0, idx, vp[None])
    s = vocabulary.l1_score(bows_p, vp[None, :])
    if has_lines:
        valid_l = _row(state.obs_ln_lm, idx) >= 0
        vl = vocabulary.bow_vector(voc_l, _row(state.kf_ln_desc, idx),
                                   valid_l)
        bows_l.index_copy_(0, idx, vl[None])
        if ln_valid is not None:
            ln_valid.index_copy_(0, idx, valid_l[None])
        s = 0.5 * (s + vocabulary.l1_score(bows_l, vl[None, :]))
    covis = covisibility_counts(state.obs_pt_lm, idx,
                                cfg.mapping.max_points)
    return bows_p, bows_l, s, covis, _row(state.kf_pose, idx)


def _post_loop_update(state, new_poses, slot_a, slot_b, cam: StereoCamera,
                      cfg: SlamConfig):
    """Apply the pose-graph correction, fuse the loop pair's duplicate
    landmarks and re-converge the local window with one LBA pass."""
    from plslam_tpu_torch.backend.map import fuse_loop_landmarks
    from plslam_tpu_torch.backend.map_handler import run_window_lba
    state = apply_graph_correction(state, new_poses)
    state, n_fused = fuse_loop_landmarks(state, slot_a, slot_b, cfg)
    state, _, _, _ = run_window_lba(state, cam, cfg)
    return state, n_fused


def floored_uncertainty(cov, n_inl: int, err: float,
                        cfg: SlamConfig) -> float:
    """Worst-axis variance of a verification solve with the residual
    sigma floored at the detector pixel noise (the lc_unc gate)."""
    n_res = max(2.0 * float(n_inl), 8.0)
    sigma2 = float(err) ** 2 * n_res / (n_res - 6.0)  # pose_gn's estimate
    floor2 = cfg.mapping.lba_min_sigma ** 2
    scale = max(sigma2, floor2) / max(sigma2, 1e-12)
    return float(np.max(np.diagonal(np.asarray(cov)))) * scale


class LoopEvent(NamedTuple):
    kf_from: int
    kf_to: int
    n_inliers: int
    residual: float
    correction_t: float
    correction_r_deg: float
    graph_cost0: float
    graph_cost1: float


class LoopCloser:
    """Per-KF place recognition, verification and correction. The map
    handler it is given (``FusedPLSLAM``) exposes ``_lock`` and ``state``."""

    def __init__(self, cfg: SlamConfig, cam: StereoCamera, device=None):
        self.cfg = cfg
        self.cam = cam
        voc_p = vocabulary.default_vocabulary("orb", cfg.loop.vocab_k,
                                              cfg.loop.vocab_l, device)
        voc_l = (vocabulary.default_vocabulary("lbd", cfg.loop.vocab_k,
                                               cfg.loop.vocab_l, device)
                 if cfg.lines.has_lines else None)
        self.db = BowDatabase(cfg, voc_p, voc_l)
        # sharded place recognition: candidate retrieval on a 'kf' mesh
        self._dist = None
        if cfg.loop.distributed:
            from plslam_tpu_torch.parallel.dist_vocab import DistRetrieval
            self._dist = DistRetrieval(
                cfg, voc_p.n_leaves,
                voc_l.n_leaves if voc_l is not None else None,
                device=voc_p.idf.device)
        self.voter = ConsistencyVoter(cfg.loop.consistency_window)
        self.odo_edges = []          # (i, j, T_rel np, w)
        self.covis_edges = []        # (i, j, T_rel np, w, n_shared)
        self.loop_edges = []
        self.events = []
        self.n_loops_closed = 0
        self.n_edges_dropped = 0     # covis edges lost to the E cap
        # funnel telemetry: why candidates did or didn't become closures
        self.n_candidates = 0        # candidates passing lc_mat
        self.n_votes_fired = 0       # consistency streaks completing
        self.n_rej_geom = 0          # verification solve failed/inl/res
        self.n_rej_unc = 0           # lc_unc covariance gate
        self.n_rej_corr = 0          # lc_trs/lc_rot correction magnitude
        self.n_frozen_events = 0     # graph solves with disconnected KFs
        self.probes_since_close = 10 ** 9
        self._last_costs = (0.0, 0.0)

    @property
    def closure_imminent(self) -> bool:
        """True when a candidate streak is one vote from firing or a
        closure fired in the last 8 probes: the mapping worker then reverts
        from pipelined to strict ordering, so corrections land before
        further insertions."""
        near = any(c >= self.voter.window - 1
                   for c in self.voter._streaks.values())
        return near or self.probes_since_close < 8

    def remap_slots(self, exact_map, n_valid: int, old_poses=None) -> None:
        """Rewrite the slot-valued host state after a KF-slot compaction
        (``backend.map.compact_keyframes``): ``exact_map[old]`` is the new
        slot or -1 for a dropped one. Odometry edges across dropped KFs
        are composed into one; covisibility and loop edges with a dropped
        end are re-expressed through the nearest surviving earlier KF
        when ``old_poses`` (the pre-compaction poses) is given, and
        dropped otherwise. The BoW rows are permuted on the device (tail
        zeroed; the line masks the same) and the consistency streaks
        reset."""
        exact = np.asarray(exact_map)
        F = exact.shape[0]
        # nearest surviving old slot at or before s (for re-expression)
        floor_old = np.full((F,), -1, np.int64)
        last = -1
        for s in range(F):
            if exact[s] >= 0:
                last = s
            floor_old[s] = last

        def move_end(s):
            """old slot -> (new slot, T_corr = T_s'^-1 T_s) through the
            nearest surviving earlier KF s' (identity if s survives)."""
            if exact[s] >= 0:
                return int(exact[s]), np.eye(4, dtype=np.float32)
            sp = int(floor_old[s])
            if sp < 0 or old_poses is None:
                return -1, None
            T_corr = (np.linalg.inv(old_poses[sp])
                      @ old_poses[s]).astype(np.float32)
            return int(exact[sp]), T_corr

        odo = sorted(self.odo_edges, key=lambda e: e[0])
        new_odo = []
        chain = None            # (old start slot, old last slot, composed T)
        for (i, j, T, w) in odo:
            if chain is None or chain[1] != i:
                chain = (i, i, np.eye(4, dtype=np.float32))  # a new chain
            start, _, T_acc = chain
            T_acc = (T_acc @ T).astype(np.float32)
            if exact[j] >= 0:
                if exact[start] >= 0:
                    new_odo.append((int(exact[start]), int(exact[j]),
                                    T_acc, w))
                chain = (j, j, np.eye(4, dtype=np.float32))
            else:
                chain = (start, j, T_acc)    # j dropped: keep composing
        self.odo_edges = new_odo

        def remap_pair(i, j, T):
            """Edge T = T_i^-1 T_j re-expressed between survivors:
            T' = T_corr_i @ T @ T_corr_j^-1."""
            i2, Ci = move_end(i)
            j2, Cj = move_end(j)
            if i2 < 0 or j2 < 0 or i2 == j2:
                return None
            T2 = T
            if Ci is not None and not np.array_equal(Ci, np.eye(4)):
                T2 = Ci @ T2
            if Cj is not None and not np.array_equal(Cj, np.eye(4)):
                T2 = T2 @ np.linalg.inv(Cj)
            return (min(i2, j2), max(i2, j2),
                    (T2 if i2 < j2 else np.linalg.inv(T2)
                     ).astype(np.float32))

        new_covis = []
        for (i, j, T, w, ns) in self.covis_edges:
            r = remap_pair(i, j, T)
            if r is not None:
                new_covis.append((r[0], r[1], r[2], w, ns))
        self.covis_edges = new_covis
        new_loops = []
        for (i, j, T, w) in self.loop_edges:
            r = remap_pair(i, j, T)
            if r is not None:
                new_loops.append((r[0], r[1], r[2], w))
        self.loop_edges = new_loops

        # new BoW row n reads old row perm[n]; the tail is zeroed
        perm = np.zeros((F,), np.int64)
        for old, new in enumerate(exact):
            if new >= 0:
                perm[new] = old
        dev = self.db.bows_p.device
        perm_d = torch.from_numpy(perm).to(dev)
        live = (torch.arange(F, device=dev) < n_valid)[:, None]

        def permute(b):
            if b is None:
                return None
            return torch.where(live, b.index_select(0, perm_d), 0.0)

        self.db.bows_p = permute(self.db.bows_p)
        self.db.bows_l = permute(self.db.bows_l)
        if self.db.ln_valid is not None:
            self.db.ln_valid = (self.db.ln_valid.index_select(0, perm_d)
                                & live)
        if self._dist is not None:
            self._dist.remap_slots(perm_d, n_valid)
        self.voter._streaks.clear()

    # -- main entry ------------------------------------------------------------
    def on_keyframe(self, map_handler, slot: int) -> Optional[np.ndarray]:
        """The per-KF place-recognition step (BoW insert, query,
        covisibility counts) and its host logic; returns the corrected
        pose of ``slot`` when a loop closed with a graph solve."""
        with map_handler._lock:
            state = map_handler.state
            _, _, s_d, covis_d, _ = probe_core(
                self.db.voc_p, self.db.voc_l, self.cfg,
                self.db.bows_l is not None, state, self.db.bows_p,
                self.db.bows_l, slot, self.db.ln_valid)
            scores, covis = s_d.cpu().numpy(), covis_d.cpu().numpy()
            n_kfs, kf_poses = int(state.n_kfs), state.kf_pose.cpu().numpy()
        out = self._handle_probe_result(map_handler, slot, scores, covis,
                                        n_kfs, kf_poses)
        return out[slot] if out is not None else None

    def on_probe_batch(self, map_handler, slots, scores_d, covis_d, poses_d
                       ) -> Optional[np.ndarray]:
        """One chunk-backend dispatch's probe rows (on_probe_batches)."""
        return self.on_probe_batches(map_handler,
                                     [(slots, scores_d, covis_d, poses_d)])

    def on_probe_batches(self, map_handler, batches) -> Optional[np.ndarray]:
        """The stacked probe rows of one or more chunk-backend dispatches
        ``(slots, scores (kmax, F), covis (kmax, F), poses)``, fetched with
        the map's KF count and poses in one transfer, then each keyframe's
        host logic in slot order. Returns the last correction (the full
        (F, 4, 4) poses) if a loop closed with a graph solve."""
        with map_handler._lock:
            state = map_handler.state
            flat = host_copies(*[t for _, s, c, _ in batches for t in (s, c)],
                               state.n_kfs, state.kf_pose)
        n_kfs, kf_poses = int(flat[-2]), flat[-1]
        corrected = None
        for b, (slots, *_) in enumerate(batches):
            scores, covis = flat[2 * b], flat[2 * b + 1]
            for j, slot in enumerate(slots):
                if corrected is not None:
                    # a closure earlier in this flush moved every KF: the
                    # fetched snapshot is stale, use the corrected poses
                    kf_poses = corrected
                out = self._handle_probe_result(
                    map_handler, slot, scores[j], covis[j], n_kfs, kf_poses)
                if out is not None:
                    corrected = out
        return corrected

    def _handle_probe_result(self, map_handler, slot: int, scores, covis,
                             n_kfs: int, kf_poses) -> Optional[np.ndarray]:
        """Returns the FULL corrected (F, 4, 4) pose array if this KF
        fired a verified loop closure with a graph solve, else None. Every
        graph edge is measured from the same pose snapshot ``kf_poses``."""
        cfg = self.cfg
        self.probes_since_close += 1
        pose = kf_poses[slot]
        # odometry edge from the previous KF, same snapshot
        if slot >= 1:
            T_rel = np.linalg.inv(kf_poses[slot - 1]) @ pose
            self.odo_edges.append((slot - 1, slot, T_rel.astype(np.float32),
                                   1.0))
        # covisibility edges to non-adjacent earlier KFs sharing enough
        # landmarks (essential vs covisibility graph by graph_type)
        covis_th = (cfg.loop.covis_min_shared
                    if cfg.loop.graph_type == "essential"
                    else cfg.loop.covis_min_shared_cov)
        for f in np.nonzero(covis >= covis_th)[0]:
            if f < slot - 1:
                T_rel = np.linalg.inv(kf_poses[f]) @ pose
                self.covis_edges.append(
                    (int(f), slot, T_rel.astype(np.float32),
                     cfg.loop.covis_edge_weight, int(covis[f])))
        if self._dist is not None:
            # mirror the keyframe's BoW rows (the probe wrote them to
            # db.bows_*) into the sharded database
            self._dist.insert(slot, *self._bow_rows(slot))
        if slot < cfg.loop.min_kf_separation:
            return None
        if self.probes_since_close < cfg.loop.lc_cooldown:
            return None             # post-closure lockout (lc_cooldown)
        if self._dist is not None:
            # the sharded query: global top-k and covisible baseline, the
            # semantics of select_candidates
            ts, ti, base = host_copies(*self._dist.query(
                slot, n_kfs, *self._bow_rows(slot)))
            baseline = max(float(base), 1e-3)
            candidates = [
                LoopCandidate(int(i), float(s) / baseline)
                for s, i in zip(ts, ti)
                if s > 0 and float(s) / baseline >= cfg.loop.lc_mat]
        else:
            scores = scores.copy()          # db.query masking, host-side
            scores[slot:] = 0.0
            scores[n_kfs:] = 0.0
            candidates, baseline = select_candidates(scores, slot, cfg)
        self.n_candidates += len(candidates)
        fired = self.voter.vote(candidates)
        if fired is None:
            return None
        self.n_votes_fired += 1
        return self._close_loop(map_handler, fired, slot, kf_poses)

    def _bow_rows(self, slot: int):
        """The database's BoW row(s) of ``slot`` (None for lines where the
        database has none)."""
        return (self.db.bows_p[slot],
                self.db.bows_l[slot] if self.db.bows_l is not None else None)

    # -- verification + optimization -------------------------------------------
    def _close_loop(self, map_handler, slot_a: int, slot_b: int, kf_poses
                    ) -> Optional[np.ndarray]:
        from plslam_tpu_torch.backend.map import fuse_loop_landmarks
        cfg = self.cfg
        with map_handler._lock:
            st = map_handler.state
            a = lambda x: _row(x, slot_a)
            b = lambda x: _row(x, slot_b)
            res, _ = verify_loop_geometry(
                a(st.kf_pt_desc), a(st.obs_pt_uv), a(st.obs_pt_disp),
                b(st.kf_pt_desc), b(st.obs_pt_uv), a(st.kf_ln_desc),
                a(st.obs_ln_ends), b(st.kf_ln_desc), b(st.obs_ln_ends),
                b(st.obs_ln_le), self.cam, cfg)
            T_ab, n_inl, err, good, cov = (x.cpu().numpy() for x in (
                res.T, res.n_inliers, res.err, res.good, res.cov))
        pose_a = kf_poses[slot_a]
        pose_b = kf_poses[slot_b]
        # gates (isLoopClosure parity: inliers, residual, uncertainty with
        # the residual sigma floored at the pixel noise, correction size)
        n_inl = int(n_inl)
        err = float(err)
        if not bool(good) or n_inl < cfg.loop.lc_inl or err > cfg.loop.lc_res:
            self.n_rej_geom += 1
            return None
        unc = floored_uncertainty(cov, n_inl, err, cfg)
        if not np.isfinite(unc) or unc > cfg.loop.lc_unc:
            self.n_rej_unc += 1
            return None
        # measured relative pose a->b in pose-graph convention:
        # T_meas = T_a^-1 T_b with T_ab = T_cam_b<-cam_a => T_meas = T_ab^-1
        T_meas = np.linalg.inv(T_ab).astype(np.float32)
        T_odo = np.linalg.inv(pose_a) @ pose_b
        corr = np.linalg.inv(T_meas) @ T_odo
        t_mag = float(np.linalg.norm(corr[:3, 3]))
        r_mag = float(np.degrees(np.arccos(
            np.clip((np.trace(corr[:3, :3]) - 1) / 2, -1, 1))))
        if t_mag > cfg.loop.lc_trs or r_mag > cfg.loop.lc_rot:
            self.n_rej_corr += 1
            return None

        self.loop_edges.append((slot_a, slot_b, T_meas, 2.0))
        if (t_mag < cfg.loop.lc_min_correction_t
                and r_mag < cfg.loop.lc_min_correction_r):
            # negligible correction: the loop edge is recorded (the next
            # significant solve consumes it) and duplicates still fuse,
            # but the graph solve and the correction are skipped
            with map_handler._lock:
                state, _ = fuse_loop_landmarks(map_handler.state, slot_a,
                                               slot_b, cfg)
                map_handler.state = state
            self.n_loops_closed += 1
            self.probes_since_close = 0
            self._last_costs = (0.0, 0.0)
            self.events.append(LoopEvent(
                slot_a, slot_b, n_inl, err, t_mag, r_mag, 0.0, 0.0))
            return None
        new_full = self._optimize_graph(map_handler, kf_poses)
        if new_full is not None:
            pm = float(np.abs(new_full[:, :3, 3]).max())
            if pm > 1e3:
                bad = np.nonzero(
                    np.abs(new_full[:, :3, 3]).max(-1) > 1e4)[0]
                print(f"[loop_closer] WARNING: graph solve returned "
                      f"|t|max={pm:.3g} at slots {bad.tolist()[:8]} "
                      f"(loop {slot_a}->{slot_b})")
        corrected = None
        if os.environ.get("PLSLAM_LC_DEBUG") and new_full is not None:
            return self._close_staged(map_handler, new_full, slot_a, slot_b,
                                      n_inl, err, t_mag, r_mag)
        with map_handler._lock:
            if new_full is not None:
                state, _ = _post_loop_update(
                    map_handler.state,
                    torch.from_numpy(new_full).to(map_handler.state.kf_pose
                                                  .device),
                    slot_a, slot_b, self.cam, cfg)
                corrected = state.kf_pose.cpu().numpy()
                pm = float(np.abs(corrected[:, :3, 3]).max())
                if pm > 1e3:
                    print(f"[loop_closer] WARNING: post-loop-update KF pose "
                          f"|t|max={pm:.3g} — correction corrupted the map")
            else:  # graph solve failed: still fuse duplicates
                state, _ = fuse_loop_landmarks(map_handler.state, slot_a,
                                               slot_b, cfg)
            map_handler.state = state
        self.n_loops_closed += 1
        self.probes_since_close = 0
        self.events.append(LoopEvent(slot_a, slot_b, n_inl, err, t_mag, r_mag,
                                     self._last_costs[0],
                                     self._last_costs[1]))
        return corrected

    def _close_staged(self, map_handler, new_full, slot_a, slot_b, n_inl,
                      err, t_mag, r_mag) -> np.ndarray:
        """``_close_loop``'s ``PLSLAM_LC_DEBUG`` branch: the correction,
        the landmark fusion and the window LBA one at a time, with each
        stage's largest |t| of a keyframe (and of a valid landmark after
        the fusion) read back; printed where one passes 1e4."""
        from plslam_tpu_torch.backend.map import fuse_loop_landmarks
        from plslam_tpu_torch.backend.map_handler import run_window_lba
        cfg = self.cfg
        t_max = lambda st: float(st.kf_pose[:, :3, 3].abs().max())
        with map_handler._lock:
            st = apply_graph_correction(
                map_handler.state, torch.from_numpy(new_full).to(
                    map_handler.state.kf_pose.device))
            m1 = t_max(st)
            st, _ = fuse_loop_landmarks(st, slot_a, slot_b, cfg)
            m2 = t_max(st)
            mp = float(torch.where(st.pt_valid[:, None], st.pt_pos,
                                   0.0).abs().max())
            st, _, _, _ = run_window_lba(st, self.cam, cfg)
            m3 = t_max(st)
            if max(m1, m2, m3) > 1e4 or mp > 1e4:
                print(f"[lc-debug] loop {slot_a}->{slot_b} stage "
                      f"|t|max: corr {m1:.3g} fuse {m2:.3g} "
                      f"(pt {mp:.3g}) lba {m3:.3g}")
            map_handler.state = st
            corrected = st.kf_pose.cpu().numpy()
        self.n_loops_closed += 1
        self.probes_since_close = 0
        self.events.append(LoopEvent(slot_a, slot_b, n_inl, err, t_mag, r_mag,
                                     self._last_costs[0],
                                     self._last_costs[1]))
        return corrected

    def _optimize_graph(self, map_handler, kf_poses_host
                        ) -> Optional[np.ndarray]:
        """Optimize the pose graph and return the corrected FULL (F,4,4)
        pose array (host), without applying it to the map state. The graph
        is cropped to the smallest power-of-two slot bucket (>= 64)
        covering the used KFs, with at most 4 edges per slot."""
        cfg = self.cfg
        F = cfg.mapping.max_kfs
        with map_handler._lock:
            state = map_handler.state
            # authoritative KF count from the device state: a later chunk's
            # insertions may already be in the map ahead of this settle
            n_used = int(state.n_kfs)
        Fb = 64
        while Fb < min(n_used, F):
            Fb *= 2
        Fb = min(Fb, F)
        E = 4 * Fb
        with map_handler._lock:
            state = map_handler.state
            poses = state.kf_pose[:Fb]
            pose_valid = state.kf_valid[:Fb]

        # odometry + loop edges are load-bearing; covis edges last, the
        # weakest (fewest shared landmarks) first to be truncated
        covis = sorted(self.covis_edges, key=lambda e: -e[4])
        edges = self.odo_edges + self.loop_edges + [e[:4] for e in covis]
        dropped = max(0, len(edges) - E)
        if dropped > self.n_edges_dropped:
            print(f"[loop_closer] pose-graph edge cap E={E}: dropping "
                  f"{dropped} weakest covisibility edges")
        self.n_edges_dropped = max(self.n_edges_dropped, dropped)
        ei = np.full((E,), 0, np.int32)
        ej = np.full((E,), 0, np.int32)
        eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
        ew = np.zeros((E,), np.float32)
        for n, (i, j, T, w) in enumerate(edges[:E]):
            ei[n], ej[n], eT[n], ew[n] = i, j, T, w

        dev = poses.device
        t = lambda a: torch.from_numpy(a).to(dev)
        g = PoseGraph(poses=poses, pose_valid=pose_valid, edge_i=t(ei),
                      edge_j=t(ej), edge_T=t(eT), edge_w=t(ew))
        # gauge-connectivity telemetry: the solvers freeze disconnected KFs
        frz = frozen_mask(g)
        n_frz = int(frz.sum())
        if n_frz:
            self.n_frozen_events += 1
            print(f"[loop_closer] pose graph: {n_frz} keyframe(s) "
                  "disconnected from the gauge component — frozen at "
                  "current estimates (edges lost at compaction?)")
        # past the dense wall the matrix-free PCG solver takes over
        solver = cfg.loop.pose_graph_solver
        if solver == "auto":
            solver = ("dense" if Fb <= cfg.loop.pose_graph_dense_max
                      else "pcg")
        if solver == "pcg":
            new_d, c0, c1 = optimize_pose_graph_pcg(
                g, iters=cfg.loop.pose_graph_iters,
                cg_iters=cfg.loop.pose_graph_cg_iters)
        else:
            new_d, c0, c1 = optimize_pose_graph(
                g, iters=cfg.loop.pose_graph_iters)
        new_np, c0, c1, valid_np, old_np = (
            new_d.cpu().numpy(), float(c0), float(c1),
            pose_valid.cpu().numpy(), poses.cpu().numpy())
        self._last_costs = (c0, c1)
        new_np = np.array(new_np)       # writable host copy
        if not np.all(np.isfinite(new_np)):
            return None
        # KFs inserted after the probe snapshot have no graph edges yet:
        # they are rigidly attached by odometry, so propagate the last
        # connected KF's correction
        n_edges = min(len(edges), E)
        if n_edges:
            last = int(max(ei[:n_edges].max(), ej[:n_edges].max()))
            delta = new_np[last] @ np.linalg.inv(old_np[last])
            for s in range(last + 1, len(new_np)):
                if valid_np[s]:
                    new_np[s] = delta @ old_np[s]
        # un-crop against the CURRENT poses (later chunks may have inserted
        # KFs beyond this settle already)
        with map_handler._lock:
            full = np.array(map_handler.state.kf_pose.cpu().numpy(),
                            np.float32)
        full[:Fb] = new_np
        return full
