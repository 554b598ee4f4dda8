"""Chunked stereo VO: a chunk of B frames per call.

Port of ``plslam_tpu/tracking/batch_vo.py``. The B stereo pairs of a
chunk are feature-extracted as one batch. In batched mode
(``tracking.batched_chunks=True``, the default) all B consecutive-pair
matches and robust GN solves then run batched, for ``chunk_passes``
passes; non-final passes run the shortened "lite" GN. In scan mode
(``batched_chunks=False``, the reference's ``lax.scan``) the frames are
tracked one after another, each from the pose the previous one left as its
prior: one full GN at B = 1 a frame. With ``lines.has_lines`` (the
default, flagship configuration) line segments are extracted, matched and
solved jointly with the points; without ``points.has_points`` (the
lines-only configuration) the point set has capacity 0 and only lines are
matched. ``keep_feats`` keeps the chunk's feature stacks, descriptors
bit-packed (``_pack_feats``), for the host-KF SLAM driver to slice its
keyframes from.

Every tensor op is enqueued on the current CUDA stream; ``submit_chunk``
does not wait for the device, ``drain`` fetches the per-frame poses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from plslam_tpu_torch import resolve_device
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.frontend.stereo_frame import (
    _frame, extract_one, extract_stereo_frame)
from plslam_tpu_torch.ops import hamming
from plslam_tpu_torch.tracking import pose_gn
from plslam_tpu_torch.tracking.frame_handler import (build_line_terms,
                                                     build_point_terms,
                                                     match_f2f_lines,
                                                     match_f2f_points)


class ChunkOutput(NamedTuple):
    DT: torch.Tensor          # (B, 4, 4) relative pose prev->cur per frame
    cov: torch.Tensor         # (B, 6, 6)
    n_inliers: torch.Tensor   # (B,)
    err: torch.Tensor         # (B,)
    good: torch.Tensor        # (B,)
    last_pts: PointObservations             # final frame's features (carry)
    last_lns: Optional[LineObservations]
    DT_next: torch.Tensor = None  # (4, 4) next chunk's constant-velocity prior
    n_lines: Optional[torch.Tensor] = None  # (B,) valid stereo lines per frame
    n_line_inliers: torch.Tensor = None     # (B,) line terms among n_inliers
    all_pts: Optional[PointObservations] = None   # keep_feats: (B, ...)
    all_lns: Optional[LineObservations] = None    # stacks, packed desc


def _to_f32(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 images -> [0, 1] f32 (as the reference, times f32(1/255))."""
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) * (1.0 / 255.0)
    return imgs.to(torch.float32)


def _shift(head, tail):
    """Previous-frame features of each pair: the carry, then all frames
    of the chunk but the last."""
    return type(tail)(*(torch.cat([h[None], t[:-1]])
                        for h, t in zip(head, tail)))


def vo_chunk(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
             prev_pts: PointObservations,
             prev_lns: Optional[LineObservations],
             T_prior0: torch.Tensor, cam: StereoCamera,
             cfg: SlamConfig, keep_feats: bool = False) -> ChunkOutput:
    """(B, H, W) stereo chunk (uint8 or f32) -> per-frame results.

    ``prev_pts`` / ``prev_lns`` are the previous frame's features (no
    batch axis; ``prev_lns`` None in the points-only configuration),
    ``T_prior0`` (4, 4) the chunk-level constant-velocity prior. With
    ``keep_feats`` the output carries the chunk's feature stacks
    (``all_pts``, ``all_lns``) with bit-packed descriptors."""
    pts, lns = extract_stereo_frame(_to_f32(imgs_l), _to_f32(imgs_r), cam,
                                    cfg)
    track = (_chunk_tracking_batched if cfg.tracking.batched_chunks
             else _chunk_tracking_scan)
    out = track(pts, lns, prev_pts, prev_lns, T_prior0, cam, cfg)
    if keep_feats:
        all_pts, all_lns = _pack_feats(pts, lns)
        out = out._replace(all_pts=all_pts, all_lns=all_lns)
    return out


def _pack_feats(pts: PointObservations, lns: Optional[LineObservations]):
    """The chunk's feature stacks with their (B, N, 256) descriptor bits
    packed into (B, N, 8) int32 words (``hamming.pack_bits``); the SLAM
    driver unpacks a keyframe's at slice time."""
    all_pts = pts._replace(desc=hamming.pack_bits(pts.desc))
    all_lns = (lns._replace(desc=hamming.pack_bits(lns.desc))
               if lns is not None else None)
    return all_pts, all_lns


def _solve_pairs(prev_p: PointObservations, prev_l: Optional[LineObservations],
                 pts: PointObservations, lns: Optional[LineObservations],
                 T_pri: torch.Tensor, cam: StereoCamera,
                 cfg: SlamConfig) -> pose_gn.PoseResult:
    """Match and solve the pairs (previous, current) along the leading
    axis from their priors (B, 4, 4): D on the points (none at capacity 0,
    the lines-only configuration) and on the lines, then one launch of
    K13."""
    if pts.uv.shape[1] > 0:
        mres = match_f2f_points(prev_p, pts, T_pri, cam, cfg)
        terms = build_point_terms(prev_p, pts, mres)
    else:
        terms = pose_gn.no_point_terms(T_pri.shape[0], T_pri.device)
    ln_terms = None
    if prev_l is not None:
        ml = match_f2f_lines(prev_l, lns, T_pri, cam, cfg)
        ln_terms = build_line_terms(prev_l, lns, ml)
    return pose_gn.optimize_pose(T_pri, cam, terms, ln_terms, cfg)


def _chunk_output(res: pose_gn.PoseResult, pts: PointObservations,
                  lns: Optional[LineObservations],
                  DT_next: torch.Tensor) -> ChunkOutput:
    return ChunkOutput(res.T, res.cov, res.n_inliers, res.err, res.good,
                       _frame(pts, -1), _frame(lns, -1), DT_next=DT_next,
                       n_lines=lns.valid.sum(-1) if lns is not None else None,
                       n_line_inliers=res.inlier_ln.sum(-1))


def _chunk_tracking_scan(pts: PointObservations,
                         lns: Optional[LineObservations],
                         prev_pts: PointObservations,
                         prev_lns: Optional[LineObservations],
                         T_prior0: torch.Tensor, cam: StereoCamera,
                         cfg: SlamConfig) -> ChunkOutput:
    """The B pairs of an extracted chunk one after another (the
    reference's ``lax.scan``): each frame matched against the one before
    it (the carry for the first) from the carried prior, one full GN, and
    the prior for the next frame ``where(good, T, prior)``, on the device."""
    one = lambda f, i: None if f is None else type(f)(*(x[i:i + 1]
                                                        for x in f))
    head = lambda f: None if f is None else type(f)(*(x[None] for x in f))
    prev_p, prev_l, T_pri = head(prev_pts), head(prev_lns), T_prior0[None]
    steps = []
    for i in range(pts.uv.shape[0]):
        pts_i, lns_i = one(pts, i), one(lns, i)
        res = _solve_pairs(prev_p, prev_l, pts_i, lns_i, T_pri, cam, cfg)
        steps.append(res)
        T_pri = torch.where(res.good[:, None, None], res.T, T_pri)
        prev_p, prev_l = pts_i, lns_i
    res = pose_gn.PoseResult(*(torch.cat(x) for x in zip(*steps)))
    return _chunk_output(res, pts, lns, T_pri[0])


def _chunk_tracking_batched(pts: PointObservations,
                            lns: Optional[LineObservations],
                            prev_pts: PointObservations,
                            prev_lns: Optional[LineObservations],
                            T_prior0: torch.Tensor, cam: StereoCamera,
                            cfg: SlamConfig) -> ChunkOutput:
    """All B consecutive-pair solves of an extracted chunk (``pts``/``lns``
    with a leading B axis), ``chunk_passes`` passes."""
    B = pts.uv.shape[0]
    prev_p = _shift(prev_pts, pts)
    prev_l = _shift(prev_lns, lns) if lns is not None else None

    def solve(T_pri, c):
        return _solve_pairs(prev_p, prev_l, pts, lns, T_pri, cam, c)

    # non-final passes only produce the next pass's prior: shortened GN
    lp = cfg.tracking.lite_pass_iters
    cfg_lite = (cfg.with_updates(
        {"tracking": {"max_iters": lp,
                      "max_iters_ref": cfg.tracking.lite_pass_iters_ref}})
        if lp > 0 and cfg.tracking.chunk_passes > 1 else cfg)

    n_passes = max(cfg.tracking.chunk_passes, 1)
    T_pri = T_prior0.expand(B, 4, 4)
    res = solve(T_pri, cfg_lite if n_passes > 1 else cfg)
    for k in range(n_passes - 1):
        # re-solve around each pair's own estimate; failed pairs retry
        # from their left neighbour's estimate, else the chunk prior
        nb_T = torch.cat([T_pri[:1], res.T[:-1]])
        nb_good = torch.cat([torch.zeros_like(res.good[:1]), res.good[:-1]])
        T_pri = torch.where(res.good[:, None, None], res.T,
                            torch.where(nb_good[:, None, None], nb_T, T_pri))
        res_new = solve(T_pri, cfg if k == n_passes - 2 else cfg_lite)
        # a pair that solved earlier keeps it over a later failed re-solve
        keep_new = res_new.good | ~res.good
        res = pose_gn.PoseResult(*(
            torch.where(keep_new.reshape((B,) + (1,) * (a.ndim - 1)), a, b)
            for a, b in zip(res_new, res)))

    return _chunk_output(res, pts, lns,
                         torch.where(res.good[-1], res.T[-1], T_pri[-1]))


class BatchedStereoVO:
    """Host driver for chunked VO: feed chunks, get per-frame poses.

    Runs on ``device`` (default: the CUDA device; raises without one)."""

    def __init__(self, cfg: SlamConfig, cam: Optional[StereoCamera] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam if cam is not None else StereoCamera.from_config(
            cfg.camera)
        self.prev_pts: Optional[PointObservations] = None
        self.prev_lns: Optional[LineObservations] = None
        self.T_wc = np.eye(4, dtype=np.float32)
        self.DT_prev = torch.eye(4, dtype=torch.float32, device=self.device)
        self.trajectory = [self.T_wc.copy()]
        self._pending = []
        # host copy of the last integrated step: the tracking-failure
        # fallback during drain (DT_prev is a device tensor)
        self._last_step_host = np.eye(4, dtype=np.float32)

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def initialize(self, img_l, img_r) -> None:
        self.prev_pts, self.prev_lns = extract_one(
            self._put(img_l), self._put(img_r), self.cam, self.cfg)

    def process_chunk(self, imgs_l, imgs_r) -> ChunkOutput:
        """(B, H, W) arrays -> per-frame results; updates the trajectory."""
        out = self.submit_chunk(imgs_l, imgs_r)
        self._integrate(out)
        return out

    def submit_chunk(self, imgs_l, imgs_r, keep_feats: bool = False
                     ) -> ChunkOutput:
        """Enqueue one chunk; the carry stays on the device. With
        ``keep_feats`` the output keeps the chunk's packed feature stacks."""
        if self.prev_pts is None:
            raise RuntimeError("call initialize() first")
        out = vo_chunk(self._put(imgs_l), self._put(imgs_r), self.prev_pts,
                       self.prev_lns, self.DT_prev, self.cam, self.cfg,
                       keep_feats=keep_feats)
        self.prev_pts, self.prev_lns = out.last_pts, out.last_lns
        self.DT_prev = out.DT_next
        self._pending.append(out)
        return out

    def drain(self) -> None:
        """Fetch all pending chunk results and extend the trajectory."""
        for out in list(self._pending):
            self._integrate(out, update_prior=False)
        self._pending = []

    def _integrate(self, out: ChunkOutput, update_prior: bool = True,
                   fetched=None) -> None:
        """``fetched=(DT, good)``: the host copies the caller already
        holds (no second fetch)."""
        self._pending = [p for p in self._pending if p is not out]
        if fetched is not None:
            DT, good = fetched
        else:
            DT = out.DT.cpu().numpy()
            good = out.good.cpu().numpy()
        DT_prev = self._last_step_host
        for i in range(DT.shape[0]):
            step = DT[i] if good[i] else DT_prev
            self.T_wc = (self.T_wc @ np.linalg.inv(step)).astype(np.float32)
            DT_prev = step.astype(np.float32)
            self.trajectory.append(self.T_wc.copy())
        self._last_step_host = DT_prev
        if update_prior:
            self.DT_prev = torch.from_numpy(DT_prev).to(self.device)
