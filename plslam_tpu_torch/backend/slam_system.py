"""The per-frame and host-KF SLAM drivers: stereo VO front end + mapping
back end (+ loop closure when enabled).

Port of ``plslam_tpu/backend/slam_system.py`` (``SlamFrameResult``,
``PLSLAM``, ``ChunkedPLSLAM``), the wiring of pl-slam's
``app/plslam_dataset.cpp``: the tracker runs every frame, a frame the
keyframe criterion promotes goes to the ``MapHandler`` (its worker thread
with ``system.async_mapping``, the default), and the back end's
corrections re-anchor the odometry. ``finish`` drains the map and
recomposes the trajectory from the corrected keyframe poses.

``PLSLAM`` is the per-frame driver (``StereoVO`` with points and lines,
B = 1). In sync mode the LBA correction of a keyframe is applied to the
tracker at once; in async mode none reaches it. Each loop probe waits for
the map to go idle first, the first keyframe's included (the reference
probes it without waiting, racing its worker), so each mode is
deterministic.

``ChunkedPLSLAM`` tracks B frames a call (``vo_chunk(keep_feats=True)``),
settles a chunk once two are in flight, decides keyframes on the host
(``KeyframeCriterion``) and hands the chunk's keyframes to
``MapHandler.add_keyframes_fused``, which slices them out of the chunk's
feature stacks on the device.

Both run on ``device`` (default: the CUDA device; raises without one).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from plslam_tpu_torch import resolve_device
from plslam_tpu_torch.backend.map import require_points
from plslam_tpu_torch.backend.map_handler import MapHandler
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.convert import host_copies
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.stereo_frame import make_extractor
from plslam_tpu_torch.loop.loop_closer import LoopCloser
from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO
from plslam_tpu_torch.tracking.frame_handler import (FrameResult,
                                                     KeyframeCriterion,
                                                     StereoVO)


class SlamFrameResult(NamedTuple):
    frame: FrameResult
    kf_slot: Optional[int]


def _recompose(kf_poses: np.ndarray, anchors) -> np.ndarray:
    """Each frame's pose: its anchor KF's corrected pose times the frame's
    pose relative to that KF at tracking time."""
    return np.stack([kf_poses[min(slot, len(kf_poses) - 1)] @ T_rel
                     for slot, T_rel in anchors])


class PLSLAM:
    """The per-frame driver: ``initialize``, ``process`` a pair at a time,
    ``finish``; ``map`` is its MapHandler, ``loop_closer`` None with loops
    off."""

    def __init__(self, cfg: SlamConfig, cam: Optional[StereoCamera] = None,
                 enable_loops: Optional[bool] = None, device=None):
        require_points(cfg, "PLSLAM")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam if cam is not None else StereoCamera.from_config(
            cfg.camera)
        self.vo = StereoVO(cfg, self.cam,
                           extract_fn=make_extractor(self.cam, cfg,
                                                     self.device),
                           device=self.device)
        self.enable_loops = (cfg.loop.enabled if enable_loops is None
                             else enable_loops)
        self.loop_closer = (LoopCloser(cfg, self.cam, self.device)
                            if self.enable_loops else None)
        self.map = MapHandler(cfg, self.cam, self.device)
        # per-frame anchoring: (KF slot at process time, T_rel to that KF)
        self._frame_anchor: List[Tuple[int, np.ndarray]] = []
        self._kf_slot = -1
        self._T_kf_at_insert = np.eye(4, dtype=np.float32)

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, img_l, img_r) -> SlamFrameResult:
        fr = self.vo.initialize(img_l, img_r)
        pts, lns = self.vo.current_features
        self.map.add_keyframe(pts, lns, self.vo.T_wc, run_lba=False)
        self._kf_slot = 0
        self._T_kf_at_insert = self.vo.T_wc.copy()
        self._frame_anchor = [(0, np.eye(4, dtype=np.float32))]
        if self.loop_closer is not None:
            self.map.wait_idle()
            self.loop_closer.on_keyframe(self.map, 0)
        return SlamFrameResult(fr, 0)

    def process(self, img_l, img_r) -> SlamFrameResult:
        fr = self.vo.insert_stereo_pair(img_l, img_r)
        T_rel = np.linalg.inv(self._T_kf_at_insert) @ fr.T_wc
        self._frame_anchor.append((self._kf_slot, T_rel.astype(np.float32)))
        kf_slot = None
        if fr.is_kf:
            pts, lns = self.vo.current_features
            summary = self.map.add_keyframe(pts, lns, fr.T_wc)
            kf_slot = self._kf_slot + 1
            self._kf_slot = kf_slot
            self._T_kf_at_insert = fr.T_wc.copy()
            if summary is not None:
                # sync mode: apply the LBA correction at once
                self._apply_correction(summary.T_w_kf)
            if self.loop_closer is not None:
                self.map.wait_idle()
                corrected = self.loop_closer.on_keyframe(self.map, kf_slot)
                if corrected is not None:
                    self._apply_correction(corrected)
        return SlamFrameResult(fr, kf_slot)

    def _apply_correction(self, T_corrected: np.ndarray) -> None:
        """Re-anchor the odometry after the back end moved the latest KF."""
        self.vo.T_wc = np.asarray(T_corrected, np.float32)
        self.vo.T_kf = self.vo.T_wc.copy()
        self._T_kf_at_insert = self.vo.T_wc.copy()

    def finish(self) -> np.ndarray:
        """finishSLAM: drain the map, recompose the trajectory from the
        corrected KF poses and the per-frame relatives, stop the worker."""
        self.map.wait_idle()
        out = _recompose(self.map.kf_poses(), self._frame_anchor)
        self.map.close()
        return out


class ChunkedPLSLAM:
    """Full SLAM on the chunked tracker: B frames a ``process_chunk``,
    host-side KF decisions from the settled per-frame poses and
    covariances, the chunk's keyframes sliced out of its feature stacks on
    the device, mapping and loop closure on the map's worker.

    Back-end corrections feed the live map: a keyframe enters it relative
    to the previous KF's current (corrected) pose. ``finish`` recomposes
    the trajectory from the corrected KF poses; ``online_pose`` is the
    latest KF's current pose composed with the tracker's chain since it.
    """

    def __init__(self, cfg: SlamConfig, cam: Optional[StereoCamera] = None,
                 enable_loops: Optional[bool] = None, device=None):
        require_points(cfg, "ChunkedPLSLAM")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam if cam is not None else StereoCamera.from_config(
            cfg.camera)
        self.vo = BatchedStereoVO(cfg, self.cam, device=self.device)
        self.kf_criterion = KeyframeCriterion(cfg)
        self.enable_loops = (cfg.loop.enabled if enable_loops is None
                             else enable_loops)
        self.loop_closer = (LoopCloser(cfg, self.cam, self.device)
                            if self.enable_loops else None)
        self.map = MapHandler(cfg, self.cam, self.device)
        self._frame_anchor: List[Tuple[int, np.ndarray]] = []
        self._kf_slot = -1
        self._T_kf_at_insert = np.eye(4, dtype=np.float32)
        self._T_kf = np.eye(4, dtype=np.float32)
        self._inflight: List[Optional[int]] = []   # n_valid a pending chunk

    def initialize(self, img_l, img_r) -> None:
        self.vo.initialize(img_l, img_r)
        on_done = None
        if self.loop_closer is not None:
            on_done = (lambda s:
                       self.loop_closer.on_keyframe(self.map, s.slot))
        self.map.add_keyframe(self.vo.prev_pts, self.vo.prev_lns,
                              np.eye(4, dtype=np.float32), run_lba=False,
                              on_done=on_done)
        self._kf_slot = 0
        self._frame_anchor = [(0, np.eye(4, dtype=np.float32))]

    def process_chunk(self, imgs_l, imgs_r,
                      n_valid: Optional[int] = None) -> int:
        """Submit a (B, H, W) chunk (its first ``n_valid`` frames real);
        once two are in flight, settle the older one. Returns the number
        of keyframes that settle made."""
        # the map's queued steps are dispatched before the next chunk, so
        # their kernels interleave with the tracker's in the stream
        self.map.wait_dispatched()
        self.vo.submit_chunk(imgs_l, imgs_r, keep_feats=True)
        self._inflight.append(n_valid)
        if len(self._inflight) >= 2:
            return self._settle_one()
        return 0

    def _settle_one(self) -> int:
        out = self.vo._pending[0]
        n_valid = self._inflight.pop(0)
        base = len(self.vo.trajectory)
        DT, cov, good = host_copies(out.DT, out.cov, out.good)
        self.vo._integrate(out, update_prior=False, fetched=(DT, good))
        B = DT.shape[0] if n_valid is None else n_valid
        kf_frames, kf_rels = [], []
        for i in range(B):
            T_wc = self.vo.trajectory[base + i]
            T_rel = np.linalg.inv(self._T_kf_at_insert) @ T_wc
            self._frame_anchor.append((self._kf_slot,
                                       T_rel.astype(np.float32)))
            is_kf, _ = self.kf_criterion.update(
                DT[i], cov[i], bool(good[i]),
                np.linalg.inv(self._T_kf) @ T_wc)
            if is_kf:
                kf_frames.append(i)
                # relative to the previous KF: the back end composes it
                # against that KF's current (LBA/loop-corrected) pose
                kf_rels.append(
                    (np.linalg.inv(self._T_kf) @ T_wc).astype(np.float32))
                self._kf_slot += 1
                self._T_kf_at_insert = T_wc.copy()
                self._T_kf = T_wc.copy()
        if kf_frames:
            self.map.add_keyframes_fused(out.all_pts, out.all_lns,
                                         kf_frames, kf_rels,
                                         loop_closer=self.loop_closer)
        return len(kf_frames)

    def online_pose(self) -> np.ndarray:
        """The latest KF's pose as the back end holds it now (LBA and loop
        corrections included) composed with the tracker's relative chain
        since that KF."""
        # the KF slot advances at decision time: wait until the worker has
        # dispatched its insertion, or the slot would read a placeholder
        self.map.wait_dispatched()
        T_kf = self.map.latest_kf_pose(max(self._kf_slot, 0))
        T_rel = np.linalg.inv(self._T_kf_at_insert) @ self.vo.T_wc
        return (T_kf @ T_rel).astype(np.float32)

    def finish(self) -> np.ndarray:
        while self._inflight:
            self._settle_one()
        self.vo.drain()
        self.map.wait_idle()
        out = _recompose(self.map.kf_poses(), self._frame_anchor)
        self.map.close()
        return out
