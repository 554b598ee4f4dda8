"""The fused SLAM chunk: tracking, the keyframe criterion, the back end
and the loop closer's BoW probe of a B-frame chunk in one step.

Port of ``plslam_tpu/backend/fused_slam.py``: ``CritCarry``,
``init_crit_carry``, ``kf_scan`` (K14), the fused step, the packed host
block and ``FusedPLSLAM``, with loop closure (the default ``SlamConfig()``)
or without (``loop.enabled=False``, the CLI's ``--no-loops``). Per chunk:
the front end over the 2B images, the batched tracking of the B pairs
(``batch_vo._chunk_tracking_batched``), the keyframe criterion as kernel
J's ``kf_scan`` launch on CUDA tensors (``kf_scan_plain`` for CPU
tensors), then the keyframes through ``chunk_backend.backend_slots``, each
followed by the BoW probe (``loop_closer.probe_core``, kernel L). The step
fetches the chunk's keyframe flags (B bytes) to know which slots run;
everything else stays on the device until the settle fetches the one
packed host block, whose probe rows the loop closer then consumes
(verification, the pose graph of kernel M, the correction).

When the KF slots near ``max_kfs`` the driver compacts them after a settle
(``_compact``: pressure eviction with ``force_retire_kfs`` where the
sweeps freed too little, ``compact_keyframes``, the host's slot-valued
records and ``LoopCloser.remap_slots``), so a run may be longer than the
map's capacity; ``save_checkpoint`` / ``resume`` persist and restore a
run (``backend/checkpoint.py``, the reference's keys and dtypes).
``loop.distributed=True`` takes the loop closer's candidates from the
sharded database (``parallel/dist_vocab.py``), into which a resume mirrors
the rebuilt rows.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from plslam_tpu_torch import native, resolve_device
from plslam_tpu_torch.backend.chunk_backend import backend_slots
from plslam_tpu_torch.backend.map import (compact_keyframes,
                                          force_retire_kfs, init_map_state,
                                          require_points)
from plslam_tpu_torch.backend.map_handler import (KeyFrameSummary,
                                                  mapping_step_traced_lba)
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)
from plslam_tpu_torch.frontend.stereo_frame import extract_stereo_frame
from plslam_tpu_torch.loop.loop_closer import LoopCloser, probe_core
from plslam_tpu_torch.tracking.batch_vo import (_chunk_tracking_batched,
                                                _frame, _to_f32, extract_one)


class CritCarry(NamedTuple):
    """Keyframe-criterion state across chunks (device tensors)."""
    cov_kf: torch.Tensor      # (6, 6) compounded covariance since last KF
    have_cov: torch.Tensor    # () bool — cov_kf holds data
    ef: torch.Tensor          # () entropy at the first post-KF frame
    have_ef: torch.Tensor     # () bool
    frames: torch.Tensor      # () int32 frames since the last KF
    T_acc: torch.Tensor       # (4, 4) pose of the frame rel. the last KF
    last_step: torch.Tensor   # (4, 4) last good relative step (fallback)


# The packed carry: CritCarry's fields as typed views into one 16-byte
# aligned uint8 buffer, at these byte offsets (csrc/slam.cu KF_CARRY_*).
# kf_scan's kernel reads the carry in and writes the carry out whole.
CARRY_OFFSETS = {"cov_kf": 0, "T_acc": 144, "last_step": 208, "ef": 272,
                 "frames": 288, "have_cov": 304, "have_ef": 320}
CARRY_BYTES = 336
# the largest chunk kf_scan's kernel takes (csrc/slam.cu KF_SCAN_MAX_B)
KF_SCAN_MAX_B = 128
_PAD = {}   # 15 zero bytes a device: the packed carry's padding


def carry_views(buf: torch.Tensor) -> CritCarry:
    """CritCarry's fields as views into the packed uint8 carry ``buf``
    (its first CARRY_BYTES)."""
    f32 = buf[:CARRY_BYTES].view(torch.float32)
    return CritCarry(
        cov_kf=f32[0:36].view(6, 6), have_cov=buf[304].view(torch.bool),
        ef=f32[68], have_ef=buf[320].view(torch.bool),
        frames=buf[288:292].view(torch.int32)[0],
        T_acc=f32[36:52].view(4, 4), last_step=f32[52:68].view(4, 4))


def pack_crit_carry(c: CritCarry) -> torch.Tensor:
    """Any CritCarry (the plain version's separate tensors) -> the packed
    uint8 carry on its device: one concatenation."""
    dev = c.cov_kf.device
    if dev not in _PAD:
        _PAD[dev] = torch.zeros(15, dtype=torch.uint8, device=dev)
    z = _PAD[dev]
    b = lambda t, dt: t.to(dt).reshape(-1).view(torch.uint8)
    f32 = torch.float32
    return torch.cat([b(c.cov_kf, f32), b(c.T_acc, f32), b(c.last_step, f32),
                      b(c.ef, f32), z[:12], b(c.frames, torch.int32), z[:12],
                      b(c.have_cov, torch.bool), z, b(c.have_ef, torch.bool),
                      z])


def _packed_base(c: CritCarry) -> Optional[torch.Tensor]:
    """``c.cov_kf`` where ``c`` is a packed carry (every field at its
    offset from a 16-byte aligned base, the buffer whole), else None."""
    base = c.cov_kf.data_ptr()
    if base % 16:
        return None
    for name, off in CARRY_OFFSETS.items():
        if getattr(c, name).data_ptr() != base + off:
            return None
    st = c.cov_kf.untyped_storage()
    if st.data_ptr() + st.nbytes() < base + CARRY_BYTES:
        return None
    return c.cov_kf


def init_crit_carry(device) -> CritCarry:
    """The carry before the first chunk, packed: no covariance, no
    entropy, 0 frames, T_acc and last_step the identity."""
    buf = np.zeros(CARRY_BYTES, np.uint8)
    eye = np.eye(4, dtype=np.float32).view(np.uint8).reshape(-1)
    buf[144:208] = eye
    buf[208:272] = eye
    return carry_views(torch.from_numpy(buf).to(device))


def _r_cap(cfg: SlamConfig) -> float:
    return float(np.float32(np.deg2rad(cfg.keyframe.max_kf_r_dist)))


def kf_scan_plain(DT, cov, good, carry: CritCarry, cfg: SlamConfig,
                  kmax: int):
    k = cfg.keyframe
    r_cap = _r_cap(cfg)
    c = carry
    dev = DT.device
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    n_fired = torch.zeros((), dtype=torch.int32, device=dev)
    flags, T_accs, ratios, blocked = [], [], [], []
    for i in range(DT.shape[0]):
        step = torch.where(good[i], DT[i], c.last_step)
        Adj = lie.adjoint_se3(DT[i])
        cov_new = torch.where(c.have_cov, Adj @ c.cov_kf @ Adj.T + cov[i],
                              cov[i])
        sign, logdet = torch.linalg.slogdet(cov_new)
        h = torch.where(sign > 0, 0.5 * logdet, -torch.inf)
        ef_new = torch.where(c.have_ef, c.ef, h)
        ratio = torch.where(ef_new != 0.0, h / ef_new, 1.0)
        T_acc = c.T_acc @ lie.inverse_se3(step)
        t_dist, r_dist = lie.se3_distance(T_acc)
        frames = c.frames + 1
        crit = ((ratio < k.min_entropy_ratio) | (t_dist > k.max_kf_t_dist)
                | (r_dist > r_cap))
        want = good[i] & (frames >= k.min_kf_n_frames) & crit
        is_kf = want & (n_fired < kmax)
        blocked.append(want & (n_fired >= kmax))
        flags.append(is_kf)
        T_accs.append(T_acc)
        ratios.append(ratio)
        c = CritCarry(cov_kf=cov_new, have_cov=~is_kf,
                      ef=torch.where(is_kf, 0.0, ef_new), have_ef=~is_kf,
                      frames=torch.where(is_kf, 0, frames),
                      T_acc=torch.where(is_kf, eye4, T_acc), last_step=step)
        n_fired = n_fired + is_kf.to(torch.int32)
    return (torch.stack(flags), torch.stack(T_accs), torch.stack(ratios),
            torch.stack(blocked), c)


def kf_scan(DT: torch.Tensor, cov: torch.Tensor, good: torch.Tensor,
            carry: CritCarry, cfg: SlamConfig, kmax: int):
    """currFrameIsKF over a tracked chunk: adjoint compounding of the raw
    per-pair covariances, entropy ratio against the first post-KF frame,
    t/r caps, min_kf_n_frames, and at most ``kmax`` keyframes a chunk (a
    further candidate is deferred, the criterion state not reset).
    Returns (flags (B,), T_accs (B,4,4), ratios (B,), blocked (B,),
    carry_out); one launch of kernel J for CUDA tensors (B at most
    KF_SCAN_MAX_B), whose four outputs and packed carry out are views
    into one buffer. A carry that is not packed (the plain version's) is
    packed first, by one concatenation."""
    if DT.device.type == "cpu":
        return kf_scan_plain(DT, cov, good, carry, cfg, kmax)
    B = DT.shape[0]
    if not 1 <= B <= KF_SCAN_MAX_B:
        raise ValueError(f"kf_scan takes 1 to {KF_SCAN_MAX_B} frames a "
                         f"chunk, got {B}")
    k = cfg.keyframe
    DT, cov, good = DT.contiguous(), cov.contiguous(), good.contiguous()
    if good.dtype == torch.bool:
        good = good.view(torch.uint8)
    native.require(DT, "kf_scan DT", torch.float32, (B, 4, 4))
    native.require(cov, "kf_scan cov", torch.float32, (B, 6, 6))
    native.require(good, "kf_scan good", torch.uint8, (B,))
    cin = _packed_base(carry)
    if cin is None:
        cin = pack_crit_carry(carry)
    native.require(cin, "kf_scan carry", cin.dtype)
    buf = torch.empty(CARRY_BYTES + 70 * B, dtype=torch.uint8,
                      device=DT.device)
    native.launch("kf_scan", DT, cov, good, cin, buf, B,
                  int(k.min_kf_n_frames), int(kmax),
                  float(k.min_entropy_ratio), float(k.max_kf_t_dist),
                  _r_cap(cfg))
    o = CARRY_BYTES
    return (buf[o + 68 * B:o + 69 * B].view(torch.bool),
            buf[o:o + 64 * B].view(torch.float32).view(B, 4, 4),
            buf[o + 64 * B:o + 68 * B].view(torch.float32),
            buf[o + 69 * B:o + 70 * B].view(torch.bool), carry_views(buf))


# The packed host block: ONE flat f32 buffer per chunk, fetched once.
#   per frame (B rows x PF):  [DT flat 16 | T_acc flat 16 | good | flag |
#                              n_inliers | err | ratio | blocked]
#   per slot (kmax rows x PS): [valid | frame_idx | pose flat 16 | stats 7]
#   then the probe's scores (kmax*F) | covis (kmax*F), zero for unused
#   slots and with loops off, | the kf_pose snapshot (F*16)
_PF = 38
_PS = 25


def fused_step(imgs: torch.Tensor, prev_pts, prev_lns, T_prior0, crit,
               state, cam: StereoCamera, cfg: SlamConfig, kmax: int,
               probe=None):
    """One chunk: imgs (2, B, H, W) stacked left/right, uint8 (scaled to
    [0, 1]) or f32 -> (host_blk, state, crit, last_pts, last_lns,
    DT_next). ``probe``: the per-KF BoW probe (``backend_slots``), or
    None with loops off."""
    pts, lns = extract_stereo_frame(_to_f32(imgs[0]), _to_f32(imgs[1]), cam,
                                    cfg)
    out = _chunk_tracking_batched(pts, lns, prev_pts, prev_lns, T_prior0,
                                  cam, cfg)
    B = out.DT.shape[0]
    dev = out.DT.device
    flags, T_accs, ratios, blocked, crit2 = kf_scan(
        out.DT, out.cov, out.good, crit, cfg, kmax)
    # the step's one wait: which frames are keyframes (B bytes)
    fired = np.nonzero(flags.cpu().numpy())[0][:kmax]
    frame_idx = [int(i) for i in fired] + [0] * (kmax - len(fired))
    kf_valid = [True] * len(fired) + [False] * (kmax - len(fired))
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    T_rels = torch.stack([T_accs[i] if v else eye
                          for i, v in zip(frame_idx, kf_valid)])
    state, scores, covis, poses, stats = backend_slots(
        state, pts, lns, frame_idx, kf_valid, T_rels, cam, cfg, kmax,
        probe=probe)
    f32 = lambda x: x.to(torch.float32)
    frame_blk = torch.cat([
        f32(out.DT).reshape(B, 16), f32(T_accs).reshape(B, 16),
        f32(out.good)[:, None], f32(flags)[:, None],
        f32(out.n_inliers)[:, None], f32(out.err)[:, None],
        f32(ratios)[:, None], f32(blocked)[:, None]], dim=1)
    slot_blk = torch.cat([
        torch.tensor(kf_valid, dtype=torch.float32, device=dev)[:, None],
        torch.tensor(frame_idx, dtype=torch.float32, device=dev)[:, None],
        poses.reshape(kmax, 16), stats], dim=1)
    host_blk = torch.cat([frame_blk.reshape(-1), slot_blk.reshape(-1),
                          scores.reshape(-1), covis.reshape(-1),
                          f32(state.kf_pose).reshape(-1)])
    return (host_blk, state, crit2, _frame(pts, -1), _frame(lns, -1),
            out.DT_next)


class FusedPLSLAM:
    """Single-step-per-chunk full SLAM driver: ``initialize`` /
    ``process_chunk`` / ``finish``, plus ``summaries``, ``online_pose``,
    ``kf_poses``, ``n_landmarks``, ``loop_closer`` (None with loops off),
    ``save_checkpoint`` and ``resume``. To the loop closer it is the map
    handler (``_lock``, ``state``).

    Runs on ``device`` (default: the CUDA device; raises without one).
    Host chunks are stacked and copied to the device in ``process_chunk``;
    a (2, B, H, W) device tensor is taken as it is. A chunk is dispatched
    once the next one is queued and settled once two are in flight, the
    reference's order (its upload queue, then its depth-2 settle queue),
    so a compaction drains the same chunks at the same point of the run.
    """

    def __init__(self, cfg: SlamConfig, cam: Optional[StereoCamera] = None,
                 enable_loops: Optional[bool] = None, device=None):
        require_points(cfg, "FusedPLSLAM")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam if cam is not None else StereoCamera.from_config(
            cfg.camera)
        self.kmax = cfg.system.kf_batch
        self.enable_loops = (cfg.loop.enabled if enable_loops is None
                             else enable_loops)
        self._lock = threading.Lock()
        self.state = init_map_state(cfg, self.device)
        self.loop_closer = None
        self._probe = None
        if self.enable_loops:
            self.loop_closer = LoopCloser(cfg, self.cam, self.device)
            db = self.loop_closer.db
            has_lines = db.bows_l is not None
            self._probe = lambda st, slot: probe_core(
                db.voc_p, db.voc_l, cfg, has_lines, st, db.bows_p, db.bows_l,
                slot, db.ln_valid)[2:4]
        self._next_slot = 0
        self._crit = init_crit_carry(self.device)
        self.prev_pts = None
        self.prev_lns = None
        self.DT_prev = torch.eye(4, dtype=torch.float32, device=self.device)
        self.trajectory: List[np.ndarray] = []
        self._frame_anchor: List[Tuple[int, np.ndarray]] = []
        self._kf_slot = -1
        self._records: List[KeyFrameSummary] = []
        self._queued: List[Tuple[torch.Tensor, Optional[int]]] = []
        self._pending: List[Tuple[torch.Tensor, Optional[int]]] = []
        self._last_step_host = np.eye(4, dtype=np.float32)
        self._T_wc = np.eye(4, dtype=np.float32)
        self._last_settled = None
        self._compacting = False
        self.n_compactions = 0
        self.n_kf_deferral_chunks = 0   # chunks where kf_batch bound
        self.n_evicted_kfs = 0      # non-redundant KFs lost to pressure
        # (frames so far, [evicted slots]) per pressure-eviction event
        self.eviction_events: List[Tuple[int, List[int]]] = []
        # telemetry: the settled per-frame rows of the packed host block
        # (good, keyframe flag, entropy ratio, pose since the last KF, ...)
        self.frame_rows: List[np.ndarray] = []

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    # -- lifecycle -----------------------------------------------------------
    def initialize(self, img_l, img_r) -> None:
        self.prev_pts, self.prev_lns = extract_one(
            self._put(img_l), self._put(img_r), self.cam, self.cfg)
        self.state = mapping_step_traced_lba(
            self.state, self.prev_pts, self.prev_lns,
            torch.eye(4, dtype=torch.float32, device=self.device), self.cam,
            self.cfg, lba_flag=False)[0]
        self._next_slot = 1
        self._kf_slot = 0
        self.trajectory = [np.eye(4, dtype=np.float32)]
        self._frame_anchor = [(0, np.eye(4, dtype=np.float32))]
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe(self, 0)

    def process_chunk(self, imgs_l, imgs_r=None,
                      n_valid: Optional[int] = None) -> None:
        """Queue a (B, H, W) stereo chunk, or a device-resident stacked
        (2, B, H, W) tensor with ``imgs_r=None``. The previous queued
        chunk is dispatched, and a chunk's host block is settled once two
        chunks are in flight."""
        if imgs_r is None:
            imgs = imgs_l
        else:
            imgs = self._put(np.stack([np.asarray(imgs_l),
                                       np.asarray(imgs_r)]))
        self._queued.append((imgs, n_valid))
        if len(self._queued) >= 2:
            self._dispatch(*self._queued.pop(0))
        if len(self._pending) >= 2:
            self._settle_one()

    def _dispatch(self, imgs, n_valid):
        if self.prev_pts is None:
            raise RuntimeError("call initialize() first")
        (host_blk, state, self._crit, self.prev_pts, self.prev_lns,
         self.DT_prev) = fused_step(
            imgs, self.prev_pts, self.prev_lns, self.DT_prev, self._crit,
            self.state, self.cam, self.cfg, self.kmax, probe=self._probe)
        with self._lock:
            self.state = state
        self._pending.append((host_blk, n_valid))

    def _settle_one(self) -> int:
        host_ref, n_valid = self._pending.pop(0)
        host_blk = host_ref.cpu().numpy()              # ONE transfer
        n_slots = self.kmax
        F = self.cfg.mapping.max_kfs
        n_fb = host_blk.size - n_slots * _PS - 2 * n_slots * F - F * 16
        fb = host_blk[:n_fb].reshape(-1, _PF)
        off = n_fb
        sb = host_blk[off:off + n_slots * _PS].reshape(n_slots, _PS)
        off += n_slots * _PS
        scores = host_blk[off:off + n_slots * F].reshape(n_slots, F)
        off += n_slots * F
        covis = host_blk[off:off + n_slots * F].reshape(n_slots, F)
        off += n_slots * F
        kf_poses = host_blk[off:].reshape(F, 4, 4)
        B = fb.shape[0] if n_valid is None else n_valid
        self.frame_rows.append(fb[:B].copy())
        DT = fb[:, :16].reshape(-1, 4, 4)
        T_acc = fb[:, 16:32].reshape(-1, 4, 4)
        good = fb[:, 32] > 0.5
        flags = fb[:, 33] > 0.5
        if (fb[:B, 37] > 0.5).any():
            # the criterion wanted more than kf_batch KFs this chunk; the
            # extra candidate fires next chunk (bounded deferral)
            self.n_kf_deferral_chunks += 1
            if self.n_kf_deferral_chunks == 1:
                warnings.warn(
                    "FusedPLSLAM: keyframe criterion hit the kf_batch cap "
                    f"({self.kmax}) in a chunk; KF(s) deferred to the next "
                    "chunk. If this repeats, raise system.kf_batch for this "
                    "chunk size.")
        # trajectory integration (fallback to the last good step)
        n_kfs_new = 0
        for i in range(B):
            step = DT[i] if good[i] else self._last_step_host
            self._T_wc = (self._T_wc @ np.linalg.inv(step)).astype(np.float32)
            self._last_step_host = step.astype(np.float32)
            self.trajectory.append(self._T_wc.copy())
            self._frame_anchor.append(
                (self._kf_slot, T_acc[i].astype(np.float32)))
            if flags[i]:
                self._kf_slot += 1
                n_kfs_new += 1
        slots_valid = sb[:, 0] > 0.5
        poses = sb[:, 2:18].reshape(n_slots, 4, 4)
        stats = sb[:, 18:25]
        # tripwires: an inserted KF pose, or any KF pose of the snapshot,
        # at an insane magnitude means state corruption upstream
        for j in np.nonzero(slots_valid)[0]:
            pm = float(np.abs(poses[j][:3, 3]).max())
            if pm > 1e3:
                print(f"[fused_slam] WARNING: settled KF slot "
                      f"{int(stats[j, 6])} (frame ~{len(self.trajectory)}) "
                      f"pose |t|={pm:.3g} — state corruption upstream of "
                      "insertion")
        tmags = np.abs(kf_poses[:max(self._next_slot, 1), :3, 3]).max(-1)
        if tmags.size and float(tmags.max()) > 1e3:
            print(f"[fused_slam] WARNING: kf_pose snapshot slot "
                  f"{int(np.argmax(tmags))} |t|={tmags.max():.3g} at frame ~"
                  f"{len(self.trajectory)} — map corrupted this chunk")
        if slots_valid.any():
            self._next_slot = int(stats[slots_valid, 6].max()) + 1
        corrected = None
        for j in np.nonzero(slots_valid)[0]:
            slot = int(stats[j, 6])
            self._records.append(KeyFrameSummary(
                slot=slot, T_w_kf=poses[j].astype(np.float32),
                n_map_matches=int(stats[j, 2]), n_new_points=int(stats[j, 3]),
                lba_cost0=float(stats[j, 0]), lba_cost1=float(stats[j, 1]),
                lba_pt_overflow=int(stats[j, 4]),
                lba_ln_overflow=int(stats[j, 5])))
            if self.loop_closer is not None:
                if corrected is not None:
                    # a closure earlier in this settle moved every KF: the
                    # snapshot is stale, use the corrected poses
                    kf_poses = corrected
                out = self.loop_closer._handle_probe_result(
                    self, slot, scores[j].copy(), covis[j], self._next_slot,
                    kf_poses)
                if out is not None:
                    corrected = out
        self._last_settled = (np.asarray(kf_poses) if corrected is None
                              else corrected)
        # when the next chunks could run into the slot ceiling, compact the
        # retired slots away (after the settle: everything above used one
        # slot numbering)
        if (not self._compacting
                and self._next_slot >= self.cfg.mapping.max_kfs
                - 2 * self.kmax):
            self._compact()
        return n_kfs_new

    def _settle_all(self):
        while self._queued:
            self._dispatch(*self._queued.pop(0))
        while self._pending:
            self._settle_one()

    def _compact(self):
        """Stop-the-world KF-slot compaction: drain the pipeline; where the
        regular sweeps left at least ``max_kfs - 2 kf_batch`` live KFs,
        evict ``min(max(3 kf_batch, F // 32), F // 4)`` of them
        (``force_retire_kfs``); drop the retired slots on the device
        (``compact_keyframes``); then remap every slot-valued host record:
        the frame anchors (re-expressed against the nearest surviving
        earlier KF with the pre-compaction poses), the current KF slot, the
        next slot, and the loop closer's edges and BoW rows. Raises when
        compaction cannot free a chunk's worth of slots."""
        self._compacting = True
        try:
            self._settle_all()
            F = self.cfg.mapping.max_kfs
            target = F - 2 * self.kmax       # room the next chunks need
            with self._lock:
                n_live = int(self.state.kf_valid.sum())
                if n_live >= target:
                    # the sequence is longer than max_kfs and the sweeps
                    # found nothing redundant: evict under pressure, a
                    # config-constant count above the 2 kf_batch headroom
                    n_evict = min(max(3 * self.kmax, F // 32), F // 4)
                    valid_before = self.state.kf_valid.cpu().numpy()
                    self.state, _ = force_retire_kfs(self.state, self.cfg,
                                                     n_evict)
                    valid_after = self.state.kf_valid.cpu().numpy()
                    evicted = np.nonzero(valid_before & ~valid_after)[0]
                    self.n_evicted_kfs += int(evicted.size)
                    self.eviction_events.append(
                        (len(self.trajectory), [int(s) for s in evicted]))
                    if len(self.eviction_events) == 1:
                        warnings.warn(
                            "FusedPLSLAM: KF capacity pressure forced "
                            f"eviction of {evicted.size} NON-redundant "
                            "keyframe(s) — map history is being lost. "
                            "Raise mapping.max_kfs for this sequence "
                            "scale. (Further evictions are recorded in "
                            "eviction_events without warning.)")
                old_poses = self.state.kf_pose.cpu().numpy()
                self.state, exact_d, _, nv_d = compact_keyframes(self.state)
                exact = exact_d.cpu().numpy()
                nv = int(nv_d)
            if nv >= target:
                raise RuntimeError(
                    f"KF capacity exhausted: {nv} live keyframes of "
                    f"max_kfs={F} after compaction + eviction (window "
                    "span leaves nothing evictable). Raise "
                    "mapping.max_kfs for this sequence scale.")
            # old slot of each surviving new slot (anchor re-expression)
            old_of_new = np.zeros((F,), np.int32)
            for old, new in enumerate(exact):
                if new >= 0:
                    old_of_new[new] = old
            # nearest surviving slot at or before each old slot
            floor = np.maximum.accumulate(np.where(exact >= 0, exact, -1))

            def remap_anchor(s, T_rel):
                s = min(int(s), F - 1)
                if exact[s] >= 0:
                    return (int(exact[s]), T_rel)
                v = int(floor[s])            # new slot of the survivor
                if v < 0:
                    return (0, T_rel)
                T_surv = old_poses[old_of_new[v]]
                T_new = (np.linalg.inv(T_surv) @ old_poses[s]
                         @ T_rel).astype(np.float32)
                return (v, T_new)

            self._frame_anchor = [remap_anchor(s, T) for s, T in
                                  self._frame_anchor]
            self._kf_slot = remap_anchor(self._kf_slot,
                                         np.eye(4, dtype=np.float32))[0]
            self._next_slot = nv
            if self.loop_closer is not None:
                self.loop_closer.remap_slots(exact, nv, old_poses=old_poses)
            with self._lock:
                self._last_settled = self.state.kf_pose.cpu().numpy()
            pm = float(np.abs(self._last_settled[:nv, :3, 3]).max())
            if pm > 1e3:
                print(f"[fused_slam] WARNING: post-compaction KF pose "
                      f"|t|max={pm:.3g} — compaction-era corruption")
            self.n_compactions += 1
        finally:
            self._compacting = False

    # -- queries -------------------------------------------------------------
    @property
    def summaries(self):
        return list(self._records)

    def online_pose(self, drain: bool = False) -> np.ndarray:
        """The latest settled KF's pose composed with the tracker's
        relative chain since it (``drain=True`` settles everything first)."""
        if drain:
            self._settle_all()
        if self._last_settled is None or not self._frame_anchor:
            return self._T_wc.copy()
        slot, T_rel = self._frame_anchor[-1]
        return (self._last_settled[slot] @ T_rel).astype(np.float32)

    def kf_poses(self) -> np.ndarray:
        n = int(self.state.n_kfs)
        return self.state.kf_pose[:n].cpu().numpy()

    def n_landmarks(self) -> Tuple[int, int]:
        return (int(self.state.pt_valid.sum()), int(self.state.ln_valid.sum()))

    def finish(self) -> np.ndarray:
        """Settle everything and recompose the trajectory from the
        corrected KF poses and the per-frame relatives."""
        self._settle_all()
        kf_poses = self.kf_poses()
        return np.stack([kf_poses[min(slot, len(kf_poses) - 1)] @ T_rel
                         for slot, T_rel in self._frame_anchor])

    # -- checkpoint / resume -------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Settle the pipeline and write the MapState, the config and the
        host continuation (trajectory, frame anchors, the criterion carry
        as the reference's ``crit_<i>`` arrays, the last frame's features,
        the prior, counters and the loop closer's packed edges) with
        ``checkpoint.save_map``. The BoW rows are not written: ``resume``
        recomputes them from the per-KF descriptors in the MapState."""
        from plslam_tpu_torch.backend.checkpoint import save_map
        self._settle_all()
        host = lambda t: t.detach().cpu().numpy()
        extra = {
            "trajectory": np.stack(self.trajectory),
            "anchor_slots": np.asarray([s for s, _ in self._frame_anchor],
                                       np.int32),
            "anchor_T": (np.stack([T for _, T in self._frame_anchor])
                         if self._frame_anchor else
                         np.zeros((0, 4, 4), np.float32)),
            "kf_slot": np.asarray(self._kf_slot, np.int32),
            "next_slot": np.asarray(self._next_slot, np.int32),
            "T_wc": self._T_wc,
            "last_step": self._last_step_host,
            "DT_prev": host(self.DT_prev),
            "n_compactions": np.asarray(self.n_compactions, np.int32),
            "n_kf_deferral_chunks": np.asarray(self.n_kf_deferral_chunks,
                                               np.int32),
            "n_evicted_kfs": np.asarray(self.n_evicted_kfs, np.int32),
        }
        for i, leaf in enumerate(self._crit):     # CritCarry's field order
            extra[f"crit_{i}"] = host(leaf)
        for i, leaf in enumerate(self.prev_pts):
            extra[f"prev_pts_{i}"] = host(leaf)
        if self.prev_lns is not None:
            for i, leaf in enumerate(self.prev_lns):
                extra[f"prev_lns_{i}"] = host(leaf)
        if self.loop_closer is not None:
            lc = self.loop_closer
            extra["lc_odo"] = _pack_edges(lc.odo_edges, 4)
            extra["lc_covis"] = _pack_edges(lc.covis_edges, 5)
            extra["lc_loop"] = _pack_edges(lc.loop_edges, 4)
            extra["lc_n_loops"] = np.asarray(lc.n_loops_closed, np.int32)
            # the post-closure lockout survives a resume
            extra["lc_probes_since_close"] = np.asarray(
                min(lc.probes_since_close, 10 ** 9), np.int64)
            # two keys of this package alone (the reference's resume reads
            # neither): the line masks of the BoW rows, which culling has
            # since changed in the map, and the voter's streaks, so that a
            # resumed run continues as the run it was saved from
            if lc.db.ln_valid is not None:
                extra["lc_bow_ln_valid"] = host(lc.db.ln_valid)
            extra["lc_streaks"] = np.asarray(
                list(lc.voter._streaks.items()), np.int64).reshape(-1, 2)
        save_map(path, self.state, self.cfg, extra=extra)

    @classmethod
    def resume(cls, path: str, cam: Optional[StereoCamera] = None,
               enable_loops: Optional[bool] = None,
               device=None) -> "FusedPLSLAM":
        """A live driver from a checkpoint (this package's or the
        reference's): the MapState and the tracker's carry exactly, the
        loop closer's edges reloaded and its BoW rows rebuilt from the
        per-KF descriptors (``_rebuild_bows``)."""
        from plslam_tpu_torch import convert
        from plslam_tpu_torch.backend.checkpoint import load_map
        dev = resolve_device(device)
        state, cfg, extra = load_map(path, dev)
        self = cls(cfg, cam, enable_loops=enable_loops, device=dev)
        with self._lock:
            self.state = state
        self.trajectory = [t.astype(np.float32) for t in extra["trajectory"]]
        self._frame_anchor = [
            (int(s), np.asarray(T, np.float32)) for s, T in
            zip(extra["anchor_slots"], extra["anchor_T"])]
        self._kf_slot = int(extra["kf_slot"])
        self._next_slot = int(extra["next_slot"])
        self._T_wc = np.asarray(extra["T_wc"], np.float32)
        self._last_step_host = np.asarray(extra["last_step"], np.float32)
        self.DT_prev = torch.from_numpy(
            np.asarray(extra["DT_prev"], np.float32)).to(dev)
        self.n_compactions = int(extra.get("n_compactions", 0))
        self.n_kf_deferral_chunks = int(extra.get("n_kf_deferral_chunks", 0))
        self.n_evicted_kfs = int(extra.get("n_evicted_kfs", 0))
        self._crit = carry_views(pack_crit_carry(convert.crit_carry_from_numpy(
            {f: extra[f"crit_{i}"] for i, f in enumerate(CritCarry._fields)},
            dev)))
        self.prev_pts = convert.points_from_numpy(
            {f: extra[f"prev_pts_{i}"]
             for i, f in enumerate(PointObservations._fields)}, dev)
        if any(k.startswith("prev_lns_") for k in extra):
            self.prev_lns = convert.lines_from_numpy(
                {f: extra[f"prev_lns_{i}"]
                 for i, f in enumerate(LineObservations._fields)}, dev)
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.odo_edges = [(i, j, T, float(w)) for (i, j, T, w) in
                            _unpack_edges(extra.get("lc_odo",
                                                    np.zeros((0, 19))), 1)]
            lc.covis_edges = [(i, j, T, float(w), int(ns)) for
                              (i, j, T, w, ns) in
                              _unpack_edges(extra.get("lc_covis",
                                                      np.zeros((0, 20))), 2)]
            lc.loop_edges = [(i, j, T, float(w)) for (i, j, T, w) in
                             _unpack_edges(extra.get("lc_loop",
                                                     np.zeros((0, 19))), 1)]
            lc.n_loops_closed = int(extra.get("lc_n_loops", 0))
            lc.probes_since_close = int(
                extra.get("lc_probes_since_close", 10 ** 9))
            lc.voter._streaks = {int(c): int(n) for c, n in
                                 extra.get("lc_streaks", np.zeros((0, 2)))}
            ln_valid = extra.get("lc_bow_ln_valid")
            self._rebuild_bows(None if ln_valid is None else
                               torch.from_numpy(ln_valid).to(dev))
        self._last_settled = self.state.kf_pose.cpu().numpy()
        return self

    def _rebuild_bows(self, ln_valid: Optional[torch.Tensor] = None):
        """The loop database's BoW rows from the per-KF descriptors in the
        MapState, slot by slot through the probe (each slot launches L's
        ``bow_descend`` and ``bow_hist`` for each family on the card). The
        line rows take the masks ``ln_valid`` (F, L) their probes used,
        where the checkpoint kept them: the rows then equal the saved
        driver's bit for bit. Without them (a checkpoint of the reference)
        they take the map's current masks, as the reference does."""
        db = self.loop_closer.db
        state = self.state
        if ln_valid is not None:
            state = state._replace(obs_ln_lm=torch.where(
                ln_valid, 0, -1).to(state.obs_ln_lm.dtype))
        lc = self.loop_closer
        for slot in range(int(state.n_kfs)):
            probe_core(db.voc_p, db.voc_l, self.cfg, db.bows_l is not None,
                       state, db.bows_p, db.bows_l, slot, db.ln_valid)
            if lc._dist is not None:        # mirror into the sharded DB
                lc._dist.insert(slot, *lc._bow_rows(slot))

    def close(self):
        if self._queued or self._pending:
            warnings.warn(
                f"FusedPLSLAM.close() with "
                f"{len(self._queued) + len(self._pending)} chunk(s) not "
                "settled — call finish() first to settle them; settling "
                "now", stacklevel=2)
            self._settle_all()


def _pack_edges(edges, width: int) -> np.ndarray:
    """Graph edges as the reference's checkpoint rows: i, j, T (16), then
    the edge's trailing scalars (width - 3 of them)."""
    out = np.zeros((len(edges), 15 + width), np.float32)
    for n, e in enumerate(edges):
        out[n, 0], out[n, 1] = e[0], e[1]
        out[n, 2:18] = np.asarray(e[2]).reshape(16)
        out[n, 18:] = e[3:width]
    return out


def _unpack_edges(arr: np.ndarray, extra_cols: int) -> list:
    out = []
    for row in arr:
        e = (int(row[0]), int(row[1]),
             row[2:18].reshape(4, 4).astype(np.float32))
        out.append(e + tuple((int(c) if float(c).is_integer() else float(c))
                             for c in row[18:18 + extra_cols]))
    return out
