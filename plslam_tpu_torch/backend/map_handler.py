"""Windowed LBA over the map state, the per-KF mapping steps and the
mapping worker.

Port of ``plslam_tpu/backend/map_handler.py`` (``_compact_landmarks``,
``_build_window_problem``, ``run_window_lba``, ``_apply_lba_result``,
``DistLBA``, ``run_window_lba_distributed``, ``mapping_step``,
``mapping_step_distributed``, ``mapping_step_traced_lba``,
``KeyFrameSummary``, ``PendingSummary``, ``PendingBatch`` and
``MapHandler``): the last window +
fixed KF slots and the landmarks they touched, compacted (newest-touched
first, stable sort as the reference's ``argsort``), solved by
``backend/lba.py::run_lba`` and scattered back with the solved outliers
detached. The reference's ``lax.cond`` around the LBA of a slot becomes a
host branch on the (host-known) flag; the periodic global KF sweep stays a
device decision (``remove_redundant_kfs_global``'s ``enabled``):
``mapping_step`` (the per-KF cadence) fires it at ``n_kfs % every == 0``,
``mapping_step_traced_lba`` (the strided cadence) when a multiple fell in
the last ``lba_kf_stride`` insertions.

``MapHandler`` holds the MapState of the per-frame and host-KF drivers
(``backend/slam_system.py``). With ``system.async_mapping`` (the default)
a worker thread takes the keyframe jobs, the reference's mapping thread:
it launches on the stream that was current where the handler was made,
so its kernels and the tracker's stay in one stream order, and it keeps
the first exception a job raised and raises it again from ``wait_idle``,
``wait_dispatched`` and ``close``. With ``mapping.distributed=True`` the
per-KF steps (both modes) solve the window on the owner-sharded LM
(``DistLBA``, ``parallel/dist_lba.py``) over ``mapping.dist_devices``
shards (0: one a visible device of the map's type).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from plslam_tpu_torch import resolve_device
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.backend import lba
from plslam_tpu_torch.backend.map import (MapState, _set_drop, add_keyframe,
                                          cull_landmarks, init_map_state,
                                          remove_redundant_kfs,
                                          remove_redundant_kfs_global)
from plslam_tpu_torch.convert import host_copies


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


class DistLBA:
    """The distributed window LBA of a MapHandler (``mapping.distributed``):
    the shard mesh ('lm' axis, ``mapping.dist_devices`` shards, 0 meaning
    one a visible device of ``device``'s type, placed as
    ``parallel/mesh.py::make_mesh`` places them) and the sharded LM
    (``make_dist_lba_lm``)."""

    def __init__(self, cfg: SlamConfig, cam: StereoCamera, device=None):
        from plslam_tpu_torch.parallel.dist_lba import make_dist_lba_lm
        from plslam_tpu_torch.parallel.mesh import make_mesh
        dev = resolve_device(device)
        n = cfg.mapping.dist_devices or (
            torch.cuda.device_count() if dev.type == "cuda" else 1)
        self.mesh = mesh = make_mesh(n, axes=("lm",), device=dev)
        self.n = mesh.size
        self.lm_fn = make_dist_lba_lm(
            mesh, cam, cfg.mapping.lba_iters, cfg.mapping.lambda_init,
            cfg.mapping.lambda_factor, axis="lm")


def run_window_lba_distributed(state: MapState, cam: StereoCamera,
                               cfg: SlamConfig, dist: DistLBA
                               ) -> Tuple[MapState, torch.Tensor,
                                          torch.Tensor, dict]:
    """``run_window_lba`` with the solve on the owner-sharded LM: the
    compact window problem, bucketed into the round-robin owner layout,
    solved across the mesh (its collectives: the reduced camera system, a
    step), the landmarks gathered and unpermuted, the outliers flagged on
    the whole problem, the result scattered into the map."""
    from plslam_tpu_torch.parallel.dist_lba import bucket_problem_by_owner
    prob, ctx = _build_window_problem(state, cam, cfg)
    bucketed = bucket_problem_by_owner(prob, dist.n)
    kf_pose, pt_b, ep_b, c0, c1 = dist.lm_fn(bucketed.problem)
    pt_pos = pt_b[bucketed.pt_perm]
    ep_pos = ep_b[bucketed.ep_perm]
    solved = prob._replace(kf_pose=kf_pose, pt_pos=pt_pos, ep_pos=ep_pos)
    pt_inl, ln_inl = lba.posthoc_inliers(solved, cam, cfg)
    res = lba.LBAResult(kf_pose, pt_pos, ep_pos, c0, c1, pt_inl, ln_inl)
    return _apply_lba_result(state, res, ctx)


def mapping_step_distributed(state: MapState, pts, lns, T_w_kf: torch.Tensor,
                             cam: StereoCamera, cfg: SlamConfig,
                             dist: DistLBA, run_lba_flag: bool = True):
    """``mapping_step`` with the window LBA on the shard mesh; with
    ``run_lba_flag`` the global sweep runs at every step (as the
    reference's; an extra sweep finds nothing more to retire)."""
    state, diag = add_keyframe(state, pts, lns, T_w_kf, cam, cfg)
    c0 = c1 = torch.zeros((), dtype=torch.float32, device=T_w_kf.device)
    if run_lba_flag:
        state, c0, c1, lba_diag = run_window_lba_distributed(
            state, cam, cfg, dist)
        diag = {**diag, **lba_diag}
        state, _ = remove_redundant_kfs(state, cfg)
        if cfg.mapping.global_kf_sweep_every > 0:
            state, _ = remove_redundant_kfs_global(state, cfg)
    state = cull_landmarks(state, cfg)
    return state, diag, c0, c1


def mapping_step(state: MapState, pts, lns, T_w_kf: torch.Tensor,
                 cam: StereoCamera, cfg: SlamConfig,
                 run_lba_flag: bool = True):
    """The per-KF back-end step: KF insertion + map matching +
    triangulation; with ``run_lba_flag`` the window LBA, redundant-KF
    retirement and, where ``n_kfs`` is a multiple of
    ``global_kf_sweep_every``, the global sweep; landmark culling always.
    Returns (state, diag, c0, c1); ``diag`` holds the LBA's overflow
    counts where it ran."""
    state, diag = add_keyframe(state, pts, lns, T_w_kf, cam, cfg)
    c0 = c1 = torch.zeros((), dtype=torch.float32, device=T_w_kf.device)
    if run_lba_flag:
        state, c0, c1, lba_diag = run_window_lba(state, cam, cfg)
        diag = {**diag, **lba_diag}
        state, _ = remove_redundant_kfs(state, cfg)
        every = cfg.mapping.global_kf_sweep_every
        if every > 0:
            state, _ = remove_redundant_kfs_global(
                state, cfg,
                enabled=torch.remainder(state.n_kfs, every) == 0)
    state = cull_landmarks(state, cfg)
    return state, diag, c0, c1


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


class PendingSummary(NamedTuple):
    """A KF summary whose values are still on the device: in async mode
    the worker fetches nothing per keyframe; ``summaries`` fetches."""
    slot: int
    refs: tuple                 # (pose, matches, new points, c0, c1, ovf x2)


class PendingBatch(NamedTuple):
    """The deferred summaries of one chunk-backend dispatch."""
    slots: tuple                # host ints (valid KFs only)
    refs: tuple                 # (poses (kmax, 4, 4), stats (kmax, 7))


def _materialize(slot: int, refs) -> KeyFrameSummary:
    refs = host_copies(*refs)
    return KeyFrameSummary(
        slot=slot, T_w_kf=np.asarray(refs[0]),
        n_map_matches=int(refs[1]), n_new_points=int(refs[2]),
        lba_cost0=float(refs[3]), lba_cost1=float(refs[4]),
        lba_pt_overflow=int(refs[5]), lba_ln_overflow=int(refs[6]))


def _materialize_batch(slots, refs) -> List[KeyFrameSummary]:
    poses, stats = host_copies(*refs)
    return [KeyFrameSummary(
        slot=s, T_w_kf=np.asarray(poses[j]),
        n_map_matches=int(stats[j, 2]), n_new_points=int(stats[j, 3]),
        lba_cost0=float(stats[j, 0]), lba_cost1=float(stats[j, 1]),
        lba_pt_overflow=int(stats[j, 4]), lba_ln_overflow=int(stats[j, 5]))
        for j, s in enumerate(slots)]


class MapHandler:
    """Host driver holding the MapState on ``device`` (default: the CUDA
    device; raises without one).

    ``system.async_mapping=True`` is the reference's mapping thread: KF
    jobs go to a worker and the tracker never waits on the LBA; the
    drivers pick corrections up at the next KF. With ``False`` every job
    runs inline and returns its summary. To the loop closer it is the map
    handler (``_lock``, ``state``)."""

    def __init__(self, cfg: SlamConfig, cam: StereoCamera, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cam = cam
        self.state = init_map_state(cfg, self.device)
        self._dist = (DistLBA(cfg, cam, device=self.device)
                      if cfg.mapping.distributed else None)
        self._records = []          # KeyFrameSummary | Pending* | list
        self._next_slot = 0
        self._lock = threading.Lock()
        self._async = cfg.system.async_mapping
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._fused = None          # the chunk-backend step, built lazily
        self._fused_probe_on = None
        self._error: Optional[BaseException] = None
        # dispatch handshake (see wait_dispatched)
        self._disp_cv = threading.Condition()
        self._jobs_submitted = 0
        self._jobs_dispatched = 0
        # the worker launches on the creating thread's stream: one stream
        # order for the tracker's kernels and the map's
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        if self._async:
            self._worker = threading.Thread(target=self._run_worker,
                                            daemon=True)
            self._worker.start()

    # -- keyframe ingestion --------------------------------------------------
    def add_keyframe(self, pts, lns, T_w_kf, run_lba: bool = True,
                     on_done=None) -> Optional[KeyFrameSummary]:
        """``on_done(record)`` runs after the KF is processed: on the worker
        in async mode (the record a fetch-free PendingSummary), inline in
        sync mode (a KeyFrameSummary, which is also returned)."""
        if self._async:
            self._queue.put(("kf", pts, lns, np.asarray(T_w_kf), run_lba,
                             on_done))
            return None
        summary = self._process(pts, lns, T_w_kf, run_lba)
        if on_done is not None:
            on_done(summary)
        return summary

    def add_keyframes_fused(self, all_pts, all_lns, frame_idx, T_rels,
                            loop_closer=None) -> None:
        """A chunk's keyframes through the chunk-backend step
        (``chunk_backend.make_chunk_backend``), at most ``kf_batch`` a
        dispatch. ``all_pts`` / ``all_lns`` are the chunk's feature stacks
        (``vo_chunk(keep_feats=True)``), ``frame_idx`` the keyframes'
        frames and ``T_rels[j]`` KF j's tracker pose relative to the
        previous KF. With ``loop_closer`` the BoW probe rides the step and
        its host logic runs from one fetch of the probe rows."""
        job = ("batch", all_pts, all_lns, list(frame_idx),
               [np.asarray(T, np.float32) for T in T_rels], loop_closer)
        if self._async:
            with self._disp_cv:
                self._jobs_submitted += 1
            self._queue.put(job)
            return
        self._process_batch(*job[1:])

    def _run_worker(self):
        if self._stream is None:
            return self._work_loop()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            return self._work_loop()

    def _fault(self, where: str, e: BaseException) -> None:
        """Print a worker failure and keep the first one for wait_idle,
        wait_dispatched and close to raise."""
        print(f"[map_handler] {where} error: {e!r}")
        traceback.print_exc()
        if self._error is None:
            self._error = e

    def _raise_fault(self) -> None:
        if self._error is not None:
            raise RuntimeError("the mapping worker failed") from self._error

    def _work_loop(self):
        """Pipelined worker: a batch job's step is dispatched at once, but
        its probe handling (the fetch and the loop closer's host logic) is
        deferred while more jobs are queued, up to 3 entries, and then
        flushed in order with one fetch. While a closure is imminent
        (``LoopCloser.closure_imminent``) it reverts to the strict
        interleave: sub-batches of 2, each handled before the next is
        dispatched."""
        pending = []          # deferred probe entries, ordered
        while True:
            if pending:
                try:
                    job = self._queue.get_nowait()
                except queue.Empty:
                    self._flush_probes(pending)
                    continue
            else:
                job = self._queue.get()
            if job is None:
                self._flush_probes(pending)
                self._queue.task_done()
                return
            try:
                if job[0] == "kf":
                    self._flush_probes(pending)   # keep strict KF order
                    summary = self._process(*job[1:5])
                    if job[5] is not None:
                        job[5](summary)
                    self._queue.task_done()
                else:
                    lc = job[5]
                    eager = (lc is not None
                             and getattr(lc, "closure_imminent", False))
                    if eager:
                        self._flush_probes(pending)
                        self._dispatch_batch(
                            *job[1:], handler=self._handle_probe_entry,
                            granularity=2)
                        self._mark_dispatched()
                        self._queue.task_done()
                    else:
                        entries = self._dispatch_batch(*job[1:])
                        self._mark_dispatched()
                        if entries:
                            pending.extend(entries)
                        else:
                            self._queue.task_done()
                        if len(pending) >= 3:     # bound pipeline depth
                            self._flush_probes(pending)
            except Exception as e:
                self._fault("worker", e)
                if job[0] != "kf":
                    self._mark_dispatched()
                self._queue.task_done()

    def _mark_dispatched(self):
        with self._disp_cv:
            self._jobs_dispatched += 1
            self._disp_cv.notify_all()

    def wait_dispatched(self, timeout: float = 30.0) -> None:
        """Block until every submitted batch job's step has been
        DISPATCHED (its probe handling may still be pending), so that the
        chunked tracker's next chunk queues behind the map's kernels. Past
        ``timeout`` seconds with the worker alive it returns; a dead worker
        or a failed job raises."""
        if not self._async:
            return
        deadline = time.monotonic() + timeout
        with self._disp_cv:
            while self._jobs_dispatched < self._jobs_submitted:
                self._raise_fault()
                if self._worker is None or not self._worker.is_alive():
                    raise RuntimeError(
                        "the mapping worker is not running: "
                        f"{self._jobs_submitted - self._jobs_dispatched} "
                        "job(s) never dispatched")
                if (not self._disp_cv.wait(timeout=0.2)
                        and time.monotonic() > deadline):
                    return
        self._raise_fault()

    def _flush_probes(self, pending):
        """Handle every deferred probe entry with ONE batched fetch."""
        if not pending:
            return
        entries = list(pending)
        pending.clear()
        try:
            lc = entries[0][4]
            if lc is not None:
                lc.on_probe_batches(
                    self, [(e[0], e[1], e[2], e[3]) for e in entries])
        except Exception as e:
            self._fault("probe", e)
        finally:
            for e in entries:
                if e[5]:
                    self._queue.task_done()

    def _handle_probe_entry(self, entry):
        slots, scores, covis, poses, loop_closer, last_of_job = entry
        try:
            if loop_closer is not None:
                loop_closer.on_probe_batch(self, slots, scores, covis,
                                           poses)
        except Exception as e:
            self._fault("probe", e)
        finally:
            if last_of_job:
                self._queue.task_done()

    def _check_capacity(self, n_new: int = 1) -> None:
        """Loud failure instead of the silent no-op insert a full KF array
        would make. The fused driver (FusedPLSLAM) recycles retired slots
        by compaction; this path fails fast with guidance."""
        if self._next_slot + n_new > self.cfg.mapping.max_kfs:
            raise RuntimeError(
                f"KF capacity exhausted: slot {self._next_slot} + "
                f"{n_new} > mapping.max_kfs={self.cfg.mapping.max_kfs}. "
                "Raise mapping.max_kfs, or use the fused driver "
                "(system.fused_slam=True), which compacts retired "
                "keyframe slots for unbounded sequences.")

    def _process(self, pts, lns, T_w_kf, run_lba_flag):
        self._check_capacity(1)
        T = torch.from_numpy(np.array(T_w_kf, np.float32)).to(self.device)
        with self._lock:
            if self._dist is not None:
                state, diag, c0, c1 = mapping_step_distributed(
                    self.state, pts, lns, T, self.cam, self.cfg, self._dist,
                    run_lba_flag=bool(run_lba_flag))
            else:
                state, diag, c0, c1 = mapping_step(
                    self.state, pts, lns, T, self.cam, self.cfg,
                    run_lba_flag=bool(run_lba_flag))
            self.state = state
            slot = self._next_slot
            self._next_slot += 1
            idx = diag["kf_slot"].reshape(1).long()
            refs = (state.kf_pose.index_select(0, idx)[0],
                    diag["n_map_matches"], diag["n_new_points"], c0, c1,
                    diag.get("lba_pt_overflow", 0),
                    diag.get("lba_ln_overflow", 0))
            if self._async:
                rec = PendingSummary(slot, refs)   # no fetch on the worker
            else:
                rec = _materialize(slot, refs)
            self._records.append(rec)
            return rec

    def _get_fused(self, loop_closer):
        probe_on = loop_closer is not None
        if self._fused is None or self._fused_probe_on != probe_on:
            from plslam_tpu_torch.backend.chunk_backend import (
                make_chunk_backend)
            voc_p = loop_closer.db.voc_p if probe_on else None
            voc_l = loop_closer.db.voc_l if probe_on else None
            self._fused = make_chunk_backend(
                self.cam, self.cfg, self.cfg.system.kf_batch, voc_p, voc_l)
            self._fused_probe_on = probe_on
        return self._fused

    def _dispatch_batch(self, all_pts, all_lns, frame_idx, T_list,
                        loop_closer, handler=None, granularity=None):
        """Dispatch one batch job's step(s). With ``handler`` each
        sub-batch's probe entry is handled before the next sub-batch is
        dispatched (a loop correction lands before later KFs anchor to
        stale poses); without it the entries are returned for deferred
        handling. ``granularity`` < kf_batch splits the job into smaller
        (padded) sub-batches."""
        kmax = self.cfg.system.kf_batch
        g = min(granularity or kmax, kmax)
        self._check_capacity(len(frame_idx))
        fused = self._get_fused(loop_closer)
        entries = []
        for off in range(0, len(frame_idx), g):
            sub_i = frame_idx[off:off + g]
            sub_T = T_list[off:off + g]
            n = len(sub_i)
            meta = np.zeros((kmax, 18), np.float32)
            meta[:n, 0] = sub_i
            meta[:n, 1] = 1.0
            meta[:, 2:] = np.eye(4, dtype=np.float32).reshape(-1)
            meta[:n, 2:] = np.stack(sub_T).reshape(n, 16)
            bows = (None, None)
            if loop_closer is not None:
                # the probe writes the database's rows in place
                bows = (loop_closer.db.bows_p, loop_closer.db.bows_l)
            with self._lock:
                state, _, _, scores, covis, poses, stats = fused(
                    self.state, *bows, all_pts, all_lns, meta)
                self.state = state
                slots = tuple(range(self._next_slot, self._next_slot + n))
                self._next_slot += n
                self._records.append(PendingBatch(slots, (poses, stats)))
            entry = [slots, scores, covis, poses, loop_closer, False]
            if handler is not None:
                handler(entry)
            else:
                entries.append(entry)
        if entries:
            entries[-1][-1] = True      # task_done after the last entry
        return entries

    def _process_batch(self, all_pts, all_lns, frame_idx, T_list,
                       loop_closer):
        """Sync mode: each sub-batch's probes handled inline, between the
        dispatches (sub-batches of 2 with loops on, so corrections land
        between insertions)."""
        def handle(entry):
            slots, scores, covis, poses, lc, _ = entry
            if lc is not None:
                lc.on_probe_batch(self, slots, scores, covis, poses)
        self._dispatch_batch(all_pts, all_lns, frame_idx, T_list,
                             loop_closer, handler=handle,
                             granularity=2 if loop_closer else None)

    @property
    def summaries(self) -> List[KeyFrameSummary]:
        """Per-KF summaries, fetched on access."""
        with self._lock:
            out = []
            for i, r in enumerate(self._records):
                if isinstance(r, PendingSummary):
                    self._records[i] = r = _materialize(r.slot, r.refs)
                elif isinstance(r, PendingBatch):
                    self._records[i] = r = _materialize_batch(r.slots,
                                                              r.refs)
                out.extend(r if isinstance(r, list) else [r])
            return out

    # -- queries -------------------------------------------------------------
    def backlog(self) -> int:
        """Jobs queued or running on the worker (0 in sync mode)."""
        return self._queue.unfinished_tasks if self._async else 0

    def wait_idle(self) -> None:
        """Block until every queued job (and its on_done hook) has
        finished (finishSLAM parity); raises the worker's first failure,
        or if the worker stopped with jobs left."""
        if self._async:
            q = self._queue
            with q.all_tasks_done:
                while q.unfinished_tasks:
                    if self._worker is None or not self._worker.is_alive():
                        raise RuntimeError(
                            "the mapping worker is not running: "
                            f"{q.unfinished_tasks} job(s) left")
                    q.all_tasks_done.wait(timeout=0.2)
        self._raise_fault()

    def kf_poses(self) -> np.ndarray:
        with self._lock:
            n = int(self.state.n_kfs)
            return self.state.kf_pose[:n].cpu().numpy()

    def latest_kf_pose(self, slot: int) -> np.ndarray:
        with self._lock:
            return self.state.kf_pose[slot].cpu().numpy()

    def n_landmarks(self) -> Tuple[int, int]:
        with self._lock:
            return (int(self.state.pt_valid.sum()),
                    int(self.state.ln_valid.sum()))

    def close(self) -> None:
        """Stop the worker after the jobs queued before; raises its first
        failure."""
        if self._async and self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=60.0)
            if self._worker.is_alive():
                raise RuntimeError("the mapping worker did not stop in 60 s")
            self._worker = None
        self._raise_fault()
