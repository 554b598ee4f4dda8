"""Per-chunk back-end: the keyframes of a chunk, in order.

Port of ``plslam_tpu/backend/chunk_backend.py``: ``backend_slots`` as the
fused SLAM step calls it (``packed_desc=False``: the chunk's features carry
unpacked descriptors; ``probe``: the loop closer's per-KF BoW probe, or
None with loops off), and ``make_chunk_backend``, the step the mapping
worker (``map_handler.MapHandler.add_keyframes_fused``) runs on a chunk of
``vo_chunk(keep_feats=True)``, whose descriptors are bit-packed
(``packed_desc=True``: slot j unpacks its frame's at slice time).
Slot j slices its frame's features out of the chunk, inserts the KF
relative to the previous KF's current map pose, and runs the mapping step
with the window LBA on every ``lba_kf_stride``-th valid slot counted from
the chunk's end (the last always solves). The slots run in order, so KF
j+1's map matching sees KF j's insertion and LBA. The slot flags are host
values (the fused step fetched the keyframe flags), so an empty slot is
skipped on the host instead of being masked on the device; its scores
and covisibility rows stay zero.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from plslam_tpu_torch.backend.map_handler import mapping_step_traced_lba
from plslam_tpu_torch.ops import hamming
from plslam_tpu_torch.tracking.batch_vo import _frame


def lba_slot_flags(kf_valid: List[bool], stride: int) -> List[bool]:
    """Which valid slots run the window LBA: every ``stride``-th counted
    from the chunk's end (MappingConfig.lba_kf_stride)."""
    stride = max(int(stride), 1)
    n_valid = sum(kf_valid)
    out, rank = [], -1
    for v in kf_valid:
        rank += int(v)
        out.append(bool(v) and (n_valid - 1 - rank) % stride == 0)
    return out


def _slice(feats, i: int, packed_desc: bool):
    """Frame ``i`` of a chunk's feature stack, descriptors unpacked."""
    out = _frame(feats, i)
    if packed_desc and out is not None:
        out = out._replace(desc=hamming.unpack_bits(out.desc))
    return out


def backend_slots(state, all_pts, all_lns, frame_idx: List[int],
                  kf_valid: List[bool], T_rels: torch.Tensor, cam, cfg,
                  kmax: int, probe=None, packed_desc: bool = False):
    """Returns (state, scores (kmax, F), covis (kmax, F), poses
    (kmax, 4, 4), stats (kmax, 7)); stats rows: [lba_cost0, lba_cost1,
    n_map_matches, n_new_points, lba_pt_overflow, lba_ln_overflow,
    kf_slot]. ``probe(state, slot)`` runs after each valid slot's mapping
    step, writes the slot's BoW rows in place and returns its (scores,
    covis). ``packed_desc``: the stacks' descriptors are bit-packed."""
    dev = T_rels.device
    f32 = torch.float32
    F = cfg.mapping.max_kfs
    lba_flags = lba_slot_flags(kf_valid, cfg.mapping.lba_kf_stride)
    scores = torch.zeros((kmax, F), dtype=f32, device=dev)
    covis = torch.zeros((kmax, F), dtype=f32, device=dev)
    poses, stats = [], []
    for j in range(kmax):
        if not kf_valid[j]:
            poses.append(torch.eye(4, dtype=f32, device=dev))
            stats.append(torch.zeros((7,), dtype=f32, device=dev))
            continue
        pts_j = _slice(all_pts, frame_idx[j], packed_desc)
        lns_j = _slice(all_lns, frame_idx[j], packed_desc)
        prev = torch.clamp(state.n_kfs - 1, min=0).reshape(1).long()
        T_w_kf = state.kf_pose.index_select(0, prev)[0] @ T_rels[j]
        state, diag, c0, c1, pt_ov, ln_ov = mapping_step_traced_lba(
            state, pts_j, lns_j, T_w_kf, cam, cfg, lba_flags[j])
        slot = diag["kf_slot"]
        if probe is not None:
            scores[j], covis[j] = probe(state, slot)
        poses.append(state.kf_pose.index_select(0, slot.reshape(1).long())[0])
        # the device-side KF slot: the host settles chunks after later
        # chunks were submitted, so only the step knows the numbering
        stats.append(torch.stack([
            torch.as_tensor(x, device=dev).to(f32) for x in (
                c0, c1, diag["n_map_matches"], diag["n_new_points"], pt_ov,
                ln_ov, slot)]))
    return state, scores, covis, torch.stack(poses), torch.stack(stats)


def make_chunk_backend(cam, cfg, kmax: int, voc_p=None, voc_l=None):
    """The chunk back-end step of the host-KF driver: returns
    ``step(state, bows_p, bows_l, all_pts, all_lns, meta) -> (state,
    bows_p, bows_l, scores (kmax, F), covis (kmax, F), poses (kmax, 4, 4),
    stats (kmax, 7))`` (``backend_slots``' stats columns).

    ``meta`` (kmax, 18), built on the host: [frame index, valid flag,
    T_rel flat 16] a slot, T_rel the keyframe's tracker pose relative to
    the previous keyframe (composed against that KF's current map pose).
    The slot flags stay host values; the T_rels go to the device in one
    copy. ``all_pts`` / ``all_lns`` are ``vo_chunk(keep_feats=True)``'s
    stacks (packed descriptors). With ``voc_p`` None the probe is left out
    and the scores and covisibility rows are zeros (``bows_p`` and
    ``bows_l`` are passed through); otherwise each valid slot's probe
    writes its BoW rows in place."""
    from plslam_tpu_torch.loop.loop_closer import probe_core
    has_lines = cfg.lines.has_lines

    def step(state, bows_p, bows_l, all_pts, all_lns, meta):
        meta = np.asarray(meta, np.float32)
        frame_idx = [int(i) for i in meta[:, 0]]
        kf_valid = [bool(v) for v in meta[:, 1] > 0.5]
        T_rels = torch.from_numpy(np.ascontiguousarray(
            meta[:, 2:]).reshape(kmax, 4, 4)).to(state.kf_pose.device)
        probe = None
        if voc_p is not None:
            probe = lambda st, slot: probe_core(
                voc_p, voc_l, cfg, has_lines, st, bows_p, bows_l,
                slot)[2:4]
        state, scores, covis, poses, stats = backend_slots(
            state, all_pts, all_lns, frame_idx, kf_valid, T_rels, cam, cfg,
            kmax, probe=probe, packed_desc=True)
        return state, bows_p, bows_l, scores, covis, poses, stats

    return step
