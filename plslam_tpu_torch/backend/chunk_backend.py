"""Per-chunk back-end: the keyframes of a chunk, in order.

Port of ``plslam_tpu/backend/chunk_backend.py::backend_slots`` as the fused
SLAM step calls it (``packed_desc=False``: the chunk's features carry
unpacked descriptors; ``probe``: the loop closer's per-KF BoW probe, or
None with loops off).
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

import torch

from plslam_tpu_torch.backend.map_handler import mapping_step_traced_lba
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


def backend_slots(state, all_pts, all_lns, frame_idx: List[int],
                  kf_valid: List[bool], T_rels: torch.Tensor, cam, cfg,
                  kmax: int, probe=None):
    """Returns (state, scores (kmax, F), covis (kmax, F), poses
    (kmax, 4, 4), stats (kmax, 7)); stats rows: [lba_cost0, lba_cost1,
    n_map_matches, n_new_points, lba_pt_overflow, lba_ln_overflow,
    kf_slot]. ``probe(state, slot)`` runs after each valid slot's mapping
    step, writes the slot's BoW rows in place and returns its (scores,
    covis)."""
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
        pts_j = _frame(all_pts, frame_idx[j])
        lns_j = _frame(all_lns, frame_idx[j])
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
