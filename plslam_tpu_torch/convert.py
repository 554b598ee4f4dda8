"""Carry state into the port from plain numpy arrays and dicts.

The reference's objects cross over as data only (``dataclasses.asdict`` of
its config, numpy arrays of its features), so this package never imports
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import (LineObservations,
                                                PointObservations)


def config_from_dict(d: Dict[str, Any]) -> SlamConfig:
    """``dataclasses.asdict`` of a reference ``SlamConfig`` -> the port's."""
    return SlamConfig().with_updates(d)


def camera_from_numpy(fx, fy, cx, cy, b, width, height) -> StereoCamera:
    cfg = dataclasses.replace(SlamConfig().camera, fx=float(fx), fy=float(fy),
                              cx=float(cx), cy=float(cy), baseline=float(b),
                              width=int(width), height=int(height))
    return StereoCamera.from_config(cfg)


_POINT_DTYPES = {"desc": torch.uint8, "octave": torch.int32,
                 "valid": torch.bool}


def points_from_numpy(arrays: Mapping[str, np.ndarray],
                      device) -> PointObservations:
    """Dict of PointObservations field arrays -> tensors on ``device``."""
    return PointObservations(**{
        f: torch.from_numpy(np.array(arrays[f])).to(
            device=device, dtype=_POINT_DTYPES.get(f, torch.float32))
        for f in PointObservations._fields})


_LINE_DTYPES = {"desc": torch.uint8, "valid": torch.bool}


def lines_from_numpy(arrays: Mapping[str, np.ndarray],
                     device) -> LineObservations:
    """Dict of LineObservations field arrays -> tensors on ``device``."""
    return LineObservations(**{
        f: torch.from_numpy(np.array(arrays[f])).to(
            device=device, dtype=_LINE_DTYPES.get(f, torch.float32))
        for f in LineObservations._fields})


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint32:          # packed descriptor words
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


_MAP_BOOL = ("kf_valid", "pt_valid", "ln_valid")
_MAP_INT = ("n_kfs", "pt_nobs", "pt_last_kf", "pt_first_kf", "pt_desc_ring",
            "pt_ring_n", "ln_nobs", "ln_last_kf", "ln_first_kf",
            "ln_desc_ring", "ln_ring_n", "obs_pt_lm", "obs_ln_lm",
            "kf_pt_desc", "kf_ln_desc")
_MAP_U8 = ("pt_desc", "ln_desc")


def map_state_from_numpy(arrays: Mapping[str, np.ndarray], device):
    """Dict of MapState field arrays (the reference's
    ``{f: np.asarray(x) for f, x in state._asdict().items()}``) -> the
    port's MapState on ``device``; uint32 descriptor words keep their bit
    patterns as int32."""
    from plslam_tpu_torch.backend.map import MapState

    def dt(f):
        return (torch.bool if f in _MAP_BOOL else torch.int32
                if f in _MAP_INT else torch.uint8 if f in _MAP_U8
                else torch.float32)
    return MapState(**{f: _tensor(arrays[f], dt(f), device)
                       for f in MapState._fields})


def crit_carry_from_numpy(arrays: Mapping[str, np.ndarray], device):
    """Dict of CritCarry field arrays -> the port's CritCarry."""
    from plslam_tpu_torch.backend.fused_slam import CritCarry
    dts = {"have_cov": torch.bool, "have_ef": torch.bool,
           "frames": torch.int32}
    return CritCarry(**{f: _tensor(arrays[f], dts.get(f, torch.float32),
                                   device) for f in CritCarry._fields})


def vocabulary_from_numpy(levels, idf, k: int, device, origin: str = ""):
    """A reference Vocabulary's per-level (k^(l+1), 256) uint8 centroid
    bits and (n_leaves,) idf weights -> the port's Vocabulary."""
    from plslam_tpu_torch.loop.vocabulary import _from_levels
    return _from_levels([np.asarray(c) for c in levels], np.asarray(idf), k,
                        origin, device)


def pose_graph_from_numpy(arrays: Mapping[str, np.ndarray], device):
    """Dict of PoseGraph field arrays -> the port's PoseGraph."""
    from plslam_tpu_torch.loop.pose_graph import PoseGraph
    dts = {"pose_valid": torch.bool, "edge_i": torch.int32,
           "edge_j": torch.int32}
    return PoseGraph(**{f: _tensor(arrays[f], dts.get(f, torch.float32),
                                   device) for f in PoseGraph._fields})


_LBA_DTYPES = {"kf_fixed": torch.bool, "kf_valid": torch.bool,
               "obs_pt_id": torch.int32, "obs_ln_sid": torch.int32,
               "obs_ln_eid": torch.int32}


def lba_problem_from_numpy(arrays: Mapping[str, np.ndarray], device):
    """Dict of LBAProblem field arrays (a reference problem's, bucketed or
    not) -> the port's LBAProblem on ``device``."""
    from plslam_tpu_torch.backend.lba import LBAProblem
    return LBAProblem(**{f: _tensor(arrays[f], _LBA_DTYPES.get(
        f, torch.float32), device) for f in LBAProblem._fields})


def host_copies(*xs) -> list:
    """Host numpy copies of tensors in one device-to-host transfer (float64
    on the wire: exact for float32 and for integers below 2**53, each copy
    back in its own dtype); other values pass through."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    if not ts:
        return list(xs)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in ts]).cpu().numpy()
    out, off = [], 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n = x.numel()
            dt = torch.empty(0, dtype=x.dtype).numpy().dtype
            out.append(flat[off:off + n].reshape(tuple(x.shape)).astype(dt))
            off += n
        else:
            out.append(x)
    return out
