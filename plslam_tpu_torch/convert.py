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
