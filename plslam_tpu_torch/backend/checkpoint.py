"""Map checkpoint and resume.

Port of ``plslam_tpu/backend/checkpoint.py``: an npz snapshot of the
MapState (``state_<field>``), the config as JSON bytes (``config_json``)
and the caller's extra arrays (``extra_<k>``). Every field is written in
the reference's dtype (the packed descriptor words as uint32, ids as
int32), so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from plslam_tpu_torch import convert
from plslam_tpu_torch.backend.map import MapState
from plslam_tpu_torch.config import SlamConfig

# the fields the reference keeps as uint32 words (the port: int32 views)
_U32 = ("pt_desc_ring", "ln_desc_ring", "kf_pt_desc", "kf_ln_desc")


def _host(name: str, t) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in _U32 else a


def save_map(path: str, state: MapState, cfg: SlamConfig,
             extra: dict = None) -> None:
    arrays = {f"state_{name}": _host(name, v)
              for name, v in zip(MapState._fields, state)}
    arrays["config_json"] = np.frombuffer(
        json.dumps(cfg.to_dict()).encode(), dtype=np.uint8)
    if extra:
        for k, v in extra.items():
            arrays[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device) -> Tuple[MapState, SlamConfig, dict]:
    """(MapState on ``device``, config, extra arrays) of a checkpoint."""
    z = np.load(path)
    cfg = SlamConfig().with_updates(
        json.loads(bytes(z["config_json"]).decode()))
    state = convert.map_state_from_numpy(
        {name: z[f"state_{name}"] for name in MapState._fields}, device)
    extra = {k[len("extra_"):]: z[k] for k in z.files
             if k.startswith("extra_")}
    return state, cfg, extra
