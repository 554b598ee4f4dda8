"""Clamped row gathers (K7).

Port of ``plslam_tpu/ops/gather.py::take_mxu``. The reference computes
``vals[idx]`` as one-hot MXU contractions only because the TPU's gather
unit serialises per index; a GPU gathers natively, so this is plain
indexing with the same clamping to [0, n) and exact values.
"""

from __future__ import annotations

import torch


def take(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched ``vals[b, idx[b]]``: vals (B, n[, k]), idx (B, m) -> (B, m[, k]);
    out-of-range indices clamp to [0, n)."""
    n = vals.shape[1]
    i = torch.clamp(idx.long(), 0, n - 1)
    if vals.ndim == 2:
        return torch.gather(vals, 1, i)
    i = i[..., None].expand(i.shape + vals.shape[2:])
    return torch.gather(vals, 1, i)
