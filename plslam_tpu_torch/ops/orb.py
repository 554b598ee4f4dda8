"""Steered-BRIEF (ORB-style) descriptors over pyramid levels (kernel C, K5).

Port of ``plslam_tpu/ops/orb.py::describe_multilevel``. The sampling
tables are regenerated here with the reference's seed and arithmetic
(the tests hold them equal to the reference's). The half-res moment maps
go through kernel A (both maps of a level in one paired launch), the
orientation (``atan2`` of two gathered moments)
and its 32-bin quantisation through PyTorch, and the 64-point pool gather
with the 256 pair tests through the hand-written kernel of
``csrc/orb.cu`` on CUDA tensors; its plain version runs only for CPU
tensors.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.ops.image import (_on, resize_bilinear,
                                         separable_filter2d_pair)

PATCH_HALF = 15           # 31x31 support, ORB standard
N_BITS = 256
N_POOL = 64               # distinct sample points per keypoint
N_ANGLE_BINS = 32
_PATTERN_RADIUS = 10.0    # rotated+rounded samples stay within +-15


def _make_pool_and_pairs():
    """Sample pool (64, 2) xy + (256, 2) pool-index pairs (seed 42)."""
    rng = np.random.default_rng(42)
    pool = rng.normal(0.0, _PATTERN_RADIUS / 2.0, size=(N_POOL, 2))
    norm = np.linalg.norm(pool, axis=-1, keepdims=True)
    pool = pool * np.minimum(1.0, _PATTERN_RADIUS / np.maximum(norm, 1e-6))
    pairs = set()
    out = []
    while len(out) < N_BITS:
        i, j = rng.integers(0, N_POOL, 2)
        if i == j or (i, j) in pairs or (j, i) in pairs:
            continue
        pairs.add((i, j))
        out.append((i, j))
    return pool.astype(np.float32), np.asarray(out, np.int32)


POOL, PAIRS = _make_pool_and_pairs()


def _make_rotated_tables() -> np.ndarray:
    """(BINS, 64, 2) int32 (dy, dx) integer offsets of the rotated pool."""
    out = np.empty((N_ANGLE_BINS, N_POOL, 2), np.int32)
    for a in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * a / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        x = c * POOL[:, 0] - s * POOL[:, 1]
        y = s * POOL[:, 0] + c * POOL[:, 1]
        out[a, :, 0] = np.clip(np.round(y), -PATCH_HALF, PATCH_HALF)
        out[a, :, 1] = np.clip(np.round(x), -PATCH_HALF, PATCH_HALF)
    return out


_ROT_TABLES = _make_rotated_tables()
# the reference's [dy row | dx row] layout of the same table
_ROT_DYDX = np.concatenate(
    [_ROT_TABLES[:, :, 0], _ROT_TABLES[:, :, 1]], axis=1).astype(np.float32)

# half-resolution moment kernels: 15 taps
_d_h = np.arange(-(PATCH_HALF // 2), PATCH_HALF // 2 + 1).astype(np.float32)
_ONES_H = np.ones_like(_d_h)


def angle_bins(theta: torch.Tensor) -> torch.Tensor:
    """Quantise angles to the 32 rotation bins: round half to even, then
    a modulo with the divisor's sign, as ``jnp.round``/``jnp.mod``."""
    scale = float(np.float32(N_ANGLE_BINS / (2.0 * math.pi)))
    return torch.remainder(torch.round(theta * scale),
                           N_ANGLE_BINS).to(torch.int32)


def pool_bits_plain(flat: torch.Tensor, center: torch.Tensor,
                    width: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """flat (N, L); center/width/bins (N, K) -> bits (N, K, 256) u8."""
    rot = torch.from_numpy(_ROT_TABLES).to(flat.device).long()
    off = rot[bins.long()]                                   # (N, K, 64, 2)
    idx = (center.long()[..., None] + off[..., 0] * width.long()[..., None]
           + off[..., 1])
    pool = torch.gather(flat, 1, idx.reshape(flat.shape[0], -1)).reshape(
        idx.shape)
    p = torch.from_numpy(PAIRS).to(flat.device).long()
    return (pool[..., p[:, 1]] > pool[..., p[:, 0]]).to(torch.uint8)


def pool_bits(flat: torch.Tensor, center: torch.Tensor, width: torch.Tensor,
              bins: torch.Tensor) -> torch.Tensor:
    """bit j of each keypoint = pool[p1_j] > pool[p0_j], the pool being
    the 64 rotated offsets of its angle bin around its flat center."""
    if flat.device.type == "cpu":
        return pool_bits_plain(flat, center, width, bins)
    N, L = flat.shape
    K = center.shape[1]
    native.require(flat, "pool_bits flat", torch.float32)
    for t, nm in ((center, "center"), (width, "width"), (bins, "bins")):
        native.require(t, f"pool_bits {nm}", torch.int32, (N, K))
    bits = torch.empty((N, K, N_BITS), dtype=torch.uint8, device=flat.device)
    native.launch("orb_describe", flat, center, width, bins,
                  _on(_ROT_TABLES, flat.device), _on(PAIRS, flat.device),
                  bits, N, K, L)
    return bits


def _bases(shapes) -> List[int]:
    out = [0]
    for (h, w) in shapes:
        out.append(out[-1] + h * w)
    return out[:-1]


def describe_multilevel(levels: List[torch.Tensor], uv: torch.Tensor,
                        octave: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Describe K keypoints per image across pyramid levels in one pass.

    levels: list of (N, h_i, w_i); uv (N, K, 2) in LEVEL-LOCAL pixels;
    octave (N, K) int. Returns (bits (N, K, 256) u8, angle (N, K))."""
    N = uv.shape[0]
    dev = uv.device
    n_lvl = len(levels)
    full_shapes = [tuple(lvl.shape[-2:]) for lvl in levels]
    # center clipping keeps every +-PATCH_HALF sample inside its level
    assert all(s[0] >= 2 * PATCH_HALF + 1 and s[1] >= 2 * PATCH_HALF + 1
               for s in full_shapes), (
        f"pyramid level smaller than the {2*PATCH_HALF+1}px ORB patch: "
        f"{full_shapes} — drop levels below that at pyramid construction")
    halves = [resize_bilinear(lvl, (s[0] // 2, s[1] // 2))
              for lvl, s in zip(levels, full_shapes)]
    half_shapes = [tuple(h.shape[-2:]) for h in halves]
    # both moment maps of a level in one filter launch, written straight
    # into the levels' concatenated buffers
    half_bases = _bases(half_shapes)
    n_half = sum(h * w for h, w in half_shapes)
    m10 = torch.empty((N, n_half), dtype=torch.float32, device=dev)
    m01 = torch.empty_like(m10)
    for h, base, (hh, hw) in zip(halves, half_bases, half_shapes):
        cols = slice(base, base + hh * hw)
        separable_filter2d_pair(h, _d_h, _ONES_H, _ONES_H, _d_h,
                                m10[:, cols], m01[:, cols])
    flat_img = torch.cat([lvl.reshape(N, -1) for lvl in levels], dim=1)

    def table(vals):
        return _on(np.asarray(vals, np.int32), dev)

    oct_i = torch.clamp(octave, 0, n_lvl - 1).long()
    fW = table([s[1] for s in full_shapes])[oct_i]
    fH = table([s[0] for s in full_shapes])[oct_i]
    fB = table(_bases(full_shapes))[oct_i]
    hW = table([s[1] for s in half_shapes])[oct_i]
    hH = table([s[0] for s in half_shapes])[oct_i]
    hB = table(half_bases)[oct_i]

    # orientation from the half-res moment maps
    u2 = torch.minimum(torch.clamp(torch.round(uv[..., 0] * 0.5).to(
        torch.int32), min=0), hW - 1)
    v2 = torch.minimum(torch.clamp(torch.round(uv[..., 1] * 0.5).to(
        torch.int32), min=0), hH - 1)
    hidx = (hB + v2 * hW + u2).long()
    theta = torch.atan2(torch.gather(m01, 1, hidx),
                        torch.gather(m10, 1, hidx))

    u = torch.minimum(torch.clamp(torch.round(uv[..., 0]).to(torch.int32),
                                  min=PATCH_HALF), fW - 1 - PATCH_HALF)
    v = torch.minimum(torch.clamp(torch.round(uv[..., 1]).to(torch.int32),
                                  min=PATCH_HALF), fH - 1 - PATCH_HALF)
    center = (fB + v * fW + u).to(torch.int32)
    bits = pool_bits(flat_img, center, fW.to(torch.int32).contiguous(),
                     angle_bins(theta).contiguous())
    return bits, theta
