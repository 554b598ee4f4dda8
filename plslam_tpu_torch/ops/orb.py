"""Steered-BRIEF (ORB-style) descriptors over pyramid levels (kernel C, K5).

Port of ``plslam_tpu/ops/orb.py::describe_multilevel``. The sampling
tables are regenerated here with the reference's seed and arithmetic
(the tests hold them equal to the reference's). The half-res moment maps
go through kernel A (both maps of a level in one paired launch); then
:func:`orient_and_describe` is one launch of the hand-written kernel of
``csrc/orb.cu`` on CUDA tensors, from the keypoints to the orientation
(``atan2`` of two moments read at each keypoint), its 32-bin
quantisation and the 64-point pool with its 256 pair tests, reading the
levels where they lie. Its plain version (the levels concatenated, torch
gathers, ``atan2``, :func:`angle_bins`, :func:`pool_bits_plain`) runs
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

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
# the kernel's copies: each (dy, dx) entry as one int16 dy << 8 | dx & 0xff,
# and lane l's eight pairs 8l .. 8l + 7 as 16 bytes (p0, p1, p0, p1, ...)
_ROT_PACKED = (_ROT_TABLES[..., 0] * 256 + (_ROT_TABLES[..., 1] & 0xFF)
               ).astype(np.int16)
_PAIRS_BY_LANE = PAIRS.astype(np.uint8).reshape(32, 16)
MAX_LEVELS = 8            # the kernel's level table
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
    the 64 rotated offsets of its angle bin around its flat center. CPU
    tensors only: on the card the sampling is part of the one launch of
    :func:`orient_and_describe`."""
    if flat.device.type != "cpu":
        raise ValueError("pool_bits runs on CPU tensors only; on CUDA "
                         "tensors use orient_and_describe")
    return pool_bits_plain(flat, center, width, bins)


def _bases(shapes) -> List[int]:
    out = [0]
    for (h, w) in shapes:
        out.append(out[-1] + h * w)
    return out[:-1]


def orient_and_describe_plain(levels: Sequence[torch.Tensor],
                              m10: torch.Tensor, m01: torch.Tensor,
                              half_shapes: Sequence[Tuple[int, int]],
                              uv: torch.Tensor, octave: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """See :func:`orient_and_describe`: the levels concatenated, the
    per-keypoint tables gathered, ``atan2``, :func:`angle_bins` and
    :func:`pool_bits_plain`."""
    N = uv.shape[0]
    dev = uv.device
    n_lvl = len(levels)
    full_shapes = [tuple(lvl.shape[-2:]) for lvl in levels]
    flat_img = torch.cat([lvl.reshape(N, -1) for lvl in levels], dim=1)

    def table(vals):
        return _on(np.asarray(vals, np.int32), dev)

    oct_i = torch.clamp(octave, 0, n_lvl - 1).long()
    fW = table([s[1] for s in full_shapes])[oct_i]
    fH = table([s[0] for s in full_shapes])[oct_i]
    fB = table(_bases(full_shapes))[oct_i]
    hW = table([s[1] for s in half_shapes])[oct_i]
    hH = table([s[0] for s in half_shapes])[oct_i]
    hB = table(_bases(half_shapes))[oct_i]

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
    bits = pool_bits_plain(flat_img, center, fW.to(torch.int32),
                           angle_bins(theta))
    return bits, theta


def orient_and_describe(levels: Sequence[torch.Tensor], m10: torch.Tensor,
                        m01: torch.Tensor,
                        half_shapes: Sequence[Tuple[int, int]],
                        uv: torch.Tensor, octave: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orientation and descriptor bits of K keypoints an image.

    levels: the pyramid, (N, h_i, w_i) each; m10, m01 (N, sum of the half
    shapes' pixels): the half-res moment maps of the levels, level i's at
    the columns from the sum of the half shapes before it; uv (N, K, 2)
    level-local; octave (N, K) int32 (clamped to the levels). Returns
    (bits (N, K, 256) u8, theta (N, K) f32). On CUDA tensors one
    ``orb_describe`` launch reads the levels where they lie (at most
    :data:`MAX_LEVELS`)."""
    if uv.device.type == "cpu":
        return orient_and_describe_plain(levels, m10, m01, half_shapes, uv,
                                         octave)
    N, K = octave.shape
    uv, octave = uv.contiguous(), octave.contiguous()
    n_lvl = len(levels)
    if not 1 <= n_lvl <= MAX_LEVELS:
        raise ValueError(f"orient_and_describe takes 1 to {MAX_LEVELS} "
                         f"levels, got {n_lvl}")
    if len(half_shapes) != n_lvl:
        raise ValueError("orient_and_describe: one half shape a level")
    n_half = sum(h * w for h, w in half_shapes)
    native.require(m10, "orient_and_describe m10", torch.float32,
                   (N, n_half))
    native.require(m01, "orient_and_describe m01", torch.float32,
                   (N, n_half))
    native.require(uv, "orient_and_describe uv", torch.float32, (N, K, 2))
    native.require(octave, "orient_and_describe octave", torch.int32, (N, K))
    rows = []
    for lvl, half, (hh, hw) in zip(levels, _bases(half_shapes), half_shapes):
        h, w = lvl.shape[-2:]
        native.require(lvl, "orient_and_describe level", torch.float32,
                       (N, h, w))
        if min(h, w) < 2 * PATCH_HALF + 1:
            raise ValueError(f"orient_and_describe: level {h}x{w} is smaller "
                             f"than the {2 * PATCH_HALF + 1}px ORB patch")
        rows += [lvl.data_ptr(), h, w, half, hh, hw]
    # read by the C entry during the call, into the kernel's parameters
    table = (ctypes.c_longlong * len(rows))(*rows)
    bits = torch.empty((N, K, N_BITS), dtype=torch.uint8, device=uv.device)
    theta = torch.empty((N, K), dtype=torch.float32, device=uv.device)
    native.launch("orb_describe", ctypes.addressof(table), n_lvl, m10, m01,
                  n_half, uv, octave, _on(_ROT_PACKED, uv.device),
                  _on(_PAIRS_BY_LANE, uv.device), bits, theta, N, K)
    return bits, theta


def moment_maps(levels: Sequence[torch.Tensor]):
    """The half-res moment maps of the levels: each level resized to half
    (kernel A) and both 15-tap moment filters of it in one paired launch,
    written straight into the levels' concatenated buffers. Returns (m10,
    m01 (N, sum of the half shapes' pixels), half_shapes)."""
    N = levels[0].shape[0]
    halves = [resize_bilinear(lvl, (lvl.shape[-2] // 2, lvl.shape[-1] // 2))
              for lvl in levels]
    half_shapes = [tuple(h.shape[-2:]) for h in halves]
    n_half = sum(h * w for h, w in half_shapes)
    m10 = torch.empty((N, n_half), dtype=torch.float32,
                      device=levels[0].device)
    m01 = torch.empty_like(m10)
    for h, base, (hh, hw) in zip(halves, _bases(half_shapes), half_shapes):
        cols = slice(base, base + hh * hw)
        separable_filter2d_pair(h, _d_h, _ONES_H, _ONES_H, _d_h,
                                m10[:, cols], m01[:, cols])
    return m10, m01, half_shapes


def describe_multilevel(levels: List[torch.Tensor], uv: torch.Tensor,
                        octave: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Describe K keypoints per image across pyramid levels in one pass.

    levels: list of (N, h_i, w_i); uv (N, K, 2) in LEVEL-LOCAL pixels;
    octave (N, K) int32. Returns (bits (N, K, 256) u8, angle (N, K))."""
    full_shapes = [tuple(lvl.shape[-2:]) for lvl in levels]
    # center clipping keeps every +-PATCH_HALF sample inside its level
    assert all(s[0] >= 2 * PATCH_HALF + 1 and s[1] >= 2 * PATCH_HALF + 1
               for s in full_shapes), (
        f"pyramid level smaller than the {2*PATCH_HALF+1}px ORB patch: "
        f"{full_shapes} — drop levels below that at pyramid construction")
    m10, m01, half_shapes = moment_maps(levels)
    return orient_and_describe(levels, m10, m01, half_shapes, uv, octave)


def orientations_at(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(N, H, W) images, (N, K, 2) pixels -> (N, K) intensity-centroid
    angles: the half-res moment maps of the image (kernel A, as
    :func:`moment_maps`) read at the rounded half pixels, ``atan2``."""
    m10, m01, ((hh, hw),) = moment_maps([img])
    u = torch.clamp(torch.round(uv[..., 0] * 0.5).long(), 0, hw - 1)
    v = torch.clamp(torch.round(uv[..., 1] * 0.5).long(), 0, hh - 1)
    idx = v * hw + u
    return torch.atan2(torch.gather(m01, 1, idx), torch.gather(m10, 1, idx))


def describe(img: torch.Tensor, uv: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Describe K keypoints an image on one (blurred) level: (N, H, W),
    (N, K, 2) -> (bits (N, K, 256) u8, angle (N, K)). The reference's
    single-level ``describe`` orients at :func:`orientations_at`'s angle,
    which is the multilevel path's at one level, so this is one
    ``orb_describe`` launch (kernel C) with every keypoint at octave 0."""
    octave = torch.zeros(uv.shape[:-1], dtype=torch.int32, device=uv.device)
    return describe_multilevel([img], uv.to(torch.float32), octave)
