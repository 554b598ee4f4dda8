"""FAST-16 corners, NMS and grid-spread top-k (kernel B, K1 and K2).

Port of ``plslam_tpu/ops/fast.py``. On CUDA tensors two hand-written
kernels (``csrc/fast.cu``) do the per-pixel work: launch 1 the 16-tap
masks at both thresholds, the 9-arc test (from :func:`arc_table`) and the
SAD score, into ``torch.bool`` masks; launch 2 the
NMS, the border mask and the 8x8 block max/argmax of ``select_topk_grid``.
The per-cell and global top-k stay in PyTorch as a stable descending sort:
``lax.top_k`` puts the lower index first on ties, and ties are the rule
here (empty blocks score 0, padding -inf). The plain versions run only
for CPU tensors.

Images are batched: (N, H, W) f32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from plslam_tpu_torch import native

# Bresenham circle radius 3, clockwise from 12 o'clock: (dy, dx)
_CIRCLE = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

_ARC = 9  # contiguous taps required
_BLOCK = 8  # block of the max/argmax reduction before the cell top-k
# the arc table on each device it was asked for
_ARC_TABLES: Dict[torch.device, torch.Tensor] = {}


def _arc9_from_bitmask(m: torch.Tensor) -> torch.Tensor:
    """int32 bitmask (bits 0..15 = taps) -> any 9 circularly contiguous."""
    d = m | (m << 16)
    for _ in range(_ARC - 1):
        d = d & (d >> 1)
    return (d & 0xFFFF) != 0


@lru_cache(maxsize=1)
def arc_table() -> np.ndarray:
    """The FAST kernel's arc test as a table, (2048,) int32: bit ``m % 32``
    of word ``m // 32`` is ``_arc9_from_bitmask(m)``, for every 16-bit
    mask ``m`` (1,025 of the 65,536 hold 9 circularly contiguous bits)."""
    arc = _arc9_from_bitmask(torch.arange(1 << 16, dtype=torch.int32))
    words = np.packbits(arc.numpy(), bitorder="little").view("<u4")
    return words.astype(np.uint32).view(np.int32)


def _arc_table_on(device: torch.device) -> torch.Tensor:
    t = _ARC_TABLES.get(device)
    if t is None:
        t = torch.from_numpy(arc_table()).to(device)
        _ARC_TABLES[device] = t
    return t


def fast_score_map2_plain(img: torch.Tensor, th_hi: float, th_lo: float
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    H, W = img.shape[-2:]
    p = F.pad(img[:, None], (3, 3, 3, 3), mode="replicate")[:, 0]
    th_hi = float(np.float32(th_hi))
    th_lo = float(np.float32(th_lo))
    zero_i = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    bh_hi = bd_hi = bh_lo = bd_lo = zero_i
    sb = sd = torch.zeros_like(img)
    for i, (dy, dx) in enumerate(_CIRCLE.tolist()):
        tap = p[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
        diff = tap - img
        bit = 1 << i
        bh_hi = bh_hi | torch.where(diff > th_hi, bit, 0).to(torch.int32)
        bd_hi = bd_hi | torch.where(diff < -th_hi, bit, 0).to(torch.int32)
        bh_lo = bh_lo | torch.where(diff > th_lo, bit, 0).to(torch.int32)
        bd_lo = bd_lo | torch.where(diff < -th_lo, bit, 0).to(torch.int32)
        sb = sb + torch.clamp(diff - th_lo, min=0.0)
        sd = sd + torch.clamp(-diff - th_lo, min=0.0)
    corner_hi = _arc9_from_bitmask(bh_hi) | _arc9_from_bitmask(bd_hi)
    corner_lo = _arc9_from_bitmask(bh_lo) | _arc9_from_bitmask(bd_lo)
    return corner_hi, corner_lo, torch.maximum(sb, sd)


def fast_score_map2(img: torch.Tensor, th_hi: float, th_lo: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, H, W) -> (corner_hi, corner_lo) bool and score f32 (at th_lo)."""
    if img.device.type == "cpu":
        return fast_score_map2_plain(img, th_hi, th_lo)
    native.require(img, "fast_score_map2", torch.float32)
    N, H, W = img.shape
    chi = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    clo = torch.empty_like(chi)
    score = torch.empty_like(img)
    native.launch("fast_score", img, chi, clo, score,
                  _arc_table_on(img.device), N, H, W, float(th_hi),
                  float(th_lo))
    return chi, clo, score


def fast_score_map(img: torch.Tensor, th: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W) -> corner mask and SAD score at threshold ``th``: kernel
    B's ``fast_score`` with both thresholds equal."""
    corner, _, score = fast_score_map2(img, th, th)
    return corner, score


def nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """(N, H, W) bool: local maxima within a (2r+1)^2 window (-inf pad)."""
    w = 2 * radius + 1
    mx = F.max_pool2d(score[:, None], (1, w), stride=1, padding=(0, radius))
    mx = F.max_pool2d(mx, (w, 1), stride=1, padding=(radius, 0))
    return score >= mx[:, 0]


def _grid_dims(H: int, W: int, grid_rows: int, grid_cols: int
               ) -> Tuple[int, int]:
    """Cell size, rounded up to multiples of the reduction block."""
    cell_h = -(-(-(-H // grid_rows)) // _BLOCK) * _BLOCK
    cell_w = -(-(-(-W // grid_cols)) // _BLOCK) * _BLOCK
    return cell_h, cell_w


def nms_block_max_plain(score, corner_hi, corner_lo, radius, border,
                        Hb, Wb):
    N, H, W = score.shape
    by = (torch.arange(H, device=score.device) >= border) & (
        torch.arange(H, device=score.device) < H - border)
    bx = (torch.arange(W, device=score.device) >= border) & (
        torch.arange(W, device=score.device) < W - border)
    keep = nms(score, radius) & by[:, None] & bx[None, :]
    s_hi = torch.where(corner_hi & keep, score, 0.0)
    s_lo = torch.where(corner_lo & keep, score, 0.0)
    pad = (0, Wb * _BLOCK - W, 0, Hb * _BLOCK - H)

    def block_max(s):
        sp = F.pad(s, pad, value=-float("inf"))
        v = sp.reshape(N, Hb, _BLOCK, Wb, _BLOCK).permute(0, 1, 3, 2, 4)
        v = v.reshape(N, Hb, Wb, _BLOCK * _BLOCK)
        # torch.max returns the first index of the maximum (jnp.argmax)
        m, a = torch.max(v, dim=-1)
        return m, a.to(torch.int32)

    bs_hi, bi_hi = block_max(s_hi)
    bs_lo, bi_lo = block_max(s_lo)
    cnt = (F.pad(s_hi, pad) > 0).reshape(N, Hb, _BLOCK, Wb, _BLOCK).sum(
        dim=(2, 4), dtype=torch.int32)
    return bs_hi, bi_hi, bs_lo, bi_lo, cnt


def nms_block_max(score: torch.Tensor, corner_hi: torch.Tensor,
                  corner_lo: torch.Tensor, radius: int, border: int,
                  Hb: int, Wb: int):
    """Keep = NMS & border & corner; per 8x8 block of the -inf padded
    (Hb*8, Wb*8) kept-score planes, the max and first argmax (0..63) at
    both thresholds, and the count of kept high-threshold corners."""
    if score.device.type == "cpu":
        return nms_block_max_plain(score, corner_hi, corner_lo, radius,
                                   border, Hb, Wb)
    native.require(score, "nms_block_max", torch.float32)
    if not 0 <= radius <= 16:
        raise ValueError(f"nms radius {radius} outside the kernel's 0..16")
    N, H, W = score.shape
    # a bool mask is bytes of 0 or 1 already: viewed, not copied
    chi, clo = (c.view(torch.uint8) if c.dtype == torch.bool
                else c.to(torch.uint8) for c in (corner_hi, corner_lo))
    chi, clo = chi.contiguous(), clo.contiguous()
    dev = score.device
    bs_hi = torch.empty((N, Hb, Wb), dtype=torch.float32, device=dev)
    bs_lo = torch.empty_like(bs_hi)
    bi_hi = torch.empty((N, Hb, Wb), dtype=torch.int32, device=dev)
    bi_lo = torch.empty_like(bi_hi)
    cnt = torch.empty_like(bi_hi)
    native.launch("fast_nms_block", score, chi, clo, bs_hi, bi_hi, bs_lo,
                  bi_lo, cnt, N, H, W, Hb, Wb, radius, border)
    return bs_hi, bi_hi, bs_lo, bi_lo, cnt


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, lower index first
    on ties (a stable sort; ``torch.topk`` leaves tie order unspecified)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def select_topk_grid(bs: torch.Tensor, bi: torch.Tensor, k_total: int,
                     grid_rows: int, grid_cols: int, cell_h: int,
                     cell_w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cell top-q of the block maxima, then global top-k: the
    reference's ``select_topk_grid`` after its 8x8 block max/argmax,
    which kernel B's second launch computes (``nms_block_max``).

    Returns (uv (N, K, 2) f32 (x, y), score (N, K), valid (N, K))."""
    N = bs.shape[0]
    n_cells = grid_rows * grid_cols
    nbh, nbw = cell_h // _BLOCK, cell_w // _BLOCK

    def cellify(a):
        c = a.reshape(N, grid_rows, nbh, grid_cols, nbw)
        return c.permute(0, 1, 3, 2, 4).reshape(N, n_cells, nbh * nbw)

    cbs, cbi = cellify(bs), cellify(bi)
    q = min(max(2 * k_total // n_cells, 1), nbh * nbw)
    cs, ci = top_k(cbs, q)                                  # (N, cells, q)
    inner = torch.gather(cbi, 2, ci)
    cells = torch.arange(n_cells, device=bs.device)
    cell_r = (cells // grid_cols)[:, None]
    cell_c = (cells % grid_cols)[:, None]
    iy = cell_r * cell_h + (ci // nbw) * _BLOCK + inner // _BLOCK
    ix = cell_c * cell_w + (ci % nbw) * _BLOCK + inner % _BLOCK
    flat_s = cs.reshape(N, -1)
    k = min(k_total, flat_s.shape[1])
    ts, ti = top_k(flat_s, k)
    uv = torch.stack([torch.gather(ix.reshape(N, -1), 1, ti),
                      torch.gather(iy.reshape(N, -1), 1, ti)],
                     dim=-1).to(torch.float32)
    valid = ts > 0.0
    if k < k_total:
        pad = k_total - k
        uv = F.pad(uv, (0, 0, 0, pad))
        ts = F.pad(ts, (0, pad), value=-float("inf"))
        valid = F.pad(valid, (0, pad))
    return uv, ts, valid


def detect_fast(img: torch.Tensor, k_total: int, th: float, th_min: float,
                adaptive: bool, nms_radius: int, grid_rows: int,
                grid_cols: int, border: int = 16
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FAST on one pyramid level of N images -> (uv, score, valid), K fixed.

    Adaptive thresholding: the low-threshold map is used for an image only
    when the high one keeps fewer than k_total/2 corners."""
    th = float(np.float32(th))
    th_lo = float(np.float32(th_min if adaptive else th))
    corner_hi, corner_lo, score = fast_score_map2(img, th, th_lo)
    H, W = img.shape[-2:]
    cell_h, cell_w = _grid_dims(H, W, grid_rows, grid_cols)
    Hb, Wb = cell_h * grid_rows // _BLOCK, cell_w * grid_cols // _BLOCK
    bs_hi, bi_hi, bs_lo, bi_lo, cnt = nms_block_max(
        score, corner_hi, corner_lo, nms_radius, border, Hb, Wb)
    if adaptive:
        enough = (cnt.sum(dim=(1, 2)) >= k_total // 2)[:, None, None]
        bs = torch.where(enough, bs_hi, bs_lo)
        bi = torch.where(enough, bi_hi, bi_lo)
    else:
        bs, bi = bs_hi, bi_hi
    return select_topk_grid(bs, bi, k_total, grid_rows, grid_cols,
                            cell_h, cell_w)
