"""Line front end: detection, LBD description, stereo matching.

Port of ``plslam_tpu/frontend/stereo_lines.py``
(``detect_and_describe_lines``, ``_fuse_levels``, ``seg_y_overlap``,
``match_stereo_lines``), batched over images: segments carry a leading
N (images) or B (stereo pairs) axis.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.frontend.features import LineObservations, line_equation
from plslam_tpu_torch.ops import hamming, lbd, lines
from plslam_tpu_torch.ops.fast import top_k
from plslam_tpu_torch.ops.gather import take
from plslam_tpu_torch.ops.lines import sqrt_rn
from plslam_tpu_torch.ops.image import resize_bilinear

_PI = math.pi


def detect_kwargs(l, half: bool, diag: float) -> dict:
    """``detect_segments``' settings of one pass of the detector, at full
    resolution or on the half-res image (``half``), with the reference's
    gate scaling of each: the half-res pass applies the ``fld_*`` scales
    whether or not ``use_fld_lines`` is set."""
    h = 0.5 if half else 1.0
    return dict(
        max_lines=l.max_lines, tile=l.tile, grad_th=l.grad_th / 255.0 * h,
        min_support=l.min_support * (l.fld_support_scale if half else 1.0),
        elong_th=l.elong_th * (l.fld_elong_scale if half else 1.0),
        perp_spread_th=l.perp_spread_th, coherence_th=l.coherence_th,
        merge_iters=max(l.merge_iters * 3, 8),
        merge_ang_th=l.merge_ang_th, merge_dist_th=l.merge_dist_th,
        merge_gap_th=l.merge_gap_th * (l.fld_gap_scale if half else 1.0),
        min_length=l.min_line_length * diag * h)


def _detect(img: torch.Tensor, l, half: bool, diag: float,
            u8_wrap: bool = False) -> lines.Segments:
    return lines.detect_segments(img, **detect_kwargs(l, half, diag),
                                 u8_wrap=u8_wrap)


def _doubled(segs: lines.Segments) -> lines.Segments:
    return segs._replace(sp=segs.sp * 2.0, ep=segs.ep * 2.0)


def detect_and_describe_lines(imgs: torch.Tensor, cfg: SlamConfig,
                              u8_wrap: bool = False
                              ) -> Tuple[lines.Segments, torch.Tensor]:
    """(N, H, W) images -> segments (N, L) and LBD bits (N, L, 256).
    ``u8_wrap``: the images hold uint8 values, and the Sobel gradients of
    the full-resolution image wrap as the reference's uint8 arithmetic
    does (the half-res image is a float resize, unaffected)."""
    l = cfg.lines
    H, W = imgs.shape[-2:]
    diag = (H * H + W * W) ** 0.5
    small = None
    if l.use_fld_lines or l.scale_levels > 1 or l.lbd_half_res:
        small = resize_bilinear(imgs, (H // 2, W // 2))
    if l.use_fld_lines:
        segs = _doubled(_detect(small, l, True, diag))
    else:
        segs = _detect(imgs, l, False, diag, u8_wrap)
        if l.scale_levels > 1:
            coarse = _doubled(_detect(small, l, True, diag))
            segs = fuse_levels(segs, coarse, l)
    # the descriptor samples the image's Sobel maps, formed inside its one
    # launch (no gradient maps are allocated)
    if l.lbd_half_res:
        desc = lbd.describe_lines_image(
            small, segs.sp * 0.5, segs.ep * 0.5, n_bands=l.lbd_bands,
            band_width=max(l.lbd_band_width // 2, 3),
            n_samples=l.lbd_samples, samples_per_band=l.lbd_band_samples)
    else:
        desc = lbd.describe_lines_image(
            imgs, segs.sp, segs.ep, n_bands=l.lbd_bands,
            band_width=l.lbd_band_width, n_samples=l.lbd_samples,
            samples_per_band=l.lbd_band_samples, u8_wrap=u8_wrap)
    return segs, desc


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def pair_dang(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Undirected angles between lines a_i and b_j, (..., N, M)."""
    return lines.dang(a[..., :, None], b[..., None, :])


def fuse_levels(fine: lines.Segments, coarse: lines.Segments,
                l) -> lines.Segments:
    """Fuse two pyramid levels: a coarse segment is added only where no
    collinear overlapping fine segment already covers it."""
    dang = pair_dang(coarse.angle, fine.angle)
    dc = coarse.ep - coarse.sp
    length_c = torch.clamp(_norm2(dc), min=1e-6)
    u = dc / length_c[..., None]
    mid_c = 0.5 * (coarse.sp + coarse.ep)
    mid_f = 0.5 * (fine.sp + fine.ep)
    rel0 = mid_f[..., None, :, 0] - mid_c[..., :, None, 0]
    rel1 = mid_f[..., None, :, 1] - mid_c[..., :, None, 1]
    u0, u1 = u[..., 0, None], u[..., 1, None]
    off = torch.abs(-u1 * rel0 + u0 * rel1)
    proj = u0 * rel0 + u1 * rel1
    len_f = _norm2(fine.ep - fine.sp)
    overlap = torch.abs(proj) < 0.5 * (length_c[..., :, None]
                                       + len_f[..., None, :])
    covered = torch.any((dang < 2 * l.merge_ang_th)
                        & (off < 2.5 * l.merge_dist_th) & overlap
                        & fine.valid[..., None, :], dim=-1)
    keep_c = coarse.valid & ~covered
    score = torch.cat([torch.where(fine.valid, fine.score, -1.0),
                       torch.where(keep_c, 4.0 * coarse.score, -1.0)], -1)
    sc, top = top_k(score, l.max_lines)
    cat = lambda a, b: take(torch.cat([a, b], dim=1), top)
    return lines.Segments(sp=cat(fine.sp, coarse.sp),
                          ep=cat(fine.ep, coarse.ep),
                          angle=cat(fine.angle, coarse.angle),
                          score=torch.clamp(sc, min=0.0), valid=sc > 0)


def seg_y_overlap(sp_a, ep_a, sp_b, ep_b) -> torch.Tensor:
    """(..., N, 2) x (..., M, 2) -> (..., N, M) vertical overlap ratio."""
    alo = torch.minimum(sp_a[..., 1], ep_a[..., 1])[..., :, None]
    ahi = torch.maximum(sp_a[..., 1], ep_a[..., 1])[..., :, None]
    blo = torch.minimum(sp_b[..., 1], ep_b[..., 1])[..., None, :]
    bhi = torch.maximum(sp_b[..., 1], ep_b[..., 1])[..., None, :]
    inter = torch.clamp(torch.minimum(ahi, bhi) - torch.maximum(alo, blo),
                        min=0.0)
    denom = torch.clamp(torch.minimum(ahi - alo, bhi - blo), min=1e-6)
    return inter / denom


def not_horizontal(angle: torch.Tensor, th: float) -> torch.Tensor:
    """|mod(angle + pi/2, pi) - pi/2| > th, with ``jnp.mod``'s floating
    remainder (fmod, shifted into the divisor's sign)."""
    x = angle + _PI / 2
    r = torch.fmod(x, _PI)
    r = torch.where((r != 0) & (r < 0), r + _PI, r)
    return torch.abs(r - _PI / 2) > th


def match_stereo_lines(segs_l: lines.Segments, desc_l: torch.Tensor,
                       segs_r: lines.Segments, desc_r: torch.Tensor,
                       cam: StereoCamera, cfg: SlamConfig
                       ) -> LineObservations:
    """Stereo line matches of B pairs: LBD NN + ratio + mutual within
    angle, row-overlap and not-horizontal masks, endpoint disparities by
    intersecting the right line with the left endpoints' rows."""
    m = cfg.matching
    mask = ((pair_dang(segs_l.angle, segs_r.angle) < 0.3)
            & (seg_y_overlap(segs_l.sp, segs_l.ep, segs_r.sp, segs_r.ep)
               > m.stereo_overlap_th)
            & not_horizontal(segs_l.angle, m.line_horiz_th)[..., :, None])
    res = hamming.match_gated(desc_l, desc_r, segs_l.valid, segs_r.valid,
                              hamming.Mask(mask), m.max_hamming_l,
                              m.min_ratio_12_l, mutual=m.best_lr_matches)
    rsel = take(torch.cat([segs_r.sp, segs_r.ep], dim=-1),
                torch.clamp(res.idx, min=0))
    le_r = line_equation(rsel[..., :2], rsel[..., 2:])
    a, b, c = le_r[..., 0], le_r[..., 1], le_r[..., 2]
    safe_a = torch.where(torch.abs(a) < 1e-6, 1e-6, a)

    def row_intersect(pt):
        return -(b * pt[..., 1] + c) / safe_a

    sdisp = segs_l.sp[..., 0] - row_intersect(segs_l.sp)
    edisp = segs_l.ep[..., 0] - row_intersect(segs_l.ep)
    disp_ok = ((sdisp > m.min_disp) & (sdisp < m.max_disp)
               & (edisp > m.min_disp) & (edisp < m.max_disp))
    valid = res.valid & segs_l.valid & disp_ok
    sP = cam.back_project(segs_l.sp, torch.where(valid, sdisp, 1.0))
    eP = cam.back_project(segs_l.ep, torch.where(valid, edisp, 1.0))
    return LineObservations(
        sp=segs_l.sp, ep=segs_l.ep, le=line_equation(segs_l.sp, segs_l.ep),
        angle=segs_l.angle, sdisp=sdisp, edisp=edisp, sP=sP, eP=eP,
        desc=desc_l, score=segs_l.score, valid=valid)
