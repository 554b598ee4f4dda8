"""Analytic FLOP model of the hot programs, and the card's peak rates.

Port of ``plslam_tpu/utils/flops.py``: the same counting formulas, so the
same config gives the same float. It counts the DOMINANT dense-math terms
(descriptor-distance products, tile moments, the GN/LBA normal equations)
from the static config shapes: a deliberate ~+-30% catalog, not a
per-op audit, that turns measured device time into an order-of-magnitude
utilisation. Convention: 1 MAC = 2 FLOPs; gathers/compares are counted at
1 op/elem where they dominate a stage.

The rates are one NVIDIA H100 SXM's (NVIDIA's H100 data sheet, dense, no
sparsity, at its 700 W power limit): ``chip_smoke.py`` computes each
kernel's bound from them.
"""

from __future__ import annotations

from plslam_tpu_torch.config import SlamConfig

# HBM3 bandwidth of the H100 SXM (data sheet: 3.35 TB/s)
HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores (data sheet: 67 TFLOP/s FP32)
F32_OPS_PER_S = 67e12
# int8 on the tensor cores, dense (data sheet: 1,979 TOPS INT8 Tensor Core,
# 3,958 with sparsity): a Hamming distance of 256 bits is a 256-deep +-1
# product (the reference's own formulation)
INT8_OPS_PER_S = 1979e12


def extract_flops(cfg: SlamConfig, n_images: int) -> float:
    """Front-end (points + lines detect/describe + stereo match) for
    ``n_images`` single images (stereo frame = 2 images)."""
    H, W = cfg.camera.height, cfg.camera.width
    HW = H * W
    p, l = cfg.points, cfg.lines
    K, L = p.max_kpts, l.max_lines
    f = 0.0

    # -- points ----------------------------------------------------------
    # pyramid (bilinear matmul resizes) + FAST score/NMS passes
    pyr = sum((1.0 / p.orb_scale_factor ** (2 * i))
              for i in range(p.orb_nlevels))
    f += 4 * HW * pyr * 2          # resize MACs
    f += 24 * HW * pyr             # FAST circle compares + NMS windows
    # half-res orientation moment maps: two 15-tap separable filters
    f += 2 * 2 * 15 * (HW / 4) * pyr * 2
    # describe: 64-sample gather (counted 1/elem) + pair-diff matmul
    # + rotation one-hot
    f += K * 64
    f += K * 64 * 256 * 2
    f += K * 32 * 128 * 2

    # -- lines -----------------------------------------------------------
    if l.has_lines:
        t = l.tile
        scales = ([1.0, 0.25] if (l.scale_levels > 1
                                  and not l.use_fld_lines)
                  else [0.25] if l.use_fld_lines else [1.0])
        for s in scales:
            hw = HW * s
            h = H * (s ** 0.5)
            w_ = W * (s ** 0.5)
            f += 2 * 2 * 3 * hw * 2                 # sobel
            hb, wb = h / (t // 2), w_ / (t // 2)
            # pass 1 (orientation maps): 1 row + 1 col matmul on 2 planes
            f += (hb * h * 2 * w_ + 2 * hb * w_ * wb) * 2
            # pass 2 (8 moment maps): 3+2 row ops, 3+2+3 col ops
            f += (5 * hb * h * w_ + 8 * hb * w_ * wb) * 2
            n_t = hb * wb
            iters = max(l.merge_iters * 3, 8)
            f += iters * (n_t * n_t * 2 + 9 * 8 * n_t)   # CC hop + shifts
            R = min(8 * L, int(n_t))
            f += R * n_t * (7 + 4) * 2                    # refit contraction
            f += (2 * L) ** 2 * 12                        # segment merge
        # LBD (half-res gradients): samples * bands * 8 gradient stats
        f += L * l.lbd_samples * l.lbd_bands * l.lbd_band_samples * 16

    # -- stereo matching (per stereo PAIR, i.e. half the images) --------
    per_pair = (K * K * 256 * 2          # point hamming matmul
                + (L * L * 256 * 2 if l.has_lines else 0))
    return f * n_images + per_pair * (n_images / 2)


def tracking_flops(cfg: SlamConfig, n_pairs: int) -> float:
    """f2f matching + robust GN for ``n_pairs`` consecutive pairs."""
    p, l, t = cfg.points, cfg.lines, cfg.tracking
    K, L = p.max_kpts, l.max_lines
    passes = max(t.chunk_passes, 1)
    f = passes * (K * K * 256 * 2 + (L * L * 256 * 2 if l.has_lines else 0))
    n_res = 2 * K + (2 * L if l.has_lines else 0)
    iters = (t.max_iters + t.max_iters_ref) + \
        (passes - 1) * (t.lite_pass_iters + t.lite_pass_iters_ref)
    f += iters * n_res * (6 * 13 * 2 + 40)   # J assembly + 6x6 normal eqs
    return f * n_pairs


def backend_flops(cfg: SlamConfig, n_kfs: int, n_lba: int,
                  n_probes: int) -> float:
    """Mapping-side work: KF insertion matching, window LBA solves, BoW
    probes + covisibility counts."""
    m, p, l, lo = cfg.mapping, cfg.points, cfg.lines, cfg.loop
    K, L = p.max_kpts, l.max_lines
    P, F = m.max_points, m.max_kfs
    W = m.window_kfs + m.fixed_kfs
    Pl, Ml = m.lba_max_points, m.lba_max_lines

    # insertion: map->KF hamming + medoid rings + culling one-hot lookup
    ins = (P * K * 256 * 2 + (m.max_lines * L * 256 * 2 if l.has_lines
                              else 0)
           + P * m.desc_ring ** 2 * 8
           + F * K * P * 2 / 64        # cull take_mxu, bf16-packed cols
           )
    # one LBA LM iteration: residuals/jacobians + landmark binning
    # one-hot + Schur assembly + back-substitution
    lba_iter = (W * K * (3 * 6 * 3 * 2 + 60)
                + W * K * Pl * 30 * 2 / 64
                + 2 * W * L * (2 * Ml) * 30 * 2 / 64
                + W * Pl * 6 * 3 * 3 * 2 * 2
                + W * W * Pl * 6 * 6 * 3 * 2
                + (W * 6) ** 3 * 2 / 3)
    lba = m.lba_iters * lba_iter * 2     # + cost evals ~ one assembly
    # probe: vocabulary descent (both families) + L1 score + covis
    n_leaves = lo.vocab_k ** lo.vocab_l
    probe = ((K + (L if l.has_lines else 0))
             * lo.vocab_k * 256 * 2 * lo.vocab_l
             + 2 * F * n_leaves
             + F * K * P * 2 / 64)
    return ins * n_kfs + lba * n_lba + probe * n_probes


def vo_chunk_total(cfg: SlamConfig, chunk: int) -> float:
    return (extract_flops(cfg, 2 * chunk)
            + tracking_flops(cfg, chunk))


def slam_chunk_total(cfg: SlamConfig, chunk: int, kfs_per_chunk: float
                     ) -> float:
    stride = max(cfg.mapping.lba_kf_stride, 1)
    return (vo_chunk_total(cfg, chunk)
            + backend_flops(cfg, n_kfs=kfs_per_chunk,
                            n_lba=kfs_per_chunk / stride,
                            n_probes=kfs_per_chunk))
