"""Typed configuration tree of the PyTorch port.

The port's own copy of ``plslam_tpu/config.py`` (same classes, fields,
defaults and YAML loading), so that ``plslam_tpu_torch`` imports nothing
of the JAX package. ``convert.config_from_dict`` rebuilds it from
``dataclasses.asdict`` of the reference config.

Everything that determines a tensor shape (feature capacities, window
sizes, iteration counts) is a static Python int: every stage runs on
fixed-capacity, masked tensors, as in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _replace_from_dict(obj, d: Dict[str, Any]):
    """Recursively apply a (possibly nested) dict onto a dataclass tree."""
    updates = {}
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[k] = _replace_from_dict(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            updates[k] = tuple(v)  # YAML has no tuples; keep fields hashable
        else:
            updates[k] = v
    return dataclasses.replace(obj, **updates)


@dataclass(frozen=True)
class PointFeatureConfig:
    """ORB-style point front-end (reference: config.h ORB/point params)."""
    has_points: bool = True
    max_kpts: int = 1024            # static capacity (ref: orb_nfeatures)
    fast_th: int = 20               # FAST intensity threshold (ref: fast_th)
    adaptative_fast: bool = True    # lower threshold when too few corners
    fast_min_th: int = 7
    orb_nlevels: int = 4            # pyramid levels (ref: orb_nlevels=8; 4 is
                                    # enough at our per-level capacities)
    orb_scale_factor: float = 1.2
    grid_rows: int = 8              # bucketing grid for spatial spread
    grid_cols: int = 16
    nms_radius: int = 5             # non-max suppression window radius


@dataclass(frozen=True)
class LineFeatureConfig:
    """LSD/LBD-style line front-end (reference: config.h line params)."""
    has_lines: bool = True
    max_lines: int = 128            # static capacity (ref: lsd_nfeatures=300)
    use_fld_lines: bool = False     # fast detector variant (ref: FLD vs LSD):
                                    # detect on a 2x-downsampled image —
                                    # ~4x cheaper, coarser endpoints
    tile: int = 16                  # tile size for the tile-fit detector
    scale_levels: int = 2           # scale-space detection levels (ref:
                                    # LSDDetector::detect runs LSD on a
                                    # Gaussian pyramid): level 2 = a
                                    # half-res pass fused by collinear
                                    # merge, catching long blurred /
                                    # low-contrast structures whose
                                    # gradients are too diffuse at full
                                    # resolution. 1 = single-scale.
    min_line_length: float = 0.025  # fraction of image diagonal (ref: min_line_length)
    grad_th: float = 5.3            # gradient magnitude threshold (~LSD quant)
    anisotropy_th: float = 0.85     # structure-tensor anisotropy gate
    # per-tile gates (validated against ground-truth synthetic scenes;
    # the level-line reweighting pass carries most of the precision, so
    # the geometric gates can sit near the anti-aliased line PSF limits;
    # robustness re-validated on the degraded suite, tests/test_degraded)
    min_support: float = 0.4        # gradient mass per tile, x tile px
    elong_th: float = 1.8           # sqrt eigenvalue ratio of tile support
    perp_spread_th: float = 3.2     # px, perpendicular spread of support
    coherence_th: float = 0.55      # double-angle orientation coherence
    merge_iters: int = 3            # collinear merge passes across tiles
    merge_ang_th: float = 0.06      # rad, collinearity angle gate for merging
    merge_dist_th: float = 2.5      # px, perpendicular distance gate
    merge_gap_th: float = 24.0      # px, segment-level merge gap (occlusion
                                    # bridging; ref line-merge option role)
    # half-resolution (use_fld_lines) gate rescaling: detection evidence
    # at half-res carries ~half the gradient mass and blurred ridges, so
    # the corresponding gates shrink. These multiply min_support /
    # elong_th / merge_gap_th ONLY when use_fld_lines=True, keeping the
    # full-res gate values meaningful at both operating points.
    fld_support_scale: float = 0.6
    fld_elong_scale: float = 0.8
    fld_gap_scale: float = 0.5
    lbd_bands: int = 9              # LBD number of bands
    lbd_band_width: int = 7         # LBD band width in px
    lbd_samples: int = 24           # samples along the segment
    lbd_band_samples: int = 2       # sample rows per band (across)
    lbd_half_res: bool = True       # sample band statistics from half-res
                                    # gradients: ~2x cheaper AND slightly
                                    # more discriminative (smoother
                                    # gradients; validated by match-rate
                                    # tests)


@dataclass(frozen=True)
class MatchingConfig:
    """Stereo + frame-to-frame matching (reference: config.h matching params)."""
    min_ratio_12_p: float = 0.75    # Lowe ratio for point NN matching
    min_ratio_12_l: float = 0.9     # ratio for line matching (lines repeat more)
    max_hamming_p: int = 80         # absolute descriptor distance gate (of 256)
    max_hamming_l: int = 90
    min_disp: float = 1.0           # min disparity (ref: min_disp ~ 1)
    max_disp: float = 192.0         # search range along rectified row
    stereo_row_tol: float = 1.5     # px, epipolar row tolerance
    stereo_overlap_th: float = 0.6  # line segment overlap (ref: stereo_overlap_th)
    line_horiz_th: float = 0.17     # rad, reject near-horizontal lines for stereo
    f2f_window: float = 160.0       # px, search window around predicted position
    #   (wide enough to bootstrap ~10 deg/frame yaw with no motion prior
    #    at KITTI focal lengths; the window is a mask on the distance
    #    matrix, so widening costs no compute shape change)
    best_lr_matches: bool = True    # mutual-best check


@dataclass(frozen=True)
class TrackingConfig:
    """Robust GN/LM pose optimizer (reference: stereoFrameHandler.cpp)."""
    max_iters: int = 8              # GN iterations (ref: max_iters=5)
    max_iters_ref: int = 8          # refinement iterations after outlier cut
    min_error: float = 1e-7         # stop criteria (kept for parity; iterations
    min_error_change: float = 1e-7  # are fixed-count with masked convergence)
    inlier_k: float = 2.0           # outlier gate: |r| > inlier_k * sigma (ref: inlier_k)
    homog_th: float = 1e-7          # near-homogeneous-point guard
    min_features: int = 12          # gate: solution invalid below this (ref: min_features)
    min_inlier_ratio: float = 0.3
    lite_pass_iters: int = 6        # batched-mode non-final passes run a
    lite_pass_iters_ref: int = 4    # shortened GN (they only produce the
                                    # next pass's prior); 0 = full GN on
                                    # every pass. (6,4) measured ATE-
                                    # neutral on the loop scenes; (4,3)
                                    # already cost ~13% ATE

    max_optim_error: float = 20.0   # gate on residual norm after opt
    lm_init_lambda: float = 1e-4    # LM fallback damping
    prior_weight: float = 0.0       # optional constant-velocity prior strength
    batched_chunks: bool = True     # chunked VO: solve all f2f pairs of a
                                    # chunk BATCHED (vmapped matching + GN)
                                    # instead of a sequential lax.scan —
                                    # the recurrence only carries the
                                    # constant-velocity prior, so pairs
                                    # decouple given a chunk-level prior.
                                    # ~3x front-to-back on TPU (MXU-sized
                                    # matmuls instead of 20 tiny programs)
    chunk_passes: int = 2           # batched-mode refinement passes: pass
                                    # k>1 re-matches/re-solves each pair
                                    # around its OWN pass-(k-1) estimate
                                    # (recovers per-pair prior quality)


@dataclass(frozen=True)
class KeyframeConfig:
    """KF selection (reference: slamConfig min_entropy_ratio/max_kf_*)."""
    min_entropy_ratio: float = 0.85
    max_kf_t_dist: float = 5.0      # m
    max_kf_r_dist: float = 15.0     # deg
    min_kf_n_frames: int = 1        # at least this many frames between KFs


@dataclass(frozen=True)
class MappingConfig:
    """Local map + LBA (reference: mapHandler.cpp / slamConfig.cpp)."""
    window_kfs: int = 6             # LBA sliding window size (local KFs)
    fixed_kfs: int = 4              # older KFs held fixed but observing
    lba_kf_stride: int = 3          # chunked back-end: run the window
                                    # LBA on every Nth KF of a chunk,
                                    # counted from the chunk's END (the
                                    # last KF always runs it, so the
                                    # window covers every insertion
                                    # while staying < window_kfs behind)
                                    # 1 = the reference's per-KF cadence
    max_kfs: int = 512              # global KF capacity
    max_points: int = 8192          # global map point capacity
    max_lines: int = 1024           # global map line capacity
    # per-KF observation capacities == the front-end feature capacities
    # (points.max_kpts / lines.max_lines); derived, not configured
    # LBA problem capacities: the window solve runs on a COMPACTED local
    # problem holding only window-touched landmarks (the reference's
    # localBundleAdjustment likewise optimizes only the local map, never
    # the full store). On overflow the caps keep the MOST RECENTLY
    # touched landmarks and drop the oldest-touched ones from the solve
    # (reported in the KF diag as lba_pt/ln_overflow — never silent);
    # the map itself is untouched.
    lba_max_points: int = 4096
    lba_max_lines: int = 512
    lba_iters: int = 6              # LM iterations in LBA (accept/reject;
                                    # converges in ~4-5 accepted steps on
                                    # ground-truth scenes — 10 iters gave
                                    # identical ATE at 1.5x the per-KF
                                    # cost, and mapping shares the chip
                                    # with tracking)
    lba_inlier_k: float = 2.0
    lba_min_sigma: float = 0.5      # px floor for the outlier gate scale
    min_lm_obs: int = 3             # cull landmarks with fewer obs (ref: min_lm_obs)
    # landmark-pool pressure culling: when occupancy crosses the high
    # water mark, ALSO retire the weakest mature landmarks (fewest
    # observations, then oldest last-seen; window-recent ones
    # protected) so new structure can keep being mapped. The round-5
    # endurance run showed the failure mode: with the pool saturated
    # (~lap 8 of 10), unmatched features silently stop becoming
    # landmarks and late-sequence accuracy decays 10-30x. The
    # reference has no equivalent (its std::vector grows unbounded);
    # this is the fixed-capacity analogue of removeBadMapLandmarks.
    lm_pool_high_water: float = 0.92
    lm_pool_evict_frac: float = 0.0625   # 1/16 of the pool per event
    # representative-descriptor + view-direction maintenance (reference:
    # mapFeatures.cpp :: updateAverageDescDir — keep the medoid of the
    # observed descriptors and a mean viewing direction, and gate map->KF
    # matching by viewing angle)
    desc_ring: int = 4              # per-landmark descriptor history size
    view_cos_th: float = 0.5        # min cos(view angle) for map matching
    max_common_fts_kf: float = 0.9  # redundant-KF cull threshold
    global_kf_sweep_every: int = 8  # run the GLOBAL redundant-KF sweep
                                    # every this many KFs (0 = never);
                                    # the per-KF pass only scans the
                                    # local window
    lambda_init: float = 1e-3       # LM damping init for LBA
    lambda_factor: float = 3.0
    distributed: bool = False       # route the window LBA through the
                                    # owner-sharded multi-device solver
                                    # (parallel.dist_lba over the 'lm'
                                    # mesh axis; SURVEY §2.3 P5). Uses
                                    # all visible devices by default;
                                    # single-device trajectories match
                                    # within f32 reduction noise.
    dist_devices: int = 0           # mesh size for distributed LBA
                                    # (0 = all visible devices)


@dataclass(frozen=True)
class LoopClosureConfig:
    """DBoW2-style place recognition + pose graph (reference: slamConfig.cpp)."""
    enabled: bool = True
    vocab_k: int = 10               # branching factor
    vocab_l: int = 4                # depth -> k^l leaves (10000; k=10
                                    # doubles held-out revisit retrieval
                                    # margins vs the round-2 k=8 tree on
                                    # the same training corpus)
    lc_mat: float = 0.3             # min relative BoW score vs covisible baseline
    lc_res: float = 1.5             # max mean residual of verification solve
    lc_unc: float = 0.01            # max covariance gate
    lc_inl: int = 20                # min inliers in geometric verification
    lc_trs: float = 1.5             # max translation of the loop correction (m)
    lc_rot: float = 35.0            # max rotation of the loop correction (deg)
    min_kf_separation: int = 20     # temporal gap before a KF can be a candidate
    consistency_window: int = 3     # consecutive-KF temporal consistency votes
    # a verified closure whose correction is below BOTH floors skips
    # the pose-graph solve + map-correction programs: the loop edge
    # still joins the graph (and duplicate landmarks still fuse), so
    # no information is lost — it is simply applied at the next
    # significant solve. On sustained revisits most closures measure
    # sub-centimetre corrections; solving a 512-1024-slot graph for
    # them is pure cost (measured: each loop event ~0.3-0.6 s of
    # programs + fetches on the endurance workload). 0 = always solve.
    lc_min_correction_t: float = 0.03    # m
    lc_min_correction_r: float = 0.2     # deg
    # suppress new closures for this many keyframes after one fires
    # (the DBoW2-era standard — e.g. ORB-SLAM's 10-KF lockout): during
    # a sustained revisit every KF is a valid candidate, but re-closing
    # an already-corrected loop buys ~zero accuracy and each closure
    # costs a pose-graph solve + correction program. 0 = no cooldown.
    lc_cooldown: int = 10
    max_loop_candidates: int = 4
    pose_graph_iters: int = 12      # GN iterations on the pose graph
    # linear solver inside each GN iteration (ref: g2o's choice of
    # CHOLMOD vs PCG in loopClosureOptimization*G2O). "dense" = one
    # (6F')^2 LU — exact, O(F'^3), the right call for small graphs;
    # "pcg" = matrix-free block-Jacobi-preconditioned CG whose H-apply
    # is two one-hot incidence matmuls per iteration — O(E) per CG
    # step, the TPU-sparse solver once the dense wall (~300 ms at
    # F'=512) is the loop-event cost center. "auto" switches at
    # pose_graph_dense_max live slots.
    pose_graph_solver: str = "auto"
    pose_graph_dense_max: int = 128
    pose_graph_cg_iters: int = 96   # fixed CG schedule per GN step
    # pose-graph edge set (ref: loopClosureOptimizationEssentialGraphG2O
    # vs loopClosureOptimizationCovGraphG2O): "essential" = odometry +
    # loop + strong covisibility edges (>= covis_min_shared shared
    # landmarks); "covisibility" = the denser graph including every pair
    # with >= covis_min_shared_cov shared landmarks
    graph_type: str = "essential"
    covis_min_shared: int = 25      # min shared landmarks, essential graph
    covis_min_shared_cov: int = 10  # min shared landmarks, covisibility graph
    covis_edge_weight: float = 1.0  # pose-graph weight of covisibility edges
    # sharded place recognition (SURVEY §2.3 P7): the per-KF BoW matrix
    # shards across a 1D 'kf' device mesh; every query scores only its
    # local shard and merges top-k + covisible baseline with
    # all_gather/pmax (parallel.dist_vocab.DistRetrieval). Works with
    # BOTH drivers: the retrieval runs host-side at settle time, so it
    # composes with the fused single-dispatch chunks (unlike the
    # sharded LBA, which needs the worker-thread driver).
    distributed: bool = False
    dist_devices: int = 0           # 0 = all visible devices


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole stereo intrinsics (reference: pinholeStereoCamera.cpp +
    dataset_params.yaml). Distortion handled by precomputed rectify maps."""
    width: int = 1241
    height: int = 376
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.5371657     # meters (KITTI 00 defaults)
    # optional radial-tangential distortion (EuRoC); zeros = pre-rectified
    d: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)


@dataclass(frozen=True)
class SystemConfig:
    """Runtime knobs that replace the reference threading flags."""
    async_mapping: bool = True      # ref: mapHandler multithread flag
    fused_slam: bool = True         # chunked drivers use the single-
                                    # dispatch-per-chunk fused program
                                    # (backend.fused_slam: KF criterion
                                    # in-program, one packed fetch); off
                                    # = host KF decisions + mapping
                                    # worker thread (ChunkedPLSLAM)
    kf_batch: int = 4               # fused chunk-backend capacity: up to
                                    # this many KFs per device dispatch
                                    # (backend.chunk_backend); a chunk
                                    # with more KFs dispatches again.
                                    # While the loop closer reports
                                    # closure_imminent, dispatches drop
                                    # to granularity 2 so corrections
                                    # land between insertions (measured
                                    # on the every-frame-KF loop stress:
                                    # ATE 0.15/0.19/0.24/0.34 m at
                                    # granularity 1/2/3/4)
    dtype: str = "float32"
    bf16_matching: bool = True      # descriptor matmuls in bfloat16 on the MXU
    profile: bool = False


@dataclass(frozen=True)
class SlamConfig:
    """Root config. ``SlamConfig()`` gives a sensible KITTI-ish default."""
    camera: CameraConfig = field(default_factory=CameraConfig)
    points: PointFeatureConfig = field(default_factory=PointFeatureConfig)
    lines: LineFeatureConfig = field(default_factory=LineFeatureConfig)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    system: SystemConfig = field(default_factory=SystemConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def with_updates(self, d: Dict[str, Any]) -> "SlamConfig":
        return _replace_from_dict(self, d)

    @staticmethod
    def from_yaml(path: str, base: Optional["SlamConfig"] = None) -> "SlamConfig":
        import yaml
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        cfg = base if base is not None else SlamConfig()
        return cfg.with_updates(d)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)
