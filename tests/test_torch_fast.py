"""Port parity, kernel B (K1, K2): FAST masks and score, NMS, grid top-k.

Given the reference's own pyramid level as input, the port's plain
versions reproduce the corner masks, the SAD score, and the selected
keypoints (uv, score, valid) EXACTLY: the score is subtract/compare/max/
add in the same tap order, and every top-k is a stable descending sort,
which is ``lax.top_k``'s tie order (lower index first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io import synthetic
from plslam_tpu.ops import fast as jfast
from plslam_tpu.ops.image import build_pyramid
from plslam_tpu_torch.ops import fast as tfast

# the reference as the VO runs it: jitted (eager op-by-op dispatch of
# the 16-tap loop costs seconds per call on the CPU)
_ref_score = jax.jit(jfast.fast_score_map2, static_argnums=(1, 2))
_ref_detect = jax.jit(jfast.detect_fast, static_argnums=tuple(range(1, 9)))

CFG = SlamConfig().with_updates({
    "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
               "cx": 320.0, "cy": 192.0, "baseline": 0.3},
    "points": {"max_kpts": 512, "orb_nlevels": 2},
    "lines": {"has_lines": False},
})


@pytest.fixture(scope="module")
def levels():
    """The reference's blurred pyramid levels of two synthetic frames."""
    cam = StereoCamera.from_config(CFG.camera)
    seq = synthetic.make_sequence(cam, n_frames=2, seed=7, n_points=260,
                                  n_lines=0, noise=0.003, step=0.12)
    out = []
    for img in (seq.images_l[0], seq.images_r[1]):
        out.append([np.asarray(lv) for lv in build_pyramid(
            jnp.asarray(img), 2, CFG.points.orb_scale_factor)])
    return out


@pytest.mark.parametrize("th_hi,th_lo", [(20 / 255.0, 7 / 255.0),
                                         (20 / 255.0, 20 / 255.0)])
def test_fast_score_map2_exact(levels, th_hi, th_lo):
    for lvl in range(2):
        imgs = np.stack([lv[lvl] for lv in levels])
        chi, clo, sc = tfast.fast_score_map2(torch.from_numpy(imgs),
                                             th_hi, th_lo)
        for n in range(imgs.shape[0]):
            rhi, rlo, rsc = _ref_score(jnp.asarray(imgs[n]), th_hi, th_lo)
            np.testing.assert_array_equal(chi[n].numpy(), np.asarray(rhi))
            np.testing.assert_array_equal(clo[n].numpy(), np.asarray(rlo))
            np.testing.assert_array_equal(sc[n].numpy(), np.asarray(rsc))


def test_nms_matches_reference():
    score = np.random.default_rng(0).integers(0, 4, (2, 40, 56)).astype(
        np.float32)           # many equal values: ties at window maxima
    got = tfast.nms(torch.from_numpy(score), 5).numpy()
    for n in range(2):
        np.testing.assert_array_equal(
            got[n], np.asarray(jfast.nms(jnp.asarray(score[n]), 5)))


@pytest.mark.parametrize("adaptive", [True, False])
def test_detect_fast_exact(levels, adaptive):
    p = CFG.points
    for lvl, k in ((0, 700), (1, 324)):
        imgs = np.stack([lv[lvl] for lv in levels])
        uv, s, v = tfast.detect_fast(
            torch.from_numpy(imgs), k, th=p.fast_th / 255.0,
            th_min=p.fast_min_th / 255.0, adaptive=adaptive,
            nms_radius=p.nms_radius, grid_rows=p.grid_rows,
            grid_cols=p.grid_cols, border=16)
        for n in range(imgs.shape[0]):
            ruv, rs, rv = _ref_detect(
                jnp.asarray(imgs[n]), k, p.fast_th / 255.0,
                p.fast_min_th / 255.0, adaptive, p.nms_radius, p.grid_rows,
                p.grid_cols, 16)
            assert int(np.asarray(rv).sum()) > 50
            np.testing.assert_array_equal(uv[n].numpy(), np.asarray(ruv))
            np.testing.assert_array_equal(s[n].numpy(), np.asarray(rs))
            np.testing.assert_array_equal(v[n].numpy(), np.asarray(rv))


def test_adaptive_fallback_takes_the_low_threshold():
    """A low-contrast image keeps too few high-threshold corners, so both
    sides must switch to the low-threshold map for that image alone."""
    rng = np.random.default_rng(5)
    imgs = np.stack([rng.uniform(0.45, 0.55, (96, 128)),
                     rng.uniform(0.0, 1.0, (96, 128))]).astype(np.float32)
    uv, s, v = tfast.detect_fast(torch.from_numpy(imgs), 64, 20 / 255.0,
                                 7 / 255.0, True, 5, 4, 4, border=16)
    for n in range(2):
        ruv, rs, rv = _ref_detect(jnp.asarray(imgs[n]), 64, 20 / 255.0,
                                  7 / 255.0, True, 5, 4, 4, 16)
        np.testing.assert_array_equal(uv[n].numpy(), np.asarray(ruv))
        np.testing.assert_array_equal(s[n].numpy(), np.asarray(rs))
        np.testing.assert_array_equal(v[n].numpy(), np.asarray(rv))


def test_top_k_tie_order_is_lax_top_k():
    x = np.array([[0, 3, -np.inf, 3, 0, 1, 0, -np.inf, 3, 2]] * 2,
                 np.float32)
    x[1] = x[1][::-1]
    v, i = tfast.top_k(torch.from_numpy(x), 7)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
