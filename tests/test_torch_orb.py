"""Port parity, kernel C (K5): ORB tables, steered pool bits, orientation.

The port regenerates the sampling tables (this system's "weights") and
they equal the reference's exactly. Given the reference's pyramid levels
and the same keypoints, the port's descriptor bits equal the reference's
for every keypoint whose 32-bin angle agrees. The angle comes from moment
maps summed in another order (see test_torch_image), so a theta within
~1e-6 of a bin edge may land in the neighbouring bin: measured 0 flips
of 600 keypoints here; the test allows 1%. Given the reference's own
bins, all bits agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io import synthetic
from plslam_tpu.ops import orb as jorb
from plslam_tpu.ops.image import build_pyramid
from plslam_tpu_torch.ops import orb as torb


def test_tables_equal_reference():
    np.testing.assert_array_equal(torb.POOL, jorb.POOL)
    np.testing.assert_array_equal(torb.PAIRS, jorb.PAIRS)
    np.testing.assert_array_equal(torb._ROT_TABLES, jorb._ROT_TABLES)
    np.testing.assert_array_equal(torb._ROT_DYDX, jorb._ROT_DYDX)
    assert torb.POOL.dtype == jorb.POOL.dtype
    assert torb.PAIRS.dtype == jorb.PAIRS.dtype


@pytest.fixture(scope="module")
def case():
    cfg = SlamConfig().with_updates({
        "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
                   "cx": 320.0, "cy": 192.0, "baseline": 0.3}})
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=1, seed=7, n_points=260,
                                  n_lines=0, noise=0.003, step=0.12)
    rng = np.random.default_rng(3)
    imgs, uvs, octs = [], [], []
    for img in (seq.images_l[0], seq.images_r[0]):
        levels = [np.asarray(lv) for lv in build_pyramid(
            jnp.asarray(img), 3, 1.2)]
        K = 300
        octv = rng.integers(0, 3, K).astype(np.int32)
        wh = np.array([lv.shape[::-1] for lv in levels], np.float32)[octv]
        # some keypoints off the image edge: the center clamp must agree
        uv = (rng.uniform(-0.05, 1.05, (K, 2)) * wh).astype(np.float32)
        imgs.append(levels)
        uvs.append(uv)
        octs.append(octv)
    return imgs, np.stack(uvs), np.stack(octs)


_ref_describe = jax.jit(jorb.describe_multilevel)


def _reference(levels, uv, octv):
    bits, theta = _ref_describe(
        [jnp.asarray(lv) for lv in levels], jnp.asarray(uv), jnp.asarray(octv))
    return np.asarray(bits), np.asarray(theta)


def test_describe_multilevel_matches_reference(case):
    levels, uv, octv = case
    t_levels = [torch.from_numpy(np.stack([lv[i] for lv in levels]))
                for i in range(3)]
    bits, theta = torb.describe_multilevel(
        t_levels, torch.from_numpy(uv), torch.from_numpy(octv))
    flips = 0
    for n in range(2):
        rbits, rtheta = _reference(levels[n], uv[n], octv[n])
        np.testing.assert_allclose(theta[n].numpy(), rtheta, atol=1e-5)
        tb = torb.angle_bins(theta[n]).numpy()
        rb = torb.angle_bins(torch.tensor(rtheta)).numpy()
        same = tb == rb
        flips += int((~same).sum())
        np.testing.assert_array_equal(bits[n].numpy()[same], rbits[same])
    assert flips <= 0.01 * uv.shape[0] * uv.shape[1], flips


def test_pool_bits_exact_given_reference_bins(case):
    """The kernel's function (gather + pair tests) on the reference's own
    bins reproduces every bit of the reference descriptor."""
    levels, uv, octv = case
    for n in range(2):
        rbits, rtheta = _reference(levels[n], uv[n], octv[n])
        shapes = [lv.shape for lv in levels[n]]
        base = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
        fW = np.array([s[1] for s in shapes])[octv[n]]
        fH = np.array([s[0] for s in shapes])[octv[n]]
        u = np.clip(np.round(uv[n, :, 0]).astype(np.int32), 15, fW - 16)
        v = np.clip(np.round(uv[n, :, 1]).astype(np.int32), 15, fH - 16)
        center = (base[octv[n]] + v * fW + u).astype(np.int32)
        flat = np.concatenate([lv.reshape(-1) for lv in levels[n]])
        bins = torb.angle_bins(torch.tensor(rtheta))
        got = torb.pool_bits(torch.from_numpy(flat)[None],
                             torch.from_numpy(center)[None],
                             torch.from_numpy(fW.astype(np.int32))[None],
                             bins[None])
        np.testing.assert_array_equal(got[0].numpy(), rbits)


def test_rounding_rules_match_jnp():
    """round half to even, modulo with the divisor's sign, truncating
    int casts: the three steps of the angle quantisation."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 31.5, -33.7, 33.2, -0.0],
                 np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(torch.round(t).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))
    np.testing.assert_array_equal(torch.remainder(t, 32).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(x), 32)))
    np.testing.assert_array_equal(t.to(torch.int32).numpy(),
                                  np.asarray(jnp.asarray(x).astype(jnp.int32)))
    theta = np.linspace(-np.pi, np.pi, 4097).astype(np.float32)
    ref = np.asarray(jnp.mod(jnp.round(jnp.asarray(theta) * (
        jorb.N_ANGLE_BINS / (2.0 * jnp.pi))), jorb.N_ANGLE_BINS).astype(
            jnp.int32))
    np.testing.assert_array_equal(
        torb.angle_bins(torch.from_numpy(theta)).numpy(), ref)
