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

import os

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
from plslam_tpu_torch.ops import image as timage
from plslam_tpu_torch.ops import orb as torb


def test_kernel_tables_hold_the_reference_tables():
    """csrc/orb.cu's copies of the tables: the packed (dy, dx) int16 of
    each rotated offset, lane l's pairs 8l .. 8l + 7 as (p0, p1) bytes,
    and its level table's size."""
    e = torb._ROT_PACKED.astype(np.int32)
    np.testing.assert_array_equal(e >> 8, jorb._ROT_TABLES[..., 0])
    np.testing.assert_array_equal((e & 0xFF).astype(np.int8),
                                  jorb._ROT_TABLES[..., 1])
    np.testing.assert_array_equal(
        torb._PAIRS_BY_LANE.reshape(32, 8, 2).reshape(256, 2), jorb.PAIRS)
    src = open(os.path.join(os.path.dirname(torb.__file__), os.pardir,
                            "csrc", "orb.cu")).read()
    assert f"MAX_LEVELS = {torb.MAX_LEVELS};" in src


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


def _pyramid_case(n_levels, seed, K=300):
    """One 384x640 synthetic frame's reference pyramid of ``n_levels``
    levels, with K keypoints an image on and off the levels' edges (K not
    a multiple of a warp's 32 keypoints or a CTA's 256)."""
    cfg = SlamConfig().with_updates({
        "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
                   "cx": 320.0, "cy": 192.0, "baseline": 0.3}})
    seq = synthetic.make_sequence(StereoCamera.from_config(cfg.camera),
                                  n_frames=1, seed=seed, n_points=260,
                                  n_lines=0, noise=0.003, step=0.12)
    levels = [np.array(lv) for lv in build_pyramid(
        jnp.asarray(seq.images_l[0]), n_levels, 1.2)]
    rng = np.random.default_rng(seed)
    octv = rng.integers(0, n_levels, K).astype(np.int32)
    wh = np.array([lv.shape[::-1] for lv in levels], np.float32)[octv]
    uv = (rng.uniform(-0.05, 1.05, (K, 2)) * wh).astype(np.float32)
    return levels, uv, octv


@pytest.mark.parametrize("n_levels", [2, 4])
def test_orient_and_describe_matches_reference(n_levels):
    """orient_and_describe's plain path (kernel C's function, from the
    port's moment maps) against the reference's describe_multilevel:
    theta within 1e-5, bits exact wherever the 32-bin angles agree."""
    levels, uv, octv = _pyramid_case(n_levels, seed=11)
    t_levels = [torch.from_numpy(lv)[None] for lv in levels]
    m10, m01, halves = torb.moment_maps(t_levels)
    bits, theta = torb.orient_and_describe(
        t_levels, m10, m01, halves, torch.from_numpy(uv)[None],
        torch.from_numpy(octv)[None])
    rbits, rtheta = _reference(levels, uv, octv)
    np.testing.assert_allclose(theta[0].numpy(), rtheta, atol=1e-5)
    same = (torb.angle_bins(theta[0]).numpy()
            == torb.angle_bins(torch.tensor(rtheta)).numpy())
    assert (~same).sum() <= 0.01 * len(uv)
    np.testing.assert_array_equal(bits[0].numpy()[same], rbits[same])


def test_describe_multilevel_unchanged(case):
    """describe_multilevel (moment_maps + orient_and_describe) equals the
    composition it replaced: the two moment filters of each half-res
    level, the levels and maps concatenated, the torch gathers, atan2,
    angle_bins and pool_bits."""
    levels, uv, octv = case
    t_levels = [torch.from_numpy(np.stack([lv[i] for lv in levels]))
                for i in range(3)]
    uv_t, oct_t = torch.from_numpy(uv), torch.from_numpy(octv)
    bits, theta = torb.describe_multilevel(t_levels, uv_t, oct_t)
    N = uv.shape[0]
    full = [tuple(lv.shape[-2:]) for lv in t_levels]
    halves = [timage.resize_bilinear(lv, (h // 2, w // 2))
              for lv, (h, w) in zip(t_levels, full)]
    half = [tuple(x.shape[-2:]) for x in halves]
    m10 = torch.cat([timage.separable_filter2d(x, torb._d_h, torb._ONES_H)
                     .reshape(N, -1) for x in halves], 1)
    m01 = torch.cat([timage.separable_filter2d(x, torb._ONES_H, torb._d_h)
                     .reshape(N, -1) for x in halves], 1)
    flat = torch.cat([lv.reshape(N, -1) for lv in t_levels], 1)
    o = oct_t.long().clamp(0, 2)
    tab = lambda v: torch.tensor(v)[o]
    fW, fH = tab([s[1] for s in full]), tab([s[0] for s in full])
    hW, hH = tab([s[1] for s in half]), tab([s[0] for s in half])
    hidx = (tab(torb._bases(half))
            + torch.minimum(torch.round(uv_t[..., 1] * 0.5).long()
                            .clamp(min=0), hH - 1) * hW
            + torch.minimum(torch.round(uv_t[..., 0] * 0.5).long()
                            .clamp(min=0), hW - 1))
    rtheta = torch.atan2(m01.gather(1, hidx), m10.gather(1, hidx))
    u = torch.minimum(torch.round(uv_t[..., 0]).long().clamp(min=15), fW - 16)
    v = torch.minimum(torch.round(uv_t[..., 1]).long().clamp(min=15), fH - 16)
    center = (tab(torb._bases(full)) + v * fW + u).to(torch.int32)
    rbits = torb.pool_bits(flat, center, fW.to(torch.int32),
                           torb.angle_bins(rtheta))
    assert torch.equal(theta, rtheta)
    assert torch.equal(bits, rbits)


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
