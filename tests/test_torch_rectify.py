"""Port parity: rectification (``core/camera.py``) and the host remap
(``io/imageio.py::_remap_np``).

``remap_bilinear_plain`` (kernel N's plain version, the CPU path of
``remap_bilinear``) against the reference's ``remap_bilinear`` on random
images and maps with negative, out-of-bounds, integer and last-row/column
coordinates: within 2e-6 absolute (measured: 0 against the eager
reference, 1.2e-7 against the jitted one, whose products XLA contracts
into FMAs). ``build_rectify_map`` and ``stereo_rectify`` are numpy copies:
exactly equal. ``StereoRectifier(device="cpu")`` against the reference's
(jitted) on the identity rig of tests/test_camera_robust.py and on a
distorted, rotated 160x120 rig: 2e-6. The host remap: the port's
``_remap_np`` exactly equal to the reference's, and within 1e-6 of the
reference's native C++ remap (``imagecodec.cpp``, f32 throughout where the
numpy copy blends in float64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.core import camera as jcam
from plslam_tpu.native import imageio as jio
from plslam_tpu_torch.core import camera as tcam
from plslam_tpu_torch.io import imageio as tio

REMAP_TOL = 2e-6


def _rot(rx, ry, rz):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def _rig(W=160, H=120):
    """A distorted rig with a rotated cam1 (as an EuRoC-style raw rig)."""
    K0 = np.array([[100.0, 0, 81.5], [0, 99.0, 58.2], [0, 0, 1]])
    K1 = np.array([[101.5, 0, 78.9], [0, 100.2, 61.0], [0, 0, 1]])
    d0 = (-0.28, 0.07, 2e-4, 1.8e-5)
    d1 = (-0.27, 0.068, -1e-4, -3.6e-5, 0.001)
    R = _rot(0.01, -0.012, 0.008)
    t = R @ np.array([-0.11, 0.0, 0.0])
    return K0, d0, K1, d1, R, t, H, W


def _maps(rng, H, W, Ho, Wo, lead=()):
    m = np.stack([rng.uniform(-3, W + 2, lead + (Ho, Wo)),
                  rng.uniform(-3, H + 2, lead + (Ho, Wo))],
                 -1).astype(np.float32)
    m[..., 0, :6, 0] = np.arange(6)             # integer u
    m[..., 1, :6, 0] = W - 1                     # last column
    m[..., 2, :6, 1] = H - 1                     # last row
    m[..., 3, :6, :] = -1.0                      # negative
    m[..., 4, :6, :] = [W - 1, H - 1]            # the last pixel
    m[..., 5, :6, :] = [W - 1.0001, H - 0.5]     # just inside
    return m


@pytest.mark.parametrize("shape", [(37, 53, 40, 60), (120, 160, 96, 131)])
def test_remap_plain_matches_reference(shape):
    H, W, Ho, Wo = shape
    rng = np.random.default_rng(H)
    img = rng.uniform(0, 1, (H, W)).astype(np.float32)
    m = _maps(rng, H, W, Ho, Wo)
    got = tcam.remap_bilinear(torch.from_numpy(img), torch.from_numpy(m))
    assert got.shape == (Ho, Wo)
    eager = np.asarray(jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
    jitted = np.asarray(jax.jit(jcam.remap_bilinear)(jnp.asarray(img),
                                                     jnp.asarray(m)))
    d_e = np.abs(got.numpy() - eager).max()
    d_j = np.abs(got.numpy() - jitted).max()
    print(f"remap: {d_e:.3g} from the eager reference, {d_j:.3g} from the "
          f"jitted one")
    assert d_e <= REMAP_TOL and d_j <= REMAP_TOL
    # out-of-bounds taps read 0: a map entirely outside gives 0
    far = np.full((4, 5, 2), -10.0, np.float32)
    assert not tcam.remap_bilinear(torch.from_numpy(img),
                                   torch.from_numpy(far)).any()


def test_remap_batched_maps_are_per_image():
    """(N, H, W) images with one map per image = N separate remaps; one
    shared map applies to every image; a map of the wrong batch raises."""
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.uniform(0, 1, (2, 30, 40)).astype(np.float32))
    m = torch.from_numpy(_maps(rng, 30, 40, 20, 25, lead=(2,)))
    got = tcam.remap_bilinear(imgs, m)
    for i in range(2):
        assert torch.equal(got[i], tcam.remap_bilinear(imgs[i], m[i]))
        assert torch.equal(tcam.remap_bilinear(imgs, m[0])[i],
                           tcam.remap_bilinear(imgs[i], m[0]))
    with pytest.raises(ValueError, match="map"):
        tcam.remap_bilinear(imgs, m[:1])


def test_rectify_maps_are_exact_copies():
    K0, d0, K1, d1, R, t, H, W = _rig()
    ref = jcam.stereo_rectify(K0, d0, K1, d1, R, t, H, W)
    got = tcam.stereo_rectify(K0, d0, K1, d1, R, t, H, W)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert dataclasses.asdict(got[2]) == dataclasses.asdict(ref[2])
    np.testing.assert_array_equal(tcam._rot_sqrt(R), jcam._rot_sqrt(R))
    K_new = np.array([[95.0, 0, 80.0], [0, 95.0, 60.0], [0, 0, 1]])
    np.testing.assert_array_equal(
        tcam.build_rectify_map(K_new, K1, d1, R, H, W),
        jcam.build_rectify_map(K_new, K1, d1, R, H, W))
    xn = np.random.default_rng(2).normal(0, 0.5, (50, 2))
    np.testing.assert_array_equal(tcam.radtan_distort(xn, d1),
                                  jcam.radtan_distort(xn, d1))


@pytest.mark.parametrize("rig", ["identity", "distorted"])
def test_stereo_rectifier_matches_reference(rig):
    if rig == "identity":         # tests/test_camera_robust.py's rig
        W, H = 64, 48
        K = np.array([[100.0, 0, W / 2.0], [0, 100.0, H / 2.0], [0, 0, 1]])
        d = (0.0,) * 5
        args = (K, d, K, d, np.eye(3), np.array([-0.2, 0.0, 0.0]), H, W)
    else:
        args = _rig()
        H, W = args[-2:]
    map_l, map_r, _ = tcam.stereo_rectify(*args)
    rng = np.random.default_rng(0)
    img_l, img_r = rng.uniform(0, 1, (2, H, W)).astype(np.float32)
    ref = jcam.StereoRectifier(map_l, map_r)(img_l, img_r)
    rect = tcam.StereoRectifier(map_l, map_r, device="cpu")
    got = rect(img_l, img_r)
    for g, r in zip(got, ref):
        assert g.shape == (H, W)
        assert np.abs(g.numpy() - np.asarray(r)).max() <= REMAP_TOL
    if rig == "identity":
        np.testing.assert_allclose(got[0].numpy(), img_l, atol=1e-5)


def test_host_remap_matches_reference():
    K0, d0, K1, d1, R, t, H, W = _rig()
    map_l, _, _ = tcam.stereo_rectify(K0, d0, K1, d1, R, t, H, W)
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 1, (H, W)).astype(np.float32)
    clamp = _maps(rng, H, W, 50, 70)              # clamped at the border
    for m in (map_l, clamp):
        got = tio._remap_np(src, m)
        np.testing.assert_array_equal(got, jio._remap_np(src, m))
        native = jio.remap(src, m)
        if native is not None:                   # the reference's C++ lib
            d = np.abs(got - native).max()
            print(f"host remap vs the reference's native remap: {d:.3g}")
            assert d <= 1e-6
