"""Port parity, kernel A (K3): separable filters, bilinear resize, pyramid.

Same numpy inputs through ``plslam_tpu.ops.image`` (banded matmuls) and
``plslam_tpu_torch.ops.image`` (plain stencils on the CPU). The two sum
the taps in different orders, so agreement is to 1e-5 absolute for images
in [0, 1]. The 15-tap moment maps of ORB orientation cancel terms whose
magnitudes sum to 56 * 15 = 840 (pixel values <= 1), so they are held to
2e-4 absolute: four f32 ulps of that sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import orb as jorb
from plslam_tpu_torch.ops import image as timage

ATOL = 1e-5


def _img(seed, shape=(2, 97, 131)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("sigma", [1.0, 1.6])
def test_gaussian_blur_matches_reference(sigma):
    imgs = _img(0)
    got = timage.gaussian_blur(torch.from_numpy(imgs), sigma).numpy()
    for n in range(imgs.shape[0]):
        ref = np.asarray(jimage.gaussian_blur(jnp.asarray(imgs[n]), sigma))
        np.testing.assert_allclose(got[n], ref, atol=ATOL, rtol=0)


def test_moment_filters_match_reference():
    """The 15-tap half-res moment kernels of describe_multilevel."""
    imgs = _img(1)
    for kx, ky in ((jorb._d_h, jorb._ONES_H), (jorb._ONES_H, jorb._d_h)):
        got = timage.separable_filter2d(torch.from_numpy(imgs), kx, ky).numpy()
        for n in range(imgs.shape[0]):
            ref = np.asarray(jimage.separable_filter2d(
                jnp.asarray(imgs[n]), kx, ky))
            np.testing.assert_allclose(got[n], ref, atol=2e-4, rtol=0)


def test_moment_pair_writes_both_maps_into_level_columns():
    """ORB's paired filter into the columns of one level of two (N, sum of
    h*w) buffers equals the two single filters (its plain version) there,
    matches the reference, and leaves the other columns as they were."""
    imgs = _img(4, (2, 41, 67))
    x = torch.from_numpy(imgs)
    hw = 41 * 67
    m10 = torch.full((2, hw + 9), -7.0)
    m01 = torch.full((2, hw + 9), -7.0)
    sets = ((jorb._d_h, jorb._ONES_H), (jorb._ONES_H, jorb._d_h))
    timage.separable_filter2d_pair(x, *sets[0], *sets[1], m10[:, 5:5 + hw],
                                   m01[:, 5:5 + hw])
    for out, (kx, ky) in zip((m10, m01), sets):
        single = timage.separable_filter2d(x, kx, ky).reshape(2, -1)
        assert torch.equal(out[:, 5:5 + hw], single)
        assert bool((out[:, :5] == -7.0).all()) and bool(
            (out[:, 5 + hw:] == -7.0).all())
        for n in range(2):
            ref = np.asarray(jimage.separable_filter2d(
                jnp.asarray(imgs[n]), kx, ky)).reshape(-1)
            np.testing.assert_allclose(out[n, 5:5 + hw].numpy(), ref,
                                       atol=2e-4, rtol=0)


def test_filter_taps_pack_centred_sets():
    """The filter kernel's taps: each set centred at the launch radius (the
    largest), zero-padded, vertical then horizontal; 15 taps at most."""
    g = timage.gaussian_kernel1d(1.0, 3)
    taps, r = timage._filter_taps([(jorb._d_h, g), (g, g)])
    assert r == 7 and taps.shape == (2, 2, 16) and taps.dtype == np.float32
    np.testing.assert_array_equal(taps[0, 0, 4:11], g)      # ky, padded
    np.testing.assert_array_equal(taps[0, 1, :15], jorb._d_h)
    np.testing.assert_array_equal(taps[1, 1, 4:11], g)
    for f, a in ((0, 0), (1, 0), (1, 1)):
        assert not taps[f, a, :4].any() and not taps[f, a, 11:].any()
    taps, r = timage._filter_taps([(g, g)])
    assert r == 3 and not taps[1].any()
    np.testing.assert_array_equal(taps[0, 0, :7], g)
    for bad in (np.ones(17, np.float32), np.ones(4, np.float32)):
        with pytest.raises(ValueError):
            timage._filter_taps([(bad, g)])


@pytest.mark.parametrize("shape", [(81, 109), (48, 65), (13, 200), (97, 131)])
def test_resize_bilinear_matches_reference(shape):
    imgs = _img(2)
    got = timage.resize_bilinear(torch.from_numpy(imgs), shape).numpy()
    assert got.shape == (2,) + shape
    for n in range(imgs.shape[0]):
        ref = np.asarray(jimage.resize_bilinear(jnp.asarray(imgs[n]), shape))
        np.testing.assert_allclose(got[n], ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("H, W, Ho, Wo", [
    (376, 1241, 313, 1034), (376, 1241, 188, 620), (97, 131, 97, 131),
    (48, 65, 97, 131)])
def test_resize_table_rebuilds_reference_matrix(H, W, Ho, Wo):
    """The resize kernel's packed taps (1/1.2, 1/2, an equal size, an
    upscale), rebuilt into the two banded matrices, equal the reference's
    _resize_matrix exactly."""
    table = timage.resize_table(H, Ho, W, Wo)
    assert table.shape == (Ho + Wo, 4) and table.dtype == np.int32
    for taps, n_out, n_in in ((table[:Ho], Ho, H), (table[Ho:], Wo, W)):
        M = np.zeros((n_out, n_in), np.float32)
        rows = np.arange(n_out)
        np.add.at(M, (rows, taps[:, 0]), taps[:, 2].view(np.float32))
        np.add.at(M, (rows, taps[:, 1]), taps[:, 3].view(np.float32))
        np.testing.assert_array_equal(M, jimage._resize_matrix(n_out, n_in))


def test_build_pyramid_matches_reference():
    imgs = _img(3, (2, 384, 640))
    got = timage.build_pyramid(torch.from_numpy(imgs), 3, 1.2)
    for n in range(imgs.shape[0]):
        ref = jimage.build_pyramid(jnp.asarray(imgs[n]), 3, 1.2)
        assert [g.shape[1:] for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[n].numpy(), np.asarray(r),
                                       atol=ATOL, rtol=0)


def test_kernel_wrappers_refuse_what_they_do_not_take():
    """A CPU tensor takes the plain version; nothing else is accepted
    silently: a wrong dtype on the kernel path raises."""
    from plslam_tpu_torch import native
    with pytest.raises(ValueError):
        native.require(torch.zeros(2, 3, 4, dtype=torch.float64), "x",
                       torch.float32)
