"""Port parity, LBD descriptors (kernel H, K12).

The reference samples the Sobel maps through a bf16 matmul
(``bilinear_sample_mxu_multi``) inside ``jit``; the port rounds the same
way, builds the same sample grid (``jnp.linspace`` as ``jit`` computes it:
XLA turns the division into a reciprocal product and reassociates, so the
eager values differ from the jitted ones by an ulp in some entries) and
the same 256 pairs. Given identical segments and gradients the samples and
the bits are exactly equal. Near-ties of the pair compares (0 < |f0 -
f1| < 1e-6 after normalisation) are counted: 4 of 32,768 on this input,
and their bits agree too; the 50 exact ties (empty bands, both 0)
compare False on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import lbd as jlbd
from plslam_tpu_torch.ops import image as timage
from plslam_tpu_torch.ops import lbd as tlbd

_ref_describe = jax.jit(jlbd.describe_lines, static_argnames=(
    "n_bands", "band_width", "n_samples", "samples_per_band"))


def test_pairs_equal_reference():
    np.testing.assert_array_equal(tlbd._make_pairs(36), jlbd._make_pairs(36))


@pytest.mark.parametrize("band_width", [3, 7])
def test_sample_grid_equals_jitted_linspace(band_width):
    half = 0.5 * 9 * band_width
    t, o = tlbd.sample_grid(9, band_width, 24, 2)
    rt, ro = jax.jit(lambda: (jnp.linspace(0.0, 1.0, 24),
                              jnp.linspace(-half + 0.5, half - 0.5, 18)))()
    np.testing.assert_array_equal(t, np.asarray(rt))
    np.testing.assert_array_equal(o, np.asarray(ro))


def _scene(seed=0, n=2, H=192, W=320, L=64):
    """Half-res-sized line fields and segments: the strips' own endpoints
    (slightly off, as detected ones are) and random segments, some
    crossing the border (clamped samples)."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, H, W)).astype(np.float32) * 0.1
    segs = []
    for k in range(n):
        sp = rng.uniform(-20, [W + 20, H + 20], (L, 2))
        ep = sp + rng.normal(0, 40, (L, 2))
        for i in range(10):
            x0, y0 = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
            th, ln = rng.uniform(0, np.pi), rng.uniform(40, 160)
            t = np.linspace(-ln / 2, ln / 2, int(3 * ln))
            xs = np.clip(x0 + t * np.cos(th), 0, W - 1).astype(int)
            ys = np.clip(y0 + t * np.sin(th), 0, H - 1).astype(int)
            imgs[k, ys, xs] = 0.9
            u = np.array([np.cos(th), np.sin(th)]) * ln / 2
            sp[i] = np.array([x0, y0]) - u + rng.normal(0, 0.3, 2)
            ep[i] = np.array([x0, y0]) + u + rng.normal(0, 0.3, 2)
        segs.append((sp.astype(np.float32), ep.astype(np.float32)))
    return imgs, segs


def test_bf16_samples_equal_reference():
    imgs, segs = _scene(1, n=1)
    gx, gy = jimage.sobel_gradients(jnp.asarray(imgs[0]))
    rng = np.random.default_rng(0)
    xy = rng.uniform(-5, [325, 197], (4000, 2)).astype(np.float32)
    xy[:100] = np.round(xy[:100])                     # integer positions
    rx, ry = jax.jit(jimage.bilinear_sample_mxu_multi)((gx, gy),
                                                       jnp.asarray(xy))
    tx, ty = tlbd.sample_bf16(torch.from_numpy(np.array(gx))[None],
                              torch.from_numpy(np.array(gy))[None],
                              torch.from_numpy(xy[:, 0])[None],
                              torch.from_numpy(xy[:, 1])[None])
    np.testing.assert_array_equal(tx[0].numpy(), np.asarray(rx))
    np.testing.assert_array_equal(ty[0].numpy(), np.asarray(ry))


def test_bits_equal_reference():
    imgs, segs = _scene()
    grads = [jimage.sobel_gradients(jnp.asarray(im)) for im in imgs]
    tg = [torch.from_numpy(np.stack([np.asarray(g[c]) for g in grads]))
          for c in (0, 1)]
    sp = torch.from_numpy(np.stack([s[0] for s in segs]))
    ep = torch.from_numpy(np.stack([s[1] for s in segs]))
    got = tlbd.describe_lines(tg[0], tg[1], sp, ep, 9, 3, 24, 2).numpy()
    feats = tlbd.line_features_plain(tg[0], tg[1], sp, ep, 9, 3, 24, 2)
    pairs = tlbd._make_pairs(36)
    d = (feats[..., pairs[:, 0]] - feats[..., pairs[:, 1]]).abs()
    near, tied = (d < 1e-6) & (d > 0), d == 0
    print(f"pair compares: {int(near.sum())} near-ties, {int(tied.sum())} "
          f"exact ties of {d.numel()}")
    assert int(near.sum()) <= 16
    for k, (g, s) in enumerate(zip(grads, segs)):
        ref = _ref_describe(None, jnp.asarray(s[0]), jnp.asarray(s[1]),
                            n_bands=9, band_width=3, n_samples=24,
                            samples_per_band=2, gx=g[0], gy=g[1])
        np.testing.assert_array_equal(got[k], np.asarray(ref))


# -- the image-taking entry (one launch from the image on the card) ------------

_ref_describe_img = jax.jit(jlbd.describe_lines, static_argnames=(
    "n_bands", "band_width", "n_samples", "samples_per_band"))


def _border_segments(rng, H, W, L):
    """Random segments, the first ones on or across the image's edges and
    one of zero length."""
    sp = rng.uniform(-20, [W + 20, H + 20], (L, 2))
    ep = sp + rng.normal(0, 30, (L, 2))
    sp[0], ep[0] = (0.0, 0.0), (W - 1.0, 0.0)             # the top row
    sp[1], ep[1] = (W - 1.0, 0.0), (W - 1.0, H - 1.0)     # the right column
    sp[2], ep[2] = (-5.0, H - 1.0), (W + 5.0, H + 3.0)    # below the bottom
    sp[3], ep[3] = (0.5, 5.0), (0.5, H - 5.0)             # the left column
    ep[4] = sp[4]                                          # zero length
    return sp.astype(np.float32), ep.astype(np.float32)


@pytest.mark.parametrize("case", ["half", "full_u8"])
def test_image_entry_plain_equals_reference(case):
    """describe_lines_image_plain equals the jitted reference's
    describe_lines given the image alone (it computes the Sobel maps
    itself): a half-res float image, and a full-res uint8 image, whose
    Sobel y difference wraps in the reference's uint8 arithmetic
    (u8_wrap); segments on and across the border, one of zero length."""
    rng = np.random.default_rng(11)
    if case == "half":
        imgs, segs = _scene(3, n=1, H=94, W=155, L=32)
        img, bw, u8 = imgs[0], 3, False
        sp, ep = segs[0]
        sp[:5], ep[:5] = (x[:5] for x in _border_segments(rng, 94, 155, 5))
        ref_img = jnp.asarray(img)
    else:
        img8 = rng.integers(0, 256, (96, 160), dtype=np.uint8)
        img8[40:44, :] = 250                               # an edge that wraps
        img, bw, u8 = img8.astype(np.float32), 7, True
        sp, ep = _border_segments(rng, 96, 160, 24)
        ref_img = jnp.asarray(img8)
    got = tlbd.describe_lines_image(
        torch.from_numpy(img)[None], torch.from_numpy(sp)[None],
        torch.from_numpy(ep)[None], 9, bw, 24, 2, u8_wrap=u8)[0].numpy()
    ref = _ref_describe_img(ref_img, jnp.asarray(sp), jnp.asarray(ep),
                            n_bands=9, band_width=bw, n_samples=24,
                            samples_per_band=2)
    np.testing.assert_array_equal(got, np.asarray(ref))


def _patch_taps(img, u8_wrap):
    """csrc/lbd.cu's image mode in torch for every top-left tap (y0, x0)
    in [0, H - 2] x [0, W - 2]: the 4 x 4 patch with its rows and columns
    clamped; each column of a tap row summed along y, (a + 2 b) + e, and
    differenced, e - a (wrapped with u8_wrap), shared by the row's two
    taps; then each tap's gx = (sum[c + 2] - sum[c]) / 8 and gy = ((dif[c]
    + 2 dif[c + 1]) + dif[c + 2]) / 8, lines_sobel's power-of-two scalings
    applied at once. Returns {(row, column): (gx, gy)}, each (N, H - 1,
    W - 1)."""
    N, H, W = img.shape
    ry = torch.clamp(torch.arange(H - 1)[:, None] - 1 + torch.arange(4),
                     0, H - 1)
    cx = torch.clamp(torch.arange(W - 1)[:, None] - 1 + torch.arange(4),
                     0, W - 1)
    p = [[img[:, ry[:, i]][:, :, cx[:, j]] for j in range(4)]
         for i in range(4)]
    taps = {}
    for r in range(2):
        sums, difs = [], []
        for j in range(4):
            a, b, e = p[r][j], p[r + 1][j], p[r + 2][j]
            sums.append((a + 2.0 * b) + e)
            d = e - a
            if u8_wrap:
                d = torch.where(d < 0, d + 256.0, d)
            difs.append(d)
        for c in range(2):
            taps[r, c] = ((sums[c + 2] - sums[c]) * 0.125,
                          ((difs[c] + 2.0 * difs[c + 1]) + difs[c + 2])
                          * 0.125)
    return taps


@pytest.mark.parametrize("u8_wrap", [False, True])
def test_kernel_taps_equal_sobel_maps(u8_wrap):
    """Every tap the kernel forms from its clamped 4 x 4 patch equals
    sobel_gradients_plain at that pixel, borders included: the deferred
    scalings are exact on images in [0, 1] and on uint8 values."""
    rng = np.random.default_rng(int(u8_wrap))
    if u8_wrap:
        img = rng.integers(0, 256, (2, 23, 37)).astype(np.float32)
    else:
        img = rng.random((2, 23, 37)).astype(np.float32)
    img = torch.from_numpy(img)
    gx, gy = timage.sobel_gradients_plain(img, u8_wrap)
    H, W = img.shape[1:]
    for (r, c), (tx, ty) in _patch_taps(img, u8_wrap).items():
        assert torch.equal(tx, gx[:, r:r + H - 1, c:c + W - 1])
        assert torch.equal(ty, gy[:, r:r + H - 1, c:c + W - 1])
