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
