"""Port parity, kernel B (K1, K2): FAST masks and score, NMS, grid top-k.

Given the reference's own pyramid level as input, the port's plain
versions reproduce the corner masks, the SAD score, and the selected
keypoints (uv, score, valid) EXACTLY: the score is subtract/compare/max/
add in the same tap order, and every top-k is a stable descending sort,
which is ``lax.top_k``'s tie order (lower index first). The NMS kernel's
block reduction (a column's rows in order, then a shuffle tree over the 8
columns on (value, index) pairs) and its 8-output window max are emulated
in numpy and held against torch, the reference's block argmax and a
direct max.
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
        assert chi.dtype == clo.dtype == torch.bool     # as the kernel's
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


# -- the FAST kernel's arithmetic (csrc/fast.cu), checked on the CPU -------

def _reverse16(m):
    return int(f"{m:016b}"[::-1], 2)


def test_arc_table_is_the_reference_arc_test():
    """The kernel's 8 KB table holds the reference's arc test of every
    16-bit mask, and is closed under bit reversal (the kernel's masks hold
    tap i at bit 15 - i)."""
    words = tfast.arc_table().view(np.uint32)
    assert words.shape == (2048,)
    m = np.arange(1 << 16, dtype=np.int64)
    table = ((words[m >> 5] >> (m & 31).astype(np.uint32)) & 1).astype(bool)
    ref = np.asarray(jfast._arc9_from_bitmask(jnp.asarray(m, jnp.int32)))
    np.testing.assert_array_equal(table, ref)
    assert int(table.sum()) == 1025
    rev = np.array([_reverse16(int(v)) for v in m])
    np.testing.assert_array_equal(table, table[rev])


def _signbit_fast(img, th_hi, th_lo):
    """fast_score_kernel's arithmetic in numpy f32 on one (H, W) image:
    mask bits from the sign bits of th - diff and diff + th shifted in
    (tap 0 ends at bit 15), the score terms as max(-(th_lo - diff), 0)
    and max(-(diff + th_lo), 0) summed from +0 in circle order, the arc
    test from the table."""
    f32 = np.float32
    th_hi, th_lo = f32(th_hi), f32(th_lo)
    H, W = img.shape
    p = np.pad(img, 3, mode="edge")
    words = tfast.arc_table().view(np.uint32)
    bits = [np.zeros((H, W), np.uint32) for _ in range(4)]
    sb = np.zeros((H, W), f32)
    sd = np.zeros((H, W), f32)
    for dy, dx in tfast._CIRCLE.tolist():
        diff = p[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - img
        lo_b, lo_d = th_lo - diff, diff + th_lo
        for j, x in enumerate((th_hi - diff, diff + th_hi, lo_b, lo_d)):
            bits[j] = (bits[j] << 1) | np.signbit(x).astype(np.uint32)
        sb = sb + np.maximum(-lo_b, f32(0))
        sd = sd + np.maximum(-lo_d, f32(0))

    def arc(m):
        return ((words[m >> 5] >> (m & 31)) & 1).astype(bool)

    return (arc(bits[0]) | arc(bits[1]), arc(bits[2]) | arc(bits[3]),
            np.maximum(sb, sd))


@pytest.mark.parametrize("case", ["default", "equal", "zero", "ties"])
def test_signbit_arithmetic_is_the_reference(levels, case):
    """The kernel's masks and score, emulated, equal the reference's bit
    for bit on a real pyramid level; "ties" takes both thresholds from
    differences that occur in the image, so pixels sit exactly on them."""
    img = levels[0][1]
    if case == "ties":
        d = img[37:47, 50:60] - img[40:50, 50:60]      # tap 0's differences
        d = np.abs(d[d != 0])
        th_hi, th_lo = float(d.max()), float(np.median(d))
    else:
        th_hi, th_lo = {"default": (20 / 255.0, 7 / 255.0),
                        "equal": (7 / 255.0, 7 / 255.0),
                        "zero": (0.0, 0.0)}[case]
    th_hi, th_lo = float(np.float32(th_hi)), float(np.float32(th_lo))
    got = _signbit_fast(img, th_hi, th_lo)
    ref = _ref_score(jnp.asarray(img), th_hi, th_lo)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        if r.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), r.view(np.int32))
        else:
            np.testing.assert_array_equal(g, r)


def test_signbit_identities_on_ties_zeros_and_subnormals():
    """diff > th iff th - diff < 0, diff < -th iff diff + th < 0, and the
    score terms equal up to the sign of a zero (which a sum from +0
    drops), on values at and around the thresholds, +-0 and subnormals."""
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    sub = [f32(1e-45), f32(3e-42), tiny * f32(0.5)]
    ths = [f32(0.0), f32(20 / 255.0), f32(7 / 255.0), sub[1], tiny]
    rng = np.random.default_rng(3)
    vals = [f32(0.0), f32(-0.0), *sub, *[-s for s in sub], tiny, -tiny]
    for th in ths:
        vals += [th, -th, np.nextafter(th, f32(1)), np.nextafter(th, f32(-1)),
                 np.nextafter(-th, f32(1)), np.nextafter(-th, f32(-1))]
    diff = np.concatenate([np.array(vals, f32),
                           rng.uniform(-1, 1, 4096).astype(f32)])
    with np.errstate(over="ignore"):
        for th in ths:
            np.testing.assert_array_equal(np.signbit(th - diff), diff > th)
            np.testing.assert_array_equal(np.signbit(diff + th), diff < -th)
            for got, ref in ((np.maximum(-(th - diff), f32(0)),
                              np.maximum(diff - th, f32(0))),
                             (np.maximum(-(diff + th), f32(0)),
                              np.maximum(-diff - th, f32(0)))):
                np.testing.assert_array_equal(got, ref)      # -0 == +0
                acc = f32(0) + got
                np.testing.assert_array_equal(
                    acc.view(np.int32), (f32(0) + ref).view(np.int32))


# -- the NMS kernel's block max and window max (csrc/fast.cu), on the CPU --

def _kernel_block_argmax(v):
    """nms_block_kernel's reduction of 8x8 blocks (n, 8, 8): lane c takes
    column c's rows in order (strict >: the first row), then lanes meet in
    a __shfl_xor_sync tree (1, 2, 4): the larger value wins, an equal value
    keeps the lower index."""
    n = v.shape[0]
    lane_v = np.full((n, 8), -np.inf, np.float32)
    lane_q = np.tile(np.arange(8), (n, 1))
    for k in range(8):
        take = v[:, k, :] > lane_v
        lane_v = np.where(take, v[:, k, :], lane_v)
        lane_q = np.where(take, k * 8 + np.arange(8), lane_q)
    for d in (1, 2, 4):
        ov, oq = lane_v[:, np.arange(8) ^ d], lane_q[:, np.arange(8) ^ d]
        take = (ov > lane_v) | ((ov == lane_v) & (oq < lane_q))
        lane_v, lane_q = np.where(take, ov, lane_v), np.where(take, oq,
                                                              lane_q)
    assert (lane_v == lane_v[:, :1]).all() and (lane_q == lane_q[:, :1]).all()
    return lane_v[:, 0], lane_q[:, 0]


def _jax_block_argmax(v):
    """select_topk_grid's block max + argmax (plslam_tpu/ops/fast.py:152-
    163): a row's first maximum, then the first row with the maximum."""
    x = jnp.asarray(v)
    rmax, rarg = jnp.max(x, axis=-1), jnp.argmax(x, axis=-1)
    brow = jnp.argmax(rmax, axis=-1)
    col = jnp.take_along_axis(rarg, brow[:, None], axis=-1)[:, 0]
    return np.asarray(jnp.max(rmax, axis=-1)), np.asarray(brow * 8 + col)


def test_block_argmax_pair_rule_is_the_first_argmax():
    """Tied maxima anywhere in a block, all zeros (0, index 0), all -inf
    (padding: -inf, index 0), kept and unkept pixels beside padding: the
    tree's pairs give torch.max's and the reference's first argmax."""
    rng = np.random.default_rng(3)
    blocks = [np.zeros((8, 8)), np.full((8, 8), -np.inf)]
    for _ in range(300):
        b = rng.integers(0, 3, (8, 8)).astype(np.float64) * 0.5
        if rng.random() < 0.5:                 # padding on the right/bottom
            b[:, rng.integers(1, 8):] = -np.inf
        if rng.random() < 0.3:
            b[rng.integers(1, 8):, :] = -np.inf
        blocks.append(b)
    for _ in range(100):                       # one to four tied maxima
        b = np.where(rng.random((8, 8)) < 0.8, 0.0, rng.random((8, 8)))
        peak = rng.integers(0, 64, rng.integers(1, 5))
        b.flat[peak] = 2.0
        blocks.append(b)
    v = np.stack(blocks).astype(np.float32)
    got_v, got_q = _kernel_block_argmax(v)
    ref_v, ref_q = torch.max(torch.from_numpy(v).reshape(-1, 64), dim=-1)
    jv, jq = _jax_block_argmax(v)
    np.testing.assert_array_equal(got_v, ref_v.numpy())
    np.testing.assert_array_equal(got_q, ref_q.numpy())
    np.testing.assert_array_equal(got_v, jv)
    np.testing.assert_array_equal(got_q, jq)
    assert got_q[1] == 0 and got_v[1] == -np.inf and got_q[0] == 0


def _window_max8(v, R):
    """window_max8<R>: 8 windows of 2R + 1 from 8 + 2R values, by the
    values all windows share, suffix maxima to their left and prefix
    maxima to their right (fmaxf on -inf and ties)."""
    left = [None] * 8
    left[7] = v[7:2 * R + 1].max()
    for j in range(6, -1, -1):
        left[j] = max(v[j], left[j + 1])
    out, right = [left[0]], -np.inf
    for j in range(1, 8):
        right = max(right, v[2 * R + j])
        out.append(max(left[j], right))
    return np.array(out, np.float32)


@pytest.mark.parametrize("R", [4, 5, 8, 16])
def test_window_max8_is_the_window_max(R):
    rng = np.random.default_rng(R)
    for _ in range(200):
        v = rng.integers(0, 4, 8 + 2 * R).astype(np.float32)
        v[rng.random(8 + 2 * R) < 0.3] = -np.inf
        want = np.array([v[j:j + 2 * R + 1].max() for j in range(8)])
        np.testing.assert_array_equal(_window_max8(v, R), want)
