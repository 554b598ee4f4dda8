"""Port parity: tracking/pose_gn.py (K13, plain f32 PyTorch in this slice).

B problems built with numpy (noisy projections, 15% gross outliers, some
invalid terms) go through the reference's ``optimize_pose`` one at a time
and through the port's batched ``optimize_pose`` at once. The poses agree
within 1e-5 (f32 normal equations summed in another order), and the
inlier counts and ``good`` flags are identical; ``optimize_pose_plain``,
the plain version kernel I is held against on the card, is held the same
way (and its covariance within 1e-3 of the reference's largest entry).
Kernel I's lower median, a three-pass radix select over the norms' bits,
is emulated in numpy and held bit for bit against both masked medians.
``line_terms_rj`` and the joint-MAD ``_weights`` are also held directly
with real line terms (behind-camera endpoints and invalid lines
included): residuals within 2e-4 px (measured 6.1e-5; each cancels terms
of ~1e3 px), Jacobians within 1e-5 relative, weights within 1e-5, the MAD
scale (a lower median over the K + 2L norms) within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.core import robust as jrobust
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.features import line_equation
from plslam_tpu.tracking import pose_gn as jgn
from plslam_tpu_torch import convert
from plslam_tpu_torch.core import robust as trobust
from plslam_tpu_torch.tracking import pose_gn as tgn

CFG = SlamConfig()
CC = CFG.camera
JC = JCam.from_config(CC)
TC = convert.camera_from_numpy(CC.fx, CC.fy, CC.cx, CC.cy, CC.baseline,
                               CC.width, CC.height)
TCFG = convert.config_from_dict(CFG.to_dict())
# the reference as the VO runs it: jitted
_ref_optimize = jax.jit(jgn.optimize_pose, static_argnums=(4,))


def _problems(B, n_pts=180, n_lns=0, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        P = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-3, 3, n_pts),
                      rng.uniform(4, 40, n_pts)], -1).astype(np.float32)
        xi = (rng.normal(size=6) * [0.05, 0.05, 0.3, 0.01, 0.03, 0.01]
              ).astype(np.float32)
        T = np.array(jlie.exp_se3(jnp.asarray(xi)))
        uv = np.asarray(JC.project(jlie.transform_points(
            jnp.asarray(T), jnp.asarray(P))))
        uv = uv + rng.normal(0, 0.5, uv.shape)
        n_out = int(0.15 * n_pts)
        uv[:n_out] += rng.normal(0, 40, (n_out, 2))
        valid = rng.random(n_pts) > 0.05
        if b == B - 1:
            valid[:] = False
            valid[:8] = True           # too few features: gated not good
        sP = np.stack([rng.uniform(-8, 8, n_lns), rng.uniform(-3, 3, n_lns),
                       rng.uniform(4, 30, n_lns)], -1).astype(np.float32)
        d = rng.normal(size=(n_lns, 3))
        eP = (sP + 2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
              ).astype(np.float32)
        le = np.asarray(line_equation(
            JC.project(jlie.transform_points(jnp.asarray(T), jnp.asarray(sP))),
            JC.project(jlie.transform_points(jnp.asarray(T), jnp.asarray(eP)))))
        out.append(dict(P=P, uv=uv.astype(np.float32), valid=valid, sP=sP,
                        eP=eP, le=le, lvalid=np.full(n_lns, b < B - 1)))
    return out


@pytest.mark.parametrize("n_lns", [0, 24])
def test_optimize_pose_matches_reference(n_lns):
    probs = _problems(4, n_lns=n_lns, seed=n_lns)
    stack = {k: np.stack([p[k] for p in probs]) for k in probs[0]}
    T0 = np.eye(4, dtype=np.float32)
    pts = tgn.PointTerms(torch.from_numpy(stack["P"]),
                         torch.from_numpy(stack["uv"]),
                         torch.from_numpy(stack["valid"]))
    lns = (tgn.LineTerms(torch.from_numpy(stack["sP"]),
                         torch.from_numpy(stack["eP"]),
                         torch.from_numpy(stack["le"]),
                         torch.from_numpy(stack["lvalid"]))
           if n_lns else None)
    res = tgn.optimize_pose(torch.from_numpy(T0).expand(4, 4, 4), TC, pts,
                            lns, TCFG)
    for b, p in enumerate(probs):
        jl = (jgn.LineTerms(jnp.asarray(p["sP"]), jnp.asarray(p["eP"]),
                            jnp.asarray(p["le"]), jnp.asarray(p["lvalid"]))
              if n_lns else None)
        ref = _ref_optimize(
            jnp.asarray(T0), JC,
            jgn.PointTerms(jnp.asarray(p["P"]), jnp.asarray(p["uv"]),
                           jnp.asarray(p["valid"])), jl, CFG)
        assert bool(res.good[b]) == bool(ref.good)
        assert int(res.n_inliers[b]) == int(ref.n_inliers)
        np.testing.assert_array_equal(res.inlier_pt[b].numpy(),
                                      np.asarray(ref.inlier_pt))
        if b < len(probs) - 1:
            assert bool(ref.good)
            np.testing.assert_allclose(res.T[b].numpy(), np.asarray(ref.T),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(res.err[b].item(), float(ref.err),
                                       rtol=1e-4)
    assert not bool(res.good[-1])


def test_line_terms_and_joint_weights_match_reference():
    probs = _problems(3, n_pts=120, n_lns=40, seed=5)
    rng = np.random.default_rng(6)
    for p in probs:
        p["sP"][:3, 2] = -1.0                 # behind the camera
        p["lvalid"] = rng.random(40) > 0.15
    stack = {k: np.stack([p[k] for p in probs]) for k in probs[0]}
    xi = np.array([0.02, -0.01, 0.1, 0.003, -0.004, 0.002], np.float32)
    T = np.array(jlie.exp_se3(jnp.asarray(xi)))
    lt = tgn.LineTerms(*(torch.from_numpy(stack[k])
                         for k in ("sP", "eP", "le", "lvalid")))
    r, J, a = tgn.line_terms_rj(torch.from_numpy(T).expand(3, 4, 4), TC, lt)
    pt = tgn.PointTerms(torch.from_numpy(stack["P"]),
                        torch.from_numpy(stack["uv"]),
                        torch.from_numpy(stack["valid"]))
    _, _, n_pt = tgn.point_terms_rj(torch.from_numpy(T).expand(3, 4, 4), TC,
                                    pt)
    w_pt, w_ln, sigma = tgn._weights(n_pt, pt.valid, a, lt.valid)
    for b, p in enumerate(probs):
        jl = jgn.LineTerms(jnp.asarray(p["sP"]), jnp.asarray(p["eP"]),
                           jnp.asarray(p["le"]), jnp.asarray(p["lvalid"]))
        rr, rJ, ra = jgn.line_terms_rj(jnp.asarray(T), JC, jl)
        # r = le . (u, v, 1) cancels terms of ~1e3 px: a few f32 ulps there
        np.testing.assert_allclose(r[b].numpy(), rr, rtol=0, atol=2e-4)
        np.testing.assert_allclose(J[b].numpy(), rJ, rtol=1e-5, atol=1e-3)
        assert not np.asarray(rr)[:3].any()          # behind: zeroed
        _, _, rn = jgn.point_terms_rj(jnp.asarray(T), JC, jgn.PointTerms(
            jnp.asarray(p["P"]), jnp.asarray(p["uv"]),
            jnp.asarray(p["valid"])))
        rw_pt, rw_ln, rs = jgn._weights(rn, jnp.asarray(p["valid"]), ra,
                                        jnp.asarray(p["lvalid"]))
        np.testing.assert_allclose(sigma[b].item(), float(rs), rtol=1e-6)
        np.testing.assert_allclose(w_pt[b].numpy(), rw_pt, atol=1e-5)
        np.testing.assert_allclose(w_ln[b].numpy(), rw_ln, atol=1e-5)


def test_gn_phases_at_main_path_shapes_match_reference():
    """The GN phases as kernel I runs them (``gn_iters``: every iteration
    of a phase in one call) at the main path's term counts, K = 1024 point
    and L = 128 line terms: the whole optimize_pose against the reference,
    poses within 1e-5, inlier masks and ``good`` identical."""
    probs = _problems(3, n_pts=1024, n_lns=128, seed=11)
    stack = {k: np.stack([p[k] for p in probs]) for k in probs[0]}
    pts = tgn.PointTerms(torch.from_numpy(stack["P"]),
                         torch.from_numpy(stack["uv"]),
                         torch.from_numpy(stack["valid"]))
    lns = tgn.LineTerms(*(torch.from_numpy(stack[k])
                          for k in ("sP", "eP", "le", "lvalid")))
    T0 = torch.eye(4).expand(3, 4, 4)
    res = tgn.optimize_pose(T0, TC, pts, lns, TCFG)
    for b, p in enumerate(probs):
        ref = _ref_optimize(
            jnp.eye(4), JC,
            jgn.PointTerms(jnp.asarray(p["P"]), jnp.asarray(p["uv"]),
                           jnp.asarray(p["valid"])),
            jgn.LineTerms(jnp.asarray(p["sP"]), jnp.asarray(p["eP"]),
                          jnp.asarray(p["le"]), jnp.asarray(p["lvalid"])),
            CFG)
        assert bool(res.good[b]) == bool(ref.good)
        np.testing.assert_array_equal(res.inlier_pt[b].numpy(),
                                      np.asarray(ref.inlier_pt))
        np.testing.assert_array_equal(res.inlier_ln[b].numpy(),
                                      np.asarray(ref.inlier_ln))
        if b < len(probs) - 1:
            np.testing.assert_allclose(res.T[b].numpy(), np.asarray(ref.T),
                                       atol=1e-5, rtol=0)
    # one phase on its own: n iterations in one call equal n calls of one
    T_a = tgn.gn_iters(T0, TC, pts, lns, 3)
    T_b = T0
    for _ in range(3):
        T_b = tgn.gn_iters(T_b, TC, pts, lns, 1)
    assert torch.equal(T_a, T_b)


def _radix_lower_median(x, mask):
    """Kernel I's lower median (csrc/pose_gn.cu, csrc/radix_select.cuh) in
    numpy: every entry's key, the 31 bits below the sign (a masked entry:
    FLT_MAX's), the (n - 1) // 2-th smallest (0 where n = 0) found digit by
    digit, 11 + 10 + 10 bits, each a histogram of the keys that share the
    digits found so far and the bucket whose running count passes the
    rank."""
    keys = np.where(mask, np.float32(x), np.finfo(np.float32).max).astype(
        np.float32).view(np.uint32) & np.uint32(0x7FFFFFFF)
    n = int(mask.sum())
    if n == 0:
        return np.float32(0.0)
    k = (n - 1) // 2
    prefix, taken = 0, 0            # the digits found, and their bits
    for bits, shift in ((11, 20), (10, 10), (10, 0)):
        sel = keys[(keys >> np.uint32(shift + bits)) == prefix] \
            if taken else keys
        hist = np.bincount((sel >> np.uint32(shift)) & np.uint32(
            (1 << bits) - 1), minlength=1 << bits)
        below = np.cumsum(hist) - hist
        b = int(np.nonzero((below <= k) & (k < below + hist))[0][0])
        k -= int(below[b])
        prefix = (prefix << bits) | b
        taken += bits
    return np.uint32(prefix).view(np.float32)


def _median_cases():
    rng = np.random.default_rng(9)
    big = np.finfo(np.float32).max
    n = 1280
    cases = {
        "random": (rng.gamma(2.0, 0.7, n), rng.random(n) > 0.1),
        "ties": (rng.integers(0, 4, n) * 0.25, rng.random(n) > 0.3),
        "all_masked": (rng.random(n), np.zeros(n, bool)),
        "one_valid": (rng.random(n), np.arange(n) == 77),
        "even_count": (rng.random(n), np.arange(n) < 10),
        "zeros": (np.where(rng.random(n) < 0.6, 0.0, rng.random(n)),
                  rng.random(n) > 0.2),
        "sentinel_valid": (np.where(rng.random(n) < 0.7, big,
                                    rng.random(n)), rng.random(n) > 0.1),
        "subnormal_and_huge": (np.where(rng.random(n) < 0.5, 1e-40, 3e38),
                               np.ones(n, bool)),
        "one_bucket": (1.0 + rng.integers(0, 3, n) * 2.0 ** -23,
                       rng.random(n) > 0.5),
    }
    return {k: (np.asarray(x, np.float32), m) for k, (x, m) in cases.items()}


@pytest.mark.parametrize("case", sorted(_median_cases()))
def test_radix_select_median_is_both_masked_medians(case):
    """The emulated select returns the sort's float to the bit: ties, no
    valid entry (0), one, an even count (the lower middle), exact zeros,
    valid entries equal to the FLT_MAX sentinel, subnormals, keys that
    share their first 21 bits."""
    x, m = _median_cases()[case]
    got = _radix_lower_median(x, m)
    ref_t = trobust.masked_median(torch.from_numpy(x), torch.from_numpy(m))
    ref_j = np.float32(jrobust.masked_median(jnp.asarray(x),
                                             jnp.asarray(m)))
    assert got.view(np.uint32) == np.float32(ref_t).view(np.uint32)
    assert got.view(np.uint32) == ref_j.view(np.uint32)


@pytest.mark.parametrize("n_lns", [0, 16])
def test_optimize_pose_plain_matches_reference(n_lns):
    """optimize_pose_plain by name (what the card's kernel is held
    against) against the reference, every PoseResult field."""
    probs = _problems(3, n_pts=120, n_lns=n_lns, seed=20 + n_lns)
    stack = {k: np.stack([p[k] for p in probs]) for k in probs[0]}
    pts = tgn.PointTerms(*(torch.from_numpy(stack[k])
                           for k in ("P", "uv", "valid")))
    lns = (tgn.LineTerms(*(torch.from_numpy(stack[k])
                           for k in ("sP", "eP", "le", "lvalid")))
           if n_lns else None)
    res = tgn.optimize_pose_plain(torch.eye(4).expand(3, 4, 4), TC, pts,
                                  lns, TCFG)
    for b, p in enumerate(probs):
        jl = (jgn.LineTerms(*(jnp.asarray(p[k])
                              for k in ("sP", "eP", "le", "lvalid")))
              if n_lns else None)
        ref = _ref_optimize(jnp.eye(4), JC, jgn.PointTerms(
            *(jnp.asarray(p[k]) for k in ("P", "uv", "valid"))), jl, CFG)
        assert bool(res.good[b]) == bool(ref.good)
        assert int(res.n_inliers[b]) == int(ref.n_inliers)
        np.testing.assert_array_equal(res.inlier_pt[b].numpy(),
                                      np.asarray(ref.inlier_pt))
        np.testing.assert_array_equal(res.inlier_ln[b].numpy(),
                                      np.asarray(ref.inlier_ln))
        if b < len(probs) - 1:
            np.testing.assert_allclose(res.T[b].numpy(), np.asarray(ref.T),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(res.err[b].item(), float(ref.err),
                                       rtol=1e-4)
            cov = np.asarray(ref.cov)
            assert np.abs(res.cov[b].numpy() - cov).max() <= (
                1e-3 * np.abs(cov).max())
