"""Port parity: tracking/pose_gn.py::optimize_pose_lm (K13's LM mode).

tests/test_pose_gn.py's problems (its ``make_problem``) go through the
reference's ``optimize_pose_lm`` and the port's (B = 1, the plain version
on the CPU): with and without lines, lines only (K = 0) and the two
degenerate cases (8 features; every term invalid), padded with invalid
terms to the points problem's 200 (one compile). The poses agree
within 1e-5, err within 1e-4 relative, the inlier masks, n_inliers and
``good`` exactly. The LM's own iterations are held the same way
(``lm_iters_plain`` against the reference's ``lm_iter`` loop, the accept
sequence read from lambda), and a batch of problems equals the problems
one at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.core import lie as jlie
from plslam_tpu.frontend.features import line_equation
from plslam_tpu.tracking import pose_gn as jgn
from plslam_tpu_torch import convert
from plslam_tpu_torch.tracking import pose_gn as tgn
from test_pose_gn import CAM as JCAM, CFG, make_problem

TCFG = convert.config_from_dict(CFG.to_dict())
_ref_lm = jax.jit(jgn.optimize_pose_lm, static_argnums=(4,))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcam():
    return convert.camera_from_numpy(
        float(JCAM.fx), float(JCAM.fy), float(JCAM.cx), float(JCAM.cy),
        float(JCAM.b), JCAM.width, JCAM.height)


def _case(name):
    """(reference PointTerms, LineTerms or None) of a named problem."""
    if name in ("points", "points_lines"):
        _, pts, lns = make_problem(jax.random.PRNGKey(6), noise=0.2)
        return pts, (lns if name == "points_lines" else None)
    if name == "lines_only":
        # test_gn_lines_only's problem, its observed endpoints with 0.5 px
        # of noise: exact lines leave err at f32 rounding (~5e-5 px)
        T_gt, _, lns = make_problem(jax.random.PRNGKey(2), n_lns=80)
        rng = np.random.default_rng(2)
        px = lambda P: JCAM.project(jlie.transform_points(T_gt, P)) + \
            rng.normal(0, 0.5, (80, 2)).astype(np.float32)
        lns = lns._replace(le_obs=line_equation(px(lns.sP), px(lns.eP)))
        empty = jgn.PointTerms(jnp.zeros((0, 3)), jnp.zeros((0, 2)),
                               jnp.zeros((0,), bool))
        return empty, lns
    # the degenerate problems padded with invalid terms to the points
    # problem's K = 200 (one compile of the reference for the three)
    if name == "too_few":
        _, pts, _ = make_problem(jax.random.PRNGKey(5), n_pts=8)
    else:
        assert name == "all_invalid"
        pts = jgn.PointTerms(jnp.ones((16, 3)), jnp.ones((16, 2)),
                             jnp.zeros((16,), bool))
    pad = lambda x, v: jnp.concatenate(
        [x, jnp.full((200 - len(x),) + x.shape[1:], v, x.dtype)])
    return jgn.PointTerms(pad(pts.P, 1.0), pad(pts.uv_obs, 0.0),
                          pad(pts.valid, False)), None


def _port_terms(pts, lns):
    t = lambda x: torch.from_numpy(np.array(x))[None]
    tp = tgn.PointTerms(t(pts.P), t(pts.uv_obs), t(pts.valid))
    tl = (None if lns is None else
          tgn.LineTerms(t(lns.sP), t(lns.eP), t(lns.le_obs), t(lns.valid)))
    return tp, tl


@pytest.mark.parametrize("name", ["points", "points_lines", "lines_only",
                                  "too_few", "all_invalid"])
def test_optimize_pose_lm_matches_reference(name):
    pts, lns = _case(name)
    ref = _ref_lm(jnp.eye(4), JCAM, pts, lns, CFG)
    tp, tl = _port_terms(pts, lns)
    got = tgn.optimize_pose_lm(torch.eye(4)[None], _tcam(), tp, tl, TCFG)
    assert bool(got.good[0]) == bool(ref.good)
    assert int(got.n_inliers[0]) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inlier_pt[0].numpy(),
                                  np.asarray(ref.inlier_pt))
    np.testing.assert_array_equal(got.inlier_ln[0].numpy(),
                                  np.asarray(ref.inlier_ln))
    assert torch.isfinite(got.T).all()
    if name in ("too_few", "all_invalid"):
        assert not bool(got.good[0])
        return
    assert bool(ref.good)
    np.testing.assert_allclose(got.T[0].numpy(), np.asarray(ref.T),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.err[0].item(), float(ref.err), rtol=1e-4)


def _ref_lm_iters(T, pts, lns, n):
    """The reference's ``lm_iter`` loop (pose_gn.py:207-231) unrolled, with
    lambda after each iteration."""
    tcfg = CFG.tracking

    def cost(T):
        _, _, n_pt = jgn.point_terms_rj(T, JCAM, pts)
        _, _, a_ln = jgn.line_terms_rj(T, JCAM, lns)
        w_pt, w_ln, _ = jgn._weights(n_pt, pts.valid, a_ln, lns.valid)
        return jnp.sum(w_pt * n_pt ** 2) + jnp.sum(w_ln * a_ln ** 2)

    @jax.jit
    def step(T, lam, c):
        r_pt, J_pt, n_pt = jgn.point_terms_rj(T, JCAM, pts)
        r_ln, J_ln, a_ln = jgn.line_terms_rj(T, JCAM, lns)
        w_pt, w_ln, _ = jgn._weights(n_pt, pts.valid, a_ln, lns.valid)
        H, g = jgn._assemble_normal_eqs(r_pt, J_pt, w_pt, r_ln, J_ln, w_ln)
        Hd = H + lam * jnp.diag(jnp.diagonal(H)) + 1e-9 * jnp.eye(6)
        T_try = jlie.mm(jlie.exp_se3(-jnp.linalg.solve(Hd, g)), T)
        c_try = cost(T_try)
        acc = jnp.isfinite(c_try) & (c_try < c)
        return (jnp.where(acc, T_try, T), jnp.where(acc, lam * 0.33, lam * 3.0),
                jnp.where(acc, c_try, c), c_try)

    lam, c, lams, c_tries = jnp.asarray(tcfg.lm_init_lambda), cost(T), [], []
    for _ in range(n):
        T, lam, c, c_try = step(T, lam, c)
        lams.append(float(lam))
        c_tries.append(float(c_try))
    return np.asarray(T), np.asarray(lams, np.float32), np.asarray(c_tries)


def test_lm_iterations_match_reference():
    """The LM phase alone on the lines problem: the same lambda after every
    iteration (so the same accept sequence), the pose within 1e-5, each
    trial cost within 1e-3 relative (the first trial, a long step from the
    identity, differs by 1.5e-4: the f32 rounding of the step times the
    cost's slope there); two problems batched equal each alone."""
    pts, lns = _case("points_lines")
    n = 2 * CFG.tracking.max_iters
    T_ref, lam_ref, c_ref = _ref_lm_iters(jnp.eye(4), pts, lns, n)
    tp, tl = _port_terms(pts, lns)
    T, tr = tgn.lm_iters_plain(torch.eye(4)[None], _tcam(), tp, tl, n,
                               TCFG.tracking.lm_init_lambda)
    np.testing.assert_array_equal(tr.lam[0].numpy(), lam_ref)
    np.testing.assert_allclose(tr.cost[0, :, 1].numpy(), c_ref, rtol=1e-3)
    np.testing.assert_allclose(T[0].numpy(), T_ref, atol=1e-5, rtol=0)
    assert (np.diff(tr.lam[0].numpy()) < 0).any()       # accepted steps
    # a batch: this problem and the no-lines one (its line terms invalid)
    tp2, _ = _port_terms(*_case("points"))
    tl2 = tl._replace(valid=torch.zeros_like(tl.valid))
    both = lambda a, b: torch.cat([a, b])
    pts_b = tgn.PointTerms(*map(both, tp, tp2))
    lns_b = tgn.LineTerms(*map(both, tl, tl2))
    res_b = tgn.optimize_pose_lm(torch.eye(4).expand(2, 4, 4), _tcam(),
                                 pts_b, lns_b, TCFG)
    for i, (p, l) in enumerate(((tp, tl), (tp2, tl2))):
        one = tgn.optimize_pose_lm(torch.eye(4)[None], _tcam(), p, l, TCFG)
        np.testing.assert_allclose(res_b.T[i].numpy(), one.T[0].numpy(),
                                   atol=1e-6, rtol=0)
        assert torch.equal(res_b.inlier_pt[i], one.inlier_pt[0])
        assert bool(res_b.good[i]) == bool(one.good[0])
