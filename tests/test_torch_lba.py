"""Port parity: backend/lba.py (K15) and the new core/lie.py helpers.

Problems are built like tests/test_lba.py::make_lba_problem (W=5 poses,
P=120 points, Q=40 line endpoints, every KF observing every landmark, the
first KF fixed) with numpy randomness (``test_torch_gpu.lba_problem_np``),
10% of the observations detached and three points put behind the cameras
(the lost-observation charge). The same problem goes to the jitted
reference and to the port's plain versions on the CPU.

Tolerances and what was measured on these problems:
  * validity masks, post-hoc inlier masks: identical;
  * residuals within 2e-4 px absolute (each cancels terms of ~1e3 px),
    Jacobians within 1e-5 relative (1e-3 absolute);
  * the robust cost within 1e-5 relative;
  * one damped step and the whole LM (6 iterations): each output within
    three times the reference's own f32 error (its distance from the
    port's float64 evaluation of the same problem, relative to the
    output's largest magnitude) plus 1e-6. At lambda = 1e-3 the endpoint
    blocks are nearly singular along their lines (one scalar residual per
    observation), so f32 sum order moves the endpoint steps: measured
    port-vs-reference 2e-4 to 9e-3 where the reference itself is 1e-4 to
    4e-3 from float64; poses and points agree to ~1e-6. Costs within
    1e-4 relative; the LM's accept/reject decisions are identical, and
    the smallest relative margin |c_try - c| / c between two compared
    costs is recorded (a margin under 1e-5 could flip on f32 noise);
  * the Schur step against a dense f64 assembly of the full normal
    equations as the reference's own test_schur_equals_dense does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import lba as jlba
from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.core import robust as jrobust
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import lba as tlba
from plslam_tpu_torch.core import lie as tlie
from test_torch_gpu import MEDIAN_CASES, lba_median_problem_np, lba_problem_np

CFG = SlamConfig()
JC = JCam.from_config(CFG.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
_ref_cost = jax.jit(jlba.lba_cost)
_ref_step = jax.jit(jlba._assemble_and_solve)
_ref_posthoc = jax.jit(jlba.posthoc_inliers, static_argnums=(2,))
_ref_point_rj = jax.jit(jlba._point_rj)
_ref_endpoint_rj = jax.jit(jlba._endpoint_rj)


def _problem(seed, **kw):
    d, cam = lba_problem_np(seed, **kw)
    d["pt_pos"][:3, 2] = -5.0                  # behind every camera: lost
    jp = jlba.LBAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    tp = tlba.LBAProblem(**{k: torch.from_numpy(v) for k, v in d.items()})
    return jp, tp, cam


@pytest.fixture(scope="module")
def problem():
    return _problem(0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _f64(tp):
    return tlba.LBAProblem(*(x.double() if x.is_floating_point() else x
                             for x in tp))


def _in_band(got, want, truth):
    """The port within 3x the reference's own f32 error (+ 1e-6)."""
    got, truth = np.asarray(got), np.asarray(truth)
    assert _rel(got, want) <= 3.0 * _rel(want, truth) + 1e-6, (
        _rel(got, want), _rel(want, truth))


def test_inv3_adjoint_and_distance_match_reference():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(200, 3, 3))
    M = (A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3)).astype(np.float32)
    M[:20] *= 1e-7                                # damped-but-empty blocks
    np.testing.assert_allclose(tlie.inv3(torch.from_numpy(M)).numpy(),
                               np.asarray(jlie.inv3(jnp.asarray(M))),
                               rtol=1e-4, atol=0)
    xi = (rng.normal(size=(50, 6)) * 0.3).astype(np.float32)
    T = np.asarray(jax.vmap(jlie.exp_se3)(jnp.asarray(xi)))
    np.testing.assert_allclose(
        tlie.adjoint_se3(torch.from_numpy(T)).numpy(),
        np.asarray(jlie.adjoint_se3(jnp.asarray(T))), rtol=1e-6, atol=1e-6)
    for got, want in zip(tlie.se3_distance(torch.from_numpy(T)),
                         jlie.se3_distance(jnp.asarray(T))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_point_and_endpoint_terms_match_reference(problem):
    jp, tp, cam = problem
    got = tlba._point_rj(tp.kf_pose, tp.pt_pos, tp.obs_pt_uv, tp.obs_pt_disp,
                         tp.obs_pt_id, cam)
    want = _ref_point_rj(jp.kf_pose, jp.pt_pos, jp.obs_pt_uv,
                         jp.obs_pt_disp, jp.obs_pt_id, JC)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert (~got[3].numpy()).sum() > 3 * 5 * 0.9      # behind + detached
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=2e-4)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-3)
    for ids_t, ids_j in ((tp.obs_ln_sid, jp.obs_ln_sid),
                         (tp.obs_ln_eid, jp.obs_ln_eid)):
        got = tlba._endpoint_rj(tp.kf_pose, tp.ep_pos, tp.obs_ln_le, ids_t,
                                cam)
        want = _ref_endpoint_rj(jp.kf_pose, jp.ep_pos, jp.obs_ln_le, ids_j,
                                JC)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                                   atol=2e-4)
        for g, w in zip(got[1:3], want[1:3]):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-3)


def test_lba_cost_matches_reference(problem):
    jp, tp, cam = problem
    got = float(tlba.lba_cost(tp, cam))
    want = float(_ref_cost(jp, JC))
    assert abs(got - want) <= 1e-5 * abs(want)
    # the charge: the 3 points behind all 5 cameras cost (dof+1) sigma^2
    # per observation that is still attached
    _, sigma, _ = tlba.lba_terms_sigma(tp, cam)
    n_lost = int((tp.obs_pt_id[:, :3] >= 0).sum())
    assert n_lost >= 10 and got > 6.0 * float(sigma) ** 2 * n_lost


@pytest.mark.parametrize("case", MEDIAN_CASES)
def test_terms_sigma_median_cases_match_reference(case):
    """The fused terms op (its plain version here) against the reference's
    _robust_sigma over the reference's own terms and its lba_cost, on
    problems whose valid |r| are chosen bit for bit
    (test_torch_gpu.lba_median_problem_np): the scale to the bit, the cost
    within 1e-5 relative, the number of valid values as built."""
    d, cam, m = lba_median_problem_np(case)
    jp = jlba.LBAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    tp = tlba.LBAProblem(**{k: torch.from_numpy(v) for k, v in d.items()})
    t, sigma, cost = tlba.lba_terms_sigma(tp, cam)
    assert int(t.ok_pt.sum() + t.ok_ln.sum()) == m
    r, _, _, ok = _ref_point_rj(jp.kf_pose, jp.pt_pos, jp.obs_pt_uv,
                                jp.obs_pt_disp, jp.obs_pt_id, JC)
    rn = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
    rs, _, _, oks = _ref_endpoint_rj(jp.kf_pose, jp.ep_pos, jp.obs_ln_le,
                                     jp.obs_ln_sid, JC)
    re, _, _, oke = _ref_endpoint_rj(jp.kf_pose, jp.ep_pos, jp.obs_ln_le,
                                     jp.obs_ln_eid, JC)
    want = np.float32(jlba._robust_sigma(rn, ok, rs, oks, re, oke))
    assert np.float32(sigma.numpy()).view(np.int32) == want.view(np.int32), (
        float(sigma), float(want))
    want_cost = float(_ref_cost(jp, JC))
    assert abs(float(cost) - want_cost) <= 1e-5 * want_cost


@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_one_damped_step_matches_reference(problem, lam):
    jp, tp, cam = problem
    got = tlba._assemble_and_solve(tp, cam, lam)
    want = _ref_step(jp, JC, jnp.float32(lam))
    truth = tlba._assemble_and_solve(_f64(tp), cam, lam)
    for g, w, t in zip(got, want, truth):
        _in_band(g.numpy(), w, t.numpy())
    idx = tlba.lba_index_plain(tp)
    capped = tlba._step(tp, cam, lam, tlba._PLAIN, idx)
    truth_c = tlba._step(_f64(tp), cam, lam, tlba._PLAIN, idx)
    for g, w, t in zip(capped, jlba._cap_steps(*want), truth_c):
        _in_band(g.numpy(), w, t.numpy())


def test_schur_equals_dense():
    """The port's Schur step equals the dense normal-equation step on a
    small point-only problem (the reference's test_schur_equals_dense)."""
    d, cam = lba_problem_np(3, W=3, P=25, Q=2, noise_px=0.1, drop=0.0)
    d["obs_ln_sid"][:] = -1
    d["obs_ln_eid"][:] = -1
    prob = tlba.LBAProblem(**{k: torch.from_numpy(v) for k, v in d.items()})
    lam = 1e-4
    dxi, d_pt, _ = tlba._assemble_and_solve(prob, cam, lam)
    W, P = 3, 25
    r, Jc, Jp, ok = tlba._point_rj(prob.kf_pose, prob.pt_pos, prob.obs_pt_uv,
                                   prob.obs_pt_disp, prob.obs_pt_id, cam)
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    sigma = jrobust.mad_scale_zero_centered(jnp.asarray(rn.reshape(-1)),
                                            jnp.asarray(ok.reshape(-1)))
    wgt = np.where(ok, np.asarray(jrobust.tstudent_weight(
        jnp.asarray(rn), sigma)), 0.0)
    Jc = np.where((~prob.kf_fixed).numpy()[:, None, None, None], Jc, 0.0)
    n = 6 * W + 3 * P
    H = np.zeros((n, n))
    g = np.zeros(n)
    ids = prob.obs_pt_id.numpy()
    for w_i in range(W):
        for k in range(P):
            if not bool(ok[w_i, k]):
                continue
            p = ids[w_i, k]
            Jrow = np.zeros((3, n))
            Jrow[:, 6 * w_i:6 * w_i + 6] = Jc[w_i, k]
            Jrow[:, 6 * W + 3 * p:6 * W + 3 * p + 3] = Jp[w_i, k].numpy()
            H += wgt[w_i, k] * Jrow.T @ Jrow
            g += wgt[w_i, k] * Jrow.T @ r[w_i, k].numpy()
    H += np.diag(lam * np.maximum(np.diag(H).copy(), 1e-3))
    H[0:6, 0:6] += 1e8 * np.eye(6)                      # pin fixed KF 0
    H += 1e-6 * np.eye(n)
    delta = -np.linalg.solve(H, g)
    np.testing.assert_allclose(dxi.numpy(), delta[:6 * W].reshape(W, 6),
                               atol=2e-3)
    np.testing.assert_allclose(d_pt.numpy(), delta[6 * W:].reshape(P, 3),
                               rtol=2e-2, atol=5e-3)


def _decisions(prob, cam, cfg):
    """The port's LM accept/reject sequence and the smallest relative
    margin between the two costs compared."""
    m = cfg.mapping
    cost = tlba._cost(prob, cam, tlba._PLAIN)
    lam = torch.tensor(m.lambda_init)
    out, margin = [], np.inf
    for _ in range(m.lba_iters):
        dxi, d_pt, d_ep = tlba._step(prob, cam, lam, tlba._PLAIN,
                                     tlba.lba_index_plain(prob))
        trial = prob._replace(kf_pose=tlie.exp_se3(dxi) @ prob.kf_pose,
                              pt_pos=prob.pt_pos + d_pt,
                              ep_pos=prob.ep_pos + d_ep)
        c_try = tlba._cost(trial, cam, tlba._PLAIN)
        acc = bool(c_try < cost)
        margin = min(margin, abs(float(c_try - cost)) / float(cost))
        out.append(acc)
        if acc:
            prob, cost, lam = trial, c_try, lam / m.lambda_factor
        else:
            lam = lam * m.lambda_factor
    return out, margin


@pytest.mark.parametrize("seed", [0, 1])
def test_run_lba_and_posthoc_match_reference(seed):
    jp, tp, cam = _problem(seed)
    got = tlba.run_lba(tp, cam, TCFG)
    want = jlba.run_lba(jp, JC, CFG)
    truth = tlba.run_lba(_f64(tp), cam, TCFG)
    for name in ("kf_pose", "pt_pos", "ep_pos"):
        _in_band(getattr(got, name).numpy(), getattr(want, name),
                 getattr(truth, name).numpy())
    for name in ("cost0", "cost1"):
        assert abs(float(getattr(got, name)) - float(getattr(want, name))) \
            <= 1e-4 * float(getattr(want, name))
    assert float(got.cost1) < 0.01 * float(got.cost0)
    np.testing.assert_array_equal(got.obs_pt_inlier.numpy(),
                                  np.asarray(want.obs_pt_inlier))
    np.testing.assert_array_equal(got.obs_ln_inlier.numpy(),
                                  np.asarray(want.obs_ln_inlier))
    accepts, margin = _decisions(tp, cam, TCFG)
    print(f"LM decisions {accepts}, smallest relative cost margin {margin:g}")
    assert margin > 1e-5
    # post-hoc flags on their own, at the solved state
    solved_t = tp._replace(kf_pose=got.kf_pose, pt_pos=got.pt_pos,
                           ep_pos=got.ep_pos)
    solved_j = jp._replace(kf_pose=jnp.asarray(got.kf_pose.numpy()),
                           pt_pos=jnp.asarray(got.pt_pos.numpy()),
                           ep_pos=jnp.asarray(got.ep_pos.numpy()))
    for g, w in zip(tlba.posthoc_inliers(solved_t, cam, TCFG),
                    _ref_posthoc(solved_j, JC, CFG)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the landmark index of the binning launch (lba_index) ----------------------

def _index_ids(seed):
    """Id tables: lba_problem_np's (seed 0), or random ones with repeated
    slots within a pose, detached (-1) and out-of-range ids (seed 1)."""
    if seed == 0:
        d, _ = lba_problem_np(0)
        P, Q = d["pt_pos"].shape[0], d["ep_pos"].shape[0]
        return d["obs_pt_id"], d["obs_ln_sid"], d["obs_ln_eid"], P, Q
    rng = np.random.default_rng(seed)
    W, K, L, P, Q = 6, 50, 12, 40, 16
    obs_id = rng.integers(-2, P + 2, (W, K)).astype(np.int32)
    sid = rng.integers(-1, Q + 1, (W, L)).astype(np.int32)
    eid = rng.integers(-1, Q + 1, (W, L)).astype(np.int32)
    return obs_id, sid, eid, P, Q


@pytest.mark.parametrize("seed", [0, 1])
def test_lba_index_plain_lists_each_observation_in_order(seed):
    """Every attached observation once, under its slot, in (pose, family,
    k) order, with the right counts: a numpy loop over the id tables."""
    obs_id, sid, eid, P, Q = _index_ids(seed)
    (W, K), L = obs_id.shape, sid.shape[1]
    want = [[] for _ in range(P + Q)]
    for w in range(W):
        for k in range(K):
            if 0 <= obs_id[w, k] < P:
                want[obs_id[w, k]].append(w * K + k)
        for f, ids in enumerate((sid, eid)):
            for k in range(L):
                if 0 <= ids[w, k] < Q:
                    want[P + ids[w, k]].append(W * K + (2 * w + f) * L + k)
    prob = tlba.LBAProblem(
        kf_pose=torch.zeros(W, 4, 4), kf_fixed=torch.zeros(W, dtype=bool),
        kf_valid=torch.ones(W, dtype=bool), pt_pos=torch.zeros(P, 3),
        ep_pos=torch.zeros(Q, 3), obs_pt_uv=torch.zeros(W, K, 2),
        obs_pt_disp=torch.zeros(W, K), obs_pt_id=torch.from_numpy(obs_id),
        obs_ln_le=torch.zeros(W, L, 3), obs_ln_sid=torch.from_numpy(sid),
        obs_ln_eid=torch.from_numpy(eid))
    idx = tlba.lba_index(prob)                  # the plain version on CPU
    assert idx.off.dtype == idx.obs.dtype == torch.int32
    counts = np.array([len(x) for x in want])
    np.testing.assert_array_equal(idx.off.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    flat = np.concatenate([np.asarray(x, np.int64) for x in want])
    total = int(counts.sum())
    np.testing.assert_array_equal(idx.obs[:total].numpy(), flat)
    assert np.all(idx.obs[total:].numpy() == -1)
    assert total == int(((obs_id >= 0) & (obs_id < P)).sum()
                        + ((sid >= 0) & (sid < Q)).sum()
                        + ((eid >= 0) & (eid < Q)).sum())


def _ids_problem(obs_id, sid, eid, P, Q):
    """An LBAProblem of the id tables alone (lba_index reads nothing else)."""
    (W, K), L = obs_id.shape, sid.shape[1]
    return tlba.LBAProblem(
        kf_pose=torch.zeros(W, 4, 4), kf_fixed=torch.zeros(W, dtype=bool),
        kf_valid=torch.ones(W, dtype=bool), pt_pos=torch.zeros(P, 3),
        ep_pos=torch.zeros(Q, 3), obs_pt_uv=torch.zeros(W, K, 2),
        obs_pt_disp=torch.zeros(W, K), obs_pt_id=torch.from_numpy(obs_id),
        obs_ln_le=torch.zeros(W, L, 3), obs_ln_sid=torch.from_numpy(sid),
        obs_ln_eid=torch.from_numpy(eid))


def _index_window(case, rng):
    """Id tables of lba_index's cases: a window with detached observations,
    out-of-range ids and empty slots; one where every landmark is seen by
    every pose (chip_smoke.py's K = 4,096 window: P = K); every observation
    detached; ids repeated within a pose; more slots than one CTA owns."""
    W, K, L, P, Q = {"random": (6, 50, 12, 40, 16),
                     "every_pose": (10, 64, 8, 64, 16),
                     "detached": (4, 30, 5, 20, 10),
                     "repeats": (5, 40, 6, 6, 3),
                     "many_slots": (3, 900, 20, 2500, 300)}[case]
    obs_id = rng.integers(-2, P + 2, (W, K))
    sid = rng.integers(-1, Q + 1, (W, L))
    eid = rng.integers(-1, Q + 1, (W, L))
    if case == "every_pose":
        obs_id = np.stack([(7 * w + np.arange(K)) % P for w in range(W)])
        sid = np.stack([(3 * w + 2 * np.arange(L)) % Q for w in range(W)])
        eid = sid + 1
        obs_id[rng.random(obs_id.shape) < 0.1] = -1
    elif case == "detached":
        obs_id[:] = -1
        sid[:] = Q
        eid[:] = -3
    elif case == "many_slots":
        obs_id[:, ::7] = -1
        obs_id[obs_id == 17] = 18          # an empty slot
    return (obs_id.astype(np.int32), sid.astype(np.int32),
            eid.astype(np.int32), P, Q)


def _index_by_ctas(obs_id, sid, eid, P, Q, rng):
    """lba_index_kernel's algorithm in numpy: C CTAs of S slots
    (index_layout); each counts its slots and the observations of lower
    slots (its base), turns the counts into each slot's end, scatters its
    observations into their slots' ranges in an arbitrary order (a random
    one here, as the shared atomics take it: each cursor counting down),
    and places each observation at its slot's start plus the members of
    the slot below it."""
    (W, K), L = obs_id.shape, sid.shape[1]
    T, N = W * K + 2 * W * L, P + Q
    C, S = tlba.index_layout(W, K, L, P, Q)
    ln = np.stack([sid, eid], axis=1).reshape(-1)            # (w, family, k)
    slot = np.concatenate([np.where((obs_id.reshape(-1) >= 0)
                                    & (obs_id.reshape(-1) < P),
                                    obs_id.reshape(-1), -1),
                           np.where((ln >= 0) & (ln < Q), ln + P, -1)])
    off = np.full(N + 1, -7, np.int64)
    lst = np.full(T, -7, np.int64)
    for c in range(C):
        lo = c * S
        ns = max(0, min(S, N - lo))
        base = int(((slot >= 0) & (slot < lo)).sum())
        own = np.flatnonzero((slot >= lo) & (slot < lo + ns))
        cur = np.cumsum(np.bincount(slot[own] - lo, minlength=ns))
        cur = np.concatenate([cur, [cur[-1] if ns else 0]])
        mem = np.full(T, -1, np.int64)
        for g in rng.permutation(own):
            cur[slot[g] - lo] -= 1
            mem[cur[slot[g] - lo]] = g
        for g in own:
            b, e = cur[slot[g] - lo], cur[slot[g] - lo + 1]
            lst[base + b + int((mem[b:e] < g).sum())] = g
        off[lo:lo + ns] = base + cur[:ns]
        if c == C - 1:
            off[N] = base + cur[ns]
            lst[base + cur[ns]:] = -1
    return off, lst


@pytest.mark.parametrize("case", ["random", "every_pose", "detached",
                                  "repeats", "many_slots"])
def test_lba_index_ranking_matches_plain(case):
    """The kernel's stable ranking (``_index_by_ctas``, two scatter orders)
    equals lba_index_plain: offsets and lists exactly, every entry written
    once."""
    rng = np.random.default_rng(["random", "every_pose", "detached",
                                 "repeats", "many_slots"].index(case))
    obs_id, sid, eid, P, Q = _index_window(case, rng)
    want = tlba.lba_index_plain(_ids_problem(obs_id, sid, eid, P, Q))
    for _ in range(2):
        off, lst = _index_by_ctas(obs_id, sid, eid, P, Q, rng)
        np.testing.assert_array_equal(off, want.off.numpy())
        np.testing.assert_array_equal(lst, want.obs.numpy())
    if case == "many_slots":
        assert tlba.index_layout(*obs_id.shape, sid.shape[1], P, Q)[0] == 11


@pytest.mark.parametrize("shape,layout", [
    ((10, 1024, 128, 4096, 1024), (20, 256)),    # the path's window
    ((10, 4096, 128, 4096, 1024), (20, 256)),    # chip_smoke.py's K = 4,096
    ((5, 120, 12, 120, 40), (1, 160)),
    ((1, 1, 0, 0, 0), (1, 0)),
    ((10, 5000, 300, 100, 100), (1, 200)),       # 56,000 observations
    ((1, 0, 0, 65535, 0), (256, 256))])
def test_index_layout_takes_the_path_shapes(shape, layout):
    C, S = tlba.index_layout(*shape)
    assert (C, S) == layout
    W, K, L, P, Q = shape
    assert (C - 1) * S < max(P + Q, 1) and C * S >= P + Q
    assert 4 * (S + 1) + 4 * (W * K + 2 * W * L) <= tlba.IDX_MAX_SMEM


@pytest.mark.parametrize("shape", [
    (10, 6000, 128, 4096, 1024),     # 62,560 observations: past the memory
    (10, 6554, 0, 10, 10),           # 65,540 observations: past uint16
    (1, 1, 1, 65535, 1),             # 65,536 slots
    (-1, 10, 1, 5, 5), (2, 10, -1, 5, 5), (2, 10, 1, -5, 5)])
def test_index_layout_refuses_what_the_launch_cannot_take(shape):
    with pytest.raises(ValueError):
        tlba.index_layout(*shape)


def test_index_layout_matches_kernel():
    """index_layout's limits are csrc/lba.cu's: the threads a CTA, the
    uint16 limits and the shared memory."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tlba.__file__), os.pardir,
                            "csrc", "lba.cu")).read()
    consts = {k: eval(v) for k, v in re.findall(
        r"constexpr int (IDX_\w+) = ([^;]+);", src)}
    assert consts["IDX_NT"] == tlba.IDX_NT
    assert consts["IDX_MAX_T"] == tlba.IDX_MAX_T
    assert consts["IDX_MAX_N"] == tlba.IDX_MAX_N
    assert consts["IDX_MAX_SMEM"] == tlba.IDX_MAX_SMEM


# -- one LM step after the blocks (lba_solve) ----------------------------------

def _solve_case(case):
    """lba_problem_np (seed 2) bent to reach one branch of the step:
    "pinned", free KF 2 with every observation detached (no support: its
    pin holds it); "floor", point 0 put 1e5 m down every camera's axis and
    observed there, so its H_ll trace is under the 1e-2 floor; "caps",
    poses perturbed by 0.6 and points by 30 m, so the steps pass the 1 m
    and 10 m caps."""
    kw = dict(pose_noise=0.6, pt_noise=30.0) if case == "caps" else {}
    d, cam = lba_problem_np(2, **kw)
    if case == "pinned":
        d["obs_pt_id"][2] = -1
        d["obs_ln_sid"][2] = -1
        d["obs_ln_eid"][2] = -1
    if case == "floor":
        far = np.array([0.0, 0.0, 1e5], np.float32)
        d["pt_pos"][0] = far
        T = d["kf_pose"]
        Pc = T[:, :3, :3] @ far + T[:, :3, 3]
        d["obs_pt_uv"][:, 0] = np.stack(
            [cam.fx * Pc[:, 0] / Pc[:, 2] + cam.cx,
             cam.fy * Pc[:, 1] / Pc[:, 2] + cam.cy], -1)
        d["obs_pt_disp"][:, 0] = cam.fx * cam.b / Pc[:, 2]
        d["obs_pt_id"][:, 0] = 0
    jp = jlba.LBAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    tp = tlba.LBAProblem(**{k: torch.from_numpy(v) for k, v in d.items()})
    return jp, tp, cam


@pytest.mark.parametrize("case", ["pinned", "floor", "caps"])
def test_lba_solve_plain_matches_reference(case):
    """lba_solve_plain on the port's blocks against the reference's
    _assemble_and_solve + _cap_steps on the same problem: each output in
    the file's band (3x the reference's distance from float64 + 1e-6),
    and the branch the case builds taken."""
    jp, tp, cam = _solve_case(case)
    lam = 1e-3
    P = tp.pt_pos.shape[0]
    want = jlba._cap_steps(*_ref_step(jp, JC, jnp.float32(lam)))

    def solve(prob):
        t, sigma, _ = tlba.lba_terms_sigma_plain(prob, cam)
        free = tlba._free(prob)
        lam_t = torch.tensor(lam, dtype=prob.kf_pose.dtype)
        b = tlba.lba_blocks_plain(t, prob, sigma, free, lam_t)
        return b, tlba.lba_solve_plain(b, free, lam_t, P)
    b, got = solve(tp)
    _, truth = solve(_f64(tp))
    for g, w, t in zip(got, want, truth):
        _in_band(g.numpy(), w, t.numpy())
    dxi, d_pt, d_ep = got
    if case == "pinned":
        assert float(torch.diagonal(b.H_cc[2]).sum()) == 0.0
        assert float(dxi[2].abs().max()) == 0.0
        assert float(dxi[1:].abs().max()) > 1e-4
    if case == "floor":
        assert float(torch.diagonal(b.H_ll[0]).sum()) < 1e-2
        assert bool((d_pt[0] == 0).all())
        assert float(d_pt[1:].abs().max()) > 0.0
    if case == "caps":
        for x, cap in ((dxi, 1.0), (torch.cat([d_pt, d_ep]), 10.0)):
            n = torch.linalg.norm(x, dim=-1)
            assert float(n.max()) == pytest.approx(cap, rel=1e-5)
            assert int((n > 0.999 * cap).sum()) >= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_observed_blocks_are_the_indexed_ones(seed):
    """The Schur launch's premise: H_cl[w, n] of lba_bin_plain is zero
    unless pose w is free and lba_index_plain lists an observation of n by
    w, decoded as the kernel decodes it (g < W K: pose g // K; else
    (g - W K) // (2 L)); the launch reads no other block."""
    _, tp, cam = _problem(seed)
    W, K = tp.obs_pt_id.shape
    L = tp.obs_ln_sid.shape[1]
    t, sigma, _ = tlba.lba_terms_sigma_plain(tp, cam)
    free = tlba._free(tp)
    H_cl = tlba.lba_bin_plain(t, tp, sigma, free, torch.tensor(1e-3))[3]
    idx = tlba.lba_index_plain(tp)
    off, obs = idx.off.numpy(), idx.obs.numpy()
    seen = np.zeros(H_cl.shape[:2], bool)
    for n in range(H_cl.shape[1]):
        for g in obs[off[n]:off[n + 1]]:
            w = g // K if g < W * K else (g - W * K) // (2 * L)
            seen[w, n] = bool(free[w])
    nonzero = (H_cl.abs().amax(dim=(2, 3)) > 0).numpy()
    assert nonzero.sum() > 0.5 * seen.sum()
    assert not (nonzero & ~seen).any()


def test_run_lba_on_cpu_is_the_plain_loop():
    """run_lba on CPU tensors runs the LM loop of plain versions (no
    graph): equal to run_lba_plain to the bit."""
    _, tp, cam = _problem(0)
    got, want = tlba.run_lba(tp, cam, TCFG), tlba.run_lba_plain(tp, cam, TCFG)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


# lba_camera's launch plan (camera_layout, camera_rounds): the default
# window, one observation, points only, lines only, K + 2L not a multiple
# of the slice with two rounds a CTA, a wide window, many rounds
CAMERA_SHAPES = [(10, 1024, 128), (1, 1, 0), (7, 64, 0), (2, 0, 33),
                 (5, 120, 20), (3, 2501, 50), (20, 4096, 128),
                 (1, 100003, 7), (4, 16, 4)]


def camera_rounds(W, K, L):
    """Every (CTA rank, first, end) round of one pose's observations under
    camera_layout, in the order csrc/lba.cu's camera_kernel takes them:
    rank c's slice [c S, (c + 1) S) in rounds of T."""
    C, S, T = tlba.camera_layout(W, K, L)
    N = K + 2 * L
    return [(c, r0, min(r0 + T, (c + 1) * S, N))
            for c in range(C) for r0 in range(c * S, min((c + 1) * S, N), T)]


@pytest.mark.parametrize("W,K,L", CAMERA_SHAPES)
def test_camera_rounds_cover_each_observation_once(W, K, L):
    """Every one of a pose's K + 2L observations is in exactly one round,
    in order; CTA rank c's rounds lie in its slice [c S, (c + 1) S), every
    CTA has one, none is longer than the CTA's T threads; C is at most the
    portable cluster size 8 and T a whole number of warps up to 256."""
    C, S, T = tlba.camera_layout(W, K, L)
    N = K + 2 * L
    assert 1 <= C <= 8 and C * S >= N and 32 <= T <= 256 and T % 32 == 0
    rounds = camera_rounds(W, K, L)
    covered = np.concatenate([np.arange(r0, r1) for _, r0, r1 in rounds])
    assert np.array_equal(covered, np.arange(N))
    assert sorted(set(c for c, _, _ in rounds)) == list(range(C))
    for c, r0, r1 in rounds:
        assert c * S <= r0 < r1 <= (c + 1) * S and r1 - r0 <= T
    if (W, K, L) == (10, 1024, 128):
        assert (C, S, T) == (8, 160, 160)


@pytest.mark.parametrize("W,K,L", CAMERA_SHAPES)
def test_camera_final_write_covers_each_output(W, K, L):
    """CTA 0 writes H_cc's 36 entries and g_c's 6 in rounds of its T
    threads (e = tid, tid + T, ...): each once, also where T is one warp
    (the 4 x 16 x 4 shard of the sharded step, T = 32)."""
    T = tlba.camera_layout(W, K, L)[2]
    written = sorted(e for tid in range(T) for e in range(tid, 42, T))
    assert written == list(range(42))


@pytest.mark.parametrize("W,K,L", [(0, 10, 1), (65536, 10, 1), (3, 0, 0),
                                   (3, -1, 4)])
def test_camera_layout_refuses_what_the_launch_cannot_take(W, K, L):
    with pytest.raises(ValueError):
        tlba.camera_layout(W, K, L)


def _camera_data_flow(t, sigma, free):
    """camera_kernel's data flow in float64 on CPU tensors: each CTA's
    rounds (camera_rounds), the round's point rows read from the copy of
    the flat Jacobians that starts at the 16-byte piece holding the first
    (``head`` floats in; zeros past the tensor's end), the endpoints'
    (family, line) from the observation's index, the CTA's partials added
    in rank order."""
    W, K = t.rn.shape
    L = t.r_ln.shape[2]
    flat = torch.cat([t.Jc_pt.reshape(-1), t.Jc_pt.new_zeros(4)])
    r_ln, ok_ln = t.r_ln.reshape(-1), t.ok_ln.reshape(-1)
    J_ln = t.Jc_ln.reshape(-1, 6)
    H = t.rn.new_zeros((W, 6, 6))
    g = t.rn.new_zeros((W, 6))
    for w in range(W):
        if not free[w]:
            continue
        parts = {}
        for c, r0, r1 in camera_rounds(W, K, L):
            acc = parts.setdefault(c, [H.new_zeros((6, 6)), g.new_zeros(6)])
            p1 = min(r1, K)
            s = (w * K + r0) * 18
            head = s - 4 * (s // 4)
            buf = flat[4 * (s // 4):4 * ((((w * K + p1) * 18) + 3) // 4)]
            for i in range(r0, r1):
                if i < K:
                    if not t.ok_pt[w, i]:
                        continue
                    Jr = buf[head + 18 * (i - r0):][:18].reshape(3, 6)
                    r, nr = t.r_pt[w, i], t.rn[w, i]
                else:
                    f = (i - K) // L
                    j = (f * W + w) * L + i - K - f * L
                    if not ok_ln[j]:
                        continue
                    Jr, r = J_ln[j][None], r_ln[j][None]
                    nr = r.abs()[0]
                wt = 6.0 / (5.0 + (nr / sigma) ** 2)
                acc[0] += wt * Jr.T @ Jr
                acc[1] += wt * Jr.T @ r
        for c in sorted(parts):
            H[w] += parts[c][0]
            g[w] += parts[c][1]
    return H, g


@pytest.mark.parametrize("case", ["fixed", "empty", "W1", "ragged",
                                  "one_warp"])
def test_camera_kernel_data_flow_matches_plain(case):
    """The kernel's reading of the terms (its rounds, the staged rows'
    offsets, the endpoint indices, the fixed poses) in float64 against
    lba_camera_plain in float64 on test_torch_gpu's lba_camera cases."""
    from test_torch_gpu import camera_case_np
    d, cam = camera_case_np(case)
    prob = tlba.LBAProblem(**{k: torch.from_numpy(v) for k, v in d.items()})
    t, sigma, _ = tlba.lba_terms_sigma_plain(prob, cam)
    t64 = tlba.LBATerms(*(x.double() if x.is_floating_point() else x
                          for x in t))
    free = tlba._free(prob)
    got = _camera_data_flow(t64, sigma.double(), free)
    want = tlba.lba_camera_plain(t64, sigma.double(), free)
    for x, y in zip(got, want):
        assert _rel(x.numpy(), y.numpy()) <= 1e-12
