"""Port parity: the owner-sharded window LBA (``parallel/dist_lba.py``) and
its live use (``mapping.distributed``), on CPU shards.

The reference tests' problem (tests/test_dist_lba.py: make_lba_problem at
W 4, P 64, Q 16, padded to shard multiples) goes as the same numpy arrays
through the JAX package on the root conftest's 8-device CPU mesh and
through the port on n CPU shards (``make_mesh(n, device="cpu")``, where
each K15 launch is its plain version). Tolerances:

  * the bucketed layout (ids, payloads, both permutations, ``n_dropped``):
    exactly equal, also where a shard's slots overflow;
  * the split solve's plain versions (``lba_schur_corr_plain`` then
    ``lba_solve_reduced_plain``) on one shard: ``lba_solve_plain``'s bits;
  * one step (``make_dist_lba_step``) and the whole LM
    (``make_dist_lba_lm``, 6 iterations): each output's distance from the
    port's float64 run of the same shards, relative to the output's
    largest magnitude, within 3x the reference's own distance plus 1e-6
    (K15's rule), and the port's distance from the reference within 4x
    plus 1e-6 (the rule's triangle). The endpoints' blocks are nearly
    singular along their lines, so f32 sum order moves their steps by
    ~2e-3 relative in both packages (measured: reference 2.0e-3, port
    3.8e-3 from float64 in the LM); costs within the same rule;
  * the port across meshes of 1, 2 and 4 shards: 4e-3 absolute (the
    reference's own cross-mesh tolerance: f32 reduction order);
  * the data-parallel (2, 4) mesh: bit-equal to the port's per-window
    steps on a 4-shard mesh (the same shard sums in the same order), and
    within 4e-3 of the reference's (2, 4) mesh;
  * the collectives of one step: ``comm_bytes_per_step(W)`` bytes exactly,
    at P 64 and at P 256;
  * the live run (``PLSLAM`` with ``mapping.distributed``, 10 frames, no
    lines, a keyframe a frame): the same keyframes as the port's
    single-device run and ATE within the reference's band (max(1.5 x,
    + 1 cm)), since the sharded scale is mean-|r| where the dense one is
    the median (the shard count's invariance is held on the step above,
    and live on the card by chip_smoke.py's ``[dist]``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import lba as jlba
from plslam_tpu.config import SlamConfig
from plslam_tpu.parallel import dist_lba as jdist
from plslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import lba as tlba
from plslam_tpu_torch.io import synthetic
from plslam_tpu_torch.parallel import dist_lba as tdist
from plslam_tpu_torch.parallel.mesh import make_mesh

from test_dist_lba import CAM, _pad_problem
from test_lba import make_lba_problem

TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b, 640,
                                 480)
ITERS, LAM0, LAM_FACTOR = 6, 1e-3, 3.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the shards' small ops, run by six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_problem(seed=5, P=64, k_mult=8, q_mult=16):
    prob, *_ = make_lba_problem(jax.random.PRNGKey(seed), W=4, P=P, Q=16,
                                noise_px=0.3)
    prob = _pad_problem(prob, k_mult, q_mult)
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


@pytest.fixture(scope="module")
def problem():
    return _np_problem()


def _jax(d):
    return jlba.LBAProblem(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch(d):
    return convert.lba_problem_from_numpy(d, "cpu")


def _f64(p):
    return type(p)(*(x.double() if x.is_floating_point() else x for x in p))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _hold(got, ref, truth, names):
    """K15's rule against the reference, relative to each output's
    largest magnitude."""
    for g, r, t, name in zip(got, ref, truth, names):
        d_ref = _rel(r, t)
        assert _rel(g, t) <= 3 * d_ref + 1e-6, (name, _rel(g, t), d_ref)
        assert _rel(g, r) <= 4 * d_ref + 1e-6, (name, _rel(g, r), d_ref)


def _skewed(d, n):
    """Row 0's point slots all owned by shard 0 (ids multiples of n): the
    slice overflows and the excess is dropped."""
    d = {k: v.copy() for k, v in d.items()}
    K = d["obs_pt_id"].shape[1]
    P = d["pt_pos"].shape[0]
    d["obs_pt_id"][0] = (n * np.arange(K)) % P
    d["obs_ln_sid"][1, :] = 0            # every line slot observes line 0
    d["obs_ln_eid"][1, :] = 1
    return d


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["padded", "skewed"])
def test_bucketing_matches_reference(problem, n, case):
    d = problem if case == "padded" else _skewed(problem, n)
    jb = jdist.bucket_problem_by_owner(_jax(d), n)
    tb = tdist.bucket_problem_by_owner(_torch(d), n)
    for f in jlba.LBAProblem._fields:
        a, b = np.asarray(getattr(jb.problem, f)), getattr(tb.problem, f)
        assert a.shape == tuple(b.shape)
        assert np.array_equal(a, b.numpy()), (n, f)
    assert np.array_equal(np.asarray(jb.pt_perm), tb.pt_perm.numpy())
    assert np.array_equal(np.asarray(jb.ep_perm), tb.ep_perm.numpy())
    assert int(jb.n_dropped) == int(tb.n_dropped)
    if case == "skewed" and n > 1:
        assert int(tb.n_dropped) > 0
    # a pure relabeling: the landmarks come back, each shard's column
    # slice names only its own landmarks
    tp = _torch(d)
    assert torch.equal(tdist.unbucket_landmarks(tb.problem.pt_pos,
                                                tb.pt_perm), tp.pt_pos)
    assert torch.equal(tdist.unbucket_landmarks(tb.problem.ep_pos,
                                                tb.ep_perm), tp.ep_pos)
    mesh = make_mesh(n, ("lm",), "cpu")
    for s in tdist.shard_problem(mesh, tb.problem):
        P_loc, Q_loc = s.pt_pos.shape[0], s.ep_pos.shape[0]
        assert int(s.obs_pt_id.max()) < P_loc and int(s.obs_ln_sid.max()) < Q_loc
        assert int(s.obs_pt_id.min()) >= -1 and int(s.obs_ln_eid.min()) >= -1


def test_split_solve_plain_is_lba_solve_plain(problem):
    """On one shard the split plain versions give lba_solve_plain's bits."""
    tp = _torch(problem)
    t, sigma, _ = tlba.lba_terms_sigma_plain(tp, TCAM)
    free = tlba._free(tp)
    lam = torch.tensor(1e-3)
    b = tlba.lba_blocks_plain(t, tp, sigma, free, lam)
    P = tp.pt_pos.shape[0]
    corr, g_corr = tlba.lba_schur_corr_plain(b, free)
    assert not corr[0].any() and not g_corr[0].any()   # KF 0 is fixed
    for cap in (True, False):
        got = tlba.lba_solve_reduced_plain(b.H_cc, b.g_c, corr, g_corr, b,
                                           free, lam, P, cap=cap)
        ref = tlba.lba_solve_plain(b, free, lam, P, cap=cap)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))


def _port_step(d, n, ops=tdist.KERNELS, f64=False, lam=1e-4):
    mesh = make_mesh(n, ("lm",), "cpu")
    tb = tdist.bucket_problem_by_owner(_torch(d), n)
    prob = _f64(tb.problem) if f64 else tb.problem
    out = tdist.make_dist_lba_step(mesh, TCAM, ops=ops)(prob, lam)
    return [x.numpy() for x in out], tb, mesh


def test_step_and_mesh_invariance_match_reference(problem):
    """make_dist_lba_step at 1, 2 and 4 shards against the reference's on
    as many devices (K15's rule), the port across meshes (4e-3), and the
    step's direction against the dense single-device step (the
    reference's test: cos > 0.99, magnitude ratio in (0.7, 1.4))."""
    outs = []
    for n in (1, 2, 4):
        got, tb, mesh = _port_step(problem, n)
        assert mesh.reduce_bytes == jdist.comm_bytes_per_step(4)
        truth = _port_step(problem, n, tdist.PLAIN, f64=True)[0]
        jb = jdist.bucket_problem_by_owner(_jax(problem), n)
        ref = [np.asarray(x) for x in jdist.make_dist_lba_step(
            jmake_mesh(n, axes=("lm",)), CAM)(jb.problem, jnp.asarray(1e-4))]
        _hold(got, ref, truth, ("dxi", "d_pt", "d_ep"))
        outs.append([got[0], tdist.unbucket_landmarks(
            torch.from_numpy(got[1]), tb.pt_perm).numpy(),
            tdist.unbucket_landmarks(torch.from_numpy(got[2]),
                                     tb.ep_perm).numpy()])
    for n, o in zip((2, 4), outs[1:]):
        for a, b in zip(outs[0], o):
            np.testing.assert_allclose(a, b, atol=4e-3, err_msg=f"n={n}")
    dense = tlba._assemble_and_solve(_torch(problem), TCAM,
                                     torch.tensor(1e-4))
    for a, b in zip(outs[2][:2], dense[:2]):
        a, b = a.ravel(), b.numpy().ravel()
        cos = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12)
        ratio = np.linalg.norm(a) / max(np.linalg.norm(b), 1e-12)
        assert cos > 0.99 and 0.7 < ratio < 1.4, (cos, ratio)


def test_dist_lm_matches_reference(problem):
    """make_dist_lba_lm (6 accept/reject iterations) at 4 shards against
    the reference's: poses, landmarks and both costs by K15's rule; the
    cost decreases."""
    n = 4
    tb = tdist.bucket_problem_by_owner(_torch(problem), n)
    lm = lambda ops: tdist.make_dist_lba_lm(make_mesh(n, ("lm",), "cpu"),
                                            TCAM, ITERS, LAM0, LAM_FACTOR,
                                            ops=ops)
    got = [x.numpy() for x in lm(tdist.KERNELS)(tb.problem)]
    truth = [x.numpy() for x in lm(tdist.PLAIN)(_f64(tb.problem))]
    jb = jdist.bucket_problem_by_owner(_jax(problem), n)
    ref = [np.asarray(x) for x in jdist.make_dist_lba_lm(
        jmake_mesh(n, axes=("lm",)), CAM, ITERS, LAM0, LAM_FACTOR)(
        jb.problem)]
    _hold(got, ref, truth, ("kf_pose", "pt_pos", "ep_pos", "cost0", "cost1"))
    assert got[4] < 0.2 * got[3], (got[3], got[4])


def test_dp_windows_match_per_window_steps():
    """Two windows on the (2, 4) mesh: bit-equal to each window's step on
    a 4-shard mesh, and within 4e-3 of the reference's (2, 4) mesh."""
    ds = [_np_problem(seed, k_mult=4, q_mult=8) for seed in (5, 11)]
    tbs = [tdist.bucket_problem_by_owner(_torch(d), 4).problem for d in ds]
    batched = tlba.LBAProblem(*(torch.stack(x) for x in zip(*tbs)))
    mesh2d = make_mesh(8, ("kf", "lm"), "cpu")
    assert mesh2d.shape == {"kf": 2, "lm": 4}
    dp = tdist.make_dist_lba_step_dp(mesh2d, TCAM)(batched, 1e-4)
    single = tdist.make_dist_lba_step(make_mesh(4, ("lm",), "cpu"), TCAM)
    for g, p in enumerate(tbs):
        for a, b in zip(dp, single(p, 1e-4)):
            assert torch.equal(a[g], b)
    jbs = [jdist.bucket_problem_by_owner(_jax(d), 4).problem for d in ds]
    jbatched = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jbs)
    ref = jdist.make_dist_lba_step_dp(jmake_mesh(8, axes=("kf", "lm")), CAM)(
        jbatched, jnp.asarray(1e-4))
    for a, b in zip(dp, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=4e-3)


def test_comm_volume_independent_of_landmark_count():
    """The collectives of one step carry comm_bytes_per_step(W) bytes at
    P 64 and at P 256: the reduced camera system and the scale's two
    scalars, never a landmark block."""
    vols = []
    for P in (64, 256):
        _, _, mesh = _port_step(_np_problem(7, P=P), 4)
        vols.append(mesh.reduce_bytes)
    assert vols == [jdist.comm_bytes_per_step(4)] * 2 == [
        tdist.comm_bytes_per_step(4)] * 2


@pytest.mark.parametrize("n", [2, 4])
def test_shard_shapes_take_the_kernels(n):
    """The path's window (W 10, K 1,024, L 128, P 4,096, Q 1,024) cut into
    n shards: lba_camera's and lba_index's launches take a shard's
    shapes, and lba_solve's scratch layout holds its landmarks."""
    W, K, L, P, Q = 10, 1024 // n, 128 // n, 4096 // n, 1024 // n
    C, S, T = tlba.camera_layout(W, K, L)
    assert C * S >= K + 2 * L and T % 32 == 0
    C, S = tlba.index_layout(W, K, L, P, Q)
    assert C * S >= P + Q
    assert tlba.new_solve_scratch(W, P + Q, "cpu").numel() == \
        tlba._solve_words(W, P + Q)


LIVE_CFG = SlamConfig().with_updates({
    "camera": {"width": 512, "height": 320, "fx": 400.0, "fy": 400.0,
               "cx": 256.0, "cy": 160.0, "baseline": 0.3},
    "points": {"max_kpts": 256, "orb_nlevels": 2},
    "lines": {"has_lines": False},
    "matching": {"f2f_window": 128.0},
    "mapping": {"max_kfs": 32, "max_points": 4096, "max_lines": 256,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 5,
                "lba_max_points": 1024, "lba_max_lines": 64},
    "keyframe": {"min_entropy_ratio": 2.0},     # a keyframe a frame
    "loop": {"enabled": False},
    "system": {"async_mapping": False},
})


def test_live_mapping_distributed_matches_single_device():
    from plslam_tpu_torch.backend.slam_system import PLSLAM
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.utils.evaluation import ate_rmse
    tcfg = convert.config_from_dict(dataclasses.asdict(LIVE_CFG))
    cam = StereoCamera.from_config(tcfg.camera)
    n = 10
    seq = synthetic.make_sequence(cam,
                                  n_frames=n, seed=5, n_points=500,
                                  n_lines=0, noise=0.004, step=0.25)

    def run(cfg):
        slam = PLSLAM(cfg, cam, device="cpu")
        slam.initialize(seq.images_l[0], seq.images_r[0])
        for i in range(1, n):
            slam.process(seq.images_l[i], seq.images_r[i])
        est = slam.finish()
        return est, slam._kf_slot + 1

    est_1, kfs_1 = run(tcfg)
    est_d, kfs_d = run(tcfg.with_updates(
        {"mapping": {"distributed": True, "dist_devices": 4}}))
    assert kfs_d == kfs_1 >= 5, (kfs_d, kfs_1)
    a1 = float(ate_rmse(est_1, seq.poses[:len(est_1)]))
    ad = float(ate_rmse(est_d, seq.poses[:len(est_d)]))
    assert ad < max(1.5 * a1, a1 + 0.01), (a1, ad)
