"""Port parity of the SE(3) pose graph (K18): ``frozen_mask``,
``edge_residuals`` (and ``log_se3`` at small angles), the dense and the PCG
Gauss-Newton solves.

The same numpy graphs, made from a seed, go through the jitted JAX
functions and the port's plain versions (CPU tensors). The union-find is
held exactly. Floats are held against a float64 evaluation of the same
graph (the port's plain version in float64): the port's distance from it
must stay within 3x the reference's own distance plus a floor, as
tests/test_torch_lba.py holds K15. The dense system mixes 1e8 pins with
O(1) blocks, so two LU implementations (LAPACK here, XLA's on the
reference) agree only to the system's f32 error. Costs and distances are
printed.
"""

import numpy as np
import torch

import jax.numpy as jnp
from plslam_tpu.core import lie as jlie
from plslam_tpu.loop import pose_graph as jpg
from plslam_tpu_torch import convert
from plslam_tpu_torch.core import lie as tlie
from plslam_tpu_torch.loop import pose_graph as tpg


def _exp(x):
    return np.asarray(jlie.exp_se3(jnp.asarray(x, jnp.float32)))


def _drifted_loop_graph(F_slots, n_kfs, seed=0, drift=0.002, n_covis=0):
    """Twin of tests/test_pose_graph_scale.py::_drifted_loop_graph: a
    circle, exact relative measurements, odometry-integrated initial poses
    with a per-step drift, a loop edge and optional skip edges (numpy)."""
    rng = np.random.default_rng(seed)
    gt, steps = [np.eye(4, dtype=np.float32)], []
    for _ in range(n_kfs - 1):
        steps.append(_exp([0.12, 0.0, 0.01, 0.0, 2.0 * np.pi / (n_kfs - 1),
                           0.0]))
        gt.append((gt[-1] @ steps[-1]).astype(np.float32))
    noisy = [np.eye(4, dtype=np.float32)]
    for step in steps:
        xi = rng.normal(0, drift, 6).astype(np.float32)
        xi[3:] *= 0.3
        noisy.append((noisy[-1] @ step @ _exp(xi)).astype(np.float32))
    edges = [(k, k + 1, steps[k], 1.0) for k in range(n_kfs - 1)]
    edges.append((0, n_kfs - 1, (np.linalg.inv(gt[0]) @ gt[-1]).astype(
        np.float32), 2.0))
    for _ in range(n_covis):
        i = int(rng.integers(0, n_kfs - 10))
        j = i + int(rng.integers(2, 8))
        edges.append((i, j, (np.linalg.inv(gt[i]) @ gt[j]).astype(
            np.float32), 1.0))
    return _pack(F_slots, np.stack(noisy), edges)


def _pack(F, poses, edges, E=None):
    E = E or int(2 ** np.ceil(np.log2(len(edges) + 1)))
    n = len(poses)
    d = dict(poses=np.tile(np.eye(4, dtype=np.float32), (F, 1, 1)),
             pose_valid=np.arange(F) < n, edge_i=np.zeros(E, np.int32),
             edge_j=np.zeros(E, np.int32),
             edge_T=np.tile(np.eye(4, dtype=np.float32), (E, 1, 1)),
             edge_w=np.zeros(E, np.float32))
    d["poses"][:n] = poses
    for k, (i, j, T, w) in enumerate(edges):
        d["edge_i"][k], d["edge_j"][k], d["edge_T"][k], d["edge_w"][k] = (
            i, j, T, w)
    return d


def _graphs(d):
    """(reference PoseGraph, port f32 PoseGraph, port f64 PoseGraph)."""
    j = jpg.PoseGraph(**{f: jnp.asarray(x) for f, x in d.items()})
    t = convert.pose_graph_from_numpy(d, "cpu")
    t64 = t._replace(poses=t.poses.double(), edge_T=t.edge_T.double(),
                     edge_w=t.edge_w.double())
    return j, t, t64


def _dist(a, b) -> float:
    return float((torch.as_tensor(np.array(a)).double()
                  - torch.as_tensor(np.array(b)).double()).abs().max())


def test_frozen_mask_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(6):
        F, E = 40, 64
        d = _pack(F, np.tile(np.eye(4, dtype=np.float32), (30, 1, 1)), [], E)
        d["pose_valid"] = rng.random(F) > 0.2
        k = 0
        for _ in range(rng.integers(10, 40)):    # a few components
            i, j = rng.integers(0, F, 2)
            if abs(i - j) < 6 or trial == 5:
                d["edge_i"][k], d["edge_j"][k] = i, j
                d["edge_w"][k] = rng.choice([0.0, 1.0, 2.0])
                k += 1
        jg, tg, _ = _graphs(d)
        want = np.asarray(jpg.frozen_mask(jg))
        np.testing.assert_array_equal(tpg.frozen_mask(tg), want)
        assert want.dtype == bool
    d["pose_valid"][:] = False
    np.testing.assert_array_equal(tpg.frozen_mask(_graphs(d)[1]),
                                  np.asarray(jpg.frozen_mask(_graphs(d)[0])))


def test_log_se3_small_angles_against_float64():
    """Near-identity residuals: log_se3 from 1e-6 to 0.2 rad (the range
    tests/test_torch_core.py does not reach), the port's f32 held to 3x
    the reference's f32 distance from float64 + 1e-7."""
    rng = np.random.default_rng(1)
    ang = np.exp(rng.uniform(np.log(1e-6), np.log(0.2), 400))
    axis = rng.normal(size=(400, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    xi = np.concatenate([rng.normal(0, 0.3, (400, 3)), axis * ang[:, None]],
                        -1)
    T64 = tlie.exp_se3(torch.from_numpy(xi))
    T32 = T64.float()
    truth = tlie.log_se3(T32.double())
    got = tlie.log_se3(T32)
    ref = np.asarray(jlie.log_se3(jnp.asarray(T32.numpy())))
    d_t, d_j = _dist(got, truth), _dist(ref, truth)
    print(f"log_se3 at 1e-6..0.2 rad: port {d_t:.3g}, reference {d_j:.3g} "
          "from float64")
    assert d_t <= 3 * d_j + 1e-7


def test_edge_residuals_against_float64():
    d = _drifted_loop_graph(64, 50, seed=4, drift=0.01, n_covis=10)
    jg, tg, t64 = _graphs(d)
    truth = tpg.edge_residuals(t64.poses, t64)
    got = tpg.edge_residuals(tg.poses, tg)
    ref = np.asarray(jpg.edge_residuals(jg.poses, jg))
    d_t, d_j = _dist(got, truth), _dist(ref, truth)
    print(f"edge residuals: port {d_t:.3g}, reference {d_j:.3g} from "
          "float64")
    assert d_t <= 3 * d_j + 1e-7
    np.testing.assert_array_equal(got.numpy()[d["edge_w"] == 0], 0.0)


def _solve_parity(d, solve_t, solve_j, label):
    """Port (f32) and reference against the port's float64 solve: the
    port within 3x the reference's distance + 1e-5 of the largest
    translation; costs printed."""
    jg, tg, t64 = _graphs(d)
    fz = torch.from_numpy(tpg.frozen_mask(tg))
    P, c0, c1 = solve_t(tg, fz)
    P64, _, c1_64 = solve_t(t64, fz)
    Pj, c0j, c1j = solve_j(jg, jnp.asarray(fz.numpy()))
    scale = float(P64[:, :3, 3].abs().max())
    d_t, d_j = _dist(P, P64), _dist(Pj, P64)
    print(f"{label}: cost {float(c0):.6g} -> {float(c1):.6g} (reference "
          f"{float(c1j):.6g}, float64 {float(c1_64):.6g}); poses from "
          f"float64: port {d_t:.3g}, reference {d_j:.3g} (largest "
          f"translation {scale:.3g})")
    assert abs(float(c0) - float(c0j)) <= 1e-5 * float(c0j)
    assert d_t <= 3 * d_j + 1e-5 * scale
    return P, c0, c1, jg


def test_dense_closes_drift_like_reference():
    """Twin of tests/test_loop.py::test_pose_graph_closes_drift."""
    F, E, n = 16, 64, 12
    step = _exp([0.5, 0, 0, 0, 2 * np.pi / n, 0])
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    rng = np.random.default_rng(3)
    poses, edges = [gt[0]], []
    for i in range(1, n):
        T = np.linalg.inv(gt[i - 1]) @ gt[i] @ _exp(np.concatenate(
            [rng.normal(0, 0.01, 3), rng.normal(0, 0.004, 3)]))
        edges.append((i - 1, i, T, 1.0))
        poses.append(poses[-1] @ T)
    T_loop = np.linalg.inv(gt[n - 1]) @ gt[0]
    edges.append((n - 1, 0, T_loop, 2.0))
    d = _pack(F, np.stack(poses).astype(np.float32), edges, E)
    P, c0, c1, _ = _solve_parity(
        d, lambda g, fz: tpg._optimize_dense(g, fz, 20),
        lambda g, fz: jpg._optimize_dense(g, fz, 20), "dense")
    assert float(c1) < 0.1 * float(c0)
    npo = P.numpy()
    assert np.linalg.norm((np.linalg.inv(T_loop) @ np.linalg.inv(npo[n - 1])
                           @ npo[0])[:3, 3]) < 0.05
    np.testing.assert_allclose(npo[0], d["poses"][0], atol=1e-4)


def test_pcg_matches_reference_midsize():
    """Twin of tests/test_pose_graph_scale.py::
    test_pcg_matches_dense_midsize (96 slots, 90 KFs, 12 skip edges)."""
    d = _drifted_loop_graph(96, 90, seed=1, n_covis=12)
    P, _, c1, _ = _solve_parity(
        d, lambda g, fz: tpg._optimize_pcg(g, fz, 10, 96),
        lambda g, fz: jpg._optimize_pcg(g, fz, 10, 96), "pcg")
    Pd, _, c1d = tpg.optimize_pose_graph(_graphs(d)[1], iters=10)
    assert float(c1) <= 1.05 * float(c1d) + 1e-6
    dt = np.linalg.norm((Pd - P).numpy()[:90, :3, 3], axis=-1)
    assert float(dt.max()) < 5e-3


def test_pcg_respects_invalid_slots():
    """Twin of tests/test_pose_graph_scale.py::
    test_pcg_respects_invalid_slots (128 slots, 60 valid)."""
    d = _drifted_loop_graph(128, 60, seed=3)
    P, _, _, _ = _solve_parity(
        d, lambda g, fz: tpg._optimize_pcg(g, fz, 6, 64),
        lambda g, fz: jpg._optimize_pcg(g, fz, 6, 64), "pcg, invalid slots")
    assert float((P[60:] - torch.from_numpy(d["poses"][60:])).abs().max()
                 ) < 1e-6
