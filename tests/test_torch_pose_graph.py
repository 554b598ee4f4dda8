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
import pytest
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


# pg_pcg's cluster: the partition the kernel computes, mirrored by
# pcg_partition, at the loop closer's five slot buckets (E = 4F; the graphs
# chip_smoke.py times; 1,024 is the provisioned long run's, a cluster of
# 16), on a hub graph with unused slots between used ones, and at larger
# clusters than pcg_layout picks
_BUCKETS = [(64, 40, 60, None), (128, 100, 300, None), (256, 200, 800, None),
            (512, 400, 1600, None), (1024, 700, 2400, None),
            (64, 40, 60, 16), (512, 400, 1600, 16)]


def _hub_graph(F=96, seed=7):
    """Edges into and out of slot 5 from most slots, unused slots (w = 0)
    between used ones, repeated pairs."""
    rng = np.random.default_rng(seed)
    E = 4 * F
    d = _pack(F, np.tile(np.eye(4, dtype=np.float32), (F - 10, 1, 1)), [], E)
    for k in range(E):
        i, j = (5, int(rng.integers(0, F - 10))) if k % 3 else tuple(
            int(v) for v in rng.integers(0, F - 10, 2))
        d["edge_i"][k], d["edge_j"][k] = (i, j) if k % 2 else (j, i)
        d["edge_w"][k] = 0.0 if k % 7 == 3 else 1.0
    return d


@pytest.mark.parametrize("F,n,extra,C", _BUCKETS + [(96, 0, 0, None),
                                                    (96, 0, 0, 8)])
def test_pcg_partition_owns_every_edge_once(F, n, extra, C):
    """Every used edge lands in exactly one CTA's list, the lists in the
    leaving lists' order (edge order within a node); every leaving and
    entering entry of a node addresses that edge in its owner's list."""
    from plslam_tpu_torch.io import synthetic
    d = (_hub_graph(F) if n == 0
         else synthetic.drift_circle_graph(F, n, extra, seed=F)[0])
    g = convert.pose_graph_from_numpy(d, "cpu")
    E = g.edge_w.shape[0]
    C_, threads, smem = tpg.pcg_layout(F, E)
    assert smem <= tpg.PCG_SMEM_MAX and threads % 32 == 0 and threads <= 1024
    assert C_ == {64: 1, 96: 1, 128: 1, 256: 2, 512: 4, 1024: 16}[F]
    C = C or C_
    inc = tpg._incidence(g)
    oi, pi, oj, pj = (np.asarray(x) for x in inc)
    parts = tpg.pcg_partition(inc, F, C)
    assert len(parts) == C
    used = np.flatnonzero(d["edge_w"] > 0)
    owned = sum((p["edges"] for p in parts), [])
    assert owned == oi[:len(used)].tolist()
    assert sorted(owned) == used.tolist()
    ei, ej = d["edge_i"], d["edge_j"]
    for p in parts:
        es = p["edges"]
        assert len(es) <= -(-E // C)
        for a, b in zip(es, es[1:]):       # by tail, edge order within one
            assert (ei[a], a) < (ei[b], b)
    assert parts[-1]["nodes"][1] == F
    for c, p in enumerate(parts):
        n0, n1 = p["nodes"]
        assert n1 - n0 <= -(-F // C)
        assert c == 0 or n0 == parts[c - 1]["nodes"][1]
        for k, node in enumerate(range(n0, n1)):
            out_e = [parts[r]["edges"][loc] for r, loc in p["leaving"][k]]
            in_e = [parts[r]["edges"][loc] for r, loc in p["entering"][k]]
            assert out_e == oi[pi[node]:pi[node + 1]].tolist()
            assert in_e == oj[pj[node]:pj[node + 1]].tolist()
            assert all(ei[e] == node for e in out_e)
            assert all(ej[e] == node for e in in_e)
            assert all(0 <= r < C and 0 <= loc < 2 ** 16
                       for r, loc in p["leaving"][k] + p["entering"][k])


def _pcg_cluster_emulated(g, Ji, Minv, diag, gvec, iters, C):
    """pg_pcg's data flow in float64 numpy: the partition, the edge pass
    (p = z + beta p_old folded in at both ends, p.Hp as sum_e w |t_e|^2 +
    sum_n diag_n |p_n|^2), the node pass through the leaving and entering
    addresses, the dot products as sums of partials; the same schedule
    and gates as pcg_plain."""
    F = g.poses.shape[0]
    parts = tpg.pcg_partition(tpg._incidence(g), F, C)
    J, M = Ji.double().numpy(), Minv.double().numpy()
    w, dg = g.edge_w.double().numpy(), diag.double().numpy()
    ei, ej = g.edge_i.numpy(), g.edge_j.numpy()
    r = -gvec.double().numpy().reshape(F, 6)
    x, p = np.zeros((F, 6)), np.zeros((F, 6))
    z = np.einsum("fpq,fq->fp", M, r)
    b2, rz, beta = float(np.sum(r * r)), float(np.sum(r * z)), 0.0
    for _ in range(iters):
        p = z + beta * p                    # A: every CTA's p, the edges
        uv, php = [], []
        for part in parts:
            rows, q = [], 0.0
            for e in part["edges"]:
                t = J[e] @ p[ei[e]] + p[ej[e]]
                rows.append((w[e] * (J[e].T @ t), w[e] * t))
                q += w[e] * float(t @ t)
            n0, n1 = part["nodes"]
            q += float(np.sum(dg[n0:n1] * np.sum(p[n0:n1] ** 2, axis=1)))
            uv.append(rows)
            php.append(q)
        pHp = sum(php)
        ok = pHp > 1e-12 and rz > 1e-12 * b2 + 1e-30
        alpha = rz / max(pHp, 1e-30) if ok else 0.0
        Hp = np.zeros((F, 6))
        for part in parts:                  # B: the owned nodes
            n0, n1 = part["nodes"]
            for k, node in enumerate(range(n0, n1)):
                y = sum((uv[rk][loc][0] for rk, loc in part["leaving"][k]),
                        np.zeros(6))
                y = y + sum((uv[rk][loc][1] for rk, loc in
                             part["entering"][k]), np.zeros(6))
                Hp[node] = y + dg[node] * p[node]
        x = x + alpha * p
        r = r - alpha * Hp
        z = np.einsum("fpq,fq->fp", M, r)
        rz_new = float(np.sum(r * z))
        beta = rz_new / max(rz, 1e-30) if ok else 0.0
        rz = rz_new
    return x


@pytest.mark.parametrize("F,n,extra,C", [(64, 40, 60, 1), (64, 40, 60, 4),
                                         (96, 0, 0, 3), (128, 100, 300, 8)])
def test_pcg_cluster_data_flow_matches_plain(F, n, extra, C):
    """The kernel's data flow over the partition (float64) against the
    plain PCG in float64 on the same system: 1e-9 of dx's largest entry
    (only the order of the sums differs)."""
    from plslam_tpu_torch.io import synthetic
    d = (_hub_graph(F) if n == 0
         else synthetic.drift_circle_graph(F, n, extra, seed=F)[0])
    g = convert.pose_graph_from_numpy(d, "cpu")
    g64 = g._replace(poses=g.poses.double(), edge_T=g.edge_T.double(),
                     edge_w=g.edge_w.double())
    r, Ji, _ = tpg.edges_plain(g64)
    diag = tpg._diag(g64, torch.zeros(F, dtype=torch.bool), True)
    gvec, Hd = tpg.blocks_plain(g64, r, Ji, diag)
    Minv = torch.linalg.inv(Hd)
    want = tpg.pcg_plain(g64, Ji, Minv, diag, gvec, 24).numpy()
    got = _pcg_cluster_emulated(g, Ji, Minv, diag, gvec, 24, C)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


# pg_edges' and pg_update's plan and the residuals a GN step hands on: the
# CTAs of edge_layout at the loop closer's five slot buckets (E = 4F) and
# at a ragged E; update_plain's residuals; the solves, which evaluate their
# edges once, against a loop that evaluates them at every step
_SWEEP = [(64, 256), (128, 512), (256, 1024), (512, 2048), (1024, 4096),
          (10, 37)]


def test_edge_layout_matches_kernel():
    """EDGE_SLOTS and EDGE_NT equal csrc/pose_graph.cu's."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tpg.__file__), os.pardir,
                            "csrc", "pose_graph.cu")).read()
    consts = dict(re.findall(r"constexpr int (EDGE_\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "EDGE_SLOTS": tpg.EDGE_SLOTS, "EDGE_NT": tpg.EDGE_NT}
    assert tpg.EDGE_SLOTS <= tpg.EDGE_NT and tpg.EDGE_NT % 32 == 0


@pytest.mark.parametrize("F,E", _SWEEP)
def test_edge_layout_owns_every_slot_once(F, E):
    """Every edge slot and every pose slot belongs to exactly one CTA,
    contiguous ranges in CTA order, at most a thread an edge; Fb 64
    already spans several SMs; Fb 1,024's cooperative pg_update is 128
    CTAs, within the card's 132 SMs."""
    ctas, threads = tpg.edge_layout(E)
    parts = tpg.edge_partition(F, E)
    assert len(parts) == ctas and threads == tpg.EDGE_NT
    if F == 64:
        assert ctas > 1
    if F == 1024:
        assert (ctas, threads) == (128, 256)
    es = [e for (e0, e1), _ in parts for e in range(e0, e1)]
    ns = [n for _, (n0, n1) in parts for n in range(n0, n1)]
    assert es == list(range(E)) and ns == list(range(F))
    assert all(0 < e1 - e0 <= tpg.EDGE_SLOTS for (e0, e1), _ in parts)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _circle(F, n, extra):
    from plslam_tpu_torch.io import synthetic
    d = synthetic.drift_circle_graph(F, n, extra, seed=F)[0]
    return convert.pose_graph_from_numpy(d, "cpu")


def test_update_plain_hands_on_the_residuals(one_thread):
    """An accepted step hands on the residuals and cost at the poses it
    returns, as edge_residuals_plain computes them there; the reversed
    step raises the cost, is rejected and hands back the input residuals
    (with none given, the residuals at the input poses)."""
    g = _circle(64, 40, 60)
    r, Ji, c = tpg.edges_plain(g)
    diag = tpg._diag(g, torch.zeros(64, dtype=torch.bool), True)
    gvec, Hd = tpg.blocks_plain(g, r, Ji, diag)
    dx = tpg.pcg_plain(g, Ji, torch.linalg.inv(Hd), diag, gvec, 24)
    P, c1, r1 = tpg.update_plain(g, c, dx, 1.0, r)
    assert float(c1) < float(c) and not torch.equal(P, g.poses)
    assert torch.equal(r1, tpg.edge_residuals_plain(P, g))
    assert torch.equal(c1, tpg.edges_plain(g._replace(poses=P))[2])
    back = g.poses @ tlie.exp_se3(torch.where(g.pose_valid[:, None], -dx,
                                              0.0))
    assert float(tpg.edges_plain(g._replace(poses=back))[2]) > float(c)
    mark = r + 1.0        # not the residuals at g.poses: handed back as is
    P2, c2, r2 = tpg.update_plain(g, c, dx, -1.0, mark)
    assert torch.equal(P2, g.poses) and torch.equal(c2, c)
    assert torch.equal(r2, mark)
    assert torch.equal(tpg.update_plain(g, c, dx, -1.0)[2], r)


def _recomputing_solve(name, g, freeze, iters, cg_iters=24):
    """The GN loop as it was: the edges at every step, the first cost from
    an evaluation of its own, the update's trial cost from the residuals
    at the trial poses."""
    F = g.poses.shape[0]
    diag = tpg._diag(g, freeze, True)
    cost = lambda P: torch.sum(g.edge_w * torch.sum(
        tpg.edge_residuals_plain(P, g) ** 2, dim=-1))
    c0 = cost(g.poses)
    c, poses = c0, g.poses
    for _ in range(iters):
        gi = g._replace(poses=poses)
        r = tpg.edge_residuals_plain(poses, gi)
        Ji = tpg._jac(gi)
        if name == "dense":
            H, gv = tpg.assemble_plain(gi, r, Ji, diag)
            step = -torch.linalg.solve_ex(H, gv[:, None])[0][:, 0].reshape(
                F, 6)
        else:
            gv, Hd = tpg.blocks_plain(gi, r, Ji, diag)
            step = tpg.pcg_plain(gi, Ji, torch.linalg.inv_ex(Hd)[0], diag,
                                 gv, cg_iters)
        new = poses @ tlie.exp_se3(torch.where(g.pose_valid[:, None], step,
                                               0.0))
        c_new = cost(new)
        ok = torch.isfinite(c_new) & (c_new <= c)
        poses, c = torch.where(ok, new, poses), torch.where(ok, c_new, c)
    return poses, c0, c


@pytest.mark.parametrize("name,F,n,extra", [("dense", 64, 40, 60),
                                            ("dense", 128, 100, 300),
                                            ("pcg", 64, 40, 60),
                                            ("pcg", 128, 100, 300)])
def test_solves_equal_recomputing_loop(one_thread, name, F, n, extra):
    """The solves, which evaluate Ji once, build H (its LU) or the inverted
    diagonal blocks once and take each step's residuals and gradient from
    the last update, give the same bits as the loop that evaluates every
    edge, assembles and solves (``solve_ex``, ``inv_ex``) at every step (12
    iterations, rejected steps among them near convergence)."""
    g = _circle(F, n, extra)
    freeze = torch.zeros(F, dtype=torch.bool)
    got = (tpg._optimize_dense(g, freeze, 12) if name == "dense"
           else tpg._optimize_pcg(g, freeze, 12, 24))
    want = _recomputing_solve(name, g, freeze, 12)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert float(got[2]) < 0.5 * float(got[1])


@pytest.mark.parametrize("F,n,extra", [(64, 40, 60), (128, 100, 300)])
def test_gradient_plain_is_the_assemblies_gradient(one_thread, F, n, extra):
    """gradient_plain in the dense order is assemble_plain's g, in the PCG
    order blocks_plain's g, bit for bit, at the first residuals and at those
    after a step, in float32 and float64; and each equals the reference's
    own scatter written out (dense: two index_adds over the edges; PCG: the
    incidence matmuls)."""
    g32 = _circle(F, n, extra)
    for g in (g32, g32._replace(poses=g32.poses.double(),
                                edge_T=g32.edge_T.double(),
                                edge_w=g32.edge_w.double())):
        r, Ji, c = tpg.edges_plain(g)
        diag = tpg._diag(g, torch.zeros(F, dtype=torch.bool), True)
        gv, Hd = tpg.blocks_plain(g, r, Ji, diag)
        dx = tpg.pcg_plain(g, Ji, torch.linalg.inv(Hd), diag, gv, 24)
        r1 = tpg.update_plain(g, c, dx, 1.0, r)[2]
        assert not torch.equal(r1, r)
        w = g.edge_w
        for res in (r, r1):
            gi = torch.einsum("e,eap,ea->ep", w, Ji, res)
            want = torch.zeros((F, 6), dtype=w.dtype)
            want.index_add_(0, g.edge_i.long(), gi)
            want.index_add_(0, g.edge_j.long(), w[:, None] * res)
            dense = tpg.gradient_plain(g, res, Ji, "dense")
            assert torch.equal(dense, want.reshape(-1))
            assert torch.equal(dense, tpg.assemble_plain(g, res, Ji, diag)[1])
            Pi, Pj = tpg._incidence_onehot(g)
            pcg = tpg.gradient_plain(g, res, Ji, "pcg")
            assert torch.equal(pcg, Pi.T @ gi + Pj.T @ (w[:, None] * res))
            assert torch.equal(pcg, tpg.blocks_plain(g, res, Ji, diag)[0])


@pytest.mark.parametrize("F,n,extra", [(64, 40, 60), (128, 100, 300)])
def test_lu_once_equals_solve_ex(one_thread, F, n, extra):
    """The dense step from H's LU, factored once a solve (``lu_factor``,
    ``lu_step``), has ``torch.linalg.solve_ex``'s bits at n = 6F = 384 and
    768 for the gradients of several GN steps."""
    g = _circle(F, n, extra)
    r, Ji, c = tpg.edges_plain(g)
    diag = tpg._diag(g, torch.zeros(F, dtype=torch.bool), True)
    H, gv = tpg.assemble_plain(g, r, Ji, diag)
    lu = tpg.lu_factor(H)
    for _ in range(3):
        want = torch.linalg.solve_ex(H, gv[:, None])[0][:, 0]
        assert torch.equal(tpg.lu_step(lu, gv), want)
        P, c, r = tpg.update_plain(g, c, want.reshape(F, 6), -1.0, r)
        g = g._replace(poses=P)
        gv = tpg.gradient_plain(g, r, Ji, "dense")
