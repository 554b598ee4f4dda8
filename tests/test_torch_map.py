"""Port parity: backend/map.py (K16 medoid, slot allocation, keyframe
insertion, KF retirement, landmark culling).

A small world (400 points, 60 segments with fixed descriptors) is seen by
ten keyframes a few centimetres apart: each frame's features are the
visible landmarks' projections with pixel noise, stereo disparity and a few
flipped descriptor bits (K=128 points, L=32 lines), so map matching finds
real matches and the landmarks reach the observer counts that the
redundancy sweeps and the culling test. Capacities are small:
``max_kfs=16``, ``max_points=512``, ``max_lines=64``. The reference builds
the map KF by KF (jitted ``add_keyframe``); each of its states crosses
into the port through ``convert.map_state_from_numpy`` and the port inserts
the same frame.

Required: every integer and bool field and the diagnostics exactly equal
(slots, matches, counters, rings, descriptors, observation tables); float
fields within 1e-5 (positions, directions, poses: f32 transforms in
another order). The medoid, the slot allocation, both redundant-KF
sweeps and the culling (both tiers) exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import map as jmap
from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.features import (LineObservations, PointObservations,
                                          line_equation)
from plslam_tpu.ops import hamming as jhamming
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import map as tmap

CFG = SlamConfig().with_updates({
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "baseline": 0.3},
    "points": {"max_kpts": 128}, "lines": {"max_lines": 32},
    "mapping": {"max_kfs": 16, "max_points": 512, "max_lines": 64}})
CAM = StereoCamera.from_config(CFG.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)
N_KF = 10


def _project(T_cw, X):
    Pc = X @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv = np.stack([CAM.fx * Pc[:, 0] / Pc[:, 2] + CAM.cx,
                   CAM.fy * Pc[:, 1] / Pc[:, 2] + CAM.cy], -1)
    return Pc, uv


def _frame(world, T_w, rng):
    """One KF's point and line features (dicts of field arrays)."""
    K, L = CFG.points.max_kpts, CFG.lines.max_lines
    T_cw = np.linalg.inv(T_w)
    Pc, uv = _project(T_cw, world["pts"])
    vis = np.nonzero((Pc[:, 2] > 1.0) & (uv[:, 0] > 2) & (uv[:, 0] < 318)
                     & (uv[:, 1] > 2) & (uv[:, 1] < 238)
                     & (rng.random(len(uv)) < 0.6))[0][:K]
    n = len(vis)
    uvn = uv[vis] + rng.normal(0, 0.3, (n, 2))
    disp = CAM.fx * CAM.b / Pc[vis, 2] + rng.normal(0, 0.1, n)
    z = CAM.fx * CAM.b / disp
    P3 = np.stack([(uvn[:, 0] - CAM.cx) * z / CAM.fx,
                   (uvn[:, 1] - CAM.cy) * z / CAM.fy, z], -1)
    desc = world["pdesc"][vis] ^ (rng.random((n, 256)) < 0.03)
    pts = dict(uv=np.zeros((K, 2)), uv_r=np.zeros((K, 2)), disp=np.zeros(K),
               P=np.zeros((K, 3)), desc=np.zeros((K, 256), np.uint8),
               octave=np.zeros(K, np.int32), angle=np.zeros(K),
               score=np.zeros(K), valid=np.zeros(K, bool))
    pts["uv"][:n], pts["disp"][:n], pts["P"][:n] = uvn, disp, P3
    pts["uv_r"][:n] = uvn - np.stack([disp, np.zeros(n)], -1)
    pts["desc"][:n], pts["valid"][:n] = desc, True
    pts["score"][:n] = rng.random(n)
    # lines: both endpoints visible
    sPc, sp = _project(T_cw, world["ls"])
    ePc, ep = _project(T_cw, world["le"])
    ok = ((sPc[:, 2] > 1.0) & (ePc[:, 2] > 1.0)
          & (np.abs(sp - [160, 120]) < [150, 110]).all(-1)
          & (np.abs(ep - [160, 120]) < [150, 110]).all(-1)
          & (rng.random(len(sp)) < 0.8))
    vis = np.nonzero(ok)[0][:L]
    m = len(vis)
    spn = sp[vis] + rng.normal(0, 0.3, (m, 2))
    epn = ep[vis] + rng.normal(0, 0.3, (m, 2))
    lns = dict(sp=np.zeros((L, 2)), ep=np.zeros((L, 2)), le=np.zeros((L, 3)),
               angle=np.zeros(L), sdisp=np.zeros(L), edisp=np.zeros(L),
               sP=np.zeros((L, 3)), eP=np.zeros((L, 3)),
               desc=np.zeros((L, 256), np.uint8), score=np.zeros(L),
               valid=np.zeros(L, bool))
    lns["sp"][:m], lns["ep"][:m] = spn, epn
    lns["le"][:m] = np.asarray(line_equation(jnp.asarray(spn, jnp.float32),
                                             jnp.asarray(epn, jnp.float32)))
    lns["sdisp"][:m] = CAM.fx * CAM.b / sPc[vis, 2]
    lns["edisp"][:m] = CAM.fx * CAM.b / ePc[vis, 2]
    lns["sP"][:m], lns["eP"][:m] = sPc[vis], ePc[vis]
    lns["desc"][:m] = world["ldesc"][vis] ^ (rng.random((m, 256)) < 0.03)
    lns["valid"][:m] = True
    cast = lambda d: {k: (v.astype(np.float32) if v.dtype == np.float64
                          else v) for k, v in d.items()}
    return cast(pts), cast(lns)


@pytest.fixture(scope="module")
def run():
    """The reference's map, KF by KF: (states, frames, poses, diags)."""
    rng = np.random.default_rng(0)
    world = dict(
        pts=np.stack([rng.uniform(-10, 10, 400), rng.uniform(-6, 6, 400),
                      rng.uniform(4, 30, 400)], -1),
        pdesc=rng.random((400, 256)) < 0.5,
        ls=np.stack([rng.uniform(-8, 8, 60), rng.uniform(-5, 5, 60),
                     rng.uniform(5, 20, 60)], -1),
        ldesc=rng.random((60, 256)) < 0.5)
    world["le"] = world["ls"] + rng.normal(0, 1.5, (60, 3))
    states = [jmap.init_map_state(CFG)]
    frames, poses, diags = [], [], []
    for i in range(N_KF):
        T_w = np.eye(4)
        T_w[:3, 3] = [0.02 * i, 0.0, 0.05 * i]
        pts, lns = _frame(world, T_w, rng)
        s, d = jmap.add_keyframe(
            states[-1], PointObservations(**{k: jnp.asarray(v)
                                            for k, v in pts.items()}),
            LineObservations(**{k: jnp.asarray(v) for k, v in lns.items()}),
            jnp.asarray(T_w, jnp.float32), CAM, CFG)
        states.append(s)
        frames.append((pts, lns))
        poses.append(T_w.astype(np.float32))
        diags.append({k: int(v) for k, v in d.items()})
    return states, frames, poses, diags


def _np_state(s):
    return {f: np.asarray(x) for f, x in s._asdict().items()}


def _t_state(s):
    return convert.map_state_from_numpy(_np_state(s), "cpu")


def _assert_state_equal(got, want, ftol=1e-5):
    for f in want._fields:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=ftol, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_medoid_and_slot_allocation_exact():
    rng = np.random.default_rng(1)
    ring = rng.integers(0, 2 ** 32, (500, 4, 8), dtype=np.uint64).astype(
        np.uint32)
    ring[:100, 2] = ring[:100, 0]                          # ties
    count = rng.integers(0, 7, 500).astype(np.int32)
    want = np.asarray(jax.jit(jmap._medoid_desc)(jnp.asarray(ring),
                                                 jnp.asarray(count)))
    got = tmap._medoid_bits(torch.from_numpy(ring.view(np.int32)),
                            torch.from_numpy(count),
                            torch.ones(500, dtype=torch.bool),
                            torch.zeros((500, 256), dtype=torch.uint8))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jhamming.unpack_bits(jnp.asarray(want))))
    for p_free in (0.1, 0.5, 0.95):
        free = rng.random(300) < p_free
        want_ = rng.random(200) < 0.4
        ref = jax.jit(jmap._allocate_slots)(jnp.asarray(free),
                                            jnp.asarray(want_))
        np.testing.assert_array_equal(
            tmap._allocate_slots(torch.from_numpy(free),
                                 torch.from_numpy(want_)).numpy(),
            np.asarray(ref))


@pytest.mark.parametrize("family,N,R,seed", [("points", 600, 4, 2),
                                             ("lines", 80, 4, 3),
                                             ("ring8", 120, 8, 4),
                                             ("ring3", 90, 3, 5)])
def test_medoid_bits_matches_reference(family, N, R, seed):
    """K16 as add_keyframe stores it: the fused plain version against the
    reference's ``jnp.where(valid, unpack_bits(_medoid_desc(ring, n)),
    desc)`` exactly, on rings with ties (repeated and equidistant
    members), count 0, count > R and invalid rows."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(0, 2 ** 32, (N, R, 8), dtype=np.uint64).astype(
        np.uint32)
    q = N // 6
    ring[:q, R - 1] = ring[:q, 0]                           # repeated
    ring[q:2 * q] = ring[q:2 * q, :1]                       # all equal
    ring[2 * q:3 * q, :, 1:] = 0                            # near ties
    ring[2 * q:3 * q, :, 0] = rng.integers(0, 4, (q, R)).astype(np.uint32)
    count = rng.integers(-1, R + 3, N).astype(np.int32)    # 0 and > R
    count[:3 * q:2] = R
    valid = rng.random(N) < 0.75
    desc = rng.integers(0, 2, (N, 256)).astype(np.uint8)
    want = np.asarray(jax.jit(lambda r, n, v, d: jnp.where(
        v[:, None], jhamming.unpack_bits(jmap._medoid_desc(r, n)), d))(
        jnp.asarray(ring), jnp.asarray(count), jnp.asarray(valid),
        jnp.asarray(desc)))
    got = tmap._medoid_bits(torch.from_numpy(ring.view(np.int32)),
                            torch.from_numpy(count),
                            torch.from_numpy(valid), torch.from_numpy(desc))
    assert got.dtype == torch.uint8 and got.shape == (N, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (count <= 0).any() and (count > R).any() and (~valid).any()


def test_add_keyframe_matches_reference(run):
    states, frames, poses, diags = run
    assert sum(d["n_map_matches"] for d in diags) > 200      # real matching
    assert sum(d["n_ln_matches"] for d in diags) > 20
    for i, ((pts, lns), T_w) in enumerate(zip(frames, poses)):
        got, d = tmap.add_keyframe(
            _t_state(states[i]), convert.points_from_numpy(pts, "cpu"),
            convert.lines_from_numpy(lns, "cpu"), torch.from_numpy(T_w),
            TCAM, TCFG)
        _assert_state_equal(got, states[i + 1])
        assert {k: int(v) for k, v in d.items()} == diags[i]


def test_add_keyframe_capacity_guard(run):
    """At n_kfs == max_kfs the insert drops every write (never clamps
    onto the last slot)."""
    states, frames, poses, _ = run
    full = states[4]._replace(n_kfs=jnp.asarray(CFG.mapping.max_kfs,
                                                jnp.int32))
    (pts, lns), T_w = frames[4], poses[4]
    want, wd = jmap.add_keyframe(
        full, PointObservations(**{k: jnp.asarray(v) for k, v in pts.items()}),
        LineObservations(**{k: jnp.asarray(v) for k, v in lns.items()}),
        jnp.asarray(T_w), CAM, CFG)
    got, d = tmap.add_keyframe(_t_state(full),
                               convert.points_from_numpy(pts, "cpu"),
                               convert.lines_from_numpy(lns, "cpu"),
                               torch.from_numpy(T_w), TCAM, TCFG)
    _assert_state_equal(got, want)
    _assert_state_equal(got, full)                         # nothing moved
    assert int(d["n_new_points"]) == 0 == int(wd["n_new_points"])


def test_kf_retirement_and_culling_exact(run):
    states = run[0]
    s = states[-1]
    want, n = jmap.remove_redundant_kfs(s, CFG)
    got, n_t = tmap.remove_redundant_kfs(_t_state(s), TCFG)
    _assert_state_equal(got, want)
    assert int(n) == int(n_t)
    removed = int(n)
    for max_retire in (2, 4):
        want, n = jmap.remove_redundant_kfs_global(s, CFG, max_retire)
        got, n_t = tmap.remove_redundant_kfs_global(_t_state(s), TCFG,
                                                    max_retire)
        _assert_state_equal(got, want)
        assert int(n) == int(n_t)
        removed += int(n)
    assert removed > 0
    want = jmap.cull_landmarks(s, CFG)
    _assert_state_equal(tmap.cull_landmarks(_t_state(s), TCFG), want)
    assert int(jnp.sum(s.pt_valid & ~want.pt_valid)) > 0


def test_cull_pool_pressure_tier_exact(run):
    """Past the high-water mark the weakest mature landmarks retire (ties
    in (nobs, last_kf) broken by the lowest slot, as lax.top_k)."""
    s = run[0][-1]
    rng = np.random.default_rng(2)
    P, M = CFG.mapping.max_points, CFG.mapping.max_lines
    s = s._replace(
        n_kfs=jnp.asarray(15, jnp.int32),
        pt_valid=jnp.asarray(rng.random(P) < 0.97),
        pt_nobs=jnp.asarray(rng.integers(1, 6, P).astype(np.int32)),
        pt_last_kf=jnp.asarray(rng.integers(0, 15, P).astype(np.int32)),
        ln_valid=jnp.asarray(rng.random(M) < 0.97),
        ln_nobs=jnp.asarray(rng.integers(1, 6, M).astype(np.int32)),
        ln_last_kf=jnp.asarray(rng.integers(0, 15, M).astype(np.int32)))
    want = jmap.cull_landmarks(s, CFG)
    _assert_state_equal(tmap.cull_landmarks(_t_state(s), TCFG), want)
    assert int(jnp.sum(s.pt_valid & ~want.pt_valid)) >= int(
        CFG.mapping.lm_pool_evict_frac * P)
