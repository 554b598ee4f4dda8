"""Port parity: KF-slot compaction with pressure eviction.

``force_retire_kfs`` and ``compact_keyframes`` (backend/map.py): a map of
ten keyframes over a small world (``test_torch_map._frame``'s features:
K=128 points, L=32 lines, ``max_kfs=16``) built KF by KF with
``add_keyframe`` in each package. The reference's functions run on its
state and the port's on the same state carried across
(``convert.map_state_from_numpy``): every field, ``exact_map``,
``floor_map``, ``n_valid`` and ``n_removed`` exactly equal; and on the
port's own state: ids, counters and masks exactly, float fields within
1e-5 (the two builds' f32 transforms). The eviction cases: ``n_retire``
below and above the removable count, and redundancy fractions that tie
once the odd-slot bonus is added (f32(0.5) + f32(0.1) == f32(0.6)), so
the candidate order hangs on the score's float32 order and the age term.

``LoopCloser.remap_slots`` on the same edges and BoW rows in both
packages: odometry chains across dropped slots, covisibility and loop
edges re-expressed through the nearest surviving earlier KF (with
``old_poses``) or dropped (without). Edge ends exact, T within 1e-6, the
BoW rows exactly, the voter's streaks cleared.

The driver: the reference's ``FusedPLSLAM`` and the port's
(``device="cpu"``) over 1 + 15 x 4 frames of ``test_kf_capacity.SMALL``
(384x240, points only, a keyframe every frame, ``max_kfs=40``): three
compactions, each with a pressure eviction. ``n_compactions``,
``eviction_events`` (frame and slots) and the frame anchors' slots are
exactly equal; KF poses and the trajectory within test_torch_fused_slam's
1 cm.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import fused_slam as jfs
from plslam_tpu.backend import map as jmap
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.features import LineObservations, PointObservations
from plslam_tpu.io import synthetic
from plslam_tpu.loop import loop_closer as jlc
from plslam_tpu.loop.database import ConsistencyVoter as JVoter
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import fused_slam as tfs
from plslam_tpu_torch.backend import map as tmap
from plslam_tpu_torch.loop import loop_closer as tlc
from plslam_tpu_torch.loop.database import ConsistencyVoter as TVoter
from test_kf_capacity import SMALL
from test_torch_map import CAM, CFG, TCAM, TCFG, _frame

N_KF = 10
# window 2 + fixed 1: slots 1 .. n_kfs - 4 may be evicted
EVICT = CFG.with_updates({"mapping": {"window_kfs": 2, "fixed_kfs": 1}})
TEVICT = convert.config_from_dict(dataclasses.asdict(EVICT))
_U32 = ("pt_desc_ring", "ln_desc_ring", "kf_pt_desc", "kf_ln_desc")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread (see test_torch_apps.py): the driver's run is
    thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(s):
    return {f: np.asarray(x) for f, x in s._asdict().items()}


def _t_state(s):
    return convert.map_state_from_numpy(_np_state(s), "cpu")


def _j_state(arrays):
    """Field arrays (the port's int32 descriptor words included) -> the
    reference's MapState."""
    return jmap.MapState(**{
        f: jnp.asarray(a.view(np.uint32) if f in _U32 else a)
        for f, a in arrays.items()})


def _assert_state(got, want, ftol=0.0):
    for f in want._fields:
        g = getattr(got, f).numpy()
        w = np.asarray(getattr(want, f))
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        if ftol and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=ftol, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.fixture(scope="module")
def states():
    """The ten-KF map, built by each package's add_keyframe: (reference
    state, the port's state)."""
    rng = np.random.default_rng(0)
    world = dict(
        pts=np.stack([rng.uniform(-10, 10, 400), rng.uniform(-6, 6, 400),
                      rng.uniform(4, 30, 400)], -1),
        pdesc=rng.random((400, 256)) < 0.5,
        ls=np.stack([rng.uniform(-8, 8, 60), rng.uniform(-5, 5, 60),
                     rng.uniform(5, 20, 60)], -1),
        ldesc=rng.random((60, 256)) < 0.5)
    world["le"] = world["ls"] + rng.normal(0, 1.5, (60, 3))
    js = jmap.init_map_state(CFG)
    ts = tmap.init_map_state(TCFG, "cpu")
    for i in range(N_KF):
        T_w = np.eye(4)
        T_w[:3, 3] = [0.02 * i, 0.0, 0.05 * i]
        pts, lns = _frame(world, T_w, rng)
        js, _ = jmap.add_keyframe(
            js, PointObservations(**{k: jnp.asarray(v)
                                     for k, v in pts.items()}),
            LineObservations(**{k: jnp.asarray(v) for k, v in lns.items()}),
            jnp.asarray(T_w, jnp.float32), CAM, CFG)
        ts, _ = tmap.add_keyframe(
            ts, convert.points_from_numpy(pts, "cpu"),
            convert.lines_from_numpy(lns, "cpu"),
            torch.from_numpy(T_w.astype(np.float32)), TCAM, TCFG)
    _assert_state(ts, js, ftol=1e-5)
    return js, ts


def _tied(js):
    """The reference's state with slots 1-6 rewritten so that their
    redundancy fractions are 1/2, 3/5, 1/2, 3/5, 7/10, 4/5: odd slots get
    +0.1, so 1-4 tie at f32(0.6) and 5-6 at f32(0.8) before the age term."""
    a = _np_state(js)
    lm, nobs = a["obs_pt_lm"].copy(), a["pt_nobs"].copy()
    P = nobs.shape[0]
    nobs[P - 200:P - 100] = 9              # well observed
    nobs[P - 100:] = 1                     # seen once
    for s, (well, n) in zip(range(1, 7), ((1, 2), (3, 5), (2, 4), (6, 10),
                                          (7, 10), (4, 5))):
        lm[s] = -1
        lm[s, :well] = np.arange(P - 200, P - 200 + well) + s
        lm[s, well:n] = np.arange(P - 100, P - 100 + n - well) + s
    a["obs_pt_lm"], a["pt_nobs"] = lm, nobs
    return _j_state(a)


@pytest.mark.parametrize("case,n_retire", [("map", 3), ("map", 9),
                                           ("tied", 4), ("tied", 7)])
def test_force_retire_and_compact_match_reference(states, case, n_retire):
    js, ts = states
    if case == "tied":
        js = _tied(js)
        ts = _t_state(js)
    want, wn = jmap.force_retire_kfs(js, EVICT, n_retire)
    got, gn = tmap.force_retire_kfs(_t_state(js), TEVICT, n_retire)
    _assert_state(got, want)
    assert int(gn) == int(wn)
    removable = N_KF - 4
    assert int(wn) == min(n_retire, removable)
    own, on = tmap.force_retire_kfs(ts, TEVICT, n_retire)
    _assert_state(own, want, ftol=1e-5)
    assert int(on) == int(wn)
    # compaction of the evicted map, of a map with slots retired by hand
    # (n_kfs below F) and of a map where every slot is live
    hand = _np_state(js)
    hand["kf_valid"] = hand["kf_valid"].copy()
    hand["kf_valid"][[0, 4, 9]] = False
    for s in (want, _j_state(hand), js):
        w = jmap.compact_keyframes(s)
        g = tmap.compact_keyframes(_t_state(s))
        _assert_state(g[0], w[0])
        for x, y in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    order = np.nonzero(np.asarray(js.kf_valid) & ~np.asarray(want.kf_valid))
    print(f"{case}, n_retire {n_retire}: evicted slots {order[0].tolist()}")


def _closer(mod, voter, rng_seed, n, F=24):
    """A loop closer of ``mod`` (either package) holding the same edges,
    BoW rows and streaks (made from ``rng_seed``), without its vocabulary."""
    rng = np.random.default_rng(rng_seed)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(F - 1):
        T = synthetic._exp_se3_np(rng.normal(0, 0.2, 6).astype(np.float32))
        poses.append((poses[-1] @ T).astype(np.float32))
    poses = np.stack(poses)
    rel = lambda i, j: (np.linalg.inv(poses[i]) @ poses[j]).astype(np.float32)
    lc = mod.LoopCloser.__new__(mod.LoopCloser)
    lc._dist = None                  # no sharded database
    lc.odo_edges = [(i - 1, i, rel(i - 1, i), 1.0) for i in range(1, n)]
    pairs = {(int(i), int(j)) for i, j in rng.integers(0, n, (40, 2))
             if j > i + 1}
    lc.covis_edges = [(i, j, rel(i, j), 0.5, int(rng.integers(20, 90)))
                      for i, j in sorted(pairs)]
    lc.loop_edges = [(1, n - 2, rel(1, n - 2), 2.0),
                     (4, n - 1, rel(4, n - 1), 2.0)]
    bows = rng.random((F, 50)).astype(np.float32)
    bows_l = rng.random((F, 30)).astype(np.float32)
    if mod is jlc:
        lc.db = type("Db", (), {"bows_p": jnp.asarray(bows),
                                "bows_l": jnp.asarray(bows_l)})()
    else:
        lc.db = type("Db", (), {"bows_p": torch.from_numpy(bows),
                                "bows_l": torch.from_numpy(bows_l),
                                "ln_valid": torch.from_numpy(
                                    rng.random((F, 8)) < 0.5)})()
    lc.voter = voter(3)
    lc.voter._streaks = {4: 2, 9: 1}
    return lc, poses


@pytest.mark.parametrize("with_poses", [True, False])
def test_remap_slots_matches_reference(with_poses):
    n, F = 20, 24
    valid = np.ones(F, bool)
    valid[[2, 3, 7, 11, 12, 13, 18]] = False     # chains across the gaps
    valid[n:] = False
    exact = np.where(valid, np.cumsum(valid) - 1, -1).astype(np.int32)
    nv = int(valid.sum())
    ref, poses = _closer(jlc, JVoter, 0, n, F)
    port, _ = _closer(tlc, TVoter, 0, n, F)
    ln_before = port.db.ln_valid.clone()
    old = poses if with_poses else None
    ref.remap_slots(exact, nv, old_poses=old)
    port.remap_slots(exact, nv, old_poses=old)
    for name in ("odo_edges", "covis_edges", "loop_edges"):
        a, b = getattr(port, name), getattr(ref, name)
        assert len(a) == len(b) and len(b) > 0, name
        for x, y in zip(a, b):
            assert x[:2] == y[:2] and x[3:] == y[3:], name
            np.testing.assert_allclose(x[2], y[2], rtol=0, atol=1e-6,
                                       err_msg=name)
    # the odometry chain bridges every gap: one edge a surviving pair
    assert [e[:2] for e in port.odo_edges] == [(i, i + 1)
                                               for i in range(nv - 1)]
    n_covis = len(port.covis_edges)
    print(f"with_poses={with_poses}: {n_covis} covisibility edges kept")
    for b in ("bows_p", "bows_l"):
        np.testing.assert_array_equal(getattr(port.db, b).numpy(),
                                      np.asarray(getattr(ref.db, b)))
    perm = np.nonzero(valid)[0]
    want_ln = np.zeros_like(ln_before.numpy())
    want_ln[:nv] = ln_before.numpy()[perm]
    np.testing.assert_array_equal(port.db.ln_valid.numpy(), want_ln)
    assert port.voter._streaks == {} == ref.voter._streaks


N_DRIVE = 61
CHUNK = 4


@pytest.fixture(scope="module")
def capacity_scene():
    cfg = SMALL
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=N_DRIVE, seed=11, kind="loop",
                                  n_points=500, n_lines=0, noise=0.004,
                                  step=0.12)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return cfg, cam, u8(np.asarray(seq.images_l)), u8(
        np.asarray(seq.images_r)), seq


def _drive(slam, il, ir):
    slam.initialize(il[0], ir[0])
    for lo in range(1, N_DRIVE, CHUNK):
        slam.process_chunk(il[lo:lo + CHUNK], ir[lo:lo + CHUNK])
    return slam.finish()


def test_fused_slam_compaction_matches_reference(capacity_scene):
    cfg, cam, il, ir, seq = capacity_scene
    ref = jfs.FusedPLSLAM(cfg, cam)
    with pytest.warns(UserWarning, match="eviction"):
        est_j = _drive(ref, il, ir)
    port = tfs.FusedPLSLAM(
        convert.config_from_dict(dataclasses.asdict(cfg)),
        convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.b,
                                  cam.width, cam.height), device="cpu")
    with pytest.warns(UserWarning, match="eviction"):
        est_t = _drive(port, il, ir)
    print(f"compactions {port.n_compactions}, evictions "
          f"{port.eviction_events}")
    assert port.n_compactions == ref.n_compactions >= 3
    assert port.eviction_events == ref.eviction_events
    assert port.n_evicted_kfs == ref.n_evicted_kfs >= 20
    assert ([s for s, _ in port._frame_anchor]
            == [s for s, _ in ref._frame_anchor])
    assert int(port.state.n_kfs) == int(ref.state.n_kfs) <= 40
    assert len(est_t) == len(est_j) == N_DRIVE
    kp_t, kp_j = port.kf_poses(), ref.kf_poses()
    dt = float(np.abs(kp_t[:, :3, 3] - kp_j[:, :3, 3]).max())
    dtraj = float(np.abs(est_t[:, :3, 3] - est_j[:, :3, 3]).max())
    print(f"KF poses {dt:.3g} m, trajectory {dtraj:.3g} m")
    assert dt < 0.01 and dtraj < 0.01
