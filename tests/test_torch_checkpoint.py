"""Port parity: map checkpoints and resumed SLAM runs.

``backend/checkpoint.py``: a MapState of random contents (every field in
its dtype) saved by each package and loaded by the other: the same npz
keys, dtypes and bytes, and the loaded states, configs and extras exactly
equal.

``FusedPLSLAM.save_checkpoint`` / ``resume`` on test_torch_fused_slam's
41-frame loop scene (320x240, a keyframe every frame, loops on, the
closure KF 0 -> KF 32 at frame 32, chunks of 4):

- the reference's run, points only, checkpointed after 5 chunks: both
  packages' checkpoints of the same run have the same keys (the port's
  two of its own besides: ``lc_streaks``, and ``lc_bow_ln_valid`` with
  lines) and dtypes; the port resumes the reference's checkpoint and its
  continuation matches the reference's uninterrupted run: keyframe frames,
  loop events and graph edges exactly, KF poses and the trajectory within
  test_torch_fused_slam's 1 cm. Points only: the reference rebuilds its
  line BoW rows from the map's current line masks, which culling has
  changed since the rows were made, so its own resumed runs with lines
  differ from its uninterrupted ones;
- the port's own round trip, with lines: the BoW rows after ``resume``
  bit-equal to the saved driver's (the line masks travel in
  ``lc_bow_ln_valid``), and the continuation equal to the uninterrupted
  run bit for bit (trajectory, KF poses, events, funnel, edges).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.backend import checkpoint as jck
from plslam_tpu.backend import fused_slam as jfs
from plslam_tpu.backend import map as jmap
from plslam_tpu.io import synthetic
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import checkpoint as tck
from plslam_tpu_torch.backend import fused_slam as tfs
from test_torch_fused_slam import CAM, CFG_LOOP, N_LOOP, TCAM

CUT = 5                                     # chunks before the checkpoint
POINTS = CFG_LOOP.with_updates({"lines": {"has_lines": False}})


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the port's SLAM path is thousands of small ops,
    which oversubscribed OpenMP threads slow down many times over when the
    suite runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_state(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for f, x in jmap.init_map_state(cfg)._asdict().items():
        a = np.asarray(x)
        if a.dtype == np.bool_:
            out[f] = rng.random(a.shape) < 0.5
        elif a.dtype == np.float32:
            out[f] = rng.normal(0, 3, a.shape).astype(np.float32)
        else:
            info = np.iinfo(a.dtype)
            out[f] = rng.integers(max(info.min, -2 ** 31),
                                  min(info.max, 2 ** 31 - 1), a.shape,
                                  dtype=np.int64).astype(a.dtype)
    return jmap.MapState(**{f: jnp.asarray(a) for f, a in out.items()})


def test_save_and_load_map_both_ways(tmp_path):
    state = _random_state(POINTS, 0)
    extra = {"trajectory": np.random.default_rng(1).normal(
        size=(7, 4, 4)).astype(np.float32), "kf_slot": np.int32(5)}
    tcfg = convert.config_from_dict(dataclasses.asdict(POINTS))
    tstate = convert.map_state_from_numpy(
        {f: np.asarray(x) for f, x in state._asdict().items()}, "cpu")
    jp, tp = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jck.save_map(jp, state, POINTS, extra=extra)
    tck.save_map(tp, tstate, tcfg, extra=extra)
    zj, zt = np.load(jp), np.load(tp)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape, k
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert json.loads(bytes(zt["config_json"]).decode()) == json.loads(
        json.dumps(POINTS.to_dict()))
    # the port loads the reference's file, the reference the port's
    got, gcfg, gx = tck.load_map(jp, "cpu")
    want, wcfg, wx = jck.load_map(tp)
    assert gcfg == tcfg and wcfg == POINTS
    for f in state._fields:
        w = np.asarray(getattr(want, f))
        assert w.dtype == np.asarray(getattr(state, f)).dtype, f
        np.testing.assert_array_equal(w, np.asarray(getattr(state, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(tstate, f).numpy(), err_msg=f)
        assert getattr(got, f).dtype == getattr(tstate, f).dtype, f
    for x in (gx, wx):
        assert sorted(x) == sorted(extra)
        for k, v in extra.items():
            np.testing.assert_array_equal(x[k], v)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.make_sequence(CAM, n_frames=N_LOOP, seed=3, kind="loop",
                                  n_points=300, n_lines=40, noise=0.004,
                                  step=0.15)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return u8(np.asarray(seq.images_l)), u8(np.asarray(seq.images_r))


def _chunks(slam, il, ir, lo_chunk, hi_chunk):
    k = CFG_LOOP.system.kf_batch
    for c in range(lo_chunk, hi_chunk):
        lo = 1 + c * k
        slam.process_chunk(il[lo:lo + k], ir[lo:lo + k])


N_CHUNKS = (N_LOOP - 1) // CFG_LOOP.system.kf_batch


def _run(slam, il, ir, stop=None, path=None):
    """initialize and chunks up to ``stop``, then save_checkpoint (with
    ``path``), else finish; returns the slam."""
    slam.initialize(il[0], ir[0])
    _chunks(slam, il, ir, 0, N_CHUNKS if stop is None else stop)
    if path is not None:
        slam.save_checkpoint(path)
    else:
        slam.finish()
    return slam


def _kf_frames(slam):
    return np.nonzero(np.diff([a for a, _ in slam._frame_anchor]))[0]


def _edges(lc):
    return [[e[:2] + tuple(e[3:]) for e in x]
            for x in (lc.odo_edges, lc.covis_edges, lc.loop_edges)]


def test_port_resumes_reference_checkpoint(frames, tmp_path):
    il, ir = frames
    ref_full = _run(jfs.FusedPLSLAM(POINTS, CAM), il, ir)
    est_full = ref_full.finish()
    path = str(tmp_path / "ref.npz")
    ref_half = _run(jfs.FusedPLSLAM(POINTS, CAM), il, ir, CUT, path)
    print(f"reference streaks at the checkpoint: "
          f"{ref_half.loop_closer.voter._streaks}")
    tcfg = convert.config_from_dict(dataclasses.asdict(POINTS))
    port = tfs.FusedPLSLAM.resume(path, TCAM, device="cpu")
    assert port.cfg == tcfg
    _chunks(port, il, ir, CUT, N_CHUNKS)
    est = port.finish()
    # the port's checkpoint of its resumed driver: the reference's keys and
    # dtypes, plus lc_streaks
    own = str(tmp_path / "port.npz")
    port.save_checkpoint(own)
    zj, zt = np.load(path), np.load(own)
    assert sorted(set(zt.files) - set(zj.files)) == ["extra_lc_streaks"]
    assert set(zj.files) <= set(zt.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype, k
        if not k.startswith(("extra_lc_", "extra_anchor", "extra_traj")):
            assert zt[k].shape == zj[k].shape, k
    # the continuation against the reference's uninterrupted run
    assert len(est) == len(est_full) == N_LOOP
    np.testing.assert_array_equal(_kf_frames(port), _kf_frames(ref_full))
    lt, lj = port.loop_closer, ref_full.loop_closer
    ev = lambda lc: [(e.kf_from, e.kf_to, e.n_inliers) for e in lc.events]
    print(f"events: port {ev(lt)}, reference {ev(lj)}")
    assert ev(lt) == ev(lj) and len(ev(lj)) >= 1
    assert lt.n_loops_closed == lj.n_loops_closed
    assert _edges(lt) == _edges(lj)
    kp_t, kp_j = port.kf_poses(), ref_full.kf_poses()
    dt = float(np.abs(kp_t[:, :3, 3] - kp_j[:, :3, 3]).max())
    dtraj = float(np.abs(est[:, :3, 3] - est_full[:, :3, 3]).max())
    print(f"KF poses {dt:.3g} m, trajectory {dtraj:.3g} m")
    assert dt < 0.01 and dtraj < 0.01


def test_port_round_trip(frames, tmp_path):
    il, ir = frames
    tcfg = convert.config_from_dict(dataclasses.asdict(CFG_LOOP))
    full = _run(tfs.FusedPLSLAM(tcfg, TCAM, device="cpu"), il, ir)
    est_full = full.finish()
    path = str(tmp_path / "port.npz")
    half = _run(tfs.FusedPLSLAM(tcfg, TCAM, device="cpu"), il, ir, CUT, path)
    z = np.load(path)
    assert "extra_lc_bow_ln_valid" in z.files and "extra_prev_lns_0" in z.files
    res = tfs.FusedPLSLAM.resume(path, TCAM, device="cpu")
    db, db0 = res.loop_closer.db, half.loop_closer.db
    for name in ("bows_p", "bows_l", "ln_valid"):
        assert torch.equal(getattr(db, name), getattr(db0, name)), name
    # the line masks the rows were made from are not the map's any more
    n = int(half.state.n_kfs)
    assert not torch.equal(db0.ln_valid[:n], half.state.obs_ln_lm[:n] >= 0)
    assert res.loop_closer.voter._streaks == half.loop_closer.voter._streaks
    funnel = lambda lc: np.array((lc.n_candidates, lc.n_votes_fired,
                                  lc.n_rej_geom, lc.n_rej_unc, lc.n_rej_corr))
    saved = funnel(half.loop_closer)
    _chunks(res, il, ir, CUT, N_CHUNKS)
    est = res.finish()
    assert np.array_equal(est, est_full)
    assert np.array_equal(res.kf_poses(), full.kf_poses())
    lt, lf = res.loop_closer, full.loop_closer
    assert lt.events == lf.events and len(lf.events) >= 1
    assert _edges(lt) == _edges(lf)
    # the funnel's counters start again at a resume (the reference's keys
    # do not carry them): the two halves add up to the whole run
    assert (saved + funnel(lt) == funnel(lf)).all()
    assert lt.n_loops_closed == lf.n_loops_closed
