"""Port parity: the per-frame and host-KF SLAM drivers
(``backend/slam_system.py``), the mapping worker (``MapHandler``), the
chunk back-end step (``make_chunk_backend``), ``vo_chunk(keep_feats=True)``
and ``run_concurrent``.

The same numpy frames go through the reference's driver and the port's
(``device="cpu"``):

- ``PLSLAM`` sync and async on tests/test_slam_backend.py's scene and
  ``CFG`` (640x384, points only, 10 frames, seed 12), and sync with lines
  (6 frames of the scene with 40 lines);
- ``ChunkedPLSLAM`` sync, loops off, on tests/test_chunked_slam.py's
  seed-4 scene (13 frames, chunks of 6), and sync, loops on, on its
  ``test_online_pose_reflects_midrun_loop_closure`` scene (512x320, 40
  frames, chunks of 13).

Held exactly: the keyframe frames, every summary's map matches and new
points, the landmark counts, the loop events (from, to, inliers) and
``closure_imminent`` after each settle. Held within tolerances (``TOL``:
positions 1e-4 m, rotations 1e-4 rad, LBA costs 1e-3 of max(the run's
largest cost, 1)): the KF poses, the trajectory and ``online_pose``.
Measured, and recorded in ROADMAP.md Queue 3: the window LBAs take LM
steps whose accept decisions lie within 1e-5 relative of their threshold
(8.3e-6 measured), so where no re-anchoring pulls the runs together their
windows part by tenths of a millimetre: the per-frame async run (3.9e-4 m,
``ASYNC_TOL``) and the loop run (2.3e-4 m through its graph solve,
``LOOP_TOL``, where one keyframe also makes one new point more). With
lines the LBD bits and segments differ slightly
(tests/test_torch_stereo_lines.py), so the costs are held to 1e-2
(``LINES_TOL``). In the loop run a wrong candidate's
verification solve may end in the other basin, which moves its rejection
between the geometry and the uncertainty gates: the funnel's candidates,
votes and closures are exact, its rejections by their sum. Port only: a
worker job that raises makes ``wait_idle`` raise, and two
``ChunkedPLSLAM`` sessions through ``run_concurrent`` equal the same
sessions run alone, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from plslam_tpu.backend import slam_system as jss
from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io import synthetic
from plslam_tpu.tracking import batch_vo as jbv
from plslam_tpu.utils.evaluation import ate_rmse
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import slam_system as tss
from plslam_tpu_torch.backend.map_handler import MapHandler
from plslam_tpu_torch.ops import hamming
from plslam_tpu_torch.tracking import batch_vo as tbv

from test_slam_backend import CFG as BACKEND_CFG
from test_chunked_slam import CFG as CHUNKED_CFG

# (positions m, rotations rad, costs as a share of max(the run's largest
# cost, 1)): the measured differences are in ROADMAP.md Queue 3
TOL = (1e-4, 1e-4, 1e-3)
LINES_TOL = (1e-4, 1e-4, 1e-2)     # LBD bits and segments differ slightly
ASYNC_TOL = (2e-3, 1e-3, 2e-2)
LOOP_TOL = (1e-3, 1e-3, 2e-2)      # a graph solve and its window LBA
CAM = StereoCamera.from_config(BACKEND_CFG.camera)

LOOP_CFG = SlamConfig().with_updates({
    "camera": {"width": 512, "height": 320, "fx": 400.0, "fy": 400.0,
               "cx": 256.0, "cy": 160.0, "baseline": 0.3},
    "points": {"max_kpts": 384, "orb_nlevels": 2},
    "lines": {"has_lines": False},
    "matching": {"f2f_window": 128.0},
    "mapping": {"max_kfs": 64, "max_points": 4096, "max_lines": 256,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 5},
    "keyframe": {"min_entropy_ratio": 2.0},
    "system": {"async_mapping": False},
    "loop": {"enabled": True, "min_kf_separation": 12,
             "consistency_window": 2, "lc_inl": 15,
             "lc_trs": 3.0, "lc_rot": 60.0},
})


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread (see test_torch_apps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg, cam):
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tcam = convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.b,
                                     cam.width, cam.height)
    return tcfg, tcam


def _rot_err(a, b) -> float:
    """Largest rotation angle (rad) between the poses of two stacks."""
    M = np.swapaxes(a[..., :3, :3], -1, -2).astype(np.float64) @ b[
        ..., :3, :3].astype(np.float64)
    w = 0.5 * np.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2]
                        - M[..., 2, 0], M[..., 1, 0] - M[..., 0, 1]], -1)
    return float(np.arcsin(np.clip(np.linalg.norm(w, axis=-1), 0, 1)).max())


def _hold_poses(tag, ref, got, pos_tol, rot_tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (tag, ref.shape, got.shape)
    dp = float(np.abs(ref[..., :3, 3] - got[..., :3, 3]).max())
    dr = _rot_err(ref, got)
    print(f"{tag}: positions within {dp:.3g} m, rotations {dr:.3g} rad")
    assert dp < pos_tol and dr < rot_tol, (tag, dp, dr)


def _hold_summaries(ref, got, cost_tol, count_tol=0):
    assert [s.slot for s in ref] == [s.slot for s in got]
    n_ref = np.array([(s.n_map_matches, s.n_new_points) for s in ref])
    n_got = np.array([(s.n_map_matches, s.n_new_points) for s in got])
    d = np.abs(n_ref - n_got)
    print(f"map matches / new points: {int((d > 0).any(-1).sum())} of "
          f"{len(ref)} keyframes differ, by at most {int(d.max())}")
    assert int(d.max()) <= count_tol and int((d > 0).sum()) <= 2 * count_tol
    c_ref = np.array([(s.lba_cost0, s.lba_cost1) for s in ref])
    c_got = np.array([(s.lba_cost0, s.lba_cost1) for s in got])
    scale = max(float(np.abs(c_ref).max()), 1.0)
    d = float(np.abs(c_ref - c_got).max()) / scale
    print(f"LBA costs within {d:.3g} of {scale:.6g}")
    assert d < cost_tol, d
    assert ((c_got[:, 1] <= c_got[:, 0]) | (c_got[:, 0] == 0)).all()


def _run_plslam(P, cfg, cam, seq, n, **kw):
    slam = P(cfg, cam, **kw)
    slam.initialize(seq.images_l[0], seq.images_r[0])
    kfs = [i for i in range(1, n)
           if slam.process(seq.images_l[i], seq.images_r[i]).kf_slot
           is not None]
    est = slam.finish()
    return dict(kfs=kfs, est=est, summaries=slam.map.summaries,
                kf_poses=slam.map.kf_poses(), lm=slam.map.n_landmarks())


def _hold_runs(ref, got, tol, count_tol=0):
    pos_tol, rot_tol, cost_tol = tol
    assert ref["kfs"] == got["kfs"]
    assert ref["lm"] == got["lm"], (ref["lm"], got["lm"])
    _hold_poses("KF poses", ref["kf_poses"], got["kf_poses"], pos_tol,
                rot_tol)
    _hold_poses("trajectory", ref["est"], got["est"], pos_tol, rot_tol)
    _hold_summaries(ref["summaries"], got["summaries"], cost_tol, count_tol)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_plslam_matches_reference(mode):
    seq = synthetic.make_sequence(CAM, n_frames=10, seed=12, n_points=260,
                                  n_lines=0, noise=0.003, step=0.12)
    cfg = BACKEND_CFG.with_updates(
        {"system": {"async_mapping": mode == "async"}})
    tcfg, tcam = _port(cfg, CAM)
    ref = _run_plslam(jss.PLSLAM, cfg, CAM, seq, 10)
    got = _run_plslam(tss.PLSLAM, tcfg, tcam, seq, 10, device="cpu")
    _hold_runs(ref, got, TOL if mode == "sync" else ASYNC_TOL)
    assert ate_rmse(got["est"], seq.poses) < 0.05


def test_plslam_with_lines_matches_reference():
    """Line landmarks through mapping_step: 6 frames with 40 lines."""
    seq = synthetic.make_sequence(CAM, n_frames=6, seed=12, n_points=260,
                                  n_lines=40, noise=0.003, step=0.12)
    cfg = BACKEND_CFG.with_updates({"lines": {"has_lines": True,
                                              "max_lines": 64}})
    tcfg, tcam = _port(cfg, CAM)
    ref = _run_plslam(jss.PLSLAM, cfg, CAM, seq, 6)
    got = _run_plslam(tss.PLSLAM, tcfg, tcam, seq, 6, device="cpu")
    assert got["lm"][1] > 0
    _hold_runs(ref, got, LINES_TOL)


def _run_chunked(P, cfg, cam, seq, chunks, **kw):
    slam = P(cfg, cam, enable_loops=cfg.loop.enabled, **kw)
    slam.initialize(seq.images_l[0], seq.images_r[0])
    imminent = []
    for lo, hi in chunks:
        slam.process_chunk(seq.images_l[lo:hi], seq.images_r[lo:hi])
        if slam.loop_closer is not None:
            imminent.append(slam.loop_closer.closure_imminent)
    while slam._inflight:
        slam._settle_one()
        if slam.loop_closer is not None:
            imminent.append(slam.loop_closer.closure_imminent)
    slam.map.wait_idle()
    online = slam.online_pose()
    est = slam.finish()
    out = dict(kfs=slam._kf_slot, est=est, summaries=slam.map.summaries,
               kf_poses=slam.map.kf_poses(), lm=slam.map.n_landmarks(),
               online=online, imminent=imminent)
    lc = slam.loop_closer
    if lc is not None:
        out["events"] = [(e.kf_from, e.kf_to, e.n_inliers) for e in lc.events]
        out["funnel"] = (lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom,
                         lc.n_rej_unc, lc.n_rej_corr, lc.n_loops_closed)
    return out


def test_chunked_plslam_matches_reference():
    seq = synthetic.make_sequence(CAM, n_frames=13, seed=4, n_points=300,
                                  n_lines=0, noise=0.003, step=0.2)
    tcfg, tcam = _port(CHUNKED_CFG, CAM)
    chunks = [(1, 7), (7, 13)]
    ref = _run_chunked(jss.ChunkedPLSLAM, CHUNKED_CFG, CAM, seq, chunks)
    got = _run_chunked(tss.ChunkedPLSLAM, tcfg, tcam, seq, chunks,
                       device="cpu")
    assert got["kfs"] >= 1
    _hold_runs(ref, got, TOL)
    _hold_poses("online pose", ref["online"], got["online"], *TOL[:2])


def test_chunked_plslam_with_loops_matches_reference():
    cam = StereoCamera.from_config(LOOP_CFG.camera)
    seq = synthetic.make_sequence(cam, n_frames=40, seed=21, kind="loop",
                                  n_points=700, n_lines=0, noise=0.004,
                                  step=0.35)
    tcfg, tcam = _port(LOOP_CFG, cam)
    chunks = [(1, 14), (14, 27), (27, 40)]
    ref = _run_chunked(jss.ChunkedPLSLAM, LOOP_CFG, cam, seq, chunks)
    got = _run_chunked(tss.ChunkedPLSLAM, tcfg, tcam, seq, chunks,
                       device="cpu")
    print(f"events {got['events']}, funnel {got['funnel']}, closure "
          f"imminent after each settle {got['imminent']}")
    print(f"reference funnel {ref['funnel']}")
    assert got["events"] == ref["events"] and len(got["events"]) >= 1
    # candidates, votes and closures exact; of the rejections only their
    # sum: a wrong candidate's verification solve may end in the other
    # basin (err 7.7e-7 and good, or err ~1e2 and not good), which moves
    # it between the geometry and the uncertainty gates
    f_got, f_ref = got["funnel"], ref["funnel"]
    assert (f_got[:2], f_got[5]) == (f_ref[:2], f_ref[5])
    assert sum(f_got[2:5]) == sum(f_ref[2:5])
    assert got["imminent"] == ref["imminent"]
    # one keyframe's triangulation makes one new point more (measured):
    # counts within 1 at no more than one keyframe
    _hold_runs(ref, got, LOOP_TOL, count_tol=1)
    _hold_poses("online pose", ref["online"], got["online"], *LOOP_TOL[:2])


def test_vo_chunk_keep_feats_packed_stacks():
    """The packed feature stacks: the port's words are the reference's
    uint32 words as int32, bit for bit for the ORB descriptors and for all
    but a few LBD bits (tests/test_torch_stereo_lines.py's rule: at least
    99.98% of the bits equal); each stack is exactly pack_bits of the port's
    own descriptor bits, and unpack_bits inverts it."""
    cfg = BACKEND_CFG.with_updates({"lines": {"has_lines": True,
                                              "max_lines": 64}})
    tcfg, tcam = _port(cfg, CAM)
    seq = synthetic.make_sequence(CAM, n_frames=4, seed=12, n_points=260,
                                  n_lines=40, noise=0.003, step=0.12)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    il, ir = u8(seq.images_l), u8(seq.images_r)
    prev_j = jbv.extract_one(jnp.asarray(il[0]), jnp.asarray(ir[0]), CAM,
                             cfg)
    ref = jbv.vo_chunk(jnp.asarray(il[1:]), jnp.asarray(ir[1:]), *prev_j,
                       jnp.eye(4), CAM, cfg, keep_feats=True)
    chunk = [torch.from_numpy(x) for x in (il[1:], ir[1:])]
    prev_t = tbv.extract_one(torch.from_numpy(il[0]), torch.from_numpy(ir[0]),
                             tcam, tcfg)
    got = tbv.vo_chunk(*chunk, *prev_t, torch.eye(4), tcam, tcfg,
                       keep_feats=True)
    plain = tbv.vo_chunk(*chunk, *prev_t, torch.eye(4), tcam, tcfg)
    assert plain.all_pts is None and plain.all_lns is None
    np.testing.assert_array_equal(got.DT.numpy(), plain.DT.numpy())
    src = tbv.extract_stereo_frame(*(tbv._to_f32(x) for x in chunk), tcam,
                                   tcfg)
    for name, feats, share in (("all_pts", src[0], 1.0),
                               ("all_lns", src[1], 0.9998)):
        r, g = getattr(ref, name), getattr(got, name)
        w = np.asarray(r.desc)
        assert w.dtype == np.uint32 and g.desc.dtype == torch.int32
        assert tuple(g.desc.shape) == w.shape and w.shape[-1] == 8
        assert torch.equal(g.desc, hamming.pack_bits(feats.desc))
        assert torch.equal(hamming.unpack_bits(g.desc), feats.desc)
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(r.valid))
        bits_ref = np.unpackbits(w.view(np.uint8))
        bits_got = np.unpackbits(g.desc.numpy().view(np.uint8))
        equal = float(np.mean(bits_ref == bits_got))
        print(f"{name}: {equal:.6f} of the packed bits equal the "
              "reference's")
        assert equal >= share, (name, equal)


def _feats(cfg, n):
    """An empty frame's point features of the map's capacity."""
    from plslam_tpu_torch.frontend.features import PointObservations
    K = cfg.points.max_kpts
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    return PointObservations(z(K, 2), z(K, 2), z(K), z(K, 3),
                             z(K, 256, dt=torch.uint8),
                             z(K, dt=torch.int32), z(K), z(K),
                             z(K, dt=torch.bool))


def test_map_handler_capacity_fails_loudly():
    """The twin of tests/test_kf_capacity.py's: a full KF array raises."""
    cfg, cam = _port(BACKEND_CFG.with_updates(
        {"mapping": {"max_kfs": 4}, "system": {"async_mapping": False}}),
        CAM)
    mh = MapHandler(cfg, cam, device="cpu")
    mh._next_slot = 4
    with pytest.raises(RuntimeError, match="KF capacity"):
        mh.add_keyframe(_feats(cfg, 0), None, np.eye(4, dtype=np.float32))


def test_map_handler_worker_error_is_raised():
    """A job that raises on the worker thread: wait_idle raises it again,
    as do wait_dispatched and close; the worker keeps taking jobs."""
    cfg, cam = _port(BACKEND_CFG.with_updates(
        {"system": {"async_mapping": True}}), CAM)
    mh = MapHandler(cfg, cam, device="cpu")

    def boom(_):
        raise ValueError("kernel failed to launch")
    mh.add_keyframe(_feats(cfg, 0), None, np.eye(4, dtype=np.float32),
                    run_lba=False, on_done=boom)
    with pytest.raises(RuntimeError, match="mapping worker") as e:
        mh.wait_idle()
    assert isinstance(e.value.__cause__, ValueError)
    assert int(mh.state.n_kfs) == 1
    with pytest.raises(RuntimeError, match="mapping worker"):
        mh.wait_dispatched()
    with pytest.raises(RuntimeError, match="mapping worker"):
        mh.close()
    assert mh._worker is None


def test_distributed_mapping_builds_sharded_lba():
    """mapping.distributed builds the sharded LBA over
    mapping.dist_devices shards on the map's device type (one a visible
    device by default)."""
    cfg, cam = _port(BACKEND_CFG.with_updates(
        {"mapping": {"distributed": True, "dist_devices": 4}}), CAM)
    mh = MapHandler(cfg, cam, device="cpu")
    assert mh._dist.n == 4 and mh._dist.mesh.devices == [
        torch.device("cpu")] * 4
    one = MapHandler(cfg.with_updates({"mapping": {"dist_devices": 0}}), cam,
                     device="cpu")
    assert one._dist.n == 1


def test_distributed_mapping_is_refused_by_name():
    """Without a card, mapping.distributed's default device, cuda, is
    refused with the device='cpu' hint, and so is a cuda mesh: never
    moved to the CPU."""
    from plslam_tpu_torch.parallel.mesh import make_mesh
    cfg, cam = _port(BACKEND_CFG.with_updates(
        {"mapping": {"distributed": True, "dist_devices": 4}}), CAM)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MapHandler(cfg, cam)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(4, ("lm",), "cuda")


def test_run_concurrent_sessions_equal_alone():
    """Two ChunkedPLSLAM sessions (async mapping, two worker threads)
    interleaved by run_concurrent: each trajectory equals the same session
    run alone, bit for bit, and holds the reference test's ATE bound
    (tests/test_chunked_slam.py::test_concurrent_multi_sequence_sessions)."""
    from plslam_tpu_torch.apps.plslam_multiseq import run_concurrent
    cfg = SlamConfig().with_updates({
        "camera": {"width": 512, "height": 320, "fx": 400.0, "fy": 400.0,
                   "cx": 256.0, "cy": 160.0, "baseline": 0.3},
        "points": {"max_kpts": 384, "orb_nlevels": 2},
        "lines": {"has_lines": False},
        "matching": {"f2f_window": 128.0},
        "mapping": {"max_kfs": 32, "max_points": 4096, "max_lines": 256,
                    "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 5},
        "loop": {"enabled": False},
    })
    cam = StereoCamera.from_config(cfg.camera)
    tcfg, tcam = _port(cfg, cam)
    assert tcfg.system.async_mapping
    seqs = [synthetic.make_sequence(cam, n_frames=17, seed=30 + s,
                                    kind="forward", n_points=400,
                                    n_lines=0, noise=0.004, step=0.2)
            for s in range(2)]
    make = lambda: tss.ChunkedPLSLAM(tcfg, tcam, enable_loops=False,
                                     device="cpu")
    both = run_concurrent([make(), make()], seqs, chunk=8)
    for traj, seq in zip(both, seqs):
        alone = run_concurrent([make()], [seq], chunk=8)[0]
        assert len(traj) == 17
        assert np.array_equal(traj, alone)
        assert float(ate_rmse(traj, seq.poses[:len(traj)])) < 0.08


def test_multiseq_main(tmp_path, capsys):
    """The multi-sequence app: system.fused_slam=false selects
    ChunkedPLSLAM for every session; --distributed runs per-frame PLSLAM
    sessions on the sharded LBA (two CPU shards) to the end."""
    from plslam_tpu_torch.apps import plslam_multiseq
    conf = tmp_path / "small.yaml"
    conf.write_text(
        "camera: {width: 320, height: 240, fx: 260.0, fy: 260.0, cx: 160.0,"
        " cy: 120.0}\npoints: {max_kpts: 128, orb_nlevels: 2}\n"
        "lines: {has_lines: false}\nmapping: {max_kfs: 16, max_points: 512}"
        "\nsystem: {fused_slam: false}\n")
    assert plslam_multiseq.main(["--synthetic", "--frames", "9", "--chunk",
                                 "4", "--no-loops", "--device", "cpu",
                                 "--config", str(conf)]) == 0
    out = capsys.readouterr().out
    assert "seq 1: 9 frames" in out and "across 2 sessions" in out
    conf.write_text(conf.read_text().replace(
        "mapping: {", "mapping: {dist_devices: 2, "))
    assert plslam_multiseq.main(["--synthetic", "--distributed", "--frames",
                                 "5", "--no-loops", "--device", "cpu",
                                 "--config", str(conf)]) == 0
    out = capsys.readouterr().out
    assert "seq 1: 5 frames" in out and "across 2 sessions" in out
