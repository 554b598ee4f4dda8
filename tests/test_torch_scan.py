"""Port parity: scan mode of ``vo_chunk`` (``tracking.batched_chunks=False``).

The reference's ``lax.scan`` over a chunk's frames against the port's
frame-by-frame recurrence on the CPU, B = 3, ``keep_feats``, from the same
carry (the port's frame-0 features, handed to both), in two
configurations: point+line on tests/test_torch_slice_lines.py's scene
(640x384, seed 3, 220 points, 40 lines, ``max_lines=64``) and lines-only
on tests/test_lines_frontend.py's (``CFG_L``, seed 0, 60 lines).

- The recurrence alone (``_chunk_tracking_scan``) on the reference's own
  features of frames 1-3 (its ``keep_feats`` stacks): ``good`` and the
  inlier counts exact; ``DT`` and ``DT_next`` within 1e-5 (measured
  2.4e-7 to 2.0e-6).
- The whole ``vo_chunk``, each package extracting its own features:
  the packed ORB words bit-equal (an empty stack lines-only), ``good``
  identical, inliers within 2% or 1, poses within 5 mm, the reference's
  own bound between per-frame and chunked tracking
  (tests/test_batch_vo.py:117). Slice 2's line endpoints differ by up to
  2.2e-3 px, which moves a line term across the gate now and then, and
  in scan mode a frame's pose is the next one's prior: measured with
  points and lines one line inlier more in frame 1 (149 against 148) and
  poses within 2.6e-4; lines-only one fewer in frames 2 and 3 (18 of 19,
  21 of 22) and frame 3's translation 2.1e-3 m off, its rotation 1.5e-4.
- Scan mode runs one full GN a frame (no lite pass), each from the prior
  that the frame before it left: ``where(good, T, prior)``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend import features as jfeat
from plslam_tpu.io import synthetic
from plslam_tpu.tracking import batch_vo as jvo
from plslam_tpu_torch import convert
from plslam_tpu_torch.ops import hamming as thamming
from plslam_tpu_torch.tracking import batch_vo as tvo
from plslam_tpu_torch.tracking import pose_gn as tpg

POSE_TOL = 1e-5    # the recurrence on identical features
CHUNK_TOL = 5e-3   # the whole chunk, each package's own features

_CAMERA = {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
           "cx": 320.0, "cy": 192.0, "baseline": 0.3}
# (configuration, scene: seed, points, lines)
CASES = {
    "point_line": ({"camera": _CAMERA,
                    "points": {"max_kpts": 512, "orb_nlevels": 2},
                    "lines": {"has_lines": True, "max_lines": 64},
                    "tracking": {"batched_chunks": False}}, (3, 220, 40)),
    "lines_only": ({"camera": _CAMERA,
                    "points": {"max_kpts": 256, "orb_nlevels": 2,
                               "has_points": False},
                    "lines": {"has_lines": True},
                    "tracking": {"batched_chunks": False}}, (0, 0, 60)),
}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_ref(feats, cls):
    return cls(**{f: jnp.asarray(getattr(feats, f).numpy())
                  for f in feats._fields})


@pytest.fixture(scope="module", params=sorted(CASES))
def scan_runs(request):
    """(the port's configuration and camera, the reference's and the
    port's scan-mode ``vo_chunk`` of frames 1-3 from the port's frame-0
    features, those features)."""
    upd, (seed, n_pts, n_lns) = CASES[request.param]
    cfg = SlamConfig().with_updates(upd)
    cam = StereoCamera.from_config(cfg.camera)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tcam = convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.b,
                                     cam.width, cam.height)
    seq = synthetic.make_sequence(cam, n_frames=4, seed=seed,
                                  n_points=n_pts, n_lines=n_lns,
                                  noise=0.003, step=0.12)
    p0, l0 = tvo.extract_one(torch.from_numpy(seq.images_l[0]),
                             torch.from_numpy(seq.images_r[0]), tcam, tcfg)
    T0 = np.eye(4, dtype=np.float32)
    il, ir = seq.images_l[1:4], seq.images_r[1:4]
    ref = jvo.vo_chunk(jnp.asarray(il), jnp.asarray(ir),
                       _to_ref(p0, jfeat.PointObservations),
                       _to_ref(l0, jfeat.LineObservations), jnp.asarray(T0),
                       cam, cfg, keep_feats=True)
    got = tvo.vo_chunk(torch.from_numpy(il), torch.from_numpy(ir), p0, l0,
                       torch.from_numpy(T0), tcam, tcfg, keep_feats=True)
    return tcfg, tcam, ref, got, (p0, l0)


def _port_stack(stack, cls):
    """The reference's ``keep_feats`` stack as the port's features, the
    descriptor words unpacked to bits."""
    arrays = {f: np.asarray(getattr(stack, f)) for f in stack._fields}
    arrays["desc"] = thamming.unpack_bits(torch.from_numpy(
        arrays["desc"].astype(np.int64))).numpy()
    return (convert.points_from_numpy(arrays, "cpu")
            if cls == "points" else convert.lines_from_numpy(arrays, "cpu"))


def test_scan_recurrence_matches_reference(scan_runs):
    """The port's recurrence on the reference's extracted features: the
    decisions exact, the poses within 1e-5."""
    tcfg, tcam, ref, _, (p0, l0) = scan_runs
    out = tvo._chunk_tracking_scan(
        _port_stack(ref.all_pts, "points"), _port_stack(ref.all_lns, "lines"),
        p0, l0, torch.eye(4), tcam, tcfg)
    good = np.asarray(ref.good)
    assert good.all()
    np.testing.assert_array_equal(out.good.numpy(), good)
    np.testing.assert_array_equal(out.n_inliers.numpy(),
                                  np.asarray(ref.n_inliers))
    d = np.abs(out.DT.numpy() - np.asarray(ref.DT)).max()
    d_next = np.abs(out.DT_next.numpy() - np.asarray(ref.DT_next)).max()
    print(f"scan recurrence poses within {d:.3g}, DT_next {d_next:.3g}")
    assert d < POSE_TOL and d_next < POSE_TOL
    # the chunk's prior out is the last good frame's pose
    assert torch.equal(out.DT_next, out.DT[-1])
    assert (out.n_line_inliers > 0).all()
    if not tcfg.points.has_points:
        assert (out.n_line_inliers == out.n_inliers).all()


def test_scan_vo_chunk_matches_reference(scan_runs):
    """The whole chunk, each package extracting its own features."""
    _, _, ref, got, _ = scan_runs
    good = np.asarray(ref.good)
    np.testing.assert_array_equal(got.good.numpy(), good)
    n_ref = np.asarray(ref.n_inliers)
    assert np.all(np.abs(got.n_inliers.numpy() - n_ref)
                  <= np.maximum(0.02 * n_ref, 1))
    d = np.abs(got.DT.numpy() - np.asarray(ref.DT)).max()
    d_next = np.abs(got.DT_next.numpy() - np.asarray(ref.DT_next)).max()
    print(f"scan vo_chunk poses within {d:.3g}, DT_next {d_next:.3g}")
    assert d < CHUNK_TOL and d_next < CHUNK_TOL


def test_scan_packed_feature_stacks_match_reference(scan_runs):
    """``keep_feats`` in scan mode: the ORB words bit-equal (the same
    extraction as batched mode), the stacks' shapes the reference's."""
    _, _, ref, got, _ = scan_runs
    np.testing.assert_array_equal(
        got.all_pts.desc.numpy(),
        np.asarray(ref.all_pts.desc).astype(np.int64).astype(np.int32))
    for f in ref.all_lns._fields:
        assert getattr(got.all_lns, f).shape == np.asarray(
            getattr(ref.all_lns, f)).shape, f
    for f in ("uv", "valid"):
        np.testing.assert_array_equal(getattr(got.all_pts, f).numpy(),
                                      np.asarray(getattr(ref.all_pts, f)))


def test_scan_launches_one_solve_a_frame(monkeypatch):
    """Scan mode solves frame after frame, one ``optimize_pose`` at B = 1
    each (no lite pass), each from the prior the frame before left:
    ``where(good, T, prior)``."""
    upd, (seed, n_pts, n_lns) = CASES["lines_only"]
    cfg = SlamConfig().with_updates(upd)
    cam = StereoCamera.from_config(cfg.camera)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tcam = convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.b,
                                     cam.width, cam.height)
    calls = []
    real = tpg.optimize_pose

    def spy(T0, cam, pts, lns, c):
        calls.append((T0.clone(), c))
        res = real(T0, cam, pts, lns, c)
        # a failed second frame: the third starts from the second's prior
        return res._replace(good=res.good & (len(calls) != 2))
    monkeypatch.setattr(tpg, "optimize_pose", spy)
    seq = synthetic.make_sequence(cam, n_frames=4, seed=seed,
                                  n_points=n_pts, n_lines=n_lns,
                                  noise=0.003, step=0.12)
    p0, l0 = tvo.extract_one(torch.from_numpy(seq.images_l[0]),
                             torch.from_numpy(seq.images_r[0]), tcam, tcfg)
    out = tvo.vo_chunk(torch.from_numpy(seq.images_l[1:4]),
                       torch.from_numpy(seq.images_r[1:4]), p0, l0,
                       torch.eye(4), tcam, tcfg)
    assert len(calls) == 3
    assert all(T.shape == (1, 4, 4) and c is tcfg for T, c in calls)
    assert torch.equal(calls[0][0][0], torch.eye(4))
    assert torch.equal(calls[1][0][0], out.DT[0])
    assert torch.equal(calls[2][0][0], calls[1][0][0])
    assert out.good.tolist() == [True, False, True]
    assert torch.equal(out.DT_next, out.DT[2])
