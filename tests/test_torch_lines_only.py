"""Port parity: the lines-only configuration (``points.has_points=False``).

tests/test_lines_frontend.py's configuration and scene (``CFG_L``: 640x384,
no points, 60 lines, seed 0, 3 frames) through the reference and the port
on the CPU:

- the zero-capacity point set: the reference's fields, shapes and dtypes;
- the chunk of frames 1-2 (``vo_chunk``, batched, B = 2, ``keep_feats``)
  from the same carry (the port's frame-0 features, handed to both): the
  line observations by slice 2's rules (>= 95% of the reference's valid
  segments in the same slot within 0.05 px, >= 99% of their LBD bits
  identical), ``good`` identical, inliers within 2% or 1, poses within
  1e-4 (measured 3.5e-5 m, the segments differing by the line detector's
  sub-pixel rounding of slice 2);
- the batched tracking alone on the reference's extracted features
  (``_chunk_tracking_batched``, zero point terms): the decisions exact,
  poses within 1e-5 (measured 2.1e-6);
- ``track_step`` on identical features (the port's frames 0 and 1): the
  line matches and inliers exact, the pose within 1e-5 (measured 4.3e-7);
- the per-frame ``StereoVO`` with ``make_extractor`` (the app's per-frame
  ``--no-points`` path) and the VO app's ``--no-points`` chunked run end
  to end on the port;
- the SLAM drivers refuse the configuration by name (the reference's
  ``FusedPLSLAM`` fails on it: its add_keyframe cannot match a
  zero-capacity point set).
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
from plslam_tpu.tracking import frame_handler as jfh
from plslam_tpu_torch import convert
from plslam_tpu_torch.frontend import stereo_frame as tsf
from plslam_tpu_torch.ops import hamming as thamming
from plslam_tpu_torch.tracking import batch_vo as tvo
from plslam_tpu_torch.tracking import frame_handler as tfh

POSE_TOL = 1e-5    # tracking on identical features
CHUNK_TOL = 1e-4   # the whole chunk, each package's own features

CFG_L = SlamConfig().with_updates({
    "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
               "cx": 320.0, "cy": 192.0, "baseline": 0.3},
    "points": {"max_kpts": 256, "orb_nlevels": 2, "has_points": False},
    "lines": {"has_lines": True}})
CAM = StereoCamera.from_config(CFG_L.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG_L))
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(CAM, n_frames=3, seed=0, n_points=0,
                                   n_lines=60, noise=0.003, step=0.12)


@pytest.fixture(scope="module")
def port_feats(seq):
    """The port's features of frames 0 and 1 (``extract_one``)."""
    return [tvo.extract_one(torch.from_numpy(seq.images_l[i]),
                            torch.from_numpy(seq.images_r[i]), TCAM, TCFG)
            for i in (0, 1)]


def _np(feats):
    return {f: np.array(getattr(feats, f)) for f in feats._fields}


def _to_ref(feats, cls):
    """The port's features as the reference's type (jnp arrays)."""
    return cls(**{f: jnp.asarray(getattr(feats, f).numpy())
                  for f in feats._fields})


@pytest.fixture(scope="module")
def chunks(seq, port_feats):
    """The reference's and the port's ``vo_chunk`` of frames 1-2 (B = 2,
    batched, ``keep_feats``) from the port's frame-0 features."""
    (p0, l0), _ = port_feats
    T0 = np.eye(4, dtype=np.float32)
    il, ir = seq.images_l[1:3], seq.images_r[1:3]
    ref = jvo.vo_chunk(jnp.asarray(il), jnp.asarray(ir),
                       _to_ref(p0, jfeat.PointObservations),
                       _to_ref(l0, jfeat.LineObservations), jnp.asarray(T0),
                       CAM, CFG_L, keep_feats=True)
    got = tvo.vo_chunk(torch.from_numpy(il), torch.from_numpy(ir), p0, l0,
                       torch.from_numpy(T0), TCAM, TCFG, keep_feats=True)
    return ref, got


def _line_agreement(ref, got):
    """(share of the reference's valid lines the port reproduces in the
    same slot within 0.05 px, share of their descriptor bits identical,
    number of valid reference lines)."""
    v = ref["valid"]
    close = ((np.abs(ref["sp"] - got["sp"]).max(-1) < 0.05)
             & (np.abs(ref["ep"] - got["ep"]).max(-1) < 0.05) & got["valid"])
    same = v & close
    bits = (ref["desc"] == got["desc"])[same].mean() if same.any() else 0.0
    return same.sum() / max(v.sum(), 1), bits, int(v.sum())


def _pose_diff(DT_ref, DT):
    """(largest translation difference, largest rotation angle between)."""
    R_err = np.einsum("...ji,...jk->...ik", DT_ref[..., :3, :3],
                      DT[..., :3, :3])
    ang = np.arccos(np.clip((np.trace(R_err, axis1=-2, axis2=-1) - 1) / 2,
                            -1, 1))
    return (float(np.abs(DT[..., :3, 3] - DT_ref[..., :3, 3]).max()),
            float(np.max(ang)))


def test_zero_capacity_point_set(seq, chunks, port_feats):
    """extract_one's points and the chunk's point stacks: capacity 0 with
    the reference's fields, shapes and dtypes (a leading B axis on the
    chunk's; its packed words int32 where the reference's are uint32, the
    same bits, as ``keep_feats`` carries them); the lines fill in."""
    (p0, l0), _ = port_feats
    ref, got = chunks
    for r, t in ((ref.last_pts, p0), (ref.all_pts, got.all_pts)):
        assert t._fields == r._fields
        for f in r._fields:
            a = np.asarray(getattr(r, f))
            b = getattr(t, f).numpy()
            if t is got.all_pts and f == "desc":
                a = a.astype(np.int32)
            assert b.shape == a.shape and b.dtype == a.dtype, (f, b.shape,
                                                               a.shape)
    assert got.all_pts.uv.shape == (2, 0, 2)
    assert got.all_pts.desc.shape == (2, 0, 8)
    assert int(l0.valid.sum()) >= 12


def _port_stack(stack, cls):
    """The reference's ``keep_feats`` stack as the port's features, the
    descriptor words unpacked to bits."""
    arrays = _np(stack)
    arrays["desc"] = thamming.unpack_bits(torch.from_numpy(
        arrays["desc"].astype(np.int64))).numpy()
    return (convert.points_from_numpy(arrays, "cpu")
            if cls == "points" else convert.lines_from_numpy(arrays, "cpu"))


def test_chunk_tracking_matches_reference(chunks, port_feats):
    """The batched tracking alone on the reference's extracted features
    (no point match, zero point terms): the decisions exact, the poses
    within 1e-5."""
    ref, _ = chunks
    (p0, l0), _ = port_feats
    out = tvo._chunk_tracking_batched(
        _port_stack(ref.all_pts, "points"), _port_stack(ref.all_lns, "lines"),
        p0, l0, torch.eye(4), TCAM, TCFG)
    np.testing.assert_array_equal(out.good.numpy(), np.asarray(ref.good))
    np.testing.assert_array_equal(out.n_inliers.numpy(),
                                  np.asarray(ref.n_inliers))
    assert (out.n_line_inliers == out.n_inliers).all()
    d = max(np.abs(out.DT.numpy() - np.asarray(ref.DT)).max(),
            np.abs(out.DT_next.numpy() - np.asarray(ref.DT_next)).max())
    print(f"tracking on the reference's features: poses within {d:.3g}")
    assert d < POSE_TOL


def test_chunk_lines_and_poses_match_reference(chunks):
    ref, got = chunks
    r_lns = _np(ref.all_lns)
    r_lns["desc"] = np.asarray(thamming.unpack_bits(
        torch.from_numpy(r_lns["desc"].astype(np.int64).astype(np.int32))))
    g_lns = {f: getattr(got.all_lns, f).numpy()
             for f in got.all_lns._fields}
    g_lns["desc"] = thamming.unpack_bits(got.all_lns.desc).numpy()
    for b in range(2):
        frac, bits, n = _line_agreement({k: v[b] for k, v in r_lns.items()},
                                        {k: v[b] for k, v in g_lns.items()})
        assert n >= 12 and frac >= 0.95 and bits >= 0.99, (b, frac, bits, n)
    good = np.asarray(ref.good)
    assert good.all()
    np.testing.assert_array_equal(got.good.numpy(), good)
    n_ref = np.asarray(ref.n_inliers)
    assert np.all(np.abs(got.n_inliers.numpy() - n_ref)
                  <= np.maximum(0.02 * n_ref, 1))
    assert (got.n_line_inliers == got.n_inliers).all()
    d_t, d_r = _pose_diff(np.asarray(ref.DT), got.DT.numpy())
    print(f"chunk poses within {d_t:.3g} m, {d_r:.3g} rad")
    assert d_t < CHUNK_TOL and d_r < CHUNK_TOL
    d_t, d_r = _pose_diff(np.asarray(ref.DT_next), got.DT_next.numpy())
    assert d_t < CHUNK_TOL and d_r < CHUNK_TOL


def test_track_step_matches_reference(port_feats):
    """``track_step`` of frames 0 -> 1 on identical features: no point
    terms; the line matches, inliers and ``good`` exact, the pose within
    1e-5."""
    (p0, l0), (p1, l1) = port_feats
    T0 = np.eye(4, dtype=np.float32)
    ref = jfh.track_step(_to_ref(p0, jfeat.PointObservations),
                         _to_ref(l0, jfeat.LineObservations),
                         _to_ref(p1, jfeat.PointObservations),
                         _to_ref(l1, jfeat.LineObservations),
                         jnp.asarray(T0), CAM, CFG_L)
    got = tfh.track_step(p0, l0, p1, l1, torch.from_numpy(T0), TCAM, TCFG)
    assert bool(ref.pose.good) and bool(got.pose.good)
    assert int(got.n_matches_pt) == 0 and got.match_idx_pt.shape == (0,)
    assert got.pose.inlier_pt.shape == (0,)
    np.testing.assert_array_equal(got.match_idx_ln.numpy(),
                                  np.asarray(ref.match_idx_ln))
    assert int(got.n_matches_ln) == int(ref.n_matches_ln) > 0
    assert int(got.pose.n_inliers) == int(ref.pose.n_inliers)
    np.testing.assert_array_equal(got.pose.inlier_ln.numpy(),
                                  np.asarray(ref.pose.inlier_ln))
    d = np.abs(got.pose.T.numpy() - np.asarray(ref.pose.T)).max()
    print(f"track_step pose within {d:.3g}")
    assert d < POSE_TOL


def test_stereo_vo_and_app_run_lines_only(seq):
    """The per-frame driver with the line extractor over the 3 frames (the
    app's per-frame ``--no-points`` path), and the VO app's ``--no-points``
    chunked (B = 2) on a synthetic scene: every frame tracked on lines
    alone."""
    from plslam_tpu_torch.apps import plstvo_dataset as app
    vo = tfh.StereoVO(TCFG, TCAM, extract_fn=tsf.make_extractor(
        TCAM, TCFG, device="cpu"), device="cpu")
    vo.initialize(seq.images_l[0], seq.images_r[0])
    res = [vo.insert_stereo_pair(seq.images_l[i], seq.images_r[i])
           for i in (1, 2)]
    assert all(r.good and r.n_inliers >= TCFG.tracking.min_features
               for r in res)
    assert vo.prev_pts.uv.shape == (0, 2)
    rec = {}
    assert app.main(["--synthetic", "--no-points", "--frames", "3",
                     "--device", "cpu", "--quiet", "--chunk", "2"],
                    record=rec) == 0
    assert rec["good"].all() and len(rec["est"]) == 3


@pytest.mark.parametrize("driver", ["FusedPLSLAM", "PLSLAM",
                                    "ChunkedPLSLAM"])
def test_slam_drivers_refuse_lines_only_by_name(driver):
    """The SLAM drivers refuse ``points.has_points=False`` at construction
    and name the reference's behaviour: its add_keyframe fails on a
    zero-capacity point set."""
    from plslam_tpu_torch.backend import fused_slam, slam_system
    cls = getattr(fused_slam if driver == "FusedPLSLAM" else slam_system,
                  driver)
    with pytest.raises(NotImplementedError,
                       match=r"has_points=False.*map\.py:193"):
        cls(TCFG, TCAM, device="cpu")
