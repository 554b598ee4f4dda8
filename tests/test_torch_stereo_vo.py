"""Port parity: the per-frame stereo VO driver (``StereoVO``).

The reference's ``StereoVO`` and the port's (``device="cpu"``) track the
same 320x240 synthetic scene of 5 frames, once with points and lines
(``make_extractor``) and once points only (the default extractor). Per
frame, ``good``, ``is_kf`` and ``n_inliers`` must be identical; poses
within 2e-5 (m and rotation entries) and the entropy ratio within 1e-4
(measured: poses 7.8e-6 with lines and 2.5e-6 points only, entropy ratios
1.3e-6; slice 2 measured 5.1e-6 on the chunked poses; the smallest margin
of a ratio to the 0.85 threshold is 0.040). ``KeyframeCriterion`` is copied
numpy: on a recorded (DT, cov, good, T_from_kf) sequence with a failed
frame and both caps it must give exactly the same flags and ratios.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend import stereo_frame as jsf
from plslam_tpu.io import synthetic
from plslam_tpu.tracking import frame_handler as jfh
from plslam_tpu_torch import convert
from plslam_tpu_torch.frontend import stereo_frame as tsf
from plslam_tpu_torch.tracking import frame_handler as tfh

POSE_TOL = 2e-5
RATIO_TOL = 1e-4

CFG = SlamConfig().with_updates({
    "camera": {"width": 320, "height": 240, "fx": 250.0, "fy": 250.0,
               "cx": 160.0, "cy": 120.0, "baseline": 0.3},
    "points": {"max_kpts": 256, "orb_nlevels": 2},
    "lines": {"has_lines": True, "max_lines": 64},
})
CAM = StereoCamera.from_config(CFG.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread: the port's per-frame path is thousands of small
    ops, which oversubscribed OpenMP threads slow down many times over when
    the suite runs several workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(CAM, n_frames=5, seed=3, n_points=220,
                                   n_lines=40, noise=0.003, step=0.12)


def _run(vo, seq):
    vo.initialize(seq.images_l[0], seq.images_r[0])
    return [vo.insert_stereo_pair(seq.images_l[i], seq.images_r[i])
            for i in range(1, len(seq.poses))]


def _compare(ref, got):
    for i, (a, b) in enumerate(zip(ref, got)):
        assert (a.good, a.is_kf, a.n_inliers) == (b.good, b.is_kf,
                                                  b.n_inliers), i
    d_pose = max(np.abs(np.asarray(a.T_wc) - b.T_wc).max()
                 for a, b in zip(ref, got))
    d_ratio = max(abs(a.entropy_ratio - b.entropy_ratio)
                  for a, b in zip(ref, got))
    margin = min(abs(a.entropy_ratio - CFG.keyframe.min_entropy_ratio)
                 for a in ref)
    print(f"poses within {d_pose:.3g}, entropy ratios within "
          f"{d_ratio:.3g}; smallest |ratio - threshold| {margin:.3g}")
    assert d_pose <= POSE_TOL and d_ratio <= RATIO_TOL


@pytest.mark.parametrize("lines", [True, False], ids=["lines", "points"])
def test_stereo_vo_matches_reference(seq, lines):
    if lines:
        jx = jsf.make_extractor(CAM, CFG)
        tx = tsf.make_extractor(TCAM, TCFG, device="cpu")
    else:
        jx = tx = None
    ref = _run(jfh.StereoVO(CFG, CAM, extract_fn=jx), seq)
    vo = tfh.StereoVO(TCFG, TCAM, extract_fn=tx, device="cpu")
    got = _run(vo, seq)
    assert all(f.good for f in ref)
    _compare(ref, got)
    np.testing.assert_allclose(np.stack(vo.trajectory)[1:],
                               np.stack([f.T_wc for f in got]))
    pts, lns = vo.current_features
    assert pts.uv.shape == (TCFG.points.max_kpts, 2)
    assert (lns is not None) == lines
    if lines:
        assert lns.valid.shape == (TCFG.lines.max_lines,)


def test_track_step_of_one_pair(seq):
    """``track_step`` alone on the reference's own features: match counts
    and indices exact, pose within the tolerance."""
    x = jsf.make_extractor(CAM, CFG)
    p0, l0 = x(jnp.asarray(seq.images_l[0]), jnp.asarray(seq.images_r[0]))
    p1, l1 = x(jnp.asarray(seq.images_l[1]), jnp.asarray(seq.images_r[1]))
    T = np.eye(4, dtype=np.float32)
    ref = jfh.track_step(p0, l0, p1, l1, jnp.asarray(T), CAM, CFG)
    conv_p = lambda p: convert.points_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields}, "cpu")
    conv_l = lambda l: convert.lines_from_numpy(
        {f: np.asarray(getattr(l, f)) for f in l._fields}, "cpu")
    got = tfh.track_step(conv_p(p0), conv_l(l0), conv_p(p1), conv_l(l1),
                         torch.from_numpy(T), TCAM, TCFG)
    np.testing.assert_array_equal(got.match_idx_pt.numpy(),
                                  np.asarray(ref.match_idx_pt))
    np.testing.assert_array_equal(got.match_idx_ln.numpy(),
                                  np.asarray(ref.match_idx_ln))
    assert int(got.n_matches_pt) == int(ref.n_matches_pt) > 50
    assert int(got.n_matches_ln) == int(ref.n_matches_ln) > 3
    assert bool(got.pose.good) and bool(ref.pose.good)
    assert int(got.pose.n_inliers) == int(ref.pose.n_inliers)
    np.testing.assert_allclose(got.pose.T.numpy(), np.asarray(ref.pose.T),
                               atol=POSE_TOL)


def test_keyframe_criterion_is_exact():
    """A recorded sequence with a failed frame (cov 1e3 I), small and large
    motions and the translation / rotation caps."""
    rng = np.random.default_rng(5)
    ref, got = jfh.KeyframeCriterion(CFG), tfh.KeyframeCriterion(TCFG)
    T_kf = np.eye(4)
    T_wc = np.eye(4)
    flags = []
    for i in range(40):
        w = rng.normal(0, 0.02 if i % 9 else 0.4, 3)
        DT = np.eye(4, dtype=np.float32)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        DT[:3, :3] = (np.eye(3) + np.sin(th) / th * K
                      + (1 - np.cos(th)) / th ** 2 * K @ K)
        DT[:3, 3] = rng.normal(0, 0.1 if i % 13 else 3.0, 3)
        A = rng.normal(0, 1e-3, (6, 6))
        good = i % 11 != 7
        cov = (A @ A.T + 1e-6 * np.eye(6) if good
               else np.eye(6) * 1e3).astype(np.float32)
        T_wc = (T_wc @ np.linalg.inv(DT)).astype(np.float32)
        T_from_kf = np.linalg.inv(T_kf) @ T_wc
        a = ref.update(DT, cov, good, T_from_kf)
        b = got.update(DT, cov, good, T_from_kf)
        assert a == b, (i, a, b)
        if a[0]:
            T_kf = T_wc.copy()
        flags.append(a[0])
    assert 3 <= sum(flags) < 40
