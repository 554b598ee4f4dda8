"""Port parity, the whole slice: the flagship point+line chunked VO.

The reference's ``extract_one`` + ``vo_chunk`` (6 frames, batched mode,
lite first pass) against the port's on the CPU, with lines on
(tests/test_batch_vo.py's point+line configuration and scene: 640x384,
seed 3, 220 points, 40 lines, ``max_lines=64``). The reference's
``prev_pts`` and ``prev_lns`` carries cross into the port through
``convert``, so both track from identical features.

Measured on this scene: all 16 valid stereo lines of the first frame and
all 12 of the chunk's last frame reproduced, endpoints within 2.2e-3 px,
99.95% and 100% of their descriptor bits identical; identical ``good``
and inlier counts; pose entries within 5.1e-6; 5 to 7 line terms among
each frame's inliers (12 to 15 stereo lines a frame). Required: identical
``good``; >= 95% of the valid segments within 0.05 px with >= 99% of
their bits identical; inliers within 2%; pose within 1e-3 m and 1e-3 rad;
at least 3 line inliers in every frame, so a chunk that drops its line
terms fails.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io import synthetic
from plslam_tpu.tracking import batch_vo as jvo
from plslam_tpu_torch import convert
from plslam_tpu_torch.tracking import batch_vo as tvo

CFG = SlamConfig().with_updates({
    "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
               "cx": 320.0, "cy": 192.0, "baseline": 0.3},
    "points": {"max_kpts": 512, "orb_nlevels": 2},
    "lines": {"has_lines": True, "max_lines": 64},
})
CAM = StereoCamera.from_config(CFG.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(CAM, n_frames=7, seed=3, n_points=220,
                                   n_lines=40, noise=0.003, step=0.12)


@pytest.fixture(scope="module")
def ref_first(seq):
    return jvo.extract_one(jnp.asarray(seq.images_l[0]),
                           jnp.asarray(seq.images_r[0]), CAM, CFG)


def _np(feats):
    return {f: np.array(getattr(feats, f)) for f in feats._fields}


def _torch_np(feats):
    return {f: getattr(feats, f).numpy() for f in feats._fields}


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


def test_extract_one_lines_match_reference(seq, ref_first):
    _, rl = ref_first
    tp, tl = tvo.extract_one(torch.from_numpy(seq.images_l[0]),
                             torch.from_numpy(seq.images_r[0]), TCAM, TCFG)
    frac, bits, n = _line_agreement(_np(rl), _torch_np(tl))
    assert n >= 10 and frac >= 0.95 and bits >= 0.99, (frac, bits, n)
    v = np.asarray(rl.valid)
    np.testing.assert_allclose(tl.sP.numpy()[v], np.asarray(rl.sP)[v],
                               rtol=1e-3, atol=1e-3)


def test_vo_chunk_with_lines_matches_reference(seq, ref_first):
    il, ir = seq.images_l, seq.images_r
    rp, rl = ref_first
    T0 = np.eye(4, dtype=np.float32)
    ref = jvo.vo_chunk(jnp.asarray(il[1:7]), jnp.asarray(ir[1:7]), rp, rl,
                       jnp.asarray(T0), CAM, CFG)
    got = tvo.vo_chunk(torch.from_numpy(il[1:7]), torch.from_numpy(ir[1:7]),
                       convert.points_from_numpy(_np(rp), "cpu"),
                       convert.lines_from_numpy(_np(rl), "cpu"),
                       torch.from_numpy(T0), TCAM, TCFG)
    good = np.asarray(ref.good)
    assert good.all()
    np.testing.assert_array_equal(got.good.numpy(), good)
    n_ref = np.asarray(ref.n_inliers)
    assert np.all(np.abs(got.n_inliers.numpy() - n_ref) <= 0.02 * n_ref)
    # the lines reach every frame's pose: line terms among its inliers
    assert got.n_line_inliers.min() >= 3, got.n_line_inliers
    DT_ref = np.asarray(ref.DT)
    DT = got.DT.numpy()
    assert np.abs(DT[:, :3, 3] - DT_ref[:, :3, 3]).max() < 1e-3
    R_err = np.einsum("bji,bjk->bik", DT_ref[:, :3, :3], DT[:, :3, :3])
    ang = np.arccos(np.clip((np.trace(R_err, axis1=1, axis2=2) - 1) / 2,
                            -1, 1))
    assert ang.max() < 1e-3
    frac, bits, n = _line_agreement(_np(ref.last_lns),
                                    _torch_np(got.last_lns))
    assert n >= 8 and frac >= 0.95 and bits >= 0.99, (frac, bits, n)


def test_uint8_initialize_and_chunk_match_reference(seq):
    """One uint8 pair through both ``BatchedStereoVO.initialize`` (taken
    unscaled, the line detector's Sobel wrapping as the reference's uint8
    arithmetic does), then one uint8 chunk through both ``process_chunk``
    (scaled to [0, 1]): keypoints, descriptors and ``valid`` of the first
    frame identical, its lines as the float slice above, identical
    ``good``, poses within 1e-3 m and 1e-3 rad."""
    u8 = lambda a: np.clip(np.asarray(a) * 255.0 + 0.5, 0, 255).astype(
        np.uint8)
    il, ir = u8(seq.images_l), u8(seq.images_r)
    ref = jvo.BatchedStereoVO(CFG, CAM)
    port = tvo.BatchedStereoVO(TCFG, TCAM, device="cpu")
    for vo in (ref, port):
        vo.initialize(il[0], ir[0])
    rp, tp = _np(ref.prev_pts), _torch_np(port.prev_pts)
    for f in ("uv", "desc", "valid"):
        np.testing.assert_array_equal(tp[f], rp[f], err_msg=f)
    frac, bits, n = _line_agreement(_np(ref.prev_lns),
                                    _torch_np(port.prev_lns))
    assert n >= 8 and frac >= 0.95 and bits >= 0.99, (frac, bits, n)
    want = ref.process_chunk(il[1:7], ir[1:7])
    got = port.process_chunk(il[1:7], ir[1:7])
    assert np.asarray(want.good).all()
    np.testing.assert_array_equal(got.good.numpy(), np.asarray(want.good))
    d = np.abs(np.stack(port.trajectory) - np.stack(ref.trajectory))
    assert d[:, :3, 3].max() < 1e-3 and d[:, :3, :3].max() < 1e-3
