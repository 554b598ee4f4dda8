"""Port parity, the whole slice: points-only chunked VO.

The reference's ``extract_one`` + ``vo_chunk`` (4 frames, batched mode,
lite first pass) against the port's on the CPU, on the same synthetic
frames (tests/test_batch_vo.py's configuration and scene). The
reference's ``prev_pts`` carry crosses into the port through
``convert.points_from_numpy``, so both track from identical features.

Measured agreement on this scene: 100% of the valid keypoints with
identical uv and descriptor, identical per-frame ``good`` and inlier
counts, pose entries within 1.3e-6. Required: >= 99%, identical ``good``,
inliers within 1%, pose within 1e-3 m and 1e-3 rad.
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
    "lines": {"has_lines": False},
})
CAM = StereoCamera.from_config(CFG.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(CAM, n_frames=5, seed=7, n_points=260,
                                   n_lines=0, noise=0.003, step=0.12)


def _np_points(p):
    return {f: np.asarray(getattr(p, f)) for f in p._fields}


def _same_fraction(ref, got):
    """Share of the reference's valid keypoints whose uv, descriptor and
    validity the port reproduces at the same index."""
    v = ref["valid"]
    same = (np.all(ref["uv"] == got["uv"], -1)
            & np.all(ref["desc"] == got["desc"], -1)
            & (ref["valid"] == got["valid"]))
    return same[v].mean(), int(v.sum())


def test_extract_one_matches_reference(seq):
    rp, _ = jvo.extract_one(jnp.asarray(seq.images_l[0]),
                            jnp.asarray(seq.images_r[0]), CAM, CFG)
    tp, tl = tvo.extract_one(torch.from_numpy(seq.images_l[0]),
                             torch.from_numpy(seq.images_r[0]), TCAM, TCFG)
    assert tl is None
    ref = _np_points(rp)
    got = {f: getattr(tp, f).numpy() for f in tp._fields}
    frac, n = _same_fraction(ref, got)
    assert n > 150 and frac >= 0.99, (frac, n)
    np.testing.assert_allclose(got["P"][ref["valid"]], ref["P"][ref["valid"]],
                               rtol=1e-5, atol=1e-5)


def test_vo_chunk_matches_reference(seq):
    il, ir = seq.images_l, seq.images_r
    rp, _ = jvo.extract_one(jnp.asarray(il[0]), jnp.asarray(ir[0]), CAM, CFG)
    T0 = np.eye(4, dtype=np.float32)
    ref = jvo.vo_chunk(jnp.asarray(il[1:5]), jnp.asarray(ir[1:5]), rp, None,
                       jnp.asarray(T0), CAM, CFG)
    got = tvo.vo_chunk(torch.from_numpy(il[1:5]), torch.from_numpy(ir[1:5]),
                       convert.points_from_numpy(_np_points(rp), "cpu"), None,
                       torch.from_numpy(T0), TCAM, TCFG)
    good = np.asarray(ref.good)
    assert good.all()
    np.testing.assert_array_equal(got.good.numpy(), good)
    n_ref = np.asarray(ref.n_inliers)
    assert np.all(np.abs(got.n_inliers.numpy() - n_ref) <= 0.01 * n_ref)
    DT_ref = np.asarray(ref.DT)
    DT = got.DT.numpy()
    assert np.abs(DT[:, :3, 3] - DT_ref[:, :3, 3]).max() < 1e-3
    R_err = np.einsum("bji,bjk->bik", DT_ref[:, :3, :3], DT[:, :3, :3])
    ang = np.arccos(np.clip((np.trace(R_err, axis1=1, axis2=2) - 1) / 2,
                            -1, 1))
    assert ang.max() < 1e-3
    np.testing.assert_allclose(got.DT_next.numpy(), np.asarray(ref.DT_next),
                               atol=1e-3)
    frac, _ = _same_fraction(
        _np_points(ref.last_pts),
        {f: getattr(got.last_pts, f).numpy() for f in got.last_pts._fields})
    assert frac >= 0.99, frac
