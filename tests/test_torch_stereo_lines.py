"""Port parity, the line front end (frontend/stereo_lines.py) and the
frame-to-frame line matching (tracking/frame_handler.py).

Scene: tests/test_batch_vo.py's point+line scene (640x384, seed 3, 220
points, 40 lines), ``lines.max_lines=64``. ``detect_and_describe_lines``
runs end to end in each of its three branches (scale-space, the default;
``use_fld_lines``; ``lbd_half_res`` off) on the reference (jitted, as the
VO runs it) and on the port. The matchers and ``_fuse_levels`` are fed
the reference's own segments and descriptors, so their integer outputs
must be exactly equal.

Measured on this scene: every valid reference segment reproduced in the
same slot in all three branches (64, 64 / 61, 56 / 64, 64 per image),
endpoints within 5.3e-3 px, >= 99.98% of descriptor bits identical (the
bits follow the endpoints' last ulps). Required: >= 95% of segments
within 0.05 px, >= 99% of bits; matcher outputs exact; line equations
within 2e-6 relative, disparities within 2e-4 px (measured 6.1e-5: the
jitted reference contracts the row intersection into an FMA) and 3D
endpoints within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend import features as jfeat
from plslam_tpu.frontend import stereo_lines as jsl
from plslam_tpu.io import synthetic
from plslam_tpu.ops import lines as jlines
from plslam_tpu.tracking import frame_handler as jfh
from plslam_tpu_torch import convert
from plslam_tpu_torch.frontend import stereo_lines as tsl
from plslam_tpu_torch.ops import lines as tlines
from plslam_tpu_torch.tracking import frame_handler as tfh

CFG = SlamConfig().with_updates({
    "camera": {"width": 640, "height": 384, "fx": 450.0, "fy": 450.0,
               "cx": 320.0, "cy": 192.0, "baseline": 0.3},
    "points": {"max_kpts": 512, "orb_nlevels": 2},
    "lines": {"has_lines": True, "max_lines": 64},
})
CAM = StereoCamera.from_config(CFG.camera)
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)
_ref_detect = jax.jit(jsl.detect_and_describe_lines, static_argnums=(1,))
_ref_match = jax.jit(jsl.match_stereo_lines, static_argnums=(5,))


def _tcfg(cfg):
    return convert.config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(CAM, n_frames=2, seed=3, n_points=220,
                                   n_lines=40, noise=0.003, step=0.12)


def _np(nt):
    return {f: np.array(getattr(nt, f)) for f in nt._fields}


def _tsegs(d):
    return tlines.Segments(**{f: torch.from_numpy(d[f])
                              for f in tlines.Segments._fields})


@pytest.fixture(scope="module")
def ref_frames(seq):
    """The reference's segments, descriptors and stereo lines of frames 0
    and 1 (default configuration)."""
    out = []
    for i in range(2):
        sl, dl = _ref_detect(jnp.asarray(seq.images_l[i]), CFG)
        sr, dr = _ref_detect(jnp.asarray(seq.images_r[i]), CFG)
        out.append((sl, dl, sr, dr, _ref_match(sl, dl, sr, dr, CAM, CFG)))
    return out


@pytest.mark.parametrize("variant", [{}, {"use_fld_lines": True},
                                     {"lbd_half_res": False}],
                         ids=["scale_space", "fld", "full_res_lbd"])
def test_detect_and_describe_matches_reference(seq, variant):
    cfg = CFG.with_updates({"lines": variant})
    imgs = np.stack([seq.images_l[0], seq.images_r[0]])
    segs, desc = tsl.detect_and_describe_lines(torch.from_numpy(imgs),
                                               _tcfg(cfg))
    n_ref = n_same = 0
    bits = []
    for k in range(2):
        rs, rd = _ref_detect(jnp.asarray(imgs[k]), cfg)
        v = np.asarray(rs.valid)
        close = (np.abs(segs.sp[k].numpy() - np.asarray(rs.sp)).max(-1)
                 < 0.05) & (np.abs(segs.ep[k].numpy() - np.asarray(rs.ep)
                                   ).max(-1) < 0.05)
        same = v & segs.valid[k].numpy() & close
        n_ref += int(v.sum())
        n_same += int(same.sum())
        bits.append((desc[k].numpy() == np.asarray(rd))[same])
    assert n_ref >= 10
    assert n_same >= 0.95 * n_ref, (n_same, n_ref)
    assert np.concatenate(bits).mean() >= 0.99


def test_fuse_levels_matches_reference():
    rng = np.random.default_rng(0)
    L = 32
    fine = {"sp": rng.uniform(0, 600, (L, 2)), "score": rng.uniform(1, 9, L),
            "valid": rng.random(L) > 0.2}
    fine["ep"] = fine["sp"] + rng.normal(0, 60, (L, 2))
    coarse = {k: v.copy() for k, v in fine.items()}
    # half of the coarse set re-finds fine segments (covered), half is new
    coarse["sp"][::2] += rng.normal(0, 0.5, (L // 2, 2))
    coarse["ep"][::2] += rng.normal(0, 0.5, (L // 2, 2))
    coarse["sp"][1::2] = rng.uniform(0, 600, (L // 2, 2))
    coarse["ep"][1::2] = coarse["sp"][1::2] + rng.normal(0, 60, (L // 2, 2))
    coarse["valid"] = rng.random(L) > 0.2
    for s in (fine, coarse):
        d = s["ep"] - s["sp"]
        d = np.where(d[:, :1] < 0, -d, d)
        s["angle"] = np.arctan2(d[:, 1], d[:, 0])
        for k in s:
            s[k] = s[k].astype(np.float32) if k != "valid" else s[k]
    l = CFG.lines.__class__(max_lines=L)
    ref = jsl._fuse_levels(jlines.Segments(**fine), jlines.Segments(**coarse),
                           l)
    got = tsl.fuse_levels(_tsegs({k: v[None] for k, v in fine.items()}),
                          _tsegs({k: v[None] for k, v in coarse.items()}), l)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(ref, f)))
    assert 0 < int(np.asarray(ref.valid).sum()) < 2 * L


def test_overlap_and_horizontal_masks_match_reference():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 400, (4, 40, 2)).astype(np.float32)
    b = rng.uniform(0, 400, (4, 50, 2)).astype(np.float32)
    for k in range(4):
        np.testing.assert_array_equal(
            tsl.seg_y_overlap(*(torch.from_numpy(x[k]) for x in (a, a[:, ::-1].copy(), b, b[:, ::-1].copy()))).numpy(),
            np.asarray(jsl.seg_y_overlap(*(jnp.asarray(x[k]) for x in (a, a[:, ::-1].copy(), b, b[:, ::-1].copy())))))
    ang = np.concatenate([rng.uniform(-1.6, 1.6, 500),
                          [-np.pi / 2, np.pi / 2, 0.0, 0.17, -0.17]]
                         ).astype(np.float32)
    m = CFG.matching
    want = np.abs(np.mod(jnp.asarray(ang) + jnp.pi / 2, jnp.pi)
                  - jnp.pi / 2) > m.line_horiz_th
    np.testing.assert_array_equal(
        tsl.not_horizontal(torch.from_numpy(ang), m.line_horiz_th).numpy(),
        np.asarray(want))


def test_match_stereo_lines_matches_reference(ref_frames):
    sl, dl, sr, dr, ref = ref_frames[0]
    tseg = lambda s: _tsegs({k: v[None] for k, v in _np(s).items()})
    got = tsl.match_stereo_lines(tseg(sl), torch.from_numpy(np.array(dl))[None],
                                 tseg(sr), torch.from_numpy(np.array(dr))[None],
                                 TCAM, _tcfg(CFG))
    v = np.asarray(ref.valid)
    assert v.sum() >= 8
    np.testing.assert_array_equal(got.valid[0].numpy(), v)
    # the disparity x - u_r cancels: the jitted reference contracts
    # b v + c of the row intersection into an FMA (measured 6.1e-5 px)
    for f, rtol, atol in (("sdisp", 0, 2e-4), ("edisp", 0, 2e-4),
                          ("sP", 1e-4, 0), ("eP", 1e-4, 0),
                          ("le", 2e-6, 0)):
        np.testing.assert_allclose(getattr(got, f)[0].numpy()[v],
                                   np.asarray(getattr(ref, f))[v],
                                   rtol=rtol, atol=atol)


def test_match_f2f_lines_matches_reference(seq, ref_frames):
    prev, cur = ref_frames[0][4], ref_frames[1][4]
    T = (np.linalg.inv(seq.poses[1]) @ seq.poses[0]).astype(np.float32)
    ref = jfh.match_f2f_lines(prev, cur, jnp.asarray(T), CAM, CFG)
    rterms = jfh.build_line_terms(prev, cur, ref)
    tp = convert.lines_from_numpy({k: v[None] for k, v in _np(prev).items()},
                                  "cpu")
    tc = convert.lines_from_numpy({k: v[None] for k, v in _np(cur).items()},
                                  "cpu")
    got = tfh.match_f2f_lines(tp, tc, torch.from_numpy(T)[None], TCAM,
                              _tcfg(CFG))
    assert int(np.asarray(ref.valid).sum()) >= 8
    np.testing.assert_array_equal(got.idx[0].numpy(), ref.idx)
    np.testing.assert_array_equal(got.valid[0].numpy(), ref.valid)
    terms = tfh.build_line_terms(tp, tc, got)
    np.testing.assert_array_equal(terms.valid[0].numpy(), rterms.valid)
    np.testing.assert_array_equal(terms.le_obs[0].numpy(), rterms.le_obs)
    # line_equation itself, on the reference's segments
    np.testing.assert_allclose(
        tfh.pose_gn.LineTerms(*terms).le_obs[0].numpy(),
        np.asarray(jfeat.line_equation(cur.sp, cur.ep))[
            np.maximum(np.asarray(ref.idx), 0)], rtol=0, atol=1e-6)
