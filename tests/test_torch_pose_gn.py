"""Port parity: tracking/pose_gn.py (K13, plain f32 PyTorch in this slice).

B problems built with numpy (noisy projections, 15% gross outliers, some
invalid terms) go through the reference's ``optimize_pose`` one at a time
and through the port's batched ``optimize_pose`` at once. The poses agree
within 1e-5 (f32 normal equations summed in another order), and the
inlier counts and ``good`` flags are identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.frontend.features import line_equation
from plslam_tpu.tracking import pose_gn as jgn
from plslam_tpu_torch import convert
from plslam_tpu_torch.tracking import pose_gn as tgn

CFG = SlamConfig()
CC = CFG.camera
JC = JCam.from_config(CC)
TC = convert.camera_from_numpy(CC.fx, CC.fy, CC.cx, CC.cy, CC.baseline,
                               CC.width, CC.height)
TCFG = convert.config_from_dict(CFG.to_dict())
# the reference as the VO runs it: jitted
_ref_optimize = jax.jit(jgn.optimize_pose, static_argnums=(4,))


def _problems(B, n_pts=180, n_lns=0, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        P = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-3, 3, n_pts),
                      rng.uniform(4, 40, n_pts)], -1).astype(np.float32)
        xi = (rng.normal(size=6) * [0.05, 0.05, 0.3, 0.01, 0.03, 0.01]
              ).astype(np.float32)
        T = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
        uv = np.asarray(JC.project(jlie.transform_points(
            jnp.asarray(T), jnp.asarray(P))))
        uv = uv + rng.normal(0, 0.5, uv.shape)
        n_out = int(0.15 * n_pts)
        uv[:n_out] += rng.normal(0, 40, (n_out, 2))
        valid = rng.random(n_pts) > 0.05
        if b == B - 1:
            valid[:] = False
            valid[:8] = True           # too few features: gated not good
        sP = np.stack([rng.uniform(-8, 8, n_lns), rng.uniform(-3, 3, n_lns),
                       rng.uniform(4, 30, n_lns)], -1).astype(np.float32)
        d = rng.normal(size=(n_lns, 3))
        eP = (sP + 2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
              ).astype(np.float32)
        le = np.asarray(line_equation(
            JC.project(jlie.transform_points(jnp.asarray(T), jnp.asarray(sP))),
            JC.project(jlie.transform_points(jnp.asarray(T), jnp.asarray(eP)))))
        out.append(dict(P=P, uv=uv.astype(np.float32), valid=valid, sP=sP,
                        eP=eP, le=le, lvalid=np.full(n_lns, b < B - 1)))
    return out


@pytest.mark.parametrize("n_lns", [0, 24])
def test_optimize_pose_matches_reference(n_lns):
    probs = _problems(4, n_lns=n_lns, seed=n_lns)
    stack = {k: np.stack([p[k] for p in probs]) for k in probs[0]}
    T0 = np.eye(4, dtype=np.float32)
    pts = tgn.PointTerms(torch.from_numpy(stack["P"]),
                         torch.from_numpy(stack["uv"]),
                         torch.from_numpy(stack["valid"]))
    lns = (tgn.LineTerms(torch.from_numpy(stack["sP"]),
                         torch.from_numpy(stack["eP"]),
                         torch.from_numpy(stack["le"]),
                         torch.from_numpy(stack["lvalid"]))
           if n_lns else None)
    res = tgn.optimize_pose(torch.from_numpy(T0).expand(4, 4, 4), TC, pts,
                            lns, TCFG)
    for b, p in enumerate(probs):
        jl = (jgn.LineTerms(jnp.asarray(p["sP"]), jnp.asarray(p["eP"]),
                            jnp.asarray(p["le"]), jnp.asarray(p["lvalid"]))
              if n_lns else None)
        ref = _ref_optimize(
            jnp.asarray(T0), JC,
            jgn.PointTerms(jnp.asarray(p["P"]), jnp.asarray(p["uv"]),
                           jnp.asarray(p["valid"])), jl, CFG)
        assert bool(res.good[b]) == bool(ref.good)
        assert int(res.n_inliers[b]) == int(ref.n_inliers)
        np.testing.assert_array_equal(res.inlier_pt[b].numpy(),
                                      np.asarray(ref.inlier_pt))
        if b < len(probs) - 1:
            assert bool(ref.good)
            np.testing.assert_allclose(res.T[b].numpy(), np.asarray(ref.T),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(res.err[b].item(), float(ref.err),
                                       rtol=1e-4)
    assert not bool(res.good[-1])
