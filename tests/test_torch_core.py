"""Port parity: core/lie.py, core/robust.py, core/camera.py.

Same numpy inputs through the reference and the port, agreement within
1e-5 relative (f32 products summed in another order). The masked median
must return the LOWER middle element for an even count, as the reference.

One exception, inherited from the reference's formula: for rotation
angles just above the Taylor switch (0.01 < theta < ~0.05) the series
coefficients (1 - cos t)/t^2 and (1 - A)/t^2 cancel catastrophically in
f32, so a one-ulp difference between the two libraries' ``cos`` shows as
up to ~1.2e-5 absolute in exp_se3's translation; those cases are held to
3e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.core import robust as jrob
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu_torch import convert
from plslam_tpu_torch.core import lie as tlie
from plslam_tpu_torch.core import robust as trob

RTOL = 1e-5


def _close(got, ref, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=atol)


def _twists(seed, n=64, rot_scale=1.0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, 3:] *= rot_scale
    xi[:4, 3:] = [[0, 0, 0], [1e-4, 0, 0], [0, 3.1, 0.01], [2e-3, -1e-3, 0]]
    return xi


@pytest.mark.parametrize("rot_scale", [0.01, 1.0])
def test_exp_log_match_reference(rot_scale):
    xi = _twists(0, rot_scale=rot_scale)
    T = tlie.exp_se3(torch.from_numpy(xi))
    _close(T, jlie.exp_se3(jnp.asarray(xi)), atol=3e-5)
    _close(tlie.exp_so3(torch.from_numpy(xi[:, 3:])),
           jlie.exp_so3(jnp.asarray(xi[:, 3:])))
    Tn = T.numpy()
    _close(tlie.inverse_se3(T), jlie.inverse_se3(jnp.asarray(Tn)))
    np.testing.assert_array_equal(
        tlie.is_valid_rotation(T[:, :3, :3]).numpy(),
        np.asarray(jlie.is_valid_rotation(jnp.asarray(Tn[:, :3, :3]))))


def test_log_matches_reference():
    """Angles where arccos is well conditioned (>= 0.2 rad), up to near pi:
    below that the reference's arccos(trace) form loses ~sqrt(eps) in f32
    on both sides alike."""
    rng = np.random.default_rng(7)
    axis = rng.normal(size=(64, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.2, 3.0, 60), [3.1, 3.13, 3.14, 0.5]])
    xi = np.concatenate([rng.normal(0, 2, (64, 3)), axis * ang[:, None]],
                        -1).astype(np.float32)
    T = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
    _close(tlie.log_se3(torch.from_numpy(T)), jlie.log_se3(jnp.asarray(T)),
           atol=1e-4)
    _close(tlie.log_so3(torch.from_numpy(T[:, :3, :3])),
           jlie.log_so3(jnp.asarray(T[:, :3, :3])), atol=1e-5)


def test_skew_and_transform_points():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tlie.skew(torch.from_numpy(w)).numpy(),
                                  np.asarray(jlie.skew(jnp.asarray(w))))
    T = np.asarray(jlie.exp_se3(jnp.asarray(_twists(2, n=5))))
    P = rng.normal(0, 5, (5, 40, 3)).astype(np.float32)
    _close(tlie.transform_points(torch.from_numpy(T), torch.from_numpy(P)),
           jlie.transform_points(jnp.asarray(T), jnp.asarray(P)), atol=1e-5)


def test_invalid_rotation_detected():
    R = np.eye(3, dtype=np.float32)[None].repeat(3, 0)
    R[1, 0, 0] = 1.01
    R[2] = -R[2]
    np.testing.assert_array_equal(
        tlie.is_valid_rotation(torch.from_numpy(R)).numpy(),
        np.asarray(jlie.is_valid_rotation(jnp.asarray(R))))


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 8])
def test_masked_median_lower_middle(n_valid):
    rng = np.random.default_rng(n_valid)
    x = rng.uniform(0, 10, (3, 12)).astype(np.float32)
    mask = np.zeros((3, 12), bool)
    for r in range(3):
        mask[r, rng.choice(12, n_valid, replace=False)] = True
    got = trob.masked_median(torch.from_numpy(x), torch.from_numpy(mask))
    ref = jrob.masked_median(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if n_valid == 8:   # even count: the lower of the two middle elements
        lower = np.sort(x[0][mask[0]])[3]
        assert got[0].item() == lower


def test_mad_scale_and_tstudent():
    rng = np.random.default_rng(9)
    r = np.abs(rng.normal(0, 2, (4, 50))).astype(np.float32)
    mask = rng.random((4, 50)) > 0.2
    s = trob.mad_scale_zero_centered(torch.from_numpy(r),
                                     torch.from_numpy(mask))
    rs = jrob.mad_scale_zero_centered(jnp.asarray(r), jnp.asarray(mask))
    _close(s, rs)
    _close(trob.tstudent_weight(torch.from_numpy(r), s[:, None]),
           jrob.tstudent_weight(jnp.asarray(r), rs[:, None]))


def test_camera_matches_reference():
    cc = SlamConfig().camera
    jc = JCam.from_config(cc)
    tc = convert.camera_from_numpy(cc.fx, cc.fy, cc.cx, cc.cy, cc.baseline,
                                   cc.width, cc.height)
    rng = np.random.default_rng(3)
    P = np.stack([rng.uniform(-10, 10, 200), rng.uniform(-3, 3, 200),
                  rng.uniform(2, 60, 200)], -1).astype(np.float32)
    _close(tc.project(torch.from_numpy(P)), jc.project(jnp.asarray(P)),
           atol=1e-4)
    _close(tc.project_jacobian(torch.from_numpy(P)),
           jc.project_jacobian(jnp.asarray(P)))
    uv = rng.uniform(0, 1000, (200, 2)).astype(np.float32)
    d = rng.uniform(1, 100, 200).astype(np.float32)
    _close(tc.back_project(torch.from_numpy(uv), torch.from_numpy(d)),
           jc.back_project(jnp.asarray(uv), jnp.asarray(d)), atol=1e-5)
