"""Port parity: the dataset VO app (``apps/plstvo_dataset.py``).

The reference's ``main`` and the port's (``--device cpu``) over one tiny
KITTI-layout directory (320x240 PNGs, 5 frames, ``poses.txt``), per frame
and with ``--chunk 2`` (points only, to keep the reference's compile
time in bounds; ``test_torch_stereo_vo.py`` holds the per-frame driver
with lines). The TUM files agree pose by pose within 2e-5 (m and
quaternion components; the file rounds to 1e-6; measured 4.0e-6) and the
printed tracking and ATE lines are identical. ``save_tum`` writes the same
bytes as the reference's on the same poses, every quaternion branch
included.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import to_u8, write_png
from plslam_tpu.apps import plstvo_dataset as japp
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.config import SlamConfig
from plslam_tpu.io import synthetic
from plslam_tpu_torch.apps import plstvo_dataset as tapp

TUM_TOL = 2e-5
CAMERA = {"width": 320, "height": 240, "fx": 250.0, "fy": 250.0,
          "cx": 160.0, "cy": 120.0, "baseline": 0.3}


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
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    cfg = SlamConfig().with_updates({"camera": CAMERA})
    seq = synthetic.make_sequence(StereoCamera.from_config(cfg.camera),
                                  n_frames=5, seed=3, n_points=220,
                                  n_lines=40, noise=0.003, step=0.12)
    for d, ims in (("image_0", seq.images_l), ("image_1", seq.images_r)):
        os.makedirs(root / d)
        for i, im in enumerate(ims):
            write_png(str(root / d / f"{i:06d}.png"), to_u8(im))
    np.savetxt(root / "poses.txt", seq.poses[:, :3, :].reshape(5, 12))
    conf = root / "config.yaml"
    with open(conf, "w") as f:
        yaml.safe_dump({"camera": CAMERA,
                        "points": {"max_kpts": 256, "orb_nlevels": 2}}, f)
    return str(root), str(conf)


def _summary(text):
    """The printed tracking and ATE lines, without the clock."""
    out = []
    for line in text.splitlines():
        if line.startswith("StVO"):
            out.append(line.split(" fps")[0].rsplit(",", 1)[0])
        elif line.startswith("ATE RMSE"):
            out.append(line)
    return out


@pytest.mark.parametrize("mode", [[], ["--chunk", "2"]],
                         ids=["per_frame", "chunked"])
def test_app_matches_reference(kitti, tmp_path, capsys, mode):
    root, conf = kitti
    args = [root, "--config", conf, "--no-lines", "--quiet", *mode]
    ref_out, port_out = str(tmp_path / "ref.txt"), str(tmp_path / "port.txt")
    assert japp.main(args + ["--out", ref_out]) == 0
    ref_text = capsys.readouterr().out
    assert tapp.main(args + ["--device", "cpu", "--out", port_out]) == 0
    port_text = capsys.readouterr().out
    ref, got = np.loadtxt(ref_out), np.loadtxt(port_out)
    assert ref.shape == got.shape == (5, 8)
    d = np.abs(ref - got).max()
    print(f"TUM poses within {d:.3g}")
    assert d <= TUM_TOL
    assert _summary(port_text) == _summary(ref_text)
    assert len(_summary(ref_text)) == 2


def _rot(axis, angle):
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def test_save_tum_is_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    rots = [np.eye(3)]
    for axis in np.eye(3):                 # trace < 0: each diagonal branch
        rots.append(_rot(axis, 3.0))
    for _ in range(6):
        a = rng.normal(0, 1, 3)
        rots.append(_rot(a / np.linalg.norm(a), rng.uniform(0, np.pi)))
    poses = np.tile(np.eye(4, dtype=np.float32), (len(rots), 1, 1))
    for T, R in zip(poses, rots):
        T[:3, :3] = R
        T[:3, 3] = rng.normal(0, 5, 3)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    japp.save_tum(a, poses)
    tapp.save_tum(b, poses)
    assert open(a, "rb").read() == open(b, "rb").read()
