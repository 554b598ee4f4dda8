"""Port parity: the SLAM app (``apps/plslam_dataset.py``).

The reference's ``main`` and the port's (``--device cpu``) with
``--chunk 4`` over a KITTI-layout directory of test_torch_fused_slam's
41-frame loop scene (320x240 PNGs, ``poses.txt``; its loop settings, a
keyframe every frame, points only: ``--no-lines`` keeps the reference's
compile time in bounds): the printed run line (frames, keyframes, map
points and lines, loops) identical, ATE within 5 mm of the reference's
and the TUM poses within test_torch_fused_slam's band (1 cm in
translation, 3e-3 in quaternion components). The port's ``--checkpoint``
of the first 21 frames, then ``--resume`` over all 41, writes the same
TUM file as its uninterrupted run (the checkpoint falls on a chunk whose
settle closes no loop, so the drain changes nothing). The per-frame
driver (``--chunk 0``, the default; PLSLAM with the mapping worker) and
the host-KF driver (``system.fused_slam=false``, ChunkedPLSLAM) against the
reference's app on the same directory (the per-frame one with ``--sync``):
the run line identical, ATE within 5 mm and the TUM rows within 1e-4 (per
frame) and 1e-3 (host-KF);
``--sync`` runs the map inline; ``--viz`` writes a PNG.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import to_u8, write_png
from plslam_tpu.apps import plslam_dataset as japp
from plslam_tpu.io import synthetic
from plslam_tpu_torch.apps import plslam_dataset as tapp
from test_torch_fused_slam import CAM, CFG_LOOP, N_LOOP

TRANS_TOL, QUAT_TOL = 0.01, 3e-3
HALF = 21


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One intra-op thread (see test_torch_apps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_slam")
    seq = synthetic.make_sequence(CAM, n_frames=N_LOOP, seed=3, kind="loop",
                                  n_points=300, n_lines=40, noise=0.004,
                                  step=0.15)
    for d, ims in (("image_0", seq.images_l), ("image_1", seq.images_r)):
        os.makedirs(root / d)
        for i, im in enumerate(ims):
            write_png(str(root / d / f"{i:06d}.png"), to_u8(im))
    np.savetxt(root / "poses.txt", seq.poses[:, :3, :].reshape(N_LOOP, 12))
    conf = root / "config.yaml"
    d = json.loads(json.dumps(dataclasses.asdict(CFG_LOOP)))
    with open(conf, "w") as f:
        yaml.safe_dump(d, f)
    return str(root), str(conf)


def _summary(text):
    """The printed run line without the clock, and the ATE."""
    run = [ln.split(" fps")[0].rsplit(",", 1)[0] for ln in text.splitlines()
           if ln.startswith("PL-SLAM")]
    ate = [float(ln.split()[2]) for ln in text.splitlines()
           if ln.startswith("ATE RMSE")]
    return run, ate


ARGS = ["--no-lines", "--quiet", "--chunk", "4"]


@pytest.fixture(scope="module")
def port_run(kitti, tmp_path_factory):
    """The port's app over the directory: (TUM path, printed text, record,
    the --viz PNG)."""
    root, conf = kitti
    out = tmp_path_factory.mktemp("port_app")
    tum, png = str(out / "port.txt"), str(out / "scene.png")
    rec = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tapp.main([root, "--config", conf, *ARGS, "--device", "cpu",
                          "--out", tum, "--viz", png], record=rec) == 0
    return tum, buf.getvalue(), rec, png


def test_slam_app_matches_reference(kitti, port_run, tmp_path, capsys):
    root, conf = kitti
    port_out, port_text, rec, png = port_run
    ref_out = str(tmp_path / "ref.txt")
    assert japp.main([root, "--config", conf, *ARGS, "--out", ref_out]) == 0
    ref_text = capsys.readouterr().out
    print(port_text)
    ref, got = np.loadtxt(ref_out), np.loadtxt(port_out)
    assert ref.shape == got.shape == (N_LOOP, 8)
    dt = np.abs(ref[:, 1:4] - got[:, 1:4]).max()
    dq = np.abs(ref[:, 4:] - got[:, 4:]).max()
    print(f"TUM translation within {dt:.3g} m, quaternion {dq:.3g}")
    assert dt < TRANS_TOL and dq < QUAT_TOL
    (run_t, ate_t), (run_j, ate_j) = _summary(port_text), _summary(ref_text)
    assert run_t == run_j and len(run_j) == 1
    assert abs(ate_t[0] - ate_j[0]) < 0.005
    assert rec["slam"].loop_closer.n_loops_closed >= 1
    assert os.path.getsize(png) > 0


def test_slam_app_checkpoint_resume(kitti, port_run, tmp_path):
    root, conf = kitti
    args = [root, "--config", conf, *ARGS, "--device", "cpu"]
    part, ck = str(tmp_path / "part.txt"), str(tmp_path / "half.npz")
    assert tapp.main(args + ["--frames", str(HALF), "--checkpoint", ck]) == 0
    rec = {}
    assert tapp.main(args + ["--resume", ck, "--out", part], record=rec) == 0
    assert len(rec["est"]) == N_LOOP
    assert open(part).read() == open(port_run[0]).read()


def test_slam_app_refuses_what_is_not_ported(kitti, tmp_path):
    """What stays refused: --resume on the host-KF driver (the reference's
    message and exit code 2) and, without a card, the default device."""
    root, conf = kitti
    off = str(tmp_path / "chunked.yaml")
    with open(off, "w") as f:
        yaml.safe_dump({"system": {"fused_slam": False}}, f)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tapp.main([root, "--config", off, "--chunk", "4", "--device",
                          "cpu", "--resume", "x.npz"]) == 2
    assert "--resume requires the fused driver" in err.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapp.main([root, "--config", conf, "--chunk", "4", "--quiet"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapp.main([root, "--config", conf, "--quiet", "--frames", "2"])


def _both_apps(root, conf, args, tmp_path, capsys):
    """The reference's app and the port's (--device cpu) with ``args``:
    (reference TUM rows, port TUM rows, port text, reference text,
    record)."""
    ref_out, port_out = str(tmp_path / "ref.txt"), str(tmp_path / "port.txt")
    assert japp.main([root, "--config", conf, *args, "--out", ref_out]) == 0
    ref_text = capsys.readouterr().out
    rec = {}
    assert tapp.main([root, "--config", conf, *args, "--device", "cpu",
                      "--out", port_out], record=rec) == 0
    port_text = capsys.readouterr().out
    return (np.loadtxt(ref_out), np.loadtxt(port_out), port_text, ref_text,
            rec)


def _hold_tum(ref, got, pos_tol):
    assert ref.shape == got.shape == (N_LOOP, 8)
    dt = np.abs(ref[:, 1:4] - got[:, 1:4]).max()
    dq = np.abs(ref[:, 4:] - got[:, 4:]).max()
    print(f"TUM translation within {dt:.3g} m, quaternion {dq:.3g}")
    assert dt < pos_tol and dq < pos_tol


# the TUM rows through the scene's loop closure (measured: 8.4e-5 per
# frame, 1.68e-4 host-KF): 128 keypoints at 320x240, a quarter of the
# frames untracked, the windows' LBA moving keyframes by ~1.6e-4 m between
# the two packages in the host-KF run (ROADMAP.md Queue 3)
PER_FRAME_TOL, APP_TOL = 1e-4, 1e-3


def test_slam_app_per_frame_matches_reference(kitti, tmp_path, capsys):
    """--chunk 0 (the default): PLSLAM. With --sync: the reference's async
    per-frame run probes keyframe 0 before its worker has inserted it
    (ROADMAP.md Queue 3), so the two packages are compared where the
    reference inserts first."""
    root, conf = kitti
    ref, got, port_text, ref_text, rec = _both_apps(
        root, conf, ["--no-lines", "--quiet", "--sync"], tmp_path, capsys)
    print(port_text)
    _hold_tum(ref, got, PER_FRAME_TOL)
    (run_t, ate_t), (run_j, ate_j) = _summary(port_text), _summary(ref_text)
    assert run_t == run_j and len(run_j) == 1
    assert abs(ate_t[0] - ate_j[0]) < 0.005
    assert not rec["slam"].map._async
    assert [(e.kf_from, e.kf_to) for e in rec["slam"].loop_closer.events
            ] == [(0, 29)]


def test_slam_app_host_kf_driver_matches_reference(kitti, tmp_path, capsys):
    """system.fused_slam=false: ChunkedPLSLAM, chunks of 4."""
    root, conf = kitti
    d = yaml.safe_load(open(conf))
    d["system"]["fused_slam"] = False
    off = str(tmp_path / "chunked.yaml")
    with open(off, "w") as f:
        yaml.safe_dump(d, f)
    ref, got, port_text, ref_text, rec = _both_apps(root, off, ARGS,
                                                    tmp_path, capsys)
    print(port_text)
    _hold_tum(ref, got, APP_TOL)
    (run_t, ate_t), (run_j, ate_j) = _summary(port_text), _summary(ref_text)
    assert run_t == run_j and "(chunked B=4)" in run_t[0]
    assert abs(ate_t[0] - ate_j[0]) < 0.005
    assert rec["slam"].map._async


def test_slam_app_sync_flag(kitti):
    """--sync sets system.async_mapping=False: the map runs inline."""
    root, conf = kitti
    for flags, want in (([], True), (["--sync"], False)):
        rec = {}
        assert tapp.main([root, "--config", conf, "--no-lines", "--quiet",
                          "--frames", "3", "--device", "cpu", *flags],
                         record=rec) == 0
        slam = rec["slam"]
        assert slam.cfg.system.async_mapping is want
        assert slam.map._async is want and (slam.map._worker is None)
        assert len(rec["est"]) == 3
