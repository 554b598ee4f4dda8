"""The port stands alone: no JAX, nothing of plslam_tpu, CUDA by default."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import plslam_tpu_torch
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.tracking.batch_vo import BatchedStereoVO, extract_one

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "plslam_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "plslam_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "profile_torch_vo.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_covers_every_port_package():
    dirs = {os.path.relpath(os.path.dirname(p), PKG) for p in _port_files()
            if p.startswith(PKG)}
    assert {"apps", "io", "utils", "core", "tracking"} <= dirs


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


_READERS = {"open", "load", "loadtxt", "fromfile", "join", "Path", "exists",
            "isfile", "isdir", "listdir", "scandir", "walk", "glob", "stat",
            "read_text", "read_bytes", "load_vocabulary"}


def _reads_reference_path(path):
    """String constants under plslam_tpu/ in the arguments of calls that
    open, list or join file paths."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if name not in _READERS:
            continue
        for arg in list(node.args) + [k.value for k in node.keywords]:
            for c in ast.walk(arg):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    v = c.value.replace("\\", "/")
                    if (v.strip("/") == "plslam_tpu"
                            or v.startswith("plslam_tpu/")
                            or "/plslam_tpu/" in v):
                        yield v


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reads_under_the_reference_package(path):
    bad = sorted(set(_reads_reference_path(path)))
    assert not bad, f"{path} reads {bad}"


def test_vocabularies_are_the_ports_own():
    from plslam_tpu_torch.loop import vocabulary
    for kind in ("orb", "lbd"):
        p = os.path.realpath(vocabulary.default_path(kind, 10, 4))
        assert p.startswith(os.path.join(PKG, "data") + os.sep), p
        assert os.path.exists(p)


def test_import_leaves_jax_out():
    mods = [m.name for m in pkgutil.walk_packages([PKG], "plslam_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'plslam_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 17


NEW_MODULES = ("plslam_tpu_torch.apps.plslam_dataset",
               "plslam_tpu_torch.utils.viz",
               "plslam_tpu_torch.backend.checkpoint",
               "plslam_tpu_torch.backend.slam_system",
               "plslam_tpu_torch.apps.plslam_multiseq")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_slam_app_modules_load_no_matplotlib_or_jax(module):
    """The SLAM app, the renders and the checkpoints are port files, and
    importing each loads neither JAX, nor the reference, nor matplotlib
    (the renders import it at their first call)."""
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in _port_files()
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'plslam_tpu', 'matplotlib')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_is_cuda():
    cfg = SlamConfig().with_updates({"lines": {"has_lines": False}})
    if torch.cuda.is_available():
        assert BatchedStereoVO(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedStereoVO(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            plslam_tpu_torch.resolve_device(None)
    assert BatchedStereoVO(cfg, device="cpu").device.type == "cpu"


def test_dataset_entry_points_default_to_cuda():
    """StereoVO, StereoRectifier, make_extractor and the app run on the
    CUDA device unless told otherwise, and raise without one."""
    from plslam_tpu_torch.apps import plstvo_dataset
    from plslam_tpu_torch.core.camera import StereoRectifier
    from plslam_tpu_torch.frontend.stereo_frame import make_extractor
    from plslam_tpu_torch.tracking.frame_handler import StereoVO
    cfg = SlamConfig().with_updates({"lines": {"has_lines": False}})
    m = np.zeros((4, 5, 2), np.float32)
    makers = (lambda **kw: StereoVO(cfg, **kw),
              lambda **kw: StereoRectifier(m, m, **kw),
              lambda **kw: make_extractor(None, cfg, **kw))
    assert plstvo_dataset.build_argparser("").parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        assert StereoVO(cfg).device.type == "cuda"
        assert StereoRectifier(m, m).maps.device.type == "cuda"
    else:
        for make in makers:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plstvo_dataset.main(["--synthetic", "--frames", "2", "--quiet",
                                 "--no-lines"])
    assert StereoVO(cfg, device="cpu").device.type == "cpu"
    assert StereoRectifier(m, m, device="cpu").maps.device.type == "cpu"
    make_extractor(None, cfg, device="cpu")


def test_slam_drivers_default_to_cuda():
    """PLSLAM, ChunkedPLSLAM and MapHandler run on the CUDA device unless
    told otherwise, and raise without one; with device="cpu" they build
    (the MapHandler's worker thread stops at close)."""
    from plslam_tpu_torch.backend.map_handler import MapHandler
    from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM, PLSLAM
    from plslam_tpu_torch.core.camera import StereoCamera
    cfg = SlamConfig().with_updates({"lines": {"has_lines": False},
                                     "loop": {"enabled": False},
                                     "mapping": {"max_kfs": 8,
                                                 "max_points": 256}})
    cam = StereoCamera.from_config(cfg.camera)
    makers = (lambda **kw: PLSLAM(cfg, cam, **kw),
              lambda **kw: ChunkedPLSLAM(cfg, cam, **kw),
              lambda **kw: MapHandler(cfg, cam, **kw))
    for make in makers:
        if torch.cuda.is_available():
            obj = make()
            assert obj.device.type == "cuda"
            (obj if isinstance(obj, MapHandler) else obj.map).close()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
        obj = make(device="cpu")
        assert obj.device.type == "cpu"
        mh = obj if isinstance(obj, MapHandler) else obj.map
        assert mh._async and mh._worker.is_alive()
        mh.close()
        assert mh._worker is None


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_line_front_end_is_refused_by_name():
    """The lines-only configuration's front end runs on the CPU (a
    zero-capacity point set beside the lines); the SLAM drivers, which the
    reference cannot run without points, refuse it by name."""
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM, PLSLAM
    from plslam_tpu_torch.core.camera import StereoCamera
    cfg = SlamConfig().with_updates({
        "camera": {"width": 96, "height": 64, "cx": 48.0, "cy": 32.0},
        "points": {"has_points": False}})
    cam = StereoCamera.from_config(cfg.camera)
    img = torch.zeros(64, 96)
    img[20:44, 30:70] = 1.0
    pts, lns = extract_one(img, img, cam, cfg)
    assert pts.uv.shape == (0, 2) and pts.desc.shape == (0, 256)
    assert pts.desc.dtype == torch.uint8 and pts.valid.dtype == torch.bool
    assert lns.valid.ndim == 1 and lns.desc.shape == (len(lns.valid), 256)
    for driver in (FusedPLSLAM, PLSLAM, ChunkedPLSLAM):
        with pytest.raises(NotImplementedError,
                           match=driver.__name__ + ": points.has_points"):
            driver(cfg, cam, device="cpu")
