"""Port parity: image decode (``io/imageio.py``), the YAML reader
(``io/yaml_lite.py``) and the dataset readers (``io/dataset.py``).

``load_gray`` must equal the reference's (``plslam_tpu/io/dataset.py::
_load_gray``, which takes the native libpng decoder here) and its native
path exactly, on PNGs written row by row with every filter type (None,
Sub, Up, Average, Paeth; ``chip_smoke.write_png``) in gray 1/2/4/8/16
bit, gray + alpha, RGB and RGBA at 8 and 16 bits, palette at 4 and 8 bits
and with tRNS chunks, and on P2/P3/P5/P6 PNM files (16-bit maxval
included). The host C++ row unfilter equals its numpy version. The YAML
reader equals ``yaml.safe_load``. ``open_dataset`` on tiny KITTI-layout,
params-yaml and EuRoC-layout directories (160x120, 3 frames, a distorted
raw rig with a rotated cam1): the camera, the rectification maps, the
ground truth, the frame lists and their slicing exactly equal, every
frame's pixels within 1e-6 (the reference rectifies in C++ in f32, the
port with the reference's numpy remap, which blends in float64; measured
1.2e-7).
"""

import dataclasses
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import yaml

from chip_smoke import write_png
from plslam_tpu.io import dataset as jds
from plslam_tpu.native import imageio as jio
from plslam_tpu_torch.io import dataset as tds
from plslam_tpu_torch.io import imageio as tio
from plslam_tpu_torch.io import yaml_lite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 23, 37


def _png_cases(rng):
    pal = rng.integers(0, 256, (180, 3))
    return {
        "gray8": dict(samples=rng.integers(0, 256, (H, W))),
        "gray16": dict(samples=rng.integers(0, 65536, (H, W)), depth=16),
        "gray4": dict(samples=rng.integers(0, 16, (H, W)), depth=4),
        "gray2": dict(samples=rng.integers(0, 4, (H, W)), depth=2),
        "gray1": dict(samples=rng.integers(0, 2, (H, W)), depth=1),
        "gray_alpha8": dict(samples=rng.integers(0, 256, (H, W, 2)),
                            color=4),
        "gray_alpha16": dict(samples=rng.integers(0, 65536, (H, W, 2)),
                             color=4, depth=16),
        "rgb8": dict(samples=rng.integers(0, 256, (H, W, 3)), color=2),
        "rgb16": dict(samples=rng.integers(0, 65536, (H, W, 3)), color=2,
                      depth=16),
        "rgba8": dict(samples=rng.integers(0, 256, (H, W, 4)), color=6),
        "rgba16": dict(samples=rng.integers(0, 65536, (H, W, 4)), color=6,
                       depth=16),
        "palette8": dict(samples=rng.integers(0, 200, (H, W)), color=3,
                         palette=pal),
        "palette4": dict(samples=rng.integers(0, 16, (H, W)), color=3,
                         depth=4, palette=pal[:16]),
        "gray8_trns": dict(samples=rng.integers(0, 256, (H, W)),
                           trns=struct.pack(">H", 7)),
        "palette_trns": dict(samples=rng.integers(0, 16, (H, W)), color=3,
                             palette=pal[:16], trns=bytes(range(0, 200, 20))),
        "rgb8_trns": dict(samples=rng.integers(0, 4, (H, W, 3)), color=2,
                          trns=struct.pack(">HHH", 1, 2, 3)),
    }


CASES = sorted(_png_cases(np.random.default_rng(0)))


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    d = tmp_path_factory.mktemp("png")
    out = {}
    for k, kw in _png_cases(np.random.default_rng(0)).items():
        out[k] = str(d / f"{k}.png")
        write_png(out[k], **kw)
    return out


def _filters(path):
    """The set of row filter types in a PNG's image data."""
    buf = open(path, "rb").read()
    chunks = dict((k, b) for k, b in tio._png_chunks(buf))
    ihdr = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    ch = tio._CHANNELS[ihdr[3]]
    rowbytes = (ihdr[0] * ch * ihdr[2] + 7) // 8
    data = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    return set(data.reshape(ihdr[1], rowbytes + 1)[:, 0].tolist())


@pytest.mark.parametrize("case", CASES)
def test_load_gray_png_exact(pngs, case):
    p = pngs[case]
    assert _filters(p) == {0, 1, 2, 3, 4}
    got = tio.load_gray(p)
    assert got.dtype == np.float32 and got.shape == (H, W)
    np.testing.assert_array_equal(got, jds._load_gray(p))
    native = jio.load_gray(p)
    assert native is not None, "the reference's native decoder must load"
    np.testing.assert_array_equal(got, native)


def _pnm_files(d):
    rng = np.random.default_rng(1)
    g = rng.integers(0, 256, (H, W)).astype(np.uint8)
    c = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    g16 = rng.integers(0, 65536, (H, W)).astype(">u2")
    files = {
        "p5.pgm": b"P5\n# a comment\n%d %d\n255\n" % (W, H) + g.tobytes(),
        "p2.pgm": (b"P2\n%d # c\n %d\n200\n" % (W, H)) + " ".join(
            str(int(v) % 201) for v in g.ravel()).encode() + b"\n",
        "p6.ppm": b"P6 %d %d 255\n" % (W, H) + c.tobytes(),
        "p3.ppm": b"P3\n%d %d\n255\n" % (W, H) + " ".join(
            map(str, c.ravel())).encode(),
        "p5_16.pgm": b"P5\n%d %d\n65535\n" % (W, H) + g16.tobytes(),
        "p2_16.pgm": b"P2\n%d %d\n65535\n" % (W, H) + " ".join(
            map(str, g16.ravel())).encode(),
    }
    for k, v in files.items():
        with open(os.path.join(d, k), "wb") as f:
            f.write(v)
    return sorted(files)


def test_load_gray_pnm_exact(tmp_path):
    for name in _pnm_files(tmp_path):
        p = str(tmp_path / name)
        got = tio.load_gray(p)
        assert got.shape == (H, W), name
        np.testing.assert_array_equal(got, jio.load_gray(p), err_msg=name)
        np.testing.assert_array_equal(got, jds._load_gray(p), err_msg=name)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_host_equals_plain(bpp):
    rng = np.random.default_rng(bpp)
    n = 7 * bpp * 5
    prev = rng.integers(0, 256, n).astype(np.uint8)
    for ftype in range(5):
        cur = rng.integers(0, 256, n).astype(np.uint8)
        a, b = cur.copy(), cur.copy()
        tio.png_unfilter_row(ftype, a, prev, bpp)
        tio.png_unfilter_row_plain(ftype, b, prev, bpp)
        np.testing.assert_array_equal(a, b, err_msg=f"filter {ftype}")
    with pytest.raises(ValueError, match="filter"):
        tio.png_unfilter_row(5, cur, prev, bpp)
    # a whole image through numpy + the host function and through numpy alone
    data = rng.integers(0, 256, (9, n + 1)).astype(np.uint8)
    data[:, 0] = np.arange(9) % 5
    np.testing.assert_array_equal(
        tio.png_unfilter(data.ravel().copy(), 9, n, bpp),
        tio.png_unfilter(data.ravel().copy(), 9, n, bpp, plain=True))


def test_other_formats_raise(tmp_path, pngs):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0 not decoded")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.load_gray(str(p))
    buf = bytearray(open(pngs["gray8"], "rb").read())
    buf[28] = 1                                  # the IHDR interlace byte
    buf[29:33] = struct.pack(">I", zlib.crc32(bytes(buf[12:29])))
    q = tmp_path / "interlaced.png"
    q.write_bytes(bytes(buf))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tio.load_gray(str(q))


SENSOR_YAML = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


def test_yaml_reader_matches_safe_load():
    # PyYAML refuses EuRoC's own "%YAML:1.0" header; the port reads it
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(SENSOR_YAML)
    body = SENSOR_YAML.split("\n", 1)[1]
    ref = yaml.safe_load(body)
    assert yaml_lite.loads(SENSOR_YAML) == ref
    assert yaml_lite.loads("%YAML 1.1\n---\n" + body) == ref
    odd = ("a: [1e-05, .5, +3, 0x1F, 017, yes, ~, 'a b', \"c\\\"d # x\", "
           ".inf, -.Inf, 1_000, 'it''s']\nb: {x: 1, y: [2, 3], 'z': w}\n"
           "c:\nd: off # comment\n")
    assert yaml_lite.loads(odd) == yaml.safe_load(odd)
    params = ("images_subfolder_l: image_0\nimages_subfolder_r: 'image_1'\n"
              "cam_width: 160\ncam_fx: 250.5\ncam_bl: 0.3 # m\n")
    assert yaml_lite.loads(params) == yaml.safe_load(params)
    with pytest.raises(NotImplementedError):
        yaml_lite.loads("a:\n  - 1\n  - 2\n")


# -- the dataset layouts -----------------------------------------------------

DH, DW, N = 120, 160, 3


def _rot(rx, ry, rz):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def _images(rng):
    return rng.integers(0, 256, (N, DH, DW)).astype(np.uint8)


def _write_pair_dirs(root, left, right, ext="png"):
    for d, seed in ((left, 2), (right, 3)):
        os.makedirs(os.path.join(root, d))
        for i, im in enumerate(_images(np.random.default_rng(seed))):
            p = os.path.join(root, d, f"{i:06d}.{ext}")
            if ext == "png":
                write_png(p, im)
            else:
                with open(p, "wb") as f:
                    f.write(b"P5\n%d %d\n255\n" % (DW, DH) + im.tobytes())


def _kitti(root):
    _write_pair_dirs(root, "image_0", "image_1")
    rng = np.random.default_rng(4)
    np.savetxt(os.path.join(root, "poses.txt"), rng.normal(0, 1, (N, 12)))


def _params(root):
    _write_pair_dirs(root, "left_cam", "right_cam", ext="pgm")
    with open(os.path.join(root, "dataset_params.yaml"), "w") as f:
        f.write("images_subfolder_l: left_cam\nimages_subfolder_r: "
                "right_cam\ncam_width: 160\ncam_height: 120\ncam_fx: 150.5\n"
                "cam_fy: 151.0\ncam_cx: 80.2\ncam_cy: 60.1\ncam_bl: 0.25\n")


def _euroc(root):
    """A raw rig: radial-tangential distortion, cam1 rotated by ~1 deg and
    0.11 m to the right, a body-to-camera T_BS; sensor.yaml without the
    "%YAML:1.0" header, which the reference's PyYAML refuses."""
    mav = os.path.join(root, "mav0")
    T_BS0 = np.eye(4)
    T_BS0[:3, :3] = _rot(0.1, 0.2, -0.15)
    T_BS0[:3, 3] = [0.05, -0.02, 0.1]
    T_10 = np.eye(4)
    T_10[:3, :3] = _rot(0.01, -0.012, 0.008)
    T_10[:3, 3] = T_10[:3, :3] @ np.array([-0.11, 0.0, 0.0])
    stamps = [1403636579763555584 + i * 50000000 for i in range(N)]
    for c, (K, d, T_rel) in enumerate((
            ((100.0, 99.0, 81.5, 58.2), (-0.28, 0.07, 2e-4, 1.8e-5),
             np.eye(4)),
            ((101.5, 100.2, 78.9, 61.0), (-0.27, 0.068, -1e-4, -3.6e-5),
             T_10))):
        cam = os.path.join(mav, f"cam{c}")
        os.makedirs(os.path.join(cam, "data"))
        T_BS = T_BS0 @ np.linalg.inv(T_rel)
        with open(os.path.join(cam, "sensor.yaml"), "w") as f:
            f.write("sensor_type: camera\nT_BS:\n  cols: 4\n  rows: 4\n"
                    "  data: [" + ",\n    ".join(
                        repr(float(v)) for v in T_BS.ravel()) + "]\n"
                    f"resolution: [{DW}, {DH}]\nintrinsics: {list(K)}\n"
                    f"distortion_coefficients: {list(d)}\n")
        for s, im in zip(stamps, _images(np.random.default_rng(5 + c))):
            write_png(os.path.join(cam, "data", f"{s}.png"), im)
    gt = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt)
    rng = np.random.default_rng(6)
    rows = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for k in range(3 * N):                    # denser than the images
        q = rng.normal(0, 1, 4)
        q /= np.linalg.norm(q)
        rows.append(f"{stamps[0] - 30000000 + k * 20000000},"
                    + ",".join(repr(float(v))
                               for v in (*rng.normal(0, 1, 3), *q)))
    with open(os.path.join(gt, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("layout", ["kitti", "params", "euroc"])
def test_open_dataset_matches_reference(tmp_path, layout):
    root = str(tmp_path / layout)
    {"kitti": _kitti, "params": _params, "euroc": _euroc}[layout](root)
    for start, count, step in ((0, None, 1), (1, 2, 1), (0, 2, 2)):
        ref = jds.open_dataset(root, start=start, count=count, step=step)
        got = tds.open_dataset(root, start=start, count=count, step=step)
        assert got.name == ref.name and len(got) == len(ref) > 0
        assert got.left == ref.left and got.right == ref.right
        assert dataclasses.asdict(got.camera) == dataclasses.asdict(
            ref.camera)
        if layout == "params":
            assert got.gt_poses is None and ref.gt_poses is None
        else:
            np.testing.assert_array_equal(got.gt_poses, ref.gt_poses)
        if layout == "euroc":
            for a, b in zip(got.rect_maps, ref.rect_maps):
                np.testing.assert_array_equal(a, b)
        else:
            assert got.rect_maps is None and ref.rect_maps is None
        d = 0.0
        for i in range(len(ref)):
            for a, b in zip(got.frame(i), ref.frame(i)):
                assert a.shape == b.shape == (DH, DW)
                d = max(d, float(np.abs(a - b).max()))
        got.close()
        ref.close()
        print(f"{layout} [{start}:{count}:{step}] frames within {d:.3g}")
        if layout != "euroc":
            assert d == 0.0
        assert d <= 1e-6, d
    # the port also reads EuRoC's own "%YAML:1.0" header
    if layout == "euroc":
        y = os.path.join(root, "mav0", "cam0", "sensor.yaml")
        plain = tds._parse_euroc_sensor_yaml(y)
        with open(y) as f:
            text = f.read()
        with open(y, "w") as f:
            f.write("%YAML:1.0\n" + text)
        headed = tds._parse_euroc_sensor_yaml(y)
        for a, b in zip(plain, headed):
            np.testing.assert_array_equal(a, b)


def test_prefetcher_contract(tmp_path):
    root = str(tmp_path / "k")
    _kitti(root)
    ds = tds.open_dataset(root)
    paths = ds.left
    pf = tio.Prefetcher(paths, (DH, DW), capacity=2)
    for i in (2, 0, 1, 1):
        np.testing.assert_array_equal(pf.get(i), tio.load_gray(paths[i]))
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.get(0)
    bad = tio.Prefetcher(paths, (DH + 1, DW))
    with pytest.raises(IOError):
        bad.get(0)
    bad.close()


def test_dataset_path_imports_no_yaml_pil_or_jax(tmp_path):
    """Reading the three layouts needs neither PyYAML nor PIL (nor JAX)."""
    for layout, make in (("kitti", _kitti), ("params", _params),
                         ("euroc", _euroc)):
        make(str(tmp_path / layout))
    code = ("import sys\n"
            "from plslam_tpu_torch.io.dataset import open_dataset\n"
            f"for l in ('kitti', 'params', 'euroc'):\n"
            f"    ds = open_dataset({str(tmp_path)!r} + '/' + l)\n"
            "    ds.frame(len(ds) - 1)\n"
            "    ds.close()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('yaml', 'PIL', 'jax', 'plslam_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
