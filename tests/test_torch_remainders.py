"""Port parity: the JAX package's small remainders.

``StereoCamera.project_stereo``, ``robust``'s ``mad_scale``,
``cauchy_weight``, ``huber_weight`` and ``pose_cov_entropy``, ``lie.mm``,
``image.extract_patches`` and ``bilinear_sample`` against the reference's
functions (float ops in another order: within 1e-6 relative, gathers
exact); ``fast.fast_score_map`` (kernel B with both thresholds equal:
masks exact, scores within 1e-6); ``orb.orientations_at`` and the
single-level ``orb.describe`` (kernel C at one level: angles within 1e-5,
bits equal where the 32-bin angle agrees, as test_torch_orb holds the
multilevel path). The image decoder against the reference's
``_load_gray``, bit for bit, on files written here: BMP at 8, 24 and 32
bits (PIL writes them; the reference hands BMP to PIL), interlaced gray,
RGB and palette PNGs (written by ``_write_adam7``: PIL writes no
interlaced PNG; held to the reference's PIL branch), a JPEG through PIL,
and without PIL an ``ImportError`` that names the format. A deliberate
difference: where the reference's native decoder is built, its libpng
path reads an interlaced PNG without de-interlacing it (the passes' rows
as the image's rows); the port gives the true image, as PIL does.
"""

import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.core import robust as jrobust
from plslam_tpu.core.camera import StereoCamera as JCam
from plslam_tpu.io import dataset as jdataset
from plslam_tpu.io import synthetic
from plslam_tpu.ops import fast as jfast
from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import orb as jorb
from plslam_tpu_torch import convert
from plslam_tpu_torch.core import lie as tlie
from plslam_tpu_torch.core import robust as trobust
from plslam_tpu_torch.io import imageio as tio
from plslam_tpu_torch.ops import fast as tfast
from plslam_tpu_torch.ops import image as timage
from plslam_tpu_torch.ops import orb as torb

CFG = SlamConfig().with_updates({
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "baseline": 0.3}})
JC = JCam.from_config(CFG.camera)
TC = convert.camera_from_numpy(JC.fx, JC.fy, JC.cx, JC.cy, JC.b, JC.width,
                               JC.height)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    seq = synthetic.make_sequence(JC, n_frames=1, seed=4, n_points=200,
                                  n_lines=20, noise=0.003, step=0.1)
    return np.asarray(seq.images_l[0], np.float32)


def _close(a, b, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_project_stereo_and_mm():
    rng = np.random.default_rng(0)
    P = np.stack([rng.uniform(-5, 5, 50), rng.uniform(-3, 3, 50),
                  rng.uniform(1, 30, 50)], -1).astype(np.float32)
    P[:2, 2] = [0.0, 1e-9]                            # the depth guard
    uv, d = TC.project_stereo(torch.from_numpy(P))
    ruv, rd = JC.project_stereo(jnp.asarray(P))
    _close(uv, ruv)
    _close(d, rd)
    a = rng.normal(size=(3, 4, 4)).astype(np.float32)
    b = rng.normal(size=(3, 4, 4)).astype(np.float32)
    _close(tlie.mm(torch.from_numpy(a), torch.from_numpy(b)),
           jlie.mm(jnp.asarray(a), jnp.asarray(b)), rtol=1e-5, atol=1e-6)


def test_robust_functions():
    rng = np.random.default_rng(1)
    r = np.concatenate([rng.normal(0, 2.5, (3, 400)),
                        np.full((3, 20), 1e3)], -1).astype(np.float32)
    mask = rng.random(r.shape) > 0.1
    mask[2] = False                                   # nothing valid
    _close(trobust.mad_scale(torch.from_numpy(r), torch.from_numpy(mask)),
           jrobust.mad_scale(jnp.asarray(r), jnp.asarray(mask)))
    x = np.linspace(-10, 10, 41).astype(np.float32)
    s = np.float32(1.7)
    _close(trobust.cauchy_weight(torch.from_numpy(x), torch.tensor(s)),
           jrobust.cauchy_weight(jnp.asarray(x), jnp.asarray(s)))
    for k in (1.345, torch.tensor(0.5)):
        _close(trobust.huber_weight(torch.from_numpy(x), k),
               jrobust.huber_weight(jnp.asarray(x), jnp.asarray(
                   np.float32(k))))
    A = rng.normal(size=(4, 6, 6))
    cov = (A @ A.transpose(0, 2, 1) * 1e-3 + 1e-6 * np.eye(6)).astype(
        np.float32)
    cov[3, :, 0] *= -1                                # det < 0: -inf
    got = trobust.pose_cov_entropy(torch.from_numpy(cov))
    ref = np.asarray(jrobust.pose_cov_entropy(jnp.asarray(cov)))
    assert np.isneginf(got[3].item()) and np.isneginf(ref[3])
    _close(got[:3], ref[:3], rtol=1e-5)


def test_patches_and_bilinear(frame):
    rng = np.random.default_rng(2)
    H, W = frame.shape
    uv = (rng.uniform(-0.1, 1.1, (60, 2)) * [W, H]).astype(np.float32)
    got = timage.extract_patches(torch.from_numpy(frame)[None],
                                 torch.from_numpy(uv)[None], 3)[0]
    ref = jimage.extract_patches(jnp.asarray(frame), jnp.asarray(uv), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    xy = (rng.uniform(-0.1, 1.1, (5, 7, 2)) * [W, H]).astype(np.float32)
    got = timage.bilinear_sample(torch.from_numpy(frame)[None],
                                 torch.from_numpy(xy)[None])[0]
    ref = jimage.bilinear_sample(jnp.asarray(frame), jnp.asarray(xy))
    _close(got, ref, rtol=0, atol=1e-6)


def test_fast_score_map(frame):
    img = np.asarray(jimage.gaussian_blur(jnp.asarray(frame), 1.0))
    th = float(np.float32(12 / 255))
    corner, score = tfast.fast_score_map(torch.from_numpy(img)[None], th)
    rc, rs = jfast.fast_score_map(jnp.asarray(img), th)
    np.testing.assert_array_equal(corner[0].numpy(), np.asarray(rc))
    _close(score[0], rs, rtol=0, atol=1e-6)


def test_orientations_and_single_level_describe(frame):
    rng = np.random.default_rng(3)
    H, W = frame.shape
    img = np.asarray(jimage.gaussian_blur(jnp.asarray(frame), 1.0))
    uv = (rng.uniform(-0.05, 1.05, (200, 2)) * [W, H]).astype(np.float32)
    t_img, t_uv = torch.from_numpy(img)[None], torch.from_numpy(uv)[None]
    theta = torb.orientations_at(t_img, t_uv)[0]
    r_theta = np.asarray(jorb.orientations_at(jnp.asarray(img),
                                              jnp.asarray(uv)))
    _close(theta, r_theta, rtol=0, atol=1e-5)
    bits, th = torb.describe(t_img, t_uv)
    r_bits, r_th = (np.asarray(x) for x in jorb.describe(jnp.asarray(img),
                                                         jnp.asarray(uv)))
    assert torch.equal(th[0], theta)
    same = (torb.angle_bins(th[0]).numpy()
            == torb.angle_bins(torch.from_numpy(r_th)).numpy())
    np.testing.assert_array_equal(bits[0].numpy()[same], r_bits[same])
    assert (~same).sum() <= 2, int((~same).sum())


# -- the decoder ----------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_adam7(path, samples, color, palette=None):
    """An 8-bit interlaced PNG of (H, W[, C]) samples, each pass's rows
    with filter Sub."""
    H, W = samples.shape[:2]
    s = samples.reshape(H, W, -1).astype(np.uint8)
    C = s.shape[-1]
    raw = b""
    for y0, x0, dy, dx in _ADAM7:
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in sub.reshape(sub.shape[0], -1).astype(np.int64):
            d = row.copy()
            d[C:] = (row[C:] - row[:-C]) & 0xFF       # Sub
            raw += b"\x01" + d.astype(np.uint8).tobytes()
    body = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0,
                                          1))
            + (_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
               if palette is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    path.write_bytes(body)


def _ref_pil_branch(path, monkeypatch):
    """The reference's _load_gray where its native decoder gives up."""
    from plslam_tpu.native import imageio as native_io
    monkeypatch.setattr(native_io, "load_gray", lambda p: None)
    try:
        return jdataset._load_gray(str(path))
    finally:
        monkeypatch.undo()


def test_decoder_matches_load_gray(tmp_path, monkeypatch):
    from PIL import Image
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (37, 29, 4), dtype=np.uint8)
    cases = {"bmp8": Image.fromarray(rgb, "RGB").quantize(40),
             "bmp8gray": Image.fromarray(rgb[..., 0], "L"),
             "bmp24": Image.fromarray(rgb, "RGB"),
             "bmp32": Image.fromarray(rgba, "RGBA")}
    for name, im in cases.items():
        p = tmp_path / f"{name}.bmp"
        im.save(p)
        got = tio.load_gray(str(p))
        ref = jdataset._load_gray(str(p))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref, err_msg=name)
    pal = rng.integers(0, 256, (16, 3))
    for name, s, color, p_ in (
            ("gray", rgb[..., 1], 0, None), ("rgb", rgb, 2, None),
            ("palette", rng.integers(0, 16, (37, 29)), 3, pal),
            ("rgba", rgba, 6, None)):
        p = tmp_path / f"adam7_{name}.png"
        _write_adam7(p, s, color, p_)
        got = tio.load_gray(str(p))
        np.testing.assert_array_equal(got, _ref_pil_branch(p, monkeypatch),
                                      err_msg=name)
    p = tmp_path / "x.jpg"
    Image.fromarray(rgb, "RGB").save(p, quality=90)
    np.testing.assert_array_equal(tio.load_gray(str(p)),
                                  jdataset._load_gray(str(p)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG"):
        tio.load_gray(str(p))


def test_interlaced_png_departs_from_the_libpng_path(tmp_path):
    """The reference's default ``_load_gray`` on an interlaced PNG, where
    its native decoder is built, is libpng's read with no interlace
    handling: the passes' rows in turn, not the image. The port returns
    the image itself (the samples / 255, as PIL), on purpose; where the
    native decoder is not built, the reference takes PIL's branch and the
    two agree."""
    from plslam_tpu.native import imageio as native_io
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (37, 29), dtype=np.uint8)
    p = tmp_path / "adam7.png"
    _write_adam7(p, gray, 0)
    got = tio.load_gray(str(p))
    np.testing.assert_array_equal(got, gray.astype(np.float32) / 255.0)
    ref = jdataset._load_gray(str(p))
    assert ref.shape == got.shape and ref.dtype == got.dtype
    if native_io.load_gray(str(p)) is None:
        np.testing.assert_array_equal(ref, got)
    else:
        # the first row of Adam7's first pass (every 8th pixel of row 0)
        # is the start of libpng's first row; what follows is not the image
        first = gray[0, 0::8]
        np.testing.assert_array_equal(np.rint(ref[0, :first.size] * 255.0),
                                      first.astype(np.float32))
        assert not np.array_equal(ref, got)
