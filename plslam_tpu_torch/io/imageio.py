"""Host image decode, rectification and prefetch (port of
``plslam_tpu/native/imageio.py`` and ``imagecodec.cpp``).

``load_gray`` decodes PGM/PPM (P2, P3, P5, P6) and PNG (8 and 16 bit;
gray, gray + alpha, RGB, RGBA, palette) to (H, W) float32 ``byte *
(1.0f/255.0f)``, as the reference's native decoder, without PIL or
libpng: the PNG stream is inflated by the standard library's ``zlib`` and
its row filters are undone here. Filters 0-2 are numpy; Average and
Paeth (3, 4) run along a row one pixel after another, through the host
C++ function ``png_unfilter_row`` (``csrc/png_unfilter.cpp``), built with
the system's ``c++`` into ``_build/`` at first use. A missing compiler
raises; nothing falls back. ``png_unfilter_row_plain`` is its numpy
version.

RGB reduces to gray as libpng's ``png_set_rgb_to_gray_fixed(png, 1, -1,
-1)`` does on a file without gAMA, sRGB, cHRM or iCCP chunks: integer
weights 6968, 23434, 2366 over 2^15 (truncated at 8 bits, rounded at 16),
then 16-bit samples keep their high byte. The reference's two reader
quirks are kept: binary PNM with maxval > 255 reads its bytes as
samples, and a tRNS chunk leaves an alpha byte after each gray byte, of
which the first W bytes of a row are read. JPEG, BMP and interlaced PNG
raise (ROADMAP.md Queue 1).

``Prefetcher`` decodes ahead in a thread pool and, given a map, rectifies
with ``_remap_np``: the reference's host remap, which clamps the source
coordinates into the image (unlike the device ``remap_bilinear``, whose
out-of-bounds taps read 0).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from plslam_tpu_torch.native import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "png_unfilter.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_INV255 = np.float32(1.0) / np.float32(255.0)
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's default rgb_to_gray coefficients (red, green; blue = 2^15 - both)
_RC, _GC = 6968, 23434
_BC = 32768 - _RC - _GC

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not decoded by plslam_tpu_torch (ROADMAP.md Queue 1: "
        "the port reads PGM/PPM and PNG)")


# -- the host C++ row filter ---------------------------------------------------

def _lib_path() -> str:
    h = hashlib.sha1(open(_SRC, "rb").read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpng_unfilter_{h.hexdigest()[:12]}.so")


def unfilter_lib() -> ctypes.CDLL:
    """Build ``png_unfilter.cpp`` at first use and load it."""
    global _lib
    with _lock:
        if _lib is None:
            out = _lib_path()
            if not os.path.exists(out):
                cxx = shutil.which("c++") or shutil.which("g++")
                if cxx is None:
                    raise RuntimeError(
                        "no C++ compiler (c++ or g++) on PATH: the PNG "
                        "decoder of plslam_tpu_torch builds "
                        "csrc/png_unfilter.cpp at first use")
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = out + f".tmp{os.getpid()}"
                subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            lib.png_unfilter_row.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int]
            lib.png_unfilter_row.restype = ctypes.c_int
            _lib = lib
        return _lib


def png_unfilter_row(ftype: int, cur: np.ndarray, prev: np.ndarray,
                     bpp: int) -> None:
    """Unfilter one row in place with the host C++ function."""
    for a in (cur, prev):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError("png_unfilter_row: contiguous uint8 rows only")
    if prev.size < cur.size or bpp < 1:
        raise ValueError("png_unfilter_row: prev shorter than the row")
    rc = unfilter_lib().png_unfilter_row(ftype, cur.ctypes.data,
                                         prev.ctypes.data, cur.size, bpp)
    if rc != 0:
        raise ValueError(f"PNG: unknown row filter type {ftype}")


def png_unfilter_row_plain(ftype: int, cur: np.ndarray, prev: np.ndarray,
                           bpp: int) -> None:
    """Numpy version of :func:`png_unfilter_row`: None, Sub (a per-lane
    uint8 cumulative sum, which wraps mod 256) and Up vectorised, Average
    and Paeth a loop along the row."""
    if ftype == 1:
        lanes = cur.reshape(-1, bpp)         # rowbytes is a multiple of bpp
        np.cumsum(lanes, axis=0, dtype=np.uint8, out=lanes)
    elif ftype == 2:
        cur += prev
    elif ftype in (3, 4):
        c = cur.astype(np.int32)
        p = prev.astype(np.int32)
        for i in range(c.size):
            a = c[i - bpp] if i >= bpp else 0
            if ftype == 3:
                pred = (a + p[i]) >> 1
            else:
                b, cc = p[i], (p[i - bpp] if i >= bpp else 0)
                q = a + b - cc
                pa, pb, pc = abs(q - a), abs(q - b), abs(q - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc
                                                          else cc)
            c[i] = (c[i] + pred) & 0xFF
        cur[:] = c.astype(np.uint8)
    elif ftype != 0:
        raise ValueError(f"PNG: unknown row filter type {ftype}")


def png_unfilter(data: np.ndarray, height: int, rowbytes: int, bpp: int,
                 plain: bool = False) -> np.ndarray:
    """Inflated PNG data (height rows of 1 filter byte + rowbytes) ->
    (height, rowbytes) uint8 unfiltered bytes. Filters 0-2 run in numpy,
    3 and 4 through the host C++ function (``plain``: its numpy version)."""
    rows = data.reshape(height, rowbytes + 1)
    ftypes = rows[:, 0]
    out = np.ascontiguousarray(rows[:, 1:])
    zero = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        f = int(ftypes[y])
        row = png_unfilter_row if f in (3, 4) and not plain \
            else png_unfilter_row_plain
        row(f, out[y], out[y - 1] if y else zero, bpp)
    return out


# -- PNG -------------------------------------------------------------------------

def _png_chunks(buf: bytes):
    if buf[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: CRC error in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG: truncated file (no IEND)")


def _samples(raw: np.ndarray, width: int, channels: int, depth: int
             ) -> np.ndarray:
    """(H, rowbytes) unfiltered bytes -> (H, W, channels) integer samples."""
    H = raw.shape[0]
    if depth == 16:
        s = raw.view(">u2").astype(np.int64)
    elif depth == 8:
        s = raw.astype(np.int64)
    else:
        bits = np.unpackbits(raw, axis=1)
        bits = bits[:, :width * depth].reshape(H, width, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        s = (bits * weights).sum(-1).astype(np.int64)
    return s.reshape(H, width, channels)


def _decode_png(buf: bytes) -> np.ndarray:
    ihdr = plte = trns = None
    idat: List[bytes] = []
    for kind, body in _png_chunks(buf):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG: no IHDR")
    W, H, depth, color, _, _, interlace = ihdr
    if interlace:
        raise _unsupported("an interlaced (Adam7) PNG")
    if color not in _CHANNELS:
        raise ValueError(f"PNG: bad color type {color}")
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    rowbytes = (W * ch * depth + 7) // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if data.size < H * (rowbytes + 1):
        raise ValueError("PNG: image data too short")
    raw = png_unfilter(data[:H * (rowbytes + 1)].copy(), H, rowbytes, bpp)
    s = _samples(raw, W, ch, depth)
    top = (1 << depth) - 1
    opaque = 65535 if depth == 16 else 255

    # libpng's expansion (palette -> RGB, gray < 8 bits -> 8, tRNS ->
    # alpha), alpha stripping (only for the alpha color types), RGB -> gray
    # at the sample depth, then 16 -> 8 bits by the high byte
    alpha = None
    if color == 3:
        pal = np.zeros((256, 3), np.int64)
        p = np.frombuffer(plte or b"", np.uint8).reshape(-1, 3)
        pal[:len(p)] = p
        idx = s[..., 0]
        rgb, depth = pal[idx], 8
        if trns is not None:
            a = np.full(256, 255, np.int64)
            t = np.frombuffer(trns, np.uint8)
            a[:len(t)] = t
            alpha = a[idx]
    elif color in (0, 2):
        if trns is not None:
            key = np.array(struct.unpack(f">{ch}H", trns[:2 * ch]))
            alpha = np.where(np.all(s == key, -1), 0, opaque)
        if color == 0 and depth < 8:
            s = s * (255 // top)
            depth = 8
        rgb = s
    else:
        rgb = s[..., :-1]                    # gray or RGB; alpha stripped
    if rgb.shape[-1] == 3:
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        rnd = 16384 if depth == 16 else 0
        gray = (_RC * r + _GC * g + _BC * b + rnd) >> 15
    else:
        gray = rgb[..., 0]
    if depth == 16:
        gray = gray >> 8
        alpha = None if alpha is None else alpha >> 8
    if alpha is not None:
        # the reference strips alpha only for the alpha color types: with
        # tRNS each row is gray, alpha, gray, ... and it reads W bytes
        gray = np.stack([gray, alpha], -1).reshape(H, 2 * W)[:, :W]
    return gray.astype(np.uint8).astype(np.float32) * _INV255


# -- PNM -------------------------------------------------------------------------

def _decode_pnm(buf: bytes) -> np.ndarray:
    n, pos = len(buf), 0
    while pos < n and chr(buf[pos]).isspace():
        pos += 1
    magic = buf[pos:pos + 2]
    pos += 2
    kinds = {b"P5": (1, True), b"P6": (3, True), b"P2": (1, False),
             b"P3": (3, False)}
    if magic not in kinds:
        raise _unsupported(f"an image of magic {magic!r}")
    ch, binary = kinds[magic]

    def header_int():
        nonlocal pos
        while pos < n:                       # whitespace and comments
            c = chr(buf[pos])
            if c == "#":
                while pos < n and buf[pos] != 0x0A:
                    pos += 1
                pos += 1
            elif c.isspace():
                pos += 1
            else:
                break
        start = pos
        while pos < n and chr(buf[pos]).isdigit():
            pos += 1
        if pos == start:
            raise ValueError("PNM: bad header")
        return int(buf[start:pos])

    W, H, maxval = header_int(), header_int(), header_int()
    pos += 1                                 # one whitespace after the header
    inv = np.float32(1.0) / np.float32(maxval)
    if binary:
        # as the reference: a row of W*ch*(2 if maxval > 255 else 1) bytes,
        # of which the first W*ch are read as samples
        row = W * ch * (2 if maxval > 255 else 1)
        data = np.frombuffer(buf, np.uint8, H * row, pos).reshape(H, row)
        px = data[:, :W * ch].astype(np.float32).reshape(H, W, ch)
        if ch == 1:
            return px[..., 0] * inv
        return ((np.float32(0.299) * px[..., 0]
                 + np.float32(0.587) * px[..., 1])
                + np.float32(0.114) * px[..., 2]) * inv
    vals = np.array([int(t) for t in buf[pos:].split()[:H * W * ch]],
                    np.int64)
    if vals.size != H * W * ch:
        raise ValueError("PNM: too few samples")
    acc = vals.reshape(H, W, ch).sum(-1)
    return acc.astype(np.float32) / np.float32(ch) * inv


def load_gray(path: str) -> np.ndarray:
    """Decode an image file to (H, W) float32 in [0, 1]."""
    with open(path, "rb") as f:
        buf = f.read()
    if path.lower().endswith(".png"):
        return _decode_png(buf)
    return _decode_pnm(buf)


# -- host rectification and prefetch ---------------------------------------------

def _remap_np(src: np.ndarray, rect_map: np.ndarray) -> np.ndarray:
    """Host bilinear remap, coordinates clamped into the image (the
    reference's ``imagecodec.cpp::remap_bilinear`` semantics)."""
    H, W = src.shape
    u = np.clip(rect_map[..., 0], 0.0, W - 1.001)
    v = np.clip(rect_map[..., 1], 0.0, H - 1.001)
    x0 = u.astype(np.int32)
    y0 = v.astype(np.int32)
    fx = u - x0
    fy = v - y0
    p00 = src[y0, x0]
    p01 = src[y0, x0 + 1]
    p10 = src[y0 + 1, x0]
    p11 = src[y0 + 1, x0 + 1]
    return ((p00 * (1 - fx) + p01 * fx) * (1 - fy)
            + (p10 * (1 - fx) + p11 * fx) * fy).astype(np.float32)


class Prefetcher:
    """Decode-ahead over an ordered path list in a thread pool.

    With ``rect_map`` ((H', W', 2) float32 source coordinates) each frame
    is rectified after decoding, in the same worker, so host IO and
    rectification overlap device compute. ``get(i)`` waits for frame i
    and keeps the next ``capacity`` frames in flight."""

    def __init__(self, paths: List[str], shape, capacity: int = 8,
                 n_threads: int = 2, rect_map: Optional[np.ndarray] = None):
        self.paths = paths
        self.shape = (tuple(rect_map.shape[:2]) if rect_map is not None
                      else (tuple(shape) if shape is not None else None))
        self._rect_map = (None if rect_map is None
                          else np.ascontiguousarray(rect_map, np.float32))
        self._capacity = capacity
        self._pool: Optional[ThreadPoolExecutor] = ThreadPoolExecutor(
            max_workers=n_threads)
        self._futures: Dict[int, Future] = {}

    def _decode(self, idx: int) -> np.ndarray:
        img = load_gray(self.paths[idx])
        if self._rect_map is not None:
            img = _remap_np(img, self._rect_map)
        return img

    def get(self, idx: int) -> np.ndarray:
        if self._pool is None:
            raise RuntimeError("Prefetcher is closed")
        for k in [k for k in self._futures if k < idx]:
            self._futures.pop(k).cancel()
        for k in range(idx, min(idx + self._capacity, len(self.paths))):
            if k not in self._futures:
                self._futures[k] = self._pool.submit(self._decode, k)
        img = self._futures.pop(idx).result()
        if self.shape is not None and img.shape != self.shape:
            raise IOError(f"{self.paths[idx]}: decoded {img.shape}, "
                          f"expected {self.shape}")
        return img

    def close(self) -> None:
        if self._pool is not None:
            for f in self._futures.values():
                f.cancel()
            self._pool.shutdown(wait=True)
            self._pool = None
            self._futures = {}

    def __del__(self):
        self.close()
