"""Line-segment detection (kernels E, F, G; K4, K8-K11).

Port of ``plslam_tpu/ops/lines.py``: a tile-wise reformulation of LSD.
Sobel gradients and the per-pixel support planes, then the overlapping
(2s x 2s, stride s) window moments in window-LOCAL coordinates, an
orientation pass and a reweighted pass (kernel E: on the path one launch
from the image, :func:`tile_moments`; the planes and each pass also alone,
:func:`gradient_planes`, :func:`orientation_maps`,
:func:`reweighted_moments`), the per-tile gates and the collinear
min-label propagation over the tile grid (kernel F, one launch:
:func:`gates_and_labels`), the per-root refit into candidate segments
(kernel G launch 1) and the segment-level collinear merge (kernel G
launch 2). The root and candidate selections
are stable descending sorts, as ``lax.top_k``.

Every function takes a batch: images (N, H, W) f32, tile maps (N, Th, Tw),
segments (N, M, ...). Python thresholds meet f32 tensors as the
reference's weakly typed scalars do: torch and ctypes round them to f32. On CUDA tensors the kernels of
``csrc/lines_tile.cu``, ``csrc/lines_label.cu`` and
``csrc/lines_segments.cu`` run; the plain PyTorch versions below run only
for CPU tensors. Integer results (gates, labels, roots) of a kernel equal
its plain version's exactly; float sums differ only in summation order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.ops.fast import top_k
from plslam_tpu_torch.ops.gather import take
from plslam_tpu_torch.ops.image import sobel_gradients_plain, sobel_launch

INF = 1e9          # f32-exact sentinel of empty min/max projections
_PI = math.pi


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA's and the CUDA kernels':
    torch's CPU kernel (AVX-512) is off by an ulp for ~0.7% of inputs; the
    f64 root of an f32 rounds back exactly."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def dang(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Undirected angle between lines of angles a and b (broadcast):
    |a - b| folded mod pi, as every line gate of the reference."""
    d = torch.abs(a - b)
    return torch.minimum(d, _PI - d)


class Segments(NamedTuple):
    sp: torch.Tensor      # (N, L, 2) x, y
    ep: torch.Tensor      # (N, L, 2)
    angle: torch.Tensor   # (N, L) direction angle in [-pi/2, pi/2]
    score: torch.Tensor   # (N, L) support mass
    valid: torch.Tensor   # (N, L) bool


class TileStage(NamedTuple):
    """State between the tile labelling and the per-root refit."""
    labels: torch.Tensor   # (N, Th, Tw) int32 component labels
    tile_ok: torch.Tensor  # (N, Th, Tw) bool gate survivors
    S: torch.Tensor        # support mass
    Sx: torch.Tensor       # window-LOCAL first/second moments
    Sy: torch.Tensor
    Sxx: torch.Tensor
    Syy: torch.Tensor
    Sxy: torch.Tensor
    cx: torch.Tensor       # centroids, IMAGE coordinates
    cy: torch.Tensor
    cx_l: torch.Tensor     # centroids, window-LOCAL coordinates
    cy_l: torch.Tensor
    l1: torch.Tensor       # major eigenvalue (tile extent)


def tile_grid(H: int, W: int, tile: int) -> Tuple[int, int]:
    s = tile // 2
    return (H - tile) // s + 1, (W - tile) // s + 1


# -- kernel E: gradient planes and window moments -------------------------------

def gradient_planes_plain(img: torch.Tensor, grad_th: float,
                          u8_wrap: bool = False):
    gx, gy = sobel_gradients_plain(img, u8_wrap)
    mag = sqrt_rn(gx * gx + gy * gy)
    w = torch.where(mag > grad_th, mag, 0.0)
    mag_safe = torch.clamp(mag, min=1e-9)
    d2x = torch.where(w > 0, (gx * gx - gy * gy) / mag_safe, 0.0)
    d2y = torch.where(w > 0, 2.0 * gx * gy / mag_safe, 0.0)
    return w, d2x, d2y


def gradient_planes(img: torch.Tensor, grad_th: float,
                    u8_wrap: bool = False):
    """(N, H, W) -> support weight w = |g| where |g| > grad_th, and the
    magnitude-weighted double-angle planes d2x, d2y (zero off support);
    ``u8_wrap`` as ``image.sobel_gradients``."""
    if img.device.type == "cpu":
        return gradient_planes_plain(img, grad_th, u8_wrap)
    return sobel_launch(img, grad_th, u8_wrap)


def _up_index(n: int, T: int, s: int, device) -> torch.Tensor:
    """Pixel -> tile index of the reference's edge-padded nearest
    upsample ``up()``: clamp(floor((p - s/2) / s), 0, T - 1)."""
    p = torch.arange(n, device=device) - s // 2
    return torch.clamp(torch.div(p, s, rounding_mode="floor"), 0, T - 1)


def _block_view(x: torch.Tensor, Th: int, Tw: int, s: int) -> torch.Tensor:
    N = x.shape[0]
    return x[:, :(Th + 1) * s, :(Tw + 1) * s].reshape(N, Th + 1, s, Tw + 1, s)


def _windows(blocks, s: int, Th: int, Tw: int):
    """(S8, Sx8, Sy8, Sxx8, Syy8, Sxy8, D2x8, D2y8) block maps ->
    the eight (Th, Tw) window maps: 2x2 adjacent blocks, origin-shifted
    exactly by the parallel-axis relations (the reference's formulas)."""
    S8, Sx8, Sy8, Sxx8, Syy8, Sxy8, D2x8, D2y8 = blocks
    sf = float(s)

    def window(fn):
        out = None
        for di in (0, 1):
            for dj in (0, 1):
                g = lambda m: m[:, di:di + Th, dj:dj + Tw]
                term = fn(di * sf, dj * sf, g)
                out = term if out is None else out + term
        return out

    return (window(lambda dy, dx, g: g(S8)),
            window(lambda dy, dx, g: g(Sx8) + dx * g(S8)),
            window(lambda dy, dx, g: g(Sy8) + dy * g(S8)),
            window(lambda dy, dx, g: g(Sxx8) + 2.0 * dx * g(Sx8)
                   + dx * dx * g(S8)),
            window(lambda dy, dx, g: g(Syy8) + 2.0 * dy * g(Sy8)
                   + dy * dy * g(S8)),
            window(lambda dy, dx, g: g(Sxy8) + dy * g(Sx8) + dx * g(Sy8)
                   + dx * dy * g(S8)),
            window(lambda dy, dx, g: g(D2x8)),
            window(lambda dy, dx, g: g(D2y8)))


def orientation_maps_plain(d2x, d2y, tile: int, stride: int):
    N, H, W = d2x.shape
    Th, Tw = tile_grid(H, W, tile)
    out = []
    for p in (d2x, d2y):
        b = _block_view(p, Th, Tw, stride).sum(dim=(2, 4))
        out.append(b[:, :-1, :-1] + b[:, :-1, 1:] + b[:, 1:, :-1]
                   + b[:, 1:, 1:])
    return tuple(out)


def reweighted_moments_plain(w, d2x, d2y, u2x, u2y, tile: int, stride: int):
    N, H, W = w.shape
    s = stride
    Th, Tw = u2x.shape[1:]
    ri = _up_index(H, Th, s, w.device)
    ci = _up_index(W, Tw, s, w.device)
    U = u2x[:, ri][:, :, ci]
    V = u2y[:, ri][:, :, ci]
    align_px = (d2x * U + d2y * V) / torch.clamp(w, min=1e-9)
    ratio = torch.square(torch.clamp(align_px, min=0.0))
    wr, xr, yr = (_block_view(p * ratio, Th, Tw, s) for p in (w, d2x, d2y))
    loc = torch.arange(s, dtype=torch.float32, device=w.device)
    lx = loc[None, None, None, None, :]
    ly = loc[None, None, :, None, None]
    sums = (wr, wr * lx, wr * ly, wr * (lx * lx), wr * (ly * ly),
            wr * (ly * lx), xr, yr)
    blocks = [t.sum(dim=(2, 4)) for t in sums]
    return _windows(blocks, s, Th, Tw)


def _moments_launch(planes, u, tile, stride, n_out):
    w = planes[0]
    N, H, W = w.shape
    Th, Tw = tile_grid(H, W, tile)
    for p in planes:
        native.require(p, "window moments", torch.float32, (N, H, W))
    scratch = torch.empty((n_out, N, Th + 1, Tw + 1), dtype=torch.float32,
                          device=w.device)
    out = torch.empty((n_out, N, Th, Tw), dtype=torch.float32,
                      device=w.device)
    if n_out == 2:
        args = (None, planes[0], planes[1], None, None)
    else:
        for m in u:
            native.require(m, "window moments u", torch.float32, (N, Th, Tw))
        args = (planes[0], planes[1], planes[2], u[0], u[1])
    native.launch("lines_moments", *args, scratch, out, N, H, W, Th, Tw,
                  stride)
    return tuple(out.unbind(0))


def orientation_maps(d2x, d2y, tile: int, stride: int):
    """Window sums (D2x, D2y) of the double-angle planes, (N, Th, Tw)."""
    assert tile == 2 * stride
    if d2x.device.type == "cpu":
        return orientation_maps_plain(d2x, d2y, tile, stride)
    return _moments_launch((d2x, d2y), None, tile, stride, 2)


def reweighted_moments(w, d2x, d2y, u2x, u2y, tile: int, stride: int):
    """The level-line reweighted pass: every pixel's planes scaled by
    ratio = max(align, 0)^2, align = (d2x u2x + d2y u2y) / w with the
    tile orientation field (u2x, u2y) read through the nearest edge-padded
    upsample; then the eight window sums (S, Sx, Sy, Sxx, Syy, Sxy, D2x,
    D2y), each (N, Th, Tw), coordinates LOCAL to each window's corner."""
    assert tile == 2 * stride
    if w.device.type == "cpu":
        return reweighted_moments_plain(w, d2x, d2y, u2x, u2y, tile, stride)
    return _moments_launch((w, d2x, d2y), (u2x.contiguous(),
                                           u2y.contiguous()),
                           tile, stride, 8)


def tile_moments_plain(img: torch.Tensor, tile: int, grad_th: float,
                       u8_wrap: bool = False):
    """See :func:`tile_moments`: :func:`gradient_planes_plain`,
    :func:`orientation_maps_plain`, the unit field,
    :func:`reweighted_moments_plain`."""
    stride = tile // 2
    w, d2x, d2y = gradient_planes_plain(img, grad_th, u8_wrap)
    D2x, D2y = orientation_maps_plain(d2x, d2y, tile, stride)
    d2n = sqrt_rn(D2x * D2x + D2y * D2y) + 1e-9
    return reweighted_moments_plain(w, d2x, d2y, D2x / d2n, D2y / d2n, tile,
                                    stride)


def tile_moments(img: torch.Tensor, tile: int, grad_th: float,
                 u8_wrap: bool = False):
    """The line detector's window moments from (N, H, W) images: the
    support planes (:func:`gradient_planes`), the orientation pass
    (:func:`orientation_maps`), the tiles' unit double-angle field
    u2 = D2 / (|D2| + 1e-9), and the reweighted pass
    (:func:`reweighted_moments`). Returns (S, Sx, Sy, Sxx, Syy, Sxy, D2x,
    D2y), each (N, Th, Tw). On CUDA tensors one ``lines_tile_moments``
    launch: the planes and the field stay inside it, and its maps are the
    bits of the four-step chain on the card."""
    stride = tile // 2
    if tile != 2 * stride:
        raise ValueError(f"tile_moments: the tile ({tile}) must be even")
    if img.device.type == "cpu":
        return tile_moments_plain(img, tile, grad_th, u8_wrap)
    N, H, W = img.shape
    native.require(img, "tile_moments", torch.float32)
    Th, Tw = tile_grid(H, W, tile)
    if Th < 1 or Tw < 1:
        raise ValueError(f"tile_moments: {H}x{W} images hold no {tile}-pixel "
                         "window")
    out = torch.empty((8, N, Th, Tw), dtype=torch.float32, device=img.device)
    native.launch("lines_tile_moments", img, out, N, H, W, Th, Tw, stride,
                  grad_th, int(u8_wrap))
    return tuple(out.unbind(0))


# -- gates (the plain version of kernel F's first pass) -----------------------

def principal_axis(sxx, syy, sxy):
    """Closed-form eigen-decomposition of [[sxx, sxy], [sxy, syy]]:
    (l1, l2, nx, ny) with l1 >= l2 and (nx, ny) the unit l1-eigenvector."""
    tr = sxx + syy
    diff = sxx - syy
    disc = sqrt_rn(diff * diff + 4.0 * sxy * sxy + 1e-20)
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    big = torch.abs(sxy) > 1e-12
    vx = torch.where(big, sxy, l1 - syy)
    vy = torch.where(big, l1 - sxx, torch.zeros_like(sxy) + 1e-12)
    n = sqrt_rn(vx * vx + vy * vy + 1e-20)
    return l1, l2, vx / n, vy / n


def tile_gates(S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, tile: int,
               min_support: float, elong_th: float, perp_spread_th: float,
               coherence_th: float):
    """Per-tile gates of the reweighted moments (reference ``tile_stage``
    :377-414). Returns (tile_ok, angle, cx, cy, dx, dy, cx_l, cy_l, l1)."""
    stride = tile // 2
    N, Th, Tw = S.shape
    S_safe = torch.clamp(S, min=1e-6)
    cx_l = Sx / S_safe
    cy_l = Sy / S_safe
    cxx = Sxx / S_safe - cx_l * cx_l
    cyy = Syy / S_safe - cy_l * cy_l
    cxy = Sxy / S_safe - cx_l * cy_l
    jj = torch.arange(Tw, dtype=torch.float32, device=S.device)
    ii = torch.arange(Th, dtype=torch.float32, device=S.device)
    cx = cx_l + float(stride) * jj[None, None, :]
    cy = cy_l + float(stride) * ii[None, :, None]
    l1, l2, dx, dy = principal_axis(cxx, cyy, cxy)
    l1 = torch.clamp(l1, min=0.0)
    l2 = torch.clamp(l2, min=0.0)
    elong = sqrt_rn(l1 / torch.clamp(l2, min=1e-4))
    perp_spread = sqrt_rn(l2)
    dn = sqrt_rn(D2x * D2x + D2y * D2y)
    coher = dn / S_safe
    nx, ny = -dy, dx
    n2x = nx * nx - ny * ny
    n2y = 2.0 * nx * ny
    align = (D2x * n2x + D2y * n2y) / torch.clamp(dn, min=1e-6)
    tile_ok = ((S > min_support * tile)
               & (elong > elong_th)
               & (perp_spread < perp_spread_th)
               & (coher > coherence_th)
               & (align > coherence_th))
    flip = dx < 0
    dx = torch.where(flip, -dx, dx)
    dy = torch.where(flip, -dy, dy)
    angle = torch.atan2(dy, dx)
    return tile_ok, angle, cx, cy, dx, dy, cx_l, cy_l, l1


# -- kernel F: gates and collinear min-label propagation ----------------------

_NEIGH = ((0, 1), (1, 0), (1, 1), (1, -1))


def _shift_pad(a: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """out[:, i, j] = a[:, i + di, j + dj], ``fill`` outside the grid."""
    Th, Tw = a.shape[-2:]
    out = torch.full_like(a, fill)
    out[:, max(-di, 0):Th + min(-di, 0), max(-dj, 0):Tw + min(-dj, 0)] = \
        a[:, max(di, 0):Th + min(di, 0), max(dj, 0):Tw + min(dj, 0)]
    return out


def propagate_labels_plain(tile_ok, angle, cx, cy, dx, dy,
                           merge_ang_th: float, merge_dist_th: float,
                           iters: int):
    N, Th, Tw = tile_ok.shape
    n = Th * Tw
    ang_th, dist_th = merge_ang_th, merge_dist_th

    def compatible(di, dj):
        ok_n = _shift_pad(tile_ok, di, dj, False)
        ang_n = _shift_pad(angle, di, dj, 0.0)
        cx_n = _shift_pad(cx, di, dj, 0.0)
        cy_n = _shift_pad(cy, di, dj, 0.0)
        off = torch.abs(-dy * (cx_n - cx) + dx * (cy_n - cy))
        return (tile_ok & ok_n & (dang(angle, ang_n) < ang_th)
                & (off < dist_th))

    comp = [compatible(*d) for d in _NEIGH]
    rev = [_shift_pad(c, -di, -dj, False) for c, (di, dj) in zip(comp, _NEIGH)]
    BIG = n + 7
    idx0 = torch.arange(n, dtype=torch.int32, device=tile_ok.device)
    lab = torch.where(tile_ok, idx0.reshape(Th, Tw), BIG).to(torch.int32)
    for _ in range(iters):
        new = lab
        for c, r, (di, dj) in zip(comp, rev, _NEIGH):
            new = torch.where(c, torch.minimum(new, _shift_pad(lab, di, dj,
                                                               BIG)), new)
            new = torch.where(r, torch.minimum(new, _shift_pad(lab, -di, -dj,
                                                               BIG)), new)
        flat = new.reshape(N, n)
        inside = flat < n
        tgt = torch.where(inside, flat, 0).long()
        hop = torch.gather(flat, 1, tgt)
        lab = torch.where(inside, torch.minimum(flat, hop), flat).reshape(
            N, Th, Tw)
    return lab


def propagate_labels(tile_ok, angle, cx, cy, dx, dy, merge_ang_th: float,
                     merge_dist_th: float, iters: int) -> torch.Tensor:
    """Connected components of compatible 8-neighbour tiles: ``iters``
    synchronous sweeps of min-label propagation, each followed by one
    pointer hop (label <- label[label]). Gated-out tiles carry Th*Tw + 7.
    Returns (N, Th, Tw) int32. CPU tensors only: on the card the labels
    are part of the one launch of :func:`gates_and_labels`."""
    if tile_ok.device.type != "cpu":
        raise ValueError("propagate_labels runs on CPU tensors only; on "
                         "CUDA tensors use gates_and_labels")
    return propagate_labels_plain(tile_ok, angle, cx, cy, dx, dy,
                                  merge_ang_th, merge_dist_th, iters)


# tiles an image that the lines_label kernel takes: its last CTA of an
# image holds 9 bytes and a bit a tile in shared memory
# (csrc/lines_label.cu; tests/test_torch_lines.py checks the sum)
LABEL_MAX_TILES = 25466
# lines_label's per-image counters of finished slices, one zeroed buffer a
# device: each launch leaves them at 0 (calls on one stream at a time)
_LABEL_COUNTS = {}


def _label_counts(device, N: int) -> torch.Tensor:
    buf = _LABEL_COUNTS.get(device)
    if buf is None or buf.numel() < N:
        buf = torch.zeros(max(N, 64), dtype=torch.int32, device=device)
        _LABEL_COUNTS[device] = buf
    return buf


def gates_and_labels_plain(S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, tile: int,
                           min_support: float, elong_th: float,
                           perp_spread_th: float, coherence_th: float,
                           merge_ang_th: float, merge_dist_th: float,
                           iters: int):
    """See :func:`gates_and_labels`: :func:`tile_gates`, then
    :func:`propagate_labels_plain`."""
    tile_ok, angle, cx, cy, dx, dy, cx_l, cy_l, l1 = tile_gates(
        S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, tile, min_support, elong_th,
        perp_spread_th, coherence_th)
    labels = propagate_labels_plain(tile_ok, angle, cx, cy, dx, dy,
                                    merge_ang_th, merge_dist_th, iters)
    return tile_ok, cx, cy, cx_l, cy_l, l1, labels


def gates_and_labels(S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, tile: int,
                     min_support: float, elong_th: float,
                     perp_spread_th: float, coherence_th: float,
                     merge_ang_th: float, merge_dist_th: float, iters: int):
    """The per-tile gates of the reweighted window moments
    (:func:`tile_gates`) and the component labels over the gated tiles
    (:func:`propagate_labels`). Returns (tile_ok bool, cx, cy, cx_l, cy_l,
    l1, labels int32), each (N, Th, Tw). On CUDA tensors one
    ``lines_label`` launch (at most :data:`LABEL_MAX_TILES` tiles an
    image); the tiles' angle and direction stay inside it."""
    if S.device.type == "cpu":
        return gates_and_labels_plain(
            S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, tile, min_support, elong_th,
            perp_spread_th, coherence_th, merge_ang_th, merge_dist_th, iters)
    N, Th, Tw = S.shape
    if Th * Tw > LABEL_MAX_TILES:
        raise ValueError(f"gates_and_labels: {Th}x{Tw} tiles an image, the "
                         f"kernel takes at most {LABEL_MAX_TILES}")
    planes = [t.contiguous() for t in (S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y)]
    for t in planes:
        native.require(t, "gates_and_labels", torch.float32, (N, Th, Tw))
    tile_ok = torch.empty((N, Th, Tw), dtype=torch.bool, device=S.device)
    out = torch.empty((5, N, Th, Tw), dtype=torch.float32, device=S.device)
    labels = torch.empty((N, Th, Tw), dtype=torch.int32, device=S.device)
    # scratch: the gated-in tiles' angle, dx, dy; tile_ok as bits
    scratch = torch.empty((N, 3, Th, Tw), dtype=torch.float32,
                          device=S.device)
    bits = torch.empty((N, (Th * Tw + 31) // 32), dtype=torch.int32,
                       device=S.device)
    native.launch("lines_label", *planes, tile_ok.view(torch.uint8),
                  *out.unbind(0), labels, scratch, bits,
                  _label_counts(S.device, N), N, Th, Tw, tile // 2,
                  min_support * tile, elong_th, perp_spread_th,
                  coherence_th, merge_ang_th, merge_dist_th, iters)
    return (tile_ok, *out.unbind(0), labels)


def tile_stage(img: torch.Tensor, tile: int = 16, grad_th: float = 0.02,
               min_support: float = 1.0, elong_th: float = 2.5,
               perp_spread_th: float = 2.2, coherence_th: float = 0.6,
               merge_iters: int = 8, merge_ang_th: float = 0.1,
               merge_dist_th: float = 2.0, u8_wrap: bool = False
               ) -> TileStage:
    """Gradients, gated tile moments, connected-component labels."""
    S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y = tile_moments(img, tile, grad_th,
                                                      u8_wrap)
    tile_ok, cx, cy, cx_l, cy_l, l1, labels = gates_and_labels(
        S, Sx, Sy, Sxx, Syy, Sxy, D2x, D2y, tile, min_support, elong_th,
        perp_spread_th, coherence_th, merge_ang_th, merge_dist_th,
        merge_iters)
    return TileStage(labels=labels, tile_ok=tile_ok, S=S, Sx=Sx, Sy=Sy,
                     Sxx=Sxx, Syy=Syy, Sxy=Sxy, cx=cx, cy=cy, cx_l=cx_l,
                     cy_l=cy_l, l1=l1)


# -- kernel G launch 1: per-root refit ----------------------------------------------

def refit_plain(root_id, lab, payload, cx, cy, he, H: int, W: int,
                len_th: float):
    """See :func:`refit`; member sums by ``index_add_`` in tile order."""
    N, R = root_id.shape
    n = lab.shape[1]
    dev = lab.device
    x0, y0 = 0.5 * W, 0.5 * H
    # tile -> root slot (-1: no root); root ids are distinct tile indices
    slot_of = torch.full((N, n + 1), -1, dtype=torch.long, device=dev)
    rid = torch.where(root_id >= 0, root_id, n).long()
    slot_of.scatter_(1, rid, torch.arange(R, device=dev).expand(N, R))
    slot_of[:, n] = -1
    lab_l = lab.long()
    slot = torch.gather(slot_of, 1, torch.where(lab_l < n, lab_l, n))
    member = slot >= 0
    gslot = (torch.arange(N, device=dev)[:, None] * R + slot)[member]
    agg = torch.zeros((N * R, 7), dtype=torch.float32, device=dev)
    agg.index_add_(0, gslot, payload[member])
    mS, mSx, mSy, mSxx, mSyy, mSxy, owns = agg.reshape(N, R, 7).unbind(-1)
    mS_safe = torch.clamp(mS, min=1e-6)
    mcx = mSx / mS_safe
    mcy = mSy / mS_safe
    mcxx = mSxx / mS_safe - mcx * mcx
    mcyy = mSyy / mS_safe - mcy * mcy
    mcxy = mSxy / mS_safe - mcx * mcy
    _, _, mdx, mdy = principal_axis(mcxx, mcyy, mcxy)
    off = (mdx * mcx + mdy * mcy).reshape(-1)
    fdx, fdy = mdx.reshape(-1)[gslot], mdy.reshape(-1)[gslot]
    pc = (cx - x0)[member] * fdx + (cy - y0)[member] * fdy - off[gslot]
    hm = he[member]
    pmin = torch.full((N * R,), INF, device=dev).scatter_reduce(
        0, gslot, pc - hm, "amin")
    pmax = torch.full((N * R,), -INF, device=dev).scatter_reduce(
        0, gslot, pc + hm, "amax")
    pmin, pmax = pmin.reshape(N, R), pmax.reshape(N, R)
    root_ok = (root_id >= 0) & (mS > 0) & (owns > 0)
    length = torch.where(root_ok, pmax - pmin, 0.0)
    seg_ok = root_ok & (length > len_th)
    sp = torch.stack([mcx + x0 + pmin * mdx, mcy + y0 + pmin * mdy], -1)
    ep = torch.stack([mcx + x0 + pmax * mdx, mcy + y0 + pmax * mdy], -1)
    return sp, ep, torch.where(seg_ok, mS, 0.0)


def refit(ts: TileStage, root_id: torch.Tensor, H: int, W: int,
          len_th: float):
    """Per root slot: sum the payload (S and image-centre moments, ones;
    zero off the gates) of its member tiles (label == root id), take the
    principal axis, and the min/max projection of the members' centroids
    -+ their half-extent. root_id (N, R) int32 (-1 empty). Returns sp, ep
    (N, R, 2) and score (N, R), the support mass where the segment is
    longer than ``len_th``, else 0. On CUDA tensors one ``lines_refit``
    launch reads the TileStage planes and builds the payload itself."""
    if ts.labels.device.type == "cpu":
        return refit_plain(root_id, *tile_payload(ts, H, W), H, W, len_th)
    N, Th, Tw = ts.labels.shape
    R = root_id.shape[1]
    lab, ok = ts.labels.contiguous(), ts.tile_ok.contiguous()
    native.require(lab, "refit labels", torch.int32, (N, Th, Tw))
    native.require(ok, "refit tile_ok", torch.bool, (N, Th, Tw))
    native.require(root_id, "refit root_id", torch.int32, (N, R))
    planes = [p.contiguous() for p in ts[2:]]
    for p in planes:
        native.require(p, "refit", torch.float32, (N, Th, Tw))
    sp = torch.empty((N, R, 2), dtype=torch.float32, device=lab.device)
    ep = torch.empty_like(sp)
    score = torch.empty((N, R), dtype=torch.float32, device=lab.device)
    native.launch("lines_refit", root_id, lab, ok, *planes, sp, ep, score,
                  N, R, Th * Tw, 0.5 * W, 0.5 * H, len_th)
    return sp, ep, score


def root_ids(ts: TileStage, max_lines: int) -> torch.Tensor:
    """The top-R root ids by own-tile mass, R = min(8 max_lines, n); -1
    empty (a stable sort, as ``lax.top_k``). (N, R) int32."""
    N, Th, Tw = ts.labels.shape
    n = Th * Tw
    lab = ts.labels.reshape(N, n)
    ids = torch.arange(n, dtype=torch.int32, device=lab.device)
    is_root = ts.tile_ok.reshape(N, n) & (lab == ids)
    r_s, r_ids = top_k(torch.where(is_root, ts.S.reshape(N, n), -1.0),
                       min(8 * max_lines, n))
    return torch.where(r_s > 0, r_ids, -1).to(torch.int32)


def tile_payload(ts: TileStage, H: int, W: int):
    """The plain refit's per-tile inputs: the flat labels, the payload (S
    and the moments shifted to the image centre, ones; zero off the
    gates), the centroids and each tile's half-extent."""
    N, Th, Tw = ts.labels.shape
    n = Th * Tw
    flat = lambda a: a.reshape(N, n)
    x0, y0 = 0.5 * W, 0.5 * H
    dxc = flat(ts.cx) - flat(ts.cx_l) - x0
    dyc = flat(ts.cy) - flat(ts.cy_l) - y0
    fS, fSx, fSy = flat(ts.S), flat(ts.Sx), flat(ts.Sy)
    payload = torch.stack([
        fS, fSx + dxc * fS, fSy + dyc * fS,
        flat(ts.Sxx) + 2.0 * dxc * fSx + dxc * dxc * fS,
        flat(ts.Syy) + 2.0 * dyc * fSy + dyc * dyc * fS,
        flat(ts.Sxy) + dyc * fSx + dxc * fSy + dxc * dyc * fS,
        torch.ones_like(fS)], dim=-1)
    payload = torch.where(flat(ts.tile_ok)[..., None], payload, 0.0)
    he = sqrt_rn(torch.clamp(12.0 * flat(ts.l1), min=0.0)) * 0.5
    return flat(ts.labels), payload, flat(ts.cx), flat(ts.cy), he


def refit_inputs(ts: TileStage, H: int, W: int, max_lines: int):
    """``refit_plain``'s arguments: the root ids and ``tile_payload``."""
    return (root_ids(ts, max_lines),) + tile_payload(ts, H, W)


def refit_roots(ts: TileStage, H: int, W: int, tile: int, max_lines: int,
                min_length: float):
    """Top 2*max_lines candidate segments (sp, ep (N, M, 2), score (N, M);
    score 0 marks an empty slot) from the tile components."""
    sp, ep, score = refit(ts, root_ids(ts, max_lines), H, W,
                          min(0.75 * tile + tile // 2, min_length))
    c_s, c_i = top_k(score, 2 * max_lines)
    return take(sp, c_i), take(ep, c_i), c_s


# -- kernel G launch 2: segment-level collinear merge ------------------------------

def _segment_table(sp, ep, score, valid):
    """Per-segment quantities of ``merge_segments`` (N, M, 13): sp, ep,
    mid, canonical unit direction, half length, angle, and the refit
    weights w, w cos 2a, w sin 2a."""
    mid = 0.5 * (sp + ep)
    d = ep - sp
    length = sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                        + 1e-12)
    du = d / length[..., None]
    du = torch.where((du[..., 0] < 0)[..., None], -du, du)
    ang = torch.atan2(du[..., 1], du[..., 0])
    w = torch.where(valid, score, 0.0)
    return torch.cat([sp, ep, mid, du, (0.5 * length)[..., None],
                      ang[..., None], w[..., None],
                      (w * torch.cos(2.0 * ang))[..., None],
                      (w * torch.sin(2.0 * ang))[..., None]], dim=-1)


def merge_plain(seg, valid, ang_th: float, dist_th: float, gap_th: float,
                iters: int):
    N, M, _ = seg.shape
    sp, ep, mid, du = seg[..., 0:2], seg[..., 2:4], seg[..., 4:6], seg[..., 6:8]
    half, ang, w, wc2, ws2 = seg.unbind(-1)[8:]
    da = dang(ang[:, :, None], ang[:, None, :])
    rel0 = mid[:, None, :, 0] - mid[:, :, None, 0]      # mid_j - mid_i
    rel1 = mid[:, None, :, 1] - mid[:, :, None, 1]
    du0, du1 = du[..., 0, None], du[..., 1, None]
    off = torch.abs(-du1 * rel0 + du0 * rel1)
    pm = du0 * rel0 + du1 * rel1
    gap = torch.abs(pm) - (half[:, :, None] + half[:, None, :])
    ok = ((da < ang_th) & (off < dist_th) & (gap < gap_th)
          & valid[:, :, None] & valid[:, None, :])
    ok = ok & ok.transpose(1, 2)
    ar = torch.arange(M, dtype=torch.int32, device=seg.device)
    lab = torch.where(valid, ar, M).to(torch.int32)
    for _ in range(iters):
        cand = torch.where(ok, lab[:, None, :], M)
        lab = torch.minimum(lab, cand.min(dim=2).values)
        lab = torch.minimum(lab, torch.gather(
            lab, 1, torch.clamp(lab, 0, M - 1).long()))
    Rf = ((lab[:, None, :] == ar[None, :, None])
          & valid[:, None, :]).to(torch.float32)            # (N, root, j)
    wsum = (Rf @ w[..., None])[..., 0]
    c2 = (Rf @ wc2[..., None])[..., 0]
    s2 = (Rf @ ws2[..., None])[..., 0]
    ang_m = 0.5 * torch.atan2(s2, c2)
    dm = torch.stack([torch.cos(ang_m), torch.sin(ang_m)], -1)
    cen = (Rf @ (w[..., None] * mid)) / torch.clamp(wsum, min=1e-6
                                                    )[..., None]
    dcen = (dm * cen).sum(-1)[..., None]
    proj_sp = dm @ sp.transpose(1, 2) - dcen
    proj_ep = dm @ ep.transpose(1, 2) - dcen
    mem = Rf > 0
    lo = torch.minimum(torch.where(mem, proj_sp, INF),
                       torch.where(mem, proj_ep, INF)).min(dim=2).values
    hi = torch.maximum(torch.where(mem, proj_sp, -INF),
                       torch.where(mem, proj_ep, -INF)).max(dim=2).values
    is_root = valid & (lab == ar) & (wsum > 0)
    sp_m = cen + lo[..., None] * dm
    ep_m = cen + hi[..., None] * dm
    return sp_m, ep_m, ang_m, torch.where(is_root, wsum, 0.0), is_root, lab


def merge_segments(sp, ep, score, valid, ang_th: float, dist_th: float,
                   gap_th: float, iters: int = 8):
    """Collinear segment-level merge of (N, M) candidates: compatibility
    (angle mod pi, mutual perpendicular midpoint offset, projection gap),
    ``iters`` sweeps of label-min propagation with a pointer hop, then a
    support-weighted double-angle refit per root. On CUDA tensors one
    ``lines_merge`` launch, which builds the segment table itself.

    Returns (sp, ep (N, M, 2), angle, score (N, M), is_root, labels)."""
    if sp.device.type == "cpu":
        return merge_plain(_segment_table(sp, ep, score, valid), valid,
                           ang_th, dist_th, gap_th, iters)
    N, M = score.shape
    sp, ep, valid = sp.contiguous(), ep.contiguous(), valid.contiguous()
    if score.stride(-1) != 1:
        score = score.contiguous()
    for t in (sp, ep):
        native.require(t, "merge_segments", torch.float32, (N, M, 2))
    native.require(valid, "merge_segments valid", torch.bool, (N, M))
    if score.dtype != torch.float32:
        raise ValueError(f"merge_segments: expected float32 scores, got "
                         f"{score.dtype}")
    sp_m = torch.empty((N, M, 2), dtype=torch.float32, device=sp.device)
    ep_m = torch.empty_like(sp_m)
    ang_m = torch.empty((N, M), dtype=torch.float32, device=sp.device)
    score_m = torch.empty_like(ang_m)
    root = torch.empty((N, M), dtype=torch.bool, device=sp.device)
    lab = torch.empty((N, M), dtype=torch.int32, device=sp.device)
    native.launch("lines_merge", sp, ep, score, valid, sp_m, ep_m, ang_m,
                  score_m, root, lab, N, M, score.stride(0), ang_th, dist_th,
                  gap_th, iters)
    return sp_m, ep_m, ang_m, score_m, root, lab


def detect_segments(img: torch.Tensor, max_lines: int, tile: int = 16,
                    grad_th: float = 0.02, min_support: float = 1.0,
                    elong_th: float = 2.5, perp_spread_th: float = 2.2,
                    coherence_th: float = 0.6, merge_iters: int = 8,
                    merge_ang_th: float = 0.1, merge_dist_th: float = 2.0,
                    merge_gap_th: float = 14.0,
                    min_length: float = 12.0, u8_wrap: bool = False
                    ) -> Segments:
    """Up to ``max_lines`` segments in each of N (H, W) images
    (``u8_wrap`` as ``image.sobel_gradients``)."""
    H, W = img.shape[-2:]
    ts = tile_stage(img, tile=tile, grad_th=grad_th, min_support=min_support,
                    elong_th=elong_th, perp_spread_th=perp_spread_th,
                    coherence_th=coherence_th, merge_iters=merge_iters,
                    merge_ang_th=merge_ang_th, merge_dist_th=merge_dist_th,
                    u8_wrap=u8_wrap)
    sp_c, ep_c, c_s = refit_roots(ts, H, W, tile, max_lines, min_length)
    sp_m, ep_m, ang_m, score_m, v_m, _ = merge_segments(
        sp_c, ep_c, c_s, c_s > 0.0, ang_th=2.0 * merge_ang_th,
        dist_th=merge_dist_th, gap_th=merge_gap_th)
    dm = ep_m - sp_m
    len_m = sqrt_rn(dm[..., 0] ** 2 + dm[..., 1] ** 2)
    score_m = torch.where(v_m & (len_m > min_length), score_m, 0.0)
    top_s, top_i = top_k(score_m, max_lines)
    hi = torch.tensor([W - 1.0, H - 1.0], device=img.device)
    sp_f = torch.minimum(torch.clamp(take(sp_m, top_i), min=0.0), hi)
    ep_f = torch.minimum(torch.clamp(take(ep_m, top_i), min=0.0), hi)
    return Segments(sp=sp_f, ep=ep_f, angle=take(ang_m, top_i), score=top_s,
                    valid=top_s > 0.0)
