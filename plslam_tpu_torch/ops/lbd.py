"""Line Band Descriptor bits (kernel H, K12).

Port of ``plslam_tpu/ops/lbd.py::describe_lines`` with the sampling of
``plslam_tpu/ops/image.py::bilinear_sample_mxu_multi``. Around each
segment a grid of ``n_samples`` points along and ``n_bands *
samples_per_band`` across samples both Sobel maps bilinearly; the samples
are rotated into the line frame, their positive and negative parts summed
per band, the 4 * n_bands statistics L2-normalised, and 256 fixed pairs
compared. The reference samples through a bf16 matmul: the gradient maps
and the x hat weights are rounded to bf16, their products summed in f32
and then weighted by the f32 y hat weights. Both versions here round the
same way, so the bits agree with the reference's. Every sum runs in one
fixed order (band sums over samples along, then across; the norm over the
statistics in order), in the plain version and in the kernel alike.

Batched: images (N, H, W) and endpoints (N, L, 2) -> bits (N, L, 256)
(``describe_lines_image``, the path's entry: the Sobel maps are formed
inside the launch, as the reference's ``describe_lines`` forms them when
it is given none), or the Sobel maps and endpoints (``describe_lines``).
On CUDA tensors the hand-written kernel of ``csrc/lbd.cu`` runs, one
launch either way; the plain versions run only for CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.ops.image import _on, sobel_gradients_plain
from plslam_tpu_torch.ops.lines import sqrt_rn

N_BITS = 256


@lru_cache(maxsize=4)
def _make_pairs(n_features: int) -> np.ndarray:
    """The reference's fixed comparison pairs: every within-statistic
    band pair first, then seeded random pairs up to 256."""
    rng = np.random.default_rng(7)
    pairs = np.empty((N_BITS, 2), np.int32)
    k = 0
    nb = n_features // 4
    for s in range(4):
        for i in range(nb):
            for j in range(i + 1, nb):
                if k < N_BITS:
                    pairs[k] = (s * nb + i, s * nb + j)
                    k += 1
    while k < N_BITS:
        i, j = rng.integers(0, n_features, 2)
        if i != j:
            pairs[k] = (i, j)
            k += 1
    return pairs


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace`` in f32 as it runs inside ``jit``, where XLA turns
    the division by ``div`` into a product with its reciprocal r and
    reassociates ``stop * (i r)`` into ``i (stop r)``:
    start (1 - i r) + i (stop r), then the exact endpoint."""
    f32 = np.float32
    i = np.arange(num - 1, dtype=f32)
    r = f32(f32(1) / f32(num - 1))
    out = f32(start) * (f32(1) - i * r) + i * f32(f32(stop) * r)
    return np.concatenate([out, [f32(stop)]]).astype(f32)


@lru_cache(maxsize=16)
def sample_grid(n_bands: int, band_width: int, n_samples: int,
                samples_per_band: int) -> Tuple[np.ndarray, np.ndarray]:
    """(t along in [0, 1], o across in px) as the reference builds them."""
    half = 0.5 * n_bands * band_width
    t = _linspace_f32(0.0, 1.0, n_samples)
    o = _linspace_f32(-half + 0.5, half - 0.5, n_bands * samples_per_band)
    return t, o


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def sample_bf16(gx: torch.Tensor, gy: torch.Tensor, px: torch.Tensor,
                py: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``bilinear_sample_mxu_multi`` of (gx, gy) (N, H, W) at (N, ...)
    positions, with its rounding: bf16 maps and x hat weights, f32 sums,
    f32 y hat weights."""
    N, H, W = gx.shape
    x = torch.clamp(px, 0.0, W - 1.001)
    y = torch.clamp(py, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx0 = _bf16(torch.clamp(1.0 - torch.abs(x - x0), min=0.0))
    wx1 = _bf16(torch.clamp(1.0 - torch.abs(x - (x0 + 1.0)), min=0.0))
    wy0 = torch.clamp(1.0 - torch.abs(y - y0), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(y - (y0 + 1.0)), min=0.0)
    xi, yi = x0.long(), y0.long()

    def sample(g):
        flat = _bf16(g).reshape(N, H * W)

        def at(r, c):
            return torch.gather(flat, 1, (r * W + c).reshape(N, -1)
                                ).reshape(r.shape)

        c0 = at(yi, xi) * wx0 + at(yi, xi + 1) * wx1
        c1 = at(yi + 1, xi) * wx0 + at(yi + 1, xi + 1) * wx1
        return c0 * wy0 + c1 * wy1

    return sample(gx), sample(gy)


def line_features_plain(gx, gy, sp, ep, n_bands: int, band_width: int,
                        n_samples: int, samples_per_band: int
                        ) -> torch.Tensor:
    """The L2-normalised band statistics (N, L, 4 * n_bands) that the
    descriptor bits compare: [par+, par-, perp+, perp-] per band."""
    N, L = sp.shape[:2]
    t_np, o_np = sample_grid(n_bands, band_width, n_samples, samples_per_band)
    t = torch.from_numpy(t_np).to(gx.device)
    o = torch.from_numpy(o_np).to(gx.device)
    d = ep - sp
    length = sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                     + 1e-12)
    dx, dy = d[..., 0] / length, d[..., 1] / length
    nx, ny = -dy, dx
    # sample grid (N, L, S, A)
    px = ((sp[..., 0, None] + d[..., 0, None] * t)[..., None]
          + (nx[..., None] * o)[..., None, :])
    py = ((sp[..., 1, None] + d[..., 1, None] * t)[..., None]
          + (ny[..., None] * o)[..., None, :])
    gxs, gys = sample_bf16(gx, gy, px, py)
    g_par = gxs * dx[..., None, None] + gys * dy[..., None, None]
    g_perp = gxs * nx[..., None, None] + gys * ny[..., None, None]

    def band_stats(g):
        g = g.reshape(N, L, n_samples, n_bands, samples_per_band)
        pos = torch.zeros((N, L, n_bands), dtype=g.dtype, device=g.device)
        neg = torch.zeros_like(pos)
        for s in range(n_samples):
            for k in range(samples_per_band):
                v = g[:, :, s, :, k]
                pos = pos + torch.clamp(v, min=0.0)
                neg = neg + torch.clamp(-v, min=0.0)
        return pos, neg

    pp, pn = band_stats(g_par)
    qp, qn = band_stats(g_perp)
    feats = torch.cat([pp, pn, qp, qn], dim=-1)
    sq = torch.zeros_like(feats[..., 0])
    for i in range(feats.shape[-1]):
        sq = sq + feats[..., i] * feats[..., i]
    return feats / torch.clamp(sqrt_rn(sq), min=1e-9
                               )[..., None]


def describe_lines_plain(gx, gy, sp, ep, n_bands: int, band_width: int,
                         n_samples: int, samples_per_band: int):
    feats = line_features_plain(gx, gy, sp, ep, n_bands, band_width,
                                n_samples, samples_per_band)
    pairs = torch.from_numpy(_make_pairs(4 * n_bands)).long().to(gx.device)
    return (feats[..., pairs[:, 0]] < feats[..., pairs[:, 1]]).to(torch.uint8)


def describe_lines_image_plain(img, sp, ep, n_bands: int, band_width: int,
                               n_samples: int, samples_per_band: int,
                               u8_wrap: bool = False):
    """``describe_lines_plain`` on the image's Sobel maps."""
    gx, gy = sobel_gradients_plain(img, u8_wrap)
    return describe_lines_plain(gx, gy, sp, ep, n_bands, band_width,
                                n_samples, samples_per_band)


def _launch(img, gx, gy, sp, ep, n_bands, band_width, n_samples,
            samples_per_band, u8_wrap):
    """One ``lbd_describe`` launch: from the image ``img``, or (img None)
    from the Sobel maps ``gx``, ``gy``."""
    ref = gx if img is None else img
    N, H, W = ref.shape
    L = sp.shape[1]
    if 4 * n_bands > 64 or min(H, W) < 2:
        raise ValueError(f"describe_lines: no launch for {n_bands} bands "
                         f"on {H}x{W}")
    sp = sp.contiguous()
    ep = ep.contiguous()
    native.require(sp, "describe_lines sp", torch.float32, (N, L, 2))
    native.require(ep, "describe_lines ep", torch.float32, (N, L, 2))
    t, o = sample_grid(n_bands, band_width, n_samples, samples_per_band)
    pairs = _make_pairs(4 * n_bands).astype(np.uint8)
    bits = torch.empty((N, L, N_BITS), dtype=torch.uint8, device=ref.device)
    native.launch("lbd_describe", img, gx, gy, sp, ep, _on(t, ref.device),
                  _on(o, ref.device), _on(pairs, ref.device), bits, N, L, H,
                  W, n_samples, n_bands, samples_per_band, W - 1.001,
                  H - 1.001, int(u8_wrap))
    return bits


def describe_lines_image(img: torch.Tensor, sp: torch.Tensor,
                         ep: torch.Tensor, n_bands: int = 9,
                         band_width: int = 7, n_samples: int = 24,
                         samples_per_band: int = 2, u8_wrap: bool = False
                         ) -> torch.Tensor:
    """Images (N, H, W) and segment endpoints (N, L, 2) in their pixel
    coordinates -> (N, L, 256) uint8 descriptor bits, sampling the images'
    Sobel maps (``u8_wrap`` as ``image.sobel_gradients``): one launch that
    forms the maps' taps from the image itself."""
    if img.device.type == "cpu":
        return describe_lines_image_plain(img, sp, ep, n_bands, band_width,
                                          n_samples, samples_per_band,
                                          u8_wrap)
    native.require(img, "describe_lines img", torch.float32)
    return _launch(img, None, None, sp, ep, n_bands, band_width, n_samples,
                   samples_per_band, u8_wrap)


def describe_lines(gx: torch.Tensor, gy: torch.Tensor, sp: torch.Tensor,
                   ep: torch.Tensor, n_bands: int = 9, band_width: int = 7,
                   n_samples: int = 24, samples_per_band: int = 2
                   ) -> torch.Tensor:
    """Sobel maps (N, H, W) and segment endpoints (N, L, 2) in the maps'
    pixel coordinates -> (N, L, 256) uint8 descriptor bits (the same
    kernel, reading the maps' taps)."""
    if gx.device.type == "cpu":
        return describe_lines_plain(gx, gy, sp, ep, n_bands, band_width,
                                    n_samples, samples_per_band)
    native.require(gx, "describe_lines gx", torch.float32)
    native.require(gy, "describe_lines gy", torch.float32, tuple(gx.shape))
    return _launch(None, gx, gy, sp, ep, n_bands, band_width, n_samples,
                   samples_per_band, False)
