"""Separable filters, bilinear resize, pyramids (kernel A, K3) and Sobel
gradients (kernel E launch 1, K4).

Port of ``plslam_tpu/ops/image.py`` (``separable_filter2d``,
``gaussian_blur``, ``resize_bilinear``, ``build_pyramid``,
``sobel_gradients``). The reference
runs each as banded-matrix products ``Mr @ img @ Mc^T``; here a vertical
pass then a horizontal pass compute what those matrices hold: an
edge-replicate correlation, and align_corners=False bilinear weights with
the reference's exact index clamping. On CUDA tensors both run as the
hand-written kernels of ``csrc/image.cu``, each in one pass (the filter
also in a paired mode: two tap sets over one input, ORB's moment maps);
the plain PyTorch versions below run only for CPU tensors.

Every function takes a batch: images are (N, H, W) f32.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch

from plslam_tpu_torch import native

# device copies of the small tap / index tables, one per (table, device)
_TABLES: Dict[tuple, torch.Tensor] = {}
# image_resize's packed tap tables, one per (H, Ho, W, Wo, device)
_RESIZE_TABLES: Dict[tuple, torch.Tensor] = {}


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        _TABLES[key] = t
    return t


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=256)
def _resize_taps(n_out: int, n_in: int) -> Tuple[np.ndarray, ...]:
    """Per output index: (i0, i1, w0, w1) of the reference's
    ``_resize_matrix`` row (align_corners=False), with its f32 rounding;
    where both taps clamp to one source the weights are merged as the
    matrix accumulates them."""
    i0 = np.zeros(n_out, np.int32)
    i1 = np.zeros(n_out, np.int32)
    w0 = np.zeros(n_out, np.float32)
    w1 = np.zeros(n_out, np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), n_in - 1)
        b = min(max(x0 + 1, 0), n_in - 1)
        row = np.zeros(n_in, np.float32)
        row[a] += 1.0 - f
        row[b] += f
        i0[i], w0[i] = a, row[a]
        if b != a:
            i1[i], w1[i] = b, row[b]
        else:
            i1[i] = a
    return i0, i1, w0, w1


def resize_table(H: int, Ho: int, W: int, Wo: int) -> np.ndarray:
    """The resize kernel's packed taps, (Ho + Wo, 4) int32: per output row
    (i0, i1, w0, w1) of ``_resize_taps(Ho, H)``, then per output column
    those of ``_resize_taps(Wo, W)``, the weights as their f32 bits."""
    def pack(taps):
        i0, i1, w0, w1 = taps
        return np.stack([i0, i1, w0.view(np.int32), w1.view(np.int32)], 1)
    return np.concatenate([pack(_resize_taps(Ho, H)),
                           pack(_resize_taps(Wo, W))])


# -- plain PyTorch versions (CPU tensors) -------------------------------------

def _filter_axis_plain(x: torch.Tensor, k: np.ndarray, dim: int
                       ) -> torch.Tensor:
    n = x.shape[dim]
    r = len(k) // 2
    out = torch.zeros_like(x)
    for t, kv in enumerate(k.tolist()):
        idx = torch.clamp(torch.arange(n, device=x.device) + t - r, 0, n - 1)
        out = out + float(np.float32(kv)) * torch.index_select(x, dim, idx)
    return out


def separable_filter2d_plain(img: torch.Tensor, kx: np.ndarray,
                             ky: np.ndarray) -> torch.Tensor:
    return _filter_axis_plain(_filter_axis_plain(img, ky, -2), kx, -1)


def _resize_axis_plain(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = (torch.from_numpy(a).to(x.device)
                      for a in _resize_taps(n_out, x.shape[dim]))
    shape = [1] * x.ndim
    shape[dim] = n_out
    return (w0.view(shape) * torch.index_select(x, dim, i0.long())
            + w1.view(shape) * torch.index_select(x, dim, i1.long()))


def resize_bilinear_plain(img: torch.Tensor, shape: Tuple[int, int]
                          ) -> torch.Tensor:
    return _resize_axis_plain(_resize_axis_plain(img, shape[0], -2),
                              shape[1], -1)


# -- kernel wrappers ------------------------------------------------------------

_MAX_RADIUS = 7      # the filter kernel's taps: 15 a set at most


def _filter_taps(sets) -> Tuple[np.ndarray, int]:
    """The filter kernel's taps of (kx, ky) sets: host f32 (2, 2, 16),
    [set][vertical, horizontal], each set centred at the launch's radius
    (the largest) and padded with zero taps; and that radius."""
    r = max(len(k) // 2 for kxy in sets for k in kxy)
    if r > _MAX_RADIUS or any(len(k) % 2 == 0 for kxy in sets for k in kxy):
        raise ValueError(f"separable_filter2d: odd tap counts up to "
                         f"{2 * _MAX_RADIUS + 1} on CUDA tensors")
    taps = np.zeros((2, 2, 16), np.float32)
    for f, (kx, ky) in enumerate(sets):
        for a, k in ((0, ky), (1, kx)):
            o = r - len(k) // 2
            taps[f, a, o:o + len(k)] = k
    return taps, r


def _filter_launch(img: torch.Tensor, sets, outs) -> None:
    """One launch of the filter kernel: ``outs`` (one or two (N, H*W) f32
    tensors whose rows may be columns of larger buffers) get ``img``
    filtered by each (kx, ky) of ``sets``."""
    N, H, W = img.shape
    native.require(img, "separable_filter2d", torch.float32)
    for o in outs:
        if (o.device != img.device or o.dtype != torch.float32
                or tuple(o.shape) != (N, H * W) or o.stride(1) != 1
                or o.stride(0) != outs[0].stride(0)):
            raise ValueError("separable_filter2d: outputs must be (N, H*W) "
                             "f32 rows on the input's device, one stride")
    if len(outs) == 2 and (outs[0].data_ptr() - outs[1].data_ptr()) % 16:
        raise ValueError("separable_filter2d_pair: the two outputs must "
                         "share their 16-byte alignment")
    taps, r = _filter_taps(sets)
    native.launch("image_sep_filter", img, outs[0],
                  outs[1] if len(outs) == 2 else None, taps.ctypes.data,
                  N, H, W, r, outs[0].stride(0))


def separable_filter2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray
                       ) -> torch.Tensor:
    """Separable 2D correlation with edge replication, (N, H, W) -> same.
    Vertical taps ``ky`` first, then horizontal ``kx`` (odd lengths)."""
    kx = np.asarray(kx, np.float32)
    ky = np.asarray(ky, np.float32)
    if img.device.type == "cpu":
        return separable_filter2d_plain(img, kx, ky)
    out = torch.empty_like(img)
    _filter_launch(img, [(kx, ky)], [out.view(img.shape[0], -1)])
    return out


def separable_filter2d_pair(img: torch.Tensor, kx_a, ky_a, kx_b, ky_b,
                            out_a: torch.Tensor, out_b: torch.Tensor
                            ) -> None:
    """``separable_filter2d(img, kx_a, ky_a)`` into ``out_a`` and
    ``separable_filter2d(img, kx_b, ky_b)`` into ``out_b``, (N, H*W) each
    (for example the columns of one level in an (N, sum of h*w) buffer),
    on CUDA tensors in one launch that reads ``img`` once; each output
    has the single filter's bits."""
    sets = [tuple(np.asarray(k, np.float32) for k in kxy)
            for kxy in ((kx_a, ky_a), (kx_b, ky_b))]
    if img.device.type == "cpu":
        N = img.shape[0]
        for (kx, ky), out in zip(sets, (out_a, out_b)):
            out.copy_(separable_filter2d_plain(img, kx, ky).reshape(N, -1))
        return
    _filter_launch(img, sets, [out_a, out_b])


def resize_bilinear(img: torch.Tensor, shape: Tuple[int, int]
                    ) -> torch.Tensor:
    """(N, H, W) -> (N, h, w) bilinear, align_corners=False."""
    if img.device.type == "cpu":
        return resize_bilinear_plain(img, shape)
    N, H, W = img.shape
    Ho, Wo = shape
    native.require(img, "resize_bilinear", torch.float32)
    key = (H, Ho, W, Wo, img.device)
    taps = _RESIZE_TABLES.get(key)
    if taps is None:
        taps = torch.from_numpy(resize_table(H, Ho, W, Wo)).to(img.device)
        _RESIZE_TABLES[key] = taps
    out = torch.empty((N, Ho, Wo), dtype=img.dtype, device=img.device)
    native.launch("image_resize", img, out, taps, N, H, W, Ho, Wo)
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(1, int(math.ceil(2.5 * sigma)))
    k = gaussian_kernel1d(sigma, r)
    return separable_filter2d(img, k, k)


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float,
                  blur_sigma: float = 1.0) -> List[torch.Tensor]:
    """Levels at 1/scale_factor^i (min 16 px a side), each blurred; each
    level is resized from the previous UNBLURRED level, as the reference."""
    H, W = img.shape[-2:]
    levels = []
    cur = img
    for i in range(n_levels):
        s = scale_factor ** i
        h, w = max(int(round(H / s)), 16), max(int(round(W / s)), 16)
        lvl = img if i == 0 else resize_bilinear(cur, (h, w))
        cur = lvl
        levels.append(gaussian_blur(lvl, blur_sigma))
    return levels


def sobel_gradients_plain(img: torch.Tensor, u8_wrap: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = torch.nn.functional.pad(img[:, None], (1, 1, 1, 1),
                                mode="replicate")[:, 0]
    sy = (p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]) * 0.25
    d = p[:, 2:] - p[:, :-2]
    if u8_wrap:
        d = torch.where(d < 0, d + 256.0, d)
    dy = d * 0.5
    gx = (sy[:, :, 2:] - sy[:, :, :-2]) * 0.5
    gy = (dy[:, :, :-2] + 2.0 * dy[:, :, 1:-1] + dy[:, :, 2:]) * 0.25
    return gx, gy


def sobel_launch(img: torch.Tensor, grad_th: float = None,
                 u8_wrap: bool = False) -> Tuple[torch.Tensor, ...]:
    """Kernel E launch 1 on a CUDA (N, H, W) f32 batch: ``(gx, gy)``, or
    with ``grad_th`` the line detector's planes ``(w, d2x, d2y)``;
    ``u8_wrap`` as ``sobel_gradients``."""
    N, H, W = img.shape
    native.require(img, "sobel_gradients", torch.float32)
    outs = [torch.empty_like(img) for _ in range(2 if grad_th is None else 3)]
    if grad_th is None:
        native.launch("lines_sobel", img, outs[0], outs[1], None, None, None,
                      N, H, W, 0.0, int(u8_wrap))
    else:
        native.launch("lines_sobel", img, None, None, *outs, N, H, W, grad_th,
                      int(u8_wrap))
    return tuple(outs)


def sobel_gradients(img: torch.Tensor, u8_wrap: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gx, gy) of (N, H, W) images: 3x3 Sobel with edge padding, scaled
    by 0.25 (smoothing) and 0.5 (difference) in the reference's order.
    ``u8_wrap``: the image holds uint8 values, and the y difference wraps
    modulo 256 as the reference's Sobel of a uint8 array does."""
    if img.device.type == "cpu":
        return sobel_gradients_plain(img, u8_wrap)
    return sobel_launch(img, u8_wrap=u8_wrap)
