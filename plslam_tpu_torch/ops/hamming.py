"""Binary-descriptor distance and NN-ratio matching (kernel D, K6).

Port of ``plslam_tpu/ops/hamming.py``. The reference gets the Hamming
distance from a +-1 bf16 matmul (exact); here descriptors are packed into
8 uint32 words (the ``pack_bits`` layout) and the hand-written kernels of
``csrc/hamming.cu`` compute the masked distance matrix with ``__popc``
(launch 1) and the NN / second-best / ratio / mutual matching
(launch 2) on CUDA tensors. The plain versions run only for CPU tensors.
Every function is batched over a leading B (frame pairs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from plslam_tpu_torch import native

N_BITS = 256
INVALID = 1e9  # f32-exact sentinel of masked distances


class MatchResult(NamedTuple):
    idx: torch.Tensor        # (B, N) int32 index into the second set, -1
    dist: torch.Tensor       # (B, N) f32 best distance
    valid: torch.Tensor      # (B, N) bool


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) {0,1} u8 -> (..., 8) int32 words holding the uint32 bit
    pattern (bit b of word w = bit 32 w + b)."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) words -> (..., 256) u8 {0,1}."""
    shifts = torch.arange(32, device=packed.device, dtype=torch.int64)
    b = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return b.reshape(packed.shape[:-1] + (N_BITS,)).to(torch.uint8)


def apply_mask(dist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, dist, INVALID)


def window_mask(pos_a: torch.Tensor, pos_b: torch.Tensor, radius: float,
                circular: bool = False) -> torch.Tensor:
    """(B, N, 2), (B, M, 2) positions -> (B, N, M) bool in-window."""
    d = pos_a[..., :, None, :] - pos_b[..., None, :, :]
    if circular:
        return torch.sum(d * d, dim=-1) <= radius * radius
    return (torch.abs(d[..., 0]) <= radius) & (torch.abs(d[..., 1]) <= radius)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Descriptors as (..., 256) bits; (..., 8) packed words unpacked."""
    return unpack_bits(x) if x.shape[-1] == 8 else x


def _words(x: torch.Tensor) -> torch.Tensor:
    """Descriptors as (..., 8) int32 words; (..., 256) bits packed."""
    return x.to(torch.int32) if x.shape[-1] == 8 else pack_bits(x)


def hamming_matrix_plain(bits_a, bits_b, valid_a, valid_b, mask):
    # with bits as +-1 the distance is (256 - a.b) / 2; f32 products of
    # +-1 summed 256 deep are exact integers
    bits_a, bits_b = _bits(bits_a), _bits(bits_b)
    a = bits_a.to(torch.float32) * 2.0 - 1.0
    b = bits_b.to(torch.float32) * 2.0 - 1.0
    dist = (N_BITS - a @ b.transpose(-1, -2)) * 0.5
    ok = valid_a[..., :, None] & valid_b[..., None, :] & mask
    return torch.where(ok, dist, INVALID)


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor,
                   valid_a: Optional[torch.Tensor] = None,
                   valid_b: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 256), (B, M, 256) bits, or (B, N, 8), (B, M, 8) packed words
    (the stored keyframe descriptors) -> (B, N, M) f32 Hamming distances,
    INVALID where a row or column is invalid or ``mask`` is False."""
    B, N, _ = bits_a.shape
    M = bits_b.shape[1]
    dev = bits_a.device
    if valid_a is None:
        valid_a = torch.ones((B, N), dtype=torch.bool, device=dev)
    if valid_b is None:
        valid_b = torch.ones((B, M), dtype=torch.bool, device=dev)
    if mask is None:
        mask = torch.ones((B, N, M), dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return hamming_matrix_plain(bits_a, bits_b, valid_a, valid_b, mask)
    pa = _words(bits_a).contiguous()
    pb = _words(bits_b).contiguous()
    va = valid_a.to(torch.uint8).contiguous()
    vb = valid_b.to(torch.uint8).contiguous()
    mk = mask.to(torch.uint8).contiguous()
    native.require(mk, "hamming_matrix mask", torch.uint8, (B, N, M))
    native.require(va, "hamming_matrix valid_a", torch.uint8, (B, N))
    native.require(vb, "hamming_matrix valid_b", torch.uint8, (B, M))
    dist = torch.empty((B, N, M), dtype=torch.float32, device=dev)
    native.launch("hamming_dist", pa, pb, va, vb, mk, dist, B, N, M)
    return dist


def match_nnr_plain(dist: torch.Tensor, max_dist: float, ratio: float,
                    mutual: bool = True) -> MatchResult:
    B, n, m = dist.shape
    # torch.min returns the first index of the minimum (jnp.argmin)
    d1, best = torch.min(dist, dim=2)
    cols = torch.arange(m, device=dist.device)
    dist2 = torch.where(cols == best[..., None], INVALID, dist)
    d2 = torch.min(dist2, dim=2).values
    ok = (d1 <= max_dist) & (d1 < ratio * d2)
    if mutual:
        best_rev = torch.min(dist, dim=1).indices            # (B, M)
        ok = ok & (torch.gather(best_rev, 1, best)
                   == torch.arange(n, device=dist.device))
    idx = torch.where(ok, best, -1)
    return MatchResult(idx.to(torch.int32), d1, ok)


def match_nnr(dist: torch.Tensor, max_dist: float, ratio: float,
              mutual: bool = True) -> MatchResult:
    """NN with Lowe ratio (second best = min over all but the best
    column), absolute gate, optional mutual-best check; ties go to the
    lowest index."""
    if dist.device.type == "cpu":
        return match_nnr_plain(dist, max_dist, ratio, mutual)
    native.require(dist, "match_nnr", torch.float32)
    B, n, m = dist.shape
    best_rev = torch.empty((B, m), dtype=torch.int32, device=dist.device)
    idx = torch.empty((B, n), dtype=torch.int32, device=dist.device)
    d1 = torch.empty((B, n), dtype=torch.float32, device=dist.device)
    ok = torch.empty((B, n), dtype=torch.uint8, device=dist.device)
    native.launch("hamming_match", dist, best_rev, idx, d1, ok, B, n, m,
                  float(max_dist), float(ratio), int(mutual))
    return MatchResult(idx, d1, ok.bool())
