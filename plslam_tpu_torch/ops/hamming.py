"""Binary-descriptor distance and NN-ratio matching (kernel D, K6).

Port of ``plslam_tpu/ops/hamming.py``. The reference gets the Hamming
distance from a +-1 bf16 matmul (exact) and gates it with (N, M) masks
that its callers build; here descriptors are packed into 8 uint32 words
(the ``pack_bits`` layout) and :func:`match_gated` takes the gate itself
(``Window``, ``Stereo``, ``Mask`` or None): on CUDA tensors two
hand-written launches of ``csrc/hamming.cu``, ``hamming_scan`` (popcount
distances, the gate, each row's best and second best and each column's
best row, with no (B, N, M) tensor) and ``hamming_finish`` (the absolute,
ratio and mutual gates). The two launches it replaced, ``hamming_matrix``
(the masked distance matrix) and ``match_nnr``, stay with no main-path
caller. The plain versions run only for CPU tensors. Every
function is batched over a leading B (frame pairs).
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


def _bits_or_words(x: torch.Tensor, name: str) -> bool:
    """True for (..., 256) u8 bits, False for (..., 8) int32 words."""
    if x.shape[-1] == N_BITS and x.dtype == torch.uint8:
        return True
    if x.shape[-1] == 8 and x.dtype == torch.int32:
        return False
    raise ValueError(f"{name}: expected (..., 256) uint8 bits or (..., 8) "
                     f"int32 words, got {tuple(x.shape)} {x.dtype}")


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


# -- the fused, gated matcher -------------------------------------------------

class Window(NamedTuple):
    """The f2f search box: |pos_a - pos_b| <= radius in x and y
    (``window_mask``), and octaves within 1 when both are given."""
    pos_a: torch.Tensor                    # (B, N, 2) predicted positions
    pos_b: torch.Tensor                    # (B, M, 2)
    radius: float
    oct_a: Optional[torch.Tensor] = None   # (B, N) int32
    oct_b: Optional[torch.Tensor] = None   # (B, M) int32


class Stereo(NamedTuple):
    """The rectified stereo gate of ``match_stereo_points``: same row
    within ``row_tol``, disparity in [min_disp, max_disp], octaves within
    1."""
    uv_l: torch.Tensor                     # (B, N, 2)
    uv_r: torch.Tensor                     # (B, M, 2)
    oct_l: torch.Tensor                    # (B, N) int32
    oct_r: torch.Tensor                    # (B, M) int32
    row_tol: float
    min_disp: float
    max_disp: float


class Mask(NamedTuple):
    """An explicit (B, N, M) bool gate."""
    mask: torch.Tensor


class ScanStats(NamedTuple):
    """``hamming_scan``'s outputs: per row the best distance, its first
    column and the second best (before the 1e9 ceiling; inf for one
    column); per column (distance bits << 32 | row) of its first best row,
    None without the mutual check."""
    d1: torch.Tensor                       # (B, N) f32
    i1: torch.Tensor                       # (B, N) int32
    v2: torch.Tensor                       # (B, N) f32
    col_best: Optional[torch.Tensor]       # (B, M) int64


def _octave_gate(oct_a, oct_b):
    return torch.abs(oct_a[..., :, None] - oct_b[..., None, :]) <= 1


def gate_mask(gate) -> Optional[torch.Tensor]:
    """The gate as the (B, N, M) mask the call sites built in torch."""
    if gate is None:
        return None
    if isinstance(gate, Mask):
        return gate.mask
    if isinstance(gate, Window):
        win = window_mask(gate.pos_a, gate.pos_b, gate.radius)
        if gate.oct_a is None:
            return win
        return win & _octave_gate(gate.oct_a, gate.oct_b)
    row_ok = torch.abs(gate.uv_l[..., :, None, 1] - gate.uv_r[..., None, :, 1]
                       ) <= gate.row_tol
    d = gate.uv_l[..., :, None, 0] - gate.uv_r[..., None, :, 0]
    disp_ok = (d >= gate.min_disp) & (d <= gate.max_disp)
    return row_ok & disp_ok & _octave_gate(gate.oct_l, gate.oct_r)


def _gated_matrix_plain(desc_a, desc_b, valid_a, valid_b, gate):
    B, N = desc_a.shape[:2]
    M = desc_b.shape[1]
    dev = desc_a.device
    ones = lambda *s: torch.ones(s, dtype=torch.bool, device=dev)
    mask = gate_mask(gate)
    return hamming_matrix_plain(
        desc_a, desc_b, ones(B, N) if valid_a is None else valid_a,
        ones(B, M) if valid_b is None else valid_b,
        ones(B, N, M) if mask is None else mask)


def match_gated_plain(desc_a, desc_b, valid_a, valid_b, gate, max_dist,
                      ratio, mutual: bool = True) -> MatchResult:
    """The call sites' torch gate, the distance matrix, then NN-ratio."""
    return match_nnr_plain(
        _gated_matrix_plain(desc_a, desc_b, valid_a, valid_b, gate),
        max_dist, ratio, mutual)


def hamming_scan_plain(dist: torch.Tensor, mutual: bool = True) -> ScanStats:
    """``hamming_scan``'s outputs from a masked distance matrix."""
    B, n, m = dist.shape
    d1, best = torch.min(dist, dim=2)
    cols = torch.arange(m, device=dist.device)
    v2 = torch.min(torch.where(cols == best[..., None], torch.inf, dist),
                   dim=2).values
    col = None
    if mutual:
        vals, rows = torch.min(dist, dim=1)
        col = (vals.view(torch.int32).to(torch.int64) << 32) | rows
    return ScanStats(d1, best.to(torch.int32), v2, col)


def hamming_finish_plain(s: ScanStats, max_dist: float, ratio: float
                         ) -> MatchResult:
    """NN-ratio from ``hamming_scan``'s outputs; the mutual check where
    ``col_best`` is given."""
    v2 = torch.clamp(s.v2, max=INVALID)
    ok = (s.d1 <= max_dist) & (s.d1 < ratio * v2)
    if s.col_best is not None:
        row = torch.gather(s.col_best, 1, s.i1.long()) & 0xFFFFFFFF
        ok = ok & (row == torch.arange(s.d1.shape[1], device=row.device))
    return MatchResult(torch.where(ok, s.i1, -1).to(torch.int32), s.d1, ok)


_GATE_KIND = {type(None): 0, Window: 1, Stereo: 3, Mask: 4}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def hamming_scan(desc_a: torch.Tensor, desc_b: torch.Tensor,
                 valid_a: Optional[torch.Tensor],
                 valid_b: Optional[torch.Tensor], gate,
                 mutual: bool = True) -> ScanStats:
    """Launch 1 of the matcher: descriptors (B, N, 256) u8 bits or (B, N,
    8) int32 words (either side either way), valid masks (None: all), the
    gate -> :class:`ScanStats`."""
    if desc_a.device.type == "cpu":
        return hamming_scan_plain(
            _gated_matrix_plain(desc_a, desc_b, valid_a, valid_b, gate),
            mutual)
    B, N = desc_a.shape[:2]
    M = desc_b.shape[1]
    dev = desc_a.device
    a_bits = _bits_or_words(desc_a, "hamming_scan desc_a")
    b_bits = _bits_or_words(desc_b, "hamming_scan desc_b")
    if desc_b.device != dev or desc_a.ndim != 3 or desc_b.shape[0] != B:
        raise ValueError("hamming_scan: expected two (B, n, ...) descriptor "
                         f"sets on {dev}, got {tuple(desc_a.shape)} and "
                         f"{tuple(desc_b.shape)} on {desc_b.device}")
    if valid_a is not None:
        valid_a = valid_a.contiguous()
        native.require(valid_a, "hamming_scan valid_a", torch.bool, (B, N))
    if valid_b is not None:
        valid_b = valid_b.contiguous()
        native.require(valid_b, "hamming_scan valid_b", torch.bool, (B, M))
    kind = _GATE_KIND[type(gate)]
    pos_a = pos_b = oct_a = oct_b = mask = None
    p = (0.0, 0.0, 0.0)
    if isinstance(gate, Window):
        pos_a, pos_b, p = gate.pos_a, gate.pos_b, (gate.radius, 0.0, 0.0)
        if gate.oct_a is not None:
            kind, oct_a, oct_b = 2, gate.oct_a, gate.oct_b
    elif isinstance(gate, Stereo):
        pos_a, pos_b, oct_a, oct_b = gate.uv_l, gate.uv_r, gate.oct_l, \
            gate.oct_r
        p = (gate.row_tol, gate.min_disp, gate.max_disp)
    elif isinstance(gate, Mask):
        mask = gate.mask.contiguous()
        native.require(mask, "hamming_scan mask", torch.bool, (B, N, M))
    if pos_a is not None:
        pos_a, pos_b = pos_a.contiguous(), pos_b.contiguous()
        native.require(pos_a, "hamming_scan pos_a", torch.float32, (B, N, 2))
        native.require(pos_b, "hamming_scan pos_b", torch.float32, (B, M, 2))
    if oct_a is not None:
        oct_a, oct_b = oct_a.contiguous(), oct_b.contiguous()
        native.require(oct_a, "hamming_scan oct_a", torch.int32, (B, N))
        native.require(oct_b, "hamming_scan oct_b", torch.int32, (B, M))
    d1 = torch.empty((B, N), dtype=torch.float32, device=dev)
    i1 = torch.empty((B, N), dtype=torch.int32, device=dev)
    v2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    col = (torch.empty((B, M), dtype=torch.int64, device=dev) if mutual
           else None)
    native.launch("hamming_scan", _aligned(desc_a), int(a_bits),
                  _aligned(desc_b), int(b_bits), valid_a, valid_b, kind,
                  pos_a, pos_b, oct_a, oct_b, mask, *map(float, p), d1, i1,
                  v2, col, B, N, M)
    return ScanStats(d1, i1, v2, col)


def hamming_finish(s: ScanStats, max_dist: float, ratio: float
                   ) -> MatchResult:
    """Launch 2 of the matcher: the 1e9 ceiling of the second best, the
    absolute and ratio gates, and the mutual check where ``col_best`` is
    given."""
    if s.d1.device.type == "cpu":
        return hamming_finish_plain(s, max_dist, ratio)
    B, N = s.d1.shape
    M = 0 if s.col_best is None else s.col_best.shape[1]
    idx = torch.empty((B, N), dtype=torch.int32, device=s.d1.device)
    ok = torch.empty((B, N), dtype=torch.bool, device=s.d1.device)
    native.launch("hamming_finish", s.d1, s.i1, s.v2, s.col_best, idx, ok,
                  B, N, M, float(max_dist), float(ratio))
    return MatchResult(idx, s.d1, ok)


def match_gated(desc_a: torch.Tensor, desc_b: torch.Tensor,
                valid_a: Optional[torch.Tensor],
                valid_b: Optional[torch.Tensor], gate, max_dist: float,
                ratio: float, mutual: bool = True) -> MatchResult:
    """NN + Lowe ratio + absolute gate (+ mutual best) of descriptor sets
    (B, N, 256) bits or (B, N, 8) words under ``gate`` (None, ``Window``,
    ``Stereo`` or ``Mask``): equal to ``match_nnr(apply_mask(
    hamming_matrix(...), gate))``, ties to the lowest index. Two launches
    on CUDA tensors, no (B, N, M) tensor."""
    if desc_a.device.type == "cpu":
        return match_gated_plain(desc_a, desc_b, valid_a, valid_b, gate,
                                 max_dist, ratio, mutual)
    return hamming_finish(hamming_scan(desc_a, desc_b, valid_a, valid_b,
                                       gate, mutual), max_dist, ratio)
