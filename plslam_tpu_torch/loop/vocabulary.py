"""Binary bag-of-words vocabulary (DBoW2 equivalent), kernel L (K17).

Port of ``plslam_tpu/loop/vocabulary.py``: a k^L tree of binary centroids
built by hierarchical k-majority, TF-IDF weighted leaf histograms ("BoW
vectors") and the L1 similarity score. Centroids live on the device as
packed descriptor words (8 int32 words per 256-bit descriptor, the
``ops/hamming.pack_bits`` layout), all levels back to back in ``flat``:
``level_words(voc, l)`` is level l's (k^(l+1), 8) block.

``transform_leaves`` descends each descriptor from the root, taking at
every level the child of least Hamming distance (the first on ties: the
reference's ``argmax`` of the +-1 similarity ``256 - 2 ham``), and
``bow_hist`` builds the masked leaf histogram times idf, L1-normalised;
``bow_vector`` is the two together. On CUDA tensors they are the two
launches of ``csrc/bow.cu`` (``bow_descend``, ``bow_hist``); the plain
versions run only for CPU tensors. ``l1_score`` stays torch (the reference leaves it to XLA).

``build_vocabulary`` runs on host numpy with the reference's random calls,
so the same descriptors and seed give the same centroids. The default
artifacts (``data/vocab_default_{orb,lbd}_10_4_v2.npz``) are byte copies of
the reference's; ``build_default_corpus``, the offline tool that trains
them, is not ported yet (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from plslam_tpu_torch import native, resolve_device
from plslam_tpu_torch.ops import hamming


class Vocabulary(NamedTuple):
    flat: torch.Tensor   # (sum_l k^(l+1), 8) int32 words, level by level
    idf: torch.Tensor    # (n_leaves,) float32
    k: int
    levels: int
    origin: str = ""     # artifact path (+ size/mtime) or a build descriptor

    @property
    def n_leaves(self) -> int:
        return self.k ** self.levels


def level_words(voc: Vocabulary, l: int) -> torch.Tensor:
    """Level l's (k^(l+1), 8) centroid words, a view into ``voc.flat``."""
    off = sum(voc.k ** (i + 1) for i in range(l))
    return voc.flat[off:off + voc.k ** (l + 1)]


def _from_levels(levels_u8, idf, k: int, origin: str, device) -> Vocabulary:
    """Per-level (k^(l+1), 256) uint8 bit arrays -> a Vocabulary on
    ``device`` (None: the CUDA device)."""
    device = resolve_device(device)
    flat = hamming.pack_bits(torch.from_numpy(
        np.concatenate([np.asarray(c, np.uint8) for c in levels_u8]))).to(
        device)
    return Vocabulary(flat=flat,
                      idf=torch.from_numpy(np.array(idf, np.float32)).to(
                          device),
                      k=k, levels=len(levels_u8), origin=origin)


# ---------------- building (host, numpy) ------------------------------------

def _kmajority(desc: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Cluster binary descriptors (N, 256) into k bit-majority centroids."""
    n = len(desc)
    if n == 0:
        return rng.integers(0, 2, (k, 256)).astype(np.uint8)
    centroids = desc[rng.choice(n, size=min(k, n), replace=False)].astype(
        np.uint8)
    if len(centroids) < k:
        centroids = np.concatenate(
            [centroids, rng.integers(0, 2, (k - len(centroids), 256))]
        ).astype(np.uint8)
    for _ in range(iters):
        d = (desc[:, None, :] != centroids[None, :, :]).sum(-1)
        assign = d.argmin(1)
        for c in range(k):
            members = desc[assign == c]
            if len(members):
                centroids[c] = (members.mean(0) > 0.5).astype(np.uint8)
    return centroids


def build_vocabulary(descriptors: np.ndarray, k: int = 8, levels: int = 4,
                     seed: int = 0, weights_from: Optional[np.ndarray] = None,
                     device=None) -> Vocabulary:
    """Hierarchical k-majority build (TemplatedVocabulary::create parity).

    descriptors: (N, 256) uint8 bits. weights_from: descriptor set used
    for the IDF statistics (defaults to the training set)."""
    rng = np.random.default_rng(seed)
    levels_arr = []
    groups = [descriptors]
    for l in range(levels):
        cents = np.zeros((k ** (l + 1), 256), np.uint8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = _kmajority(g, k, rng)
            cents[gi * k:(gi + 1) * k] = c
            if len(g):
                d = (g[:, None, :] != c[None, :, :]).sum(-1)
                assign = d.argmin(1)
            else:
                assign = np.zeros((0,), int)
            for ci in range(k):
                next_groups.append(g[assign == ci] if len(g) else g)
        groups = next_groups
        levels_arr.append(cents)

    digest = zlib.crc32(np.ascontiguousarray(
        np.concatenate([c.reshape(-1) for c in levels_arr])).tobytes())
    device = resolve_device(device)
    voc = _from_levels(levels_arr, np.ones((k ** levels,), np.float32), k,
                       f"built:{k}:{levels}:{seed}:{digest:08x}", device)
    w = weights_from if weights_from is not None else descriptors
    if len(w):
        leaves = transform_leaves(voc, torch.from_numpy(
            np.asarray(w, np.uint8)).to(device)).cpu().numpy()
        counts = np.bincount(leaves, minlength=k ** levels).astype(np.float64)
        n = max(len(w), 1)
        idf = np.log(n / np.maximum(counts, 1.0))
        voc = voc._replace(idf=torch.as_tensor(
            np.asarray(idf, np.float32)).to(device))
    return voc


def level_bits(voc: Vocabulary) -> list:
    """The centroids as per-level (k^(l+1), 256) uint8 numpy bit arrays
    (the npz layout)."""
    return [hamming.unpack_bits(level_words(voc, l)).cpu().numpy()
            for l in range(voc.levels)]


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    np.savez_compressed(
        path, k=voc.k, levels=voc.levels, idf=voc.idf.cpu().numpy(),
        **{f"level_{i}": c for i, c in enumerate(level_bits(voc))})


def load_vocabulary(path: str, device=None) -> Vocabulary:
    z = np.load(path)
    k, levels = int(z["k"]), int(z["levels"])
    st = os.stat(path)
    origin = f"{os.path.abspath(path)}:{st.st_size}:{int(st.st_mtime)}"
    return _from_levels([z[f"level_{i}"] for i in range(levels)], z["idf"],
                        k, origin, device)


# ---------------- transform (kernel L) --------------------------------------

def _packed(desc: torch.Tensor) -> torch.Tensor:
    """(N, 256) bits or (N, 8) packed words -> (N, 8) int32 words."""
    if desc.shape[-1] == hamming.N_BITS:
        return hamming.pack_bits(desc)
    return desc.to(torch.int32)


def transform_leaves_plain(voc: Vocabulary, words: torch.Tensor
                           ) -> torch.Tensor:
    from plslam_tpu_torch.backend.map import _popcount32
    n = words.shape[0]
    node = torch.zeros((n,), dtype=torch.int64, device=words.device)
    ar = torch.arange(voc.k, device=words.device)
    for l in range(voc.levels):
        child = node[:, None] * voc.k + ar[None, :]           # (N, k)
        c = level_words(voc, l)[child]                         # (N, k, 8)
        ham = _popcount32(torch.bitwise_xor(c, words[:, None, :])).sum(-1)
        # torch.argmin keeps the first minimum: the reference's argmax of
        # 256 - 2 ham keeps the first maximum
        node = torch.gather(child, 1, torch.argmin(ham, dim=1)[:, None])[:, 0]
    return node.to(torch.int32)


# the largest branching factor ``bow_descend`` takes (csrc/bow.cu)
BOW_MAX_K = 16


def transform_leaves(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """(N, 256) descriptor bits, or (N, 8) packed words -> (N,) int32 leaf
    ids by the tree descent; one ``bow_descend`` launch on CUDA (8 lanes a
    descriptor, k at most ``BOW_MAX_K``)."""
    words = _packed(desc)
    if words.device.type == "cpu":
        return transform_leaves_plain(voc, words)
    if not 1 <= voc.k <= BOW_MAX_K:
        raise ValueError(f"bow_descend takes k <= {BOW_MAX_K}, got {voc.k}")
    words = words.contiguous()
    n = words.shape[0]
    native.require(words, "transform_leaves desc", torch.int32, (n, 8))
    native.require(voc.flat, "transform_leaves centroids", torch.int32)
    leaves = torch.empty((n,), dtype=torch.int32, device=words.device)
    if n:
        native.launch("bow_descend", words, voc.flat, leaves, n, voc.k,
                      voc.levels)
    return leaves


def bow_hist_plain(voc: Vocabulary, leaves: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    hist = torch.zeros((voc.n_leaves,), dtype=torch.float32,
                       device=leaves.device).index_add_(0, leaves.long(), w)
    v = hist * voc.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


# bow_hist's kernel (csrc/bow.cu): threads a CTA, the most descriptors it
# takes, the least leaves a CTA writes and the most CTAs
HIST_NT, HIST_MAX_N, HIST_SLICE, HIST_MAX_CTAS = 1024, 4096, 1024, 128


def hist_layout(n_leaves: int) -> Tuple[int, int]:
    """(CTAs, leaves a CTA writes) of ``bow_hist``'s launch: CTA c writes
    leaves c * slice .. min((c + 1) * slice, n_leaves) - 1."""
    ctas = min(max(-(-n_leaves // HIST_SLICE), 1), HIST_MAX_CTAS)
    return ctas, (-(-n_leaves // ctas) + 3) // 4 * 4


def bow_hist(voc: Vocabulary, leaves: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """(N,) leaf ids and (N,) bool ``valid`` -> the TF-IDF L1-normalised
    BoW vector (n_leaves,); one ``bow_hist`` launch on CUDA (``hist_layout``
    CTAs, N at most ``HIST_MAX_N``)."""
    if leaves.device.type == "cpu":
        return bow_hist_plain(voc, leaves, valid.to(torch.float32))
    n = leaves.shape[0]
    if n > HIST_MAX_N:
        raise ValueError(f"bow_hist takes at most {HIST_MAX_N} descriptors, "
                         f"got {n}")
    leaves, va = leaves.contiguous(), valid.contiguous()
    if va.dtype == torch.bool:
        va = va.view(torch.uint8)
    native.require(leaves, "bow_hist leaves", torch.int32, (n,))
    native.require(va, "bow_hist valid", torch.uint8, (n,))
    native.require(voc.idf, "bow_hist idf", torch.float32, (voc.n_leaves,))
    out = torch.empty((voc.n_leaves,), dtype=torch.float32,
                      device=leaves.device)
    native.launch("bow_hist", leaves, va, voc.idf, out, n, voc.n_leaves)
    return out


def bow_vector(voc: Vocabulary, desc: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TF-IDF L1-normalised BoW vector (n_leaves,) of the descriptors
    (bits or packed words) where ``valid``: ``transform_leaves`` then
    ``bow_hist``."""
    leaves = transform_leaves(voc, desc)
    if valid is None:
        valid = torch.ones(leaves.shape, dtype=torch.bool,
                           device=leaves.device)
    return bow_hist(voc, leaves, valid)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity: 1 - 0.5 * |v1 - v2|_1 in [0, 1]; broadcasts
    v1 (..., D), v2 (..., D)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


# ---------------- default artifact ------------------------------------------

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
_VOCAB_VERSION = 2
_VOCAB_CACHE: dict = {}


def default_path(kind: str = "orb", k: int = 10, levels: int = 4) -> str:
    return os.path.join(_DATA, f"vocab_default_{kind}_{k}_{levels}_"
                               f"v{_VOCAB_VERSION}.npz")


def default_vocabulary(kind: str = "orb", k: int = 10, levels: int = 4,
                       device=None) -> Vocabulary:
    """The shipped corpus-trained vocabulary (DBoW2's vocabulary file),
    loaded once per path and device. Raises where the artifact is
    missing: ``build_default_corpus``, which trains one, is not ported."""
    path = default_path(kind, k, levels)
    device = resolve_device(device)
    key = (path, str(device))
    if key not in _VOCAB_CACHE:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path}: no default vocabulary artifact for kind={kind!r} "
                f"k={k} levels={levels}; training one (build_default_corpus)"
                " is not ported yet (ROADMAP.md Queue 1, item 9)")
        _VOCAB_CACHE[key] = load_vocabulary(path, device)
    return _VOCAB_CACHE[key]
