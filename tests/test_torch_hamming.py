"""Port parity, kernel D (K6): masked Hamming matrix and NN-ratio matching.

Distances, match indices, best distances and validity equal the
reference's EXACTLY, including inputs built with ties (duplicated
descriptors, equal distances in a row and in a column), where both sides
must pick the lowest index.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.ops import hamming as jham
from plslam_tpu_torch.ops import hamming as tham


def _case(seed, N=96, M=80, dup=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, (2, N, 256)).astype(np.uint8)
    b = rng.integers(0, 2, (2, M, 256)).astype(np.uint8)
    # near copies make real matches (distance 0..12) ...
    for n in range(2):
        src = rng.choice(N, M // 2, replace=False)
        flip = rng.random((M // 2, 256)) < rng.uniform(0, 0.05, (M // 2, 1))
        b[n, :M // 2] = a[n, src] ^ flip.astype(np.uint8)
        if dup:
            # ... and exact duplicates make ties in rows and in columns
            b[n, M // 2:M // 2 + 6] = b[n, :6]
            a[n, N - 4:] = a[n, :4]
    va = rng.random((2, N)) > 0.1
    vb = rng.random((2, M)) > 0.1
    mask = rng.random((2, N, M)) > 0.3
    return a, b, va, vb, mask


@pytest.mark.parametrize("seed,dup", [(0, True), (1, True), (2, False)])
@pytest.mark.parametrize("mutual", [True, False])
def test_distance_and_match_exact(seed, dup, mutual):
    a, b, va, vb, mask = _case(seed, dup=dup)
    t = [torch.from_numpy(x) for x in (a, b, va, vb, mask)]
    dist = tham.hamming_matrix(*t)
    # the mask taken inside the distance or applied after it: same matrix
    assert torch.equal(dist, tham.apply_mask(tham.hamming_matrix(*t[:4]),
                                             t[4]))
    res = tham.match_nnr(dist, 80, 0.75, mutual=mutual)
    n_matched = 0
    for n in range(2):
        rd = jham.hamming_matrix(jnp.asarray(a[n]), jnp.asarray(b[n]),
                                 jnp.asarray(va[n]), jnp.asarray(vb[n]))
        rd = jham.apply_mask(rd, jnp.asarray(mask[n]))
        np.testing.assert_array_equal(dist[n].numpy(), np.asarray(rd))
        rr = jham.match_nnr(rd, 80, 0.75, mutual=mutual)
        np.testing.assert_array_equal(res.idx[n].numpy(), np.asarray(rr.idx))
        np.testing.assert_array_equal(res.dist[n].numpy(), np.asarray(rr.dist))
        np.testing.assert_array_equal(res.valid[n].numpy(),
                                      np.asarray(rr.valid))
        n_matched += int(np.asarray(rr.valid).sum())
    assert n_matched > 20


def test_tie_goes_to_lowest_index():
    """Rows and columns of equal distances: argmin picks index 0 first."""
    d = np.full((1, 4, 5), 7.0, np.float32)
    d[0, :, 3] = 2.0
    d[0, 2, 1] = 2.0
    res = tham.match_nnr(torch.from_numpy(d), 80, 1.01, mutual=True)
    rr = jham.match_nnr(jnp.asarray(d[0]), 80, 1.01, mutual=True)
    np.testing.assert_array_equal(res.idx[0].numpy(), np.asarray(rr.idx))
    np.testing.assert_array_equal(res.valid[0].numpy(), np.asarray(rr.valid))


def test_window_mask_matches_reference():
    rng = np.random.default_rng(4)
    pa = rng.uniform(0, 300, (2, 50, 2)).astype(np.float32)
    pb = rng.uniform(0, 300, (2, 60, 2)).astype(np.float32)
    for circular in (False, True):
        got = tham.window_mask(torch.from_numpy(pa), torch.from_numpy(pb),
                               40.0, circular).numpy()
        for n in range(2):
            ref = jham.window_mask(jnp.asarray(pa[n]), jnp.asarray(pb[n]),
                                   40.0, circular)
            np.testing.assert_array_equal(got[n], np.asarray(ref))


def test_pack_bits_layout_matches_reference():
    bits = np.random.default_rng(5).integers(0, 2, (3, 256)).astype(np.uint8)
    packed = tham.pack_bits(torch.from_numpy(bits))
    ref = np.asarray(jham.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(tham.unpack_bits(packed).numpy(), bits)
