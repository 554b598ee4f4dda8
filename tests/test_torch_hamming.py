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


# -- the fused, gated matcher (match_gated) ------------------------------------

from plslam_tpu.config import SlamConfig as JConfig  # noqa: E402
from plslam_tpu.frontend import stereo_points as jsp  # noqa: E402

_JCFG = JConfig()


def _gated_case(seed, N=96, M=80):
    """Bits with near copies and duplicates (ties), positions where the
    copies fall inside every gate, octaves, all-masked rows (invalid, or
    far from every column) and all-masked columns."""
    a, b, va, vb, mask = _case(seed, N, M)
    rng = np.random.default_rng(100 + seed)
    pa = rng.uniform(20, 400, (2, N, 2)).astype(np.float32)
    pb = rng.uniform(20, 400, (2, M, 2)).astype(np.float32)
    oa = rng.integers(0, 4, (2, N)).astype(np.int32)
    ob = rng.integers(0, 4, (2, M)).astype(np.int32)
    for n in range(2):
        # the near copies: the source row's position shifted along its row
        # (a disparity), and an octave within 1
        for j in range(M // 2):
            i = int(np.argmin((a[n] != b[n, j]).sum(-1)))
            pb[n, j] = pa[n, i] + [-rng.uniform(2, 60), rng.uniform(-1, 1)]
            ob[n, j] = np.clip(oa[n, i] + rng.integers(-1, 2), 0, 3)
        pa[n, :5] += 5000.0            # rows outside every window
        pb[n, -3:] -= 5000.0           # columns outside every window
        va[n, 5:8] = False             # invalid rows
        vb[n, -6:-3] = False           # invalid columns
        mask[n, 8:10] = False          # rows the mask closes
        mask[n, :, -8:-6] = False      # columns the mask closes
    return a, b, va, vb, mask, pa, pb, oa, ob


def _ref_gated(kind, a, b, va, vb, mask, pa, pb, oa, ob, n, max_d, ratio,
               mutual):
    """The reference's own pipeline for batch element n."""
    j = jnp.asarray
    if kind == "stereo":
        m = _JCFG.matching
        assert (m.max_hamming_p, m.min_ratio_12_p, m.best_lr_matches) == (
            max_d, ratio, mutual)
        return jsp.match_stereo_points(j(pa[n]), j(a[n]), j(oa[n]), j(va[n]),
                                       j(pb[n]), j(b[n]), j(ob[n]), j(vb[n]),
                                       _JCFG)
    dist = jham.hamming_matrix(j(a[n]), j(b[n]), j(va[n]), j(vb[n]))
    if kind in ("window", "window_oct"):
        gate = jham.window_mask(j(pa[n]), j(pb[n]), 60.0)
        if kind == "window_oct":
            gate = gate & (jnp.abs(j(oa[n])[:, None] - j(ob[n])[None, :]) <= 1)
        dist = jham.apply_mask(dist, gate)
    elif kind == "mask":
        dist = jham.apply_mask(dist, j(mask[n]))
    return jham.match_nnr(dist, max_d, ratio, mutual=mutual)


@pytest.mark.parametrize("form", ["bits", "words", "words_bits"])
@pytest.mark.parametrize("kind", ["none", "window", "window_oct", "stereo",
                                  "mask"])
def test_match_gated_plain_matches_reference_pipeline(kind, form):
    """match_gated_plain, and the scan/finish plain pair it is held
    against on the card, equal the reference's hamming_matrix ->
    gate -> match_nnr exactly: idx, dist and valid."""
    seed = 3 + ["none", "window", "window_oct", "stereo", "mask"].index(kind)
    a, b, va, vb, mask, pa, pb, oa, ob = _gated_case(seed)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if form != "bits":
        ta = tham.pack_bits(ta)                        # the stored words
        if form == "words":
            tb = tham.pack_bits(tb)
    t = lambda x: torch.from_numpy(x)
    gate = {"none": None,
            "window": tham.Window(t(pa), t(pb), 60.0),
            "window_oct": tham.Window(t(pa), t(pb), 60.0, t(oa), t(ob)),
            "mask": tham.Mask(t(mask))}.get(kind)
    if kind == "stereo":
        m = _JCFG.matching
        gate = tham.Stereo(t(pa), t(pb), t(oa), t(ob), m.stereo_row_tol,
                           m.min_disp, m.max_disp)
    mutual = kind != "mask"
    max_d, ratio = 80, 0.75
    got = tham.match_gated_plain(ta, tb, t(va), t(vb), gate, max_d, ratio,
                                 mutual)
    pair = tham.hamming_finish(tham.hamming_scan(ta, tb, t(va), t(vb), gate,
                                                 mutual), max_d, ratio)
    n_matched = 0
    for n in range(2):
        rr = _ref_gated(kind, a, b, va, vb, mask, pa, pb, oa, ob, n, max_d,
                        ratio, mutual)
        for res in (got, pair):
            np.testing.assert_array_equal(res.idx[n].numpy(),
                                          np.asarray(rr.idx))
            np.testing.assert_array_equal(res.dist[n].numpy(),
                                          np.asarray(rr.dist))
            np.testing.assert_array_equal(res.valid[n].numpy(),
                                          np.asarray(rr.valid))
        n_matched += int(np.asarray(rr.valid).sum())
        # the all-masked rows: column 0 at 1e9, unmatched
        assert np.all(np.asarray(rr.dist)[5:8] == 1e9)
        assert np.all(np.asarray(rr.idx)[5:8] == -1)
    assert n_matched > 10
