"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs a CUDA device: every test takes the ``cuda`` fixture, which skips
where there is none (decided when the test runs, never at import). On the
card: ``python -m pytest -m gpu tests/test_torch_gpu.py``. Bits, masks,
indices, leaf ids and the FAST score must be exactly equal; filter and
resize outputs agree to 1e-6 absolute (FMA contraction) for images in
[0, 1]; other tolerances are stated in each test.
"""

import numpy as np
import pytest
import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.ops import fast, hamming, image, lbd, lines, orb
from torch_line_cases import (G_H, G_MERGE_CASES, G_REFIT_CASES, G_W,
                              kernel_g_merge_case, kernel_g_stage, line_field,
                              stripe_field)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _imgs(shape=(3, 157, 243), seed=0):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, shape).astype(np.float32))


def _launched(name, fn):
    before = native.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert native.LAUNCHES[name] == before + 1
    return out


def test_filter_and_resize(cuda):
    x = _imgs()
    for kx, ky, tol in ((image.gaussian_kernel1d(1.0, 3),) * 2 + (1e-6,),
                        (orb._d_h, orb._ONES_H, 1e-4)):
        got = _launched("image_sep_filter", lambda: image.separable_filter2d(
            x.to(cuda), kx, ky))
        ref = image.separable_filter2d_plain(x, kx, ky)
        assert (got.cpu() - ref).abs().max() <= tol
    for shape in ((131, 202), (78, 121), (20, 300)):
        got = _launched("image_resize",
                        lambda: image.resize_bilinear(x.to(cuda), shape))
        ref = image.resize_bilinear_plain(x, shape)
        assert (got.cpu() - ref).abs().max() <= 1e-6


@pytest.mark.parametrize("N", [1, 40])
def test_resize_one_pass(cuda, N):
    """image_resize, one launch a call, against its plain version on the
    card: a 376x1241 batch to the pyramid's 1/1.2 (313x1034) and the
    half-resolution passes' 1/2 (188x620), and to an odd width that is not
    a multiple of the kernel's 4-column strips (157x517)."""
    x = _imgs((N, 376, 1241), seed=3).to(cuda)
    for shape in ((313, 1034), (188, 620), (157, 517)):
        got = _launched("image_resize",
                        lambda: image.resize_bilinear(x, shape))
        ref = image.resize_bilinear_plain(x, shape)
        assert got.shape == (N,) + shape
        assert float((got - ref).abs().max()) <= 1e-6


def test_fast_kernels_exact(cuda):
    x = image.gaussian_blur(_imgs(seed=1), 1.0)
    th_hi, th_lo = float(np.float32(20 / 255)), float(np.float32(7 / 255))
    got = _launched("fast_score",
                    lambda: fast.fast_score_map2(x.to(cuda), th_hi, th_lo))
    ref = fast.fast_score_map2_plain(x, th_hi, th_lo)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    chi, clo, score = ref
    got = _launched("fast_nms_block", lambda: fast.nms_block_max(
        score.to(cuda), chi.to(cuda), clo.to(cuda), 5, 16, 24, 32))
    ref = fast.nms_block_max_plain(score, chi, clo, 5, 16, 24, 32)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


@pytest.mark.parametrize("shape", [(376, 1241), (313, 1034), (261, 862),
                                   (218, 718)])
def test_fast_score_exact_at_level_shapes(cuda, shape):
    """fast_score at the pyramid's four level shapes (no width a multiple
    of 4), one launch a call: masks (torch.bool) and score exactly equal
    to the plain version; nms_block_max fed those bool masks (viewed, not
    copied) and fed them as uint8, exactly equal to its plain version."""
    H, W = shape
    x = image.gaussian_blur(_imgs((2, H, W), seed=4).to(cuda), 1.0)
    th_hi, th_lo = float(np.float32(20 / 255)), float(np.float32(7 / 255))
    got = _launched("fast_score",
                    lambda: fast.fast_score_map2(x, th_hi, th_lo))
    ref = fast.fast_score_map2_plain(x, th_hi, th_lo)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert int(got[0].sum()) > 0
    chi, clo, score = got
    cell_h, cell_w = fast._grid_dims(H, W, 8, 16)
    Hb, Wb = cell_h * 8 // 8, cell_w * 16 // 8
    want = fast.nms_block_max_plain(score, chi, clo, 5, 16, Hb, Wb)
    for masks in ((chi, clo), (chi.to(torch.uint8), clo.to(torch.uint8))):
        res = _launched("fast_nms_block", lambda: fast.nms_block_max(
            score, *masks, 5, 16, Hb, Wb))
        for g, r in zip(res, want):
            assert torch.equal(g, r)


@pytest.mark.parametrize("radius", [3, 5, 7])
def test_nms_block_max_ties_radii_alignment(cuda, radius):
    """nms_block_max exactly equal to its plain version at the four level
    shapes (no width a multiple of 4): scores of few values (tied maxima
    in a block and in the NMS windows), the path's radius and the run-time
    radius path, and a score plane at an address that is not 16-byte
    aligned (the kernel's scalar loads)."""
    rng = np.random.default_rng(radius)
    for H, W in ((376, 1241), (313, 1034), (261, 862), (218, 718)):
        score = torch.from_numpy(rng.integers(0, 4, (2, H, W)).astype(
            np.float32) / 4).to(cuda)
        chi = torch.from_numpy(rng.random((2, H, W)) < 0.3).to(cuda)
        clo = chi | torch.from_numpy(rng.random((2, H, W)) < 0.3).to(cuda)
        cell_h, cell_w = fast._grid_dims(H, W, 8, 16)
        Hb, Wb = cell_h, cell_w * 2
        odd = torch.empty(score.numel() + 1, device=cuda)[1:].view(
            score.shape).copy_(score)
        want = fast.nms_block_max_plain(score, chi, clo, radius, 16, Hb, Wb)
        for s in (score, odd):
            got = _launched("fast_nms_block", lambda: fast.nms_block_max(
                s, chi, clo, radius, 16, Hb, Wb))
            for g, r in zip(got, want):
                assert torch.equal(g, r)


@pytest.mark.parametrize("radius", [3, 7])
def test_sep_filter_one_launch(cuda, radius):
    """image_sep_filter, one launch a call, at r = 3 (the blur) and r = 7
    (a 15-tap set), on widths that are not multiples of the kernel's tiles
    or strips, against its plain version on the card (FMA contraction:
    1e-6 for the blur, 1e-4 for sums of up to 15 x 7)."""
    g = image.gaussian_kernel1d(1.0, 3)
    kx, ky, tol = (g, g, 1e-6) if radius == 3 else (orb._d_h, g, 1e-4)
    for shape in ((3, 157, 517), (2, 37, 359), (1, 16, 9), (40, 188, 620)):
        x = _imgs(shape, seed=5).to(cuda)
        got = _launched("image_sep_filter",
                        lambda: image.separable_filter2d(x, kx, ky))
        ref = image.separable_filter2d_plain(x, kx, ky)
        assert float((got - ref).abs().max()) <= tol


def test_sep_filter_pair_bit_equal_to_single_calls(cuda):
    """The paired mode, one launch, writes ORB's two moment maps into the
    columns of one level of two larger buffers (an odd offset, so rows are
    not 16-byte aligned); each equals its single call to the bit and the
    other columns stay as they were. Outputs of unequal alignment raise."""
    sets = ((orb._d_h, orb._ONES_H), (orb._ONES_H, orb._d_h))
    for shape in ((2, 188, 620), (3, 47, 155), (1, 109, 359)):
        N, H, W = shape
        x = _imgs(shape, seed=6).to(cuda)
        bufs = [torch.full((N, H * W + 11), -7.0, device=cuda)
                for _ in sets]
        cols = slice(3, 3 + H * W)
        _launched("image_sep_filter", lambda: image.separable_filter2d_pair(
            x, *sets[0], *sets[1], bufs[0][:, cols], bufs[1][:, cols]))
        for buf, (kx, ky) in zip(bufs, sets):
            single = image.separable_filter2d(x, kx, ky).reshape(N, -1)
            assert torch.equal(buf[:, cols], single)
            assert bool((buf[:, :3] == -7.0).all())
            assert bool((buf[:, 3 + H * W:] == -7.0).all())
    with pytest.raises(ValueError):
        image.separable_filter2d_pair(x, *sets[0], *sets[1], bufs[0][:, cols],
                                      bufs[1][:, 4:4 + H * W])


def _orb_case(n_levels, seed=2, N=2, K=300):
    """Pyramid levels of 120x200 images, moment maps with zeros and both
    signs, and keypoints on and off the levels' edges, on half-integer
    coordinates (round half to even) and with octaves outside the levels
    (clamped)."""
    levels = image.build_pyramid(_imgs((N, 120, 200), seed), n_levels, 1.2)
    halves = [(lv.shape[1] // 2, lv.shape[2] // 2) for lv in levels]
    rng = np.random.default_rng(seed)
    n_half = sum(h * w for h, w in halves)
    m = rng.normal(size=(2, N, n_half)).astype(np.float32)
    m[:, :, ::7] = 0.0                        # atan2(0, 0) and +-0 moments
    octv = rng.integers(-1, n_levels + 1, (N, K)).astype(np.int32)
    wh = np.array([lv.shape[:0:-1] for lv in levels], np.float32)[
        np.clip(octv, 0, n_levels - 1)]
    uv = (rng.uniform(-0.1, 1.1, (N, K, 2)) * wh).astype(np.float32)
    uv[:, ::5] = np.round(uv[:, ::5]) + 0.5   # ties at full res
    uv[:, 1::5] = np.round(uv[:, 1::5])       # and, where odd, at half res
    return (levels, torch.from_numpy(m[0]), torch.from_numpy(m[1]), halves,
            torch.from_numpy(uv), torch.from_numpy(octv))


@pytest.mark.parametrize("n_levels", [2, 4])
def test_orb_bits_exact(cuda, n_levels):
    """orient_and_describe, one launch, against its plain version on the
    card: bits and theta bit-equal at the clamps, K not a multiple of a
    warp's 32 keypoints or a CTA's 256."""
    levels, m10, m01, halves, uv, octv = _orb_case(n_levels)
    levels = [lv.to(cuda) for lv in levels]
    m10, m01, uv, octv = (t.to(cuda) for t in (m10, m01, uv, octv))
    bits, theta = _launched("orb_describe", lambda: orb.orient_and_describe(
        levels, m10, m01, halves, uv, octv))
    rbits, rtheta = orb.orient_and_describe_plain(levels, m10, m01, halves,
                                                  uv, octv)
    assert torch.equal(theta, rtheta)
    assert torch.equal(bits, rbits)
    assert bits.shape == (2, 300, 256) and bool((bits <= 1).all())
    with pytest.raises(ValueError):               # no CUDA branch left
        orb.pool_bits(levels[0].reshape(2, -1), octv, octv, octv)


@pytest.mark.parametrize("mutual", [True, False])
def test_hamming_kernels_exact(cuda, mutual):
    g = torch.Generator().manual_seed(1)
    a = torch.randint(0, 2, (3, 200, 256), generator=g, dtype=torch.uint8)
    b = a[:, torch.randperm(200, generator=g)[:150]].clone()
    b[:, :40] ^= (torch.rand((3, 40, 256), generator=g) < 0.05).to(torch.uint8)
    b[:, 140:] = b[:, :10]                              # ties
    va = torch.rand((3, 200), generator=g) > 0.1
    vb = torch.rand((3, 150), generator=g) > 0.1
    mask = torch.rand((3, 200, 150), generator=g) > 0.2
    dev = [t.to(cuda) for t in (a, b, va, vb, mask)]
    dist = _launched("hamming_dist", lambda: hamming.hamming_matrix(*dev))
    ref = hamming.hamming_matrix_plain(a, b, va, vb, mask)
    assert torch.equal(dist.cpu(), ref)
    got = _launched("hamming_match",
                    lambda: hamming.match_nnr(dist, 80, 0.75, mutual))
    want = hamming.match_nnr_plain(ref, 80, 0.75, mutual)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert int(want.valid.sum()) > 50


def test_cuda_tensor_never_takes_the_plain_version(cuda):
    with pytest.raises(ValueError):
        image.gaussian_blur(torch.zeros(1, 40, 40, dtype=torch.float64,
                                        device=cuda), 1.0)


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_lines_sobel_and_moments(cuda):
    x = line_field(3)
    got = _launched("lines_sobel", lambda: image.sobel_gradients(x.to(cuda)))
    for g, r in zip(got, image.sobel_gradients_plain(x)):
        assert torch.equal(g.cpu(), r)
    got = _launched("lines_sobel",
                    lambda: lines.gradient_planes(x.to(cuda), 0.02))
    # the plain version on the card: torch's CPU sqrt is not correctly
    # rounded (AVX-512), the card's and the kernel's are
    for g, r in zip(got, lines.gradient_planes_plain(x.to(cuda), 0.02)):
        assert torch.equal(g, r)
    w, d2x, d2y = lines.gradient_planes_plain(x, 0.02)
    D2x, D2y = lines.orientation_maps_plain(d2x, d2y, 16, 8)
    got = _launched("lines_moments", lambda: lines.orientation_maps(
        d2x.to(cuda), d2y.to(cuda), 16, 8))
    for g, r in zip(got, (D2x, D2y)):
        assert _rel_err(g.cpu(), r) <= 1e-5
    d2n = torch.sqrt(D2x * D2x + D2y * D2y) + 1e-9
    u = (D2x / d2n, D2y / d2n)
    ref = lines.reweighted_moments_plain(w, d2x, d2y, *u, 16, 8)
    got = _launched("lines_moments", lambda: lines.reweighted_moments(
        *(t.to(cuda) for t in (w, d2x, d2y) + u), 16, 8))
    for g, r in zip(got, ref):
        assert _rel_err(g.cpu(), r) <= 1e-5


@pytest.mark.parametrize("case", ["full", "half", "u8_wrap", "u8_half",
                                  "euroc", "euroc_half", "odd", "small",
                                  "tile12", "tile32"])
def test_lines_tile_moments(cuda, case):
    """lines_tile_moments, one launch, bit for bit the chain it replaced
    on the card (chip_smoke.py's tile_moments_chain: lines_sobel,
    lines_moments, torch's unit field, lines_moments), and within 1e-5 of each map's largest magnitude of
    tile_moments_plain on the card: the flagship path's full and half
    resolution with its thresholds, a uint8 frame held as f32 with
    u8_wrap at both, the EuRoC layout's 480x752 and 240x376, odd sizes
    (157x243: 18 x 29 windows), an image smaller than one CTA's windows
    (40x50), and tiles 12 and 32 (the kernel's any-s form; at 32 its CTAs
    shrink to fit shared memory)."""
    th = 5.3 / 255.0
    shape, tile, wrap, th = {
        "full": ((3, 376, 1241), 16, False, th),
        "half": ((3, 188, 620), 16, False, th * 0.5),
        "u8_wrap": ((2, 376, 1241), 16, True, th),
        "u8_half": ((2, 188, 620), 16, True, th * 0.5),
        "euroc": ((2, 480, 752), 16, False, th),
        "euroc_half": ((2, 240, 376), 16, False, th * 0.5),
        "odd": ((3, 157, 243), 16, False, 0.02),
        "small": ((2, 40, 50), 16, False, 0.02),
        "tile12": ((2, 157, 243), 12, False, 0.02),
        "tile32": ((2, 376, 620), 32, False, 0.02)}[case]
    N, H, W = shape
    x = line_field(len(case), n=N, H=H, W=W, n_lines=max(H * W // 6000, 8))
    if wrap:
        x = torch.round(x * 200 + torch.from_numpy(np.random.default_rng(
            9).integers(0, 56, shape).astype(np.float32)))
    x = x.to(cuda)
    got = _launched("lines_tile_moments",
                    lambda: lines.tile_moments(x, tile, th, wrap))
    from chip_smoke import tile_moments_chain
    chain = tile_moments_chain(x, tile, th, wrap)
    plain = lines.tile_moments_plain(x, tile, th, wrap)
    Th, Tw = lines.tile_grid(H, W, tile)
    for g, c, p in zip(got, chain, plain):
        assert g.shape == (N, Th, Tw)
        assert torch.equal(g, c)
        assert _rel_err(g, p) <= 1e-5
    assert float(got[0].sum()) > 0


def _tile_maps(x):
    w, d2x, d2y = lines.gradient_planes_plain(x, 0.02)
    D2x, D2y = lines.orientation_maps_plain(d2x, d2y, 16, 8)
    d2n = torch.sqrt(D2x * D2x + D2y * D2y) + 1e-9
    return lines.reweighted_moments_plain(w, d2x, d2y, D2x / d2n, D2y / d2n,
                                          16, 8)


@pytest.mark.parametrize("case", ["many_linked", "none", "line_field",
                                  "chain"])
def test_lines_labels_exact(cuda, case):
    """gates_and_labels, one launch, against tile_gates +
    propagate_labels_plain on the card, every output bit-equal: a stripe
    field with more than 1,024 linked tiles an image (the list takes more
    than one pass of the block), the line field with merge_dist_th 0 (no
    tile linked), the line field, and the stripe field with 2 sweeps
    (chains longer than 2^iters: the labels stop short)."""
    x = stripe_field(0) if case in ("many_linked", "chain") else line_field(4)
    maps = [m.to(cuda) for m in _tile_maps(x)]
    dist_th = 0.0 if case == "none" else 2.0
    iters = 2 if case == "chain" else 9
    args = (*maps, 16, 1.0, 2.5, 2.2, 0.6, 0.1, dist_th, iters)
    got = _launched("lines_label", lambda: lines.gates_and_labels(*args))
    ref = lines.gates_and_labels_plain(*args)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    ok, lab = ref[0], ref[-1]
    N, Th, Tw = lab.shape
    own = lab == torch.arange(Th * Tw, device=cuda).reshape(Th, Tw)
    linked = (ok & ~own).reshape(N, -1).sum(1)
    assert int(ok.sum()) > 20
    if case == "many_linked":
        assert int(linked.min()) > 1024
    elif case == "none":
        assert bool(own[ok].all()) and int(linked.max()) == 0
    else:
        assert int(linked.min()) > 10                 # real components
    with pytest.raises(ValueError):               # no CUDA branch left
        lines.propagate_labels(*lines.tile_gates(*maps, 16, 1.0, 2.5, 2.2,
                                                 0.6)[:6], 0.1, 2.0, 9)


def test_lines_refit_and_merge(cuda):
    """Kernel G through its public calls, one launch each: refit_roots on
    the card against the CPU's plain path, merge_segments the same."""
    x = line_field(5)
    ts = lines.tile_stage(x, tile=16)
    H, W = x.shape[1:]
    sp, ep, sc = _launched("lines_refit", lambda: lines.refit_roots(
        lines.TileStage(*(t.to(cuda) for t in ts)), H, W, 16, 48, 12.0))
    rsp, rep, rsc = lines.refit_roots(ts, H, W, 16, 48, 12.0)
    v = rsc > 0
    assert int(v.sum()) > 5
    assert torch.equal(sc.cpu() > 0, v)
    assert _rel_err(sc.cpu(), rsc) <= 1e-5
    assert (sp.cpu() - rsp)[v].abs().max() <= 1e-3
    assert (ep.cpu() - rep)[v].abs().max() <= 1e-3
    got = _launched("lines_merge", lambda: lines.merge_segments(
        rsp.to(cuda), rep.to(cuda), rsc.to(cuda), v.to(cuda), 0.2, 2.0, 14.0))
    ref = lines.merge_segments(rsp, rep, rsc, v, 0.2, 2.0, 14.0)
    root = ref[4]
    assert torch.equal(got[4].cpu(), root) and torch.equal(got[5].cpu(),
                                                           ref[5])
    assert _rel_err(got[3].cpu(), ref[3]) <= 1e-5
    for g, r in zip(got[:2], ref[:2]):
        assert (g.cpu() - r)[root].abs().max() <= 1e-3


# -- kernel G's edge cases (torch_line_cases; the CPU tests hold the plain
# path to the JAX reference on the same cases: tests/test_torch_lines.py) ----


def _hold_refit(got, ref):
    seg = ref[2] > 0
    assert torch.equal(got[2] > 0, seg)
    if bool(seg.any()):
        assert _rel_err(got[2], ref[2]) <= 1e-5
        for g, r in zip(got[:2], ref[:2]):
            assert float((g - r)[seg].abs().max()) <= 1e-3


def _hold_merge(got, ref):
    root = ref[4]
    assert torch.equal(got[4], root) and torch.equal(got[5], ref[5])
    assert got[4].dtype == torch.bool
    if bool(root.any()):
        assert _rel_err(got[3], ref[3]) <= 1e-5
        for g, r in zip(got[:3], ref[:3]):
            assert float((g - r)[root].abs().max()) <= 1e-3


@pytest.mark.parametrize("case", G_REFIT_CASES)
def test_kernel_g_edge_cases(cuda, case):
    """lines_refit (one launch) against refit_plain and lines_merge (one
    launch) against merge_plain, both on the card, on the refit cases:
    segments, roots and labels exactly equal, scores within 1e-5
    relative, endpoints within 1e-3 px (the plain refit's index_add_ sums
    in another order)."""
    ts, ml = kernel_g_stage(case)
    ts = lines.TileStage(*(t.to(cuda) for t in ts))
    len_th = min(0.75 * 16 + 8, 12.0)
    rid = lines.root_ids(ts, ml)
    got = _launched("lines_refit", lambda: lines.refit(ts, rid, G_H, G_W,
                                                       len_th))
    _hold_refit(got, lines.refit_plain(*lines.refit_inputs(ts, G_H, G_W, ml),
                                       G_H, G_W, len_th))
    sp, ep, sc = lines.refit_roots(ts, G_H, G_W, 16, ml, 12.0)
    assert sp.shape[1] == 2 * ml
    v = sc > 0
    got = _launched("lines_merge", lambda: lines.merge_segments(
        sp, ep, sc, v, 0.2, 2.0, 14.0))
    _hold_merge(got, lines.merge_plain(lines._segment_table(sp, ep, sc, v),
                                       v, 0.2, 2.0, 14.0, 8))


@pytest.mark.parametrize("case", G_MERGE_CASES)
def test_lines_merge_edge_cases(cuda, case):
    """lines_merge against merge_plain on the card on the merge cases
    (the chain's labels after 2 sweeps are not yet one component)."""
    sp, ep, sc, v, iters = (x.to(cuda) if isinstance(x, torch.Tensor) else x
                            for x in kernel_g_merge_case(case))
    got = _launched("lines_merge", lambda: lines.merge_segments(
        sp, ep, sc, v, 0.2, 2.0, 14.0, iters))
    _hold_merge(got, lines.merge_plain(lines._segment_table(sp, ep, sc, v),
                                       v, 0.2, 2.0, 14.0, iters))


def test_kernel_g_bit_equal_to_replaced_kernels(cuda):
    """Kernel G keeps the summation orders of the kernels it replaced (a
    warp a root slot walking every label; a block an image testing every
    pair) and the torch glue's arithmetic: refit_roots and merge_segments
    on line_field(5)'s TileStage (kernels E and F on the card) give those
    kernels' outputs (tests/data/lines_segments_warp_per_slot.npz, written
    on the H100 by that code) to the bit."""
    import os
    saved = np.load(os.path.join(os.path.dirname(__file__), "data",
                                 "lines_segments_warp_per_slot.npz"))
    x = line_field(5).to(cuda)
    ts = lines.tile_stage(x, tile=16)
    H, W = x.shape[1:]
    sp, ep, sc = lines.refit_roots(ts, H, W, 16, 48, 12.0)
    m = lines.merge_segments(sp, ep, sc, sc > 0, 0.2, 2.0, 14.0)
    got = {"refit_sp": sp, "refit_ep": ep, "refit_score": sc,
           "merge_sp": m[0], "merge_ep": m[1], "merge_angle": m[2],
           "merge_score": m[3], "merge_root": m[4], "merge_labels": m[5]}
    for k, g in got.items():
        assert torch.equal(g.cpu(), torch.from_numpy(saved[k])), k


def test_lbd_bits_exact(cuda):
    x = line_field(6)
    gx, gy = image.sobel_gradients_plain(x)
    g = torch.Generator().manual_seed(2)
    sp = torch.rand((3, 40, 2), generator=g) * torch.tensor([199., 159.])
    ep = sp + torch.randn((3, 40, 2), generator=g) * 30
    ref = lbd.describe_lines_plain(gx, gy, sp, ep, 9, 3, 24, 2)
    got = _launched("lbd_describe", lambda: lbd.describe_lines(
        gx.to(cuda), gy.to(cuda), sp.to(cuda), ep.to(cuda), 9, 3, 24, 2))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("case", ["path", "u8_wrap", "empty",
                                  "zero_length", "border"])
def test_lbd_image_exact(cuda, case):
    """describe_lines_image, one launch from the image, bit-equal to its
    plain composition (sobel_gradients_plain, then describe_lines_plain):
    at the path's shape (40 half-res 188 x 620 images, 128 segments each,
    band width 3), on full-res uint8 values with u8_wrap (band width 7),
    with no segment, with zero-length segments and with segments on and
    across the border."""
    rng = np.random.default_rng(7)
    N, H, W, L, bw, u8 = {"path": (40, 188, 620, 128, 3, False),
                          "u8_wrap": (4, 376, 1241, 64, 7, True),
                          "empty": (3, 50, 60, 0, 3, False),
                          "zero_length": (2, 90, 150, 40, 3, False),
                          "border": (2, 90, 150, 40, 3, False)}[case]
    if u8:
        img = rng.integers(0, 256, (N, H, W)).astype(np.float32)
    else:
        img = rng.random((N, H, W)).astype(np.float32)
    sp = rng.uniform(0, [W, H], (N, L, 2))
    ep = sp + rng.normal(0, 40, (N, L, 2))
    if case == "zero_length":
        ep[:, ::2] = sp[:, ::2]
    if case == "border":
        sp[:, :10, 0], ep[:, :10, 0] = 0.0, W - 1.0        # along the edges
        sp[:, 10:20, 1], ep[:, 10:20, 1] = H - 1.0, H + 8.0
        sp[:, 20:] = rng.uniform(-30, [W + 30, H + 30], (N, L - 20, 2))
    img, sp, ep = (torch.from_numpy(x.astype(np.float32))
                   for x in (img, sp, ep))
    ref = lbd.describe_lines_image_plain(img, sp, ep, 9, bw, 24, 2, u8)
    got = _launched("lbd_describe", lambda: lbd.describe_lines_image(
        img.to(cuda), sp.to(cuda), ep.to(cuda), 9, bw, 24, 2, u8))
    assert got.shape == (N, L, 256) and torch.equal(got.cpu(), ref)


def test_hamming_kernels_at_line_shapes(cuda):
    """Kernel D at the line path's 128 x 128, with window and angle masks."""
    g = torch.Generator().manual_seed(3)
    a = torch.randint(0, 2, (4, 128, 256), generator=g, dtype=torch.uint8)
    b = a[:, torch.randperm(128, generator=g)].clone()
    b ^= (torch.rand((4, 128, 256), generator=g) < 0.1).to(torch.uint8)
    va = torch.rand((4, 128), generator=g) > 0.2
    vb = torch.rand((4, 128), generator=g) > 0.2
    pa = torch.rand((4, 128, 2), generator=g) * 600
    pb = torch.rand((4, 128, 2), generator=g) * 600
    ang_a = torch.rand((4, 128), generator=g) * 3
    ang_b = torch.rand((4, 128), generator=g) * 3
    mask = (hamming.window_mask(pa, pb, 300.0)
            & ((ang_a[..., :, None] - ang_b[..., None, :]).abs() < 1.0))
    dev = [t.to(cuda) for t in (a, b, va, vb, mask)]
    dist = _launched("hamming_dist", lambda: hamming.hamming_matrix(*dev))
    ref = hamming.hamming_matrix_plain(a, b, va, vb, mask)
    assert torch.equal(dist.cpu(), ref)
    got = _launched("hamming_match",
                    lambda: hamming.match_nnr(dist, 90, 0.9))
    for x, y in zip(got, hamming.match_nnr_plain(ref, 90, 0.9)):
        assert torch.equal(x.cpu(), y)


# -- slice 3: kernels I (K13), J (K14, K16) and K (K15) -----------------------

def lba_problem_np(seed, W=5, P=120, Q=40, noise_px=0.3, pose_noise=0.03,
                   pt_noise=0.05, drop=0.1):
    """tests/test_lba.py::make_lba_problem's construction, with numpy
    randomness (dense visibility, endpoints paired (2q, 2q+1), the first KF
    fixed) and ``drop`` of the observations detached (id -1). Returns a
    dict of the LBAProblem fields and the camera."""
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    cam = StereoCamera.from_config(SlamConfig().camera)
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)
    pts = np.stack([u(-6, 6, P), u(-4, 4, P), u(6, 25, P)], -1)
    eps = np.stack([u(-6, 6, Q), u(-4, 4, Q), u(6, 25, Q)], -1)
    xi = np.array([[0.05 * w, 0.01 * w, -0.3 * w, 0.0, 0.015 * w, 0.0]
                   for w in range(W)], np.float32)
    poses = lie.exp_se3(torch.from_numpy(xi)).numpy().astype(np.float64)

    def proj(T, X):
        Pc = X @ T[:3, :3].T + T[:3, 3]
        return np.stack([cam.fx * Pc[:, 0] / Pc[:, 2] + cam.cx,
                         cam.fy * Pc[:, 1] / Pc[:, 2] + cam.cy], -1), Pc[:, 2]
    obs_uv, disp, les = [], [], []
    for T in poses:
        uv, z = proj(T, pts)
        obs_uv.append(uv + noise_px * rng.normal(size=uv.shape))
        disp.append(cam.fx * cam.b / z + noise_px * rng.normal(size=z.shape))
        sp = proj(T, eps[0::2])[0] + noise_px * rng.normal(size=(Q // 2, 2))
        ep = proj(T, eps[1::2])[0] + noise_px * rng.normal(size=(Q // 2, 2))
        le = np.stack([sp[:, 1] - ep[:, 1], ep[:, 0] - sp[:, 0],
                       sp[:, 0] * ep[:, 1] - sp[:, 1] * ep[:, 0]], -1)
        les.append(le / np.linalg.norm(le[:, :2], axis=-1, keepdims=True))
    obs_id = np.tile(np.arange(P, dtype=np.int32), (W, 1))
    obs_id[rng.random((W, P)) < drop] = -1
    sid = np.tile(np.arange(0, Q, 2, dtype=np.int32), (W, 1))
    gone = rng.random(sid.shape) < drop
    sid[gone] = -1
    eid = np.where(sid >= 0, sid + 1, -1).astype(np.int32)
    dpose = rng.normal(size=(W, 6)) * pose_noise
    dpose[0] = 0.0
    kf_pose = (lie.exp_se3(torch.from_numpy(dpose.astype(np.float32))).numpy()
               @ poses.astype(np.float32))
    fixed = np.zeros(W, bool)
    fixed[0] = True
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        kf_pose=f32(kf_pose), kf_fixed=fixed, kf_valid=np.ones(W, bool),
        pt_pos=f32(pts + pt_noise * rng.normal(size=pts.shape)),
        ep_pos=f32(eps + pt_noise * rng.normal(size=eps.shape)),
        obs_pt_uv=f32(obs_uv), obs_pt_disp=f32(disp), obs_pt_id=obs_id,
        obs_ln_le=f32(les), obs_ln_sid=sid, obs_ln_eid=eid), cam


# the lower median's edge cases: odd and even counts of valid |r|, exactly
# one and none, ties straddling the median, values one ulp apart
MEDIAN_CASES = ("odd", "even", "one", "none", "ties", "last_bit")


def lba_median_problem_np(case, seed=0):
    """A problem whose valid |r| are chosen bit for bit. Every point
    observation is detached but those of three points put behind every
    camera (lost: charged). Each line observation's equation is (0, 0, c),
    so its endpoint residuals are c exactly: the case's values go to the
    start endpoints (random signs) and the other endpoints are detached.
    ``case``: one of MEDIAN_CASES; "wide", 20,480 lines with both endpoints
    attached (40,960 values, all in one top radix bucket; more than the
    32,768 observations the sort it replaced could hold); "mixed",
    lba_problem_np's own geometry, points and lines. Returns the dict of
    LBAProblem fields, the camera and the number of valid values."""
    if case == "mixed":
        d, cam = lba_problem_np(seed)
        return d, cam, None
    W, L = (10, 2048) if case == "wide" else (4, 64)
    d, cam = lba_problem_np(seed, W=W, Q=2 * L)
    rng = np.random.default_rng(seed + 1)
    d["pt_pos"][:3, 2] = -5.0
    d["obs_pt_id"][:] = -1
    d["obs_pt_id"][:, :3] = np.arange(3)
    x = np.float32(0.7)
    x1 = np.nextafter(x, np.float32(1))
    vals = {
        "odd": lambda: rng.lognormal(0.0, 1.0, 101),
        "even": lambda: rng.lognormal(0.0, 1.0, 100),
        "one": lambda: np.array([0.37]),
        "none": lambda: np.zeros(0),
        "ties": lambda: rng.choice([0.0, 0.5, 1.0, 1.5], 200),
        "last_bit": lambda: rng.permutation(np.concatenate(
            [np.full(49, x), [x1], np.full(50, np.nextafter(x1, x1 + 1))])),
        "wide": lambda: rng.uniform(1.0, 1.1, W * L),
    }[case]().astype(np.float32)
    m = len(vals)
    le = np.zeros((W * L, 3), np.float32)
    le[:m, 2] = vals * rng.choice(np.float32([-1, 1]), m)
    d["obs_ln_le"] = le.reshape(W, L, 3)
    slot = np.arange(W * L).reshape(W, L)
    d["obs_ln_sid"] = np.where(slot < m, 2 * (slot % L), -1).astype(np.int32)
    d["obs_ln_eid"] = (np.where(slot < m, 2 * (slot % L) + 1, -1)
                       if case == "wide" else np.full((W, L), -1)
                       ).astype(np.int32)
    return d, cam, 2 * m if case == "wide" else m


def _lba_problem(d, dev):
    from plslam_tpu_torch.backend import lba
    return lba.LBAProblem(**{k: torch.from_numpy(v).to(dev)
                             for k, v in d.items()})


def _gn_problems(B, K, L, seed):
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.features import line_equation
    from plslam_tpu_torch.tracking import pose_gn
    cam = StereoCamera.from_config(SlamConfig().camera)
    rng = np.random.default_rng(seed)
    P = torch.from_numpy(np.stack([rng.uniform(-8, 8, (B, K)),
                                   rng.uniform(-3, 3, (B, K)),
                                   rng.uniform(4, 40, (B, K))], -1
                                  ).astype(np.float32))
    xi = torch.from_numpy((rng.normal(size=(B, 6)) * [0.05, 0.05, 0.3, 0.01,
                                                      0.03, 0.01]
                           ).astype(np.float32))
    T = lie.exp_se3(xi)
    uv = cam.project(lie.transform_points(T, P))
    uv = uv + torch.from_numpy(rng.normal(0, 0.5, uv.shape).astype(np.float32))
    uv[:, :K // 7] += torch.from_numpy(
        rng.normal(0, 40, (B, K // 7, 2)).astype(np.float32))
    pv = torch.from_numpy(rng.random((B, K)) > 0.05)
    sP = torch.from_numpy(np.stack([rng.uniform(-8, 8, (B, L)),
                                    rng.uniform(-3, 3, (B, L)),
                                    rng.uniform(4, 30, (B, L))], -1
                                   ).astype(np.float32))
    d = rng.normal(size=(B, L, 3))
    eP = sP + torch.from_numpy(
        (2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
            np.float32))
    le = line_equation(cam.project(lie.transform_points(T, sP)),
                       cam.project(lie.transform_points(T, eP)))
    if L:
        sP[:, :2, 2] = -1.0                       # behind the camera
    lv = torch.from_numpy(rng.random((B, L)) > 0.15)
    return (cam, pose_gn.PointTerms(P, uv, pv),
            pose_gn.LineTerms(sP, eP, le, lv))


@pytest.mark.parametrize("L", [0, 32])
def test_pose_gn_kernel(cuda, L):
    """Kernel I (K13): 6 GN iterations of 5 pairs against the plain
    version on the card: poses within 1e-5, with and without lines."""
    from plslam_tpu_torch.tracking import pose_gn
    cam, pts, lns = _gn_problems(5, 300, L, seed=L)
    dev = lambda nt: type(nt)(*(x.to(cuda) for x in nt))
    T0 = torch.eye(4).expand(5, 4, 4).to(cuda)
    got = _launched("pose_gn_optimize", lambda: pose_gn.gn_iters(
        T0, cam, dev(pts), dev(lns), 6))
    ref = pose_gn.gn_iters_plain(T0, cam, dev(pts), dev(lns), 6)
    assert float((got - ref).abs().max()) <= 1e-5
    assert float((ref - T0).abs().max()) > 1e-2          # it moved


@pytest.mark.parametrize("L", [0, 32])
def test_pose_gn_phase_bit_equal_to_bitonic_kernel(cuda, L):
    """Kernel I's phase-only form keeps the arithmetic of the bitonic-sort
    kernel it replaced (the same terms, order of summation, solve and
    update; the median exact either way): on test_pose_gn_kernel's
    problems its 6 iterations give that kernel's saved poses
    (tests/data/pose_gn_phase_bitonic.npz, written on the H100) to the
    bit."""
    import os
    from plslam_tpu_torch.tracking import pose_gn
    saved = np.load(os.path.join(os.path.dirname(__file__), "data",
                                 "pose_gn_phase_bitonic.npz"))[f"T_L{L}"]
    cam, pts, lns = _gn_problems(5, 300, L, seed=L)
    dev = lambda nt: type(nt)(*(x.to(cuda) for x in nt))
    T0 = torch.eye(4).expand(5, 4, 4).to(cuda)
    got = _launched("pose_gn_optimize", lambda: pose_gn.gn_iters(
        T0, cam, dev(pts), dev(lns), 6))
    assert torch.equal(got.cpu(), torch.from_numpy(saved))


@pytest.mark.parametrize("B,L", [(20, 128), (20, 0), (1, 128)])
def test_optimize_pose_one_launch(cuda, B, L):
    """Kernel I's whole optimize_pose (K13) is one launch, held against
    optimize_pose_plain on the card by chip_smoke.py's rule (hold_pose): T
    within 1e-5; the covariance and err within 3x the plain version's
    distance from their float64 values (the plain version's statistics
    run in float64 from its pose and inliers) + 1e-5 of those values; the
    decisions exactly equal or within 1e-4 of their threshold."""
    from chip_smoke import gn_inputs, hold_pose, pose_margins
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.tracking import pose_gn
    cfg = SlamConfig()
    cam, pts, lns = gn_inputs(cuda, B, 1024, L, seed=B + L)
    lns = lns if L else None
    T0 = torch.eye(4, device=cuda).expand(B, 4, 4)
    margins, ref, H, sse = pose_margins(T0, cam, pts, lns, cfg)
    got = _launched("pose_gn_optimize", lambda: pose_gn.optimize_pose(
        T0, cam, pts, lns, cfg))
    errs, _, _, _ = hold_pose(got, ref, margins, H, sse)
    assert errs[0] <= 1e-5 and errs[1] <= 1.0 and errs[2] <= 1.0
    assert errs[3] == 0
    assert bool(ref.good.all())


@pytest.mark.parametrize("B", [20, 1])
def test_optimize_pose_lines_only(cuda, B):
    """Kernel I's whole optimize_pose with K = 0 point terms (the
    lines-only configuration: zero-size point tensors, a null pointer to
    the kernel) and 128 line terms with 0.5 px endpoint noise, a tenth 40
    px off: one launch, held to optimize_pose_plain on the card by
    chip_smoke.py's lines-only rule (LINES_ONLY_GN_TOLS: T within 1e-5,
    cov and err within 1e-3 relative, the decisions exactly equal or
    within 1e-4 of their threshold); its point masks of size 0."""
    from chip_smoke import (LINES_ONLY_GN_TOLS, gn_inputs, hold_pose,
                            lines_only_cov_rel, pose_margins)
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.tracking import pose_gn
    cfg = SlamConfig()
    cam, pts, lns = gn_inputs(cuda, B, 0, 128, seed=5 + 128 + B,
                              line_px=0.5)
    T0 = torch.eye(4, device=cuda).expand(B, 4, 4)
    margins, ref, H, sse = pose_margins(T0, cam, pts, lns, cfg)
    got = _launched("pose_gn_optimize", lambda: pose_gn.optimize_pose(
        T0, cam, pts, lns, cfg))
    assert got.inlier_pt.shape == (B, 0)
    errs, _, err_rel, differ = hold_pose(got, ref, margins, H, sse)
    errs = [errs[0], lines_only_cov_rel(got, ref, differ), err_rel, errs[3]]
    assert all(e <= t for e, t in zip(errs, LINES_ONLY_GN_TOLS)), errs
    assert bool(ref.good.all())
    assert torch.equal(got.n_inliers, got.inlier_ln.sum(-1).int())


def _kf_chunk(rng, B, cuda, bad_lead=0):
    from plslam_tpu_torch.core import lie
    xi = rng.normal(size=(B, 6)) * [0.05, 0.02, 0.4, 0.01, 0.03, 0.01]
    DT = lie.exp_se3(torch.from_numpy(xi.astype(np.float32))).to(cuda)
    A = rng.normal(size=(B, 6, 6)) * 1e-3
    cov = torch.from_numpy((A @ A.transpose(0, 2, 1) + 1e-6 * np.eye(6))
                           .astype(np.float32)).to(cuda)
    good = rng.random(B) > 0.1
    good[:bad_lead] = False
    return DT, cov, torch.from_numpy(good).to(cuda)


@pytest.mark.parametrize("kmax", [1, 4])
@pytest.mark.parametrize("B", [1, 20, 33, 64])
def test_kf_scan_kernel(cuda, B, kmax):
    """Kernel J's kf_scan (K14), one launch a chunk: flags and blocked
    exactly equal to the plain version on the card, T_accs within 1e-5 of
    their largest magnitude (at least 1e-5),
    ratios within 1e-4 and the carry's flags and counter exact, over
    chunks (a few frames that are not good first in some, every frame
    not good in one) with the carry alternating between the kernel's
    packed carry and the plain version's unpacked one; the kmax cap
    defers some."""
    from plslam_tpu_torch.backend import fused_slam
    from plslam_tpu_torch.config import SlamConfig
    cfg = SlamConfig()
    rng = np.random.default_rng(B * 10 + kmax)
    carry = fused_slam.init_crit_carry(cuda)
    n_kf = n_blocked = 0
    for chunk in range(6 if B > 1 else 40):
        bad = B if chunk % 6 == 2 else min((0, 3, 0, 0, 7, 1)[chunk % 6],
                                           B - 1)
        DT, cov, good = _kf_chunk(rng, B, cuda, bad)
        got = _launched("kf_scan", lambda: fused_slam.kf_scan(
            DT, cov, good, carry, cfg, kmax))
        ref = fused_slam.kf_scan_plain(DT, cov, good, carry, cfg, kmax)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[3], ref[3])
        # T_accs: 1e-5 of their largest magnitude, at least 1e-5 (with
        # kmax 1 the pose since the last KF grows to tens of metres)
        assert float((got[1] - ref[1]).abs().max()) <= 1e-5 * max(
            1.0, float(ref[1].abs().max()))
        assert float((got[2] - ref[2]).abs().max()) <= 1e-4
        assert fused_slam._packed_base(got[4]) is not None
        for g, r in zip(got[4], ref[4]):
            assert g.dtype == r.dtype and g.shape == r.shape
            if g.dtype == torch.bool or not g.is_floating_point():
                assert torch.equal(g, r)
            else:
                assert float((g - r).abs().max()) <= 1e-5 * max(
                    1.0, float(r.abs().max()))
        n_kf += int(ref[0].sum())
        n_blocked += int(ref[3].sum())
        carry = ref[4] if chunk % 2 else got[4]
    assert n_kf >= 3 and (kmax == 4 or B == 1 or n_blocked > 0)


@pytest.mark.parametrize("case", ["random", "all_invalid", "one_leaf", "n1",
                                  "ends", "ragged", "k16", "n4096"])
def test_bow_hist_kernel(cuda, case):
    """Kernel L's bow_hist (K17), one launch: within 1e-6 of the plain
    version's largest entry, with exactly its zeros, |sum |v| - 1| <=
    1e-5 (0 where nothing is valid) and the L1 scores against a database
    of plain vectors within 1e-6; on the 10,000 leaves of a 10 x 4
    vocabulary (the cases of test_torch_loop.py's _hist_by_ctas), on
    2,187 (k = 3, levels 7: 3 CTAs, the last short), on 65,536 (k = 16,
    levels 4) and with the most descriptors it takes."""
    from plslam_tpu_torch.loop import vocabulary as voc
    k, levels = {"ragged": (3, 7), "k16": (16, 4)}.get(case, (10, 4))
    n_leaves = k ** levels
    g = torch.Generator().manual_seed(len(case))
    idf = torch.rand((n_leaves,), generator=g) * 3.0 + 0.1
    v = voc.Vocabulary(flat=torch.zeros((1, 8), dtype=torch.int32),
                       idf=idf, k=k, levels=levels)
    vg = v._replace(idf=idf.to(cuda))
    n = {"n1": 1, "n4096": voc.HIST_MAX_N, "random": 1024}.get(case, 128)
    leaves = torch.randint(0, n_leaves, (n,), generator=g,
                           dtype=torch.int32)
    valid = torch.rand((n,), generator=g) > 0.2
    if case == "all_invalid":
        valid[:] = False
    elif case == "one_leaf":
        leaves[:] = 17
    elif case in ("ends", "ragged"):
        leaves[:4] = torch.tensor([0, n_leaves - 1, 0, n_leaves - 1])
        valid[:4] = True
    elif case == "n4096":
        leaves = leaves % 700        # repeats: counts above 1
    got = _launched("bow_hist", lambda: voc.bow_hist(vg, leaves.to(cuda),
                                                     valid.to(cuda))).cpu()
    ref = voc.bow_hist_plain(vg, leaves.to(cuda),
                             valid.to(cuda).to(torch.float32)).cpu()
    assert torch.equal(got == 0, ref == 0)
    top = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-6 * max(top, 1e-30)
    if valid.any():
        assert abs(float(got.abs().sum()) - 1.0) <= 1e-5
        db = torch.stack([voc.bow_hist_plain(v, torch.randint(
            0, n_leaves, (n,), generator=g, dtype=torch.int32), torch.ones(
            n)) for _ in range(4)] + [ref])
        assert float((voc.l1_score(db, got[None])
                      - voc.l1_score(db, ref[None])).abs().max()) <= 1e-6
    else:
        assert not got.any()


@pytest.mark.parametrize("N,R", [(3000, 4), (1024, 4), (777, 1), (513, 3),
                                 (300, 8)])
def test_medoid_kernel(cuda, N, R):
    """Kernel J's medoid (K16), one launch: exactly the plain version's
    rows (the medoid's bits where valid, desc elsewhere), with ties, short
    rings (count 0, count > R) and invalid rows, at ring sizes that are and
    are not powers of two."""
    from plslam_tpu_torch.backend import map as tmap
    g = torch.Generator().manual_seed(N + R)
    ring = torch.randint(-2 ** 31, 2 ** 31 - 1, (N, R, 8), generator=g,
                         dtype=torch.int64).to(torch.int32)
    ring[:N // 6, R - 1] = ring[:N // 6, 0]             # ties
    ring[N // 6:N // 3] = ring[N // 6:N // 3, :1]       # all equal
    count = torch.randint(-1, R + 3, (N,), generator=g).to(torch.int32)
    valid = torch.rand((N,), generator=g) < 0.75
    desc = torch.randint(0, 2, (N, 256), generator=g, dtype=torch.uint8)
    got = _launched("medoid", lambda: tmap._medoid_bits(
        ring.to(cuda), count.to(cuda), valid.to(cuda), desc.to(cuda)))
    assert torch.equal(got.cpu(),
                       tmap._medoid_bits_plain(ring, count, valid, desc))


def test_lba_kernels(cuda):
    """Kernel K (K15), launch by launch and a whole run_lba, against the
    plain version on the card. Masks and flags exact; floats relative to
    each output's largest magnitude (f32 sums in another order)."""
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    d, cam = lba_problem_np(0)
    prob = _lba_problem(d, cuda)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(
        min=1e-30))
    t, sig, cost = _launched("lba_terms",
                             lambda: lba.lba_terms_sigma(prob, cam))
    tp = lba.lba_terms_plain(prob, cam)
    assert torch.equal(t.ok_pt, tp.ok_pt) and torch.equal(t.ok_ln, tp.ok_ln)
    for a, b in zip(t, tp):
        if a.is_floating_point():
            assert rel(a, b) <= 1e-5
    # the scale and cost of the kernel's own terms: the scale to the bit
    sig_p, cost_p = lba.lba_sigma_plain(t, prob)
    assert torch.equal(sig, sig_p) and rel(cost, cost_p) <= 1e-5
    sig_p = lba.lba_sigma_plain(tp, prob)[0]
    free = lba._free(prob)
    lam = torch.tensor(1e-3, device=cuda)
    b = lba.lba_blocks(tp, prob, sig_p, free, lam, lba.lba_index(prob))
    bp = lba.LandmarkBlocks(*lba.lba_camera_plain(tp, sig_p, free),
                            *lba.lba_bin_plain(tp, prob, sig_p, free, lam))
    # the damped blocks' inverses amplify f32 sum-order noise by their
    # condition number: 1e-4 there
    for x, y, tol in zip(b, bp, (1e-5, 1e-5, 1e-5, 1e-4, 1e-5, 1e-5)):
        assert rel(x, y) <= tol
    P = prob.pt_pos.shape[0]
    for cap in (True, False):
        got = _launched("lba_solve", lambda: lba.lba_solve(
            bp, prob, free, lam, lba.lba_index(prob), cap=cap))
        _hold_f64(got, lba.lba_solve_plain(bp, free, lam, P, cap=cap),
                  lba.lba_solve_plain(_f64(bp), free, lam.double(), P,
                                      cap=cap))
    cfg = SlamConfig()
    before = native.LAUNCHES["lba_bin"]
    res = lba.run_lba(prob, cam, cfg)
    torch.cuda.synchronize()
    assert native.LAUNCHES["lba_bin"] == before + cfg.mapping.lba_iters
    assert float(res.cost1) < float(res.cost0)
    n_obs = int((prob.obs_pt_id >= 0).sum())
    assert int(res.obs_pt_inlier.sum()) > 0.8 * n_obs
    resp = lba.run_lba_plain(prob, cam, cfg)
    assert rel(res.kf_pose, resp.kf_pose) <= 1e-4
    assert rel(res.pt_pos, resp.pt_pos) <= 1e-4
    assert rel(res.cost1, resp.cost1) <= 1e-3
    assert float((res.obs_pt_inlier == resp.obs_pt_inlier).float().mean()
                 ) >= 0.995


def _f64(nt):
    return type(nt)(*(x.double() if x.is_floating_point() else x
                      for x in nt))


def _hold_f64(got, ref, truth):
    """K15's rule: each float output of the kernel, and its distance from
    the plain version, within 3x the plain version's own distance from
    float64 + 1e-5 (relative to the output's largest magnitude)."""
    rel = lambda a, c: float((a.double() - c.double()).abs().max()
                             / c.double().abs().max().clamp(min=1e-30))
    for g, r, t in zip(got, ref, truth):
        bound = 3.0 * rel(r, t) + 1e-5
        assert rel(g, t) <= bound and rel(g, r) <= bound, (
            rel(g, t), rel(g, r), bound)


@pytest.mark.parametrize("case", ["dense", "pinned"])
def test_lba_solve_one_launch(cuda, case):
    """lba_solve (the Schur complement over the observed pose pairs, the
    damped 6W x 6W solve and the landmark steps; one call of its entry)
    against lba_solve_plain under K15's rule, on lba_problem_np and on a
    pinned, nearly singular case (free KF 2 with every observation
    detached, KF 3 left with four points and no lines); two launches on
    the same blocks give the same bits."""
    from plslam_tpu_torch.backend import lba
    d, cam = lba_problem_np(2)
    if case == "pinned":
        for key in ("obs_pt_id", "obs_ln_sid", "obs_ln_eid"):
            d[key][2] = -1
        d["obs_pt_id"][3, 4:] = -1
        d["obs_ln_sid"][3] = d["obs_ln_eid"][3] = -1
    prob = _lba_problem(d, cuda)
    free = lba._free(prob)
    lam = torch.tensor(1e-3, device=cuda)
    t, sigma, _ = lba.lba_terms_sigma_plain(prob, cam)
    b = lba.lba_blocks_plain(t, prob, sigma, free, lam)
    idx = lba.lba_index(prob)
    P = prob.pt_pos.shape[0]
    got = _launched("lba_solve",
                    lambda: lba.lba_solve(b, prob, free, lam, idx))
    _hold_f64(got, lba.lba_solve_plain(b, free, lam, P),
              lba.lba_solve_plain(_f64(b), free, lam.double(), P))
    for x, y in zip(got, lba.lba_solve(b, prob, free, lam, idx)):
        assert torch.equal(x, y)
    if case == "pinned":
        assert float(got[0][2].abs().max()) == 0.0


def test_lba_solve_at_the_window_shape(cuda):
    """lba_solve on chip_smoke.py's lba_window_problem (the SLAM path's
    window: W = 10, K = 1,024, L = 128, 5,120 landmarks; a launch whose
    shared memory passes the default 48 KB) under K15's rule."""
    from chip_smoke import lba_window_problem
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    prob = lba_window_problem(cuda, cfg, cam)
    free = lba._free(prob)
    lam = torch.tensor(cfg.mapping.lambda_init, device=cuda)
    t, sigma, _ = lba.lba_terms_sigma_plain(prob, cam)
    b = lba.lba_blocks_plain(t, prob, sigma, free, lam)
    P = prob.pt_pos.shape[0]
    got = _launched("lba_solve", lambda: lba.lba_solve(
        b, prob, free, lam, lba.lba_index(prob)))
    _hold_f64(got, lba.lba_solve_plain(b, free, lam, P),
              lba.lba_solve_plain(_f64(b), free, lam.double(), P))


def _window_shard(cuda, n):
    """Shard 0 of n of chip_smoke.py's lba_window_problem, bucketed by
    owner, with its plain blocks at the plain terms' MAD scale (the shard's
    own H_cc and g_c standing for the all-reduced ones)."""
    from chip_smoke import lba_window_problem
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.parallel.dist_lba import (bucket_problem_by_owner,
                                                    shard_problem)
    from plslam_tpu_torch.parallel.mesh import make_mesh
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    whole = lba_window_problem(cuda, cfg, cam)
    prob = shard_problem(make_mesh(n, ("lm",), cuda),
                         bucket_problem_by_owner(whole, n).problem)[0]
    free = lba._free(prob)
    lam = torch.tensor(cfg.mapping.lambda_init, device=cuda)
    t, sigma, _ = lba.lba_terms_sigma_plain(prob, cam)
    return prob, free, lam, lba.lba_blocks_plain(t, prob, sigma, free, lam)


@pytest.mark.parametrize("n", [1, 4])
def test_lba_schur_corr_and_solve_reduced(cuda, n):
    """The owner-sharded step's two entries on shard 0 of n of the path's
    window (n = 4: W = 10, K = 256, L = 32, 1,280 landmarks), one launch
    each: lba_schur_corr's sums against lba_schur_corr_plain and
    lba_solve_reduced's step against lba_solve_reduced_plain, each under
    K15's rule (float64 the truth); two launches give the same bits."""
    from plslam_tpu_torch.backend import lba
    prob, free, lam, b = _window_shard(cuda, n)
    idx = lba.lba_index(prob)
    scratch = lba.new_solve_scratch(b.H_cl.shape[0], b.H_cl.shape[1], cuda)
    corr = _launched("lba_schur_corr", lambda: lba.lba_schur_corr(
        b, prob, free, idx, scratch))
    _hold_f64(corr, lba.lba_schur_corr_plain(b, free),
              lba.lba_schur_corr_plain(_f64(b), free))
    P = prob.pt_pos.shape[0]
    for cap in (True, False):
        got = _launched("lba_solve_reduced", lambda: lba.lba_solve_reduced(
            b.H_cc, b.g_c, *corr, b, prob, free, lam, cap=cap,
            scratch=scratch))
        c64 = [x.double() for x in corr]
        _hold_f64(got, lba.lba_solve_reduced_plain(
            b.H_cc, b.g_c, *corr, b, free, lam, P, cap=cap),
            lba.lba_solve_reduced_plain(b.H_cc.double(), b.g_c.double(),
                                        *c64, _f64(b), free, lam.double(),
                                        P, cap=cap))
    again = lba.lba_schur_corr(b, prob, free, idx, scratch)
    assert all(torch.equal(x, y) for x, y in zip(corr, again))
    for x, y in zip(got, lba.lba_solve_reduced(
            b.H_cc, b.g_c, *corr, b, prob, free, lam, cap=False,
            scratch=scratch)):
        assert torch.equal(x, y)
    if n == 1:
        # the whole window: the split step against lba_solve, one launch
        # of each, by K15's rule
        whole = _launched("lba_solve", lambda: lba.lba_solve(
            b, prob, free, lam, idx, cap=False))
        _hold_f64(got, whole, lba.lba_solve_plain(_f64(b), free,
                                                  lam.double(), P, cap=False))


def test_run_lba_graph_replay(cuda):
    """run_lba on a CUDA device: its first call of a shape runs eagerly and
    captures, later calls replay the graph. On two successive problems of
    one shape with different values (stale inputs would show) each call is
    bit-equal to the eager loop of kernels, and native.LAUNCHES counts each
    call as that loop's launches: PER_LBA's table, the capture uncounted."""
    from chip_smoke import PER_LBA
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    cfg = SlamConfig()
    probs = [_lba_problem(lba_problem_np(seed, W=6, P=100, Q=30)[0], cuda)
             for seed in (7, 8)]
    cam = lba_problem_np(7)[1]
    for i, prob in enumerate(probs * 2):
        native.reset_counts()
        got = lba.run_lba(prob, cam, cfg)
        torch.cuda.synchronize()
        assert dict(native.LAUNCHES) == PER_LBA, (i, dict(native.LAUNCHES))
        want = lba._run(prob, cam, cfg, lba._KERNELS)
        for x, y in zip(got, want):
            assert torch.equal(x, y), i
    assert not torch.equal(lba.run_lba(probs[0], cam, cfg).pt_pos,
                           lba.run_lba(probs[1], cam, cfg).pt_pos)


def test_lines_sobel_u8_wrap(cuda):
    """Kernel E launch 1 on a uint8 image held as f32 (an unscaled first
    frame): the y difference wraps modulo 256 exactly as the plain
    version's, in both modes."""
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (2, 90, 130)).astype(np.float32))
    got = _launched("lines_sobel", lambda: image.sobel_gradients(
        x.to(cuda), u8_wrap=True))
    for g, r in zip(got, image.sobel_gradients_plain(x, u8_wrap=True)):
        assert torch.equal(g.cpu(), r)
    got = _launched("lines_sobel", lambda: lines.gradient_planes(
        x.to(cuda), 0.02, u8_wrap=True))
    for g, r in zip(got, lines.gradient_planes_plain(x.to(cuda), 0.02,
                                                     u8_wrap=True)):
        assert torch.equal(g, r)


def test_bow_kernels(cuda):
    """Kernel L (K17) on the shipped vocabularies: leaf ids exactly the
    plain version's, the BoW vector within 1e-6 of its largest entry."""
    from plslam_tpu_torch.loop import vocabulary as voc
    for kind, n in (("orb", 1024), ("lbd", 128)):
        vc = voc.default_vocabulary(kind, 10, 4, "cpu")
        vg = voc.default_vocabulary(kind, 10, 4, cuda)
        g = torch.Generator().manual_seed(n)
        bits = torch.randint(0, 2, (n, 256), generator=g, dtype=torch.uint8)
        # descriptors near centroids too: ties and deep descents
        bits[: n // 2] = voc.hamming.unpack_bits(
            voc.level_words(vc, 3)[torch.randint(0, 10000, (n // 2,),
                                                 generator=g)])
        words = voc.hamming.pack_bits(bits)
        valid = torch.rand((n,), generator=g) > 0.2
        got = _launched("bow_descend", lambda: voc.transform_leaves(
            vg, words.to(cuda)))
        assert torch.equal(got.cpu(), voc.transform_leaves_plain(vc, words))
        v = _launched("bow_hist", lambda: voc.bow_vector(vg, words.to(cuda),
                                                         valid.to(cuda)))
        ref = voc.bow_vector(vc, words, valid)
        assert float((v.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-6
        assert abs(float(v.abs().sum()) - 1.0) <= 1e-5


@pytest.mark.parametrize("F,n,extra", [(64, 40, 60), (128, 100, 300),
                                       (256, 200, 800), (512, 400, 1600),
                                       (1024, 700, 2400)])
def test_pose_graph_kernels(cuda, F, n, extra):
    """Kernel M (K18) against the plain version on the card: launch by
    launch at Fb 64 and 512 (pg_edges at every bucket, against float64;
    pg_assemble and pg_blocks, built once a solve; pg_blocks and pg_update
    also at 1,024), pg_pcg (one CTA, one, two, four and sixteen) at the
    loop closer's five slot buckets, and both solvers up to Fb 128.
    Residuals and Jacobians within 1e-5 of the largest (f32 log/exp in
    another operation order), the dense system and gradient within 1e-5,
    the PCG step within 1e-3, the poses of a whole solve within 1e-3 of
    their largest translation and the cost lowered."""
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg
    gd = convert.pose_graph_from_numpy(
        synthetic.drift_circle_graph(F, n, extra, seed=F)[0], cuda)
    rel = lambda a, b: float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
    every = F in (64, 512)      # the other M kernels, as chip_smoke.py
    blocks_too = F in (64, 512, 1024)
    rp, Jp, cp = pg.edges_plain(gd)
    # pg_edges at every bucket: the kernel against the plain version in
    # float64 (K18's rule: 3x the plain version's own distance + 1e-5); as
    # chip_smoke.py, also within 1e-5 of the plain version but at Fb 128,
    # where the two differ by more while equally far from float64
    r, J, c = _launched("pg_edges", lambda: pg.edges(gd))
    truth = pg.edges_plain(gd._replace(poses=gd.poses.double(),
                                       edge_T=gd.edge_T.double(),
                                       edge_w=gd.edge_w.double()))
    for x, y, z in zip((r, J, c), (rp, Jp, cp), truth):
        assert rel(x, z) <= 3.0 * rel(y, z) + 1e-5, (rel(x, z), rel(y, z))
    if F != 128:
        assert (rel(r, rp) <= 1e-5 and rel(J, Jp) <= 1e-6
                and rel(c, cp) <= 1e-5)
    freeze = torch.zeros(F, dtype=torch.bool, device=cuda)
    diag = pg._diag(gd, freeze, True)
    inc = pg._incidence(gd)
    if every:
        H, gv = _launched("pg_assemble", lambda: pg.assemble(gd, rp, Jp, diag,
                                                             inc))
        Hp, gvp = pg.assemble_plain(gd, rp, Jp, diag)
        assert rel(H - torch.diag(torch.diag(H)), Hp - torch.diag(
            torch.diag(Hp))) <= 1e-5 and rel(gv, gvp) <= 1e-5
    gvp, Hdp = pg.blocks_plain(gd, rp, Jp, diag)
    if blocks_too:
        gv, Hd = _launched("pg_blocks", lambda: pg.blocks(gd, rp, Jp, diag,
                                                          inc))
        assert rel(gv, gvp) <= 1e-5 and rel(Hd, Hdp) <= 1e-5
    Minv = torch.linalg.inv_ex(Hdp)[0]
    dx = _launched("pg_pcg", lambda: pg.pcg(gd, Jp, Minv, diag, gvp, 96, inc))
    assert rel(dx, pg.pcg_plain(gd, Jp, Minv, diag, gvp, 96)) <= 1e-3
    if blocks_too:
        P, c1, _ = _launched("pg_update", lambda: pg.update(gd, cp, dx, 1.0,
                                                            r))
        Pp, c1p, _ = pg.update_plain(gd, cp, dx, 1.0)
        assert rel(P, Pp) <= 1e-5 and rel(c1, c1p) <= 1e-5
    for solve in ((pg._optimize_pcg, pg._optimize_dense) if F <= 128
                  else ()):
        got = solve(gd, freeze, 12)
        want = solve(gd._replace(poses=gd.poses.cpu(), **{
            f: getattr(gd, f).cpu() for f in pg.PoseGraph._fields[1:]}),
                     freeze.cpu(), 12)
        assert float(got[2]) < 0.5 * float(got[1])
        t_scale = float(want[0][:, :3, 3].abs().max())
        assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-3 * t_scale


@pytest.mark.parametrize("F,n,extra,E", [(64, 40, 60, None),
                                         (128, 100, 300, None),
                                         (256, 200, 800, None),
                                         (512, 400, 1600, None),
                                         (1024, 700, 2400, None),
                                         (64, 40, 60, 247)])
def test_pose_graph_edge_sweep(cuda, F, n, extra, E):
    """K18's edge sweep over edge_layout's CTAs at the loop closer's five
    slot buckets (128 CTAs at Fb 1,024) and at a ragged E (247 slots: a
    last CTA of 23 edges):
    pg_edges' two modes give the same residual and cost bits, r = 0 on
    unused slots, Ji within 1e-6 of the plain version's largest entry, r
    and the cost within 1e-5 (not at Fb 128: test_pose_graph_kernels holds
    it to float64 there); pg_update's poses and cost within 1e-5 of
    update_plain's; the residuals and cost it hands on are the bits of a
    pg_edges launch at the accepted poses; the reversed step is rejected
    and hands back the poses, residuals and cost exactly; a second launch
    of each gives the same bits (the last-CTA counter is back at 0)."""
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg
    gd = convert.pose_graph_from_numpy(
        synthetic.drift_circle_graph(F, n, extra, seed=F)[0], cuda)
    if E is not None:
        gd = gd._replace(**{f: getattr(gd, f)[:E]
                            for f in pg.PoseGraph._fields[2:]})
    rel = lambda a, b: float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
    rp, Jp, cp = pg.edges_plain(gd)
    r, J, c = _launched("pg_edges", lambda: pg.edges(gd))
    r2, J2, c2 = _launched("pg_edges", lambda: pg.edges(gd, jac=False))
    assert J2 is None and torch.equal(r, r2) and torch.equal(c, c2)
    assert bool((r[gd.edge_w <= 0] == 0).all())
    assert rel(J, Jp) <= 1e-6
    if F != 128:
        assert rel(r, rp) <= 1e-5 and rel(c, cp) <= 1e-5
    for x, y in zip(pg.edges(gd), (r, J, c)):
        assert torch.equal(x, y)
    freeze = torch.zeros(F, dtype=torch.bool, device=cuda)
    diag = pg._diag(gd, freeze, True)
    gv, Hd = pg.blocks_plain(gd, rp, Jp, diag)
    dx = pg.pcg_plain(gd, Jp, torch.linalg.inv_ex(Hd)[0], diag, gv, 96)
    P, c1, r1 = _launched("pg_update", lambda: pg.update(gd, c, dx, 1.0, r))
    assert float(c1) < float(c)
    Pp, c1p, _ = pg.update_plain(gd, c, dx, 1.0, r)
    assert rel(P, Pp) <= 1e-5 and rel(c1, c1p) <= 1e-5
    re, _, ce = pg.edges(gd._replace(poses=P), jac=False)
    assert torch.equal(r1, re) and torch.equal(c1, ce)
    for x, y in zip(pg.update(gd, c, dx, 1.0, r), (P, c1, r1)):
        assert torch.equal(x, y)
    Pb, cb, rb = _launched("pg_update", lambda: pg.update(gd, c, dx, -1.0,
                                                          r))
    assert torch.equal(Pb, gd.poses) and torch.equal(cb, c)
    assert torch.equal(rb, r)


@pytest.mark.parametrize("F,n,extra,E", [(64, 40, 60, None),
                                         (128, 100, 300, None),
                                         (256, 200, 800, None),
                                         (512, 400, 1600, None),
                                         (1024, 700, 2400, None),
                                         (64, 40, 60, 247)])
def test_pose_graph_gradient(cuda, F, n, extra, E):
    """The gradient pg_update hands on, in both orders, at the loop
    closer's five slot buckets and a ragged E: the bits of pg_assemble's
    (dense) and pg_blocks' (PCG) g at the residuals it hands on, within
    1e-5 of gradient_plain's largest entry; its poses, cost and residuals
    the bits of a launch without the gradient; a second launch the same
    bits; a rejected step hands back the poses, residuals, cost and g_in."""
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg
    gd = convert.pose_graph_from_numpy(
        synthetic.drift_circle_graph(F, n, extra, seed=F)[0], cuda)
    if E is not None:
        gd = gd._replace(**{f: getattr(gd, f)[:E]
                            for f in pg.PoseGraph._fields[2:]})
    rel = lambda a, b: float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
    freeze = torch.zeros(F, dtype=torch.bool, device=cuda)
    diag = pg._diag(gd, freeze, True)
    inc = pg._incidence(gd)
    r, J, c = pg.edges(gd)
    gv, Hd = pg.blocks_plain(gd, r, J, diag)
    dx = pg.pcg_plain(gd, J, torch.linalg.inv_ex(Hd)[0], diag, gv, 96)
    P0, c0, r0 = pg.update(gd, c, dx, 1.0, r)
    assert float(c0) < float(c)
    for mode, shape in (("dense", (6 * F,)), ("pcg", (F, 6))):
        g_in = torch.full(shape, 7.0, device=cuda)
        step = lambda s: pg.update(gd, c, dx, s, r, None,
                                   (mode, J, g_in, torch.empty_like(g_in),
                                    inc))
        P, c1, r1, g1 = _launched("pg_update", lambda: step(1.0))
        for x, y in zip(step(1.0), (P, c1, r1, g1)):
            assert torch.equal(x, y)
        assert torch.equal(P, P0) and torch.equal(c1, c0)
        assert torch.equal(r1, r0)
        want = (pg.assemble(gd, r1, J, diag, inc)[1] if mode == "dense"
                else pg.blocks(gd, r1, J, diag, inc)[0])
        assert torch.equal(g1, want)
        assert rel(g1, pg.gradient_plain(gd, r1, J, mode)) <= 1e-5
        Pb, cb, rb, gb = step(-1.0)
        assert torch.equal(Pb, gd.poses) and torch.equal(cb, c)
        assert torch.equal(rb, r) and torch.equal(gb, g_in)


@pytest.mark.parametrize("F,n,extra", [(64, 40, 60), (128, 100, 300),
                                       (256, 200, 800), (512, 400, 1600)])
def test_pose_graph_solves_equal_per_step_loop(cuda, F, n, extra):
    """Whole dense and PCG solves (H or its diagonal blocks built once, LU
    or the inverses once, each step's gradient from pg_update) against the
    loop that assembles and solves every step on the card (pg_assemble and
    torch.linalg.solve_ex; pg_blocks, torch.linalg.inv_ex and pg_pcg):
    poses and costs the same bits; the solves launch pg_edges, pg_assemble
    or pg_blocks once and pg_update (and pg_pcg) 12 times."""
    from collections import Counter
    from chip_smoke import per_step_solve
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.io import synthetic
    from plslam_tpu_torch.loop import pose_graph as pg
    gd = convert.pose_graph_from_numpy(
        synthetic.drift_circle_graph(F, n, extra, seed=F)[0], cuda)
    freeze = torch.zeros(F, dtype=torch.bool, device=cuda)
    for name in ("dense", "pcg"):
        before = Counter(native.LAUNCHES)
        got = (pg._optimize_dense(gd, freeze, 12) if name == "dense"
               else pg._optimize_pcg(gd, freeze, 12, 96))
        torch.cuda.synchronize()
        launched = Counter(native.LAUNCHES) - before
        for x, y in zip(got, per_step_solve(pg, name, gd, freeze, 12, 96)):
            assert torch.equal(x, y)
        assert float(got[2]) < 0.5 * float(got[1])
        assert launched == ({"pg_edges": 1, "pg_assemble": 1, "pg_update": 12}
                            if name == "dense" else
                            {"pg_edges": 1, "pg_blocks": 1, "pg_pcg": 12,
                             "pg_update": 12})


def _hub_graph(dev, F=96, seed=7):
    """Slot 5 on two edges in three (list entries past one staged chunk,
    more distinct neighbours than a CTA keeps in shared memory), unused
    slots between used ones, repeated pairs, seeded poses and
    measurements."""
    from plslam_tpu_torch import convert
    from plslam_tpu_torch.core import lie
    rng = np.random.default_rng(seed)
    E = 4 * F
    exp = lambda n: lie.exp_se3(torch.from_numpy(
        rng.normal(0, 0.3, (n, 6)).astype(np.float32))).numpy()
    d = dict(poses=exp(F), pose_valid=np.arange(F) < F - 10,
             edge_i=np.zeros(E, np.int32), edge_j=np.zeros(E, np.int32),
             edge_T=exp(E), edge_w=np.zeros(E, np.float32))
    for k in range(E):
        i, j = (5, int(rng.integers(0, F - 10))) if k % 3 else tuple(
            int(v) for v in rng.integers(0, F - 10, 2))
        d["edge_i"][k], d["edge_j"][k] = (i, j) if k % 2 else (j, i)
        d["edge_w"][k] = 0.0 if k % 7 == 3 else 1.0 + (k % 5) * 0.25
    return convert.pose_graph_from_numpy(d, dev)


def test_pose_graph_hub(cuda):
    """K18's normal equations and gradient on a hub graph: pg_assemble and
    pg_blocks within today's tolerances of their plain versions; the
    gradient pg_update hands on, in both orders, the bits of theirs at its
    residuals; whole dense and PCG solves (6 iterations) the bits of the
    loop that assembles and solves every step."""
    from chip_smoke import per_step_solve
    from plslam_tpu_torch.loop import pose_graph as pg
    gd = _hub_graph(cuda)
    inc = pg._incidence(gd)
    assert int((inc[1][1:] - inc[1][:-1]).max()) > 64
    rel = lambda a, b: float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30))
    freeze = torch.from_numpy(pg.frozen_mask(gd)).to(cuda)
    diag = pg._diag(gd, freeze, True)
    r, J, c = pg.edges(gd)
    H, gv = _launched("pg_assemble", lambda: pg.assemble(gd, r, J, diag, inc))
    Hp, gvp = pg.assemble_plain(gd, r, J, diag)
    assert rel(H - torch.diag(torch.diag(H)), Hp - torch.diag(
        torch.diag(Hp))) <= 1e-5 and rel(gv, gvp) <= 1e-5
    assert rel(torch.diag(H), torch.diag(Hp)) <= 1e-6
    gb, Hd = _launched("pg_blocks", lambda: pg.blocks(gd, r, J, diag, inc))
    gbp, Hdp = pg.blocks_plain(gd, r, J, diag)
    assert rel(gb, gbp) <= 1e-5 and rel(Hd, Hdp) <= 1e-5
    dx = pg.pcg_plain(gd, J, torch.linalg.inv_ex(Hdp)[0], diag, gbp, 24)
    for mode, g_in in (("dense", gv), ("pcg", gb)):
        P, c1, r1, g1 = pg.update(gd, c, dx, 1.0, r, None,
                                  (mode, J, g_in, torch.empty_like(g_in),
                                   inc))
        assert not torch.equal(P, gd.poses)
        want = (pg.assemble(gd, r1, J, diag, inc)[1] if mode == "dense"
                else pg.blocks(gd, r1, J, diag, inc)[0])
        assert torch.equal(g1, want)
    for name in ("dense", "pcg"):
        got = (pg._optimize_dense(gd, freeze, 6) if name == "dense"
               else pg._optimize_pcg(gd, freeze, 6, 24))
        for x, y in zip(got, per_step_solve(pg, name, gd, freeze, 6, 24)):
            assert torch.equal(x, y)


def test_remap_kernel_bit_equal(cuda):
    """Kernel N (K19) bit-equal to its plain version on maps with
    negative, out-of-bounds, integer and last-row/column coordinates, with
    one shared map and with one map per image; the rectifier is one
    launch a pair."""
    from plslam_tpu_torch.core import camera
    rng = np.random.default_rng(3)
    H, W, Ho, Wo = 120, 161, 97, 133
    img = torch.from_numpy(rng.uniform(0, 1, (2, H, W)).astype(np.float32))
    m = np.stack([rng.uniform(-3, W + 2, (2, Ho, Wo)),
                  rng.uniform(-3, H + 2, (2, Ho, Wo))], -1).astype(np.float32)
    m[:, 0, :8, 0] = np.arange(8)
    m[:, 1, :8, 0] = W - 1
    m[:, 2, :8, 1] = H - 1
    m[:, 3, :8] = -1.0
    m = torch.from_numpy(m)
    for mp in (m, m[0]):
        got = _launched("remap_bilinear", lambda: camera.remap_bilinear(
            img.to(cuda), mp.to(cuda)))
        ref = camera.remap_bilinear_plain(img.to(cuda), mp.to(cuda))
        assert torch.equal(got, ref)
        assert torch.equal(got.cpu(), camera.remap_bilinear_plain(img, mp))
    rect = camera.StereoRectifier(m[0].numpy(), m[1].numpy(), device=cuda)
    out_l, out_r = _launched("remap_bilinear", lambda: rect(img[0], img[1]))
    assert torch.equal(out_l, camera.remap_bilinear_plain(img[0].to(cuda),
                                                          m[0].to(cuda)))
    assert torch.equal(out_r, camera.remap_bilinear_plain(img[1].to(cuda),
                                                          m[1].to(cuda)))


# -- the fused, gated matcher (D) and the LBA landmark index (K) ---------------

@pytest.mark.parametrize("shape", [(20, 1024, 1024), (1, 1024, 1024),
                                   (1, 8192, 1024), (1, 128, 128)])
@pytest.mark.parametrize("kind", ["none", "window", "window_oct", "stereo",
                                  "mask"])
def test_hamming_scan_finish_exact(cuda, kind, shape):
    """hamming_scan + hamming_finish against match_gated_plain on the card:
    idx, dist and valid exactly equal, bits and packed words, with and
    without the mutual check."""
    from chip_smoke import gated_case
    B, N, M = shape
    g = torch.Generator().manual_seed(N + M + len(kind))
    for words, mutual in ((False, True), (True, True), (False, False)):
        a, b, va, vb, gate = gated_case(g, cuda, B, N, M, kind, words)
        scan = _launched("hamming_scan", lambda: hamming.hamming_scan(
            a, b, va, vb, gate, mutual))
        got = _launched("hamming_finish", lambda: hamming.hamming_finish(
            scan, 80, 0.75))
        want = hamming.match_gated_plain(a, b, va, vb, gate, 80, 0.75, mutual)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        dist = hamming._gated_matrix_plain(a, b, va, vb, gate)
        for x, y in zip(scan, hamming.hamming_scan_plain(dist, mutual)):
            assert (x is None and y is None) or torch.equal(x, y)
        assert int(want.valid.sum()) > B * M // 20


def test_lba_index_and_bin(cuda):
    """lba_index exactly equal to its plain version; lba_bin on
    chip_smoke.py's lba_window_problem within chip_smoke.py's tolerances
    of the plain version (relative to each output's largest magnitude)."""
    from chip_smoke import lba_window_problem
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    prob = lba_window_problem(cuda, cfg, cam)
    idx = _launched("lba_index", lambda: lba.lba_index(prob))
    for x, y in zip(idx, lba.lba_index_plain(prob)):
        assert torch.equal(x, y)
    tp = lba.lba_terms_plain(prob, cam)
    sigma = lba.lba_sigma_plain(tp, prob)[0]
    free = lba._free(prob)
    lam = torch.tensor(cfg.mapping.lambda_init, device=cuda)
    got = _launched("lba_bin", lambda: lba.lba_bin(tp, prob, sigma, free,
                                                   lam, idx))
    ref = lba.lba_bin_plain(tp, prob, sigma, free, lam)
    for x, y, tol in zip(got, ref, (1e-5, 1e-3, 1e-5, 1e-5)):
        assert float((x - y).abs().max() / y.abs().max()) <= tol


@pytest.mark.parametrize("case", ["window", "k4096", "detached",
                                  "every_pose", "k1022"])
def test_lba_index_exact(cuda, case):
    """lba_index, one launch, exactly equal to its plain version: on
    chip_smoke.py's window (W = 10, K = 1,024, L = 128, P = 4,096, Q =
    1,024: 20 CTAs), its K = 4,096 window (every point seen by every pose),
    with every observation detached, with one point and one line's
    endpoints in all W poses (twice in one of them), and with K = 1,022
    (the ids one at a time: K not a multiple of 4)."""
    from chip_smoke import lba_window_problem
    from plslam_tpu_torch.backend import lba
    from plslam_tpu_torch.config import SlamConfig
    from plslam_tpu_torch.core.camera import StereoCamera
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    prob = lba_window_problem(cuda, cfg, cam,
                              K=4096 if case == "k4096" else None)
    ids = dict(obs_pt_id=prob.obs_pt_id.clone(),
               obs_ln_sid=prob.obs_ln_sid.clone(),
               obs_ln_eid=prob.obs_ln_eid.clone())
    if case == "detached":
        for x in ids.values():
            x.fill_(-1)
    elif case == "every_pose":
        ids["obs_pt_id"][:, 5] = 3
        ids["obs_pt_id"][2, 700] = 3
        ids["obs_ln_sid"][:, 9] = 40
        ids["obs_ln_eid"][:, 9] = 41
    if case == "k1022":
        ids["obs_pt_id"] = ids["obs_pt_id"][:, :1022].contiguous()
    prob = prob._replace(**ids)
    idx = _launched("lba_index", lambda: lba.lba_index(prob))
    want = lba.lba_index_plain(lba.LBAProblem(*(x.cpu() for x in prob)))
    for x, y in zip(idx, want):
        assert torch.equal(x.cpu(), y)
    if case == "detached":
        assert int(want.off[-1]) == 0
    if case == "every_pose":
        W = prob.obs_pt_id.shape[0]
        assert int(want.off[4] - want.off[3]) >= W + 1


@pytest.mark.parametrize("case", MEDIAN_CASES + ("mixed", "wide"))
def test_lba_terms_sigma_exact(cuda, case):
    """The one lba_terms launch's scale equal to the bit to the plain
    lower median over the kernel's own terms (a sort), and its robust cost
    within 1e-5 of the plain one's, on the median's edge cases
    (lba_median_problem_np), lba_problem_np's geometry and a window of
    40,960 values in one top radix bucket; validity masks exact."""
    from plslam_tpu_torch.backend import lba
    d, cam, m = lba_median_problem_np(case)
    prob = _lba_problem(d, cuda)
    t, sig, cost = _launched("lba_terms",
                             lambda: lba.lba_terms_sigma(prob, cam))
    tp = lba.lba_terms_plain(prob, cam)
    assert torch.equal(t.ok_pt, tp.ok_pt) and torch.equal(t.ok_ln, tp.ok_ln)
    if m is not None:
        assert int(t.ok_pt.sum() + t.ok_ln.sum()) == m
    sig_p, cost_p = lba.lba_sigma_plain(t, prob)
    assert torch.equal(sig, sig_p), (float(sig), float(sig_p))
    assert abs(float(cost) - float(cost_p)) <= 1e-5 * abs(float(cost_p))
    # the launch leaves its scratch zeroed: a second launch agrees
    assert torch.equal(lba.lba_terms_sigma(prob, cam)[1], sig)


# -- lba_camera as a thread-block cluster, bow_descend by 8 lanes --------------

# lba_camera's cases: a second fixed pose; a free pose with every
# observation detached; one free pose; the default window's shape (W = 10,
# K = 1,024, L = 128: clusters of 8); K + 2L not a multiple of the cluster's
# slice, with two rounds a CTA, odd K (rows off 16-byte alignment) and the
# Jacobians' last 16-byte piece past the tensor's end
CAMERA_CASES = ("fixed", "empty", "W1", "W10", "ragged", "one_warp")


def camera_case_np(case):
    """lba_problem_np's construction for one of CAMERA_CASES: the dict of
    LBAProblem fields and the camera."""
    kw = {"W1": dict(W=1), "W10": dict(W=10, P=1024, Q=256),
          "ragged": dict(W=3, P=2501, Q=100),
          "one_warp": dict(W=4, P=16, Q=8)}.get(case, {})
    d, cam = lba_problem_np(13, **kw)
    if case == "fixed":
        d["kf_fixed"][2] = True
    elif case == "empty":
        for key in ("obs_pt_id", "obs_ln_sid", "obs_ln_eid"):
            d[key][3] = -1
    elif case == "W1":
        d["kf_fixed"][0] = False
    return d, cam


@pytest.mark.parametrize("case", CAMERA_CASES)
def test_lba_camera_cluster(cuda, case):
    """lba_camera, one cluster launch a call, against its plain version and
    the plain version in float64 under K15's rule (_hold_f64); fixed poses
    and a pose with no valid observation get zero blocks; two launches give
    the same bits (no float atomics)."""
    from plslam_tpu_torch.backend import lba
    d, cam = camera_case_np(case)
    prob = _lba_problem(d, cuda)
    W, K = prob.obs_pt_id.shape
    L = prob.obs_ln_sid.shape[1]
    C, S, T = lba.camera_layout(W, K, L)
    if case == "W10":
        assert (C, S, T) == (8, 160, 160)
    if case == "ragged":
        assert C * S != K + 2 * L and S > T and K % 2 == 1
    if case == "one_warp":
        # a shard of the sharded step at the smallest shapes: a CTA of one
        # warp writes the 42 outputs in two rounds
        assert (C, S, T) == (1, 24, 32)
    t, sigma, _ = lba.lba_terms_sigma_plain(prob, cam)
    free = lba._free(prob)
    got = _launched("lba_camera", lambda: lba.lba_camera(t, sigma, free))
    ref = lba.lba_camera_plain(t, sigma, free)
    _hold_f64(got, ref, lba.lba_camera_plain(_f64(t), sigma.double(), free))
    zero = ~free
    if case == "empty":
        assert bool(free[3])
        zero[3] = True
    assert bool(zero.any()) == (case != "W1")
    assert not bool(got[0][zero].any()) and not bool(got[1][zero].any())
    assert float(got[0][~zero].abs().max()) > 0.0
    for x, y in zip(got, lba.lba_camera(t, sigma, free)):
        assert torch.equal(x, y)


def _ref_vocab_path(kind, k, levels):
    """The reference's shipped vocabulary artifact (the 8 x 4 pair is
    tracked in the repository; the port ships the 10 x 4 pair)."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "plslam_tpu", "data",
        f"vocab_default_{kind}_{k}_{levels}_v2.npz")


def tied_vocabulary_np(k, levels, n, seed):
    """A k^levels tree and n descriptors tied between two children at every
    level: level l's centroids are 0 outside bits [64 l, 64 l + 64), where
    child c of every node sets the 6 bits [64 l + 6 c, 64 l + 6 c + 6);
    each descriptor sets 3 bits of two children's blocks (a != b, drawn
    a level), 6 from both and 12 from every other child. Both the bits and
    the descriptors go through one random permutation of the 256 bit
    positions. Returns (per-level (k^(l+1), 256) uint8 centroids, (n, 256)
    uint8 descriptors, the expected leaves: the first of each pair)."""
    assert 2 <= k <= 10 and levels <= 4
    rng = np.random.default_rng(seed)
    perm = rng.permutation(256)
    block = np.zeros((levels, k, 256), np.uint8)
    for l in range(levels):
        for c in range(k):
            block[l, c, 64 * l + 6 * c: 64 * l + 6 * c + 6] = 1
    cents = [np.tile(block[l], (k ** l, 1))[:, perm] for l in range(levels)]
    desc = np.zeros((n, 256), np.uint8)
    leaves = np.zeros(n, np.int64)
    for i in range(n):
        for l in range(levels):
            a, b = rng.choice(k, 2, replace=False)
            for c in (a, b):
                on = 64 * l + 6 * c + rng.choice(6, 3, replace=False)
                desc[i, on] = 1
            leaves[i] = leaves[i] * k + min(a, b)
    return cents, desc[:, perm], leaves


# bow_descend's cases: (vocabulary, k, n); "ties": tied_vocabulary_np
BOW_CASES = [("orb", 10, 1), ("orb", 10, 128), ("orb", 10, 1024),
             ("lbd", 10, 128), ("orb", 8, 1024), ("lbd", 8, 128),
             ("ties", 10, 1024), ("ties", 8, 128), ("ties", 10, 1)]


@pytest.mark.parametrize("kind,k,n", BOW_CASES)
def test_bow_descend_exact(cuda, kind, k, n):
    """bow_descend (8 lanes a descriptor, the top two levels in shared
    memory) exactly equal to transform_leaves_plain on both shipped
    vocabulary sizes (10 x 4, the port's; 8 x 4, the reference's tracked
    pair) at 1, 128 and 1,024 descriptors (half of them a leaf centroid
    with one bit flipped), and on descriptors tied between two children at
    every level (the first child wins)."""
    from plslam_tpu_torch.loop import vocabulary as voc
    g = torch.Generator().manual_seed(n + k)
    if kind == "ties":
        cents, bits, want = tied_vocabulary_np(k, 4, n, seed=n + k)
        vc = voc._from_levels(cents, np.ones(k ** 4, np.float32), k, "ties",
                              "cpu")
        bits = torch.from_numpy(bits)
    else:
        vc = (voc.default_vocabulary(kind, k, 4, "cpu") if k == 10 else
              voc.load_vocabulary(_ref_vocab_path(kind, k, 4), "cpu"))
        bits = torch.randint(0, 2, (n, 256), generator=g, dtype=torch.uint8)
        leaf = hamming.unpack_bits(voc.level_words(vc, 3)[torch.randint(
            0, k ** 4, (n // 2,), generator=g)])
        leaf[torch.arange(n // 2), torch.randint(0, 256, (n // 2,),
                                                 generator=g)] ^= 1
        bits[: n // 2] = leaf
        want = None
    vg = vc._replace(flat=vc.flat.to(cuda), idf=vc.idf.to(cuda))
    words = hamming.pack_bits(bits)
    got = _launched("bow_descend", lambda: voc.transform_leaves(
        vg, words.to(cuda))).cpu()
    ref = voc.transform_leaves_plain(vc, words)
    assert torch.equal(got, ref)
    if want is not None:
        assert np.array_equal(got.numpy(), want)
