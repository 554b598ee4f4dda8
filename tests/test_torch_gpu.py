"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs a CUDA device: every test takes the ``cuda`` fixture, which skips
where there is none (decided when the test runs, never at import). On the
card: ``python -m pytest -m gpu tests/test_torch_gpu.py``. Bits, masks,
indices and the FAST score must be exactly equal; filter and resize
outputs agree to 1e-6 absolute (FMA contraction) for images in [0, 1].
"""

import numpy as np
import pytest
import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.ops import fast, hamming, image, lbd, lines, orb

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


def test_orb_bits_exact(cuda):
    x = _imgs((2, 120, 200), seed=2)
    flat = x.reshape(2, -1)
    g = torch.Generator().manual_seed(0)
    u = torch.randint(15, 185, (2, 300), generator=g)
    v = torch.randint(15, 105, (2, 300), generator=g)
    center = (v * 200 + u).to(torch.int32)
    width = torch.full((2, 300), 200, dtype=torch.int32)
    bins = torch.randint(0, 32, (2, 300), generator=g).to(torch.int32)
    got = _launched("orb_describe", lambda: orb.pool_bits(
        flat.to(cuda), center.to(cuda), width.to(cuda), bins.to(cuda)))
    assert torch.equal(got.cpu(), orb.pool_bits_plain(flat, center, width,
                                                      bins))


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


def _line_field(seed, n=3, H=160, W=200, n_lines=8):
    """Noise plus bright straight strips: line-detector inputs."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, H, W)).astype(np.float32) * 0.06
    for k in range(n):
        for _ in range(n_lines):
            x0, y0 = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
            th, L = rng.uniform(0, np.pi), rng.uniform(40, 120)
            t = np.linspace(-L / 2, L / 2, int(3 * L))
            xs = np.clip(x0 + t * np.cos(th), 0, W - 1).astype(int)
            ys = np.clip(y0 + t * np.sin(th), 0, H - 1).astype(int)
            img[k, ys, xs] = 1.0
    return torch.from_numpy(img)


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_lines_sobel_and_moments(cuda):
    x = _line_field(3)
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


def _tile_inputs(x):
    w, d2x, d2y = lines.gradient_planes_plain(x, 0.02)
    D2x, D2y = lines.orientation_maps_plain(d2x, d2y, 16, 8)
    d2n = torch.sqrt(D2x * D2x + D2y * D2y) + 1e-9
    m = lines.reweighted_moments_plain(w, d2x, d2y, D2x / d2n, D2y / d2n,
                                       16, 8)
    return lines.tile_gates(*m, 16, 1.0, 2.5, 2.2, 0.6)


def test_lines_labels_exact(cuda):
    tile_ok, angle, cx, cy, dx, dy = _tile_inputs(_line_field(4))[:6]
    args = (tile_ok, angle, cx, cy, dx, dy)
    ref = lines.propagate_labels_plain(*args, 0.1, 2.0, 9)
    got = _launched("lines_label", lambda: lines.propagate_labels(
        *(t.to(cuda) for t in args), 0.1, 2.0, 9))
    assert torch.equal(got.cpu(), ref)
    assert int((ref == torch.arange(ref[0].numel()).reshape(ref.shape[1:])
                ).sum()) > 10                       # real components


def test_lines_refit_and_merge(cuda):
    x = _line_field(5)
    ts = lines.tile_stage(x, tile=16)
    H, W = x.shape[1:]
    before = native.LAUNCHES["lines_refit"]
    sp, ep, sc = lines.refit_roots(
        lines.TileStage(*(t.to(cuda) for t in ts)), H, W, 16, 48, 12.0)
    torch.cuda.synchronize()
    assert native.LAUNCHES["lines_refit"] == before + 1
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


def test_lbd_bits_exact(cuda):
    x = _line_field(6)
    gx, gy = image.sobel_gradients_plain(x)
    g = torch.Generator().manual_seed(2)
    sp = torch.rand((3, 40, 2), generator=g) * torch.tensor([199., 159.])
    ep = sp + torch.randn((3, 40, 2), generator=g) * 30
    ref = lbd.describe_lines_plain(gx, gy, sp, ep, 9, 3, 24, 2)
    got = _launched("lbd_describe", lambda: lbd.describe_lines(
        gx.to(cuda), gy.to(cuda), sp.to(cuda), ep.to(cuda), 9, 3, 24, 2))
    assert torch.equal(got.cpu(), ref)


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
