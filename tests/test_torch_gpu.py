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
from plslam_tpu_torch.ops import fast, hamming, image, orb

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
