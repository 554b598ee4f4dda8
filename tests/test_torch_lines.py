"""Port parity, the line detector (kernels E, F, G; K4, K8-K11).

The same numpy line fields (noise plus bright strips, 160x200, as
tests/test_line_refit_parity.py renders them) go through
``plslam_tpu.ops.lines`` and the port's plain versions on the CPU. Each
integer stage is fed the reference's own float maps, so a gate or a label
can only differ through the port's code, never through summation order.

Tolerances (measured on these fields in brackets):
  * Sobel gradients and the planes w, d2x, d2y: 1e-6 absolute [0];
  * window moments: 1e-5 of each map's largest magnitude [2e-7]: the
    reference sums blocks with banded matmuls, the port in block order;
  * gates and labels given the reference's maps: exactly equal;
  * ``refit_roots`` given the reference's TileStage: the same candidate
    slots, scores within 1e-5 relative, endpoints within 1e-3 px [5e-5];
  * ``merge_segments`` given the reference's candidates: roots exactly
    equal, scores within 1e-5 relative, endpoints within 1e-3 px [8e-6];
  * ``detect_segments`` end to end: the same valid slots, endpoints
    within 0.05 px [1.7e-4];
  * kernel G's edge cases (test_torch_gpu.py builds them; the card holds
    the kernels to the plain versions on the same cases): candidates,
    roots and labels exactly, scores within 1e-5 relative, endpoints and
    angles within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.ops import image as jimage
from plslam_tpu.ops import lines as jlines
from plslam_tpu_torch.ops import image as timage
from plslam_tpu_torch.ops import lines as tlines
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.frontend.stereo_lines import detect_kwargs
from torch_line_cases import (G_H, G_MERGE_CASES, G_REFIT_CASES, G_W,
                              kernel_g_merge_case, kernel_g_stage, line_field,
                              stripe_field)
from chip_smoke import tile_moments_chain

TILE = 16


def _render_field(seed, H=160, W=200, n_lines=6):
    """Random noise + randomly placed bright line strips."""
    rng = np.random.default_rng(seed)
    img = rng.random((H, W)).astype(np.float32) * 0.06
    for _ in range(n_lines):
        x0 = rng.uniform(10, W - 10)
        y0 = rng.uniform(10, H - 10)
        th = rng.uniform(0, np.pi)
        L = rng.uniform(40, 120)
        t = np.linspace(-L / 2, L / 2, int(3 * L))
        xs = np.clip(x0 + t * np.cos(th), 0, W - 1).astype(int)
        ys = np.clip(y0 + t * np.sin(th), 0, H - 1).astype(int)
        img[ys, xs] = 1.0
    return img


@pytest.fixture(scope="module")
def fields():
    return np.stack([_render_field(s) for s in range(4)])


@pytest.fixture(scope="module")
def ref_stages(fields):
    return [jlines.tile_stage(jnp.asarray(f), tile=TILE) for f in fields]


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_sobel_and_planes_match_reference(fields):
    gx, gy = timage.sobel_gradients(_t(fields))
    w, d2x, d2y = tlines.gradient_planes(_t(fields), 0.02)
    for n, f in enumerate(fields):
        rgx, rgy = jimage.sobel_gradients(jnp.asarray(f))
        np.testing.assert_allclose(gx[n].numpy(), rgx, atol=1e-6, rtol=0)
        np.testing.assert_allclose(gy[n].numpy(), rgy, atol=1e-6, rtol=0)
        mag = jnp.sqrt(rgx * rgx + rgy * rgy)
        rw = jnp.where(mag > 0.02, mag, 0.0)
        ms = jnp.maximum(mag, 1e-9)
        np.testing.assert_allclose(w[n].numpy(), rw, atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            d2x[n].numpy(), jnp.where(rw > 0, (rgx * rgx - rgy * rgy) / ms, 0),
            atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            d2y[n].numpy(), jnp.where(rw > 0, 2.0 * rgx * rgy / ms, 0),
            atol=1e-6, rtol=0)


def _ref_maps(f, u=None, grad_th=0.02):
    """The reference's reweighted window maps of one field, as its
    tile_stage forms them (:330-375); ``u`` replaces its unit
    orientation field."""
    H, W = f.shape
    gx, gy = jimage.sobel_gradients(jnp.asarray(f))
    mag = jnp.sqrt(gx * gx + gy * gy)
    w = jnp.where(mag > grad_th, mag, 0.0)
    ms = jnp.maximum(mag, 1e-9)
    d2x = jnp.where(w > 0, (gx * gx - gy * gy) / ms, 0.0)
    d2y = jnp.where(w > 0, 2.0 * gx * gy / ms, 0.0)
    D2x, D2y = jlines.orientation_maps(d2x, d2y, TILE, 8)
    if u is None:
        d2n = jnp.sqrt(D2x * D2x + D2y * D2y) + 1e-9
        u = (D2x / d2n, D2y / d2n)
    Th, Tw = D2x.shape

    def up(m):
        full = jnp.broadcast_to(m[:, None, :, None], (Th, 8, Tw, 8)
                                ).reshape(Th * 8, Tw * 8)
        return jnp.pad(full, ((4, H - Th * 8 - 4), (4, W - Tw * 8 - 4)),
                       mode="edge")

    al = (d2x * up(jnp.asarray(u[0])) + d2y * up(jnp.asarray(u[1]))
          ) / jnp.maximum(w, 1e-9)
    ratio = jnp.square(jnp.maximum(al, 0.0))
    return (D2x, D2y), jlines.tile_moment_maps(w * ratio, d2x * ratio,
                                               d2y * ratio, TILE, 8)


def test_window_moments_match_reference(fields):
    w, d2x, d2y = tlines.gradient_planes(_t(fields), 0.02)
    D2x, D2y = tlines.orientation_maps(d2x, d2y, TILE, TILE // 2)
    u = torch.rand((2,) + D2x.shape, generator=torch.Generator().manual_seed(0))
    got = tlines.reweighted_moments(w, d2x, d2y, u[0], u[1], TILE, TILE // 2)
    for n, f in enumerate(fields):
        rD, ref = _ref_maps(f, (u[0, n].numpy(), u[1, n].numpy()))
        for g, r in zip((D2x[n], D2y[n]) + tuple(x[n] for x in got),
                        tuple(rD) + tuple(ref)):
            assert _rel(g.numpy(), np.asarray(r)) <= 1e-5


def test_tile_stage_matches_reference(fields, ref_stages):
    got = tlines.tile_stage(_t(fields), tile=TILE)
    for n, ref in enumerate(ref_stages):
        np.testing.assert_array_equal(got.tile_ok[n].numpy(), ref.tile_ok)
        np.testing.assert_array_equal(got.labels[n].numpy(), ref.labels)
        for f in ("S", "Sx", "Sxx", "Sxy", "cx", "l1"):
            assert _rel(getattr(got, f)[n].numpy(),
                        np.asarray(getattr(ref, f))) <= 1e-5


def test_tile_moments_match_reference(fields, ref_stages):
    """tile_moments (kernel E's one launch on the card) on the CPU: the
    line fields, a uint8 first frame (u8_wrap, against the reference's
    tile_stage of the uint8 array) and an image smaller than one CTA's
    16 x 29 windows. Bit for bit the four-step chain it replaced; S..Sxy
    within 1e-5 of each map's largest magnitude of the reference's
    tile_stage, D2x and D2y of its reweighted window maps. The chain is
    chip_smoke.py's ``tile_moments_chain`` (the public functions; on the
    CPU their plain versions)."""
    rng = np.random.default_rng(3)
    u8 = np.round(_render_field(5) * 200
                  + rng.integers(0, 56, (160, 200))).astype(np.uint8)
    small = fields[:, :40, :50]
    cases = [(fields, False, ref_stages),
             (u8[None].astype(np.float32), True,
              [jlines.tile_stage(jnp.asarray(u8), tile=TILE)]),
             (small, False,
              [jlines.tile_stage(jnp.asarray(f), tile=TILE) for f in small])]
    for imgs, wrap, refs in cases:
        x = _t(np.ascontiguousarray(imgs))
        got = tlines.tile_moments(x, TILE, 0.02, u8_wrap=wrap)
        chain = tile_moments_chain(x, TILE, 0.02, u8_wrap=wrap)
        assert len(got) == 8
        for g, c in zip(got, chain):
            assert g.shape == (x.shape[0],) + tlines.tile_grid(
                *x.shape[1:], TILE)
            assert torch.equal(g, c)
        for n, ref in enumerate(refs):
            for g, f in zip(got[:6], ("S", "Sx", "Sy", "Sxx", "Syy", "Sxy")):
                assert _rel(g[n].numpy(), np.asarray(getattr(ref, f))) <= 1e-5
            rimg = np.asarray(imgs[n]).astype(u8.dtype if wrap else np.float32)
            _, maps = _ref_maps(rimg)
            for g, r in zip(got[6:], maps[6:]):
                assert _rel(g[n].numpy(), np.asarray(r)) <= 1e-5
        assert float(got[0].sum()) > 0


def test_gates_and_labels_exact_given_reference_maps(fields, ref_stages):
    """Gates and the 8-sweep label propagation on the reference's own
    window maps: every gate and every label identical."""
    for f, ref in zip(fields, ref_stages):
        _, maps = _ref_maps(f)
        np.testing.assert_array_equal(np.asarray(maps[0]), ref.S)
        tile_ok, angle, cx, cy, dx, dy = tlines.tile_gates(
            *(_t(m)[None] for m in maps), TILE, 1.0, 2.5, 2.2, 0.6)[:6]
        np.testing.assert_array_equal(tile_ok[0].numpy(), ref.tile_ok)
        lab = tlines.propagate_labels(tile_ok, angle, cx, cy, dx, dy, 0.1,
                                      2.0, 8)
        np.testing.assert_array_equal(lab[0].numpy(), ref.labels)
        assert int(np.asarray(ref.tile_ok).sum()) >= 10


_GATE_KEYS = ("tile", "min_support", "elong_th", "perp_spread_th",
              "coherence_th", "merge_ang_th", "merge_dist_th", "merge_iters")


@pytest.mark.parametrize("scene,half,iters", [
    ("lines", False, None), ("lines", True, None), ("stripes", False, None),
    ("stripes", True, None), ("stripes", False, 2)])
def test_gates_and_labels_plain_matches_reference(scene, half, iters):
    """gates_and_labels' plain version (kernel F's function) on the
    reference's own window maps against the reference's tile_stage, with
    the detector's settings at full and half resolution: tile_ok and
    labels identical, cx and l1 within 1e-5 of their largest magnitude.
    The stripes are 32 rows apart, 16 at half resolution. The last case
    runs 2 sweeps over chains of 49 tiles, longer than 2^2: its labels
    stop short of the components, and still agree."""
    img = (line_field(4, n=1) if scene == "lines"
           else stripe_field(1, n=1, period=32))[0].numpy()
    H, W = img.shape
    kw = detect_kwargs(SlamConfig().lines, half, float(np.hypot(H, W)))
    if half:
        img = np.asarray(jimage.resize_bilinear(jnp.asarray(img),
                                                (H // 2, W // 2)))
    if iters is not None:
        kw["merge_iters"] = iters
    ref = jlines.tile_stage(jnp.asarray(img), grad_th=kw["grad_th"],
                            **{k: kw[k] for k in _GATE_KEYS})
    _, maps = _ref_maps(img, grad_th=kw["grad_th"])
    tile_ok, cx, cy, cx_l, cy_l, l1, lab = tlines.gates_and_labels(
        *(_t(m)[None] for m in maps), *(kw[k] for k in _GATE_KEYS))
    np.testing.assert_array_equal(tile_ok[0].numpy(), ref.tile_ok)
    np.testing.assert_array_equal(lab[0].numpy(), ref.labels)
    assert _rel(cx[0].numpy(), np.asarray(ref.cx)) <= 1e-5
    assert _rel(l1[0].numpy(), np.asarray(ref.l1)) <= 1e-5
    n_ok = int(np.asarray(ref.tile_ok).sum())
    n_roots = int((np.asarray(ref.labels) == np.arange(lab[0].numel())
                   .reshape(lab.shape[1:]))[np.asarray(ref.tile_ok)].sum())
    assert n_ok >= 10 and n_roots < n_ok             # real components
    if iters is not None:                            # not converged
        full = tlines.gates_and_labels(
            *(_t(m)[None] for m in maps),
            *(kw[k] for k in _GATE_KEYS[:-1]), 16)[-1]
        assert not torch.equal(full, lab)


def test_label_limit_matches_kernel():
    """LABEL_MAX_TILES is what csrc/lines_label.cu's entry takes: its last
    CTA's shared memory (four int16 planes, the compatibility bytes in
    whole words, the tile_ok mask) fits the card's 232,448 bytes less the
    entry's margin; and the labels fit an int16."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tlines.__file__), os.pardir,
                            "csrc", "lines_label.cu")).read()
    per = eval(re.search(r"BYTES_PER_TILE = ([0-9 *+]+);", src).group(1))
    cap = eval(re.search(r"smem > (232448 - [0-9]+)\)", src).group(1))
    smem = lambda n: n * (per - 1) + (n + 3) // 4 * 4 + (n + 31) // 32 * 4
    n = tlines.LABEL_MAX_TILES
    assert smem(n) <= cap < smem(n + 1)
    assert n + 7 <= 32767


def _kernel_f_labels(tile_ok, angle, cx, cy, dx, dy, ang_th, dist_th, iters):
    """What csrc/lines_label.cu's last CTA of an image does, in numpy:
    over the gated-in tiles, the forward compatibility bits and each
    link's reverse bit on the neighbour; the tiles without a link labelled
    at once; the synchronous sweeps and hops over the linked tiles only,
    stopped once an iteration changes no label."""
    Th, Tw = tile_ok.shape
    n = Th * Tw
    ok = tile_ok.reshape(-1)
    fl = [np.asarray(x, np.float32).reshape(-1)
          for x in (angle, cx, cy, dx, dy)]
    a, x, y, ux, uy = fl
    comp = np.zeros(n, np.uint8)
    for t in np.nonzero(ok)[0]:
        i, j = divmod(t, Tw)
        for d, (di, dj) in enumerate(tlines._NEIGH):
            ni, nj = i + di, j + dj
            if not (0 <= ni < Th and 0 <= nj < Tw) or not ok[ni * Tw + nj]:
                continue
            nt = ni * Tw + nj
            dang = np.abs(a[t] - a[nt])
            dang = min(dang, np.float32(np.pi) - dang)
            off = np.abs(-uy[t] * (x[nt] - x[t]) + ux[t] * (y[nt] - y[t]))
            if dang < np.float32(ang_th) and off < np.float32(dist_th):
                comp[t] |= 1 << d
                comp[nt] |= 1 << (4 + d)
    lab = np.where(ok, np.arange(n), n + 7).astype(np.int64)
    linked = np.nonzero(comp)[0]
    A = lab.copy()
    for _ in range(iters):
        B = A.copy()
        for t in linked:
            for d, (di, dj) in enumerate(tlines._NEIGH):
                off = di * Tw + dj
                if comp[t] >> d & 1:
                    B[t] = min(B[t], A[t + off])
                if comp[t] >> (4 + d) & 1:
                    B[t] = min(B[t], A[t - off])
        hop = A.copy()
        for t in linked:
            hop[t] = min(B[t], B[B[t]])
        if np.array_equal(hop, A):
            break
        A = hop
    return A.reshape(Th, Tw), comp.reshape(Th, Tw)


@pytest.mark.parametrize("field,iters", [("lines", 9), ("stripes", 9),
                                         ("stripes", 2), ("noise", 9)])
def test_unlinked_tiles_keep_first_label(field, iters):
    """A tile with no compatible neighbour keeps its first label (its
    index, or Th*Tw + 7 where gated out) through every sweep and hop of
    the plain version; and the kernel's passes over the linked tiles alone
    (a numpy emulation of csrc/lines_label.cu) give the plain version's
    labels exactly, at any count of linked tiles."""
    x = {"lines": lambda: line_field(4, n=2),
         "stripes": lambda: stripe_field(0, n=2),
         "noise": lambda: torch.from_numpy(np.random.default_rng(2).random(
             (2, 160, 200)).astype(np.float32) * 0.06)}[field]()
    w, d2x, d2y = tlines.gradient_planes(x, 0.02)
    D2x, D2y = tlines.orientation_maps(d2x, d2y, TILE, 8)
    d2n = tlines.sqrt_rn(D2x * D2x + D2y * D2y) + 1e-9
    maps = tlines.reweighted_moments(w, d2x, d2y, D2x / d2n, D2y / d2n,
                                     TILE, 8)
    tile_ok, angle, cx, cy, dx, dy = tlines.tile_gates(
        *maps, TILE, 1.0, 2.5, 2.2, 0.6)[:6]
    lab = tlines.propagate_labels(tile_ok, angle, cx, cy, dx, dy, 0.1, 2.0,
                                  iters)
    N, Th, Tw = lab.shape
    first = torch.where(tile_ok, torch.arange(Th * Tw, dtype=torch.int32
                                              ).reshape(Th, Tw), Th * Tw + 7)
    n_linked = 0
    for b in range(N):
        want, comp = _kernel_f_labels(
            *(t[b].numpy() for t in (tile_ok, angle, cx, cy, dx, dy)),
            0.1, 2.0, iters)
        np.testing.assert_array_equal(lab[b].numpy(), want)
        alone = torch.from_numpy(comp == 0)
        assert torch.equal(lab[b][alone], first[b][alone])
        n_linked += int((comp != 0).sum())
    if field == "noise":
        assert n_linked == 0
    else:
        assert n_linked > (1024 if field == "stripes" else 20)


def test_refit_roots_matches_reference(fields, ref_stages):
    H, W = fields.shape[1:]
    for ref in ref_stages:
        ts = tlines.TileStage(*(_t(x)[None] for x in ref))
        sp, ep, sc = tlines.refit_roots(ts, H, W, TILE, 48, 12.0)
        rsp, rep, rsc = (np.asarray(x) for x in jlines.refit_roots(
            ref, H, W, TILE, 48, 12.0))
        v = rsc > 0
        assert v.sum() >= 4
        np.testing.assert_array_equal(sc[0].numpy() > 0, v)
        assert _rel(sc[0].numpy(), rsc) <= 1e-5
        np.testing.assert_allclose(sp[0].numpy()[v], rsp[v], atol=1e-3)
        np.testing.assert_allclose(ep[0].numpy()[v], rep[v], atol=1e-3)


@pytest.mark.parametrize("gap_th", [14.0, 40.0])
def test_merge_segments_matches_reference(fields, ref_stages, gap_th):
    H, W = fields.shape[1:]
    for ref in ref_stages:
        rsp, rep, rsc = jlines.refit_roots(ref, H, W, TILE, 48, 12.0)
        want = [np.asarray(x) for x in jlines.merge_segments(
            rsp, rep, rsc, rsc > 0, ang_th=0.2, dist_th=2.0, gap_th=gap_th)]
        got = [x[0].numpy() for x in tlines.merge_segments(
            _t(rsp)[None], _t(rep)[None], _t(rsc)[None],
            _t(np.asarray(rsc) > 0)[None], 0.2, 2.0, gap_th)]
        root = want[4]
        np.testing.assert_array_equal(got[4], root)
        assert _rel(got[3], want[3]) <= 1e-5
        for g, r in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g[root], r[root], atol=1e-3)
        np.testing.assert_allclose(got[2][root], want[2][root], atol=1e-5)
        # labels: every valid slot's label is a root of its component
        lab = got[5]
        assert np.all(root[lab[root]]) and np.all(lab[root] == np.nonzero(
            root)[0])


def test_detect_segments_matches_reference(fields):
    got = tlines.detect_segments(_t(fields), 48, tile=TILE)
    for n, f in enumerate(fields):
        ref = jlines.detect_segments(jnp.asarray(f), 48, tile=TILE)
        v = np.asarray(ref.valid)
        assert v.sum() >= 3
        np.testing.assert_array_equal(got.valid[n].numpy(), v)
        np.testing.assert_allclose(got.score[n].numpy(), ref.score,
                                   rtol=1e-5, atol=0)
        np.testing.assert_allclose(got.sp[n].numpy()[v],
                                   np.asarray(ref.sp)[v], atol=0.05)
        np.testing.assert_allclose(got.ep[n].numpy()[v],
                                   np.asarray(ref.ep)[v], atol=0.05)


def _merge_labels_np(sp, ep, valid, ang_th, dist_th, gap_th, iters):
    """The reference's merge labels (plslam_tpu/ops/lines.py:254-271) in
    float64 numpy, for cases whose tests are far from their thresholds."""
    M = sp.shape[0]
    mid = 0.5 * (sp + ep)
    d = ep - sp
    du = d / np.sqrt((d * d).sum(-1) + 1e-12)[:, None]
    du = np.where((du[:, 0] < 0)[:, None], -du, du)
    ang = np.arctan2(du[:, 1], du[:, 0])
    da = np.abs(ang[:, None] - ang[None, :])
    da = np.minimum(da, np.pi - da)
    rel = mid[None, :, :] - mid[:, None, :]
    off = np.abs(-du[:, None, 1] * rel[..., 0] + du[:, None, 0] * rel[..., 1])
    pm = du[:, None, 0] * rel[..., 0] + du[:, None, 1] * rel[..., 1]
    half = 0.5 * np.sqrt((d * d).sum(-1))
    gap = np.abs(pm) - (half[:, None] + half[None, :])
    ok = ((da < ang_th) & (off < dist_th) & (gap < gap_th)
          & valid[:, None] & valid[None, :])
    ok = ok & ok.T
    lab = np.where(valid, np.arange(M), M)
    for _ in range(iters):
        lab = np.minimum(lab, np.where(ok, lab[None, :], M).min(1))
        lab = np.minimum(lab, lab[np.clip(lab, 0, M - 1)])
    return lab


def _hold_merge_to_reference(got, want, lab):
    root = want[4]
    np.testing.assert_array_equal(got[4], root)
    np.testing.assert_array_equal(got[5], lab)
    if root.any():
        assert _rel(got[3], want[3]) <= 1e-5
        for g, r in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g[root], r[root], atol=1e-3)


@pytest.mark.parametrize("case", G_REFIT_CASES)
def test_refit_and_merge_edge_cases_match_reference(case):
    """refit_roots, then merge_segments on its candidates, against the
    reference on kernel G's refit cases, image by image."""
    ts, ml = kernel_g_stage(case)
    sp, ep, sc = tlines.refit_roots(ts, G_H, G_W, TILE, ml, 12.0)
    assert sp.shape[1] == 2 * ml
    N, Th, Tw = ts.labels.shape
    n = Th * Tw
    n_roots = (ts.tile_ok & (ts.labels == torch.arange(n, dtype=torch.int32
                                                       ).reshape(Th, Tw))
               ).reshape(N, n).sum(1)
    if case == "many_roots":
        assert int(n_roots.min()) > 8 * ml          # more roots than R
    if case == "invalid_member":
        plain, _ = kernel_g_stage("m40")
        before = tlines.refit_roots(plain, G_H, G_W, TILE, ml, 12.0)
        assert not torch.equal(before[1], ep)       # the projection grew
    for b in range(N):
        jts = jlines.TileStage(*(jnp.asarray(x[b].numpy()) for x in ts))
        rsp, rsc_ep, rsc = (np.asarray(x) for x in jlines.refit_roots(
            jts, G_H, G_W, TILE, ml, 12.0))
        v = rsc > 0
        np.testing.assert_array_equal(sc[b].numpy() > 0, v)
        assert v.any() == (case != "no_root")
        if v.any():
            assert _rel(sc[b].numpy(), rsc) <= 1e-5
            np.testing.assert_allclose(sp[b].numpy()[v], rsp[v], atol=1e-3)
            np.testing.assert_allclose(ep[b].numpy()[v], rsc_ep[v],
                                       atol=1e-3)
        want = [np.asarray(x) for x in jlines.merge_segments(
            rsp, rsc_ep, rsc, v, ang_th=0.2, dist_th=2.0, gap_th=14.0)]
        got = [x[0].numpy() for x in tlines.merge_segments(
            _t(rsp)[None], _t(rsc_ep)[None], _t(rsc)[None], _t(v)[None],
            0.2, 2.0, 14.0)]
        root = want[4]
        np.testing.assert_array_equal(got[4], root)
        if root.any():
            assert _rel(got[3], want[3]) <= 1e-5
            for g, r in zip(got[:3], want[:3]):
                np.testing.assert_allclose(g[root], r[root], atol=1e-3)
        # labels: every valid slot's label is a root of its component
        lab = got[5]
        assert np.all(root[lab[v]]) and np.all(lab[root] == np.nonzero(
            root)[0])


@pytest.mark.parametrize("case", G_MERGE_CASES)
def test_merge_edge_cases_match_reference(case):
    """merge_segments against the reference (roots, scores, endpoints,
    angles) and its labels against the reference's label loop, on the
    chain longer than the sweeps and the lines across the +-pi/2 flip."""
    sp, ep, sc, v, iters = kernel_g_merge_case(case)
    got = [x[0].numpy() for x in tlines.merge_segments(
        sp, ep, sc, v, 0.2, 2.0, 14.0, iters)]
    want = [np.asarray(x) for x in jlines.merge_segments(
        sp[0].numpy(), ep[0].numpy(), sc[0].numpy(), v[0].numpy(),
        ang_th=0.2, dist_th=2.0, gap_th=14.0, iters=iters)]
    lab = _merge_labels_np(sp[0].double().numpy(), ep[0].double().numpy(),
                           v[0].numpy(), 0.2, 2.0, 14.0, iters)
    _hold_merge_to_reference(got, want, lab)
    frag = np.nonzero(v[0].numpy())[0]
    if case == "chain":
        full = _merge_labels_np(sp[0].double().numpy(),
                                ep[0].double().numpy(), v[0].numpy(), 0.2,
                                2.0, 14.0, 16)
        assert len(set(full[frag])) == 3            # two chains, one cross
        assert len(set(lab[frag])) > 3              # 2 sweeps: not yet
    else:
        assert len(set(lab[frag])) == 1             # one line
        ang = sp.new_tensor(0.0) + float(got[2][got[4]][0])
        assert abs(abs(float(ang)) - np.pi / 2) < 0.01
