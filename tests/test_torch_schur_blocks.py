"""The owner-sharded step's two K15 entries, on the CPU: the launch plan of
``lba_schur_corr`` (``backend/lba.py::schur_corr_layout``) and the pose
masks it leaves, and the block factorization that
``lba_solve_reduced``'s kernel does (``csrc/lba.cu``:
``schur_corr_kernel``, ``solve_reduced_kernel``).

The kernels run only on the card (``tests/test_torch_gpu.py`` holds them
against their plain versions there). Here:

  * the layout covers every landmark once for every W in 1..16 and N in
    1..65,535, with no CTA idle and a CTA's shared memory within the
    227 KB an H100 CTA may hold; it raises past that;
  * on shard 0 of 2 and of 4 of ``chip_smoke.lba_window_problem``, the
    plan that the layout gives and each landmark's pose mask, which the
    kernel leaves in the scratch for ``lba_solve_reduced``;
  * ``block_ldl_solve``, a float64 model of the kernel's factorization
    (S = L D L^T by 6 x 6 pose blocks, each D_k inverted by the symmetric
    sweep, the gradient carried as a last block row, then L^T x = z),
    against ``torch.linalg.solve_ex`` in float64 on the reduced systems of
    those shards (built through the plain versions and the mesh's psum),
    on systems with pinned poses, with no free pose and with nearly
    singular endpoint blocks: every pivot positive, the solution within
    1e-9 of solve_ex's, and the whole step (``reduced_step_model``, the
    kernel's assembly, factorization, mask and landmark steps) within
    K15's rule: 3x the plain version's distance from float64 + 1e-5,
    relative to each output's largest magnitude;
  * an indefinite S: a pivot that is not positive, and a step that is NaN
    everywhere (which the LM rejects).
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from plslam_tpu_torch.backend import lba as tlba
from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.parallel import dist_lba as tdist
from plslam_tpu_torch.parallel.mesh import make_mesh

_CTA_BYTES = 227 * 1024       # the shared memory an H100 CTA may hold


# -- lba_schur_corr's launch plan ----------------------------------------------

@pytest.mark.parametrize("W", range(1, 17))
def test_schur_corr_layout_covers_every_landmark(W):
    """For N = 1..65,535: ceil(N / CH) chunks of CH landmarks cover N; the
    C CTAs' runs [c per, (c + 1) per) cover every chunk once, each CTA
    takes at least one, and a CTA's shared bytes (the dynamic ones and
    the 16 KB left for the static arrays) fit 227 KB. The chunk is the
    least multiple of 32 that spreads N over 16 CTAs, up to the largest
    that fits: 128 landmarks up to W = 9, 96 up to W = 11 (the path's
    window, 10, among them), 64 up to W = 14, then 32."""
    cap = 128 if W <= 9 else 96 if W <= 11 else 64 if W <= 14 else 32
    assert tlba.corr_smem(W, cap) <= tlba.CORR_MAX_SMEM
    assert cap == 128 or tlba.corr_smem(W, cap + 32) > tlba.CORR_MAX_SMEM
    for N in range(1, 65536):
        C, CH, per = tlba.schur_corr_layout(W, N)
        G = -(-N // CH)
        assert 1 <= C <= tlba.CORR_MAX_C and 32 <= CH <= cap
        assert CH % 32 == 0 and CH == min(cap, 32 * -(-N // 512))
        assert G * CH >= N > (G - 1) * CH
        assert C * per >= G > (C - 1) * per
        assert tlba.corr_smem(W, CH) <= tlba.CORR_MAX_SMEM
    assert tlba.CORR_MAX_SMEM + 16 * 1024 <= _CTA_BYTES


@pytest.mark.parametrize("shape", [(0, 10), (17, 10), (10, 0), (10, 65536),
                                   (-1, 5)])
def test_schur_corr_layout_refuses_what_the_launch_cannot_take(shape):
    with pytest.raises(ValueError):
        tlba.schur_corr_layout(*shape)


def test_schur_corr_constants_match_kernel():
    """The plans' limits are csrc/lba.cu's: lba_schur_corr's cluster,
    largest chunk and dynamic shared memory a CTA; lba_solve_reduced's
    threads and stepping CTAs."""
    src = open(os.path.join(os.path.dirname(tlba.__file__), os.pardir,
                            "csrc", "lba.cu")).read()
    consts = {k: eval(v) for k, v in re.findall(
        r"constexpr int ((?:CORR|RED)_\w+) = ([^;]+);", src)}
    assert consts["CORR_MAX_C"] == tlba.CORR_MAX_C
    assert consts["CORR_MAX_CH"] == max(tlba.CORR_CHUNKS)
    assert consts["CORR_MAX_SMEM"] == tlba.CORR_MAX_SMEM
    assert consts["RED_MAX_S"] == tlba.RED_MAX_S
    assert consts["RED_NT"] == tlba.RED_NT
    assert [tlba.solve_reduced_cluster(N) for N in (1, 512, 513, 1280, 3584,
                                                    3585, 65535)] == [
        2, 2, 3, 4, 8, 8, 8]


# -- the shards' systems ---------------------------------------------------------

@pytest.fixture(scope="module")
def window():
    from chip_smoke import lba_window_problem
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    return cfg, cam, lba_window_problem("cpu", cfg, cam)


def _kernel_sums(b, free):
    """corr and g_corr as lba_schur_corr's kernel gives them: float64 sums
    of the float32 blocks, rounded once, corr[v][w] the transpose of
    corr[w][v] (lba_schur_corr_plain's float32 sums differ from their
    mirror in the last bits)."""
    corr, g_corr = tlba.lba_schur_corr_plain(_f64(b), free)
    W = corr.shape[0]
    up = torch.triu(torch.ones((W, W), dtype=torch.bool))[..., None, None]
    corr = corr.float()
    return torch.where(up, corr, corr.permute(1, 0, 3, 2)), g_corr.float()


def _shard_system(window, n, lam=None, bend=None, sums=None):
    """Shard 0 of n of the window (``bend`` edits the whole problem first)
    through the plain versions, its H_cc, g_c, corr and g_corr all-reduced
    by the mesh's psum (``sums``: the shards' corr and g_corr, by default
    lba_schur_corr_plain): (H_cc, g_c, corr, g_corr, blocks, free, lam,
    problem, index)."""
    cfg, cam, prob = window
    if bend is not None:
        prob = bend(prob)
    mesh = make_mesh(n, ("lm",), "cpu")
    probs = tdist.shard_problem(mesh,
                                tdist.bucket_problem_by_owner(prob, n).problem)
    lam = torch.tensor(cfg.mapping.lambda_init if lam is None else lam)
    tp = [tlba.lba_terms_plain(p, cam) for p in probs]
    sigma = tdist._shard_scale(mesh, tp, "lm")
    free = [tlba._free(p) for p in probs]
    cams = [tlba.lba_camera_plain(t, s, f) for t, s, f in zip(tp, sigma, free)]
    H_cc = mesh.psum([c[0] for c in cams], "lm")
    g_c = mesh.psum([c[1] for c in cams], "lm")
    bs = [tlba.LandmarkBlocks(h, g, *tlba.lba_bin_plain(t, p, s, f, lam))
          for h, g, t, p, s, f in zip(H_cc, g_c, tp, probs, sigma, free)]
    sums = [(sums or tlba.lba_schur_corr_plain)(b, f)
            for b, f in zip(bs, free)]
    corr = mesh.psum([s[0] for s in sums], "lm")
    g_corr = mesh.psum([s[1] for s in sums], "lm")
    return (H_cc[0], g_c[0], corr[0], g_corr[0], bs[0], free[0], lam,
            probs[0], tlba.lba_index_plain(probs[0]))


def _f64(nt):
    return type(nt)(*(x.double() if x.is_floating_point() else x
                      for x in nt))


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp(min=1e-30))


# -- lba_schur_corr's plan and pose masks --------------------------------------

def _pose_masks(index, free, W, K, L):
    """Each landmark's pose mask as the kernel leaves it in the scratch: bit
    w set where free pose w observes it."""
    fr = free.numpy()
    off, obs = index.off.numpy(), index.obs.numpy()
    masks = np.zeros(len(off) - 1, np.int64)
    for n in range(len(masks)):
        for g in obs[off[n]:off[n + 1]]:
            w = g // K if g < W * K else (g - W * K) // (2 * L)
            if fr[w]:
                masks[n] |= 1 << w
    return masks


@pytest.mark.parametrize("n", [2, 4])
def test_schur_corr_layout_and_pose_masks(window, n):
    """On shard 0 of n (W = 10, 2,560 or 1,280 landmarks) the plan is 27
    chunks of 96 over 14 CTAs, or 14 CTAs of one chunk of 96; each
    landmark's pose mask names exactly its observing free poses."""
    H_cc, g_c, corr, g_corr, b, free, lam, p, idx = _shard_system(window, n)
    K, L = p.obs_pt_id.shape[1], p.obs_ln_sid.shape[1]
    W, N = b.H_cl.shape[:2]
    C, CH, per = tlba.schur_corr_layout(W, N)
    assert (C, CH, per) == ((14, 96, 2) if n == 2 else (14, 96, 1))
    masks = _pose_masks(idx, free, W, K, L)
    assert masks.shape == (N,)
    seen = (b.H_cl.abs().sum((2, 3)) > 0).T.numpy()     # (N, W)
    bits = (masks[:, None] >> np.arange(W)) & 1
    assert np.array_equal(bits.astype(bool) | ~seen, np.ones_like(seen))
    assert not bits[:, ~free.numpy()].any()


# -- lba_solve_reduced's block factorization, modelled ---------------------------

_NAN = float("nan")


def sweep_inverse(D):
    """The kernel's sweep_inverse in float64: D (6 x 6, symmetric; its
    lower triangle read) swept on each index in turn (Gauss-Jordan, no
    pivoting) -> (D^-1, the 6 pivots); a pivot that is not positive is
    made NaN, and NaN then fills everything after it."""
    D = torch.tril(D) + torch.tril(D, -1).T
    pivots = []
    for k in range(6):
        p = float(D[k, k])
        pivots.append(p)
        if not p > 0.0:
            p = _NAN
        inv = 1.0 / p
        col = D[:, k].clone()
        new = D - torch.outer(col, col) * inv
        new[k, :] = D[k, :] * inv
        new[:, k] = D[:, k] * inv
        new[k, k] = -inv
        D = new
    return -D, pivots


def block_ldl_solve(S, g):
    """The kernel's factorization in float64: S (6F x 6F) = L D L^T by 6 x
    6 blocks with the gradient as a last block row, then L^T x = z. ->
    (x, the 6F pivots)."""
    F = S.shape[0] // 6
    A = torch.cat([S, g[None]]).clone()      # (6F + 1) x 6F, lower used
    z = torch.zeros(6 * F, dtype=S.dtype)
    Lt = torch.zeros_like(S)                 # L_ik^T above the diagonal
    pivots = []
    for k in range(F):
        kk, rest = slice(6 * k, 6 * k + 6), slice(6 * k + 6, 6 * F + 1)
        Q, piv = sweep_inverse(A[kk, kk])
        pivots += piv
        panel = A[rest, kk] @ Q                 # rows: L_ik, then z_k
        Lt[kk, 6 * k + 6:] = panel[:-1].T
        z[kk] = panel[-1]
        A[rest, 6 * k + 6:] -= panel @ A[6 * k + 6:6 * F, kk].T
    x = z.clone()
    for i in range(F - 1, -1, -1):
        x[:6 * i] -= Lt[:6 * i, 6 * i:6 * i + 6] @ x[6 * i:6 * i + 6]
    return x, pivots


def reduced_system64(H_cc, g_c, corr, g_corr, free, lam, pin_weight):
    """S and g of the free poses as the kernel assembles them, float64 from
    the float32 inputs (the damping and floor in float32): S's symmetric
    part, each entry the mean of the inputs' two mirrored ones (the same
    entry where H_cc and corr are symmetric, as their kernels write them;
    the plain versions' float32 sums may differ in the last bits)."""
    idx = free.nonzero()[:, 0]
    F = idx.numel()
    S = torch.zeros((6 * F, 6 * F), dtype=torch.float64)
    g = torch.zeros(6 * F, dtype=torch.float64)
    for i, w in enumerate(idx.tolist()):
        g[6 * i:6 * i + 6] = g_c[w].double() - g_corr[w].double()
        for j, v in enumerate(idx.tolist()):
            S[6 * i:6 * i + 6, 6 * j:6 * j + 6] = -corr[w, v].double()
        diag = torch.diagonal(H_cc[w])
        damp = (lam.float() * torch.clamp(diag, min=1e-3) + 1e-6).double()
        pin = 0.0 if float(diag.sum()) > 1.0 else pin_weight
        S[6 * i:6 * i + 6, 6 * i:6 * i + 6] += H_cc[w].double()
        S[6 * i:6 * i + 6, 6 * i:6 * i + 6] += torch.diag(damp + pin)
    return 0.5 * (S + S.T), g


def reduced_step_model(H_cc, g_c, corr, g_corr, b, free, lam, P,
                       pin_weight=tlba.PIN_WEIGHT, cap=True):
    """lba_solve_reduced's arithmetic in float64: the assembly, the block
    factorization, the free mask; the landmark steps from it. -> ((dxi,
    d_pt, d_ep), pivots)."""
    S, g = reduced_system64(H_cc, g_c, corr, g_corr, free, lam, pin_weight)
    x, pivots = block_ldl_solve(S, g)
    dxi = torch.zeros((free.numel(), 6), dtype=torch.float64)
    dxi[free] = -x.reshape(-1, 6)
    return tlba.lba_backsub_plain(_f64(b), dxi, P, cap), pivots


def _hold_k15(got, ref, truth):
    for x, r, t in zip(got, ref, truth):
        bound = 3.0 * _rel(r, t) + 1e-5
        assert _rel(x, t) <= bound and _rel(x, r) <= bound, (
            _rel(x, t), _rel(x, r), bound)


def _check_case(system, expect_free=None):
    H_cc, g_c, corr, g_corr, b, free, lam, p, _ = system
    P = p.pt_pos.shape[0]
    if expect_free is not None:
        assert int(free.sum()) == expect_free
    S, g = reduced_system64(H_cc, g_c, corr, g_corr, free, lam,
                            tlba.PIN_WEIGHT)
    x, pivots = block_ldl_solve(S, g)
    assert all(v > 0.0 for v in pivots)
    if S.numel():
        ref = torch.linalg.solve_ex(S, g[:, None])[0][:, 0]
        assert _rel(x, ref) <= 1e-9
    for cap in (True, False):
        got, _ = reduced_step_model(H_cc, g_c, corr, g_corr, b, free, lam, P,
                                    cap=cap)
        ref = tlba.lba_solve_reduced_plain(H_cc, g_c, corr, g_corr, b, free,
                                           lam, P, cap=cap)
        truth = tlba.lba_solve_reduced_plain(
            H_cc.double(), g_c.double(), corr.double(), g_corr.double(),
            _f64(b), free, lam.double(), P, cap=cap)
        _hold_k15(got, ref, truth)
    return x


@pytest.mark.parametrize("n", [2, 4])
def test_block_ldl_on_the_shards_reduced_systems(window, n):
    """Shard 0 of n: 6 free poses of 10, 36 unknowns."""
    _check_case(_shard_system(window, n), expect_free=6)


def _pin_kf(prob):
    """Free KF 5 (the second free pose) with every observation detached
    (no support: its pin holds it) and KF 6 left with four points and no
    lines."""
    ids = [x.clone() for x in (prob.obs_pt_id, prob.obs_ln_sid,
                               prob.obs_ln_eid)]
    for x in ids:
        x[5] = -1
    ids[0][6, 4:] = -1
    ids[1][6] = ids[2][6] = -1
    return prob._replace(obs_pt_id=ids[0], obs_ln_sid=ids[1],
                         obs_ln_eid=ids[2])


def test_block_ldl_with_pinned_poses(window):
    x = _check_case(_shard_system(window, 4, bend=_pin_kf), expect_free=6)
    # KF 5: pinned, with no coupling and no gradient, it does not move
    assert not x[6:12].any()


def test_block_ldl_with_no_free_pose(window):
    """Every pose fixed: an empty system (F = 0), a zero pose step and the
    landmarks stepped from their own gradients."""
    fix = lambda p: p._replace(kf_fixed=torch.ones_like(p.kf_fixed))
    H_cc, g_c, corr, g_corr, b, free, lam, p, _ = _shard_system(
        window, 2, bend=fix)
    _check_case((H_cc, g_c, corr, g_corr, b, free, lam, p, None),
                expect_free=0)
    (dxi, d_pt, _), pivots = reduced_step_model(
        H_cc, g_c, corr, g_corr, b, free, lam, p.pt_pos.shape[0])
    assert pivots == [] and not dxi.any() and d_pt.abs().max() > 0


def test_block_ldl_with_nearly_singular_endpoint_blocks(window):
    """The endpoints' blocks, each observed along one line direction, are
    almost singular across it (their eigenvalues' ratio under 1e-6), and
    at lam 1e-6, under the smallest the LM reaches (1e-3 / 3^5 after five
    accepted steps), little damping props them up: S stays positive
    definite. Their inverses' entries are far larger here, and
    lba_schur_corr_plain's float32 sums then differ from their mirror far
    beyond the last bits, which moves the plain LU's answer away from the
    symmetric one that the kernel solves: the sums are the kernel's
    (_kernel_sums), which the path all-reduces, and which the plain
    versions then solve too."""
    system = _shard_system(window, 4, lam=1e-6, sums=_kernel_sums)
    b = system[4]
    P = system[7].pt_pos.shape[0]
    ev = torch.linalg.eigvalsh(b.H_ll[P:].double())
    assert float((ev[:, 0] / ev[:, 2].clamp(min=1e-30)).median()) < 1e-6
    _check_case(system, expect_free=6)


def test_block_ldl_indefinite_gives_nan():
    """A symmetric S with a negative direction in its second block: the
    sweep meets a pivot that is not positive, and the whole solution is
    NaN (the step the LM rejects)."""
    rng = np.random.default_rng(0)
    F = 3
    M = rng.normal(size=(6 * F, 6 * F))
    S = torch.from_numpy(M @ M.T + 6 * F * np.eye(6 * F))
    S[8, 8] = -50.0
    g = torch.from_numpy(rng.normal(size=6 * F))
    x, pivots = block_ldl_solve(S, g)
    assert all(v > 0.0 for v in pivots[:8]) and pivots[8] <= 0.0
    assert all(math.isnan(v) for v in pivots[9:])
    assert torch.isnan(x).all()
