"""Port parity of the loop closer's parts: vocabulary (K17), database,
covisibility, the per-KF probe, verification, landmark fusion and the
graph correction.

The same numpy inputs, made from a seed, go through the jitted JAX
function and the port's plain version (CPU tensors). Tolerances, each
stated where it is held:
  * the vocabulary artifacts: byte-identical copies;
  * leaf ids, candidates, votes, the funnel counters, covisibility counts
    and every integer field of the fused map: exactly equal;
  * BoW vectors and scores: 1e-6 absolute (f32 sums of 10,000 leaves in
    another order, ~1e-7 relative); the smallest |rel - lc_mat| and the
    smallest gap between ranked candidates are printed, so that a flip
    could be told from a fault;
  * idf of a built vocabulary: 1e-6; its centroids identical;
  * verification: equal ``good`` and inliers, T_ab within 1e-5 on the
    well-conditioned pair, the floored uncertainty on the same side of
    lc_unc (the degenerate pair's T is free along its weak axis);
  * the graph correction: 1e-6 absolute (poses and points of unit scale).
"""

import dataclasses
import filecmp
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from plslam_tpu.backend import map as jmap
from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.loop import database as jdb
from plslam_tpu.loop import loop_closer as jlc
from plslam_tpu.loop import vocabulary as jvoc
from plslam_tpu.ops import hamming as jham
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import map as tmap
from plslam_tpu_torch.loop import database as tdb
from plslam_tpu_torch.loop import loop_closer as tlc
from plslam_tpu_torch.loop import vocabulary as tvoc

CFG = SlamConfig().with_updates({
    "points": {"max_kpts": 128}, "lines": {"max_lines": 32},
    "mapping": {"max_kfs": 16, "max_points": 512, "max_lines": 64}})
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def vocs():
    """(reference, port) default vocabularies of both families."""
    out = {}
    for kind in ("orb", "lbd"):
        out[kind] = (jvoc.default_vocabulary(kind, 10, 4),
                     tvoc.default_vocabulary(kind, 10, 4, "cpu"))
    return out


def test_vocabulary_artifacts_are_byte_copies(vocs):
    for kind in ("orb", "lbd"):
        ref_path = jvoc._DEFAULT_PATH.replace(
            ".npz", f"_{kind}_10_4_v{jvoc._VOCAB_VERSION}.npz")
        assert filecmp.cmp(ref_path, tvoc.default_path(kind, 10, 4),
                           shallow=False)
        j, t = vocs[kind]
        np.testing.assert_array_equal(t.idf.numpy(), np.asarray(j.idf))
        for cj, ct in zip(j.centroids, tvoc.level_bits(t)):
            np.testing.assert_array_equal(ct, np.asarray(cj))


def _descriptors(voc_j, n, seed):
    """Random descriptors, half of them leaf centroids with a few bits
    flipped (deep descents, near-ties at every level)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    leaves = np.asarray(voc_j.centroids[-1])
    pick = leaves[rng.integers(0, len(leaves), n // 2)].copy()
    for row in pick:
        row[rng.choice(256, 3, replace=False)] ^= 1
    d[: n // 2] = pick
    return d


@pytest.mark.parametrize("kind,n", [("orb", 1024), ("lbd", 128)])
def test_transform_leaves_exact(vocs, kind, n):
    j, t = vocs[kind]
    d = _descriptors(j, n, seed=n)
    want = np.asarray(jvoc.transform_leaves(j, jnp.asarray(d)))
    for x in (torch.from_numpy(d), tvoc.hamming.pack_bits(torch.from_numpy(d))):
        np.testing.assert_array_equal(tvoc.transform_leaves(t, x).numpy(),
                                      want)


def test_transform_leaves_exact_on_a_keyframe(vocs):
    """The descriptors of a real frame (the port's front end on a
    synthetic scene) descend to the same leaves."""
    from plslam_tpu.core.camera import StereoCamera
    from plslam_tpu.io import synthetic
    from plslam_tpu_torch.frontend.stereo_lines import (
        detect_and_describe_lines)
    from plslam_tpu_torch.tracking.batch_vo import extract_one
    cfg = SlamConfig().with_updates({
        "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
                   "cx": 160.0, "cy": 120.0, "baseline": 0.3},
        "points": {"max_kpts": 256, "orb_nlevels": 2},
        "lines": {"max_lines": 32}})
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=1, seed=4, n_points=300,
                                  n_lines=40)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    tcam = convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.b,
                                     cam.width, cam.height)
    pts, _ = extract_one(torch.from_numpy(seq.images_l[0]),
                         torch.from_numpy(seq.images_r[0]), tcam, tcfg)
    segs, ldesc = detect_and_describe_lines(
        torch.from_numpy(np.asarray(seq.images_l[:1])), tcfg)
    for kind, desc, valid in (("orb", pts.desc, pts.valid),
                              ("lbd", ldesc[0], segs.valid[0])):
        j, t = vocs[kind]
        d = desc.numpy()[valid.numpy()]
        assert len(d) >= 20
        np.testing.assert_array_equal(
            tvoc.transform_leaves(t, torch.from_numpy(d)).numpy(),
            np.asarray(jvoc.transform_leaves(j, jnp.asarray(d))))


def test_bow_vector_and_l1_score(vocs):
    rng = np.random.default_rng(3)
    for kind, n in (("orb", 1024), ("lbd", 128)):
        j, t = vocs[kind]
        ds = [_descriptors(j, n, seed=s) for s in range(3)]
        valid = rng.random((3, n)) > 0.2
        vj = [np.asarray(jvoc.bow_vector(j, jnp.asarray(d), jnp.asarray(v)))
              for d, v in zip(ds, valid)]
        vt = [tvoc.bow_vector(t, torch.from_numpy(d), torch.from_numpy(v))
              for d, v in zip(ds, valid)]
        for a, b in zip(vt, vj):
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
        sj = np.asarray(jvoc.l1_score(jnp.asarray(np.stack(vj)),
                                      jnp.asarray(vj[0])[None]))
        st = tvoc.l1_score(torch.stack(vt), vt[0][None]).numpy()
        np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)


def test_build_vocabulary_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    centers = rng.integers(0, 2, (8, 256)).astype(np.uint8)
    descs = []
    for c in centers:
        for _ in range(40):
            d = c.copy()
            d[rng.choice(256, size=8, replace=False)] ^= 1
            descs.append(d)
    descs = np.stack(descs)
    j = jvoc.build_vocabulary(descs, k=4, levels=3, seed=0)
    t = tvoc.build_vocabulary(descs, k=4, levels=3, seed=0, device="cpu")
    for cj, ct in zip(j.centroids, tvoc.level_bits(t)):
        np.testing.assert_array_equal(ct, np.asarray(cj))
    np.testing.assert_allclose(t.idf.numpy(), np.asarray(j.idf), rtol=0,
                               atol=1e-6)
    assert t.origin == j.origin
    # one npz format: the port's file loads on the reference's side
    p = str(tmp_path / "voc.npz")
    tvoc.save_vocabulary(t, p)
    j2 = jvoc.load_vocabulary(p)
    np.testing.assert_array_equal(
        np.asarray(jvoc.transform_leaves(j2, jnp.asarray(descs))),
        tvoc.transform_leaves(t, torch.from_numpy(descs)).numpy())
    t2 = tvoc.load_vocabulary(p, "cpu")
    assert torch.equal(t2.flat, t.flat) and torch.equal(t2.idf, t.idf)
    # the reference's Vocabulary carried across as data
    t3 = convert.vocabulary_from_numpy([np.asarray(c) for c in j.centroids],
                                       np.asarray(j.idf), j.k, "cpu")
    assert torch.equal(t3.flat, t.flat)
    np.testing.assert_array_equal(t3.idf.numpy(), np.asarray(j.idf))


def _score_sequence(seed, F=40):
    """Recorded-like probe scores: a drifting self-similarity with a
    revisit of the first keyframes from slot 28 on."""
    rng = np.random.default_rng(seed)
    seqs = []
    for slot in range(F):
        s = rng.uniform(0.0, 0.08, F).astype(np.float32)
        s[max(slot - 3, 0):slot] = rng.uniform(0.1, 0.25)
        if slot >= 28:
            s[(slot - 28) % 6: (slot - 28) % 6 + 3] = rng.uniform(0.05, 0.3)
        seqs.append(s)
    return seqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidates_votes_and_gates_match_reference(seed):
    """select_candidates, the consistency voter, the cooldown and
    min_kf_separation gates and the funnel counters, driven through both
    closers' ``_handle_probe_result`` on the same score sequence (the
    verification replaced on both sides by a recorder that closes)."""
    cfg = CFG.with_updates({"mapping": {"max_kfs": 40},
                            "loop": {"min_kf_separation": 12,
                                     "consistency_window": 2,
                                     "lc_cooldown": 5}})
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    closers = {"ref": jlc.LoopCloser(cfg, None),
               "port": tlc.LoopCloser(tcfg, None, "cpu")}
    fired = {k: [] for k in closers}
    for name, lc in closers.items():
        def close(mh, a, b, poses, lc=lc, name=name):
            fired[name].append((a, b))
            lc.probes_since_close = 0
            return None
        lc._close_loop = close
    seqs = _score_sequence(seed)
    F = cfg.mapping.max_kfs
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    rng = np.random.default_rng(seed)
    margin, gap = np.inf, np.inf
    for slot, s in enumerate(seqs[:F]):
        covis = rng.integers(0, 40, F).astype(np.float32)
        for name, lc in closers.items():
            lc._handle_probe_result(None, slot, s[:F].copy(), covis, slot + 1,
                                    poses)
        cands, base = jdb.select_candidates(
            np.where(np.arange(F) < slot, s[:F], 0.0), slot, cfg)
        tc, tb = tdb.select_candidates(
            np.where(np.arange(F) < slot, s[:F], 0.0), slot, tcfg)
        assert [tuple(c) for c in tc] == [tuple(c) for c in cands]
        assert tb == base
        rel = np.where(np.arange(F) < max(slot - 12, 0), s[:F], 0.0) / base
        margin = min(margin, float(np.abs(rel[rel > 0] - 0.3).min())
                     if (rel > 0).any() else np.inf)
        top = np.sort(rel)[::-1][:5]
        if len(top) > 1:
            gap = min(gap, float(np.min(np.abs(np.diff(top)))))
    counters = lambda lc: (lc.n_candidates, lc.n_votes_fired, len(
        lc.odo_edges), len(lc.covis_edges), lc.probes_since_close)
    print(f"funnel {counters(closers['port'])}, closures {fired['port']}, "
          f"smallest |rel - lc_mat| {margin:.3g}, smallest ranked gap "
          f"{gap:.3g}")
    assert fired["port"] == fired["ref"]
    assert counters(closers["port"]) == counters(closers["ref"])
    assert closers["ref"].n_votes_fired >= 1
    for (a, b) in zip(closers["port"].covis_edges, closers["ref"].covis_edges):
        assert a[:2] == b[:2] and a[3:] == b[3:]


def test_covisibility_counts():
    """Twin of tests/test_loop.py::test_covisibility_counts."""
    F, K, P = 6, 8, 32
    obs = np.full((F, K), -1, np.int32)
    obs[0, :4] = [1, 2, 3, 4]
    obs[1, :4] = [3, 4, 5, 6]
    obs[2, :2] = [1, 9]
    obs[3, :3] = [20, 21, 22]
    obs[4, :4] = [3, 3, 3, 7]          # duplicate ids count once
    for slot in (0, 4):
        want = np.asarray(jlc.covisibility_counts(jnp.asarray(obs),
                                                  jnp.asarray(slot), P))
        got = tlc.covisibility_counts(torch.from_numpy(obs), slot, P)
        np.testing.assert_array_equal(got.numpy(), want)
    assert list(got.numpy()[:2]) == [1, 1]


def _random_state(seed, cfg=CFG, n_kfs=10):
    """A reference MapState with random observation tables, descriptors,
    landmarks and poses (numpy dict, uint32 descriptor words)."""
    rng = np.random.default_rng(seed)
    st = {f: np.array(x) for f, x in jmap.init_map_state(cfg)
          ._asdict().items()}
    F, K = st["obs_pt_lm"].shape
    L = st["obs_ln_lm"].shape[1]
    P, M = st["pt_pos"].shape[0], st["ln_spos"].shape[0]
    st["n_kfs"] = np.asarray(n_kfs, np.int32)
    st["kf_valid"][:n_kfs] = True
    xi = rng.normal(size=(F, 6)).astype(np.float32) * [1, 1, 1, 0.2, 0.2,
                                                        0.2]
    st["kf_pose"] = np.asarray(jlie.exp_se3(jnp.asarray(xi.astype(
        np.float32))))
    st["kf_pt_desc"] = rng.integers(0, 2 ** 32, (F, K, 8), dtype=np.uint64
                                    ).astype(np.uint32)
    st["kf_ln_desc"] = rng.integers(0, 2 ** 32, (F, L, 8), dtype=np.uint64
                                    ).astype(np.uint32)
    st["obs_pt_disp"] = np.where(rng.random((F, K)) > 0.2,
                                 rng.uniform(1, 30, (F, K)), 0.0
                                 ).astype(np.float32)
    st["obs_pt_lm"] = np.where(rng.random((F, K)) > 0.3,
                               rng.integers(0, P, (F, K)), -1).astype(np.int32)
    st["obs_ln_lm"] = np.where(rng.random((F, L)) > 0.3,
                               rng.integers(0, M, (F, L)), -1).astype(np.int32)
    st["pt_pos"] = rng.normal(0, 3, (P, 3)).astype(np.float32)
    st["pt_valid"] = rng.random(P) > 0.1
    st["pt_nobs"] = rng.integers(1, 6, P).astype(np.int32)
    st["pt_first_kf"] = np.where(rng.random(P) > 0.2,
                                 rng.integers(0, n_kfs, P), -1).astype(np.int32)
    st["pt_dir"] = rng.normal(size=(P, 3)).astype(np.float32)
    for f in ("ln_spos", "ln_epos"):
        st[f] = rng.normal(0, 3, (M, 3)).astype(np.float32)
    st["ln_dir"] = rng.normal(size=(M, 3)).astype(np.float32)
    st["ln_valid"] = rng.random(M) > 0.1
    st["ln_nobs"] = rng.integers(1, 6, M).astype(np.int32)
    st["ln_first_kf"] = np.where(rng.random(M) > 0.2,
                                 rng.integers(0, n_kfs, M), -1).astype(np.int32)
    return st


def _jstate(st):
    return jmap.MapState(**{f: jnp.asarray(x) for f, x in st.items()})


def test_probe_core_matches_reference(vocs):
    """probe_core on a MapState carried across: the BoW rows written, the
    fused scores (points and lines), covisibility and the pose."""
    st = _random_state(1)
    F = CFG.mapping.max_kfs
    (jp, tp), (jl, tl) = vocs["orb"], vocs["lbd"]
    rng = np.random.default_rng(2)
    bp = rng.random((F, 10000)).astype(np.float32) * 1e-3
    bl = rng.random((F, 10000)).astype(np.float32) * 1e-3
    ref = jax.jit(partial(jlc.probe_core, jp, jl, CFG, True))
    ts = convert.map_state_from_numpy(st, "cpu")
    tbp, tbl = torch.from_numpy(bp.copy()), torch.from_numpy(bl.copy())
    for slot in (0, 7, 9):
        want = ref(_jstate(st), jnp.asarray(bp), jnp.asarray(bl),
                   jnp.asarray(slot))
        bp, bl = np.asarray(want[0]), np.asarray(want[1])
        got = tlc.probe_core(tp, tl, TCFG, True, ts, tbp, tbl, slot)
        assert got[0] is tbp and got[1] is tbl          # written in place
        np.testing.assert_allclose(tbp.numpy(), bp, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tbl.numpy(), bl, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_verify_loop_geometry_matches_reference():
    """Twin of tests/test_loop.py::
    test_lc_unc_gate_rejects_degenerate_geometry: a well-conditioned and
    a degenerate pair through both verifications."""
    from plslam_tpu.core.camera import StereoCamera
    cfg = SlamConfig().with_updates({
        "lines": {"has_lines": False}, "tracking": {"min_features": 8}})
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    cam = StereoCamera.from_config(cfg.camera)
    tcam = convert.camera_from_numpy(cam.fx, cam.fy, cam.cx, cam.cy, cam.b,
                                     cam.width, cam.height)
    rng = np.random.default_rng(5)
    K, L = cfg.points.max_kpts, cfg.lines.max_lines
    T_ab = np.asarray(jlie.exp_se3(jnp.asarray(
        [0.05, -0.02, 0.08, 0.004, 0.01, -0.006])), np.float32)

    def proj(Q):
        return np.stack([float(cam.fx) * Q[:, 0] / Q[:, 2] + float(cam.cx),
                         float(cam.fy) * Q[:, 1] / Q[:, 2] + float(cam.cy)],
                        -1).astype(np.float32)

    n = 60
    P_good = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n),
                       rng.uniform(6, 18, n)], -1).astype(np.float32)
    P_bad = np.stack([150.0 + rng.uniform(-0.15, 0.15, n),
                      rng.uniform(-0.15, 0.15, n),
                      180.0 + rng.uniform(-0.5, 0.5, n)], -1).astype(np.float32)
    sides = []
    for P in (P_good, P_bad):
        uv_a, uv_b = np.zeros((K, 2), np.float32), np.zeros((K, 2), np.float32)
        disp_a = np.zeros((K,), np.float32)
        uv_a[:n] = proj(P)
        uv_b[:n] = proj(P @ T_ab[:3, :3].T + T_ab[:3, 3])
        disp_a[:n] = float(cam.fx * cam.b) / P[:, 2]
        desc = np.zeros((K, 256), np.uint8)
        desc[:n] = rng.integers(0, 2, (n, 256))
        packed = np.asarray(jham.pack_bits(jnp.asarray(desc)))
        zl = np.zeros((L, 8), np.uint32)
        ze, zq = np.zeros((L, 6), np.float32), np.zeros((L, 3), np.float32)
        args = (packed, uv_a, disp_a, packed, uv_b, zl, ze, zl, ze, zq)
        rj, nj = jlc.verify_loop_geometry(*map(jnp.asarray, args), cam, cfg)
        rt, nt = tlc.verify_loop_geometry(
            *(convert._tensor(a, torch.int32 if a.dtype == np.uint32
                              else torch.float32, "cpu") for a in args),
            tcam, tcfg)
        assert bool(rt.good) == bool(rj.good)
        assert int(rt.n_inliers) == int(rj.n_inliers) and int(nt) == int(nj)
        dT = float(np.abs(rt.T.numpy() - np.asarray(rj.T)).max())
        if not sides:       # the degenerate pair's T is free along its
            assert dT <= 1e-5       # weak axis: only its gate side is held
        uj = jlc.floored_uncertainty(rj.cov, int(rj.n_inliers),
                                     float(rj.err), cfg)
        ut = tlc.floored_uncertainty(rt.cov.numpy(), int(rt.n_inliers),
                                     float(rt.err), tcfg)
        print(f"n_inliers {int(rt.n_inliers)}, T_ab diff {dT:.3g}, "
              f"uncertainty port {ut:.4g} "
              f"reference {uj:.4g} (lc_unc {cfg.loop.lc_unc})")
        assert (ut > cfg.loop.lc_unc) == (uj > cfg.loop.lc_unc)
        sides.append(ut > cfg.loop.lc_unc)
    assert sides == [False, True]


def _fusion_case(seed):
    """Two loop KFs whose landmarks are near-duplicates: KF b observes the
    same descriptors as KF a (a few bits flipped, rows shuffled) on other
    landmark slots that sit within 0.5 m, including a chain that makes one
    slot the dup of two pairs: (5, 9) and (9, 7)."""
    st = _random_state(seed, n_kfs=6)
    rng = np.random.default_rng(seed)
    K = st["obs_pt_lm"].shape[1]
    a, b = 1, 4
    bits = rng.integers(0, 2, (K, 256)).astype(np.uint8)
    perm = rng.permutation(K)
    bits_b = bits[perm].copy()
    bits_b[:, :3] ^= 1
    st["kf_pt_desc"][a] = np.asarray(jham.pack_bits(jnp.asarray(bits)))
    st["kf_pt_desc"][b] = np.asarray(jham.pack_bits(jnp.asarray(bits_b)))
    lm_a = rng.permutation(400)[:K].astype(np.int32) + 20
    lm_b = rng.permutation(400)[:K].astype(np.int32) + 20
    lm_a[perm[:2]] = [5, 9]            # b's rows 0, 1 match a's rows perm
    lm_b[:2] = [9, 7]                  # -> pairs (5, 9) and (9, 7)
    st["obs_pt_lm"][a], st["obs_pt_lm"][b] = lm_a, lm_b
    st["pt_pos"][lm_b] = st["pt_pos"][lm_a[perm]] + 0.05
    st["pt_pos"][[5, 7, 9]] = 0.0
    # lines: the same construction, midpoints within 0.5 m
    L = st["obs_ln_lm"].shape[1]
    lb = rng.integers(0, 2, (L, 256)).astype(np.uint8)
    lperm = rng.permutation(L)
    st["kf_ln_desc"][a] = np.asarray(jham.pack_bits(jnp.asarray(lb)))
    st["kf_ln_desc"][b] = np.asarray(jham.pack_bits(jnp.asarray(lb[lperm])))
    la = rng.permutation(60)[:L].astype(np.int32)
    lbb = rng.permutation(60)[:L].astype(np.int32)
    st["obs_ln_lm"][a], st["obs_ln_lm"][b] = la, lbb
    for f in ("ln_spos", "ln_epos"):
        st[f][lbb] = st[f][la[lperm]] + 0.02
    return st, a, b


def test_fuse_loop_landmarks_matches_reference():
    """Integer fields exactly equal, the duplicate-dup chain included: a
    slot that is the dup of two fused pairs takes the keep of the last
    pair in row order, as the reference's CPU scatter."""
    for seed in (0, 1):
        st, a, b = _fusion_case(seed)
        js, nj = jmap.fuse_loop_landmarks(_jstate(st), jnp.asarray(a),
                                          jnp.asarray(b), CFG)
        ts, nt = tmap.fuse_loop_landmarks(
            convert.map_state_from_numpy(st, "cpu"), a, b, TCFG)
        assert int(nt) == int(nj) and int(nj) > 50
        for f in ("obs_pt_lm", "pt_valid", "pt_nobs", "obs_ln_lm",
                  "ln_valid", "ln_nobs"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        # the chain 9 -> 5 and 9 -> 7 resolved the reference's way
        assert not bool(ts.pt_valid[9])
        assert int((ts.obs_pt_lm == 9).sum()) == 0


def test_apply_graph_correction_matches_reference():
    st = _random_state(3)
    F = CFG.mapping.max_kfs
    rng = np.random.default_rng(4)
    new = np.asarray(jlie.exp_se3(jnp.asarray(
        (rng.normal(size=(F, 6)) * 0.05).astype(np.float32)))) @ st["kf_pose"]
    js = jlc.apply_graph_correction(_jstate(st), jnp.asarray(new))
    ts = tlc.apply_graph_correction(convert.map_state_from_numpy(st, "cpu"),
                                    torch.from_numpy(new))
    for f in ("kf_pose", "pt_pos", "pt_dir", "ln_spos", "ln_epos", "ln_dir"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-5 if f.endswith("pos") else 1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("k,n", [(10, 128), (8, 128), (10, 1)])
def test_transform_leaves_ties_match_reference(k, n):
    """Descriptors tied between two children at every level
    (test_torch_gpu.tied_vocabulary_np, numpy): the plain version and the
    reference's transform_leaves both take the first child each time."""
    from test_torch_gpu import tied_vocabulary_np
    cents, bits, want = tied_vocabulary_np(k, 4, n, seed=7 * k + n)
    idf = np.ones(k ** 4, np.float32)
    j = jvoc.Vocabulary(centroids=tuple(jnp.asarray(c) for c in cents),
                        idf=jnp.asarray(idf), k=k, levels=4)
    t = tvoc._from_levels(cents, idf, k, "ties", "cpu")
    ref = np.asarray(jvoc.transform_leaves(j, jnp.asarray(bits)))
    got = tvoc.transform_leaves_plain(t, tvoc.hamming.pack_bits(
        torch.from_numpy(bits))).numpy()
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)


def _descend_by_lanes(voc, words):
    """bow_descend's arithmetic in numpy: a lane a packed word, each lane's
    popcounts of its word against the k children, two children's counts
    packed in one 32-bit word (low half the even child), the packed words
    summed over the 8 lanes, unpacked, the first minimum in child order."""
    flat = voc.flat.numpy().view(np.uint32)
    x = words.numpy().view(np.uint32)                        # (n, 8)
    n, k = x.shape[0], voc.k
    node, off = np.zeros(n, np.int64), 0
    pop = np.vectorize(lambda v: bin(int(v)).count("1"), otypes=[np.uint32])
    for l in range(voc.levels):
        rows = flat[off + node[:, None] * k + np.arange(k)]  # (n, k, 8)
        cnt = pop(rows ^ x[:, None, :])
        cnt = np.concatenate([cnt, np.zeros((n, k % 2, 8), np.uint32)], 1)
        packed = cnt[:, 0::2] | (cnt[:, 1::2] << np.uint32(16))
        s = packed.sum(-1, dtype=np.uint32)                  # (n, ceil(k/2))
        d = np.stack([s & 0xFFFF, s >> 16], -1).reshape(n, -1)[:, :k]
        node = node * k + d.argmin(1)
        off += k ** (l + 1)
    return node


@pytest.mark.parametrize("case", ["orb10", "lbd8", "ties10", "k16"])
def test_bow_descend_lane_arithmetic(vocs, case):
    """_descend_by_lanes (the kernel's 8-lane packed sums and first
    minimum) equals transform_leaves_plain on the port's 10 x 4 vocabulary,
    the reference's tracked 8 x 4 one, tied descriptors and a built
    16 x 3 tree (the largest k the kernel takes: eight packed words)."""
    from test_torch_gpu import _ref_vocab_path, tied_vocabulary_np
    rng = np.random.default_rng(len(case))
    bits = rng.integers(0, 2, (256, 256)).astype(np.uint8)
    if case == "orb10":
        v = vocs["orb"][1]
    elif case == "lbd8":
        v = tvoc.load_vocabulary(_ref_vocab_path("lbd", 8, 4), "cpu")
    elif case == "ties10":
        cents, bits, _ = tied_vocabulary_np(10, 4, 256, seed=3)
        v = tvoc._from_levels(cents, np.ones(10 ** 4, np.float32), 10,
                              "ties", "cpu")
    else:
        v = tvoc.build_vocabulary(bits, k=16, levels=3, seed=2,
                                  device="cpu")
    if case != "ties10":        # half of them near a leaf centroid
        leaf = tvoc.level_bits(v)[-1]
        bits[:128] = leaf[rng.integers(0, len(leaf), 128)]
        bits[np.arange(128), rng.integers(0, 256, 128)] ^= 1
    words = tvoc.hamming.pack_bits(torch.from_numpy(bits))
    assert v.k <= tvoc.BOW_MAX_K
    np.testing.assert_array_equal(_descend_by_lanes(v, words),
                                  tvoc.transform_leaves_plain(v, words).numpy())


def _hist_by_ctas(leaves, valid, idf, n_leaves):
    """bow_hist's order in float32 numpy: each distinct valid leaf counted
    and its first valid descriptor marked; the term count * idf[leaf] at
    that descriptor; the L1 norm as the kernel sums it (thread t, of
    HIST_NT, adds its descriptors t, t + HIST_NT, ... in order; a shuffle
    butterfly in each warp of 32; the warps' sums in warp order; at least
    1e-9); then each CTA of ``hist_layout`` zeroes its slice and writes
    term / norm at the leaves in it. Asserts that the slices write every
    leaf, each once."""
    nt = tvoc.HIST_NT
    count, first = {}, {}
    for d in np.nonzero(valid)[0]:
        leaf = int(leaves[d])
        count[leaf] = count.get(leaf, 0) + 1
        first.setdefault(leaf, d)
    term = np.zeros(len(leaves), np.float32)
    for leaf, d in first.items():
        term[d] = np.float32(count[leaf]) * idf[leaf]
    part = np.zeros(nt, np.float32)
    for d in range(len(leaves)):
        part[d % nt] += np.abs(term[d])
    for s in (16, 8, 4, 2, 1):
        part = part + part[np.arange(nt) ^ s]
    total = np.float32(0.0)
    for w in range(nt // 32):
        total = np.float32(total + part[32 * w])
    total = max(total, np.float32(1e-9))
    ctas, size = tvoc.hist_layout(n_leaves)
    out = np.full(n_leaves, np.nan, np.float32)
    written = np.zeros(n_leaves, int)
    for c in range(ctas):
        lo, hi = c * size, min((c + 1) * size, n_leaves)
        out[lo:hi] = 0.0
        written[lo:hi] += 1
        for leaf, d in first.items():
            if lo <= leaf < hi:
                out[leaf] = term[d] / total
    assert (written == 1).all()
    return out


def _random_vocabs(k, levels, seed):
    """(reference, port) vocabularies of random centroids and idf; the
    nodes on the paths to the first and the last leaf share those leaves'
    centroids, so that the two leaf centroids descend to them."""
    rng = np.random.default_rng(seed)
    cents = [rng.integers(0, 2, (k ** (l + 1), 256)).astype(np.uint8)
             for l in range(levels)]
    for c in cents[:-1]:
        c[0], c[-1] = cents[-1][0], cents[-1][-1]
    idf = rng.uniform(0.1, 3.0, k ** levels).astype(np.float32)
    j = jvoc.Vocabulary(centroids=tuple(jnp.asarray(c) for c in cents),
                        idf=jnp.asarray(idf), k=k, levels=levels)
    return j, tvoc._from_levels(cents, idf, k, "random", "cpu")


@pytest.mark.parametrize("voc_kind,case", [
    ("orb", "random"), ("orb", "all_invalid"), ("orb", "one_leaf"),
    ("orb", "n1"), ("orb", "ends"), ("k3l2", "random"),
    ("k3l2", "all_invalid"), ("k3l2", "one_leaf"), ("k3l2", "n1"),
    ("k3l2", "ends"), ("k3l7", "ends")])
def test_bow_hist_order_matches_reference(vocs, voc_kind, case):
    """_hist_by_ctas (bow_hist's counts, first-occurrence norm and slice
    writes) is within 1e-6 of the reference's bow_vector with the same
    zeros, on the shipped ORB vocabulary (10,000 leaves, 10 CTAs of 1,000)
    and random ones of k = 3, levels 2 (9 leaves, one CTA whose slice of 12
    overhangs) and levels 7 (2,187 leaves, 3 CTAs of 732, the last short):
    all descriptors invalid (the zero vector the 1e-9 floor gives), every
    descriptor on one leaf, N = 1, descriptors on leaves 0 and n_leaves -
    1, and random ones."""
    j, t = (vocs["orb"] if voc_kind == "orb" else _random_vocabs(
        3, 2 if voc_kind == "k3l2" else 7, seed=len(voc_kind)))
    n_leaves = t.n_leaves
    rng = np.random.default_rng(len(case))
    n = 1 if case == "n1" else 64
    bits = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    valid = rng.random(n) > 0.2
    if case == "all_invalid":
        valid[:] = False
    elif case == "one_leaf":
        bits[:] = bits[0]
        valid[:] = True
    elif case == "n1":
        valid[:] = True
    elif case == "ends":
        # descriptors that descend to the first and the last leaf: leaf
        # centroids with a few bits flipped, and random ones
        leaf_bits = tvoc.level_bits(t)[-1][[0, -1]]
        pool = np.concatenate([np.repeat(leaf_bits, 200, 0),
                               rng.integers(0, 2, (8192, 256))]).astype(
            np.uint8)
        flip = rng.random((400, 256)) < 0.02
        pool[:400] ^= flip.astype(np.uint8)
        lv = tvoc.transform_leaves_plain(t, tvoc.hamming.pack_bits(
            torch.from_numpy(pool))).numpy()
        at = [np.nonzero(lv == e)[0][:3] for e in (0, n_leaves - 1)]
        assert all(len(a) for a in at)
        bits[:6] = pool[np.concatenate(at)][np.arange(6) % sum(map(len, at))]
        valid[:6] = True
    leaves = tvoc.transform_leaves_plain(t, tvoc.hamming.pack_bits(
        torch.from_numpy(bits))).numpy()
    if case == "ends":
        assert {0, n_leaves - 1} <= set(leaves[valid].tolist())
    got = _hist_by_ctas(leaves, valid, t.idf.numpy(), n_leaves)
    want = np.asarray(jvoc.bow_vector(j, jnp.asarray(bits),
                                      jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 0, want == 0)
    if valid.any():
        assert abs(float(np.abs(got).sum()) - 1.0) <= 1e-5
    else:
        assert not got.any()


def test_bow_hist_layout_matches_kernel():
    """hist_layout and the HIST_* constants equal csrc/bow.cu's, and the
    slices cover every vector length once, with 16-byte aligned starts."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tvoc.__file__), os.pardir,
                            "csrc", "bow.cu")).read()
    consts = dict(re.findall(r"(HIST_\w+) = (\d+)", src))
    assert {k: int(v) for k, v in consts.items() if k != "HIST_PER"} == {
        "HIST_NT": tvoc.HIST_NT, "HIST_MAX_N": tvoc.HIST_MAX_N,
        "HIST_SLICE": tvoc.HIST_SLICE, "HIST_MAX_CTAS": tvoc.HIST_MAX_CTAS}
    for n in (1, 9, 1000, 1024, 1025, 2187, 10_000, 65_536, 1_000_000):
        ctas, size = tvoc.hist_layout(n)
        assert 1 <= ctas <= tvoc.HIST_MAX_CTAS and size % 4 == 0
        assert (ctas - 1) * size < n <= ctas * size
