"""Port parity, the whole slice: the fused SLAM chunk without loop closure.

``kf_scan`` (K14) against the reference's on the DT / cov / good
sequences of the port's tracking of the slice's scene, on synthetic
ones, and on synthetic ones that hit the kf_batch cap: flags and
``blocked`` exactly equal, ratios and poses within 1e-5; each run prints
the smallest margin |ratio - min_entropy_ratio| it saw, so that a flip
could be told from a fault.

The slice: the reference's ``FusedPLSLAM(enable_loops=False)`` and the
port's ``FusedPLSLAM(device="cpu")`` on one synthetic loop scene (320x240,
seed 3, 300 points, 40 lines, 1 + 3 x 8 frames, kf_batch 4, small map
capacities). Required and measured: identical keyframe frames and slots,
identical map matches and new points per keyframe, identical landmark
counts; KF poses and the trajectory within 1 cm in translation and 3e-3
in rotation entries, ATE within 5 mm of the reference's (measured 6.5 mm,
1.03e-3 and 1.5 mm). The LBA here runs with its MAD scale at the 1e-4
floor (most window landmarks have one observation, with zero residual),
so its steps are ill-conditioned and f32 sums in another order move the
poses by millimetres (the reference's own fused and chunked drivers are
held to 1 cm of ATE in tests/test_fused_slam.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from plslam_tpu.backend import fused_slam as jfs
from plslam_tpu.config import SlamConfig
from plslam_tpu.core import lie as jlie
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io import synthetic
from plslam_tpu.utils.evaluation import ate_rmse
from plslam_tpu_torch import convert
from plslam_tpu_torch.backend import fused_slam as tfs

CFG = SlamConfig().with_updates({
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "baseline": 0.3},
    "points": {"max_kpts": 128, "orb_nlevels": 2},
    "lines": {"max_lines": 32},
    "mapping": {"max_kfs": 32, "max_points": 512, "max_lines": 64,
                "lba_max_points": 256, "lba_max_lines": 32,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 3},
    "system": {"kf_batch": 4},
    "loop": {"enabled": False}})
CAM = StereoCamera.from_config(CFG.camera)
TCFG = convert.config_from_dict(dataclasses.asdict(CFG))
TCAM = convert.camera_from_numpy(CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.b,
                                 CAM.width, CAM.height)
# the reference as the fused step runs it: jitted (cfg and kmax static)
_ref_scan = jax.jit(jfs.kf_scan, static_argnums=(4, 5))


def _sequences(seed, n_chunks=3, B=20):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        xi = rng.normal(size=(B, 6)) * [0.05, 0.02, 0.4, 0.01, 0.03, 0.01]
        DT = np.stack([np.asarray(jlie.exp_se3(jnp.asarray(x, jnp.float32)))
                       for x in xi])
        A = rng.normal(size=(B, 6, 6)) * 1e-3
        cov = (A @ A.transpose(0, 2, 1) + 1e-6 * np.eye(6)).astype(np.float32)
        out.append((DT, cov, rng.random(B) > 0.1))
    return out


def _run_scans(cfg, seqs, kmax, packed=False):
    """Both scans over consecutive chunks, the carry threaded through (the
    port's packed, with ``packed``: as the CUDA wrapper's carries are)."""
    jc, tc = jfs.init_crit_carry(), tfs.init_crit_carry("cpu")
    margin, n_kf, n_blocked = np.inf, 0, 0
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    for DT, cov, good in seqs:
        want = _ref_scan(jnp.asarray(DT), jnp.asarray(cov),
                         jnp.asarray(good), jc, cfg, kmax)
        got = tfs.kf_scan(torch.from_numpy(DT), torch.from_numpy(cov),
                          torch.from_numpy(good), tc, tcfg, kmax)
        for i in (0, 3):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        for i in (1, 2):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                       rtol=1e-5, atol=1e-5)
        for f in jfs.CritCarry._fields:
            g, w = getattr(got[4], f).numpy(), np.asarray(getattr(want[4], f))
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)
        r = np.asarray(want[2])
        margin = min(margin, float(np.abs(r[np.isfinite(r)]
                                          - cfg.keyframe.min_entropy_ratio
                                          ).min()))
        n_kf += int(np.sum(want[0]))
        n_blocked += int(np.sum(want[3]))
        jc = want[4]
        tc = convert.crit_carry_from_numpy(
            {f: np.asarray(x) for f, x in want[4]._asdict().items()}, "cpu")
        if packed:
            tc = tfs.carry_views(tfs.pack_crit_carry(tc))
            assert tfs._packed_base(tc) is not None
    print(f"kf_scan: {n_kf} keyframes, {n_blocked} deferred, smallest "
          f"|ratio - {cfg.keyframe.min_entropy_ratio}| = {margin:g}")
    return n_kf, n_blocked


def test_kf_scan_matches_reference_on_synthetic_chunks():
    n_kf, _ = _run_scans(CFG, _sequences(0), kmax=4)
    assert n_kf >= 3


def test_kf_scan_kmax_cap_matches_reference():
    """A keyframe every frame (min_entropy_ratio 2), at most 2 a chunk:
    the cap defers, and the flags and ``blocked`` stay exact."""
    cfg = CFG.with_updates({"keyframe": {"min_entropy_ratio": 2.0}})
    n_kf, n_blocked = _run_scans(cfg, _sequences(1), kmax=2)
    assert n_kf == 6 and n_blocked > 10


def test_init_crit_carry_packed_matches_reference():
    """The port's first carry is packed (every field a view at its offset
    of one buffer) and equals the reference's field by field."""
    jc, tc = jfs.init_crit_carry(), tfs.init_crit_carry("cpu")
    assert tfs._packed_base(tc) is not None
    for f in jfs.CritCarry._fields:
        g, w = getattr(tc, f), np.asarray(getattr(jc, f))
        assert tuple(g.shape) == w.shape, f
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


def test_crit_carry_pack_round_trip():
    """pack_crit_carry then carry_views gives back every field (dtype,
    shape, value) of an unpacked carry from the plain scan, as a packed
    carry; packing a packed carry changes nothing."""
    DT, cov, good = _sequences(5, n_chunks=1, B=7)[0]
    c = tfs.init_crit_carry("cpu")
    c = tfs.kf_scan_plain(torch.from_numpy(DT), torch.from_numpy(cov),
                          torch.from_numpy(good), c, TCFG, 4)[4]
    c = c._replace(ef=torch.tensor(-3.5), frames=torch.tensor(
        5, dtype=torch.int32), have_cov=torch.tensor(True))
    assert tfs._packed_base(c) is None
    buf = tfs.pack_crit_carry(c)
    assert buf.dtype == torch.uint8 and buf.numel() == tfs.CARRY_BYTES
    for back in (tfs.carry_views(buf),
                 tfs.carry_views(tfs.pack_crit_carry(tfs.carry_views(buf)))):
        assert tfs._packed_base(back) is not None
        for f in tfs.CritCarry._fields:
            g, w = getattr(back, f), getattr(c, f)
            assert g.dtype == w.dtype and g.shape == w.shape, f
            assert torch.equal(g, w), f


def test_kf_scan_plain_from_packed_carries_matches_reference():
    """kf_scan_plain fed packed carries over three chunks (the port's
    first carry, then the reference's carries packed) equals the
    reference's kf_scan."""
    n_kf, _ = _run_scans(CFG, _sequences(2), kmax=4, packed=True)
    assert n_kf >= 3


def test_carry_layout_matches_kernel():
    """The Python layout of the packed carry (byte offsets, size) and the
    largest chunk equal csrc/slam.cu's KF_CARRY_* and KF_SCAN_MAX_B; the
    offsets are 16-byte aligned and the fields do not overlap."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tfs.__file__), os.pardir,
                            "csrc", "slam.cu")).read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (KF_CARRY_\w+|KF_SCAN_MAX_B) = (\d+)", src)}
    assert consts.pop("KF_CARRY_BYTES") == tfs.CARRY_BYTES
    assert consts.pop("KF_SCAN_MAX_B") == tfs.KF_SCAN_MAX_B
    assert consts == {"KF_CARRY_" + f.upper(): o
                      for f, o in tfs.CARRY_OFFSETS.items()}
    c = tfs.init_crit_carry("cpu")
    spans = sorted((o, o + getattr(c, f).numel() * getattr(c, f).element_size())
                   for f, o in tfs.CARRY_OFFSETS.items())
    assert all(o % 16 == 0 for o, _ in spans)
    assert all(e <= o2 for (_, e), (o2, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= tfs.CARRY_BYTES


def _latest_good_by_words(good):
    """kf_scan's prologue in numpy: good packed into 32-frame words (the
    ballots), then for frame f its word masked to bits <= f % 32, earlier
    words while that is 0, and the highest set bit; -1 where no frame at
    or before f is good."""
    B = len(good)
    words = [sum(int(good[b]) << (b - w) for b in range(w, min(w + 32, B)))
             for w in range(0, B, 32)]
    out = []
    for f in range(B):
        w = f >> 5
        m = words[w] & (0xFFFFFFFF >> (31 - (f & 31)))
        while m == 0 and w > 0:
            w -= 1
            m = words[w]
        out.append(32 * w + m.bit_length() - 1 if m else -1)
    return np.array(out)


@pytest.mark.parametrize("pattern", ["leading_bad", "all_bad", "all_good",
                                     "random"])
@pytest.mark.parametrize("B", [20, 33, 70])
def test_latest_good_step_prefix(pattern, B):
    """The prologue's latest-good-frame prefix equals the plain version's
    sequential where(good, DT, last_step) chain: index by index against
    the chain in numpy, and the step it picks for the last frame against
    the plain version's carry out."""
    rng = np.random.default_rng(B)
    good = {"leading_bad": np.arange(B) >= B - 5 - (B % 7),
            "all_bad": np.zeros(B, bool), "all_good": np.ones(B, bool),
            "random": rng.random(B) > 0.6}[pattern]
    want, last = [], -1
    for f in range(B):
        last = f if good[f] else last
        want.append(last)
    got = _latest_good_by_words(good)
    np.testing.assert_array_equal(got, want)
    DT, cov, _ = _sequences(B, n_chunks=1, B=B)[0]
    c = tfs.init_crit_carry("cpu")
    c = c._replace(last_step=torch.from_numpy(DT[0] @ DT[1]))
    out = tfs.kf_scan_plain(torch.from_numpy(DT), torch.from_numpy(cov),
                            torch.from_numpy(good), c, TCFG, 4)[4]
    pick = c.last_step if got[-1] < 0 else torch.from_numpy(DT[got[-1]])
    assert torch.equal(out.last_step, pick)


@pytest.fixture(scope="module")
def scene():
    seq = synthetic.make_sequence(CAM, n_frames=25, seed=3, kind="loop",
                                  n_points=300, n_lines=40, noise=0.004,
                                  step=0.15)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return u8(np.asarray(seq.images_l)), u8(np.asarray(seq.images_r)), seq


def _drive(slam, il, ir):
    slam.initialize(il[0], ir[0])
    for lo in (1, 9, 17):
        slam.process_chunk(il[lo:lo + 8], ir[lo:lo + 8])
    return slam.finish()


def test_kf_scan_matches_reference_on_recorded_chunks(scene):
    """The DT / cov / good of the port's tracking of the scene's chunks
    (as the fused step feeds kf_scan)."""
    from plslam_tpu_torch.tracking.batch_vo import vo_chunk, extract_one
    il, ir, _ = scene
    p, l = extract_one(torch.from_numpy(il[0]), torch.from_numpy(ir[0]),
                       TCAM, TCFG)
    T = torch.eye(4)
    seqs = []
    for lo in (1, 9, 17):
        out = vo_chunk(torch.from_numpy(il[lo:lo + 8]),
                       torch.from_numpy(ir[lo:lo + 8]), p, l, T, TCAM, TCFG)
        p, l, T = out.last_pts, out.last_lns, out.DT_next
        seqs.append((out.DT.numpy(), out.cov.numpy(), out.good.numpy()))
    n_kf, _ = _run_scans(CFG, seqs, kmax=4)
    assert n_kf >= 6


def test_fused_slam_matches_reference(scene):
    il, ir, seq = scene
    ref = jfs.FusedPLSLAM(CFG, CAM, enable_loops=False)
    est_j = _drive(ref, il, ir)
    port = tfs.FusedPLSLAM(TCFG, TCAM, device="cpu")
    est_t = _drive(port, il, ir)
    kf_frames = lambda s: np.nonzero(np.diff([a for a, _ in s._frame_anchor])
                                     )[0]
    np.testing.assert_array_equal(kf_frames(port), kf_frames(ref))
    assert len(kf_frames(ref)) >= 8
    rows = lambda s: [(r.slot, r.n_map_matches, r.n_new_points)
                      for r in s.summaries]
    assert rows(port) == rows(ref)
    assert sum(r[1] for r in rows(ref)) > 50
    kp_t, kp_j = port.kf_poses(), ref.kf_poses()
    dt = float(np.abs(kp_t[:, :3, 3] - kp_j[:, :3, 3]).max())
    dr = float(np.abs(kp_t[:, :3, :3] - kp_j[:, :3, :3]).max())
    dtraj = float(np.abs(est_t[:, :3, 3] - est_j[:, :3, 3]).max())
    print(f"KF poses: translation {dt:.3g} m, rotation entries {dr:.3g}; "
          f"trajectory translation {dtraj:.3g} m; landmarks "
          f"{port.n_landmarks()} vs {ref.n_landmarks()}")
    assert dt < 0.01 and dr < 3e-3 and dtraj < 0.01
    assert port.n_landmarks() == ref.n_landmarks()
    ate = lambda est: float(ate_rmse(est, seq.poses[:len(est)]))
    assert abs(ate(est_t) - ate(est_j)) < 0.005, (ate(est_t), ate(est_j))


def test_fused_slam_loops_and_sharded_database():
    """Loops run, also with the sharded database (loop.distributed, two
    CPU shards of the BoW rows), and slot remapping runs (checkpoints:
    test_torch_checkpoint.py)."""
    looped = tfs.FusedPLSLAM(TCFG.with_updates({"loop": {"enabled": True}}),
                             TCAM, device="cpu")
    assert looped.loop_closer is not None
    sharded = tfs.FusedPLSLAM(TCFG.with_updates(
        {"loop": {"enabled": True, "distributed": True, "dist_devices": 2}}),
        TCAM, device="cpu")
    assert sharded.loop_closer._dist.n == 2
    F = TCFG.mapping.max_kfs
    looped.loop_closer.remap_slots(np.arange(F), F)


def test_fused_slam_raises_where_not_ported(scene):
    """Without a card the default device is refused, and a map too small
    for the compaction to make room raises the reference's capacity
    error."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tfs.FusedPLSLAM(TCFG, TCAM)          # the default is the card
    # the compaction point (max_kfs - 2 kf_batch slots used): 12 slots
    # cannot hold the window span and a chunk's headroom. One intra-op
    # thread: only the error is checked, and the run's thousands of small
    # ops crawl under oversubscribed threads when the suite runs workers
    small = tfs.FusedPLSLAM(TCFG.with_updates({"mapping": {"max_kfs": 12}}),
                            TCAM, device="cpu")
    il, ir, _ = scene
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(RuntimeError, match="KF capacity exhausted"):
            _drive(small, il, ir)
    finally:
        torch.set_num_threads(n)


# -- the loop slice: FusedPLSLAM with loop closure on ------------------------

CFG_LOOP = CFG.with_updates({
    "mapping": {"max_kfs": 64},
    "keyframe": {"min_entropy_ratio": 2.0},            # a KF every frame
    "loop": {"enabled": True, "min_kf_separation": 12,
             "consistency_window": 2, "lc_inl": 15, "lc_trs": 3.0,
             "lc_rot": 60.0,
             "lc_min_correction_t": 0.0, "lc_min_correction_r": 0.0}})
# the lazy branch: a floor above this scene's correction (0.74 m, 4.1 deg)
LAZY = {"loop": {"lc_min_correction_t": 1.0, "lc_min_correction_r": 5.0}}
N_LOOP = 41


@pytest.fixture(scope="module")
def loop_scene():
    seq = synthetic.make_sequence(CAM, n_frames=N_LOOP, seed=3, kind="loop",
                                  n_points=300, n_lines=40, noise=0.004,
                                  step=0.15)
    u8 = lambda a: np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return u8(np.asarray(seq.images_l)), u8(np.asarray(seq.images_r)), seq


def _drive_loops(slam, il, ir):
    """initialize, then chunks of kf_batch frames, then finish."""
    slam.initialize(il[0], ir[0])
    k = CFG_LOOP.system.kf_batch
    for lo in range(1, N_LOOP, k):
        slam.process_chunk(il[lo:lo + k], ir[lo:lo + k])
    return slam.finish()


def _funnel(lc):
    return (lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom, lc.n_rej_unc,
            lc.n_rej_corr, lc.n_loops_closed, len(lc.odo_edges),
            len(lc.covis_edges), len(lc.loop_edges))


@pytest.mark.parametrize("branch", ["solve", "lazy"])
def test_fused_slam_with_loops_matches_reference(loop_scene, branch):
    """The reference's FusedPLSLAM(enable_loops=True) against the port's
    on a 41-frame loop scene that closes KF 0 -> KF 32, with the graph
    solve (floors 0: always solve) and with the lazy correction (floors
    above the correction): identical keyframe frames, loop events (slots,
    inliers), funnel counters and graph edges; KF poses and the trajectory
    within the loops-off band (1 cm, 3e-3)."""
    il, ir, seq = loop_scene
    ref = jfs.FusedPLSLAM(CFG_LOOP, CAM, enable_loops=True)
    tcfg = convert.config_from_dict(dataclasses.asdict(CFG_LOOP))
    if branch == "lazy":
        # the reference's fused step is compiled for CFG_LOOP; its closer
        # alone reads the floors
        ref.loop_closer.cfg = CFG_LOOP.with_updates(LAZY)
        tcfg = tcfg.with_updates(LAZY)
    est_j = _drive_loops(ref, il, ir)
    port = tfs.FusedPLSLAM(tcfg, TCAM, device="cpu")
    est_t = _drive_loops(port, il, ir)
    kf_frames = lambda s: np.nonzero(np.diff([a for a, _ in s._frame_anchor])
                                     )[0]
    np.testing.assert_array_equal(kf_frames(port), kf_frames(ref))
    lj, lt = ref.loop_closer, port.loop_closer
    ev = lambda lc: [(e.kf_from, e.kf_to, e.n_inliers) for e in lc.events]
    print(f"{branch}: events {lt.events} (reference {lj.events}); funnel "
          f"{_funnel(lt)}")
    assert ev(lt) == ev(lj) and len(ev(lj)) >= 1
    assert _funnel(lt) == _funnel(lj)
    for e in lt.events:
        assert (e.graph_cost1 > 0) == (branch == "solve")
    for a, b in zip(lt.covis_edges, lj.covis_edges):
        assert a[:2] == b[:2] and a[4] == b[4]
    kp_t, kp_j = port.kf_poses(), ref.kf_poses()
    dt = float(np.abs(kp_t[:, :3, 3] - kp_j[:, :3, 3]).max())
    dr = float(np.abs(kp_t[:, :3, :3] - kp_j[:, :3, :3]).max())
    dtraj = float(np.abs(est_t[:, :3, 3] - est_j[:, :3, 3]).max())
    ate = lambda est: float(ate_rmse(est, seq.poses[:len(est)]))
    print(f"KF poses: translation {dt:.3g} m, rotation entries {dr:.3g}; "
          f"trajectory {dtraj:.3g} m; ATE {ate(est_t):.4f} (reference "
          f"{ate(est_j):.4f})")
    assert dt < 0.01 and dr < 3e-3 and dtraj < 0.01


def test_lc_debug_staged_closure_equals_fused(loop_scene, monkeypatch):
    """``PLSLAM_LC_DEBUG``'s staged closure (``LoopCloser._close_staged``:
    the correction, the fusion and the window LBA one at a time, each
    stage's largest |t| read back) against the closure path the port
    takes without it (``_post_loop_update``), from the same map at the
    same closure: the port's run of this scene up to its closure KF 0 ->
    KF 32, taken both ways from one snapshot. The corrected poses and the
    whole map state are equal, and so are the event and the funnel."""
    from plslam_tpu_torch.loop import loop_closer as tlc
    il, ir, _ = loop_scene
    tcfg = convert.config_from_dict(dataclasses.asdict(CFG_LOOP))
    close = tlc.LoopCloser._close_loop
    staged = []
    clone = lambda st: type(st)(*(x.clone() if torch.is_tensor(x) else x
                                  for x in st))
    keep = ("events", "loop_edges", "n_loops_closed", "probes_since_close",
            "_last_costs", "n_rej_geom", "n_rej_unc", "n_rej_corr",
            "n_frozen_events", "n_edges_dropped")

    def both(self, mh, slot_a, slot_b, kf_poses):
        st0 = clone(mh.state)
        fields0 = {k: list(getattr(self, k)) if isinstance(
            getattr(self, k), list) else getattr(self, k) for k in keep}
        monkeypatch.delenv("PLSLAM_LC_DEBUG", raising=False)
        fused = close(self, mh, slot_a, slot_b, kf_poses)
        st_f = clone(mh.state)
        fields_f = {k: list(getattr(self, k)) if isinstance(
            getattr(self, k), list) else getattr(self, k) for k in keep}
        mh.state = st0
        for k, v in fields0.items():
            setattr(self, k, list(v) if isinstance(v, list) else v)
        monkeypatch.setenv("PLSLAM_LC_DEBUG", "1")
        out = close(self, mh, slot_a, slot_b, kf_poses)
        monkeypatch.delenv("PLSLAM_LC_DEBUG")
        if fused is not None:
            staged.append((slot_a, slot_b))
            np.testing.assert_array_equal(out, fused)
            for a, b in zip(mh.state, st_f):
                if torch.is_tensor(a):
                    assert torch.equal(a, b)
        assert repr({k: getattr(self, k) for k in keep}) == repr(fields_f)
        return out

    monkeypatch.setattr(tlc.LoopCloser, "_close_loop", both)
    calls = []
    stage = tlc.LoopCloser._close_staged
    monkeypatch.setattr(tlc.LoopCloser, "_close_staged",
                        lambda self, *a: calls.append(a[2:4]) or
                        stage(self, *a))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the chunks up to the closure's (nothing after it is checked)
        port = tfs.FusedPLSLAM(tcfg, TCAM, device="cpu")
        port.initialize(il[0], ir[0])
        k = CFG_LOOP.system.kf_batch
        for lo in range(1, N_LOOP, k):
            port.process_chunk(il[lo:lo + k], ir[lo:lo + k])
            if staged:
                break
        port.finish()
    finally:
        torch.set_num_threads(n)
    assert staged == [(0, 32)] and calls == [(0, 32)]
    assert [(e.kf_from, e.kf_to) for e in port.loop_closer.events] == \
        [(0, 32)]
