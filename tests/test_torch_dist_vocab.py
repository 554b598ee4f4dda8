"""Port parity: sharded place recognition (``parallel/dist_vocab.py``) and
the loop closer's sharded database (``loop.distributed``), on CPU shards.

The same numpy BoW rows go to the JAX package's ``DistRetrieval`` on the
root conftest's 8-device CPU mesh and to the port's on 1, 4 and 8 CPU
shards. Held exactly: the candidates' slots, in order, against the
single-device ``select_candidates`` (the port's and the reference's) and
against the reference's sharded query; scores within 1e-6 absolute of the
reference's (float32 L1 sums, the same order of terms) and relative
scores within 1e-4 of ``select_candidates``' (the reference test's own
tolerance); the rows after ``remap_slots`` bit for bit. The loop closer
with ``loop.distributed`` counts the same candidates and keeps the same
consistency streaks as the one without, keyframe by keyframe, and its
sharded rows follow a compaction and, bit for bit, ``FusedPLSLAM``'s
rebuild of the rows after a resume. ``FusedPLSLAM`` (through a
compaction) and ``ChunkedPLSLAM`` with ``loop.distributed`` make the loop
events, funnel counters and frame anchors of their runs without it, their
trajectories within 1 mm and their sharded rows the host rows' bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.config import SlamConfig
from plslam_tpu.loop.database import select_candidates as jselect
from plslam_tpu.parallel.dist_vocab import DistRetrieval as JDist
from plslam_tpu.parallel.dist_vocab import make_sharded_query as jquery
from plslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from plslam_tpu_torch import convert
from plslam_tpu_torch.loop.database import select_candidates
from plslam_tpu_torch.parallel.dist_vocab import (DistRetrieval,
                                                  make_sharded_query)
from plslam_tpu_torch.parallel.mesh import make_mesh


def _cfg(F=64, sep=12, k=4, n=8):
    return SlamConfig().with_updates({
        "mapping": {"max_kfs": F},
        "loop": {"min_kf_separation": sep, "max_loop_candidates": k,
                 "distributed": True, "dist_devices": n},
    })


def _tcfg(cfg):
    return convert.config_from_dict(dataclasses.asdict(cfg))


def _bows(F, D, seed):
    b = np.random.default_rng(seed).random((F, D)).astype(np.float32)
    return b / b.sum(-1, keepdims=True)


QUERIES = [(20, 21), (35, 36), (63, 64), (13, 30), (50, 64)]


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dist_retrieval_candidates_equal_host(n):
    cfg = _cfg(n=n)
    tcfg = _tcfg(cfg)
    F, D_p, D_l = 64, 96, 48
    bows_p, bows_l = _bows(F, D_p, 0), _bows(F, D_l, 1)
    ref = JDist(cfg, D_p, D_l)
    dist = DistRetrieval(tcfg, D_p, D_l, device="cpu")
    assert dist.n == n and dist.rows == F // n
    for s in range(F):
        ref.insert(s, jnp.asarray(bows_p[s]), jnp.asarray(bows_l[s]))
        dist.insert(s, torch.from_numpy(bows_p[s]),
                    torch.from_numpy(bows_l[s]))
    for slot, n_kfs in QUERIES:
        sp = 1.0 - 0.5 * np.abs(bows_p - bows_p[slot]).sum(-1)
        sl = 1.0 - 0.5 * np.abs(bows_l - bows_l[slot]).sum(-1)
        scores = (0.5 * (sp + sl)).astype(np.float32)
        scores[slot:] = 0.0
        scores[n_kfs:] = 0.0
        host, host_base = select_candidates(scores, slot, tcfg)
        jhost, _ = jselect(scores, slot, cfg)
        ts, ti, base = dist.query(slot, n_kfs, torch.from_numpy(bows_p[slot]),
                                  torch.from_numpy(bows_l[slot]))
        rs, ri, rbase = jax.device_get(ref.query(
            slot, n_kfs, jnp.asarray(bows_p[slot]), jnp.asarray(bows_l[slot])))
        assert np.array_equal(ti.numpy(), np.asarray(ri)), (slot, n_kfs)
        np.testing.assert_allclose(ts.numpy(), rs, rtol=0, atol=1e-6)
        assert abs(float(base) - float(rbase)) <= 1e-6
        b = max(float(base), 1e-3)
        got = [(int(i), float(s) / b) for s, i in zip(ts.numpy(), ti.numpy())
               if s > 0 and float(s) / b >= tcfg.loop.lc_mat]
        assert b == pytest.approx(host_base, rel=1e-5)
        assert [g[0] for g in got] == [c.slot for c in host] == [
            c.slot for c in jhost], (slot, n_kfs, got, host)
        for (_, r), c in zip(got, host):
            assert r == pytest.approx(c.score, rel=1e-4)


def test_dist_retrieval_remap_slots():
    """A compaction's permutation (every third slot dropped) moves the rows
    as the primary database's, across shards, the tail zeroed."""
    cfg = _tcfg(_cfg(n=4))
    F, D = 64, 32
    bows = _bows(F, D, 2)
    dist = DistRetrieval(cfg, D, None, device="cpu")
    for s in range(F):
        dist.insert(s, torch.from_numpy(bows[s]))
    keep = [old for old in range(F) if old % 3]
    perm = np.zeros((F,), np.int64)
    perm[:len(keep)] = keep
    dist.remap_slots(perm, len(keep))
    got = torch.cat(dist.bows_p).numpy()
    assert np.array_equal(got[:len(keep)], bows[keep])
    assert not got[len(keep):].any()
    assert [x.shape for x in dist.bows_p] == [(16, D)] * 4


def test_sharded_query_matches_reference():
    bows = _bows(64, 40, 3)
    q = bows[17]
    got = make_sharded_query(make_mesh(8, ("kf",), "cpu"), k=8)(
        torch.from_numpy(bows), torch.from_numpy(q))
    ref = jax.device_get(jquery(jmake_mesh(8, axes=("kf",)), k=8)(
        jnp.asarray(bows), jnp.asarray(q)))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0, atol=1e-6)
    assert int(got[1][0]) == 17


def test_loop_closer_sharded_database_follows_the_host_one():
    """Two loop closers, with and without loop.distributed, fed the same
    BoW rows and probe scores keyframe by keyframe: the same candidate
    counts and consistency streaks (no vote fires at this window), the
    sharded rows mirrored; then a compaction moves them alike."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.loop.loop_closer import LoopCloser
    cfg = _tcfg(SlamConfig().with_updates({
        "mapping": {"max_kfs": 64},
        "lines": {"has_lines": False},
        "loop": {"min_kf_separation": 12, "consistency_window": 100,
                 "lc_mat": 0.0, "lc_cooldown": 0, "dist_devices": 4}}))
    cam = StereoCamera.from_config(cfg.camera)
    host = LoopCloser(cfg, cam, "cpu")
    dist = LoopCloser(cfg.with_updates({"loop": {"distributed": True}}),
                      cam, "cpu")
    assert dist._dist is not None and dist._dist.n == 4
    F = cfg.mapping.max_kfs
    D = host.db.bows_p.shape[1]
    bows = _bows(F, D, 4)
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    covis = np.zeros((F,), np.int32)
    for slot in range(40):
        for lc in (host, dist):
            lc.db.bows_p[slot] = torch.from_numpy(bows[slot])
        scores = (1.0 - 0.5 * np.abs(bows - bows[slot]).sum(-1)).astype(
            np.float32)
        for lc in (host, dist):
            lc._handle_probe_result(None, slot, scores, covis, slot + 1,
                                    kf_poses)
        assert dist.n_candidates == host.n_candidates
        assert dist.voter._streaks == host.voter._streaks
    assert host.n_candidates > 0
    rows = torch.cat(dist._dist.bows_p)
    assert torch.equal(rows[:40], host.db.bows_p[:40])
    exact = np.where(np.arange(F) % 3 == 0, -1, np.cumsum(np.arange(F) % 3
                                                          != 0) - 1)
    n_valid = int((exact >= 0).sum())
    for lc in (host, dist):
        lc.remap_slots(exact, n_valid)
    assert torch.equal(torch.cat(dist._dist.bows_p), host.db.bows_p)


def test_fused_resume_rebuild_mirrors_into_the_sharded_database():
    """FusedPLSLAM's rebuild of the BoW rows after a resume
    (``_rebuild_bows``) mirrors each rebuilt row into the sharded
    database: three keyframes of random descriptors, their rows equal in
    both databases, bit for bit."""
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.core.camera import StereoCamera
    cfg = _tcfg(SlamConfig().with_updates({
        "mapping": {"max_kfs": 32, "max_points": 512, "max_lines": 64},
        "loop": {"enabled": True, "distributed": True, "dist_devices": 4}}))
    slam = FusedPLSLAM(cfg, StereoCamera.from_config(cfg.camera),
                       device="cpu")
    st = slam.state
    g = torch.Generator().manual_seed(5)
    n = 3
    desc = lambda x: torch.randint(-2 ** 31, 2 ** 31 - 1, x.shape[1:],
                                   generator=g, dtype=torch.int32)
    kf_pt, kf_ln = st.kf_pt_desc.clone(), st.kf_ln_desc.clone()
    for s in range(n):
        kf_pt[s], kf_ln[s] = desc(kf_pt), desc(kf_ln)
    slam.state = st._replace(
        n_kfs=torch.tensor(n, dtype=st.n_kfs.dtype), kf_pt_desc=kf_pt,
        kf_ln_desc=kf_ln, obs_pt_disp=torch.ones_like(st.obs_pt_disp),
        obs_ln_lm=torch.zeros_like(st.obs_ln_lm))
    slam._rebuild_bows()
    lc = slam.loop_closer
    for db, rows in ((lc.db.bows_p, lc._dist.bows_p),
                     (lc.db.bows_l, lc._dist.bows_l)):
        got = torch.cat(rows)
        assert torch.equal(got, db) and bool(got[:n].any(-1).all())
        assert not got[n:].any()


# test_torch_fused_slam's 41-frame loop scene and configuration: a keyframe
# a frame, KF 0 -> KF 32 closes, kf_batch 4
LOOP_CFG = SlamConfig().with_updates({
    "camera": {"width": 320, "height": 240, "fx": 260.0, "fy": 260.0,
               "cx": 160.0, "cy": 120.0, "baseline": 0.3},
    "points": {"max_kpts": 128, "orb_nlevels": 2},
    "lines": {"max_lines": 32},
    "mapping": {"max_kfs": 64, "max_points": 512, "max_lines": 64,
                "lba_max_points": 256, "lba_max_lines": 32,
                "window_kfs": 4, "fixed_kfs": 2, "lba_iters": 3},
    "system": {"kf_batch": 4},
    "keyframe": {"min_entropy_ratio": 2.0},
    "loop": {"enabled": True, "min_kf_separation": 12,
             "consistency_window": 2, "lc_inl": 15, "lc_trs": 3.0,
             "lc_rot": 60.0, "lc_min_correction_t": 0.0,
             "lc_min_correction_r": 0.0, "dist_devices": 4}})


@pytest.mark.parametrize("driver", ["fused", "chunked"])
def test_chunk_drivers_with_the_sharded_database(driver):
    """FusedPLSLAM (max_kfs 40: a compaction, with a pressure eviction,
    between two settles) and ChunkedPLSLAM, which hand several keyframes'
    probes to the loop closer a settle, over the 41-frame loop scene with
    and without loop.distributed (4 CPU shards): the same loop events
    (slots, inliers), funnel counters, frame anchors and compactions, at
    least one closure (and, fused, one compaction), the trajectories
    within 1 mm, and the sharded rows the bits of the host database's."""
    from plslam_tpu_torch.backend.fused_slam import FusedPLSLAM
    from plslam_tpu_torch.backend.slam_system import ChunkedPLSLAM
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic
    cls = FusedPLSLAM if driver == "fused" else ChunkedPLSLAM
    cfg = _tcfg(LOOP_CFG.with_updates(
        {"mapping": {"max_kfs": 40}} if driver == "fused" else {}))
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=41, seed=3, kind="loop",
                                  n_points=300, n_lines=40, noise=0.004,
                                  step=0.15)
    u8 = lambda a: np.clip(np.asarray(a) * 255.0 + 0.5, 0, 255).astype(
        np.uint8)
    il, ir = u8(seq.images_l), u8(seq.images_r)
    runs = []
    # one intra-op thread: the runs' thousands of small ops crawl under
    # oversubscribed threads when the suite runs workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for c in (cfg, cfg.with_updates({"loop": {"distributed": True}})):
            slam = cls(c, cam, device="cpu")
            slam.initialize(il[0], ir[0])
            for lo in range(1, len(il), 4):
                slam.process_chunk(il[lo:lo + 4], ir[lo:lo + 4])
            est = slam.finish()
            lc = slam.loop_closer
            runs.append((est, [(e.kf_from, e.kf_to, e.n_inliers)
                               for e in lc.events],
                         (lc.n_candidates, lc.n_votes_fired, lc.n_rej_geom,
                          lc.n_rej_unc, lc.n_rej_corr, lc.n_loops_closed,
                          len(lc.odo_edges), len(lc.covis_edges),
                          len(lc.loop_edges)),
                         [a for a, _ in slam._frame_anchor],
                         getattr(slam, "n_compactions", 0)))
    finally:
        torch.set_num_threads(n)
    (est_h, *host), (est_d, *dist) = runs
    print(f"{driver}: events {dist[0]}, funnel {dist[1]}, compactions "
          f"{dist[3]}")
    assert dist == host
    assert host[1][5] >= 1 and (driver == "chunked" or host[3] >= 1)
    assert float(np.abs(est_d[:, :3, 3] - est_h[:, :3, 3]).max()) < 1e-3
    assert lc._dist.n == 4
    for rows, db in ((lc._dist.bows_p, lc.db.bows_p),
                     (lc._dist.bows_l, lc.db.bows_l)):
        assert torch.equal(torch.cat(rows), db)
