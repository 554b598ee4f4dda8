#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 profile_torch_vo.py [--reps N] [--no-lines | --slam | --loops]

The main path of ``chip_smoke.py``: the flagship point+line chunked VO
(``plslam_tpu_torch.tracking.batch_vo.vo_chunk``) at the full width of
the default ``SlamConfig()`` on bench.py's synthetic scene (60 lines), one
chunk of 20 stereo pairs; ``--no-lines`` profiles the points-only
configuration instead. After a warm-up it reports:

  * stage times on the host clock, each call ending in
    ``torch.cuda.synchronize()`` and averaged over ``--reps`` calls: the
    whole chunk (first and again last: it is host-bound and drifts with
    the host's load); the front end (``extract_stereo_frame`` on the chunk),
    and within it the point front end (detection, description, stereo
    matching of the 40 images) and the line front end (the same for
    lines); one frame-to-frame match of the 20 pairs for points and for
    lines; one batched GN solve with the full and with the lite
    iteration counts;
  * one chunk under ``torch.profiler``: kernel launches, the device's
    busy time (the sum of kernel and copy times; one stream, so they do
    not overlap) and its idle share of the chunk's unprofiled wall time,
    the hand-written kernels' share, and the kernels by device time;
  * the calls of ``ops/gather.py::take`` (K7, no hand kernel) in a chunk,
    counted in one more chunk.

``--slam`` profiles the fused SLAM chunk without loop closure instead
(``backend/fused_slam.py::fused_step``, ``SlamConfig()`` with
``loop.enabled=False``) on chip_smoke.py's SLAM scene (bench_slam.py's,
uint8 frames): ``FusedPLSLAM`` runs the first three chunks to build a map,
then the fourth chunk is timed from that state as a whole and stage by
stage (the front end, the tracking, ``kf_scan``, one keyframe's
``add_keyframe``, one window LBA, KF retirement + landmark culling), and
profiled once; the hand kernels' launches per chunk come from
``native.LAUNCHES``. ``--loops`` does the same with loop closure on (the
default ``SlamConfig()``, chip_smoke.py's loop scene, bench_slam.py's own),
the chunk's keyframes each followed by the BoW probe, and times one probe
(``loop_closer.probe_core``: BoW descent and histogram of both families,
the scores against the database, the covisibility counts) as a stage.

The last line is one JSON object of these numbers. Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.utils.devtime import device_table


def host_ms(fn, reps: int) -> float:
    """Mean host-clock time of ``fn`` (ending in a synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def take_calls(chunk) -> dict:
    """K7's calls in one more chunk: ``ops/gather.py::take`` (no hand
    kernel, so no launch counter) is wrapped, for that chunk only, in
    every module of the port that imported it, and each call is put down
    to the front end or the tracking by its callers."""
    from plslam_tpu_torch.ops import gather
    take = gather.take
    calls = {"front_end": 0, "tracking": 0}

    def counted(*args):
        f = sys._getframe(1)
        while f is not None and f.f_code.co_name != "extract_stereo_frame":
            f = f.f_back
        calls["front_end" if f is not None else "tracking"] += 1
        return take(*args)

    # every importer but ops/gather.py itself, so that no module imported
    # meanwhile keeps the wrapper
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("plslam_tpu_torch") and m is not gather
            and getattr(m, "take", None) is take]
    for m in mods:
        m.take = counted
    try:
        chunk()
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.take = take
    # initialize is one extraction, each chunk one extraction + tracking
    calls["main_path"] = 3 * calls["front_end"] + 2 * calls["tracking"]
    return calls


def profile_chunk(chunk, wall_ms):
    """One call of ``chunk`` under torch.profiler: (busy ms, idle share of
    ``wall_ms``, device launches, hand-kernel ms, hand kernels, top 25)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    table = device_table(prof)
    busy_ms = sum(us for _, us in table.values()) / 1e3
    launches = sum(n for n, _ in table.values())
    own = {k: v for k, v in table.items()
           if native.is_own_kernel(k)}
    own_ms = sum(us for _, us in own.values()) / 1e3
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
    print(f"[profile] device busy {busy_ms:.3f} ms of a {wall_ms:.3f} ms "
          f"chunk (idle share {idle}), {launches} kernel launches; "
          f"hand-written kernels {own_ms:.3f} ms", flush=True)
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:25]
    for k, (n, us) in top:
        print(f"[kernel] {us / 1e3:9.3f} ms {n:6d}x  {k[:110]}")
    for k, (n, us) in sorted(own.items(), key=lambda kv: -kv[1][1]):
        print(f"[own] {us / 1e3:9.3f} ms {n:6d}x  {k[:110]}")
    from torch.autograd import DeviceType
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    for e in host:
        print(f"[host] {e.self_cpu_time_total / 1e3:9.3f} ms self CPU "
              f"{e.count:6d}x  {e.key[:80]}")
    return busy_ms, idle, launches, own_ms, own, top


def slam_main(reps: int, smi: str, loops: bool) -> int:
    """The --slam and --loops profiles (see the module docstring)."""
    from chip_smoke import CHUNK, loop_scene, slam_scene
    from plslam_tpu_torch.backend import fused_slam, map as tmap
    from plslam_tpu_torch.backend.map_handler import run_window_lba
    from plslam_tpu_torch.frontend.stereo_frame import extract_stereo_frame
    from plslam_tpu_torch.tracking import batch_vo

    dev = torch.device("cuda", 0)
    cfg, cam, _, il, ir = loop_scene() if loops else slam_scene()
    chunks = [torch.from_numpy(np.stack([il[lo:lo + CHUNK],
                                         ir[lo:lo + CHUNK]])).to(dev)
              for lo in range(1, 1 + 4 * CHUNK, CHUNK)]
    slam = fused_slam.FusedPLSLAM(cfg, cam)
    slam.initialize(il[0], ir[0])
    for c in chunks[:3]:
        slam.process_chunk(c)
    slam._settle_all()
    kmax = slam.kmax
    args = (chunks[3], slam.prev_pts, slam.prev_lns, slam.DT_prev,
            slam._crit, slam.state, cam, cfg, kmax)

    def chunk():
        # the probe rewrites the BoW rows of the chunk's keyframes in place:
        # the same rows each time
        return fused_slam.fused_step(*args, probe=slam._probe)

    imgs = chunks[3]
    fl, fr = batch_vo._to_f32(imgs[0]), batch_vo._to_f32(imgs[1])
    pts, lns = extract_stereo_frame(fl, fr, cam, cfg)
    out = batch_vo._chunk_tracking_batched(pts, lns, slam.prev_pts,
                                           slam.prev_lns, slam.DT_prev, cam,
                                           cfg)
    pts0, lns0 = batch_vo._frame(pts, 0), batch_vo._frame(lns, 0)
    last = slam.state.kf_pose[int(slam.state.n_kfs) - 1]
    T_w = last @ torch.linalg.inv(out.DT[0])
    state1, _ = tmap.add_keyframe(slam.state, pts0, lns0, T_w, cam, cfg)

    def retire_cull():
        s, _ = tmap.remove_redundant_kfs(state1, cfg)
        s, _ = tmap.remove_redundant_kfs_global(s, cfg)
        return tmap.cull_landmarks(s, cfg)

    stages = {
        "chunk": host_ms(chunk, reps),
        "front_end": host_ms(lambda: extract_stereo_frame(fl, fr, cam, cfg),
                             reps),
        "tracking": host_ms(lambda: batch_vo._chunk_tracking_batched(
            pts, lns, slam.prev_pts, slam.prev_lns, slam.DT_prev, cam, cfg),
            reps),
        "kf_scan": host_ms(lambda: fused_slam.kf_scan(
            out.DT, out.cov, out.good, slam._crit, cfg, kmax), reps),
        "add_keyframe": host_ms(lambda: tmap.add_keyframe(
            slam.state, pts0, lns0, T_w, cam, cfg), reps),
        "window_lba": host_ms(lambda: run_window_lba(state1, cam, cfg), reps),
        "retire_and_cull": host_ms(retire_cull, reps),
    }
    if loops:
        slot = int(slam.state.n_kfs) - 1
        stages["probe"] = host_ms(lambda: slam._probe(slam.state, slot),
                                  reps)
    # the host-bound chunk drifts with the host's load: time it again
    stages["chunk_again"] = host_ms(chunk, reps)
    for k, v in stages.items():
        print(f"[stage] {k}: {v:.3f} ms (host clock, mean of {reps})",
              flush=True)
    native.reset_counts()
    host_blk = chunk()[0].cpu().numpy()
    own_launches = dict(native.LAUNCHES)
    slots = host_blk[CHUNK * fused_slam._PF:].reshape(-1)[
        :kmax * fused_slam._PS].reshape(kmax, fused_slam._PS)
    n_kf = int((slots[:, 0] > 0.5).sum())
    print(f"[slam] keyframes in the profiled chunk: {n_kf}; hand-kernel "
          f"launches {json.dumps(own_launches, sort_keys=True)}", flush=True)
    busy_ms, idle, launches, own_ms, own, top = profile_chunk(
        chunk, stages["chunk"])
    print(smi)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "path": "loops" if loops else "slam", "frames_per_chunk": CHUNK,
        "keyframes_in_chunk": n_kf,
        "stages_ms": stages, "device_busy_ms": busy_ms,
        "device_idle_share": idle, "kernel_launches": launches,
        "own_kernels_ms": own_ms, "own_launches": own_launches,
        "own_kernels": {k[:60]: {"launches": n, "ms": us / 1e3}
                        for k, (n, us) in own.items()},
        "top_kernels": [{"name": k[:160], "launches": n, "ms": us / 1e3}
                        for k, (n, us) in top[:10]]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-lines", action="store_true",
                    help="the points-only configuration")
    ap.add_argument("--slam", action="store_true",
                    help="the fused SLAM chunk without loop closure")
    ap.add_argument("--loops", action="store_true",
                    help="the fused SLAM chunk with loop closure")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    if args.slam or args.loops:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        return slam_main(args.reps, smi, args.loops)
    from chip_smoke import CHUNK, main_scene
    from plslam_tpu_torch.frontend import stereo_lines, stereo_points
    from plslam_tpu_torch.frontend.stereo_frame import extract_stereo_frame
    from plslam_tpu_torch.tracking import batch_vo, pose_gn
    from plslam_tpu_torch.tracking.frame_handler import (
        build_line_terms, build_point_terms, match_f2f_lines,
        match_f2f_points)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    lines = not args.no_lines
    cfg, cam, seq = main_scene(lines)
    il = torch.from_numpy(seq.images_l).to(dev)
    ir = torch.from_numpy(seq.images_r).to(dev)
    prev, prev_l = batch_vo.extract_one(il[0], ir[0], cam, cfg)
    T0 = torch.eye(4, device=dev)
    chunk_l, chunk_r = il[1:1 + CHUNK], ir[1:1 + CHUNK]

    def chunk():
        return batch_vo.vo_chunk(chunk_l, chunk_r, prev, prev_l, T0, cam,
                                 cfg)

    fl = batch_vo._to_f32(chunk_l)
    fr = batch_vo._to_f32(chunk_r)
    both = torch.cat([fl, fr])
    pts, lns = extract_stereo_frame(fl, fr, cam, cfg)
    prev_p = batch_vo._shift(prev, pts)
    T_pri = T0.expand(CHUNK, 4, 4)
    terms = build_point_terms(prev_p, pts,
                              match_f2f_points(prev_p, pts, T_pri, cam, cfg))
    ln_terms = None
    if lines:
        prev_ln = batch_vo._shift(prev_l, lns)
        ln_terms = build_line_terms(prev_ln, lns, match_f2f_lines(
            prev_ln, lns, T_pri, cam, cfg))
    t = cfg.tracking
    cfg_lite = cfg.with_updates({"tracking": {
        "max_iters": t.lite_pass_iters,
        "max_iters_ref": t.lite_pass_iters_ref}})

    def point_front():
        uv, desc, octv, ang, sc, val = stereo_points.detect_and_describe(
            both, cfg)
        B = CHUNK
        return stereo_points.match_stereo_points(
            uv[:B], desc[:B], octv[:B], val[:B], uv[B:], desc[B:], octv[B:],
            val[B:], cfg)

    def line_front():
        segs, d = stereo_lines.detect_and_describe_lines(both, cfg)
        half = lambda a, b: type(segs)(*(x[a:b] for x in segs))
        return stereo_lines.match_stereo_lines(
            half(0, CHUNK), d[:CHUNK], half(CHUNK, None), d[CHUNK:], cam, cfg)

    stages = {
        "chunk": host_ms(chunk, args.reps),
        "front_end": host_ms(lambda: extract_stereo_frame(fl, fr, cam, cfg),
                             args.reps),
        "front_end_points": host_ms(point_front, args.reps),
        "f2f_match_points": host_ms(lambda: match_f2f_points(
            prev_p, pts, T_pri, cam, cfg), args.reps),
        "gn_full": host_ms(lambda: pose_gn.optimize_pose(
            T_pri, cam, terms, ln_terms, cfg), args.reps),
        "gn_lite": host_ms(lambda: pose_gn.optimize_pose(
            T_pri, cam, terms, ln_terms, cfg_lite), args.reps),
    }
    if lines:
        stages["front_end_lines"] = host_ms(line_front, args.reps)
        stages["f2f_match_lines"] = host_ms(lambda: match_f2f_lines(
            prev_ln, lns, T_pri, cam, cfg), args.reps)
    # the host-bound chunk drifts with the host's load: time it again
    stages["chunk_again"] = host_ms(chunk, args.reps)
    for k, v in stages.items():
        print(f"[stage] {k}: {v:.3f} ms (host clock, mean of {args.reps})",
              flush=True)

    busy_ms, idle, launches, own_ms, own, top = profile_chunk(
        chunk, stages["chunk"])
    takes = take_calls(chunk)
    print(f"[k7] take (clamp + torch.gather) calls per chunk: "
          f"{takes['front_end']} in the front end, {takes['tracking']} in "
          f"the tracking; chip_smoke.py's main path (initialize + 2 "
          f"chunks): {takes['main_path']}", flush=True)
    print(smi)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "lines": lines, "frames_per_chunk": CHUNK, "stages_ms": stages,
        "device_busy_ms": busy_ms, "device_idle_share": idle,
        "kernel_launches": launches, "own_kernels_ms": own_ms,
        "take_calls": takes,
        "own_kernels": {k[:60]: {"launches": n, "ms": us / 1e3}
                        for k, (n, us) in own.items()},
        "top_kernels": [{"name": k[:160], "launches": n, "ms": us / 1e3}
                        for k, (n, us) in top[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
