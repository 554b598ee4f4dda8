#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 profile_torch_vo.py [--reps N] [--no-lines]

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

The last line is one JSON object of these numbers. Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

# the hand-written kernels' device function names (csrc/*.cu)
OWN_KERNELS = ("filter_vertical", "filter_horizontal", "resize_vertical",
               "resize_horizontal", "fast_score_kernel", "nms_block_kernel",
               "orb_describe_kernel", "dist_kernel", "col_argmin_kernel",
               "row_match_kernel", "sobel_kernel", "block_moments",
               "window_moments", "label_kernel", "refit_kernel",
               "merge_kernel", "lbd_kernel")


def host_ms(fn, reps: int) -> float:
    """Mean host-clock time of ``fn`` (ending in a synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_table(prof):
    """{kernel name: (launches, device us)} from a profile: device-side
    events only (a CPU op's own device time repeats its kernels')."""
    from torch.autograd import DeviceType
    out = defaultdict(lambda: [0, 0.0])
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            out[e.key][0] += e.count
            out[e.key][1] += e.device_time_total
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-lines", action="store_true",
                    help="the points-only configuration")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    table = device_table(prof)
    busy_ms = sum(us for _, us in table.values()) / 1e3
    launches = sum(n for n, _ in table.values())
    own = {k: v for k, v in table.items()
           if any(name in k for name in OWN_KERNELS)}
    own_ms = sum(us for _, us in own.values()) / 1e3
    idle = 1.0 - busy_ms / stages["chunk"] if busy_ms > 0 else None
    print(f"[profile] device busy {busy_ms:.3f} ms of a {stages['chunk']:.3f}"
          f" ms chunk (idle share {idle}), {launches} kernel launches; "
          f"hand-written kernels {own_ms:.3f} ms", flush=True)
    top = sorted(table.items(), key=lambda kv: -kv[1][1])[:25]
    for k, (n, us) in top:
        print(f"[kernel] {us / 1e3:9.3f} ms {n:6d}x  {k[:110]}")
    for k, (n, us) in sorted(own.items(), key=lambda kv: -kv[1][1]):
        print(f"[own] {us / 1e3:9.3f} ms {n:6d}x  {k[:110]}")
    takes = take_calls(chunk)
    print(f"[k7] take (clamp + torch.gather) calls per chunk: "
          f"{takes['front_end']} in the front end, {takes['tracking']} in "
          f"the tracking; chip_smoke.py's main path (initialize + 2 "
          f"chunks): {takes['main_path']}", flush=True)
    from torch.autograd import DeviceType
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    for e in host:
        print(f"[host] {e.self_cpu_time_total / 1e3:9.3f} ms self CPU "
              f"{e.count:6d}x  {e.key[:80]}")
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
