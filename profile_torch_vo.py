#!/usr/bin/env python3
"""Where the time of the port's main path goes, on one CUDA card.

    python3 profile_torch_vo.py [--reps N]

The main path of ``chip_smoke.py``: points-only chunked VO
(``plslam_tpu_torch.tracking.batch_vo.vo_chunk``) at the full width of
``SlamConfig()`` with ``lines.has_lines=False``, on bench.py's synthetic
scene, one chunk of 20 stereo pairs. After a warm-up it reports:

  * stage times on the host clock, each call ending in
    ``torch.cuda.synchronize()`` and averaged over ``--reps`` calls: the
    whole chunk, the front end (``extract_stereo_frame`` on the chunk),
    one frame-to-frame match of the 20 pairs, and one batched GN solve
    with the full and with the lite iteration counts;
  * one chunk under ``torch.profiler``: kernel launches, the device's
    busy time (the sum of kernel and copy times; one stream, so they do
    not overlap) and its idle share of the chunk's unprofiled wall time,
    the hand-written kernels' share, and the kernels by device time.

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
               "row_match_kernel")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import CHUNK, main_scene
    from plslam_tpu_torch.frontend.stereo_frame import extract_stereo_frame
    from plslam_tpu_torch.tracking import batch_vo, pose_gn
    from plslam_tpu_torch.tracking.frame_handler import (build_point_terms,
                                                         match_f2f_points)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg, cam, seq = main_scene()
    il = torch.from_numpy(seq.images_l).to(dev)
    ir = torch.from_numpy(seq.images_r).to(dev)
    prev, _ = batch_vo.extract_one(il[0], ir[0], cam, cfg)
    T0 = torch.eye(4, device=dev)
    chunk_l, chunk_r = il[1:1 + CHUNK], ir[1:1 + CHUNK]

    def chunk():
        return batch_vo.vo_chunk(chunk_l, chunk_r, prev, None, T0, cam, cfg)

    fl = batch_vo._to_f32(chunk_l)
    fr = batch_vo._to_f32(chunk_r)
    pts, _ = extract_stereo_frame(fl, fr, cam, cfg)
    prev_p = batch_vo.PointObservations(*(
        torch.cat([h[None], t[:-1]]) for h, t in zip(prev, pts)))
    T_pri = T0.expand(CHUNK, 4, 4)
    terms = build_point_terms(prev_p, pts,
                              match_f2f_points(prev_p, pts, T_pri, cam, cfg))
    t = cfg.tracking
    cfg_lite = cfg.with_updates({"tracking": {
        "max_iters": t.lite_pass_iters,
        "max_iters_ref": t.lite_pass_iters_ref}})

    stages = {
        "chunk": host_ms(chunk, args.reps),
        "front_end": host_ms(lambda: extract_stereo_frame(fl, fr, cam, cfg),
                             args.reps),
        "f2f_match": host_ms(lambda: match_f2f_points(prev_p, pts, T_pri,
                                                      cam, cfg), args.reps),
        "gn_full": host_ms(lambda: pose_gn.optimize_pose(
            T_pri, cam, terms, None, cfg), args.reps),
        "gn_lite": host_ms(lambda: pose_gn.optimize_pose(
            T_pri, cam, terms, None, cfg_lite), args.reps),
    }
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
        "frames_per_chunk": CHUNK, "stages_ms": stages,
        "device_busy_ms": busy_ms, "device_idle_share": idle,
        "kernel_launches": launches, "own_kernels_ms": own_ms,
        "top_kernels": [{"name": k[:160], "launches": n, "ms": us / 1e3}
                        for k, (n, us) in top[:10]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
