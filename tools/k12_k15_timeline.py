"""Where the time of K12's and K15's index launches goes on the card:
copies of plslam_tpu_torch/csrc/lbd.cu and csrc/lba.cu with globaltimer
stamps at their phases.

- ``lbd_describe`` (from the image, chip_smoke.py's line scene: 40
  half-res 188x620 images and the path's segments): each warp's start,
  its samples, its band sums, its norm and its bits; and when the warps
  start, from the first.
- ``lba_index`` (chip_smoke.py's ``lba_window_problem``): each CTA's
  start, its counters zeroed, its slots and counts, its scan, its fill
  and its places; then the package's kernel's device time (torch.profiler,
  chip_smoke.py's ``device_ms``) with the slots split over 1 to 40 CTAs.

Needs an sm_90 card and nvcc; run from the repository root:

    python3 tools/k12_k15_timeline.py

Builds the instrumented copies with nvcc into a temporary directory,
holds their outputs bit-equal to the package's kernels, and prints the
card's name and power limit, then each phase's mean and largest time in
ns (%globaltimer ticks in steps of 32 ns on the H100). Imports nothing of
JAX.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_ms, lba_window_problem  # noqa: E402
from plslam_tpu_torch import native  # noqa: E402
from plslam_tpu_torch.backend import lba  # noqa: E402
from plslam_tpu_torch.config import SlamConfig  # noqa: E402
from plslam_tpu_torch.core.camera import StereoCamera  # noqa: E402
from plslam_tpu_torch.frontend import stereo_lines  # noqa: E402
from plslam_tpu_torch.io import synthetic  # noqa: E402
from plslam_tpu_torch.ops import image, lbd  # noqa: E402

SLOTS = 8192             # warps (LBD) or CTAs (lba_index) the table holds
STAMPS = 8
# (source, entry, who stamps, the slot of the stamp, anchors: a stamp
# before each, phase names, the end of the kernel)
KERNELS = {
    "lbd": ("lbd.cu", "lbd_describe", "lane == 0",
            "blockIdx.x * LBD_WARPS + warp",
            ["  // the lanes of a load take samples", "  // feats = [par+, par-",
             "  // the norm over the statistics in order",
             "  // bits 8 lane .. 8 lane + 7"],
            ["samples", "band sums", "norm", "bits"],
            "      make_uint2(out[0], out[1]);\n"),
    "lba_index": ("lba.cu", "lba_index", "threadIdx.x == 0", "blockIdx.x",
                  ["  for (int j = tid; j <= ns; j += IDX_NT) cur[j] = 0;",
                   "  // the slots: the ids of a batch",
                   "  // each slot's end (inclusive scan)",
                   "  // the fill: each owned observation",
                   "  // each owned observation's place"],
                  ["counters zeroed", "slots and counts", "scan", "fill",
                   "places and offsets"],
                  "    for (int g = n_att + tid; g < T; g += IDX_NT) "
                  "list[g] = -1;\n  }\n"),
}


def instrumented_source(kind: str) -> str:
    src_name, _, who, slot, anchors, _, end = KERNELS[kind]
    src = open(os.path.join(ROOT, "plslam_tpu_torch", "csrc",
                            src_name)).read()
    src = src.replace("#include <stdint.h>", f"""#include <stdint.h>
__device__ long long g_stamps[{SLOTS} * {STAMPS}];
__device__ __forceinline__ long long stamp_now() {{
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}""", 1)

    def stamp(k):
        return (f"  if ({who}) g_stamps[({slot}) * {STAMPS} + {k}] = "
                "stamp_now();\n")

    for k, a in enumerate(anchors):
        if a not in src:
            raise SystemExit(f"{src_name} changed: no anchor {a!r}")
        src = src.replace(a, stamp(k) + a, 1)
    if end not in src:
        raise SystemExit(f"{src_name} changed: no end of the kernel")
    tail = ("  __syncthreads();\n" if kind == "lba_index" else "")
    src = src.replace(end, end + tail + stamp(len(anchors)), 1)
    return src + """
extern "C" int read_stamps(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
extern "C" int clear_stamps() {
  static long long z[%d * %d];
  return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
}
""" % (SLOTS, STAMPS)


def build(kind: str, tmp: str):
    cu, so = os.path.join(tmp, f"{kind}.cu"), os.path.join(tmp, f"{kind}.so")
    with open(cu, "w") as f:
        f.write(instrumented_source(kind))
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I",
                    os.path.join(ROOT, "plslam_tpu_torch", "csrc"),
                    "-shared", cu, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    entry = KERNELS[kind][1]
    fn = getattr(lib, entry)
    fn.argtypes = [kinds[c] for c in native._SIGNATURES[entry]] + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def run(kind: str, lib, fn, args, outs, want) -> np.ndarray:
    """Launch the instrumented copy with ``args`` (tensors as pointers),
    hold ``outs`` to ``want``, return the stamps of the last launch."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def call():
        rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"{kind} failed: error {rc}")

    for _ in range(3):
        call()
    if lib.clear_stamps() != 0:
        raise SystemExit("clearing the stamps failed")
    call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs, want)):
        raise SystemExit(f"{kind}: the instrumented kernel differs from "
                         "the package's")
    st = np.zeros(SLOTS * STAMPS, np.int64)
    if lib.read_stamps(ctypes.c_void_p(st.ctypes.data)) != 0:
        raise SystemExit("reading the stamps failed")
    return st.reshape(SLOTS, STAMPS)


def report(kind: str, st: np.ndarray, what: str) -> None:
    names = KERNELS[kind][5]
    n = len(names)
    used = st[:, 0] > 0
    st = st[used]
    t0 = st[:, 0].min()
    print(f"[{kind}] {what}: {int(used.sum())} stamped; ns mean / max",
          flush=True)
    for k, name in enumerate(names):
        d = st[:, k + 1] - st[:, k]
        print(f"[{kind}]   {name}: {d.mean():.0f} / {d.max()}", flush=True)
    starts, ends = st[:, 0] - t0, st[:, n] - t0
    q = np.percentile(starts, [50, 90, 100])
    print(f"[{kind}]   starts (from the first) median / 90% / last "
          f"{q[0]:.0f} / {q[1]:.0f} / {q[2]:.0f}; ends mean / last "
          f"{ends.mean():.0f} / {ends.max()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    with tempfile.TemporaryDirectory() as tmp:
        # K12 on the line scene's half-res images and the path's segments
        seq = synthetic.make_sequence(cam, n_frames=20, seed=1, n_points=500,
                                      n_lines=60, noise=0.003, step=0.25)
        imgs = torch.from_numpy(np.concatenate([seq.images_l, seq.images_r])
                                ).to(dev)
        N, H, W = imgs.shape
        small = image.resize_bilinear(imgs, (H // 2, W // 2))
        segs, _ = stereo_lines.detect_and_describe_lines(imgs, cfg)
        sp, ep = (segs.sp * 0.5).contiguous(), (segs.ep * 0.5).contiguous()
        l = cfg.lines
        S, NB, SPB = l.lbd_samples, l.lbd_bands, l.lbd_band_samples
        bw = max(l.lbd_band_width // 2, 3)
        want = lbd.describe_lines_image(small, sp, ep, NB, bw, S, SPB)
        t, o = lbd.sample_grid(NB, bw, S, SPB)
        pairs = lbd._make_pairs(4 * NB).astype(np.uint8)
        tabs = [torch.from_numpy(x).to(dev) for x in (t, o, pairs)]
        bits = torch.empty_like(want)
        h, w = small.shape[1:]
        lib, fn = build("lbd", tmp)
        st = run("lbd", lib, fn, [small, None, None, sp, ep, *tabs, bits, N,
                                  sp.shape[1], h, w, S, NB, SPB, w - 1.001,
                                  h - 1.001, 0], [bits], [want])
        report("lbd", st, f"{N} x {sp.shape[1]} segments on {h}x{w}")
        # K15's index on the window problem
        prob = lba_window_problem(dev, cfg, cam)
        Wk, K = prob.obs_pt_id.shape
        L = prob.obs_ln_sid.shape[1]
        P, Q = prob.pt_pos.shape[0], prob.ep_pos.shape[0]
        want = lba.lba_index(prob)
        off, obs = torch.empty_like(want.off), torch.empty_like(want.obs)
        lib, fn = build("lba_index", tmp)
        layout = lba.index_layout(Wk, K, L, P, Q)
        st = run("lba_index", lib, fn,
                 [lba._i32(prob.obs_pt_id), lba._i32(prob.obs_ln_sid),
                  lba._i32(prob.obs_ln_eid), off, obs, Wk, K, L, P, Q,
                  *layout], [off, obs], list(want))
        report("lba_index", st, f"W={Wk} K={K} L={L} P={P} Q={Q}, "
               f"{layout[0]} CTAs of {layout[1]} slots")
        # the package's kernel over other splits of the slots: each CTA
        # reads every id, more CTAs shorten only the owned part
        n = P + Q
        for C in (1, 2, 5, 10, 20, 40):
            S = -(-n // C)

            def call():
                native.launch("lba_index", lba._i32(prob.obs_pt_id),
                              lba._i32(prob.obs_ln_sid),
                              lba._i32(prob.obs_ln_eid), off, obs, Wk, K, L,
                              P, Q, C, S)

            call()
            torch.cuda.synchronize()
            same = torch.equal(off, want.off) and torch.equal(obs, want.obs)
            ms = device_ms(call, iters=20)
            print(f"[lba_index] {C} CTAs of {S} slots: device_ms {ms:.4f}"
                  f"{'' if same else ' DIFFERS'}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
