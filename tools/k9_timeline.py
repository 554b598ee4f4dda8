"""Where the time of K9's one launch goes on the card: a copy of
plslam_tpu_torch/csrc/lines_label.cu with globaltimer stamps at its
phases (a CTA's gate pass; then, in the last CTA of each image, the wait
for the other slices and the fences, the list of the gated-in tiles, the
compatibility bits, the linked list, the sweeps and the label writes),
run on chip_smoke.py's line scene (40 images, 376x1241) at full and at
half resolution with the detector's settings.

Needs an sm_90 card and nvcc; run from the repository root:

    python3 tools/k9_timeline.py

Builds the instrumented copy with nvcc into a temporary directory, holds
its outputs bit-equal to ``lines.gates_and_labels`` (the kernel as
built by the package), and prints the card's name and power limit, the
slices an image, then each phase's mean and largest time in ns (from the
first CTA's start; the stamps are %globaltimer, which ticks in steps of
32 ns on the H100) and the sweeps' iterations. Imports nothing of JAX.
"""

import ctypes
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plslam_tpu_torch import native  # noqa: E402
from plslam_tpu_torch.config import SlamConfig  # noqa: E402
from plslam_tpu_torch.core.camera import StereoCamera  # noqa: E402
from plslam_tpu_torch.frontend import stereo_lines  # noqa: E402
from plslam_tpu_torch.io import synthetic  # noqa: E402
from plslam_tpu_torch.ops import image, lines  # noqa: E402

SLOTS = 64 * 32          # (image, slice) pairs the stamp table holds
# stamp k before each anchor of the kernel's source
ANCHORS = ["  // the slice's gates (lines.py::tile_gates, in its order)",
           "  // the last slice of the image to finish goes on",
           "  int16_t* A = smem;",
           "  // forward compatibilities of the gated-in tiles",
           "  // a gated-in tile without a link keeps its index",
           "  const int L = s_nlink;"]
PHASES = ["gates (a slice)", "wait and fences", "gated-in list",
          "compatibility bits", "linked list", "sweeps and writes"]
END, ITERS, STAMPS = 6, 7, 8   # the end's stamp, the sweeps', an entry's


def instrumented_source() -> str:
    path = os.path.join(os.path.dirname(native.__file__), "csrc",
                        "lines_label.cu")
    src = open(path).read()
    src = src.replace("#include <stdint.h>", f"""#include <stdint.h>
__device__ long long g_stamps[{SLOTS} * {STAMPS}];
__device__ __forceinline__ long long stamp_now() {{
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}""", 1)

    def stamp(k):
        return (f"  if (threadIdx.x == 0) g_stamps[(blockIdx.y * gridDim.x "
                f"+ blockIdx.x) * {STAMPS} + {k}] = stamp_now();\n")

    for k, a in enumerate(ANCHORS):
        if a not in src:
            raise SystemExit(f"lines_label.cu changed: no anchor {a!r}")
        src = src.replace(a, stamp(k) + a, 1)
    end = ("    out.labels[base + t] = A[t];\n  }\n}")
    if end not in src:
        raise SystemExit("lines_label.cu changed: no end of the kernel")
    src = src.replace(end, "    out.labels[base + t] = A[t];\n  }\n"
                      "  __syncthreads();\n" + stamp(END) + "}", 1)
    loop = "    if (!__syncthreads_or(changed)) break;"
    src = src.replace(loop, "    if (tid == 0) g_stamps[(blockIdx.y * "
                      f"gridDim.x + blockIdx.x) * {STAMPS} + {ITERS}] = "
                      "it + 1;\n" + loop)
    return src + """
extern "C" int read_stamps(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
extern "C" int clear_stamps() {
  static long long z[%d * %d];
  return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
}
""" % (SLOTS, STAMPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "k9.cu"), os.path.join(tmp, "k9.so")
        with open(cu, "w") as f:
            f.write(instrumented_source())
        subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-shared", cu,
                        "-o", so], check=True)
        lib = ctypes.CDLL(so)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn = lib.lines_label
        fn.argtypes = [kinds[c] for c in native._SIGNATURES["lines_label"]
                       ] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        cfg = SlamConfig()
        cam = StereoCamera.from_config(cfg.camera)
        seq = synthetic.make_sequence(cam, n_frames=20, seed=1,
                                      n_points=500, n_lines=60, noise=0.003,
                                      step=0.25)
        imgs = torch.from_numpy(np.concatenate([seq.images_l, seq.images_r])
                                ).to(dev)
        N, H, W = imgs.shape
        for tag, img, half in (("full", imgs, False), (
                "half", image.resize_bilinear(imgs, (H // 2, W // 2)), True)):
            kw = stereo_lines.detect_kwargs(cfg.lines, half, math.hypot(H, W))
            tile = kw["tile"]
            w, d2x, d2y = lines.gradient_planes(img, kw["grad_th"])
            D2x, D2y = lines.orientation_maps(d2x, d2y, tile, tile // 2)
            d2n = lines.sqrt_rn(D2x * D2x + D2y * D2y) + 1e-9
            maps = lines.reweighted_moments(w, d2x, d2y, D2x / d2n,
                                            D2y / d2n, tile, tile // 2)
            maps = [m.contiguous() for m in maps]
            gargs = (*maps, tile, kw["min_support"], kw["elong_th"],
                     kw["perp_spread_th"], kw["coherence_th"],
                     kw["merge_ang_th"], kw["merge_dist_th"],
                     kw["merge_iters"])
            ref = lines.gates_and_labels(*gargs)
            _, Th, Tw = maps[0].shape
            ok = torch.empty((N, Th, Tw), dtype=torch.bool, device=dev)
            out = torch.empty((5, N, Th, Tw), device=dev)
            lab = torch.empty((N, Th, Tw), dtype=torch.int32, device=dev)
            scratch = torch.empty((N, 3, Th, Tw), device=dev)
            bits = torch.empty((N, (Th * Tw + 31) // 32), dtype=torch.int32,
                               device=dev)
            count = torch.zeros(N, dtype=torch.int32, device=dev)
            args = [*maps, ok.view(torch.uint8), *out.unbind(0), lab,
                    scratch, bits, count, N, Th, Tw, tile // 2,
                    kw["min_support"] * tile, kw["elong_th"],
                    kw["perp_spread_th"], kw["coherence_th"],
                    kw["merge_ang_th"], kw["merge_dist_th"],
                    kw["merge_iters"]]
            conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                    for a in args]

            def call():
                rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise SystemExit(f"lines_label failed: error {rc}")

            for _ in range(3):
                call()
            if lib.clear_stamps() != 0:
                raise SystemExit("clearing the stamps failed")
            call()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       zip((ok, *out.unbind(0), lab), ref))
            if not same:
                raise SystemExit(f"{tag}: the instrumented kernel differs "
                                 "from gates_and_labels")
            st = np.zeros(SLOTS * STAMPS, np.int64)
            if lib.read_stamps(ctypes.c_void_p(st.ctypes.data)) != 0:
                raise SystemExit("reading the stamps failed")
            st = st.reshape(SLOTS, STAMPS)
            used = st[:, 0] > 0
            t0 = st[used, 0].min()
            tails = st[st[:, 2] > 0]
            steps = [st[used, 1] - st[used, 0]]
            steps += [tails[:, k + 1] - tails[:, k] for k in range(1, END)]
            print(f"[k9] {tag} ({Th}x{Tw} tiles, {N} images, "
                  f"{int(used.sum()) // N} slices an image; outputs "
                  f"bit-equal): ns mean / max", flush=True)
            for name, d in zip(PHASES, steps):
                print(f"[k9]   {name}: {d.mean():.0f} / {d.max()}",
                      flush=True)
            print(f"[k9]   last CTA starts {np.mean(tails[:, 2] - t0):.0f} "
                  f"/ {np.max(tails[:, 2] - t0)}, ends "
                  f"{np.mean(tails[:, END] - t0):.0f} / "
                  f"{np.max(tails[:, END] - t0)}; sweeps "
                  f"{tails[:, ITERS].mean():.2f} / {tails[:, ITERS].max()}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
