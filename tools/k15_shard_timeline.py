"""Where the time of the owner-sharded LBA step's two K15 launches goes on
the card: copies of plslam_tpu_torch/csrc/lba.cu with globaltimer stamps
at the phases of ``schur_corr_kernel`` (``lba_schur_corr``) and
``solve_reduced_kernel`` (``lba_solve_reduced``), by the machinery of
``tools/k12_k15_timeline.py``.

- ``lba_schur_corr`` on shard 0 of 4 of chip_smoke.py's
  ``lba_window_problem`` (the plain blocks at the plain terms' scale):
  each CTA's start, a chunk's offsets, its masks and factors, its pair
  bits and E, warp 0's plan of the pieces and the rest of the pairs'
  landmark lists (warps 1-4), its pair sums (the CTA's last chunk), its
  sums sent to the CTAs that own them, and the cluster barrier with its
  slice of the rank-order sums; then the
  package's kernel's device time (torch.profiler, chip_smoke.py's
  ``device_ms``) over other cluster plans (CTAs, chunk, chunks a CTA).
- ``lba_solve_reduced`` on the same shard, from the plain sums
  all-reduced: CTA 0's free poses (a ballot), its assembly of S, the block
  L D L^T, the back-substitution and the step, and the push into the
  stepping CTAs after the cluster barrier's first phase; then each block
  step of the factorization: warp 0's inverse of the next diagonal block,
  warp 1's panel and trailing update, and the whole step.

Needs an sm_90 card and nvcc; run from the repository root:

    python3 tools/k15_shard_timeline.py

Holds the instrumented copies' outputs bit-equal to the package's
kernels, and prints the card's name and power limit, then each phase's
mean and largest time in ns (%globaltimer ticks in steps of 32 ns on the
H100). Imports nothing of JAX.
"""

import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import k12_k15_timeline as tl  # noqa: E402
from chip_smoke import (device_ms, dist_plain_inputs,  # noqa: E402
                        lba_window_problem)
from plslam_tpu_torch import native  # noqa: E402
from plslam_tpu_torch.backend import lba  # noqa: E402
from plslam_tpu_torch.config import SlamConfig  # noqa: E402
from plslam_tpu_torch.core.camera import StereoCamera  # noqa: E402

tl.STAMPS = 10
tl.KERNELS["lba_schur_corr"] = (
    "lba.cu", "lba_schur_corr", "threadIdx.x == 0", "blockIdx.x",
    ["  if (tid < W) s_free[tid] = a.free_[tid];",
     "    // 2. each landmark's observing free poses",
     "    // 3. warps 0-1: each landmark's mask out",
     "    // 4. warp 0: the touched pairs, and their landmark runs",
     "    __syncthreads();\n    // 5. the pieces",
     "    const int items = s_items, split = s_split",
     "  // 6. every CTA runs",
     "  cluster_sync_all();\n  const int lo = rank * sl"],
    ["offsets", "masks and factors", "pair bits and E", "warp 0's plan",
     "the rest of the lists", "pair sums", "the sums sent",
     "cluster barrier and rank-order sums out"],
    "    if (w != v) a.corr[((size_t)v * W + w) * 36 + 6 * c + r] = f;\n"
    "  }\n")
tl.KERNELS["lba_solve_reduced"] = (
    "lba.cu", "lba_solve_reduced", "threadIdx.x == 0", "blockIdx.x",
    ["  // 1. the free poses, a bit each",
     "  // 2. S and g (lba_solve's arithmetic",
     "  // 3. the block L D L^T",
     "  // 4. warp 0: L^T x = z by blocks",
     "  // 5. every CTA runs (the first phase)"],
    ["free poses", "assembly", "block L D L^T", "back-substitution and step",
     "first phase's wait and the push"],
    "        s_step[i % (6 * W)];\n")


# lba_solve_reduced's block steps: CTA 0's thread 0 (warp 0) and thread 32
# (warp 1) stamp each step k's start, warp 1's panel, and each warp's end
# before the step's barrier
STEP_MARKS = (
    ("    const int b = 6 * (k + 1), nt = nf - b;   // the trailing rows\n",
     True, "    if (threadIdx.x == 0) g_steps[4 * k] = step_now();\n"),
    ('      asm volatile("bar.sync 1, %0;" ::"r"(RED_NT - 32) : "memory");\n',
     False, "      if (threadIdx.x == 32) g_steps[4 * k + 1] = step_now();\n"),
    ("    __syncthreads();\n  }\n  // 4. warp 0: L^T x = z by blocks",
     False, "    if (threadIdx.x == 0) g_steps[4 * k + 2] = step_now();\n"
     "    if (threadIdx.x == 32) g_steps[4 * k + 3] = step_now();\n"))


def steps_source() -> str:
    src = open(os.path.join(ROOT, "plslam_tpu_torch", "csrc",
                            "lba.cu")).read()
    src = src.replace("#include <stdint.h>", """#include <stdint.h>
__device__ long long g_steps[64 * 4];
__device__ __forceinline__ long long step_now() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}""", 1)
    for anchor, after, code in STEP_MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"lba.cu changed: no anchor {anchor!r}")
        src = src.replace(anchor, anchor + code if after else code + anchor)
    return src + """
extern "C" int read_steps(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_steps, sizeof(g_steps));
}
"""


def report_steps(tmp: str, args: list) -> None:
    """Each block step of lba_solve_reduced's factorization: warp 0's
    D_k+1 and its inverse, warp 1's panel and trailing update, and the
    whole step to the next one's start (ns)."""
    import ctypes
    import numpy as np
    cu, so = os.path.join(tmp, "steps.cu"), os.path.join(tmp, "steps.so")
    with open(cu, "w") as f:
        f.write(steps_source())
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-I",
                    os.path.join(ROOT, "plslam_tpu_torch", "csrc"),
                    "-shared", cu, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    fn = lib.lba_solve_reduced
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn.argtypes = [kinds[c] for c in native._SIGNATURES[
        "lba_solve_reduced"]] + [ctypes.c_void_p]
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    for _ in range(4):
        if fn(*conv, torch.cuda.current_stream().cuda_stream) != 0:
            raise SystemExit("the stamped lba_solve_reduced failed")
    torch.cuda.synchronize()
    st = np.zeros(64 * 4, np.int64)
    lib.read_steps(ctypes.c_void_p(st.ctypes.data))
    st = st.reshape(64, 4)
    F = int((st[:, 0] > 0).sum())
    for k in range(F):
        s = st[k]
        nxt = st[k + 1, 0] if k + 1 < F else s[2]
        print(f"[lba_solve_reduced] step {k}: warp 0 {s[2] - s[0]}, warp 1 "
              f"panel {s[1] - s[0]} and update {s[3] - s[1]}, the step "
              f"{nxt - s[0]}", flush=True)


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
    prob = lba_window_problem(dev, cfg, cam)
    _, probs, _, _, frees, H_cc, g_c, bps, corr, g_corr, lam = (
        dist_plain_inputs(dev, cfg, cam, prob, 4))
    p, f = probs[0], frees[0]
    b = lba.LandmarkBlocks(*(x.contiguous() for x in bps[0]))
    W, N = b.H_cl.shape[:2]
    K, L = p.obs_pt_id.shape[1], p.obs_ln_sid.shape[1]
    idx = lba.lba_index(p)
    words = lba._solve_words(W, N)
    scr = lba.new_solve_scratch(W, N, dev)
    fu8 = f.to(torch.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        want = lba.lba_schur_corr(b, p, f, idx, scr)
        outs = [torch.empty_like(x) for x in want]
        layout = lba.schur_corr_layout(W, N)
        lib, fn = tl.build("lba_schur_corr", tmp)
        st = tl.run("lba_schur_corr", lib, fn,
                    [idx.off, idx.obs, b.H_inv, b.g_l, b.H_cl, fu8, *outs,
                     scr, words, W, K, L, N, *layout], outs, list(want))
        tl.report("lba_schur_corr", st, f"W={W} N={N}, {layout[0]} CTAs, "
                  f"chunks of {layout[1]}, {layout[2]} a CTA")
        # the package's kernel over other plans
        plans = [layout]
        for CH in lba.CORR_CHUNKS:
            G = -(-N // CH)
            for per in (1, 2):
                if (-(-G // per) <= lba.CORR_MAX_C
                        and lba.corr_smem(W, CH) <= lba.CORR_MAX_SMEM):
                    plans.append((-(-G // per), CH, per))
        for C, CH, per in plans:

            def call():
                native.launch("lba_schur_corr", idx.off, idx.obs, b.H_inv,
                              b.g_l, b.H_cl, fu8, *outs, scr, words, W, K,
                              L, N, C, CH, per)

            call()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(outs, want))
            print(f"[lba_schur_corr] {C} CTAs, chunks of {CH}, {per} a "
                  f"CTA: device_ms {device_ms(call, iters=20):.4f}; the "
                  f"same bits as the plan's: {same}", flush=True)
        args = [x.contiguous() for x in (H_cc[0], g_c[0], corr[0],
                                         g_corr[0])]
        got = lba.lba_solve_reduced(*args, b, p, f, lam, scratch=scr)
        want = [got[0], torch.cat(got[1:])]
        outs = [torch.empty_like(x) for x in want]
        lib, fn = tl.build("lba_solve_reduced", tmp)
        st = tl.run("lba_solve_reduced", lib, fn,
                    [*args, b.H_ll, b.H_inv, b.g_l, b.H_cl, lam, fu8, *outs,
                     scr, words, W, N, float(lba.PIN_WEIGHT), 1], outs, want)
        tl.report("lba_solve_reduced", st, f"W={W} N={N}, "
                  f"{int(f.sum())} free poses, CTA 0 of "
                  f"{lba.solve_reduced_cluster(N)}")
        report_steps(tmp, [*args, b.H_ll, b.H_inv, b.g_l, b.H_cl, lam, fu8,
                           *outs, scr, words, W, N, float(lba.PIN_WEIGHT),
                           1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
