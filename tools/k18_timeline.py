"""Where the time of K18's edge sweep goes on the card: copies of
plslam_tpu_torch/csrc/pose_graph.cu with globaltimer stamps in
``pg_edges`` (with Ji) and ``pg_update`` (on an accepted step, on a
rejected step, and on an accepted step that also hands on the gradient in
the dense order) at the loop closer's four slot buckets (chip_smoke.py's
``PG_BUCKETS``).

Each CTA stamps its start, the start of its first residual (after the
barrier that follows the loads, the end poses' and the own slots' trial
poses; a stamp right after the barrier may be scheduled before it, as the
timer read depends on nothing), the
end of its residuals, its partial (before the fence and the count, or
the grid barrier of ``pg_update``'s cooperative launch), the sum of the
partials (``pg_edges``: the last CTA) and its end (``pg_edges``: the last
CTA; ``pg_update``: every CTA, after its write-back of a rejected step or
its slots' gradient); in ``pg_update`` warps 1 and 3 also stamp the end of
their trial poses.

Needs an sm_90 card and nvcc; run from the repository root:

    python3 tools/k18_timeline.py

Builds the instrumented copy with nvcc into a temporary directory, holds
its outputs bit-equal to the package's kernels, and prints the card's
name and power limit, then each phase's mean and largest time in ns
(%globaltimer ticks in steps of 32 ns on the H100) and each launch's
device time (torch.profiler, chip_smoke.py's ``device_ms``). Imports
nothing of JAX.
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

from chip_smoke import PG_BUCKETS, device_ms  # noqa: E402
from plslam_tpu_torch import convert, native  # noqa: E402
from plslam_tpu_torch.io import synthetic  # noqa: E402
from plslam_tpu_torch.loop import pose_graph as pg  # noqa: E402

SLOTS = 256              # CTAs the table holds
STAMPS = 8
# (anchor, the stamp inserted before it, or after it where the anchor ends
# in a newline and the stamp starts with one); stamp k of CTA b is
# g_stamps[b * STAMPS + k]. Inserted in this order: an earlier anchor may
# hold a later one's text.
NOW = "g_stamps[blockIdx.x * %d + %%d] = stamp_now();" % STAMPS
INSERTS = [
    # pg_edges
    ("  float Ti[16], Tj[16], w = 0.0f;\n", f"  if (tid == 0) {NOW % 0}\n"),
    ("  __syncthreads();\n  copy_floats<1>(s.r + (size_t)e0 * 6, sR, n * 6, tid, "
     "EDGE_NT);\n  if (JAC)", f"  if (tid == 0) {NOW % 2}\n"),
    ("    *cost = s_total;\n",
     f"\n  if (tid == 0) {NOW % 5}\n"),
    # pg_update
    ("  float w = 0.0f;\n  if (warp == 0) {  // w and the Tm rows",
     f"  if (tid == 0) {NOW % 0}\n"),
    ("  } else if (warp <= 4) {  // the CTA's own slots' trial poses",
     f"    if (tid == 32) {NOW % 6}\n"),
    ("  } else if (grad) {  // the edges' Ji rows; the slots' list entries",
     f"    if (tid == 96) {NOW % 7}\n"),
    ("  if (grad) {  // u = Ji^T r of the CTA's edges",
     f"  if (tid == 0) {NOW % 2}\n"),
    ("    fence_acq_rel_gpu();\n    atomicAdd(count, 1u);",
     f"    {NOW % 3}\n"),
    ("  if (tid == 0 && b == 0) *c_out = ok ? c_new : c;",
     f"  if (tid == 0) {NOW % 5}\n"),
    # shared: warp 0's first residual, the cost
    ("    if (w > 0.0f) edge_residual(sT + l * 16, Ti, Tj, r);",
     f"    if (l == 0) {NOW % 1}\n"),
    ("    fence_acq_rel_gpu();\n    const bool last = atomicAdd",
     f"    {NOW % 3}\n"),
    ("  if (tid == 0) *total = c;\n",
     f"  if (tid == 0) {NOW % 4}\n"),
]
PHASES = ["staging", "residuals", "r (and u) out and partial",
          "fence, count or grid barrier, sum",
          "write-back or gradient, end"]


def instrumented_source() -> str:
    src = open(os.path.join(ROOT, "plslam_tpu_torch", "csrc",
                            "pose_graph.cu")).read()
    src = src.replace("#include <stdint.h>", f"""#include <stdint.h>
__device__ long long g_stamps[{SLOTS} * {STAMPS}];
__device__ __forceinline__ long long stamp_now() {{
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t) :: "memory");
  return t;
}}""", 1)
    for anchor, stamp in INSERTS:
        if src.count(anchor) != 1:
            raise SystemExit(f"pose_graph.cu changed: anchor {anchor!r}")
        after = anchor.endswith("\n") and stamp.startswith("\n")
        src = src.replace(anchor, anchor + stamp[1:] if after
                          else stamp + anchor, 1)
    return src + """
extern "C" int read_stamps(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
extern "C" int clear_stamps() {
  static long long z[%d * %d];
  return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
}
""" % (SLOTS, STAMPS)


def build(tmp: str):
    cu, so = os.path.join(tmp, "pg.cu"), os.path.join(tmp, "pg.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-shared", cu, "-o",
                    so], check=True)
    lib = ctypes.CDLL(so)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fns = {}
    for entry in ("pg_edges", "pg_update"):
        fn = getattr(lib, entry)
        fn.argtypes = [kinds[c] for c in native._SIGNATURES[entry]] + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return lib, fns


def stamps(lib, fn, args, outs, want) -> np.ndarray:
    """Launch the instrumented copy with ``args``, hold ``outs`` to
    ``want``, return the stamps of the last launch (a row a CTA)."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def call():
        rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"the instrumented launch failed: error {rc}")

    for _ in range(3):
        call()
    if lib.clear_stamps() != 0:
        raise SystemExit("clearing the stamps failed")
    call()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs, want)):
        raise SystemExit("the instrumented kernel differs from the package's")
    st = np.zeros(SLOTS * STAMPS, np.int64)
    if lib.read_stamps(ctypes.c_void_p(st.ctypes.data)) != 0:
        raise SystemExit("reading the stamps failed")
    st = st.reshape(SLOTS, STAMPS)
    return st[st[:, 0] > 0]


def report(tag: str, st: np.ndarray, update: bool) -> None:
    t0 = st[:, 0].min()
    last = int(np.argmax(st[:, 5]))
    print(f"[{tag}] {len(st)} CTAs; ns from the CTA's start, mean / max "
          f"(the last CTA's own in brackets)", flush=True)
    for k, name in enumerate(PHASES):
        d = st[:, k + 1] - st[:, k]
        ok = (st[:, k + 1] > 0) & (st[:, k] > 0)
        mean = d[ok].mean() if ok.any() else float("nan")
        print(f"[{tag}]   {name}: {mean:.0f} / {d[ok].max() if ok.any() else 0}"
              f" ({st[last, k + 1] - st[last, k]})", flush=True)
    if update:
        for k, who in ((6, "warp 1's end poses"), (7, "warp 3's own poses")):
            d = st[:, k] - st[:, 0]
            print(f"[{tag}]   {who} done after {d.mean():.0f} / {d.max()}",
                  flush=True)
    starts = st[:, 0] - t0
    print(f"[{tag}]   starts (from the first) median / last "
          f"{np.median(starts):.0f} / {starts.max()}; the last CTA ends at "
          f"{st[last, 5] - t0}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        lib, fns = build(tmp)
        for F, n, extra in PG_BUCKETS:
            gd = convert.pose_graph_from_numpy(
                synthetic.drift_circle_graph(F, n, extra, seed=F)[0], dev)
            a = pg._args(gd)
            E = a[4].shape[0]
            ctas, nt = pg.edge_layout(E)
            part, count, u = pg._sweep_scratch(dev, ctas, E)
            r, J, c = pg.edges(gd)
            ro, Jo = torch.empty_like(r), torch.empty_like(J)
            co = torch.empty_like(c)
            st = stamps(lib, fns["pg_edges"], [*a, ro, Jo, co, part, count, F,
                                               E, ctas, nt], [ro, Jo, co],
                        [r, J, c])
            report(f"pg_edges@{F}", st, False)
            freeze = torch.zeros(F, dtype=torch.bool, device=dev)
            diag = pg._diag(gd, freeze, True)
            rp, Jp, _ = pg.edges_plain(gd)
            gv, Hd = pg.blocks_plain(gd, rp, Jp, diag)
            dx = pg.pcg_plain(gd, Jp, torch.linalg.inv_ex(Hd)[0], diag, gv,
                              96)
            va = gd.pose_valid.to(torch.uint8)
            inc = pg._incidence(gd)
            g_in = torch.zeros((6 * F,), device=dev)
            for tag, scale, grad in (("accepted", 1.0, False),
                                     ("rejected", -1.0, False),
                                     ("accepted, gradient", 1.0, True)):
                want = pg.update(gd, c, dx, scale, r, None, (
                    "dense", J, g_in, torch.empty_like(g_in), inc)
                    if grad else None)
                outs = [torch.empty_like(x) for x in want]
                P, co, ro = outs[:3]
                gargs = ([*inc, J, g_in, outs[3], u] if grad
                         else [None] * 8)
                st = stamps(lib, fns["pg_update"],
                            [*a, c, dx, va, r, P, ro, co, part, count,
                             *gargs, F, E, ctas, nt,
                             pg.GRAD_MODES["dense"] if grad else 0, scale],
                            outs, list(want))
                report(f"pg_update@{F} {tag}", st, True)
            g_out = torch.empty_like(g_in)
            ms = [device_ms(fn, iters=20) for fn in (
                lambda: pg.edges(gd), lambda: pg.edges(gd, jac=False),
                lambda: pg.update(gd, c, dx, 1.0, r),
                lambda: pg.update(gd, c, dx, -1.0, r),
                lambda: pg.update(gd, c, dx, 1.0, r, None,
                                  ("dense", J, g_in, g_out, inc)))]
            print(f"[k18] Fb={F}, {ctas} CTAs of {nt} threads: device_ms "
                  f"pg_edges {ms[0]:.4f}, without Ji {ms[1]:.4f}, pg_update "
                  f"accepted {ms[2]:.4f}, rejected {ms[3]:.4f}, accepted "
                  f"with the gradient {ms[4]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
