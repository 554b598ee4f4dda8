"""Where the time of kernel E's one launch (``lines_tile_moments``) goes on
the card: copies of plslam_tpu_torch/csrc/lines_tile.cu with phases cut
out, timed beside the whole kernel on chip_smoke.py's line scene (40
images, 376x1241) at full and at half resolution with the detector's
settings.

Needs an sm_90 card and nvcc; run from the repository root:

    python3 tools/e_phases.py

Builds each copy with nvcc into a temporary directory, holds the whole
copy's maps bit-equal to ``lines.tile_moments`` (the kernel as built by
the package), and prints the card's name and power limit, then, in turns
(whole, cut, cut, whole), the device time of each copy (CUDA events over
50 launches): "whole"; "no reweighted pass" (the tile copy, the
orientation pass, the unit field and the windows); "no orientation pass"
(the copy, the unit field and windows of empty orientation blocks, the
reweighted pass, which does the same work on them); "copy only". Each
pass's share is printed two ways, the pass added to the copy alone and
the pass taken from the whole: a warp starts its orientation pass when
its own rows have landed, so the copy and the passes overlap and the two
estimates bracket the pass. Imports nothing of JAX.
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

# the condition of each pass in the kernel's source, and what cuts it
R_PASS = "  if (warp <= nby && lane <= nbx) {\n    const int bi = i0 + warp, bj"
O_PASS = "    if (warp < nby + 3 && lane < nbx + 3 && bi >= 0"


def cut(src: str, anchor: str) -> str:
    """The source with the pass that starts at ``anchor`` never taken."""
    assert anchor in src, anchor
    return src.replace(anchor, anchor.replace("if (", "if (N < 0 && ", 1), 1)


def copies():
    path = os.path.join(os.path.dirname(native.__file__), "csrc",
                        "lines_tile.cu")
    src = open(path).read()
    return {"whole": src, "no reweighted pass": cut(src, R_PASS),
            "no orientation pass": cut(src, O_PASS),
            "copy only": cut(cut(src, R_PASS), O_PASS)}


def build(tmp: str, src: str):
    cu = os.path.join(tmp, f"{len(os.listdir(tmp))}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-shared", cu, "-o",
                    so], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(so).lines_tile_moments
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def event_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    cfg = SlamConfig()
    cam = StereoCamera.from_config(cfg.camera)
    seq = synthetic.make_sequence(cam, n_frames=20, seed=1, n_points=500,
                                  n_lines=60, noise=0.003, step=0.25)
    imgs = torch.from_numpy(np.concatenate([seq.images_l, seq.images_r])
                            ).to(dev)
    N, H, W = imgs.shape
    with tempfile.TemporaryDirectory() as tmp:
        fns = {k: build(tmp, v) for k, v in copies().items()}
        for tag, img, half in (("full", imgs, False),
                               ("half", image.resize_bilinear(
                                   imgs, (H // 2, W // 2)), True)):
            kw = stereo_lines.detect_kwargs(cfg.lines, half, math.hypot(H, W))
            tile, th = kw["tile"], kw["grad_th"]
            n, h, w = img.shape
            Th, Tw = lines.tile_grid(h, w, tile)
            outs = {k: torch.empty((8, n, Th, Tw), device=dev) for k in fns}
            calls = {k: (lambda f=f, o=outs[k]: f(
                img.data_ptr(), o.data_ptr(), n, h, w, Th, Tw, tile // 2, th,
                0, torch.cuda.current_stream().cuda_stream))
                for k, f in fns.items()}
            for k, c in calls.items():
                if c() != 0:
                    print(f"{k}: launch failed", file=sys.stderr)
                    return 1
            torch.cuda.synchronize()
            want = torch.stack(lines.tile_moments(img, tile, th))
            if not torch.equal(outs["whole"], want):
                print("the whole copy differs from lines.tile_moments",
                      file=sys.stderr)
                return 1
            order = list(calls)
            times = {k: [] for k in calls}
            for rep in range(2):
                for k in (order if rep == 0 else order[::-1]):
                    times[k].append(event_ms(calls[k]))
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            print(f"[{tag}] {n} x {h}x{w}, {Th}x{Tw} windows: "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
                  flush=True)
            copy = ms["copy only"]
            print(f"[{tag}] copy {copy:.4f} ms; orientation pass "
                  f"{ms['no reweighted pass'] - copy:.4f} added to the copy, "
                  f"{ms['whole'] - ms['no orientation pass']:.4f} taken from "
                  f"the whole; reweighted pass "
                  f"{ms['no orientation pass'] - copy:.4f} added to the copy, "
                  f"{ms['whole'] - ms['no reweighted pass']:.4f} taken from "
                  "the whole", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
