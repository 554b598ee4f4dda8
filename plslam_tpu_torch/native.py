"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The kernel sources are compiled by ``nvcc`` for ``sm_90a`` at first
use, one ``nvcc`` per source started together, and linked into one
shared library with a plain C interface under ``_build/`` (git-ignored).
The library name carries a hash of the sources, so an edited source is
rebuilt. Nothing is built or loaded at import time.

Every C entry point takes raw device pointers and the current CUDA
stream last, launches without synchronising, and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and
counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from typing import Dict, List, Optional

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ["image.cu", "fast.cu", "orb.cu", "hamming.cu", "lines_tile.cu",
           "lines_label.cu", "lines_segments.cu", "lbd.cu", "pose_gn.cu",
           "slam.cu", "lba.cu", "bow.cu", "pose_graph.cu", "remap.cu"]
# headers the sources include: part of the library's hash
HEADERS = ["radix_select.cuh"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# C signatures: p = device pointer, i = int, f = float; every entry point
# takes the stream as one more trailing pointer.
_SIGNATURES: Dict[str, str] = {
    "image_sep_filter": "ppppiiiii",
    "image_resize": "pppiiiii",
    "fast_score": "pppppiiiff",
    "fast_nms_block": "ppppppppiiiiiii",
    "orb_describe": "pippi" + "pppppp" + "ii",
    "hamming_dist": "ppppppiii",
    "hamming_match": "pppppiiiffi",
    "hamming_scan": "pipippi" + "ppppp" + "fff" + "pppp" + "iii",
    "hamming_finish": "p" * 6 + "iiiff",
    "lines_sobel": "ppppppiiifi",
    "lines_moments": "pppppppiiiiii",
    "lines_tile_moments": "ppiiiiiifi",
    "lines_label": "p" * 18 + "iiii" + "ffffff" + "i",
    "lines_refit": "p" * 17 + "iii" + "fff",
    "lines_merge": "p" * 10 + "iii" + "fffi",
    "lbd_describe": "p" * 9 + "iiiiiii" + "ffi",
    "pose_gn_optimize": "p" * 15 + "i" * 7 + "f" * 7,
    "kf_scan": "ppppp" + "iii" + "fff",
    "medoid": "pppppii",
    "lba_terms": "p" * 21 + "iiiii" + "fffff",
    "lba_camera": "p" * 11 + "iiiiii",
    "lba_index": "p" * 5 + "iiiii" + "ii",
    "lba_bin": "p" * 18 + "iiiii",
    "lba_solve": "p" * 13 + "iiiii" + "fi",
    "lba_schur_corr": "p" * 9 + "iiiii",
    "lba_solve_reduced": "p" * 13 + "iii" + "fi",
    "bow_descend": "pppiii",
    "bow_hist": "ppppii",
    "pg_edges": "p" * 10 + "iiii",
    "pg_assemble": "p" * 14 + "ii",
    "pg_blocks": "p" * 14 + "ii",
    "pg_pcg": "p" * 14 + "iii",
    "pg_update": "p" * 22 + "iiiii" + "f",
    "remap_bilinear": "pppiiiiii",
}

# the kernels' device function names (csrc/*.cu): what chip_smoke.py and
# profile_torch_vo.py count as the hand-written kernels' device time
KERNEL_FUNCTIONS = (
    "filter_kernel", "resize_kernel",
    "fast_score_kernel", "nms_block_kernel",
    "orb_describe_kernel", "dist_kernel", "col_argmin_kernel",
    "row_match_kernel", "hamming_scan_kernel", "hamming_finish_kernel",
    "sobel_kernel", "block_moments", "window_moments",
    "tile_moments_kernel", "label_kernel",
    "refit_kernel", "merge_kernel", "lbd_kernel", "pose_optimize_kernel",
    "kf_scan_kernel", "medoid_kernel", "terms_kernel",
    "camera_kernel", "lba_index_kernel", "bin_index_kernel",
    "schur_solve_kernel", "landmark_step_kernel", "bow_descend_kernel",
    "bow_hist_kernel",
    "pg_edges_kernel", "pg_assemble_kernel", "pg_blocks_kernel",
    "pg_pcg_kernel", "pg_update_kernel", "remap_kernel")



def is_own_kernel(name: str) -> bool:
    """Whether a torch.profiler event name is one of KERNEL_FUNCTIONS
    (``(anonymous namespace)::f(...)`` or ``...::f<...>``; torch's own
    kernels may contain the same words, as ``gpu_index_kernel``)."""
    return any(f"::{f}(" in name or f"::{f}<" in name
               for f in KERNEL_FUNCTIONS)


# launches per C entry point since the last reset (plain versions on CPU
# tensors are never counted); the tracker and the mapping worker launch
# from two threads, so every update holds _count_lock
LAUNCHES: Counter = Counter()

_lock = threading.Lock()
_count_lock = threading.Lock()
_sink = threading.local()     # a thread's redirect of its own launches
_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def reset_counts() -> None:
    with _count_lock:
        LAUNCHES.clear()


def add_counts(counts: Counter) -> None:
    """Count launches made elsewhere (a CUDA graph replay's)."""
    with _count_lock:
        LAUNCHES.update(counts)


class counting_into:
    """Context manager: the calling thread's launches go to ``counts``
    instead of LAUNCHES (a CUDA graph capture records launches that only
    its replays execute); other threads keep counting in LAUNCHES."""

    def __init__(self, counts: Counter):
        self.counts = counts

    def __enter__(self) -> Counter:
        self.prev = getattr(_sink, "counts", None)
        _sink.counts = self.counts
        return self.counts

    def __exit__(self, *exc) -> None:
        _sink.counts = self.prev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "plslam_tpu_torch are built at first use and need "
                           "the CUDA toolkit")
    return path


def _lib_path() -> str:
    h = hashlib.sha1()
    for s in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, s), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libplslam_kernels_{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile every source in parallel and link the shared library."""
    global BUILD_SECONDS
    out = _lib_path()
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    # objects go to a directory of this process's own, so two processes
    # that build at once (test workers) never write the same file
    obj_dir = os.path.join(BUILD_DIR, f"obj{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    t0 = time.perf_counter()
    objs: List[str] = []
    procs = []
    for s in SOURCES:
        obj = os.path.join(obj_dir, s.replace(".cu", ".o"))
        objs.append(obj)
        procs.append((s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC, s), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"--- {s} ---\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out + f".tmp{os.getpid()}"
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                     "f": ctypes.c_float}
            for name, sig in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = [kinds[c] for c in sig] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` on the current stream; raise on error.

    Tensor arguments pass as their data pointers; they must stay alive
    until the kernel has run, which the caller guarantees by holding them
    (PyTorch's caching allocator keeps stream order)."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    sink = getattr(_sink, "counts", None)
    with _count_lock:
        (LAUNCHES if sink is None else sink)[name] += 1


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Check what a kernel takes: CUDA, dtype, contiguity, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
