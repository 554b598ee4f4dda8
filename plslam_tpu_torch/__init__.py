"""plslam_tpu_torch — the PyTorch + CUDA (Hopper) port of plslam_tpu.

The chunked stereo VO with and without lines (``tracking.batch_vo``), the
per-frame VO (``tracking.frame_handler.StereoVO``), the fused SLAM chunk
with and without loop closure (``backend.fused_slam``: KF-slot compaction
past ``max_kfs``, checkpoints through ``backend.checkpoint``), the
per-frame and host-KF SLAM drivers with the mapping worker thread
(``backend.slam_system``, ``backend.map_handler.MapHandler``), the dataset
VO app (``apps.plstvo_dataset`` over ``io.dataset``), the SLAM app
(``apps.plslam_dataset``), concurrent sessions
(``apps.plslam_multiseq``) and the distributed back end (``parallel``: the
owner-sharded window LBA, sharded BoW retrieval, meshes over torch devices
and processes). The JAX package
``plslam_tpu`` is the reference; this package imports nothing of it (nor
of JAX) and keeps its own copies of the numpy-only modules.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``. Hot ops are hand-written CUDA kernels
(``plslam_tpu_torch/csrc``); each has a plain PyTorch version beside it,
which runs only for CPU tensors.
"""

import torch

# The reference pins all pose math to full f32 (plslam_tpu/core/lie.py
# ``mm``, pose_gn HIGHEST-precision einsums): TF32 breaks the rotation
# validity gates and the 6x6 solve conditioning.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "plslam_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
