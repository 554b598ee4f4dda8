"""Dataset readers (port of ``plslam_tpu/io/dataset.py``).

Enumerates stereo image pairs and carries the calibration:
  * KITTI odometry layout   (<dir>/image_0/*.png, <dir>/image_1/*.png,
                             ground truth from <dir>/poses.txt)
  * EuRoC ASL layout        (<dir>/mav0/cam0/data/*.png, cam1/...): a raw
                             rig, rectified on the host
  * generic params yaml     (<dir>/dataset_params.yaml with
                             images_subfolder_l/r + calibration keys)
  * synthetic               (in-memory ground-truth scenes)

Images decode through ``io/imageio.py`` (no PIL, no libpng) and YAML
through ``io/yaml_lite.py`` (no PyYAML). Frames come back as host (H, W)
float32 arrays in [0, 1], as the reference returns them; a raw rig's
frames are rectified on the host with the reference's clamping remap
inside the prefetch workers.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from plslam_tpu_torch.config import CameraConfig, SlamConfig
from plslam_tpu_torch.io import yaml_lite
from plslam_tpu_torch.io.imageio import Prefetcher, load_gray


class StereoDataset:
    """Iterates (img_l, img_r) float32 pairs + optional GT poses."""

    def __init__(self, left: List[str], right: List[str],
                 camera: CameraConfig, gt_poses: Optional[np.ndarray] = None,
                 name: str = "dataset", rect_maps=None):
        assert len(left) == len(right), "stereo list length mismatch"
        self.left = left
        self.right = right
        self.camera = camera
        self.gt_poses = gt_poses
        self.name = name
        # raw (distorted, unaligned) rigs carry host (u, v) remap maps
        # (rectifyImagesLR); None means the input is already rectified
        self.rect_maps = rect_maps
        self._pf = None

    def __len__(self) -> int:
        return len(self.left)

    def _prefetchers(self):
        if self._pf is None:
            ml, mr = self.rect_maps if self.rect_maps is not None \
                else (None, None)
            # the output shape comes from the maps, else from the first
            # image (a dataset need not match the camera config)
            shape = None if ml is not None else load_gray(self.left[0]).shape
            self._pf = (Prefetcher(self.left, shape, rect_map=ml),
                        Prefetcher(self.right, shape, rect_map=mr))
        return self._pf

    def frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        pf_l, pf_r = self._prefetchers()
        return pf_l.get(i), pf_r.get(i)

    def close(self) -> None:
        if self._pf is not None:
            for p in self._pf:
                p.close()
            self._pf = None

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(len(self)):
            yield self.frame(i)


def _sorted_images(d: str) -> List[str]:
    out: List[str] = []
    for ext in ("png", "jpg", "jpeg", "pgm", "ppm", "bmp"):
        out.extend(glob.glob(os.path.join(d, f"*.{ext}")))
    return sorted(out)


def open_dataset(path: str, camera: Optional[CameraConfig] = None,
                 start: int = 0, count: Optional[int] = None, step: int = 1
                 ) -> StereoDataset:
    """Detect the layout and build a StereoDataset (Dataset::Dataset,
    with the frame offset / count / step arguments)."""
    if os.path.isdir(os.path.join(path, "image_0")):
        l = _sorted_images(os.path.join(path, "image_0"))
        r = _sorted_images(os.path.join(path, "image_1"))
        name = "kitti:" + os.path.basename(os.path.normpath(path))
        gt = _load_kitti_poses(path)
    elif os.path.isdir(os.path.join(path, "mav0")):
        return _open_euroc(path, start, count, step)
    elif os.path.exists(os.path.join(path, "dataset_params.yaml")):
        p = yaml_lite.load(os.path.join(path, "dataset_params.yaml"))
        l = _sorted_images(os.path.join(path, p.get("images_subfolder_l",
                                                    "left")))
        r = _sorted_images(os.path.join(path, p.get("images_subfolder_r",
                                                    "right")))
        camera = camera or CameraConfig(
            width=int(p.get("cam_width", 1241)),
            height=int(p.get("cam_height", 376)),
            fx=float(p.get("cam_fx", 718.856)),
            fy=float(p.get("cam_fy", 718.856)),
            cx=float(p.get("cam_cx", 607.19)),
            cy=float(p.get("cam_cy", 185.22)),
            baseline=float(p.get("cam_bl", 0.537)))
        name = "params:" + os.path.basename(os.path.normpath(path))
        gt = None
    else:
        raise FileNotFoundError(f"no recognizable stereo dataset at {path}")
    end = None if count is None else start + count * step
    sl = slice(start, end, step)
    gt_sl = gt[sl] if gt is not None else None
    return StereoDataset(l[sl], r[sl], camera or CameraConfig(), gt_sl, name)


def _parse_euroc_sensor_yaml(path: str):
    """mav0/cam*/sensor.yaml -> (K 3x3, dist tuple, T_BS 4x4, (w, h))."""
    s = yaml_lite.load(path)
    fu, fv, cu, cv = s["intrinsics"]
    K = np.array([[fu, 0, cu], [0, fv, cv], [0, 0, 1.0]])
    d = tuple(float(x) for x in s.get("distortion_coefficients", []))
    T_BS = np.asarray(s["T_BS"]["data"], np.float64).reshape(4, 4)
    w, h = s["resolution"]
    return K, d, T_BS, (int(w), int(h))


def _quat_to_rot(qw, qx, qy, qz):
    q = np.array([qw, qx, qy, qz]) / np.linalg.norm([qw, qx, qy, qz])
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _open_euroc(path: str, start: int, count: Optional[int], step: int
                ) -> StereoDataset:
    """EuRoC ASL: a raw distorted, unaligned stereo rig, fully rectified
    (sensor.yaml intrinsics and extrinsics -> stereo_rectify; the remap
    runs in the prefetch workers), with the ground truth of
    state_groundtruth_estimate0 expressed in the rectified-left-camera
    frame so ATE compares like with like."""
    from plslam_tpu_torch.core.camera import _rot_sqrt, stereo_rectify
    mav = os.path.join(path, "mav0")
    l = _sorted_images(os.path.join(mav, "cam0", "data"))
    r = _sorted_images(os.path.join(mav, "cam1", "data"))
    name = "euroc:" + os.path.basename(os.path.normpath(path))

    rect_maps = None
    camera = None
    R1 = np.eye(3)
    T_BS0 = np.eye(4)
    y0 = os.path.join(mav, "cam0", "sensor.yaml")
    y1 = os.path.join(mav, "cam1", "sensor.yaml")
    if os.path.exists(y0) and os.path.exists(y1):
        K0, d0, T_BS0, (w, h) = _parse_euroc_sensor_yaml(y0)
        K1, d1, T_BS1, _ = _parse_euroc_sensor_yaml(y1)
        T_10 = np.linalg.inv(T_BS1) @ T_BS0          # x_c1 = T_10 x_c0
        map_l, map_r, camera = stereo_rectify(
            K0, d0, K1, d1, T_10[:3, :3], T_10[:3, 3], h, w)
        rect_maps = (map_l, map_r)
        # R1 (the left rectifying rotation) for the GT frame change
        Rh = _rot_sqrt(T_10[:3, :3])
        t_mid = Rh.T @ T_10[:3, 3]
        e1 = -t_mid / np.linalg.norm(t_mid)
        e2 = np.cross([0.0, 0.0, 1.0], e1)
        e2 = e2 / np.linalg.norm(e2)
        R1 = np.stack([e1, e2, np.cross(e1, e2)]) @ Rh

    # align the stereo lists by timestamp (file names are ns stamps)
    stamps_l = {os.path.splitext(os.path.basename(p))[0]: p for p in l}
    stamps_r = {os.path.splitext(os.path.basename(p))[0]: p for p in r}
    common = sorted(set(stamps_l) & set(stamps_r))
    l = [stamps_l[s] for s in common]
    r = [stamps_r[s] for s in common]

    gt = _load_euroc_gt(mav, common, T_BS0, R1)
    end = None if count is None else start + count * step
    sl = slice(start, end, step)
    gt_sl = gt[sl] if gt is not None else None
    return StereoDataset(l[sl], r[sl], camera or CameraConfig(), gt_sl,
                         name, rect_maps=rect_maps)


def _load_euroc_gt(mav: str, stamps: List[str], T_BS0: np.ndarray,
                   R1: np.ndarray) -> Optional[np.ndarray]:
    """state_groundtruth_estimate0/data.csv -> (N, 4, 4) rectified-left-
    camera poses at the image timestamps (nearest neighbour)."""
    csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if not os.path.exists(csv):
        return None
    rows = np.genfromtxt(csv, delimiter=",", skip_header=1)
    if rows.ndim != 2 or rows.shape[1] < 8:
        return None
    gt_ts = rows[:, 0]
    T_c0_rect = np.eye(4)
    T_c0_rect[:3, :3] = R1.T                      # x_c0 = R1^T x_rect
    out = []
    img_ts = np.array([float(s) for s in stamps])
    idx = np.searchsorted(gt_ts, img_ts)
    for k, i in enumerate(np.clip(idx, 1, len(gt_ts) - 1)):
        j = i if abs(gt_ts[i] - img_ts[k]) < abs(gt_ts[i - 1] - img_ts[k]) \
            else i - 1
        p = rows[j, 1:4]
        T_WB = np.eye(4)
        T_WB[:3, :3] = _quat_to_rot(*rows[j, 4:8])
        T_WB[:3, 3] = p
        out.append(T_WB @ T_BS0 @ T_c0_rect)
    return np.stack(out).astype(np.float32)


def _load_kitti_poses(path: str) -> Optional[np.ndarray]:
    """KITTI poses.txt (3x4 row-major per line) if present."""
    for cand in (os.path.join(path, "poses.txt"),
                 os.path.join(path, "..", "poses",
                              os.path.basename(os.path.normpath(path))
                              + ".txt")):
        if os.path.exists(cand):
            rows = np.loadtxt(cand).reshape(-1, 3, 4)
            poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
            poses[:, :3, :] = rows
            return poses
    return None


def synthetic_dataset(cfg: SlamConfig, n_frames: int = 50, seed: int = 0,
                      kind: str = "forward", n_points: int = 300,
                      n_lines: int = 60, step: float = 0.15,
                      noise: float = 0.005):
    """In-memory synthetic stereo dataset with exact GT poses."""
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io import synthetic as synth

    cam = StereoCamera.from_config(cfg.camera)
    seq = synth.make_sequence(cam, n_frames=n_frames, seed=seed, kind=kind,
                              n_points=n_points, n_lines=n_lines, step=step,
                              noise=noise)

    class _MemDataset(StereoDataset):
        def __init__(self):
            self.left = [str(i) for i in range(n_frames)]
            self.right = list(self.left)
            self.camera = cfg.camera
            self.gt_poses = seq.poses
            self.name = f"synthetic:{kind}"
            self.seq = seq

        def frame(self, i: int):
            return seq.images_l[i], seq.images_r[i]

    return _MemDataset()
