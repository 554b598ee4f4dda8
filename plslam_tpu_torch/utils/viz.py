"""3D map and trajectory renders, 2D feature overlays.

Port of ``plslam_tpu/utils/viz.py`` (the reference's ``slamScene``: camera
frusta, trajectory, map points and line segments, loop links) as headless
matplotlib PNGs. matplotlib is imported inside ``_require_mpl``, at the
first render, and is not needed otherwise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _require_mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    """A host array of a tensor on any device, or of an array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def plot_scene(kf_poses: np.ndarray, pt_pos: Optional[np.ndarray] = None,
               ln_spos: Optional[np.ndarray] = None,
               ln_epos: Optional[np.ndarray] = None,
               gt_poses: Optional[np.ndarray] = None,
               loop_pairs=None, path: str = "scene.png",
               frustum_scale: float = 0.3, title: str = "plslam_tpu map"):
    """Render the SLAM scene to a PNG (slamScene screenshot parity)."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")

    traj = kf_poses[:, :3, 3]
    ax.plot(traj[:, 0], traj[:, 2], traj[:, 1], "b-", lw=1.5,
            label="keyframes")
    if gt_poses is not None:
        g = gt_poses[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], g[:, 1], "g--", lw=1.0, label="ground truth")
    # camera frusta (every few KFs)
    stride = max(len(kf_poses) // 20, 1)
    for T in kf_poses[::stride]:
        _draw_frustum(ax, T, frustum_scale)
    if pt_pos is not None and len(pt_pos):
        ax.scatter(pt_pos[:, 0], pt_pos[:, 2], pt_pos[:, 1], s=1.0,
                   c="k", alpha=0.4, label="map points")
    if ln_spos is not None and len(ln_spos):
        for s, e in zip(ln_spos, ln_epos):
            ax.plot([s[0], e[0]], [s[2], e[2]], [s[1], e[1]], "r-",
                    lw=0.7, alpha=0.6)
    if loop_pairs:
        for (i, j) in loop_pairs:
            a, b = traj[i], traj[j]
            ax.plot([a[0], b[0]], [a[2], b[2]], [a[1], b[1]], "m-", lw=2.0)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("y [m]")
    ax.set_title(title)
    ax.legend(loc="upper left", fontsize=8)
    try:  # equal aspect when supported
        ax.set_box_aspect((1, 1, 0.5))
    except Exception:
        pass
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def _draw_frustum(ax, T: np.ndarray, s: float):
    """Wireframe camera frustum at pose T (camera-to-world)."""
    pts_c = np.array([[0, 0, 0], [-s, -0.6 * s, s], [s, -0.6 * s, s],
                      [s, 0.6 * s, s], [-s, 0.6 * s, s]])
    pts_w = pts_c @ T[:3, :3].T + T[:3, 3]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for a, b in edges:
        ax.plot([pts_w[a, 0], pts_w[b, 0]], [pts_w[a, 2], pts_w[b, 2]],
                [pts_w[a, 1], pts_w[b, 1]], "c-", lw=0.5)


def plot_map_handler(map_handler, path: str = "scene.png",
                     gt_poses: Optional[np.ndarray] = None,
                     loop_closer=None):
    """Render from a map holder's state (``FusedPLSLAM``: ``_lock``,
    ``state``), its tensors on any device."""
    with map_handler._lock:
        st = map_handler.state
        n = int(st.n_kfs)
        kf = _np(st.kf_pose[:n])
        pv, lv = _np(st.pt_valid), _np(st.ln_valid)
        pts = _np(st.pt_pos)[pv]
        lsp = _np(st.ln_spos)[lv]
        lep = _np(st.ln_epos)[lv]
    pairs = None
    if loop_closer is not None:
        pairs = [(e.kf_from, e.kf_to) for e in loop_closer.events]
    return plot_scene(kf, pts, lsp, lep, gt_poses=gt_poses,
                      loop_pairs=pairs, path=path)


def draw_features(img: np.ndarray, pts=None, lns=None) -> np.ndarray:
    """2D overlay (H, W, 3): detected points (green) and lines (red) —
    the per-frame debug view of the reference's tracking window."""
    out = np.stack([img, img, img], axis=-1).astype(np.float32)
    if pts is not None:
        uv = _np(pts.uv)
        valid = _np(pts.valid)
        for (u, v) in uv[valid]:
            ui, vi = int(round(u)), int(round(v))
            if 2 <= ui < img.shape[1] - 2 and 2 <= vi < img.shape[0] - 2:
                out[vi - 2:vi + 3, ui - 2:ui + 3, 1] = 1.0
                out[vi - 1:vi + 2, ui - 1:ui + 2, 0] = 0.0
    if lns is not None:
        sp = _np(lns.sp)
        ep = _np(lns.ep)
        valid = _np(lns.valid)
        for s, e in zip(sp[valid], ep[valid]):
            n = int(max(abs(e[0] - s[0]), abs(e[1] - s[1]))) + 1
            for t in np.linspace(0, 1, n):
                u = int(round(s[0] + t * (e[0] - s[0])))
                v = int(round(s[1] + t * (e[1] - s[1])))
                if 0 <= u < img.shape[1] and 0 <= v < img.shape[0]:
                    out[v, u] = (1.0, 0.1, 0.1)
    return np.clip(out, 0, 1)
