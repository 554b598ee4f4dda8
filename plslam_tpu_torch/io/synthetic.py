"""Synthetic stereo scene generator with exact ground truth.

The port's own numpy copy of ``plslam_tpu/io/synthetic.py``: the same
seeds give the same worlds, trajectories and images. It builds random
3D worlds of points and
line segments, camera trajectories, and renders stereo image pairs whose
feature geometry is known exactly. Every stage of the pipeline (detector,
matcher, pose solver, BA, loop closure) is validated against it.

Rendering is deliberately simple but feature-detector-friendly:
  * points  -> anti-aliased bright blobs with a unique high-contrast
               checkered texture patch around each (so descriptors are
               discriminative and FAST fires on them);
  * lines   -> anti-aliased bright segments over a dark background;
  * backdrop-> low-frequency Perlin-ish noise so detectors see realistic
               gradients without spurious strong corners.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np



class Degradation(NamedTuple):
    """Realistic-imagery degradation model (VERDICT round-1 item: the
    clean renderer over-states front-end robustness — EuRoC/KITTI-grade
    imagery has texture clutter, sensor noise, motion blur, vignetting
    and exposure steps; stvo-pl's adaptive FAST + LSD must survive them).

    All strengths are 0 = off. ``preset`` builds the standard levels the
    regression tests use.
    """
    texture: float = 0.0        # multi-octave backdrop texture amplitude
    noise: float = 0.005        # per-pixel Gaussian sigma (sensor noise)
    motion_blur: float = 0.0    # blur length in px along apparent motion
    vignette: float = 0.0       # radial gain falloff at the corners
    exposure_jitter: float = 0.0  # per-frame multiplicative gain sigma
    rolling_shutter: float = 0.0  # max horizontal row skew in px across
                                  # the frame (CMOS readout shear)
    specular: float = 0.0       # saturating view-dependent highlight
                                # blobs, DIFFERENT per eye (stereo
                                # outlier generator); value = intensity
    n_speculars: int = 4
    occluders: int = 0          # dynamic untextured blobs crossing the
                                # scene (pedestrians/vehicles analogue;
                                # temporally coherent across a sequence)
    lr_asym: float = 0.0        # photometric L/R asymmetry: right-eye
                                # gain and offset mismatch sigma
                                # (imperfect radiometric calibration)

    @staticmethod
    def preset(level: str) -> "Degradation":
        return {
            "clean": Degradation(),
            "moderate": Degradation(texture=0.10, noise=0.015,
                                    motion_blur=1.5, vignette=0.25,
                                    exposure_jitter=0.05,
                                    rolling_shutter=1.5, specular=0.35,
                                    occluders=2, lr_asym=0.04),
            "heavy": Degradation(texture=0.18, noise=0.03,
                                 motion_blur=3.0, vignette=0.4,
                                 exposure_jitter=0.12,
                                 rolling_shutter=3.0, specular=0.6,
                                 occluders=4, lr_asym=0.08),
        }[level]


class SyntheticWorld(NamedTuple):
    points: np.ndarray          # (P, 3) world-frame 3D points
    line_sp: np.ndarray         # (L, 3) segment start points
    line_ep: np.ndarray         # (L, 3) segment end points
    point_tex_seed: np.ndarray  # (P,) per-point texture seeds


class SyntheticSequence(NamedTuple):
    world: SyntheticWorld
    poses: np.ndarray           # (F, 4, 4) T_world_cam (camera-to-world)
    images_l: np.ndarray        # (F, H, W) float32 in [0,1]
    images_r: np.ndarray


def make_world(rng: np.random.Generator, n_points: int = 300, n_lines: int = 60,
               extent: float = 14.0, depth: Tuple[float, float] = (4.0, 30.0),
               layout: str = "frustum") -> SyntheticWorld:
    """layout='frustum': points ahead of the initial camera (forward
    trajectories). layout='ring': full 360-degree annulus around the
    origin (loop trajectories — the camera turns and must keep seeing
    structure in every direction)."""
    if layout == "ring":
        ang_p = rng.uniform(0, 2 * np.pi, n_points)
        rad_p = rng.uniform(depth[0], depth[1], n_points)
        pts = np.stack([
            rad_p * np.sin(ang_p),
            rng.uniform(-extent * 0.3, extent * 0.3, n_points),
            rad_p * np.cos(ang_p),
        ], axis=-1)
        ang_l = rng.uniform(0, 2 * np.pi, n_lines)
        rad_l = rng.uniform(depth[0], depth[1], n_lines)
        sp = np.stack([
            rad_l * np.sin(ang_l),
            rng.uniform(-extent * 0.3, extent * 0.3, n_lines),
            rad_l * np.cos(ang_l),
        ], axis=-1)
    else:
        pts = np.stack([
            rng.uniform(-extent, extent, n_points),
            rng.uniform(-extent * 0.4, extent * 0.4, n_points),
            rng.uniform(depth[0], depth[1], n_points),
        ], axis=-1)
        sp = np.stack([
            rng.uniform(-extent, extent, n_lines),
            rng.uniform(-extent * 0.4, extent * 0.4, n_lines),
            rng.uniform(depth[0], depth[1], n_lines),
        ], axis=-1)
    d = rng.normal(size=(n_lines, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    length = rng.uniform(1.0, 4.0, (n_lines, 1))
    ep = sp + d * length
    seeds = rng.integers(0, 2**31 - 1, n_points)
    return SyntheticWorld(pts.astype(np.float32), sp.astype(np.float32),
                          ep.astype(np.float32), seeds)


def _exp_se3_np(xi: np.ndarray) -> np.ndarray:
    """Pure-numpy SE(3) exponential (v, w ordering as core.lie): scene
    generation is host-side and never touches the device."""
    v, w = xi[:3].astype(np.float64), xi[3:].astype(np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-9:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th ** 2
        C = (1 - A) / th ** 2
        R = np.eye(3) + A * K + B * (K @ K)
        V = np.eye(3) + B * K + C * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T.astype(np.float32)


def make_trajectory(n_frames: int, kind: str = "forward", step: float = 0.15,
                    yaw_rate: float = 0.0, rng: Optional[np.random.Generator] = None
                    ) -> np.ndarray:
    """(F, 4, 4) camera-to-world poses. kinds: forward, arc, loop."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    T = np.eye(4, dtype=np.float32)
    if kind == "arc" and yaw_rate == 0.0:
        yaw_rate = np.radians(1.5)     # gentle constant turn
    if kind == "loop":
        # close the circle by ~85% of the frames so the tail OVERSHOOTS
        # into revisited territory — loop detection needs several
        # consecutive keyframes inside the revisit (temporal consistency
        # voting), which a circle that closes exactly at the last frame
        # never provides. Capped at ~10 deg/frame: an uncapped rate is
        # physically untrackable (features leave the f2f window).
        yaw_rate = min(2 * np.pi / max(0.85 * (n_frames - 1), 1.0),
                       np.radians(10.0))
    for i in range(n_frames):
        poses[i] = T
        jitter = np.zeros(6, np.float32)
        if rng is not None:
            jitter = np.concatenate([rng.normal(0, 0.004, 3),
                                     rng.normal(0, 0.0015, 3)]).astype(np.float32)
        xi = np.array([0, 0, step, 0, yaw_rate, 0], np.float32) + jitter
        T = (T @ _exp_se3_np(xi)).astype(np.float32)
    return poses


# -- rendering ----------------------------------------------------------------

def _project_np(P_cam: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    z = np.maximum(P_cam[..., 2], 1e-6)
    return np.stack([fx * P_cam[..., 0] / z + cx,
                     fy * P_cam[..., 1] / z + cy], axis=-1)


def _upsample(small: np.ndarray, H: int, W: int) -> np.ndarray:
    ys = np.linspace(0, small.shape[0] - 1.001, H)
    xs = np.linspace(0, small.shape[1] - 1.001, W)
    y0 = ys.astype(int); x0 = xs.astype(int)
    fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
    return (small[y0][:, x0] * (1 - fy) * (1 - fx)
            + small[y0][:, x0 + 1] * (1 - fy) * fx
            + small[y0 + 1][:, x0] * fy * (1 - fx)
            + small[y0 + 1][:, x0 + 1] * fy * fx)


def _background(rng: np.random.Generator, H: int, W: int,
                texture: float = 0.0) -> np.ndarray:
    """Low-frequency backdrop in [0.25, 0.45]; ``texture`` adds
    multi-octave value noise (16/8/4 px octaves) so detectors face
    realistic clutter gradients instead of a flat field."""
    small = rng.uniform(0, 1, (H // 16 + 2, W // 16 + 2)).astype(np.float32)
    img = 0.25 + 0.2 * _upsample(small, H, W)
    if texture > 0:
        amp = texture
        for cell in (16, 8, 4):
            s = rng.uniform(-1, 1, (H // cell + 2, W // cell + 2)
                            ).astype(np.float32)
            img = img + amp * _upsample(s, H, W)
            amp *= 0.55
    return img.astype(np.float32)


_PATCH = 10  # half-size of the texture patch stamped around each point


def _point_patches(seeds: np.ndarray) -> np.ndarray:
    """Deterministic high-contrast texture patch per point, (P, 2S+1, 2S+1)."""
    P = len(seeds)
    S = _PATCH
    out = np.empty((P, 2 * S + 1, 2 * S + 1), np.float32)
    for i, s in enumerate(seeds):
        r = np.random.default_rng(int(s))
        # blocky random texture: strong gradients, unique layout
        blocks = r.uniform(0, 1, (6, 6)) > 0.5
        tex = np.kron(blocks, np.ones((4, 4)))[: 2 * S + 1, : 2 * S + 1]
        out[i] = 0.15 + 0.75 * tex
    return out


def _motion_blur(img: np.ndarray, length: float, theta: float) -> np.ndarray:
    """Directional box blur of ``length`` px along angle theta."""
    n = int(np.ceil(length)) + 1
    if n <= 1 or length <= 0.5:
        return img
    acc = np.zeros_like(img)
    for s in np.linspace(-length / 2, length / 2, n):
        ix = int(round(s * np.cos(theta)))
        iy = int(round(s * np.sin(theta)))
        acc += np.roll(img, (iy, ix), axis=(0, 1))
    return acc / n


def _rolling_shutter(img: np.ndarray, skew_px: float) -> np.ndarray:
    """CMOS readout shear: row v shifts horizontally by
    skew_px * (v/H - 0.5), subpixel via a two-tap blend."""
    H, W = img.shape
    shifts = skew_px * (np.arange(H) / H - 0.5)
    i0 = np.floor(shifts).astype(int)
    frac = (shifts - i0)[:, None].astype(np.float32)
    out = np.empty_like(img)
    for v in range(H):          # per-row roll (cheap at these sizes)
        a = np.roll(img[v], i0[v])
        b = np.roll(img[v], i0[v] + 1)
        out[v] = a
        if frac[v, 0] > 0:
            out[v] = (1 - frac[v, 0]) * a + frac[v, 0] * b
    return out


def _add_speculars(img: np.ndarray, rng: np.random.Generator,
                   intensity: float, n: int) -> np.ndarray:
    """Saturating view-dependent highlight blobs (stereo outliers:
    callers draw DIFFERENT blobs per eye)."""
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(n):
        cx_ = rng.uniform(0.1 * W, 0.9 * W)
        cy_ = rng.uniform(0.1 * H, 0.9 * H)
        sig = rng.uniform(2.0, 9.0)
        r2 = (xs - cx_) ** 2 + (ys - cy_) ** 2
        img = img + intensity * np.exp(-r2 / (2 * sig * sig))
    return img


class _Occluder(NamedTuple):
    pos: np.ndarray             # (2,) px center
    vel: np.ndarray             # (2,) px/frame
    size: np.ndarray            # (2,) px half-axes
    shade: float


def _make_occluders(rng: np.random.Generator, n: int, H: int, W: int):
    return [_Occluder(
        pos=np.array([rng.uniform(-0.2 * W, 1.2 * W),
                      rng.uniform(0.25 * H, 0.9 * H)]),
        vel=np.array([rng.choice([-1, 1]) * rng.uniform(2.0, 9.0),
                      rng.uniform(-1.0, 1.0)]),
        size=np.array([rng.uniform(0.03, 0.09) * W,
                       rng.uniform(0.08, 0.25) * H]),
        shade=rng.uniform(0.15, 0.45)) for _ in range(n)]


def _draw_occluder(img: np.ndarray, o: "_Occluder", frame: int,
                   disp_px: float = 0.0) -> None:
    """Filled soft-edged ellipse at the occluder's frame-k position
    (``disp_px`` shifts it for the right eye — occluders are CLOSER
    than the scene, so their disparity is larger)."""
    H, W = img.shape
    cx_, cy_ = o.pos + frame * o.vel
    cx_ -= disp_px
    ax, ay = o.size
    xmin = int(max(cx_ - ax - 2, 0)); xmax = int(min(cx_ + ax + 2, W - 1))
    ymin = int(max(cy_ - ay - 2, 0)); ymax = int(min(cy_ + ay + 2, H - 1))
    if xmax <= xmin or ymax <= ymin:
        return
    ys, xs = np.mgrid[ymin:ymax + 1, xmin:xmax + 1].astype(np.float32)
    r = ((xs - cx_) / ax) ** 2 + ((ys - cy_) / ay) ** 2
    alpha = np.clip((1.0 - r) * 4.0, 0, 1)
    reg = img[ymin:ymax + 1, xmin:xmax + 1]
    img[ymin:ymax + 1, xmin:xmax + 1] = reg + alpha * (o.shade - reg)


def _vignette_gain(H: int, W: int, strength: float) -> np.ndarray:
    ys = (np.arange(H) - H / 2) / (H / 2)
    xs = (np.arange(W) - W / 2) / (W / 2)
    r2 = (ys[:, None] ** 2 + xs[None, :] ** 2) / 2.0
    return (1.0 - strength * r2).astype(np.float32)


def render_frame(world: SyntheticWorld, T_wc: np.ndarray, cam,
                 rng: np.random.Generator, noise: float = 0.01,
                 degrade: Optional[Degradation] = None,
                 occluders=None, frame_idx: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Render a stereo pair for camera-to-world pose T_wc. Returns (imL, imR)."""
    H, W = cam.height, cam.width
    fx, fy, cx, cy, b = (float(cam.fx), float(cam.fy), float(cam.cx),
                         float(cam.cy), float(cam.b))
    T_cw = np.linalg.inv(T_wc)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    d = degrade if degrade is not None else Degradation(noise=noise)

    # per-frame camera effects shared by both eyes (a stereo rig has one
    # shutter): blur direction, exposure gain, rolling-shutter skew;
    # the L/R photometric mismatch is per-frame too (auto-exposure on
    # imperfectly synced sensors)
    blur_theta = rng.uniform(-0.35, 0.35)
    gain = 1.0 + (rng.normal(0, d.exposure_jitter)
                  if d.exposure_jitter > 0 else 0.0)
    rs_skew = (rng.uniform(-d.rolling_shutter, d.rolling_shutter)
               if d.rolling_shutter > 0 else 0.0)
    asym_g = (rng.normal(0, d.lr_asym) if d.lr_asym > 0 else 0.0)
    asym_o = (rng.normal(0, 0.5 * d.lr_asym) if d.lr_asym > 0 else 0.0)
    vig = _vignette_gain(H, W, d.vignette) if d.vignette > 0 else None

    imgs = []
    for eye in range(2):
        off = np.array([0.0, 0.0, 0.0]) if eye == 0 else np.array([-b, 0.0, 0.0])
        img = _background(np.random.default_rng(12345), H, W,
                          texture=d.texture).copy()

        # lines first (points stamp over them)
        sp_c = world.line_sp @ R.T + t
        ep_c = world.line_ep @ R.T + t
        vis = (sp_c[:, 2] > 0.5) & (ep_c[:, 2] > 0.5)
        sp_px = _project_np(sp_c + off, fx, fy, cx, cy)
        ep_px = _project_np(ep_c + off, fx, fy, cx, cy)
        for i in np.nonzero(vis)[0]:
            _draw_segment(img, sp_px[i], ep_px[i], 0.95, width=1.6)

        # points: stamp texture patches
        P_c = world.points @ R.T + t
        visp = P_c[:, 2] > 0.5
        uv = _project_np(P_c + off, fx, fy, cx, cy)
        patches = _point_patches(world.point_tex_seed)
        S = _PATCH
        for i in np.nonzero(visp)[0]:
            u, v = uv[i]
            ui, vi = int(round(u)), int(round(v))
            if not (S <= ui < W - S and S <= vi < H - S):
                continue
            img[vi - S:vi + S + 1, ui - S:ui + S + 1] = patches[i]

        # dynamic occluders: temporally coherent blobs crossing the
        # scene (make_sequence owns their tracks); closer than the
        # scene, so the right eye sees them at a larger disparity
        if occluders:
            for o in occluders:
                _draw_occluder(img, o, frame_idx,
                               disp_px=(0.0 if eye == 0
                                        else 0.18 * fx * b / 4.0))
        # speculars are VIEW-DEPENDENT: each eye draws different blobs
        if d.specular > 0:
            img = _add_speculars(img, rng, d.specular, d.n_speculars)
        if d.motion_blur > 0:
            img = _motion_blur(img, d.motion_blur, blur_theta)
        if d.rolling_shutter > 0:
            img = _rolling_shutter(img, rs_skew)
        if vig is not None:
            img = img * vig
        eye_gain, eye_off = gain, 0.0
        if eye == 1 and d.lr_asym > 0:
            eye_gain = gain * (1.0 + asym_g)
            eye_off = asym_o
        img = img * eye_gain + eye_off
        if d.noise > 0:
            img = img + rng.normal(0, d.noise, img.shape).astype(np.float32)
        imgs.append(np.clip(img, 0, 1).astype(np.float32))
    return imgs[0], imgs[1]


def _draw_segment(img: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                  value: float, width: float = 1.5) -> None:
    """Anti-aliased segment rasterizer (bounding-box distance test)."""
    H, W = img.shape
    x0, y0 = p0; x1, y1 = p1
    # clip bounding box
    xmin = int(max(min(x0, x1) - width - 1, 0))
    xmax = int(min(max(x0, x1) + width + 1, W - 1))
    ymin = int(max(min(y0, y1) - width - 1, 0))
    ymax = int(min(max(y0, y1) + width + 1, H - 1))
    if xmax <= xmin or ymax <= ymin:
        return
    ys, xs = np.mgrid[ymin:ymax + 1, xmin:xmax + 1]
    dx, dy = x1 - x0, y1 - y0
    L2 = dx * dx + dy * dy
    if L2 < 1e-9:
        return
    s = ((xs - x0) * dx + (ys - y0) * dy) / L2
    s = np.clip(s, 0, 1)
    px = x0 + s * dx
    py = y0 + s * dy
    d = np.sqrt((xs - px) ** 2 + (ys - py) ** 2)
    alpha = np.clip(1.0 - (d - width * 0.5), 0, 1)
    reg = img[ymin:ymax + 1, xmin:xmax + 1]
    img[ymin:ymax + 1, xmin:xmax + 1] = reg + alpha * (value - reg)


def make_sequence(cam, n_frames: int = 12, seed: int = 0, kind: str = "forward",
                  n_points: int = 300, n_lines: int = 60, noise: float = 0.005,
                  step: float = 0.15, yaw_rate: float = 0.0,
                  degrade: Optional[Degradation] = None) -> SyntheticSequence:
    rng = np.random.default_rng(seed)
    world = make_world(rng, n_points=n_points, n_lines=n_lines,
                       layout="ring" if kind == "loop" else "frustum")
    poses = make_trajectory(n_frames, kind=kind, step=step, yaw_rate=yaw_rate,
                            rng=rng)
    occ = None
    if degrade is not None and degrade.occluders > 0:
        occ = _make_occluders(rng, degrade.occluders,
                              cam.height, cam.width)
    ims_l, ims_r = [], []
    for i in range(n_frames):
        il, ir = render_frame(world, poses[i], cam, rng, noise=noise,
                              degrade=degrade, occluders=occ, frame_idx=i)
        ims_l.append(il)
        ims_r.append(ir)
    return SyntheticSequence(world, poses, np.stack(ims_l), np.stack(ims_r))


def exact_stereo_features(world: SyntheticWorld, T_wc: np.ndarray, cam,
                          margin: float = 12.0):
    """Ground-truth stereo observations for a pose: the oracle used by
    matcher/solver tests that bypass the image front-end.

    Returns dict with uv_l, uv_r, disp, P_cam (camera-frame 3D), vis mask
    for points, and sp/ep pixel + 3D versions for lines.
    """
    fx, fy, cx, cy, b = (float(cam.fx), float(cam.fy), float(cam.cx),
                         float(cam.cy), float(cam.b))
    H, W = cam.height, cam.width
    T_cw = np.linalg.inv(T_wc)
    R, t = T_cw[:3, :3], T_cw[:3, 3]

    P_c = world.points @ R.T + t
    uv_l = _project_np(P_c, fx, fy, cx, cy)
    disp = fx * b / np.maximum(P_c[:, 2], 1e-6)
    uv_r = uv_l.copy()
    uv_r[:, 0] -= disp
    vis = ((P_c[:, 2] > 1.0)
           & (uv_l[:, 0] > margin) & (uv_l[:, 0] < W - margin)
           & (uv_l[:, 1] > margin) & (uv_l[:, 1] < H - margin)
           & (uv_r[:, 0] > margin) & (disp > 1.0))

    sp_c = world.line_sp @ R.T + t
    ep_c = world.line_ep @ R.T + t
    sp_px = _project_np(sp_c, fx, fy, cx, cy)
    ep_px = _project_np(ep_c, fx, fy, cx, cy)
    lvis = ((sp_c[:, 2] > 1.0) & (ep_c[:, 2] > 1.0)
            & (sp_px[:, 0] > margin) & (sp_px[:, 0] < W - margin)
            & (sp_px[:, 1] > margin) & (sp_px[:, 1] < H - margin)
            & (ep_px[:, 0] > margin) & (ep_px[:, 0] < W - margin)
            & (ep_px[:, 1] > margin) & (ep_px[:, 1] < H - margin))
    return dict(uv_l=uv_l, uv_r=uv_r, disp=disp, P_cam=P_c, vis=vis,
                line_sp_px=sp_px, line_ep_px=ep_px, line_sp_cam=sp_c,
                line_ep_cam=ep_c, line_vis=lvis)


def drift_circle_graph(F: int, n: int, extra: int, seed: int):
    """A pose graph the shape of a closure's essential graph: a circle of n
    keyframes (0.5 m steps) with drifted odometry edges, one exact loop
    edge (weight 2) and ``extra`` noisy chords, padded to F slots and 4F
    edge slots. Returns (PoseGraph field arrays, number of edges used)."""
    rng = np.random.default_rng(seed)
    noisy = lambda st, sr: _exp_se3_np(np.concatenate(
        [rng.normal(0, st, 3), rng.normal(0, sr, 3)]))
    step = _exp_se3_np(np.array([0.5, 0, 0, 0, 2 * np.pi / n, 0]))
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    poses, edges = [gt[0]], []
    for i in range(1, n):
        T = np.linalg.inv(gt[i - 1]) @ gt[i] @ noisy(0.01, 0.004)
        edges.append((i - 1, i, T, 1.0))
        poses.append(poses[-1] @ T)
    edges.append((n - 1, 0, np.linalg.inv(gt[n - 1]) @ gt[0], 2.0))
    for _ in range(extra):
        i, j = sorted(rng.choice(n, 2, replace=False))
        edges.append((i, j, np.linalg.inv(gt[i]) @ gt[j] @ noisy(0.02, 0.005),
                      1.0))
    E = 4 * F
    if len(edges) > E:
        raise ValueError(f"{len(edges)} edges do not fit {E} edge slots")
    d = dict(poses=np.tile(np.eye(4, dtype=np.float32), (F, 1, 1)),
             pose_valid=np.arange(F) < n, edge_i=np.zeros(E, np.int32),
             edge_j=np.zeros(E, np.int32),
             edge_T=np.tile(np.eye(4, dtype=np.float32), (E, 1, 1)),
             edge_w=np.zeros(E, np.float32))
    d["poses"][:n] = np.stack(poses)
    for k, (i, j, T, w) in enumerate(edges):
        d["edge_i"][k], d["edge_j"][k], d["edge_T"][k], d["edge_w"][k] = (
            i, j, T, w)
    return d, len(edges)
