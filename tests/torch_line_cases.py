"""Hand-built line-detector inputs shared by the port's line tests: the
CPU tests (tests/test_torch_lines.py) hold the plain path to the JAX
reference on them, the GPU tests (tests/test_torch_gpu.py) the kernels
to the plain path."""

import numpy as np
import torch

from plslam_tpu_torch.ops import lines


def line_field(seed, n=3, H=160, W=200, n_lines=8):
    """Noise plus bright straight strips: line-detector inputs."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, H, W)).astype(np.float32) * 0.06
    for k in range(n):
        for _ in range(n_lines):
            x0, y0 = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
            th, L = rng.uniform(0, np.pi), rng.uniform(40, 120)
            t = np.linspace(-L / 2, L / 2, int(3 * L))
            xs = np.clip(x0 + t * np.cos(th), 0, W - 1).astype(int)
            ys = np.clip(y0 + t * np.sin(th), 0, H - 1).astype(int)
            img[k, ys, xs] = 1.0
    return torch.from_numpy(img)


def stripe_field(seed, n=2, H=240, W=400, period=16, tilt=0.02):
    """Noise plus bright full-width stripes, one every ``period`` rows,
    slightly tilted: at 240x400 and tile 16 over 1,100 of the 1,421 tiles
    of an image are gated in and linked, in chains 49 tiles long."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, H, W)).astype(np.float32) * 0.06
    xs = np.arange(W)
    for k in range(n):
        for y0 in np.arange(4, H - 4, period) + rng.uniform(0, 3):
            ys = np.clip(np.round(y0 + tilt * (xs - W / 2)), 0,
                         H - 1).astype(int)
            img[k, ys, xs] = 1.5
    return torch.from_numpy(img)


G_REFIT_CASES = ("invalid_member", "no_root", "many_roots", "m40")
G_MERGE_CASES = ("chain", "vertical")
G_H, G_W = 160, 200


def kernel_g_stage(case):
    """(TileStage on the CPU, max_lines) of a refit case on line_field(5)'s
    three 160x200 images: "invalid_member", the last gated-out tile of each
    image carrying its heaviest root's label (a member for the projections
    only: its payload is masked); "no_root", every gate off; "many_roots",
    max_lines 1, so R = 8 root slots for the 9-10 roots an image; "m40",
    max_lines 20, M = 40 candidates (not a multiple of 32)."""
    ts = lines.tile_stage(line_field(5), tile=16)
    N, Th, Tw = ts.labels.shape
    n = Th * Tw
    if case == "invalid_member":
        lab = ts.labels.reshape(N, n).clone()
        ok = ts.tile_ok.reshape(N, n)
        S = ts.S.reshape(N, n)
        for b in range(N):
            roots = ok[b] & (lab[b] == torch.arange(n, dtype=torch.int32))
            r = int(torch.where(roots, S[b], -1.0).argmax())
            lab[b, int(torch.nonzero(~ok[b])[-1])] = r
        ts = ts._replace(labels=lab.reshape(N, Th, Tw))
    elif case == "no_root":
        ts = ts._replace(tile_ok=torch.zeros_like(ts.tile_ok),
                         labels=torch.full_like(ts.labels, n + 7))
    return ts, {"many_roots": 1, "m40": 20}.get(case, 48)


def kernel_g_merge_case(case):
    """(sp, ep, score, valid, iters) of a merge case, one image of M = 40
    slots, the segments in shuffled slots and the empty slots between them
    holding stray coordinates: "chain", 12 collinear 10 px fragments 15 px
    apart (only neighbours are compatible) merged in 2 sweeps, fewer than
    the chain's hops, beside a chain of 5 and a crossing segment;
    "vertical", 10 fragments of one vertical line tilted by +-0.005 rad
    (one exactly vertical), drawn up and down: angles on both sides of the
    +-pi/2 flip."""
    rng = np.random.default_rng(7)
    M = 40
    segs = []
    if case == "chain":
        for c0, a, k in (((20.0, 30.0), 0.3, 12), ((120.0, 60.0), -1.0, 5)):
            u = np.array([np.cos(a), np.sin(a)])
            for i in range(k):
                c = np.array(c0) + 15.0 * i * u
                segs.append((c - 5 * u, c + 5 * u))
        segs.append((np.array([60.0, 10.0]), np.array([70.0, 100.0])))
        iters = 2
    else:
        for i in range(10):
            tilt = 0.0 if i == 4 else 0.005 * (1 if i % 2 else -1)
            d = 5 * np.array([np.sin(tilt), np.cos(tilt)])
            c = np.array([100.0, 20.0 + 13.0 * i])
            segs.append((c - d, c + d) if i % 3 else (c + d, c - d))
        iters = 8
    sp = rng.uniform(0, 200, (1, M, 2))
    ep = sp + rng.uniform(-20, 20, (1, M, 2))
    score = np.zeros((1, M))
    for s, (a, b) in zip(rng.permutation(M), segs):
        sp[0, s], ep[0, s] = a, b
        score[0, s] = rng.uniform(5, 50)
    t = lambda x: torch.from_numpy(x.astype(np.float32))
    return t(sp), t(ep), t(score), t(score) > 0, iters
