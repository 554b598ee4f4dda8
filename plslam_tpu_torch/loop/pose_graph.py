"""SE(3) pose-graph optimisation (the g2o replacement), kernel M (K18).

Port of ``plslam_tpu/loop/pose_graph.py``: after a verified loop, the
essential graph (odometry, covisibility and loop edges) is optimised over
the KF poses by Gauss-Newton. Per edge the residual is
r = log(Tm^-1 Ti^-1 Tj) with the right-perturbation Jacobians
Ji = -Ad(Tm^-1), Jj = I; each iteration solves the normal equations with
pins on invalid slots (1e6), on slots cut off from the gauge component
(1e8, ``frozen_mask``) and on the first valid slot (1e8), updates
T <- T exp(dx) and accepts only a finite cost that did not rise.

Two linear solvers: dense, the (6F)^2 system through the library's LU
(the reference calls ``jnp.linalg.solve``), and PCG, a matrix-free
block-Jacobi-preconditioned CG with a fixed schedule. On CUDA tensors
every step but the library's LU and batched 6 x 6 inverse is a launch of
``csrc/pose_graph.cu`` (``pg_edges`` and ``pg_update`` over
``edge_layout``'s CTAs, ``pg_assemble``, ``pg_blocks``, ``pg_pcg`` on a
thread-block cluster); the plain versions (the reference's arithmetic in
torch) run only for CPU tensors. Ji, w and the pins depend only on the
edges and the gauge, so H (dense) and its diagonal blocks (PCG) are the
same at every GN step: a solve evaluates its edges once (``edges``: r, Ji,
the first cost), builds H and the first gradient once (``assemble``; PCG
``blocks``), factors H once (LU; PCG inverts the blocks once), and each GN
step's ``update`` hands on the residuals at the poses it returns and the
gradient there (``gradient_plain``'s arithmetic): a dense solve launches
1 + 1 + 12 hand kernels at 12 iterations, PCG 1 + 1 + 2 x 12.
Fixed capacity: F pose slots, E edge slots, masked by ``edge_w > 0``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from plslam_tpu_torch import native
from plslam_tpu_torch.core import lie


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (F, 4, 4) T_w_kf
    pose_valid: torch.Tensor   # (F,) bool
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,)
    edge_T: torch.Tensor       # (E, 4, 4) measured T_i^-1 T_j
    edge_w: torch.Tensor       # (E,) weight (0 = unused slot)


def frozen_mask(g: PoseGraph) -> np.ndarray:
    """(F,) bool — valid poses NOT connected (through used edges) to the
    first valid pose: both solvers pin them at their current estimates.
    Host union-find, copied from the reference."""
    valid = g.pose_valid.cpu().numpy()
    F = valid.shape[0]
    parent = np.arange(F)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    w = g.edge_w.cpu().numpy()
    ei = g.edge_i.cpu().numpy()
    ej = g.edge_j.cpu().numpy()
    for i, j in zip(ei[w > 0], ej[w > 0]):
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
    if not valid.any():
        return ~valid
    root = find(int(np.argmax(valid)))
    reach = np.fromiter((find(s) == root for s in range(F)), bool, F)
    return valid & ~reach


def _diag(g: PoseGraph, freeze: torch.Tensor, fix_first: bool
          ) -> torch.Tensor:
    """(F,) diagonal added to H: the pins plus 1e-5 + 1e-6 (in the poses'
    float type)."""
    dt = g.poses.dtype
    pin = ((~g.pose_valid).to(dt) * 1e6 + freeze.to(dt) * 1e8)
    if fix_first:
        first = torch.argmax(g.pose_valid.to(torch.uint8))
        pin = pin.index_add(0, first.reshape(1),
                            torch.full((1,), 1e8, dtype=dt,
                                       device=pin.device))
    return (pin + 1e-5) + 1e-6


def _args(g: PoseGraph):
    """The graph as the kernels take it (contiguous, checked)."""
    F, E = g.poses.shape[0], g.edge_w.shape[0]
    out = (g.poses.to(torch.float32).contiguous(),
           g.edge_i.to(torch.int32).contiguous(),
           g.edge_j.to(torch.int32).contiguous(),
           g.edge_T.to(torch.float32).contiguous(),
           g.edge_w.to(torch.float32).contiguous())
    for name, t, dt, shape in zip(
            ("poses", "edge_i", "edge_j", "edge_T", "edge_w"), out,
            (torch.float32, torch.int32, torch.int32, torch.float32,
             torch.float32),
            ((F, 4, 4), (E,), (E,), (E, 4, 4), (E,))):
        native.require(t, f"pose graph {name}", dt, shape)
    return out


def _incidence(g: PoseGraph):
    """Edges leaving / entering each slot, each list in edge order (a
    stable sort by endpoint): (edge ids, (F + 1,) offsets) twice; unused
    edges are in no list."""
    F = g.poses.shape[0]
    used = g.edge_w > 0
    out = []
    for end in (g.edge_i, g.edge_j):
        key = torch.where(used, end.long(), F)
        order = torch.sort(key, stable=True).indices.to(torch.int32)
        ptr = torch.zeros((F + 1,), dtype=torch.int64, device=key.device)
        ptr[1:] = torch.cumsum(torch.bincount(key, minlength=F + 1)[:F], 0)
        out += [order.contiguous(), ptr.to(torch.int32).contiguous()]
    return tuple(out)


# -- edges: residuals, Jacobians, cost ---------------------------------------

def _jac(g: PoseGraph) -> torch.Tensor:
    return -lie.adjoint_se3(lie.inverse_se3(g.edge_T))


def edge_residuals_plain(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    Ti = poses[g.edge_i.long()]
    Tj = poses[g.edge_j.long()]
    r = lie.log_se3(lie.inverse_se3(g.edge_T) @ lie.inverse_se3(Ti) @ Tj)
    return torch.where((g.edge_w > 0)[:, None], r, 0.0)


def _cost_of(r: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    return torch.sum(g.edge_w * torch.sum(r * r, dim=-1))


def edges_plain(g: PoseGraph, jac: bool = True):
    """(r (E, 6), Ji (E, 6, 6) or None, cost ()) at ``g.poses``."""
    r = edge_residuals_plain(g.poses, g)
    return r, _jac(g) if jac else None, _cost_of(r, g)


# pg_edges' and pg_update's plan (csrc/pose_graph.cu::edge_ctas)
EDGE_SLOTS = 32     # edge slots a CTA, a lane of its first warp each
EDGE_NT = 256       # threads a CTA


def edge_layout(E: int) -> Tuple[int, int]:
    """(CTAs, threads a CTA) of a ``pg_edges`` or ``pg_update`` launch over
    E edge slots: ``EDGE_SLOTS`` slots a CTA. The C entries compute the
    same plan and refuse any other."""
    return max(1, -(-E // EDGE_SLOTS)), EDGE_NT


def edge_partition(F: int, E: int):
    """Per CTA of ``edge_layout(E)``, as the kernels compute them: the edge
    slots it evaluates (e0, e1) and the pose slots whose trial poses
    ``pg_update`` writes from it (n0, n1)."""
    ctas = edge_layout(E)[0]
    nc = -(-F // ctas)
    return [((b * EDGE_SLOTS, min((b + 1) * EDGE_SLOTS, E)),
             (min(b * nc, F), min((b + 1) * nc, F))) for b in range(ctas)]


# per device: the CTAs' cost partials, the last-CTA (or grid barrier)
# counter, which every launch leaves at 0 (launches on one stream; a CUDA
# graph may capture them), and pg_update's (E, 6) products Ji^T r
_SWEEP = {}


def _sweep_scratch(device, ctas: int, E: int = 0):
    buf = _SWEEP.get(device)
    if buf is None or buf[0].numel() < ctas or buf[2].numel() < 6 * E:
        buf = (torch.empty((max(ctas, 64),), dtype=torch.float32,
                           device=device),
               torch.zeros((1,), dtype=torch.int32, device=device),
               torch.empty((6 * max(E, 2048),), dtype=torch.float32,
                           device=device))
        _SWEEP[device] = buf
    return buf


def edges(g: PoseGraph, jac: bool = True):
    """Residuals (0 on unused edges), the Jacobians Ji (None when ``jac``
    is false) and the cost at ``g.poses``: one ``pg_edges`` launch on
    CUDA, ``edge_layout(E)`` CTAs."""
    if g.poses.device.type == "cpu":
        return edges_plain(g, jac)
    a = _args(g)
    F, E = a[0].shape[0], a[4].shape[0]
    dev = a[0].device
    r = torch.empty((E, 6), dtype=torch.float32, device=dev)
    J = (torch.empty((E, 6, 6), dtype=torch.float32, device=dev) if jac
         else None)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    ctas, threads = edge_layout(E)
    native.launch("pg_edges", *a, r, J, cost, *_sweep_scratch(dev, ctas)[:2],
                  F, E, ctas, threads)
    return r, J, cost


def edge_residuals(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """(E, 6) residuals log(Tm^-1 Ti^-1 Tj), zeroed for unused slots."""
    return edges(g._replace(poses=poses), jac=False)[0]


# -- dense normal equations ---------------------------------------------------

GRAD_MODES = {"dense": 1, "pcg": 2}     # csrc/pose_graph.cu GRAD_DENSE, _PCG


def gradient_plain(g: PoseGraph, r, Ji, mode: str):
    """The gradient sum_e w (Ji^T r_e at the tail, r_e at the head) at the
    residuals r, in ``mode``'s order: "dense" the reference's dense
    scatter-adds ((6F,), ``assemble_plain``'s g), "pcg" its incidence
    matmuls ((F, 6), ``blocks_plain``'s g)."""
    F = g.poses.shape[0]
    w = g.edge_w
    gi = torch.einsum("e,eap,ea->ep", w, Ji, r)
    if mode == "dense":
        gvec = torch.zeros((F, 6), dtype=w.dtype, device=w.device)
        gvec.index_add_(0, g.edge_i.long(), gi)
        gvec.index_add_(0, g.edge_j.long(), w[:, None] * r)
        return gvec.reshape(-1)
    Pi, Pj = _incidence_onehot(g)
    return Pi.T @ gi + Pj.T @ (w[:, None] * r)


def assemble_plain(g: PoseGraph, r, Ji, diag):
    """(H (6F, 6F), g (6F,)): the reference's scatter-adds in its order."""
    F = g.poses.shape[0]
    ei, ej, w = g.edge_i.long(), g.edge_j.long(), g.edge_w
    eye = torch.eye(6, dtype=w.dtype, device=w.device)
    H = torch.zeros((F, F, 6, 6), dtype=w.dtype, device=w.device)
    H.index_put_((ei, ei), torch.einsum("e,eap,eaq->epq", w, Ji, Ji),
                 accumulate=True)
    H.index_put_((ej, ej), w[:, None, None] * eye, accumulate=True)
    Hij = torch.einsum("e,eap->epa", w, Ji)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
    idx = torch.arange(F, device=w.device)
    H[idx, idx] += diag[:, None, None] * eye
    return (H.permute(0, 2, 1, 3).reshape(6 * F, 6 * F),
            gradient_plain(g, r, Ji, "dense"))


def assemble(g: PoseGraph, r, Ji, diag, inc=None):
    """The dense system and the gradient, one ``pg_assemble`` launch (a
    block per slot: the blocks its rows touch summed in shared memory, the
    rest of its band streamed out as zeros); a solve launches it once."""
    if g.poses.device.type == "cpu":
        return assemble_plain(g, r, Ji, diag)
    a = _args(g)
    F, E = a[0].shape[0], a[4].shape[0]
    inc = _incidence(g) if inc is None else inc
    H = torch.empty((6 * F, 6 * F), dtype=torch.float32, device=r.device)
    gvec = torch.empty((6 * F,), dtype=torch.float32, device=r.device)
    native.launch("pg_assemble", *a, *inc, r.contiguous(), Ji.contiguous(),
                  diag.to(torch.float32).contiguous(), H, gvec, F, E)
    return H, gvec


# -- PCG ----------------------------------------------------------------------

def _incidence_onehot(g: PoseGraph):
    """The reference's (E, F) one-hot incidence operators, zero on unused
    edges (the plain versions' form)."""
    F = g.poses.shape[0]
    used = (g.edge_w > 0).to(g.edge_w.dtype)
    one = lambda end: torch.nn.functional.one_hot(end.long(), F).to(
        g.edge_w.dtype) * used[:, None]
    return one(g.edge_i), one(g.edge_j)


def blocks_plain(g: PoseGraph, r, Ji, diag):
    """(gradient (F, 6), exact diagonal blocks of H (F, 6, 6))."""
    w = g.edge_w
    Pi, Pj = _incidence_onehot(g)
    gvec = gradient_plain(g, r, Ji, "pcg")
    eye = torch.eye(6, dtype=w.dtype, device=w.device)
    Hii = torch.einsum("e,eap,eaq->epq", w, Ji, Ji)
    Hd = (torch.einsum("ef,epq->fpq", Pi, Hii)
          + (Pj.T @ w)[:, None, None] * eye + diag[:, None, None] * eye)
    return gvec, Hd


def blocks(g: PoseGraph, r, Ji, diag, inc):
    """(gradient, diagonal blocks of H), one ``pg_blocks`` launch (a block
    per slot); a solve launches it once."""
    if g.poses.device.type == "cpu":
        return blocks_plain(g, r, Ji, diag)
    a = _args(g)
    F, E = a[0].shape[0], a[4].shape[0]
    Hd = torch.empty((F, 6, 6), dtype=torch.float32, device=r.device)
    gvec = torch.empty((F, 6), dtype=torch.float32, device=r.device)
    native.launch("pg_blocks", *a, *inc, r.contiguous(), Ji.contiguous(),
                  diag.to(torch.float32).contiguous(), Hd, gvec, F, E)
    return gvec, Hd


def pcg_plain(g: PoseGraph, Ji, Minv, diag, gvec, cg_iters: int):
    w = g.edge_w
    Pi, Pj = _incidence_onehot(g)

    def applyH(x):
        t = torch.einsum("eap,ep->ea", Ji, Pi @ x) + Pj @ x
        yi = torch.einsum("e,eap,ea->ep", w, Ji, t)
        return Pi.T @ yi + Pj.T @ (w[:, None] * t) + diag[:, None] * x

    prec = lambda v: torch.einsum("fpq,fq->fp", Minv, v)
    b = -gvec
    b2 = torch.sum(b * b)
    x = torch.zeros_like(b)
    rr = b
    z = prec(rr)
    p = z
    rz = torch.sum(rr * z)
    for _ in range(cg_iters):
        Hp = applyH(p)
        pHp = torch.sum(p * Hp)
        ok = (pHp > 1e-12) & (rz > 1e-12 * b2 + 1e-30)
        alpha = torch.where(ok, rz / torch.clamp(pHp, min=1e-30), 0.0)
        x = x + alpha * p
        rr = rr - alpha * Hp
        z = prec(rr)
        rz_new = torch.sum(rr * z)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


# pg_pcg's cluster (csrc/pose_graph.cu::pcg_cluster, pcg_words)
PCG_MAX_CLUSTER = 16
PCG_MAX_NODES = 128           # nodes a CTA
PCG_SMEM_MAX = 232448         # dynamic shared memory a CTA (sm_90)


def pcg_layout(F: int, E: int):
    """(cluster size C, threads a CTA, shared bytes a CTA) of the
    ``pg_pcg`` launch for F slots and E edge slots: the smallest power of
    two C <= 16 whose CTAs each hold ceil(E / C) edges' Ji rows, products
    and ends, ceil(F / C) nodes' Minv blocks and vectors, z and two p
    buffers of all F nodes, the addresses of its nodes' list entries (up
    to 2E) and pass B's lane slots, with at most 128 nodes a CTA; a thread
    an edge slot of a CTA; None where no cluster holds the graph. The
    kernel's own arithmetic."""
    C = 1
    while C <= PCG_MAX_CLUSTER:
        EC, NC = -(-E // C), -(-F // C)
        slots = NC + E + 32
        words = (EC * (36 + 12 + 3) + NC * (36 + 2 * 6 + 1 + 2) + 2
                 + 18 * F + 2 * E + slots + 96)
        if words * 4 <= PCG_SMEM_MAX and (NC <= PCG_MAX_NODES
                                          or C == PCG_MAX_CLUSTER):
            return C, min(1024, max(64, -(-EC // 32) * 32)), words * 4
        C *= 2
    return None


def pcg_partition(inc, F: int, C: int):
    """What each CTA of ``pg_pcg``'s cluster owns, computed from the
    incidence lists as the kernel computes it: per rank a dict of its nodes
    (a range of NC = ceil(F / C)), its used edges (positions [c CE, (c + 1)
    CE) of the leaving lists, CE = ceil(U / C): edge ids in that order),
    the address (rank, local edge) of each leaving-list position of its
    nodes and of each edge entering them (in the entering lists' order;
    found by a binary search of the edge in its tail's leaving list)."""
    oi, pi, oj, pj = (np.asarray(x.cpu()) for x in inc)
    U = int(pi[F])
    NC, CE = -(-F // C), max(-(-U // C), 1)
    ref = lambda s: (s // CE, s - (s // CE) * CE)
    tail = {int(e): n for n in range(F) for e in oi[pi[n]:pi[n + 1]]}
    out = []
    for c in range(C):
        n0, n1 = min(c * NC, F), min((c + 1) * NC, F)
        s0, s1 = min(c * CE, U), min((c + 1) * CE, U)
        leaving, entering = [], []
        for n in range(n0, n1):
            leaving.append([ref(s) for s in range(pi[n], pi[n + 1])])
            row = []
            for e in oj[pj[n]:pj[n + 1]]:
                i = tail[int(e)]
                s = int(pi[i] + np.searchsorted(oi[pi[i]:pi[i + 1]], e))
                row.append(ref(s))
            entering.append(row)
        out.append(dict(nodes=(n0, n1), edges=oi[s0:s1].tolist(),
                        leaving=leaving, entering=entering))
    return out


def pcg(g: PoseGraph, Ji, Minv, diag, gvec, cg_iters: int, inc=None):
    """``cg_iters`` block-Jacobi PCG steps on H dx = -g from 0: one
    ``pg_pcg`` launch, a thread-block cluster of ``pcg_layout(F, E)[0]``
    CTAs with the Jacobians and vectors in their shared memory."""
    if g.poses.device.type == "cpu":
        return pcg_plain(g, Ji, Minv, diag, gvec, cg_iters)
    a = _args(g)
    F, E = a[0].shape[0], a[4].shape[0]
    if pcg_layout(F, E) is None:
        raise ValueError(f"pg_pcg: F={F}, E={E} exceed the shared memory of "
                         f"a cluster of {PCG_MAX_CLUSTER} CTAs")
    inc = _incidence(g) if inc is None else inc
    dx = torch.empty((F, 6), dtype=torch.float32, device=Ji.device)
    native.launch("pg_pcg", *a, *inc, Ji.contiguous(),
                  Minv.to(torch.float32).contiguous(),
                  diag.to(torch.float32).contiguous(), gvec.contiguous(), dx,
                  F, E, int(cg_iters))
    return dx


# -- the GN update with its accept test --------------------------------------

def update_plain(g: PoseGraph, c, step, scale: float, r=None, grad=None):
    """``update``'s plain version; ``grad`` as there (its mode and Ji
    used): the gradient at the residuals handed on, returned fourth."""
    dx = torch.where(g.pose_valid[:, None], scale * step, 0.0)
    new = g.poses @ lie.exp_se3(dx)
    r_new = edge_residuals_plain(new, g)
    c_new = _cost_of(r_new, g)
    ok = torch.isfinite(c_new) & (c_new <= c)
    if r is None:
        r = edge_residuals_plain(g.poses, g)
    out = (torch.where(ok, new, g.poses), torch.where(ok, c_new, c),
           torch.where(ok, r_new, r))
    return out if grad is None else (
        *out, gradient_plain(g, out[2], grad[1], grad[0]))


def update(g: PoseGraph, c, step, scale: float, r=None, r_out=None,
           grad=None):
    """T <- T exp(scale * step) on valid slots, kept only if the cost is
    finite and did not rise: (poses, cost, residuals at those poses); one
    ``pg_update`` launch. ``r``: the residuals at ``g.poses``, handed back
    on a reject (None: one ``pg_edges`` launch without Ji computes them);
    ``r_out``: the buffer the residuals go to (a solve alternates two).
    ``grad``: None, or (mode, Ji, g_in, g_out, inc): the same launch also
    computes the gradient at the residuals it hands on, in ``mode``'s order
    (``gradient_plain``), into ``g_out`` (``g_in``, the gradient at ``r``,
    is handed on after a reject), returned fourth."""
    if g.poses.device.type == "cpu":
        return update_plain(g, c, step, scale, r, grad)
    a = _args(g)
    F, E = a[0].shape[0], a[4].shape[0]
    dev = a[0].device
    if r is None:
        r = edges(g, jac=False)[0]
    r = r.contiguous()
    r_out = torch.empty_like(r) if r_out is None else r_out
    for name, t in (("residuals", r), ("residual buffer", r_out)):
        native.require(t, f"pose graph {name}", torch.float32, (E, 6))
    if r_out.data_ptr() == r.data_ptr():
        raise ValueError("pg_update: r_out must not be r")
    st = step.reshape(F, 6).to(torch.float32).contiguous()
    va = g.pose_valid.to(torch.bool).contiguous().view(torch.uint8)
    c_in = c.to(torch.float32).reshape(()).contiguous()
    poses = torch.empty_like(a[0])
    c_out = torch.empty((), dtype=torch.float32, device=dev)
    ctas, threads = edge_layout(E)
    partial, count, u = _sweep_scratch(dev, ctas, E)
    mode, gargs = 0, [None] * 8
    if grad is not None:
        name, Ji, g_in, g_out, inc = grad
        mode = GRAD_MODES[name]
        for what, t in (("gradient", g_in), ("gradient buffer", g_out)):
            native.require(t, f"pose graph {what}", torch.float32)
            if t.numel() != 6 * F or not t.is_contiguous():
                raise ValueError(f"pg_update: the {what} must be "
                                 f"{6 * F} contiguous floats")
        if g_out.data_ptr() == g_in.data_ptr():
            raise ValueError("pg_update: g_out must not be g_in")
        native.require(Ji, "pose graph Ji", torch.float32, (E, 6, 6))
        inc = _incidence(g) if inc is None else inc
        gargs = [*inc, Ji.contiguous(), g_in, g_out, u]
    native.launch("pg_update", *a, c_in, st, va, r, poses, r_out, c_out,
                  partial, count, *gargs, F, E, ctas, threads, mode,
                  float(scale))
    return (poses, c_out, r_out) if grad is None else (poses, c_out, r_out,
                                                       g_out)


# -- the solvers --------------------------------------------------------------

def lu_factor(H):
    """H's LU with partial pivoting, once a solve: (LU, pivots), the factors
    ``torch.linalg.solve_ex`` computes inside."""
    LU, piv, _ = torch.linalg.lu_factor_ex(H)
    return LU, piv


def lu_step(lu, gvec):
    """The solve of H x = gvec from ``lu_factor``'s factors: the bits of
    ``torch.linalg.solve_ex(H, gvec[:, None])[0][:, 0]``."""
    return torch.linalg.lu_solve(lu[0], lu[1], gvec[:, None])[:, 0]


def _gauss_newton(g: PoseGraph, iters: int, first, step, scale: float,
                  mode: str):
    """One ``edges`` (r, Ji, cost0); ``first(g, r, Ji, inc)``: what the solve
    keeps (dense H's LU, PCG the inverted diagonal blocks) and the first
    gradient; per iteration the step ``step(g, Ji, kept, gvec, inc)`` and
    ``update``, which hands on the residuals and the gradient there
    (``mode``'s order; none after the last step); two buffers of each
    alternate."""
    r, Ji, c0 = edges(g)
    inc = _incidence(g) if g.poses.device.type == "cuda" else None
    kept, gvec = first(g, r, Ji, inc)
    c, spare_r, spare_g = c0, torch.empty_like(r), torch.empty_like(gvec)
    for k in range(iters):
        grad = (mode, Ji, gvec, spare_g, inc) if k + 1 < iters else None
        out = update(g, c, step(g, Ji, kept, gvec, inc), scale, r, spare_r,
                     grad)
        poses, c, r_next = out[:3]
        spare_r, r = r, r_next
        if grad is not None:
            spare_g, gvec = gvec, out[3]
        g = g._replace(poses=poses)
    return g.poses, c0, c


def optimize_pose_graph(g: PoseGraph, iters: int = 12, fix_first: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (optimized poses (F,4,4), cost0, cost1). Poses outside the
    gauge-connected component are frozen (see frozen_mask)."""
    freeze = torch.from_numpy(frozen_mask(g)).to(g.poses.device)
    return _optimize_dense(g, freeze, iters, fix_first)


def _optimize_dense(g: PoseGraph, freeze: torch.Tensor, iters: int = 12,
                    fix_first: bool = True):
    diag = _diag(g, freeze, fix_first)
    F = g.poses.shape[0]

    def first(g, r, Ji, inc):
        H, gvec = assemble(g, r, Ji, diag, inc)
        return lu_factor(H), gvec

    def step(g, Ji, lu, gvec, inc):
        return lu_step(lu, gvec).reshape(F, 6)
    return _gauss_newton(g, iters, first, step, -1.0, "dense")


def optimize_pose_graph_pcg(g: PoseGraph, iters: int = 12,
                            cg_iters: int = 96, fix_first: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """PCG variant of optimize_pose_graph (see _optimize_pcg)."""
    freeze = torch.from_numpy(frozen_mask(g)).to(g.poses.device)
    return _optimize_pcg(g, freeze, iters, cg_iters, fix_first)


def _optimize_pcg(g: PoseGraph, freeze: torch.Tensor, iters: int = 12,
                  cg_iters: int = 96, fix_first: bool = True):
    """Gauss-Newton with a matrix-free block-Jacobi-preconditioned CG
    linear solve (fixed ``cg_iters`` schedule): the sparse solver for
    graphs past the dense (6F)^2 wall. Same contract as the dense one."""
    diag = _diag(g, freeze, fix_first)

    def first(g, r, Ji, inc):
        gvec, Hd = blocks(g, r, Ji, diag, inc)
        return torch.linalg.inv_ex(Hd)[0], gvec

    def step(g, Ji, Minv, gvec, inc):
        return pcg(g, Ji, Minv, diag, gvec, cg_iters, inc)
    return _gauss_newton(g, iters, first, step, 1.0, "pcg")
