"""The owner-sharded window LBA over a shard mesh.

Port of ``plslam_tpu/parallel/dist_lba.py``: ``BucketedProblem``,
``_bucket_rows``, ``bucket_problem_by_owner``, ``unbucket_landmarks``,
``comm_bytes_per_step``, ``_to_local_ids``, the sharded residual scale and
cost, the sharded step (``make_dist_lba_step``), the sharded LM
(``make_dist_lba_lm``, the live system's solve) and the data-parallel
windows of a (kf, lm) mesh (``make_dist_lba_step_dp``).

  ownership   : landmark g belongs to shard g % n; lines own both their
                endpoints. ``bucket_problem_by_owner`` permutes a problem
                into that layout and routes every observation slot to its
                landmark's owner (K / n slots a shard; the overflow is
                dropped and counted, as the reference does).
  a shard     : an ordinary ``backend/lba.py::LBAProblem`` with K / n point
                slots, L / n line slots, P / n points, Q / n endpoints and
                local landmark ids (``shard_problem``), on its device.
  the step    : on each shard K15's kernels: ``lba_terms`` (residuals and
                Jacobians; its median scale is not used), ``lba_index``
                (once a solve), ``lba_camera`` and ``lba_bin`` with the
                GLOBAL scale, and ``lba_solve`` split around its collective:
                ``lba_schur_corr`` (the shard's Schur sums) and
                ``lba_solve_reduced`` (the all-reduced system's solve and
                the shard's landmark steps). On CPU tensors each is its
                plain version.
  reduction   : the only collectives of a step are the scale's two scalars
                (sum |r| and the count: sigma = max(1.2533 sum|r| /
                max(n, 1), 1e-4), the mean-|r| estimator, where the dense
                path takes the median), H_cc, g_c, the Schur correction
                (W, W, 6, 6) and g_corr (W, 6): ``comm_bytes_per_step(W)``,
                whatever the landmark count.
  back-sub    : landmark steps stay on their owner shard; the LM gathers
                the solved landmarks once, at its end.

The step differs from the dense one (``backend/lba.py``) in the scale
alone: damping of the original H_cc diagonal, the 1e-6 floor, the 1e8 pins
of fixed and unsupported poses, the landmark support floor of 1e-2 and
``_cap_steps`` are the same.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from plslam_tpu_torch.backend import lba
from plslam_tpu_torch.core import lie
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.parallel.mesh import Mesh


# ---------------------------------------------------------------------------
# owner-sharded problem layout
# ---------------------------------------------------------------------------

class BucketedProblem(NamedTuple):
    problem: lba.LBAProblem    # owner-sharded layout, bucketed global ids
    pt_perm: torch.Tensor      # (P,) original id -> bucketed row
    ep_perm: torch.Tensor      # (Q,) original endpoint -> bucketed row
    n_dropped: torch.Tensor    # obs slots lost to per-shard capacity


def _bucket_rows(ids, n: int, cap: int, lm_shard: int, payload):
    """Route each obs slot of every row to its owner's contiguous slice.

    ids (W, K) landmark ids in ORIGINAL order (-1 invalid), owner = id % n;
    payload: a tuple of (W, K, ...) tensors moved along. Returns
    (bucketed_ids (W, K), payload_bucketed, n_dropped): column slice
    [d cap, (d + 1) cap) holds owner d's observations in their order, ids
    in the bucketed global layout (owner * lm_shard + id // n)."""
    W, K = ids.shape
    owner = torch.where(ids >= 0, ids % n, n)
    srt = torch.sort(owner, dim=1, stable=True).indices
    o_s = torch.gather(owner, 1, srt)
    start = torch.searchsorted(o_s.contiguous(), o_s.contiguous(),
                               side="left")
    rank = torch.arange(K, device=ids.device) - start
    ok = (o_s < n) & (rank < cap)
    dest = torch.where(ok, o_s * cap + rank, K)       # K: dropped
    ids_s = torch.gather(ids, 1, srt)
    new_id = torch.where(ok, o_s * lm_shard + torch.div(
        ids_s, n, rounding_mode="floor"), -1).to(ids.dtype)
    out_ids = torch.full((W, K + 1), -1, dtype=ids.dtype,
                         device=ids.device).scatter_(1, dest, new_id)[:, :K]

    def move(x):
        tail = x.shape[2:]
        xs = torch.gather(x, 1, srt.reshape(W, K, *([1] * len(tail)))
                          .expand(W, K, *tail))
        out = torch.zeros((W, K + 1) + tail, dtype=x.dtype, device=x.device)
        idx = dest.reshape(W, K, *([1] * len(tail))).expand(W, K, *tail)
        return out.scatter_(1, idx, xs)[:, :K]
    dropped = torch.sum((o_s < n) & ~ok)
    return out_ids, tuple(move(x) for x in payload), dropped


def bucket_problem_by_owner(prob: lba.LBAProblem, n: int) -> BucketedProblem:
    """Permute a global-layout problem into the owner-sharded layout:
    round-robin ownership (id % n), local id = id // n; lines own BOTH
    endpoints (owner = line % n). Observation slots go to their owner's
    column slice (K / n a shard; the rare overflow is dropped and
    counted)."""
    Pn, Q = prob.pt_pos.shape[0], prob.ep_pos.shape[0]
    W, K = prob.obs_pt_id.shape
    L = prob.obs_ln_sid.shape[1]
    if Pn % n or Q % (2 * n) or K % n or L % n:
        raise ValueError(f"bucket_problem_by_owner: P={Pn}, K={K}, L={L} "
                         f"and Q/2={Q // 2} must divide into {n} shards")
    dev = prob.pt_pos.device
    g = torch.arange(Pn, device=dev)
    pt_perm = (g % n) * (Pn // n) + g // n
    pt_pos = torch.zeros_like(prob.pt_pos).index_copy_(0, pt_perm,
                                                       prob.pt_pos)
    m = torch.arange(Q // 2, device=dev)             # line ids
    line_perm = (m % n) * (Q // (2 * n)) + m // n
    e = torch.arange(Q, device=dev)
    ep_perm = 2 * line_perm[e // 2] + e % 2
    ep_pos = torch.zeros_like(prob.ep_pos).index_copy_(0, ep_perm,
                                                       prob.ep_pos)

    obs_pt_id, (obs_pt_uv, obs_pt_disp), drop_p = _bucket_rows(
        prob.obs_pt_id, n, K // n, Pn // n,
        (prob.obs_pt_uv, prob.obs_pt_disp))
    # line observations: owner by LINE id (sid // 2); both endpoint ids
    # become bucketed endpoint indices 2 * bucketed_line + (0 | 1)
    sid = prob.obs_ln_sid
    line_of = torch.where(sid >= 0, torch.div(sid, 2, rounding_mode="floor"),
                          -1).to(sid.dtype)
    line_new, (obs_ln_le, s_par, e_par), drop_l = _bucket_rows(
        line_of, n, L // n, Q // (2 * n),
        (prob.obs_ln_le, sid % 2, prob.obs_ln_eid % 2))
    obs_ln_sid = torch.where(line_new >= 0, 2 * line_new + s_par, -1)
    obs_ln_eid = torch.where(line_new >= 0, 2 * line_new + e_par, -1)
    new_prob = prob._replace(
        pt_pos=pt_pos, ep_pos=ep_pos, obs_pt_uv=obs_pt_uv,
        obs_pt_disp=obs_pt_disp, obs_pt_id=obs_pt_id, obs_ln_le=obs_ln_le,
        obs_ln_sid=obs_ln_sid.to(sid.dtype),
        obs_ln_eid=obs_ln_eid.to(sid.dtype))
    return BucketedProblem(new_prob, pt_perm, ep_perm, drop_p + drop_l)


def unbucket_landmarks(x_bucketed: torch.Tensor, perm: torch.Tensor
                       ) -> torch.Tensor:
    """Map owner-sharded landmark rows back to the original order."""
    return x_bucketed[perm]


def comm_bytes_per_step(W: int) -> int:
    """All-reduce volume of one sharded step (f32 bytes): H_cc (W,6,6) +
    g_c (W,6) + Schur correction (W,W,6,6) + g_corr (W,6) + the scale's 2
    scalars, whatever the landmark count."""
    return 4 * (W * 36 + W * 6 + W * W * 36 + W * 6 + 2)


def _to_local_ids(problem: lba.LBAProblem, me: int) -> lba.LBAProblem:
    """A shard's slice, ids in the bucketed global layout -> local ids (its
    landmarks occupy [me P_loc, (me + 1) P_loc))."""
    P_loc, Q_loc = problem.pt_pos.shape[0], problem.ep_pos.shape[0]
    loc = lambda ids, size: torch.where(ids >= 0, ids - me * size, -1).to(
        ids.dtype)
    return problem._replace(obs_pt_id=loc(problem.obs_pt_id, P_loc),
                            obs_ln_sid=loc(problem.obs_ln_sid, Q_loc),
                            obs_ln_eid=loc(problem.obs_ln_eid, Q_loc))


def _slice(problem: lba.LBAProblem, n: int, c: int) -> lba.LBAProblem:
    """Shard c of n of a bucketed problem, with local ids."""
    K, L = problem.obs_pt_id.shape[1] // n, problem.obs_ln_sid.shape[1] // n
    P, Q = problem.pt_pos.shape[0] // n, problem.ep_pos.shape[0] // n
    obs = lambda x, m: x[:, c * m:(c + 1) * m]
    return _to_local_ids(problem._replace(
        pt_pos=problem.pt_pos[c * P:(c + 1) * P],
        ep_pos=problem.ep_pos[c * Q:(c + 1) * Q],
        obs_pt_uv=obs(problem.obs_pt_uv, K),
        obs_pt_disp=obs(problem.obs_pt_disp, K),
        obs_pt_id=obs(problem.obs_pt_id, K),
        obs_ln_le=obs(problem.obs_ln_le, L),
        obs_ln_sid=obs(problem.obs_ln_sid, L),
        obs_ln_eid=obs(problem.obs_ln_eid, L)), c)


def shard_problem(mesh: Mesh, problem: lba.LBAProblem, axis: str = "lm"
                  ) -> List[lba.LBAProblem]:
    """The local shards of a bucketed problem (``bucket_problem_by_owner``
    at ``mesh.shape[axis]``), each with local ids on its device."""
    n = mesh.shape[axis]
    return [lba.LBAProblem(*(x.contiguous().to(dev) for x in _slice(
        problem, n, mesh.axis_index(i, axis))))
        for i, dev in enumerate(mesh.devices)]


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

class ShardOps(NamedTuple):
    """What a shard runs: K15's launches (``KERNELS``, each dispatching on
    its tensors' device) or their plain versions (``PLAIN``, any device;
    what chip_smoke.py holds the launches to on the card)."""
    terms: object      # (problem, cam) -> (LBATerms, ...)
    index: object      # problem -> LBAIndex
    camera: object     # (terms, sigma, free) -> (H_cc, g_c)
    bin: object        # (terms, problem, sigma, free, lam, index) -> blocks
    corr: object       # (blocks, problem, free, index, scratch)
    solve: object      # (H_cc, g_c, corr, g_corr, blocks, problem, free,
    #                     lam, pin_weight, cap, scratch) -> (dxi, d_pt, d_ep)


KERNELS = ShardOps(lba.lba_terms_sigma, lba.lba_index, lba.lba_camera,
                   lba.lba_bin, lba.lba_schur_corr, lba.lba_solve_reduced)
PLAIN = ShardOps(
    lba.lba_terms_sigma_plain, lba.lba_index_plain, lba.lba_camera_plain,
    lambda t, problem, sigma, free, lam, index: lba.lba_bin_plain(
        t, problem, sigma, free, lam),
    lambda b, problem, free, index, scratch: lba.lba_schur_corr_plain(b, free),
    lambda H_cc, g_c, corr, g_corr, b, problem, free, lam, pin_weight, cap,
    scratch: lba.lba_solve_reduced_plain(
        H_cc, g_c, corr, g_corr, b, free, lam, problem.pt_pos.shape[0],
        pin_weight, cap))


def _scale_terms(t: lba.LBATerms):
    """A shard's count of valid residuals (int32) and their sum of |r|."""
    n_ok = (torch.sum(t.ok_pt, dtype=torch.int32)
            + torch.sum(t.ok_ln, dtype=torch.int32))
    s_abs = (torch.sum(torch.where(t.ok_pt, t.rn, 0.0))
             + torch.sum(torch.where(t.ok_ln[0], torch.abs(t.r_ln[0]), 0.0))
             + torch.sum(torch.where(t.ok_ln[1], torch.abs(t.r_ln[1]), 0.0)))
    return n_ok, s_abs


def _shard_scale(mesh: Mesh, terms: list, axis: str) -> list:
    """The GLOBAL robust scale (collective mean |r|), one a shard."""
    parts = mesh.map(_scale_terms, terms)
    n_ok = mesh.psum([p[0] for p in parts], axis)
    s_abs = mesh.psum([p[1] for p in parts], axis)
    return mesh.map(lambda n, s: torch.clamp(
        1.2533 * s / torch.clamp(n, min=1).to(s.dtype), min=1e-4),
        n_ok, s_abs)


def _local_cost(t: lba.LBATerms, problem: lba.LBAProblem, sigma):
    """A shard's robust cost at the global scale, with the lost-observation
    charge of ``backend/lba.py::lba_sigma_plain``."""
    w_pt, w_ln = lba._weights(t, sigma)
    n_lost = (torch.sum((problem.obs_pt_id >= 0) & ~t.ok_pt)
              + torch.sum((problem.obs_ln_sid >= 0) & ~t.ok_ln[0])
              + torch.sum((problem.obs_ln_eid >= 0) & ~t.ok_ln[1]))
    return (torch.sum(w_pt * t.rn ** 2) + torch.sum(w_ln[0] * t.r_ln[0] ** 2)
            + torch.sum(w_ln[1] * t.r_ln[1] ** 2)
            + 6.0 * sigma * sigma * n_lost)


def _shard_cost(mesh: Mesh, probs: list, cam: StereoCamera, axis: str,
                ops: ShardOps) -> list:
    """The robust total cost over the shards (local ids), one a shard."""
    terms = mesh.map(lambda p: ops.terms(p, cam)[0], probs)
    sigma = _shard_scale(mesh, terms, axis)
    return mesh.psum(mesh.map(_local_cost, terms, probs, sigma), axis)


def _solve_scratch(mesh: Mesh, probs: list) -> list:
    """A scratch a shard for its lba_schur_corr and lba_solve_reduced
    (None on the CPU)."""
    def one(p):
        if p.kf_pose.device.type == "cpu":
            return None
        return lba.new_solve_scratch(p.kf_pose.shape[0], p.pt_pos.shape[0]
                                     + p.ep_pos.shape[0], p.kf_pose.device)
    return mesh.map(one, probs)


def _owner_shard_step(mesh: Mesh, probs: list, lam: list, cam: StereoCamera,
                      axis: str, ops: ShardOps, index: list, scratch: list,
                      cap: bool) -> Tuple[list, list, list]:
    """The damped sharded step on local ids; only the reduced camera system
    crosses shards. Returns per-shard lists (dxi (W,6) the same on every
    shard, d_pt, d_ep of the shard's landmarks)."""
    terms = mesh.map(lambda p: ops.terms(p, cam)[0], probs)
    sigma = _shard_scale(mesh, terms, axis)
    free = mesh.map(lba._free, probs)
    cam_blocks = mesh.map(ops.camera, terms, sigma, free)
    H_cc = mesh.psum([c[0] for c in cam_blocks], axis)
    g_c = mesh.psum([c[1] for c in cam_blocks], axis)
    blocks = mesh.map(lambda h, g, t, p, s, f, l, i: lba.LandmarkBlocks(
        h, g, *ops.bin(t, p, s, f, l, i)),
        H_cc, g_c, terms, probs, sigma, free, lam, index)
    sums = mesh.map(ops.corr, blocks, probs, free, index, scratch)
    corr = mesh.psum([s[0] for s in sums], axis)
    g_corr = mesh.psum([s[1] for s in sums], axis)
    out = mesh.map(ops.solve, H_cc, g_c, corr, g_corr, blocks, probs, free,
                   lam, lba.PIN_WEIGHT, cap, scratch)
    return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]


def _lam_list(mesh: Mesh, lam, probs: list) -> list:
    return mesh.map(lambda p: torch.as_tensor(
        lam, dtype=torch.float32).to(p.kf_pose.device).reshape(()), probs)


def make_dist_lba_step(mesh: Mesh, cam: StereoCamera, axis: str = "lm",
                       ops: ShardOps = KERNELS):
    """fn(problem, lam) -> (dxi (W,6), d_pt (P,3), d_ep (Q,3)): one damped
    sharded step, uncapped. ``problem`` is in the owner-sharded layout of
    ``bucket_problem_by_owner(prob, mesh.shape[axis])`` (every process of
    a multi-process mesh passes the whole of it and takes its own shards);
    the outputs are in that layout, gathered onto the problem's device."""
    def step(problem: lba.LBAProblem, lam):
        probs = shard_problem(mesh, problem, axis)
        dxi, d_pt, d_ep = _owner_shard_step(
            mesh, probs, _lam_list(mesh, lam, probs), cam, axis, ops,
            mesh.map(ops.index, probs), _solve_scratch(mesh, probs),
            cap=False)
        dev = problem.kf_pose.device
        return (dxi[0].to(dev), mesh.gather(d_pt, axis).to(dev),
                mesh.gather(d_ep, axis).to(dev))
    return step


def _lm_shards(mesh: Mesh, probs: list, cam: StereoCamera, iters: int,
               lam0: float, lam_factor: float, axis: str, ops: ShardOps):
    """``iters`` accept/reject LM steps on the shards (local ids); every
    decision on the device. Returns (shards, cost0, cost1), lists."""
    cost0 = _shard_cost(mesh, probs, cam, axis, ops)
    cost = cost0
    lam = _lam_list(mesh, lam0, probs)
    # the observation ids stay as they are through the LM loop
    index = mesh.map(ops.index, probs)
    scratch = _solve_scratch(mesh, probs)
    for _ in range(iters):
        # trust-region caps as the dense loop's (_cap_steps, in the step)
        dxi, d_pt, d_ep = _owner_shard_step(mesh, probs, lam, cam, axis, ops,
                                            index, scratch, cap=True)
        trial = mesh.map(lambda p, d, a, e: p._replace(
            kf_pose=lie.exp_se3(d) @ p.kf_pose, pt_pos=p.pt_pos + a,
            ep_pos=p.ep_pos + e), probs, dxi, d_pt, d_ep)
        c_try = _shard_cost(mesh, trial, cam, axis, ops)
        # every shard sees the same costs and dxi; the landmark steps'
        # finiteness is the shard's own: made global by a pmin
        finite = mesh.pmin(mesh.map(lambda c, d, a, e: (
            torch.isfinite(c) & torch.all(torch.isfinite(d))
            & torch.all(torch.isfinite(a)) & torch.all(torch.isfinite(e))
        ).to(torch.int32), c_try, dxi, d_pt, d_ep), axis)
        accept = mesh.map(lambda f, ct, c: (f > 0) & (ct < c), finite, c_try,
                          cost)
        probs = mesh.map(lambda a, t, p: lba.LBAProblem(
            *(torch.where(a, x, y) for x, y in zip(t, p))), accept, trial,
            probs)
        lam = mesh.map(lambda a, l: torch.where(
            a, l * (1.0 / lam_factor), l * lam_factor), accept, lam)
        cost = mesh.map(torch.where, accept, c_try, cost)
    return probs, cost0, cost


def make_dist_lba_lm(mesh: Mesh, cam: StereoCamera, iters: int, lam0: float,
                     lam_factor: float, axis: str = "lm",
                     ops: ShardOps = KERNELS):
    """The sharded robust LM (the live system's solve): fn(problem) ->
    (kf_pose (W,4,4), pt_pos (P,3), ep_pos (Q,3) in the bucketed layout,
    cost0, cost1) on the problem's device. ``problem``: as
    ``make_dist_lba_step`` takes it. The same loop as
    ``backend/lba.py::run_lba``, with the sharded step and cost."""
    def lm(problem: lba.LBAProblem):
        probs, cost0, cost1 = _lm_shards(
            mesh, shard_problem(mesh, problem, axis), cam, iters, lam0,
            lam_factor, axis, ops)
        dev = problem.kf_pose.device
        return (probs[0].kf_pose.to(dev),
                mesh.gather([p.pt_pos for p in probs], axis).to(dev),
                mesh.gather([p.ep_pos for p in probs], axis).to(dev),
                cost0[0].to(dev), cost1[0].to(dev))
    return lm


def make_dist_lba_step_dp(mesh: Mesh, cam: StereoCamera,
                          kf_axis: str = "kf", lm_axis: str = "lm",
                          ops: ShardOps = KERNELS):
    """Data-parallel windows x owner-sharded Schur on a 2D mesh: the
    ``kf_axis`` runs independent windows, each window's landmarks and
    Schur reduction shard over ``lm_axis`` as ``make_dist_lba_step``'s.
    fn(problems, lam): ``problems`` a batched owner-sharded LBAProblem
    with a leading window axis of G (a multiple of
    ``mesh.shape[kf_axis]``; window block b on kf row b); returns batched
    (dxi (G,W,6), d_pt (G,P,3), d_ep (G,Q,3))."""
    def step(problems: lba.LBAProblem, lam):
        G = problems.kf_pose.shape[0]
        nk, nl = mesh.shape[kf_axis], mesh.shape[lm_axis]
        if G % nk:
            raise ValueError(f"{G} windows over {nk} kf rows")
        per = G // nk
        outs = []
        for j in range(per):
            probs = [lba.LBAProblem(*(x.contiguous().to(dev) for x in _slice(
                lba.LBAProblem(*(x[mesh.axis_index(i, kf_axis) * per + j]
                                 for x in problems)),
                nl, mesh.axis_index(i, lm_axis))))
                for i, dev in enumerate(mesh.devices)]
            dxi, d_pt, d_ep = _owner_shard_step(
                mesh, probs, _lam_list(mesh, lam, probs), cam, lm_axis, ops,
                mesh.map(ops.index, probs), _solve_scratch(mesh, probs),
                cap=False)
            whole = lambda xs: [torch.cat(list(s.unbind(0))) for s in
                                mesh.all_gather(xs, lm_axis)]
            outs.append((dxi, whole(d_pt), whole(d_ep)))
        dev = problems.kf_pose.device
        # shard i's windows (kf row b, j) -> the batch, row by row
        res = []
        for f in range(3):
            per_shard = [torch.stack([o[f][i] for o in outs])
                         for i in range(len(mesh.devices))]
            rows = mesh.all_gather(per_shard, kf_axis)[0]  # (nk, per, ...)
            res.append(rows.reshape((G,) + rows.shape[2:]).to(dev))
        return tuple(res)
    return step
