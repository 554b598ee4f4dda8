"""Sharded place-recognition retrieval.

Port of ``plslam_tpu/parallel/dist_vocab.py``: ``make_sharded_query`` and
``DistRetrieval``. The shards of a 1D 'kf' mesh hold F / n rows each of the
per-KF BoW matrices (both vocabularies); a query scores each shard's rows
(``loop/vocabulary.py::l1_score``), takes the covisible baseline by a
``pmax``, a local top-k and the merged top-k of an ``all_gather``. A top-k
here is a stable descending sort (``lax.top_k``'s order: of equal scores
the lower index first), so the candidates are the single-device
``loop/database.py::select_candidates`` ones, candidate for candidate.
"""

from __future__ import annotations

from typing import Optional

import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.loop.vocabulary import l1_score
from plslam_tpu_torch.parallel.mesh import Mesh, make_mesh


def _top_k(x: torch.Tensor, k: int):
    """The k largest entries of a vector and their indices, ties in index
    order (``lax.top_k``'s)."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def make_sharded_query(mesh: Mesh, axis: str = "kf", k: int = 8):
    """fn(bows (F, D), query (D,)) -> (top-k scores, top-k global KF
    indices) over the rows sharded on ``axis``."""
    def query(bows, q):
        rows = mesh.shard(bows, axis)
        n_local = rows[0].shape[0]

        def local(b, i):
            s, t = _top_k(l1_score(b, q.to(b.device)[None, :]), k)
            return s, t + mesh.axis_index(i, axis) * n_local
        loc = mesh.map(local, rows, list(range(len(mesh.devices))))
        all_s = mesh.all_gather([x[0] for x in loc], axis)[0].reshape(-1)
        all_i = mesh.all_gather([x[1] for x in loc], axis)[0].reshape(-1)
        ms, sel = _top_k(all_s, k)
        return ms, all_i[sel]
    return query


class DistRetrieval:
    """The sharded BoW database of the live loop closer
    (``loop.distributed``): it mirrors every keyframe insertion and answers
    the candidate query (global top-k and the covisible baseline of
    lookForLoopCandidates) with the semantics of
    ``loop/database.py::select_candidates``. Its 'kf' mesh has
    ``loop.dist_devices`` shards (0: one a visible device of ``device``'s
    type), into which ``mapping.max_kfs`` must divide."""

    def __init__(self, cfg: SlamConfig, n_leaves_p: int,
                 n_leaves_l: Optional[int] = None, device=None):
        dev = torch.device("cuda" if device is None else device)
        n = cfg.loop.dist_devices or (
            torch.cuda.device_count() if dev.type == "cuda" else 1)
        self.mesh = mesh = make_mesh(n, axes=("kf",), device=dev)
        self.n = mesh.shape["kf"]
        F = cfg.mapping.max_kfs
        if F % self.n:
            raise ValueError(f"mapping.max_kfs={F} must divide the "
                             f"{self.n}-shard retrieval mesh")
        self.rows = F // self.n
        self.k = cfg.loop.max_loop_candidates
        if self.k > self.rows:
            raise ValueError(f"loop.max_loop_candidates={self.k} exceeds the "
                             f"{self.rows} rows of a shard")
        self.sep = cfg.loop.min_kf_separation
        self._has_l = n_leaves_l is not None
        self.bows_p = self._zeros(n_leaves_p)
        self.bows_l = self._zeros(n_leaves_l if self._has_l else 1)

    def _zeros(self, d: int) -> list:
        return [torch.zeros((self.rows, d), dtype=torch.float32, device=dev)
                for dev in self.mesh.devices]

    def insert(self, slot: int, vp: torch.Tensor,
               vl: Optional[torch.Tensor] = None) -> None:
        """Mirror one keyframe's BoW vector(s) into the sharded rows (shard
        slot // rows, row slot % rows)."""
        i, r = divmod(int(slot), self.rows)
        self.bows_p[i][r] = vp.to(self.bows_p[i].device)
        if self._has_l and vl is not None:
            self.bows_l[i][r] = vl.to(self.bows_l[i].device)

    def query(self, slot: int, n_kfs: int, qp: torch.Tensor,
              ql: Optional[torch.Tensor] = None):
        """(top-k scores, top-k global KF slots, covisible baseline) for
        the keyframe at ``slot`` (its vectors inserted already: pass them
        as qp / ql), on the first shard's device."""
        mesh, k, sep, has_l = self.mesh, self.k, self.sep, self._has_l

        def local(bp, bl, i):
            gid = i * self.rows + torch.arange(self.rows, dtype=torch.int32,
                                               device=bp.device)
            s = l1_score(bp, qp.to(bp.device)[None, :])
            if has_l:
                s = 0.5 * (s + l1_score(bl, ql.to(bl.device)[None, :]))
            # covisible baseline: best score in the temporal window
            covis_win = (gid >= slot - sep) & (gid < slot)
            base = torch.max(torch.where(covis_win, s, 0.0))
            eligible = (gid < slot - sep) & (gid < n_kfs)
            ts, tl = _top_k(torch.where(eligible, s, 0.0), k)
            return base, ts, gid[tl]
        loc = mesh.map(local, self.bows_p, self.bows_l,
                       list(range(len(mesh.devices))))
        base = mesh.pmax([x[0] for x in loc], "kf")[0]
        all_s = mesh.all_gather([x[1] for x in loc], "kf")[0].reshape(-1)
        all_i = mesh.all_gather([x[2] for x in loc], "kf")[0].reshape(-1)
        ms, sel = _top_k(all_s, k)
        return ms, all_i[sel], base

    def _remap(self, rows: list, perm: torch.Tensor, n_valid: int) -> list:
        full = self.mesh.gather(rows, "kf")
        p = perm.to(full.device, torch.int64)
        live = (torch.arange(full.shape[0], device=full.device)
                < n_valid)[:, None]
        return self.mesh.shard(torch.where(live, full.index_select(0, p),
                                           0.0), "kf")

    def remap_slots(self, perm, n_valid: int) -> None:
        """Permute rows after a KF-slot compaction (LoopCloser.remap_slots'
        contract: new row n reads old row perm[n], the tail zeroed)."""
        perm = torch.as_tensor(perm)
        self.bows_p = self._remap(self.bows_p, perm, n_valid)
        if self._has_l:
            self.bows_l = self._remap(self.bows_l, perm, n_valid)
