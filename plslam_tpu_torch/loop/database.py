"""BoW keyframe database: retrieval as a dense score over the BoW matrix.

Port of ``plslam_tpu/loop/database.py`` (``BowDatabase``, ``LoopCandidate``,
``select_candidates``, ``ConsistencyVoter``). The database is the stacked
(F, n_leaves) BoW matrices of points and lines on the device; candidate
selection and temporal-consistency voting are host numpy, copied line for
line (``np.argsort`` and the voter's dict order included), so the same
scores give the same candidates and votes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from plslam_tpu_torch.config import SlamConfig
from plslam_tpu_torch.loop.vocabulary import Vocabulary


class BowDatabase:
    """The two vocabularies plus the dense (F, n_leaves) BoW matrices for
    points and lines. The per-KF probe (``loop_closer.probe_core``)
    writes a keyframe's row in place, and with lines also the row of
    ``ln_valid`` (F, L): the line mask its BoW vector was made from. Later
    culling and retirement clear entries of the map's ``obs_ln_lm``, so
    that mask is kept for a rebuild of the rows after a resume."""

    def __init__(self, cfg: SlamConfig, voc_p: Vocabulary,
                 voc_l: Optional[Vocabulary] = None):
        self.cfg = cfg
        self.voc_p = voc_p
        self.voc_l = voc_l
        F = cfg.mapping.max_kfs
        dev = voc_p.idf.device
        self.bows_p = torch.zeros((F, voc_p.n_leaves), dtype=torch.float32,
                                  device=dev)
        self.bows_l = (torch.zeros((F, voc_l.n_leaves), dtype=torch.float32,
                                   device=dev)
                       if voc_l is not None else None)
        self.ln_valid = (torch.zeros((F, cfg.lines.max_lines),
                                     dtype=torch.bool, device=dev)
                         if voc_l is not None else None)


class LoopCandidate(NamedTuple):
    slot: int
    score: float


def select_candidates(scores: np.ndarray, slot: int, cfg: SlamConfig
                      ) -> Tuple[list, float]:
    """lookForLoopCandidates parity: normalize by the best covisible
    (temporally adjacent) score, gate with lc_mat, exclude the temporal
    neighborhood, return the top candidates."""
    lc = cfg.loop
    lo = max(slot - lc.min_kf_separation, 0)
    covis = scores[lo:slot]
    baseline = float(covis.max()) if covis.size else 1.0
    baseline = max(baseline, 1e-3)
    eligible = scores.copy()
    eligible[max(slot - lc.min_kf_separation, 0):] = 0.0
    rel = eligible / baseline
    order = np.argsort(-rel)[:lc.max_loop_candidates]
    out = [LoopCandidate(int(i), float(rel[i]))
           for i in order if rel[i] >= lc.lc_mat and eligible[i] > 0]
    return out, baseline


class ConsistencyVoter:
    """Temporal consistency: a loop fires only after the same candidate
    region is retrieved in `consistency_window` consecutive KFs."""

    def __init__(self, window: int, radius: int = 4):
        self.window = window
        self.radius = radius
        self._streaks = {}          # group center -> consecutive count

    def vote(self, candidates) -> Optional[int]:
        new_streaks = {}
        fired = None
        for c in candidates:
            best = None
            for center, count in self._streaks.items():
                if abs(c.slot - center) <= self.radius:
                    best = max(best or 0, count)
            streak = (best or 0) + 1
            new_streaks[c.slot] = max(streak, new_streaks.get(c.slot, 0))
            if streak >= self.window and fired is None:
                fired = c.slot
        self._streaks = new_streaks
        return fired
