"""Loop detection: dense BoW scoring + temporal consistency.

Replaces LoopDetector (ref src/loopdetector.cpp:38-154) and the
inverted-file candidate retrieval (ref src/pipeline_map.cpp:151-272):

- every keyframe's dense BoW vector lives in a (F, W) device matrix;
  a query scores against ALL keyframes in one masked reduction —
  feasible because F <= a few hundred, so the inverted file's pruning
  buys nothing on an accelerator;
- minScore = min_score_ratio * best covisible-neighbor score
  (the author's deliberate deviation from ORB-SLAM2's min,
  ref src/loopdetector.cpp:51-76);
- covisibility (shared-mappoint counts) is computed on demand from the
  observation table;
- temporal consistency (candidate groups intersecting previous groups
  over >= consistency_threshold consecutive keyframes,
  ref src/loopdetector.cpp:92-146) is cheap set bookkeeping on the host
  over tiny per-keyframe neighbor bitmasks.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_toolkit_tpu.config import LoopConfig
from slam_toolkit_tpu.mapping.map_state import MapState


class LoopScores(NamedTuple):
    scores: jnp.ndarray       # (F,) BoW similarity to each keyframe slot
    covis: jnp.ndarray        # (F,) shared-mappoint counts with the query
    min_score: jnp.ndarray    # () detection threshold
    candidates: jnp.ndarray   # (F,) bool raw candidate mask


# canonical implementation lives in mapping/map_state.py (the tracker's
# local-map gather needs it too); re-exported here for the detector API
from slam_toolkit_tpu.mapping.map_state import covisibility_counts  # noqa: E402,F401


def score_query(m: MapState, bow_db, bow_query,
                kf_slot: jnp.ndarray, cfg: LoopConfig) -> LoopScores:
    """Score one keyframe's BoW against the whole database (jit-safe).

    `bow_db`/`bow_query` are either dense (F, W)/(W,) vectors or
    top-w sparse rows (vocab.TopWBow) — vocab.bow_score dispatches."""
    from slam_toolkit_tpu.loop.vocab import bow_score
    scores = bow_score(bow_query, bow_db)
    valid = m.kf_valid & (jnp.arange(m.kf_valid.shape[0]) != kf_slot)
    scores = jnp.where(valid, scores, -1.0)

    covis = covisibility_counts(m, kf_slot)
    neighbor = valid & (covis >= cfg.min_covisibility)
    best_neighbor = jnp.max(jnp.where(neighbor, scores, 0.0))
    # absolute floor: a keyframe with no covisible neighbor (aggressive
    # culling / low texture) would otherwise degrade min_score to ~0 and
    # admit every keyframe sharing a single BoW word as a candidate
    # (ORB-SLAM2 never hits this because its query always has neighbors)
    min_score = jnp.maximum(cfg.min_score_ratio * best_neighbor,
                            cfg.min_score_floor)

    # temporal gate: a candidate must be at least min_kf_gap keyframe
    # insertions older than the query
    fid = jnp.where(m.kf_valid, m.kf_frame_id, jnp.iinfo(jnp.int32).max)
    rank = jnp.sum(fid[None, :] < fid[:, None], axis=1)   # insertion rank
    old_enough = rank <= rank[kf_slot] - cfg.min_kf_gap

    candidates = (valid & ~neighbor & old_enough &
                  (scores >= jnp.maximum(min_score, 1e-6)))
    return LoopScores(scores=scores, covis=covis, min_score=min_score,
                      candidates=candidates)


def acc_score_retrieval(scores: np.ndarray, cand_slots: np.ndarray,
                        covis_rows: np.ndarray, accept_ratio: float = 0.75,
                        group_size: int = 10):
    """Covisibility-group score accumulation (ref src/pipeline_map.cpp:224-269).

    Single-frame BoW similarity aliases: two distinct places can share
    enough words to out-score a true revisit. The reference therefore
    accumulates each candidate's score over its top-`group_size`
    covisible keyframes that are themselves candidates, and keeps only
    groups scoring > accept_ratio * bestAccScore, represented by the
    group's best-scoring member.

    scores: (F,) BoW score per keyframe slot. cand_slots: (C,) raw
    candidate slots. covis_rows: (C, F) shared-mappoint counts of each
    candidate vs every slot. Returns (kept_slots, kept_acc) — deduped
    representative slots sorted by descending group score.
    """
    cand_set = set(int(c) for c in cand_slots)
    reps, accs = [], []
    for ci, cs in enumerate(cand_slots):
        cov = covis_rows[ci].copy()
        cov[int(cs)] = 0
        top = np.argsort(-cov)[:group_size]
        top = top[cov[top] > 0]
        acc = float(scores[int(cs)])
        best_slot, best_score = int(cs), float(scores[int(cs)])
        for j in top:
            if int(j) in cand_set:
                acc += float(scores[int(j)])
                if float(scores[int(j)]) > best_score:
                    best_slot, best_score = int(j), float(scores[int(j)])
        reps.append(best_slot)
        accs.append(acc)
    if not reps:
        return np.empty((0,), np.int64), np.empty((0,))
    accs = np.asarray(accs)
    keep = accs > accept_ratio * accs.max()
    out, seen = [], set()
    for r, a in sorted(zip(np.asarray(reps)[keep], accs[keep]),
                       key=lambda t: -t[1]):
        if int(r) not in seen:
            seen.add(int(r))
            out.append((int(r), float(a)))
    return (np.asarray([o[0] for o in out], np.int64),
            np.asarray([o[1] for o in out]))


class ConsistencyTracker:
    """Host-side temporal-consistency groups (ref src/loopdetector.cpp:92-146).

    A candidate is accepted once its covisibility group has intersected a
    previous detection's group for `threshold` consecutive keyframes.
    """

    def __init__(self, threshold: int):
        self.threshold = threshold
        self.groups: List[Tuple[Set[int], int]] = []   # (kf set, streak)

    def update(self, candidate_groups: List[Set[int]]) -> List[int]:
        """candidate_groups: for each candidate, {candidate + its covisible
        neighbors}. Returns indices of candidates that are now consistent."""
        accepted = []
        new_groups: List[Tuple[Set[int], int]] = []
        for ci, grp in enumerate(candidate_groups):
            streak = 0
            for prev, n in self.groups:
                if grp & prev:
                    streak = max(streak, n + 1)
            new_groups.append((grp, streak))
            if streak >= self.threshold:
                accepted.append(ci)
        self.groups = new_groups
        return accepted

    def reset(self):
        self.groups = []
