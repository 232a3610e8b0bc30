"""Keyframe culling with landmark re-anchoring.

The reference bounds memory by deleting old non-keyframes and stripping
images from old keyframes (CullingOldFrames, ref src/pipeline_map.cpp:
100-129; ReduceMemSize, src/frame.cpp:591-600) — our map stores neither,
so that behavior is free. What a fixed-capacity map needs instead is
ORB-SLAM-style redundancy culling: drop keyframes whose observations are
overwhelmingly covered by other keyframes.

Because landmarks are anchored (inverse depth along the anchor
keyframe's ray), culling keyframe f must re-anchor every landmark whose
mp_ref_kf == f to another observing keyframe; landmarks with no other
observer are invalidated (freeing their slots for reuse by
allocate_slots' first-free scan).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.mapping.map_state import MapState, mappoint_positions


def redundancy_scores(m: MapState, protect_recent: int = 8) -> jnp.ndarray:
    """(F,) fraction of a keyframe's landmarks seen by >= 3 other KFs.

    -1 for invalid or protected (most recent) keyframes, so argmax picks
    the best culling candidate.
    """
    F, K = m.kf_obs.shape
    M = m.mp_valid.shape[0]
    counts = jnp.concatenate([m.mp_obs_count, jnp.zeros(1, jnp.int32)])
    ids = jnp.where(m.kf_obs >= 0, m.kf_obs, M)
    redundant = (counts[ids] >= 4) & (ids < M)          # self + 3 others
    observed = ids < M
    frac = jnp.sum(redundant, axis=1) / jnp.maximum(
        jnp.sum(observed, axis=1), 1)
    fid = jnp.where(m.kf_valid, m.kf_frame_id, -1)
    rank = jnp.sum(fid[None, :] < fid[:, None], axis=1)
    newest_rank = jnp.max(jnp.where(m.kf_valid, rank, -1))
    protected = rank > newest_rank - protect_recent
    return jnp.where(m.kf_valid & ~protected, frac, -1.0)


def cull_keyframe(m: MapState, slot: jnp.ndarray) -> MapState:
    """Remove keyframe `slot`: re-anchor or invalidate its landmarks."""
    F, K = m.kf_obs.shape
    M = m.mp_valid.shape[0]

    # positions BEFORE the anchor moves
    Xw = mappoint_positions(m)

    # find an alternative observer for every landmark: scatter-max of the
    # encoded (kf, kpt) over all observations from OTHER keyframes
    ids = m.kf_obs                                       # (F, K)
    f_idx = jnp.broadcast_to(jnp.arange(F)[:, None], (F, K))
    k_idx = jnp.broadcast_to(jnp.arange(K)[None, :], (F, K))
    usable = (ids >= 0) & m.kf_valid[:, None] & (f_idx != slot)
    code = jnp.where(usable, f_idx * K + k_idx + 1, 0)   # 0 = none
    target = jnp.where(usable, ids, M)
    alt = jnp.zeros((M + 1,), jnp.int32).at[
        target.reshape(-1)].max(code.reshape(-1))[:M]

    anchored_here = m.mp_valid & (m.mp_ref_kf == slot)
    has_alt = alt > 0
    new_ref = jnp.where(anchored_here & has_alt,
                        (alt - 1) // K, m.mp_ref_kf)
    new_kpt = jnp.where(anchored_here & has_alt,
                        (alt - 1) % K, m.mp_kpt)
    # recompute inverse depth along the new anchor ray; a landmark that
    # lands BEHIND its new anchor cannot be re-encoded — drop it rather
    # than clamping it to 1 mm depth (same guard as ba_adapter.write_back)
    z_new = se3.transform(m.kf_T_cw[new_ref], Xw)[..., 2]
    new_invd = jnp.where(anchored_here & has_alt,
                         1.0 / jnp.maximum(z_new, 1e-3), m.mp_invd)
    behind = anchored_here & has_alt & (z_new <= 1e-3)
    new_valid = m.mp_valid & ~(anchored_here & ~has_alt) & ~behind

    # decrement observation counts for everything this keyframe saw
    seen = jnp.where(m.kf_obs[slot] >= 0, m.kf_obs[slot], M)
    obs_count = jnp.concatenate([m.mp_obs_count, jnp.zeros(1, jnp.int32)])
    obs_count = obs_count.at[seen].add(-1)[:M]
    obs_count = jnp.maximum(obs_count, 0)

    return m._replace(
        kf_valid=m.kf_valid.at[slot].set(False),
        kf_frame_id=m.kf_frame_id.at[slot].set(-1),
        kf_obs=m.kf_obs.at[slot].set(-1),
        mp_ref_kf=new_ref,
        mp_kpt=new_kpt,
        mp_invd=new_invd,
        mp_valid=new_valid,
        mp_obs_count=obs_count,
    )


def cull_weak_mappoints(m: MapState, cur_frame_id, grace_frames: int = 12,
                        min_obs: int = 2) -> MapState:
    """Free landmarks never re-observed after a grace period.

    ORB-SLAM-style mappoint culling: a landmark created at one keyframe
    must be tracked into at least `min_obs` keyframes within
    `grace_frames` frames of its anchor or its slot is recycled. The
    reference has no direct equivalent (its mappoints die only with
    their frames); with a dense stereo supplier this is what keeps the
    fixed-capacity table from saturating with one-shot landmarks.

    Safe for slot reuse: a weak landmark's only kf_obs reference is its
    anchor entry, which is cleared here (guarded, in case a loop-closure
    merge re-pointed it)."""
    F, K = m.kf_obs.shape
    M = m.mp_valid.shape[0]
    # a landmark only had a chance to be re-observed if keyframes were
    # actually created after its anchor: require >= min_obs newer KFs.
    # Computed as a per-KF newer-count table (one fused (F, F)
    # compare-reduce) instead of a sort+searchsorted
    newer_tbl = jnp.sum(m.kf_valid[None, :] &
                        (m.kf_frame_id[None, :] > m.kf_frame_id[:, None]),
                        axis=1).astype(jnp.int32)
    # per-KF eligibility, applied per landmark as one (M, F) broadcast
    # compare-reduce instead of gathering the age and newer-count
    # tables per landmark
    kf_elig = ((cur_frame_id - m.kf_frame_id > grace_frames) &
               (newer_tbl >= min_obs))
    elig = jnp.any(kf_elig[None, :] &
                   (m.mp_ref_kf[:, None] == jnp.arange(F)[None, :]), axis=1)
    weak = m.mp_valid & (m.mp_obs_count < min_obs) & elig
    flat_idx = m.mp_ref_kf * K + m.mp_kpt
    # anchor-cell invariant: for every VALID landmark w,
    # kf_obs[mp_ref_kf[w], mp_kpt[w]] == w. Insert writes the anchor
    # cell; cull_keyframe re-anchors onto a cell that observes w;
    # merge_mappoints only rewrites cells of LOSER landmarks (which it
    # invalidates) and only adopts into EMPTY cells (loop/closer.py:
    # 231-251). So the weak mask (which requires mp_valid) never needs
    # a read-back guard (a 16k-element gather from the 2M obs table).
    # Drop-mode scatter straight into the (F*K,) view (the old concat-
    # sentinel + [:-1] slice copied the table twice more per event).
    obs_flat = m.kf_obs.reshape(-1)
    target = jnp.where(weak, flat_idx, F * K)
    obs_flat = obs_flat.at[target].set(-1, mode="drop")
    return m._replace(
        kf_obs=obs_flat.reshape(F, K),
        mp_valid=m.mp_valid & ~weak,
        mp_obs_count=jnp.where(weak, 0, m.mp_obs_count))


def cull_most_redundant(m: MapState, min_fraction: float = 0.8,
                        protect_recent: int = 8
                        ) -> Tuple[MapState, jnp.ndarray]:
    """Cull the most redundant keyframe if above `min_fraction`.

    Returns (map, culled_slot or -1). jit-safe (lax.cond on the score).
    """
    scores = redundancy_scores(m, protect_recent)
    slot = jnp.argmax(scores)
    do = scores[slot] >= min_fraction

    def yes(mm):
        return cull_keyframe(mm, slot)

    def no(mm):
        return mm

    m2 = jax.lax.cond(do, yes, no, m)
    return m2, jnp.where(do, slot, -1)
