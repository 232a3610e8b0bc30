"""The global map as one fixed-capacity pytree of arrays.

Replacement for the reference's pointer graph
(PipelineMap / Frame* / Mappoint* webs with per-object mutexes,
ref include/pipeline_map.h, include/frame.h:131-143,
include/mappoint.h:31-69). Design per SURVEY.md §7.1:

- struct-of-arrays with static capacities; "deleted" = valid mask False
  (EraseMappoint / SetBad / CullingOldFrames all become mask updates)
- mappoints keep the reference's anchored inverse-depth parametrization
  (ref src/mappoint.cpp:128-138): world point reconstructed on demand as
  Xw = T_wc_ref . (ray * 1/invd)
- observations: kf_obs[f, k] = mappoint id seen at keypoint k of keyframe
  slot f (-1 if none) — the bidirectional mappoints_/mappoints_index_
  maps of ref src/frame.cpp:281-343 collapse into this single array
- covisibility is computed on demand from kf_obs instead of being
  maintained as mutable neighbor sets (ref src/frame.cpp:469-559)

All update functions are pure: MapState in, MapState out, jit-safe.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.frontend.frame import FrameState
from slam_toolkit_tpu.geometry import se3


class MapState(NamedTuple):
    # --- keyframes (capacity F, keypoint slots K) ---
    kf_T_cw: jnp.ndarray        # (F, 4, 4)
    kf_valid: jnp.ndarray       # (F,) bool
    kf_frame_id: jnp.ndarray    # (F,) int32 global frame index, -1 empty
    kf_xy: jnp.ndarray          # (F, K, 2) pixel coords
    kf_norm: jnp.ndarray        # (F, K, 2) normalized coords
    kf_desc: jnp.ndarray        # (F, K*8) uint32 — K packed 8-word
    #                             descriptors per keyframe row
    kf_sigma2: jnp.ndarray      # (F, K) per-octave variance (pixel^2)
    kf_kpt_valid: jnp.ndarray   # (F, K) bool
    kf_right_x_norm: jnp.ndarray  # (F, K) normalized right x (stereo)
    kf_has_stereo: jnp.ndarray  # (F, K) bool
    kf_obs: jnp.ndarray         # (F, K) int32 mappoint id, -1 none
    kf_quality: jnp.ndarray     # (F,) float32 tracking inliers at creation
    # --- mappoints (capacity M) ---
    mp_ref_kf: jnp.ndarray      # (M,) int32 anchor keyframe slot
    mp_kpt: jnp.ndarray         # (M,) int32 anchor keypoint index
    mp_invd: jnp.ndarray        # (M,) float32 inverse depth (>= 1e-3)
    mp_desc: jnp.ndarray        # (M, 8) uint32 anchor descriptor
    mp_valid: jnp.ndarray       # (M,) bool
    mp_obs_count: jnp.ndarray   # (M,) int32 number of observing keyframes

    @property
    def capacity(self) -> Tuple[int, int]:
        return self.kf_valid.shape[0], self.mp_valid.shape[0]


def empty_map(cfg: SlamConfig) -> MapState:
    f = cfg.map.max_keyframes
    k = cfg.extractor.max_keypoints
    m = cfg.map.max_mappoints
    return MapState(
        kf_T_cw=jnp.tile(jnp.eye(4), (f, 1, 1)),
        kf_valid=jnp.zeros(f, bool),
        kf_frame_id=jnp.full((f,), -1, jnp.int32),
        kf_xy=jnp.zeros((f, k, 2)),
        kf_norm=jnp.zeros((f, k, 2)),
        kf_desc=jnp.zeros((f, k * 8), jnp.uint32),
        kf_sigma2=jnp.ones((f, k)),
        kf_kpt_valid=jnp.zeros((f, k), bool),
        kf_right_x_norm=jnp.zeros((f, k)),
        kf_has_stereo=jnp.zeros((f, k), bool),
        kf_obs=jnp.full((f, k), -1, jnp.int32),
        kf_quality=jnp.zeros(f),
        mp_ref_kf=jnp.zeros(m, jnp.int32),
        mp_kpt=jnp.zeros(m, jnp.int32),
        # explicit dtype: jnp.full from a python scalar is WEAK-typed,
        # and weakness survives every .at[].set update — until the
        # sim3 closure's `invd * s_ring` produced a STRONG array and
        # the aval change silently recompiled the whole chunk program
        # mid-run (JAX_LOG_COMPILES diff of BENCH_LOOP_GROUP=sim3)
        mp_invd=jnp.full((m,), 1e-3, jnp.float32),
        mp_desc=jnp.zeros((m, 8), jnp.uint32),
        mp_valid=jnp.zeros(m, bool),
        mp_obs_count=jnp.zeros(m, jnp.int32),
    )


def mappoint_positions(m: MapState) -> jnp.ndarray:
    """(M, 3) world positions: Xw = T_wc_ref . (ray / invd).

    Mirrors Mappoint::GetXw (ref src/mappoint.cpp:128-138) as one batched
    gather + transform. Invalid points land at the origin (masked later).
    """
    norm = m.kf_norm[m.mp_ref_kf, m.mp_kpt]             # (M, 2)
    invd = jnp.maximum(m.mp_invd, 1e-3)
    ray = jnp.concatenate([norm, jnp.ones_like(invd)[:, None]], axis=-1)
    Xc = ray / invd[:, None]
    T_wc = se3.inv(m.kf_T_cw[m.mp_ref_kf])
    Xw = se3.transform(T_wc, Xc)
    return jnp.where(m.mp_valid[:, None], Xw, 0.0)


def allocate_slots(free: jnp.ndarray, want: jnp.ndarray,
                   num: int) -> jnp.ndarray:
    """First-free-slot allocation, shape-static.

    free: (N,) bool availability; want: (num,) bool which requests are
    real. Returns (num,) int32 slot ids; masked (or overflow) requests
    get the SENTINEL N, so callers can scatter with mode="drop" and
    never collide with a real allocation. Allocation = the i-th real
    request gets the i-th free slot, as one fused (num, N)
    compare-reduce instead of a searchsorted, an argsort or a
    scatter+gather rank->slot table (ROADMAP S9 A/Bs these on the
    GPU)."""
    n = free.shape[0]
    csum = jnp.cumsum(free.astype(jnp.int32))            # (N,) monotone
    rank = jnp.cumsum(want.astype(jnp.int32)) - 1        # 0-based rank
    # slots[r] = min{ i : free[i] and csum[i] == rank[r] + 1 }
    hit = free[None, :] & (csum[None, :] == (rank + 1)[:, None])
    slots = jnp.min(jnp.where(hit, jnp.arange(n, dtype=jnp.int32)[None, :],
                              n), axis=1)
    real = want & (rank < csum[-1])
    return jnp.where(real, slots, n).astype(jnp.int32)


def claimed_keypoints(m: MapState, frame: FrameState, T_cw: jnp.ndarray,
                      cfg: SlamConfig, points_w: jnp.ndarray = None,
                      points_valid: jnp.ndarray = None) -> jnp.ndarray:
    """(K,) bool — keypoints whose image region a live landmark already owns.

    Rasterize every valid landmark's projection into a cell grid
    (cell = claim_cell_px), dilate 3x3, and test each keypoint's cell:
    effective suppression radius is cell..2.8*cell px. Projection is
    pure pinhole (distortion ignored — a few px at image corners, well
    inside the dilation slack). O(M + K + grid) instead of an (M, K)
    distance matrix.

    points_w/points_valid: optional world-point snapshot to rasterize
    instead of the full mappoint table — the engines pass the tracker's
    local-map snapshot (the landmarks that can project here anyway),
    which skips the 16k-point mappoint_positions + a 16k-long scatter.
    Old landmarks outside the
    snapshot's recency window can then re-claim on a loop revisit, the
    same duplicate-then-merge behavior the reference has
    (ref src/loopcloser.cpp:223-299)."""
    cell = cfg.map.claim_cell_px
    K = frame.feats.xy.shape[0]
    if cell <= 0:
        return jnp.zeros((K,), bool)
    if points_w is None:
        points_w = mappoint_positions(m)
        points_valid = m.mp_valid
    Xc = se3.transform(T_cw, points_w)
    z = jnp.maximum(Xc[:, 2], 0.05)
    u = cfg.camera.fx * Xc[:, 0] / z + cfg.camera.cx
    v = cfg.camera.fy * Xc[:, 1] / z + cfg.camera.cy
    gw = int(cfg.camera.width / cell) + 3
    gh = int(cfg.camera.height / cell) + 3
    cu = jnp.floor(u / cell).astype(jnp.int32) + 1
    cv = jnp.floor(v / cell).astype(jnp.int32) + 1
    inb = (points_valid & (Xc[:, 2] > 0.05) &
           (cu >= 0) & (cu < gw) & (cv >= 0) & (cv < gh))
    flat = jnp.where(inb, cv * gw + cu, gh * gw)
    grid = jnp.zeros((gh * gw,), bool).at[flat].set(
        True, mode="drop").reshape(gh, gw)
    dil = grid
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                dil = dil | jnp.roll(jnp.roll(grid, dy, 0), dx, 1)
    ku = jnp.clip(jnp.floor(frame.feats.xy[:, 0] / cell).astype(jnp.int32)
                  + 1, 0, gw - 1)
    kv = jnp.clip(jnp.floor(frame.feats.xy[:, 1] / cell).astype(jnp.int32)
                  + 1, 0, gh - 1)
    return dil[kv, ku]


def insert_keyframe(m: MapState, frame: FrameState, T_cw: jnp.ndarray,
                    frame_id: jnp.ndarray, mp_ids: jnp.ndarray,
                    mp_kpt: jnp.ndarray, mp_tracked: jnp.ndarray,
                    cfg: SlamConfig,
                    quality: jnp.ndarray = None,
                    lm_snapshot: Tuple[jnp.ndarray, jnp.ndarray] = None
                    ) -> Tuple[MapState, jnp.ndarray]:
    """Insert `frame` as a keyframe and supply new mappoints.

    mp_ids/mp_kpt/mp_tracked: the tracking result — landmark id (into the
    mappoint table), its matched keypoint index, and the inlier mask.
    New mappoints are supplied only at stereo keypoints that are neither
    matched to a landmark nor claimed by a projected one
    (claimed_keypoints above).
    Equivalent to Frame::SetKeyframe + SupplyMappoints + AddFrame
    (ref src/frame.cpp:444-463, :235-255; src/pipeline_map.cpp:131-149).

    Returns (new_map, kf_slot).
    """
    K = frame.feats.xy.shape[0]
    slot = jnp.argmin(m.kf_valid.astype(jnp.int32))  # first free KF slot

    # --- record tracked observations: kpt k of this KF sees mp_ids[i] ---
    scatter_kpt = jnp.where(mp_tracked, mp_kpt, K)   # K = dropped
    obs_row = jnp.zeros((K + 1,), jnp.int32).at[:K].set(-1) \
        .at[scatter_kpt].set(jnp.where(mp_tracked, mp_ids, -1))[:K]

    # --- supply new mappoints at stereo keypoints with no landmark ---
    has_mp = obs_row >= 0
    lm_Xw, lm_ok = lm_snapshot if lm_snapshot is not None else (None, None)
    claimed = claimed_keypoints(m, frame, T_cw, cfg, lm_Xw, lm_ok)
    new_mask = frame.feats.valid & frame.has_stereo & ~has_mp & ~claimed
    # allocate_slots never allocates past capacity (overflow requests
    # would map onto OCCUPIED slots and silently overwrite live
    # landmarks): masked/overflow requests get the sentinel M, dropped
    # by every scatter below
    new_slots = allocate_slots(~m.mp_valid, new_mask, K)
    allocated = new_slots < m.mp_valid.shape[0]
    kpt_idx = jnp.arange(K, dtype=jnp.int32)
    invd_new = 1.0 / jnp.maximum(frame.depth, 1e-3)

    mp_ref_kf = m.mp_ref_kf.at[new_slots].set(slot, mode="drop")
    mp_kpt_arr = m.mp_kpt.at[new_slots].set(kpt_idx, mode="drop")
    mp_invd = m.mp_invd.at[new_slots].set(invd_new, mode="drop")
    mp_desc = m.mp_desc.at[new_slots].set(frame.feats.desc, mode="drop")
    mp_valid = m.mp_valid.at[new_slots].set(True, mode="drop")

    # register the new mappoints as observations of this KF
    obs_row = jnp.where(allocated, new_slots, obs_row)

    # bump observation counts: tracked landmarks +1, new landmarks = 1
    tracked_ids = jnp.where(mp_tracked, mp_ids,
                            m.mp_obs_count.shape[0])  # overflow slot
    obs_count = jnp.concatenate([m.mp_obs_count, jnp.zeros(1, jnp.int32)])
    obs_count = obs_count.at[tracked_ids].add(1)[:-1]
    obs_count = obs_count.at[new_slots].set(1, mode="drop")

    new_m = m._replace(
        kf_T_cw=m.kf_T_cw.at[slot].set(T_cw),
        kf_valid=m.kf_valid.at[slot].set(True),
        kf_frame_id=m.kf_frame_id.at[slot].set(frame_id.astype(jnp.int32)),
        kf_xy=m.kf_xy.at[slot].set(frame.feats.xy),
        kf_norm=m.kf_norm.at[slot].set(frame.norm_xy),
        kf_desc=m.kf_desc.at[slot].set(frame.feats.desc.reshape(-1)),
        kf_sigma2=m.kf_sigma2.at[slot].set(frame.feats.sigma2),
        kf_kpt_valid=m.kf_kpt_valid.at[slot].set(frame.feats.valid),
        kf_right_x_norm=m.kf_right_x_norm.at[slot].set(frame.right_x_norm),
        kf_has_stereo=m.kf_has_stereo.at[slot].set(frame.has_stereo),
        kf_obs=m.kf_obs.at[slot].set(obs_row),
        kf_quality=m.kf_quality.at[slot].set(
            jnp.sum(mp_tracked.astype(jnp.float32)) if quality is None
            else quality),
        mp_ref_kf=mp_ref_kf,
        mp_kpt=mp_kpt_arr,
        mp_invd=mp_invd,
        mp_desc=mp_desc,
        mp_valid=mp_valid,
        mp_obs_count=obs_count,
    )
    return new_m, slot


def unique_prioritized(ids: jnp.ndarray, num_out: int,
                       m: MapState) -> jnp.ndarray:
    """Up to `num_out` DISTINCT landmark ids, established-first.

    ids: (N,) int32 in [-1, M); negative entries are ignored. Returns
    (num_out,) int32 with sentinel M in unfilled slots. When the set
    exceeds num_out, ESTABLISHED landmarks (appearing >= 2 times in
    `ids`, i.e. re-observed within the candidate window — BA-refined)
    survive and single-observation stereo inits are dropped: truncating
    the other way around filled the tracker's local map with
    never-optimized inits and lost the refined ones (measured 4x ATE at
    KITTI density).
    """
    M = m.mp_valid.shape[0]
    n = ids.shape[0]
    assert M * n < 2 ** 31, "packed sort keys overflow int32"
    pos = jnp.arange(n, dtype=jnp.int32)
    # sort 1: group duplicates (id-major); first occurrence marks the set
    key = jnp.where(ids >= 0, ids * n + pos, M * n)
    skey = jnp.sort(key)
    sid = jnp.minimum(skey // n, M)
    first = jnp.concatenate([jnp.ones(1, bool),
                             sid[1:] != sid[:-1]]) & (sid < M)
    # sort 2: established landmarks first, then by id; sentinel last
    # (two 20k-key sorts instead of a membership scatter + cumsum-rank
    # compaction).
    # "Established" = the id appears at least twice IN THE CANDIDATE
    # SET (duplicates are adjacent after sort 1, so this is one shifted
    # compare). The previous definition gathered mp_obs_count per id
    # (a 16-20k-element gather per keyframe event). The in-set notion is the better criterion anyway
    # for both callers: a BA point seen once in the window contributes
    # a near-unconstrained residual however many older keyframes saw
    # it, and a local-map landmark re-observed within the recent window
    # is exactly the "refined, multi-view" one worth keeping (bench
    # ATE/RPE at KITTI scale: 0.173 m / 0.0223 m vs 0.170 / 0.0225
    # before — inside run-to-run noise).
    # NOTE (r5): a nearest-first ordering among non-established
    # landmarks (quantized-invd sort bands) was measured on the bench
    # clothoid and REJECTED: near ground points fail frame-to-frame
    # descriptor matching regardless of being offered (self-similar
    # texture under magnification — see MatcherConfig.track_ratio), so
    # the near inits displaced established far landmarks from the
    # snapshot without ever matching, tripling open-loop drift
    # (1.9 -> 6.7 m over the 320-frame track). Near geometry for the
    # loop relative pose comes from the candidate keyframe's own stereo
    # rows instead (closer._candidate_group_landmarks stereo
    # augmentation).
    est = first & jnp.concatenate([sid[1:] == sid[:-1],
                                   jnp.zeros(1, bool)])
    pack2 = jnp.where(first,
                      jnp.where(est, 0, M + 1) + sid,
                      2 * (M + 1) + M)        # sentinel: % (M+1) == M
    return (jnp.sort(pack2)[:num_out] % (M + 1)).astype(jnp.int32)


def covisibility_counts(m: MapState, kf_slot: jnp.ndarray) -> jnp.ndarray:
    """(F,) number of mappoints shared with keyframe `kf_slot`.

    Replaces Frame::GetNeighbors (ref src/frame.cpp:469-523): membership
    is evaluated by scattering the query's observed ids into an (M,) mask
    and gathering it at every keyframe's observation table.
    """
    M = m.mp_valid.shape[0]
    q = m.kf_obs[kf_slot]                                  # (K,)
    member = jnp.zeros((M + 1,), bool).at[
        jnp.where(q >= 0, q, M)].set(True)[:M]
    obs = m.kf_obs                                          # (F, K)
    hit = jnp.where(obs >= 0, member[jnp.clip(obs, 0)], False)
    return jnp.sum(hit, axis=1).astype(jnp.int32)


def camera_frustum(cam_cfg, margin: float = 1.25):
    """Normalized-plane half-extents (nx_max, ny_max) of a pinhole
    camera, widened by `margin` so landmarks just outside the current
    view (about to enter as the camera turns) survive the gather filter."""
    nx = margin * max(cam_cfg.cx, cam_cfg.width - cam_cfg.cx) / cam_cfg.fx
    ny = margin * max(cam_cfg.cy, cam_cfg.height - cam_cfg.cy) / cam_cfg.fy
    return (float(nx), float(ny))


def gather_local_landmarks(m: MapState, num_out: int,
                           recent: int = 10, covis_kfs: int = 0,
                           covis_min: int = 5, frustum=None):
    """Mappoints observed by the `recent` most recently inserted keyframes
    plus (covis_kfs > 0) the latest keyframe's top covisible neighbors.

    Returns (Xw (L,3), desc (L,8), ids (L,), valid (L,)) with L = num_out.
    The two components mirror the reference's tracking set — covisibility
    walk from the latest keyframe fused with the 10 latest frames'
    mappoints (ref src/pipeline.cpp:167-177). The covisibility half is
    what keeps tracking INSIDE the old map after a loop closure: the
    mappoint merge seeds shared observations at the seam, each new
    keyframe then adopts its neighbors' landmarks, and the shared-
    observation wave rides forward around the loop — so re-traversed
    regions reuse old landmarks instead of duplicating them, and the
    loop detector's covisibility exclusion suppresses noisy re-closures
    of an already-consistent seam (with recency only, lap-2 keyframes
    never became covisible with lap-1 and every re-detection injected a
    fresh noisy pose-graph edge).

    frustum: optional (nx_max, ny_max) normalized-plane half-extents of
    the camera. When given, the covisibility half keeps only landmarks
    IN VIEW of the latest keyframe (positive depth, |x/z| <= nx_max,
    |y/z| <= ny_max — the behind-camera/out-of-frame cull of the
    reference's ProjectionMatch, ref src/matcher.cpp:143-160). Without
    it, a covisible neighbor's whole observation row competes for the
    fixed num_out slots and out-of-view old landmarks can displace the
    current-location ones the tracker actually needs (measured: tracking
    quality collapsed 79 -> 15 on the revisit circle).

    Truncation (rare under claim-grid suppression) keeps established
    landmarks — see unique_prioritized.
    """
    F = m.kf_valid.shape[0]
    # rank keyframes by insertion recency: frame_id, invalid -> -1
    fid = jnp.where(m.kf_valid, m.kf_frame_id, -1)
    _, recent_slots = jax.lax.top_k(fid, recent)        # newest first
    ids = m.kf_obs[recent_slots].reshape(-1)            # (recent*K,)
    if covis_kfs > 0:
        K = m.kf_obs.shape[1]
        latest = jnp.argmax(fid)
        # anchor-ownership covisibility: count, per keyframe, how many of
        # the latest keyframe's observed landmarks IT ANCHORS. One small
        # gather (K indices) + a fused (K, F) compare-reduce — exact
        # covisibility (covisibility_counts) needs a gather with F*K
        # indices inside the scan. Anchors are the canonical owners, so
        # this ranks the same
        # old-map neighbors; it only undercounts keyframes that merely
        # re-observe (which the recency half already covers).
        q = m.kf_obs[latest]                              # (K,)
        anc = jnp.where(q >= 0, m.mp_ref_kf[jnp.clip(q, 0)], -1)
        cov = jnp.sum(anc[:, None] ==
                      jnp.arange(F, dtype=jnp.int32)[None, :],
                      axis=0).astype(jnp.int32)           # (F,)
        in_recent = jnp.zeros((F,), bool).at[recent_slots].set(True)
        cov = jnp.where(m.kf_valid & ~in_recent, cov, 0)
        cov_top, cov_slots = jax.lax.top_k(cov, covis_kfs)
        cids = m.kf_obs[cov_slots].reshape(-1)          # (covis_kfs*K,)
        keep = jnp.repeat(cov_top >= covis_min, K) & (cids >= 0)
        if frustum is not None:
            safe = jnp.where(keep, cids, 0)
            Xc = se3.transform(m.kf_T_cw[latest],
                               mappoint_positions_at(m, safe))
            z = Xc[..., 2]
            zs = jnp.maximum(z, 1e-6)
            keep = keep & (z > 0.05) & \
                (jnp.abs(Xc[..., 0] / zs) <= frustum[0]) & \
                (jnp.abs(Xc[..., 1] / zs) <= frustum[1])
        cids = jnp.where(keep, cids, -1)
        ids = jnp.concatenate([ids, cids])
    uniq = unique_prioritized(ids, num_out, m)
    ok = uniq < m.mp_valid.shape[0]
    safe = jnp.where(ok, uniq, 0)
    Xw = mappoint_positions_at(m, safe)
    valid = ok & m.mp_valid[safe]
    return Xw, m.mp_desc[safe], safe, valid


def mappoint_positions_at(m: MapState, ids: jnp.ndarray) -> jnp.ndarray:
    """World positions for a subset of mappoint ids (gather version)."""
    norm = m.kf_norm[m.mp_ref_kf[ids], m.mp_kpt[ids]]
    invd = jnp.maximum(m.mp_invd[ids], 1e-3)
    ray = jnp.concatenate([norm, jnp.ones_like(invd)[:, None]], axis=-1)
    Xc = ray / invd[:, None]
    T_wc = se3.inv(m.kf_T_cw[m.mp_ref_kf[ids]])
    return se3.transform(T_wc, Xc)
