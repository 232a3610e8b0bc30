"""MapState <-> BAProblem adapter: the local-mapping step.

Plays the role of StandardLocalMapper::InitializeGraph + retrieval
(ref src/localmapper.cpp:39-120, :140-160): select the local window,
assemble the fixed-shape BA problem, solve, and write poses + inverse
depths back into the map — all as one jitted pure function.

Window selection uses keyframe recency (the W most recent keyframes,
oldest fixed as gauge, ref :62-75). Landmarks are every mappoint
observed in the window, newest-first, up to the P-slot capacity.
Results are written back exactly like the reference's RetriveStructure
(src/method.cpp:118-126): optimized Xw is re-encoded as inverse depth
along the anchor keyframe's (possibly updated) ray.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.mapping.map_state import MapState, mappoint_positions_at
from slam_toolkit_tpu.optim.local_ba import BAProblem, BAResult, solve_ba


def select_window(m: MapState, W: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(slots (W,), valid (W,)): the W most recent keyframes, newest first."""
    fid = jnp.where(m.kf_valid, m.kf_frame_id, -1)
    vals, slots = jax.lax.top_k(fid, W)
    return slots.astype(jnp.int32), vals >= 0


def select_points(m: MapState, window: jnp.ndarray, P: int):
    """Up to P distinct mappoints observed by the window keyframes.

    When the window holds more than P uniques, BA keeps ESTABLISHED
    landmarks (observed >= 2x within the window) — the ones whose BA
    residuals are actually multi-view-constrained (multi-view,
    near the gauge keyframe). Prioritizing newest-first here measurably
    destabilizes the solve (single-observation points dominate the
    slots)."""
    from slam_toolkit_tpu.mapping.map_state import unique_prioritized
    M = m.mp_valid.shape[0]
    ids = m.kf_obs[window].reshape(-1)
    uniq = unique_prioritized(ids, P, m)
    ok = uniq < M
    safe = jnp.where(ok, uniq, 0)
    return safe, ok & m.mp_valid[safe]


def select_seam_window(m: MapState, cur: jnp.ndarray, cand: jnp.ndarray,
                       W: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Both-sides window around a just-closed loop seam: the current
    and candidate keyframes (forced in) plus the keyframes most
    covisible with EITHER — after merge_mappoints the two sides share
    landmarks, so covisibility spans the seam. Newest-side poses bend
    toward the held old side via the oldest-fixed gauge that
    build_problem applies to any window."""
    from slam_toolkit_tpu.mapping.map_state import covisibility_counts
    c1 = covisibility_counts(m, cur)
    c2 = covisibility_counts(m, cand)
    score = jnp.maximum(c1, c2).astype(jnp.float32)
    score = jnp.where(m.kf_valid, score, -1.0)
    big = jnp.float32(1e9)
    score = score.at[cur].set(big).at[cand].set(big - 1.0)
    vals, slots = jax.lax.top_k(score, W)
    slots = slots.astype(jnp.int32)
    return slots, (vals > 0) & m.kf_valid[slots]


def build_problem(m: MapState, cam: StereoCamera,
                  cfg: SlamConfig, window=None,
                  win_valid=None, fixed_mask=None
                  ) -> Tuple[BAProblem, jnp.ndarray, jnp.ndarray]:
    W = cfg.local_ba.window_keyframes
    P = cfg.local_ba.max_points
    K = m.kf_obs.shape[1]
    if window is None:
        window, win_valid = select_window(m, W)
    pt_ids, pt_valid = select_points(m, window, P)

    # invert the observation table: kpt_at[w, p] = keypoint index of
    # point p in window keyframe w (-1 = unobserved), as one dense
    # (W, K, P) compare-reduce that XLA fuses into one pass, instead of
    # a rank-table gather over the 16k observation ids followed by 5
    # (W, P) scatters (ROADMAP S9 A/Bs the two on the GPU). max() over
    # k matches the scatter's last-write-wins on the
    # (impossible-by-construction) duplicate.
    obs_ids = m.kf_obs[window]                         # (W, K)
    match = ((obs_ids[:, :, None] == pt_ids[None, None, :]) &
             (obs_ids >= 0)[:, :, None] & pt_valid[None, None, :])
    k_iota = jnp.arange(K, dtype=jnp.int32)
    kpt_at = jnp.max(jnp.where(match, k_iota[None, :, None], -1),
                     axis=1)                           # (W, P)
    obs_mask = kpt_at >= 0
    safe_kpt = jnp.maximum(kpt_at, 0)

    # ONE packed (W, P, 5) gather for every per-observation channel
    # (z_norm x/y, right-x, inv_sigma, has_stereo) instead of three
    # separate take_along_axis calls.
    norm = m.kf_norm[window]                           # (W, K, 2)
    rxn = m.kf_right_x_norm[window]                    # (W, K)
    sigma2_n = m.kf_sigma2[window] / (cam.left.fx * cam.left.fx)
    packed = jnp.concatenate([
        norm, rxn[..., None],
        jax.lax.rsqrt(jnp.maximum(sigma2_n, 1e-12))[..., None],
        m.kf_has_stereo[window].astype(jnp.float32)[..., None],
    ], axis=-1)                                        # (W, K, 5)
    got = jnp.take_along_axis(
        packed, safe_kpt[:, :, None], axis=1)          # (W, P, 5)
    z = jnp.where(obs_mask[:, :, None], got[:, :, :3], 0.0)
    inv_sigma = jnp.where(obs_mask, got[:, :, 3], 1.0)
    stereo_mask = obs_mask & (got[:, :, 4] > 0.5)

    Xw = mappoint_positions_at(m, pt_ids)
    if fixed_mask is None:
        # gauge: the OLDEST valid keyframe in the window is fixed
        # (ref :62-75); if only one KF exists, it is fixed trivially.
        fid = jnp.where(win_valid, m.kf_frame_id[window],
                        jnp.iinfo(jnp.int32).max)
        oldest = jnp.argmin(fid)
        pose_fixed = jnp.zeros((W,), bool).at[oldest].set(True)
    else:
        # caller-supplied gauge (seam BA fixes the whole old side)
        pose_fixed = fixed_mask

    # a point anchored OUTSIDE the window stays fixed: the window can
    # lean on old structure (constant-point pose edges) but cannot drag
    # it off its out-of-window observations — the reference's fixed
    # out-of-window poses + anchor stereo edge (ref src/localmapper.cpp:
    # 86-117). Without this, a loop revisit re-using lap-1 landmarks
    # walked them meters away from their own keyframes.
    anchors = m.mp_ref_kf[pt_ids]                      # (P,)
    anchor_in_win = jnp.any(
        (anchors[:, None] == window[None, :]) & win_valid[None, :], axis=1)

    prob = BAProblem(
        T_cw=m.kf_T_cw[window],
        pose_fixed=pose_fixed | ~win_valid,
        pose_valid=win_valid,
        Xw=Xw,
        point_valid=pt_valid,
        z=z,
        inv_sigma=inv_sigma,
        obs_mask=obs_mask,
        stereo_mask=stereo_mask,
        baseline=cam.baseline,
        point_free=anchor_in_win,
    )
    return prob, window, pt_ids


def write_back(m: MapState, res: BAResult, window: jnp.ndarray,
               win_valid: jnp.ndarray, pose_fixed: jnp.ndarray,
               pt_ids: jnp.ndarray, pt_valid: jnp.ndarray) -> MapState:
    # poses
    upd = win_valid & ~pose_fixed
    new_T = jnp.where(upd[:, None, None], res.T_cw, m.kf_T_cw[window])
    kf_T_cw = m.kf_T_cw.at[window].set(new_T)

    # points: invd along anchor ray (RetriveStructure, method.cpp:118-126)
    ref = m.mp_ref_kf[pt_ids]
    z_ref = se3.transform(kf_T_cw[ref], res.Xw)[..., 2]
    invd_new = 1.0 / jnp.maximum(z_ref, 1e-3)
    # a point optimized to BEHIND its anchor (z_ref <= 0) has no valid
    # inverse-depth encoding — clamping it used to teleport the landmark
    # to 1 mm in front of the anchor, where it kept polluting matching;
    # invalidate it instead (the reference throws on negative depth,
    # src/frame.cpp:401-403 — here a mask write is the fail-safe form)
    behind = pt_valid & (z_ref <= 1e-3)
    # dump invalid writes into a padding slot (index M), then slice it off
    M = m.mp_valid.shape[0]
    dump_ids = jnp.where(pt_valid, pt_ids, M)
    mp_invd = jnp.concatenate([m.mp_invd, jnp.zeros(1)]) \
        .at[dump_ids].set(invd_new)[:M]
    kill_ids = jnp.where(behind, pt_ids, M)
    mp_valid = jnp.concatenate([m.mp_valid, jnp.zeros(1, bool)]) \
        .at[kill_ids].set(False)[:M]
    return m._replace(kf_T_cw=kf_T_cw, mp_invd=mp_invd, mp_valid=mp_valid)


def local_ba_step(m: MapState, cam: StereoCamera, cfg: SlamConfig,
                  window=None, win_valid=None, fixed_mask=None) -> MapState:
    """One local-BA pass over the current window (the mapping-thread work,
    ref src/pipeline.cpp:137-138)."""
    prob, window, pt_ids = build_problem(m, cam, cfg, window, win_valid,
                                         fixed_mask)
    res = solve_ba(prob, iters=cfg.local_ba.num_iterations,
                   huber_delta=cfg.local_ba.huber_delta,
                   lambda0=cfg.local_ba.lm_lambda0,
                   lambda_up=cfg.local_ba.lm_lambda_up,
                   lambda_down=cfg.local_ba.lm_lambda_down,
                   trim_sigma=cfg.local_ba.trim_sigma)
    # belt-and-braces: a solve that returns ANY non-finite value is
    # discarded wholesale (keep the pre-BA map). The solver guards its
    # own steps, but a single escaped NaN here poisons every later frame.
    ok = (jnp.isfinite(res.T_cw).all() & jnp.isfinite(res.Xw).all())
    res = BAResult(
        T_cw=jnp.where(ok, res.T_cw, prob.T_cw),
        Xw=jnp.where(ok, res.Xw, prob.Xw),
        cost=res.cost, edge_r2=res.edge_r2)
    return write_back(m, res, window, prob.pose_valid, prob.pose_fixed,
                      pt_ids, prob.point_valid)


def seam_ba_step(m: MapState, cur: jnp.ndarray, cand: jnp.ndarray,
                 cam: StereoCamera, cfg: SlamConfig) -> MapState:
    """Post-closure seam BA: one local-BA pass whose window straddles the
    just-closed loop (current + candidate + their covisible keyframes).

    The reference always runs local BA on the mapping thread after a
    closure (ref src/pipeline.cpp:137-138, src/localmapper.cpp:122-162);
    without it the pose graph corrects keyframe CHAINS but nothing
    re-optimizes structure around the seam, leaving the merged landmarks
    inconsistent with both sides' observations.

    Gauge: STRUCTURE-ONLY — every pose in the window is held fixed and
    only landmarks move. The pose graph + RANSAC seam measurement just
    placed the keyframes; letting reprojection BA re-move them fights
    the (more accurate) seam measurement and measurably walked the whole
    revisit off by ~1 m (low-drift circle diag: 0.73 m no-seam-BA /
    1.66 m oldest-only gauge / 0.99 m old-side-fixed gauge). What IS
    stale after a closure is the structure: merged landmarks must become
    consistent with BOTH sides' observations before the next frames
    track against them."""
    window, win_valid = select_seam_window(m, cur, cand,
                                           cfg.local_ba.window_keyframes)
    return local_ba_step(m, cam, cfg, window, win_valid,
                         fixed_mask=jnp.ones_like(win_valid))
