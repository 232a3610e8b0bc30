"""Loop closing: relative pose, pose-graph correction, mappoint merge.

Replaces LoopCloser (ref src/loopcloser.cpp):
- GetRelativePose (:51-100): re-track the current keyframe against the
  candidate's mappoints with the candidate's pose as prediction, accept
  if > min_matches inliers survive the reprojection filter;
- CloseLoop (:104-220): SE(3) pose graph over all keyframes — odometry
  chain edges with anisotropic information (:113-116), the new loop edge
  plus all previously closed loops (:160-185,191), oldest keyframe fixed
  (:158) — here one jitted dense solve (optim/pose_graph.py). The
  reference must rigidly re-attach non-keyframes and recompute mappoint
  positions; our anchored inverse-depth mappoints follow their keyframes
  automatically;
- CombineNeighborMappoints (:223-299): duplicate landmarks merged by
  projection-matching loop-side mappoints into the current keyframe and
  redirecting every observation of the loser to the winner.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.frontend.matching import projection_match
from slam_toolkit_tpu.geometry import se3, sim3
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.mapping.map_state import MapState, mappoint_positions_at
from slam_toolkit_tpu.ops.extractor import FrameFeatures
from slam_toolkit_tpu.optim import pose_lm
from slam_toolkit_tpu.optim.pose_graph import (PoseGraphProblem,
                                               solve_pose_graph,
                                               solve_pose_graph_sim3)


class RelPoseResult(NamedTuple):
    T_cw: jnp.ndarray      # corrected pose of the current keyframe
    n_inliers: jnp.ndarray
    ok: jnp.ndarray
    scale: float = 1.0     # plain-float default: a jnp default here
    #                        would initialize the JAX backend at module
    #                        import
    # ^ detected relative scale current-map / candidate-map (median of
    #   matched-landmark depth ratios); 1 when too few pairs or under
    #   pure SE(3) operation. Only the Sim(3) pose graph consumes it.
    n_near: int = 0        # final inliers nearer than the depth gate —
    #                        diagnostic for the rot/trans-ambiguity
    #                        analysis (r5; see _decoupled_rt_refine)


def _kf_features(m: MapState, slot: jnp.ndarray) -> FrameFeatures:
    """Rebuild a FrameFeatures view from stored keyframe arrays."""
    k = m.kf_xy.shape[1]
    return FrameFeatures(
        xy=m.kf_xy[slot], response=jnp.zeros((k,)),
        octave=jnp.zeros((k,), jnp.int32), angle=jnp.zeros((k,)),
        sigma2=m.kf_sigma2[slot], desc=m.kf_desc[slot].reshape(-1, 8),
        valid=m.kf_kpt_valid[slot])


def _candidate_group_landmarks(m: MapState, cur_slot: jnp.ndarray,
                               cand_slot: jnp.ndarray, cfg: SlamConfig):
    """Landmarks of the candidate + its top covisible neighbors (deduped).

    The candidate's own observation row (~one frame of mostly-distant
    points) conditions the relative-pose solve poorly: translation along
    the view axis and yaw-vs-lateral are near-unobservable, and 1-2 m
    wrong solves pass the reprojection gate with 80+ inliers. The
    reference seeds loop matching from the candidate's covisibility
    group for the same reason (ORB-SLAM2 SearchAndFuse / the group logic
    of ref src/loopdetector.cpp:92-146); the wider baseline of the
    neighbor keyframes' landmarks pins the weak directions. Neighbors
    are restricted to keyframes at least min_kf_gap insertions older
    than the CURRENT keyframe so post-merge covisibility with the
    current lap cannot leak the current frame's own structure into its
    measurement."""
    from slam_toolkit_tpu.mapping.map_state import (covisibility_counts,
                                                    unique_prioritized)
    F = m.kf_valid.shape[0]
    K = m.kf_obs.shape[1]
    nb = cfg.loop.relpose_neighbor_kfs
    ids_c = m.kf_obs[cand_slot]                     # (K,)
    if nb <= 0:
        ids = ids_c
    else:
        cov = covisibility_counts(m, cand_slot)
        fid = jnp.where(m.kf_valid, m.kf_frame_id,
                        jnp.iinfo(jnp.int32).max)
        rank = jnp.sum(fid[None, :] < fid[:, None], axis=1)
        ok_nb = m.kf_valid & (jnp.arange(F) != cand_slot) & \
            (rank <= rank[cur_slot] - cfg.loop.min_kf_gap)
        cov = jnp.where(ok_nb, cov, 0)
        cov_top, nbs = jax.lax.top_k(cov, nb)
        ids_n = m.kf_obs[nbs].reshape(-1)           # (nb*K,)
        ids_n = jnp.where(jnp.repeat(cov_top > 0, K), ids_n, -1)
        ids = jnp.concatenate([ids_c, ids_n])
    uniq = unique_prioritized(ids, cfg.loop.relpose_landmarks, m)
    ok = uniq < m.mp_valid.shape[0]
    safe = jnp.where(ok, uniq, 0)
    Xw = mappoint_positions_at(m, safe)
    valid = ok & m.mp_valid[safe]
    if not cfg.loop.relpose_stereo_aug:
        return Xw, m.mp_desc[safe], valid
    # augment with the CANDIDATE keyframe's own stereo keypoints as 3D
    # points. The curated map is effectively far-only at KITTI scale
    # (near ground points fail the self-similar-texture ratio test
    # frame to frame and are weak-culled — measured 65-74 m depth
    # percentiles on the bench clothoid's candidate group), so the loop
    # solve inherits the far-field's yaw/lateral ambiguity valley
    # (1.5 m lateral edge error at 1.03 deg through 122 inliers, r4/r5
    # dissections). The keyframe rows store ALL extracted keypoints
    # with their stereo matches (~500 near ones per frame), and at the
    # revisit the viewpoint matches the anchor's, so their descriptors
    # are directly matchable — triangulate them off the candidate's
    # stereo disparity and let them vote. The reference's loop re-track
    # equally uses the candidate FRAME's features, not only curated
    # mappoints (ref src/loopcloser.cpp:51-100 via matcher.cpp).
    norm_c = m.kf_norm[cand_slot]                        # (K, 2)
    disp_n = norm_c[:, 0] - m.kf_right_x_norm[cand_slot]
    # baseline enters via the caller's camera at solve time; disparity
    # is stored normalized, so z = baseline / disp_n. Gate tiny/negative
    # disparities (z blows up) — those rows are far points the curated
    # map already covers.
    z_c = cfg.camera.baseline / jnp.maximum(disp_n, 1e-6)
    aug_ok = (m.kf_kpt_valid[cand_slot] & m.kf_has_stereo[cand_slot]
              & (disp_n > 1e-6) & (z_c > 0.5)
              & (z_c < 2.0 * cfg.loop.relpose_depth_baselines
                 * cfg.camera.baseline))
    ray = jnp.concatenate([norm_c, jnp.ones_like(z_c)[:, None]], axis=-1)
    Xc = ray * z_c[:, None]
    Xw_aug = se3.transform(se3.inv(m.kf_T_cw[cand_slot]), Xc)
    return (jnp.concatenate([Xw, Xw_aug], axis=0),
            jnp.concatenate([m.mp_desc[safe],
                             m.kf_desc[cand_slot].reshape(-1, 8)], axis=0),
            jnp.concatenate([valid, aug_ok], axis=0))


def _ransac_consensus(T_pred: jnp.ndarray, Xw: jnp.ndarray,
                      z_norm: jnp.ndarray, ok: jnp.ndarray,
                      inlier_norm, key, n_hypotheses: int = 64,
                      sample_size: int = 4) -> jnp.ndarray:
    """Consensus mask over putative loop matches (ORB-SLAM2's Sim3-RANSAC
    counterpart). Measured on the synthetic revisit: ~35% of radius-gated
    descriptor matches can be texture-aliased and SELF-CONSISTENT at a
    meters-shifted pose (75 of 83 matches preferred a 1.7 m-wrong
    solution; the true pose satisfied only 54) — a robust-kernel LM
    converges to the contaminated optimum, so the outliers must be
    rejected by consensus BEFORE the solve. All hypotheses are one
    batched vmap: S-point Gauss-Newton re-solves from the prediction,
    scored by normalized reprojection over every putative match."""
    L = Xw.shape[0]
    probs = ok.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    idx = jax.random.choice(key, L, (n_hypotheses, sample_size),
                            replace=True, p=probs)
    from slam_toolkit_tpu.config import TrackerConfig
    cfg_h = TrackerConfig(num_iterations=3, huber_delta=1e9)

    def solve_one(sample_idx):
        res = pose_lm.optimize_pose(
            T_pred, Xw[sample_idx], z_norm[sample_idx],
            jnp.ones((sample_size,)), jnp.ones((sample_size,)), cfg_h)
        return res.T_cw

    Ts = jax.vmap(solve_one)(idx)                       # (H, 4, 4)
    Xc = jnp.einsum('hij,nj->hni', Ts[:, :3, :3], Xw) + Ts[:, None, :3, 3]
    good = Xc[..., 2] > 1e-3
    zs = jnp.where(good, Xc[..., 2], 1.0)
    err = jnp.linalg.norm(Xc[..., :2] / zs[..., None] - z_norm[None],
                          axis=-1)
    inl = good & (err < inlier_norm) & ok[None]
    best = jnp.argmax(jnp.sum(inl, axis=-1))
    return inl[best]


def _decoupled_rt_refine(T0: jnp.ndarray, Xw: jnp.ndarray,
                         z_norm: jnp.ndarray, inv_sig: jnp.ndarray,
                         use: jnp.ndarray, near: jnp.ndarray,
                         stereo, huber_delta: float,
                         rounds: int) -> jnp.ndarray:
    """Alternating rotation-only / translation-only Gauss-Newton polish
    of a loop relative-pose estimate.

    Why: the joint 6-DoF solve slides along the yaw/lateral-translation
    valley when most matched landmarks sit at similar far depths —
    measured on the bench clothoid as a 1.5 m lateral loop-edge error
    at 1.03 deg with 122 reprojection inliers (the rotation error times
    the ~60 m scene depth equals the translation error; r4/r5 seam
    dissection). The two directions have asymmetric error sources:
    ROTATION observations are depth-free (a pure rotation moves
    projections independently of landmark depth), so far points
    estimate R without bias from their noisy stereo depths; TRANSLATION
    observations scale with 1/z, so near points carry almost all the
    unbiased signal. Decoupling breaks the valley: R from the far-rich
    full set with t frozen, then t from the near set (when populated)
    with R frozen, alternated `rounds` times.

    Pure fixed-iteration function, ~(rounds * 4) small reductions over
    the landmark table — negligible next to the joint LM."""
    from slam_toolkit_tpu.optim import robust

    far = use & ~near
    rot_sel = jnp.where(jnp.sum(far) >= 20, far, use).astype(jnp.float32)
    t_sel = jnp.where(jnp.sum(use & near) >= 6, use & near,
                      use).astype(jnp.float32)
    z_r_norm, s_mask, baseline = stereo

    def gn_step(T, sel, rot: bool):
        R, t = T[:3, :3], T[:3, 3]
        Xc = Xw @ R.T + t
        good = Xc[:, 2] > 1e-3
        z = jnp.where(good, Xc[:, 2], 1.0)
        u = Xc[:, :2] / z[:, None]
        r = (u - z_norm) * inv_sig[:, None]                  # (N, 2)
        w = sel * good * robust.huber_weight(
            jnp.linalg.norm(r, axis=-1), huber_delta)
        iz = inv_sig / z
        x, y = Xc[:, 0], Xc[:, 1]
        Ju = jnp.stack([
            jnp.stack([iz, jnp.zeros_like(iz), -x * iz / z], -1),
            jnp.stack([jnp.zeros_like(iz), iz, -y * iz / z], -1)],
            axis=-2)                                          # (N, 2, 3)
        if rot:
            # R <- exp(phi) R with t frozen: dXc/dphi = -[Xc - t]x
            J = -jnp.einsum('nij,njk->nik', Ju, se3.hat(Xc - t))
        else:
            J = Ju
        H = jnp.einsum('n,nij,nik->jk', w, J, J)
        g = jnp.einsum('n,nij,ni->j', w, J, r)
        if not rot:
            # stereo right-x rows pin the view axis (only t consumes
            # depth): r_s = ((x - b)/z - u_r) * inv_sig
            rs = ((x - baseline) / z - z_r_norm) * inv_sig
            ws = sel * good * s_mask * robust.huber_weight(
                jnp.abs(rs), huber_delta)
            Js = jnp.stack([iz, jnp.zeros_like(iz),
                            -(x - baseline) * iz / z], -1)    # (N, 3)
            H = H + jnp.einsum('n,nj,nk->jk', ws, Js, Js)
            g = g + jnp.einsum('n,nj,n->j', ws, Js, rs)
        delta = jnp.linalg.solve(H + 1e-8 * jnp.eye(3), -g)
        # guard a degenerate normal system (empty selection)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        if rot:
            Rot = se3.exp(jnp.concatenate(
                [jnp.zeros(3), delta]))[:3, :3]
            T = T.at[:3, :3].set(Rot @ R)
        else:
            T = T.at[:3, 3].set(t + delta)
        return se3.normalize(T)

    T = T0
    for _ in range(rounds):
        T = gn_step(T, rot_sel, rot=True)
        T = gn_step(T, t_sel, rot=False)
    return T


def relative_pose(m: MapState, cur_slot: jnp.ndarray, cand_slot: jnp.ndarray,
                  cam: StereoCamera, cfg: SlamConfig) -> RelPoseResult:
    """Track the current KF against the candidate group's landmarks
    (ref src/loopcloser.cpp:51-100, prediction = candidate pose)."""
    Xw, desc, valid = _candidate_group_landmarks(m, cur_slot, cand_slot,
                                                 cfg)

    feats = _kf_features(m, cur_slot)
    T_pred = m.kf_T_cw[cand_slot]
    F = m.kf_valid.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(7),
                             cur_slot * F + cand_slot)

    def solve(kpt, ok, salt, T_seed):
        z_norm = m.kf_norm[cur_slot][kpt]
        sigma2 = m.kf_sigma2[cur_slot][kpt] / (cam.left.fx * cam.left.fx)
        consensus = _ransac_consensus(
            T_seed, Xw, z_norm, ok,
            cfg.tracker.reprojection_px / cam.left.fx,
            jax.random.fold_in(key, salt))
        # keep the raw set if consensus collapsed (degenerate samples)
        use_c = jnp.where(jnp.sum(consensus) >= 6, consensus, ok)
        use = use_c
        # depth-gate the SOLVE to near landmarks when enough exist
        # (ORB-SLAM2's close/far stereo split at 40 baselines): far
        # landmarks carry large BIASED stereo-depth errors (disparity
        # quantization: +-0.25 px at 2 px disparity is +-12% of z) and
        # drag the pose along the rotation-translation ambiguity
        # valley — measured as a 1.5 m loop-edge error at 1.03 deg with
        # 122 "inliers" on the KITTI-scale bench clothoid (r4 seam
        # dissection; the seam offset equals the edge error). Near
        # points pin the translation; the far set still votes through
        # the consensus mask and the final inlier count.
        z_pred = (jnp.einsum('ij,nj->ni', T_seed[:3, :3], Xw)
                  + T_seed[:3, 3])[:, 2]
        near = z_pred < cfg.loop.relpose_depth_baselines * cam.baseline
        use_near = use & near
        # gate threshold is its own knob (relpose_near_min), decoupled
        # from the ACCEPTANCE threshold: even 15 near points pin
        # translation better than 100 far ones, while acceptance still
        # counts the full inlier set below (r5)
        use = jnp.where(jnp.sum(use_near) >= cfg.loop.relpose_near_min,
                        use_near, use)
        # stereo rows where the current keyframe has a right-image match:
        # a loop edge from pure reprojection on mostly-distant points
        # leaves view-axis translation near-unobservable (measured 1-2.4 m
        # errors passing 80+ inliers); the right-x residual pins it
        # (the reference anchors scale the same way,
        # ref src/method.cpp:43-57)
        stereo = (m.kf_right_x_norm[cur_slot][kpt],
                  m.kf_has_stereo[cur_slot][kpt].astype(jnp.float32),
                  cam.baseline)
        res = pose_lm.optimize_pose(T_seed, Xw, z_norm, sigma2, use,
                                    cfg.tracker, stereo=stereo)
        T_est = res.T_cw
        if cfg.loop.relpose_rt_rounds > 0:
            # refine over the full consensus set (rotation needs the
            # far-rich population even when the joint solve was
            # near-gated)
            T_est = _decoupled_rt_refine(
                T_est, Xw, z_norm,
                jax.lax.rsqrt(jnp.maximum(sigma2, 1e-12)), use_c,
                near, stereo, cfg.tracker.huber_delta,
                cfg.loop.relpose_rt_rounds)
        inlier, depth = pose_lm.reprojection_inliers(
            cam.left, T_est, Xw, m.kf_xy[cur_slot][kpt], use,
            cfg.tracker.reprojection_px)
        return T_est, jnp.sum(inlier), _loop_scale(
            m, cur_slot, kpt, inlier, depth, cfg), \
            jnp.sum(inlier & near)

    # 2x the tracking radius: the prediction here carries the full
    # accumulated loop drift, not one frame of motion
    match = projection_match(Xw, desc, valid, feats, T_pred, cam,
                             cfg.matcher, 1.0 * cfg.matcher.projection_radius)
    T_proj, n_proj, s_proj, nn_proj = solve(match.kpt_idx, match.ok, 0,
                                            T_pred)

    # FeatureVector-equivalent fallback: the reference seeds loop
    # matching from DBoW2 node groups (TemplatedVocabulary.h:135-146 via
    # matcher SearchByBoW), which needs NO pose prior — so it survives
    # drift beyond any projection radius. The dense form of "match
    # within a vocabulary node" is simply the full masked Hamming matmul
    # with a mutual-consistency check; tree pruning buys nothing when
    # the whole (K, K) product is one matmul.
    from slam_toolkit_tpu.ops import hamming
    gmask = valid[:, None] & feats.valid[None, :]
    dist = hamming.masked_distance(desc, feats.desc, gmask)
    gidx, gok = hamming.ratio_test_match(dist, cfg.matcher.ratio,
                                         cfg.matcher.max_hamming)
    back = jnp.argmin(dist, axis=0)
    gok = gok & (back[gidx] == jnp.arange(gidx.shape[0]))
    gok = hamming.keep_best_per_target(
        gidx, gok, dist[jnp.arange(gidx.shape[0]), gidx],
        feats.desc.shape[0])
    T_glob, n_glob, s_glob, nn_glob = solve(gidx, gok, 1, T_pred)

    # prefer the projective solve (tighter gating); fall back to the
    # global solve when projection found too little and global did better
    use_glob = (n_proj < cfg.loop.min_matches) & (n_glob > n_proj)
    T = jnp.where(use_glob, T_glob, T_proj)
    n = jnp.where(use_glob, n_glob, n_proj)
    s = jnp.where(use_glob, s_glob, s_proj)
    nn = jnp.where(use_glob, nn_glob, nn_proj)

    # re-match from the SOLVED pose (selection-bias removal; see
    # LoopConfig.relpose_refine_rounds). The first projection match only
    # finds landmarks whose true projection lies within the radius of
    # the DRIFT-predicted one — a biased subset whose solve is dragged
    # toward the prediction along the yaw/lateral ambiguity valley (the
    # r5 seam dissection's 1.5 m lateral edge error at 1.03 deg through
    # 122 inliers — the decoupled-refine A/B proved the optimizer
    # converges; the matches themselves were biased). Re-matching around
    # projections at the solved pose recovers the unbiased set, exactly
    # the reference flow's second SearchByProjection pass.
    # refine ONLY solves that already pass the acceptance gate: the
    # re-match exists to DE-BIAS an accepted edge, not to rescue a
    # failed candidate — re-matching around a wrong solve with a tight
    # radius manufactures self-consistent support (measured on the bench
    # clothoid: the 34-inlier failed candidate "improved" to 46 inliers
    # at a 4.3 m-wrong edge and stole the closure from the genuine
    # 122-inlier candidate one keyframe later)
    accepted0 = n >= cfg.loop.min_matches
    for r in range(cfg.loop.relpose_refine_rounds):
        radius = cfg.loop.relpose_refine_radius * \
            cfg.matcher.projection_radius
        m2 = projection_match(Xw, desc, valid, feats, T, cam,
                              cfg.matcher, radius)
        T2, n2, s2, nn2 = solve(m2.kpt_idx, m2.ok, 2 + r, T)
        apply = accepted0 & (n2 >= cfg.loop.min_matches)
        T = jnp.where(apply, T2, T)
        n = jnp.where(apply, n2, n)
        s = jnp.where(apply, s2, s)
        nn = jnp.where(apply, nn2, nn)

    return RelPoseResult(T_cw=T, n_inliers=n,
                         ok=n >= cfg.loop.min_matches,
                         scale=s, n_near=nn)


def _loop_scale(m: MapState, cur_slot, kpt, inlier, d_cand, cfg):
    """Relative scale current-map / candidate-map from matched-landmark
    depth ratios (the job ORB-SLAM's Horn-based Sim3 solver does for
    monocular loop closures). For each inlier match, the matched current
    keypoint may already observe a current-side landmark: compare its
    depth in the current keyframe (drifted local scale) with the
    candidate landmark's depth in the re-tracked frame (candidate
    scale). The masked median ratio is the scale estimate; 1.0 when
    fewer than cfg.loop.min_scale_pairs pairs exist. Skipped entirely
    (constant 1.0, no gathers/sort traced) under pure SE(3) operation,
    where the estimate is never consumed."""
    if cfg.loop.pose_graph_group != "sim3":
        return jnp.float32(1.0)
    ids_cur = m.kf_obs[cur_slot][kpt]                     # (L,)
    safe_cur = jnp.where(ids_cur >= 0, ids_cur, 0)
    pair_ok = inlier & (ids_cur >= 0) & m.mp_valid[safe_cur]
    Xw_cur = mappoint_positions_at(m, safe_cur)
    d_cur = se3.transform(m.kf_T_cw[cur_slot], Xw_cur)[..., 2]
    pair_ok = pair_ok & (d_cur > 1e-3) & (d_cand > 1e-3)
    ratio = d_cur / jnp.maximum(d_cand, 1e-3)
    n_pairs = jnp.sum(pair_ok)
    # masked median: invalid -> +inf, take the (n-1)//2-th order stat
    r_sorted = jnp.sort(jnp.where(pair_ok, ratio, jnp.inf))
    med = r_sorted[jnp.maximum(n_pairs - 1, 0) // 2]
    # clamp to the stereo prior: a stereo rig observes absolute scale
    # every frame, so REAL map scale drift is bounded to a few percent;
    # an unclamped estimate applies whatever the (drift-distorted)
    # matched structure says — measured on the fig8 bench as a 0.815
    # scale on a 137-inlier mid-lap closure that rescaled every
    # anchored depth by 18.5% and wrecked the map. Monocular operation
    # (where Sim3 scale genuinely floats) would raise max_scale_drift.
    c = cfg.loop.max_scale_drift
    med = jnp.clip(med, 1.0 / (1.0 + c), 1.0 + c)
    return jnp.where(n_pairs >= cfg.loop.min_scale_pairs, med, 1.0)


def relocalize_frame(m: MapState, frame_feats: FrameFeatures,
                     frame_norm: jnp.ndarray, cand_slot: jnp.ndarray,
                     cam: StereoCamera, cfg: SlamConfig) -> RelPoseResult:
    """Relocalize a (non-key)frame against a candidate keyframe's
    landmarks — the engine's recovery path after lost tracking (absent
    from the reference, which always trusts constant velocity)."""
    ids = m.kf_obs[cand_slot]
    safe = jnp.where(ids >= 0, ids, 0)
    valid = (ids >= 0) & m.mp_valid[safe]
    Xw = mappoint_positions_at(m, safe)
    desc = m.mp_desc[safe]
    T_pred = m.kf_T_cw[cand_slot]
    match = projection_match(Xw, desc, valid, frame_feats, T_pred, cam,
                             cfg.matcher, 2.0 * cfg.matcher.projection_radius)
    kpt = match.kpt_idx
    z_norm = frame_norm[kpt]
    sigma2 = frame_feats.sigma2[kpt] / (cam.left.fx * cam.left.fx)
    res = pose_lm.optimize_pose(T_pred, Xw, z_norm, sigma2, match.ok,
                                cfg.tracker)
    inlier, _ = pose_lm.reprojection_inliers(
        cam.left, res.T_cw, Xw, frame_feats.xy[kpt], match.ok,
        cfg.tracker.reprojection_px)
    n = jnp.sum(inlier)
    # relocalization has its own (laxer) gate: min_matches guards the
    # POSE GRAPH against weak loop edges, but a 25-inlier re-track is
    # far better than staying on a blind constant-velocity prediction
    return RelPoseResult(T_cw=res.T_cw, n_inliers=n,
                         ok=n >= cfg.loop.reloc_min_matches)


def loop_edge_measurement(m: MapState, cand_slot: jnp.ndarray,
                          T_cur_loop: jnp.ndarray, scale,
                          cfg: SlamConfig) -> jnp.ndarray:
    """The pose-graph measurement for a detected loop: the re-tracked
    current pose relative to the candidate. Under "sim3" it carries the
    detected scale drift as a similarity [[s*R, s*t], [0, 1]] — the
    true relative pose expressed in the current (drifted) local scale,
    so at the optimum S_cur = C . S_cand has scale s and to_se3's t/s
    restores the metric pose. Used both by close_loop and for the
    closed-loops memory ring (the recorded edge must match what the
    solver consumed)."""
    rel = se3.compose(T_cur_loop, se3.inv(m.kf_T_cw[cand_slot]))
    if cfg.loop.pose_graph_group != "sim3":
        return rel
    s = jnp.asarray(scale, rel.dtype)
    return sim3.make(rel[..., :3, :3], s[..., None] * rel[..., :3, 3], s)


def close_loop(m: MapState, cur_slot: jnp.ndarray, cand_slot: jnp.ndarray,
               T_cur_loop: jnp.ndarray, prev_loops_i: jnp.ndarray,
               prev_loops_j: jnp.ndarray, prev_loops_T: jnp.ndarray,
               prev_loops_valid: jnp.ndarray,
               cfg: SlamConfig, tier: int = 0,
               loop_scale=1.0, loop_weight=1.0,
               prev_loops_w: jnp.ndarray | None = None) -> MapState:
    """Pose-graph correction over all keyframes (ref :104-220).

    prev_loops_*: fixed-capacity memory of earlier closures (slot pairs
    and measured relative transforms), mirroring closed_loops_ (:191).

    tier (static): size of the COMPACT pose-graph problem. The solver's
    dense normal equations scale as (6*N)^3; solving over the whole
    1024-slot ring is ~(1024/N)^3 times the work when only a few dozen
    keyframes exist. The caller picks the smallest tier >= the live keyframe
    count; valid keyframes are gathered age-ordered into a (tier,)
    problem and the optimized poses scattered back. tier<=0 or
    tier>=F solves over the full ring (identical result, just without
    the compaction permutation).

    cfg.loop.pose_graph_group == "sim3" switches to the 7-DoF
    essential-graph correction (the reference's own TODO,
    ref src/loopcloser.cpp:107): the loop edge carries loop_scale (the
    detected current/candidate scale ratio, RelPoseResult.scale),
    optimized similarities convert back as [R, t/s], and anchored
    inverse depths rescale with their anchor keyframes (invd' = invd*s,
    since a landmark's metric depth shrinks by 1/s when its keyframe's
    local scale s is divided out). prev_loops_T entries are whatever
    loop_edge_measurement produced at record time (similarities here).
    """
    F = m.kf_valid.shape[0]
    if tier <= 0 or tier > F:
        tier = F
    # order keyframes by frame id; valid KFs first by age
    fid = jnp.where(m.kf_valid, m.kf_frame_id, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(fid)
    n_valid = jnp.sum(m.kf_valid)
    # compact index of each ring slot (its age rank)
    rank = jnp.zeros((F,), jnp.int32).at[order].set(
        jnp.arange(F, dtype=jnp.int32))

    sel = order[:tier]                              # ring slots, oldest first
    valid_c = jnp.arange(tier) < n_valid
    T_ring = m.kf_T_cw                               # pre-correction poses
    Tc_pre = T_ring[sel]

    # chain edges: compact e -> e+1 for e < n_valid-1
    # (measured BEFORE the rigid pre-correction: odometry constraints)
    E_loop = prev_loops_i.shape[0]
    ei = jnp.arange(tier - 1, dtype=jnp.int32)
    ej = jnp.arange(1, tier, dtype=jnp.int32)
    chain_valid = ei < (n_valid - 1)
    T_meas_chain = se3.compose(Tc_pre[ej], se3.inv(Tc_pre[ei]))

    # the new loop edge: measurement from the re-tracked pose (carries
    # the detected scale under "sim3")
    sim3_mode = cfg.loop.pose_graph_group == "sim3"
    loop_T_new = loop_edge_measurement(m, cand_slot, T_cur_loop,
                                       loop_scale, cfg)

    # rigid pre-correction (ORB-SLAM CorrectLoop): apply the loop
    # correction dT to the recent segment so LM starts near the optimum —
    # its small-step linearization cannot execute tens-of-meters moves
    dT = se3.compose(T_cur_loop, se3.inv(T_ring[cur_slot]))
    seg = m.kf_valid & (rank > rank[cur_slot] - cfg.loop.correction_window)
    T_init = jnp.where(seg[:, None, None],
                       se3.normalize(se3.compose(dT[None], T_ring)), T_ring)
    m = m._replace(kf_T_cw=T_init)

    # loop-edge endpoints mapped to compact indices; an endpoint outside
    # the tier (stale prev-loop slot) invalidates its edge
    li = jnp.concatenate([jnp.asarray([cand_slot], jnp.int32),
                          prev_loops_i])
    lj = jnp.concatenate([jnp.asarray([cur_slot], jnp.int32),
                          prev_loops_j])
    lv = jnp.concatenate([jnp.array([True]), prev_loops_valid])
    lv = lv & (rank[li] < tier) & (rank[lj] < tier)
    edge_i = jnp.concatenate([ei, jnp.minimum(rank[li], tier - 1)])
    edge_j = jnp.concatenate([ej, jnp.minimum(rank[lj], tier - 1)])
    edge_T = jnp.concatenate([T_meas_chain, loop_T_new[None], prev_loops_T])
    edge_valid = jnp.concatenate([chain_valid, lv])

    info_list = [cfg.loop.info_translation] * 3 + \
        [cfg.loop.info_rotation, cfg.loop.info_yaw_damp,
         cfg.loop.info_rotation]
    if sim3_mode:
        info_list.append(cfg.loop.info_scale)
    info_row = jnp.asarray(info_list, jnp.float32)
    edge_info = jnp.tile(info_row, (edge_i.shape[0], 1))
    # de-weight odometry edges whose endpoints tracked poorly (a blind /
    # lost stretch must not outvote good loop edges; the reference has no
    # tracking-failure handling at all)
    qc = m.kf_quality[sel]
    q = jnp.minimum(qc[ei], qc[ej])
    chain_scale = jnp.clip(q / (2.0 * cfg.tracker.min_matches),
                           cfg.loop.chain_quality_floor, 1.0)
    # loop edges likewise weighted by measurement quality (inlier count
    # of the relative-pose solve): a barely-accepted edge must not
    # outvote a 3x-stronger one (ref weighs all loops equally)
    if prev_loops_w is None:
        prev_loops_w = jnp.ones((E_loop,), jnp.float32)
    # REPLAYED edges carry extra information weight: a replayed loop is
    # a seam that was already measured, accepted AND corrected — the
    # poses around it have been made consistent with it, so a later
    # closure's correction should deform the graph elsewhere rather
    # than drag the closed seam apart through the odometry chain.
    # Measured on the CPU figure-eight (2 closures): lap-2 seam
    # degradation under the second correction 0.75 -> 1.31 m at
    # boost=1; LoopConfig.replay_edge_boost has the swept values.
    loop_w = jnp.concatenate([
        jnp.asarray([loop_weight], jnp.float32),
        prev_loops_w * cfg.loop.replay_edge_boost])
    scale = jnp.concatenate([chain_scale, loop_w])
    edge_info = edge_info * scale[:, None]

    prob = PoseGraphProblem(
        T_cw=m.kf_T_cw[sel],
        pose_valid=valid_c,
        pose_fixed=(jnp.arange(tier) == 0) | ~valid_c,
        edge_i=edge_i, edge_j=edge_j, edge_T_ji=edge_T,
        edge_info=edge_info, edge_valid=edge_valid)
    if sim3_mode:
        # SE3 inits / chain measurements ARE unit-scale similarities —
        # the matrices pass through unlifted
        S_opt = solve_pose_graph_sim3(prob,
                                      iters=cfg.loop.posegraph_iterations)
        T_opt = sim3.to_se3(S_opt)
        s_c = jnp.where(valid_c, sim3.scale_of(S_opt), 1.0)
        s_ring = jnp.ones((F,), s_c.dtype).at[sel].set(s_c)
        # anchored inverse depths follow their keyframes' scale
        invd = jnp.where(m.mp_valid,
                         m.mp_invd * s_ring[m.mp_ref_kf], m.mp_invd)
        m = m._replace(mp_invd=invd)
    else:
        T_opt = solve_pose_graph(prob,
                                 iters=cfg.loop.posegraph_iterations)
    new_T = m.kf_T_cw.at[sel].set(
        jnp.where(valid_c[:, None, None], T_opt, m.kf_T_cw[sel]))
    return m._replace(kf_T_cw=new_T)


def merge_mappoints(m: MapState, cur_slot: jnp.ndarray,
                    cand_slot: jnp.ndarray, cam: StereoCamera,
                    cfg: SlamConfig) -> MapState:
    """Merge duplicate landmarks after closure (ref :223-299).

    Candidate-side mappoints are projection-matched into the current
    keyframe at the tight loop radius; where the matched keypoint already
    observes a different landmark, the candidate-side one (older) wins
    and every observation of the loser is redirected to it.
    """
    ids_cand = m.kf_obs[cand_slot]
    safe = jnp.where(ids_cand >= 0, ids_cand, 0)
    valid = (ids_cand >= 0) & m.mp_valid[safe]
    Xw = mappoint_positions_at(m, safe)
    desc = m.mp_desc[safe]
    feats = _kf_features(m, cur_slot)
    match = projection_match(Xw, desc, valid, feats, m.kf_T_cw[cur_slot],
                             cam, cfg.matcher, cfg.matcher.loop_radius)
    kpt = match.kpt_idx
    existing = m.kf_obs[cur_slot][kpt]             # current landmark at kpt
    winner = safe                                   # candidate-side id
    loser = existing
    do_merge = match.ok & (existing >= 0) & (existing != winner)

    M = m.mp_valid.shape[0]
    K = m.kf_obs.shape[1]
    # a winner that is itself a LOSER of another row this pass would be
    # invalidated while observations are redirected to it — exclude such
    # rows (a later closure pass can still merge them)
    loser_flag = jnp.zeros((M + 1,), bool) \
        .at[jnp.where(do_merge, loser, M)].set(True)[:M]
    do_merge = do_merge & ~loser_flag[winner]

    # remap table loser -> winner (identity elsewhere); masked writes land
    # in a padding slot M that is sliced off afterwards
    dump = jnp.where(do_merge, loser, M)
    remap = jnp.concatenate([jnp.arange(M, dtype=jnp.int32),
                             jnp.zeros(1, jnp.int32)])
    remap = remap.at[dump].set(winner)
    remap = jnp.concatenate([remap[:M], jnp.array([-1], jnp.int32)])  # id -1
    kf_obs = remap[jnp.where(m.kf_obs >= 0, m.kf_obs, M)]
    mp_valid = jnp.concatenate([m.mp_valid, jnp.zeros(1, bool)]) \
        .at[dump].set(False)[:M]

    # unmatched current keypoints observing nothing can adopt the
    # candidate landmark directly (SetMappoitIfEmpty, ref :254-261)
    adopt = match.ok & (existing < 0)
    obs_row = jnp.concatenate([kf_obs[cur_slot], jnp.zeros(1, jnp.int32)]) \
        .at[jnp.where(adopt, kpt, K)].set(winner)[:K]
    kf_obs = kf_obs.at[cur_slot].set(obs_row)

    # observation counts follow the redirects (culling reads them:
    # mapping/culling.py weak-landmark pass) — winners inherit their
    # losers' counts, losers zero out, adoptions add one
    cnt = jnp.concatenate([m.mp_obs_count, jnp.zeros(1, jnp.int32)])
    w_dump = jnp.where(do_merge, winner, M)
    cnt = cnt.at[w_dump].add(jnp.where(do_merge, cnt[dump], 0))
    cnt = cnt.at[dump].set(0)
    cnt = cnt.at[jnp.where(adopt, winner, M)].add(1)
    return m._replace(kf_obs=kf_obs, mp_valid=mp_valid,
                      mp_obs_count=cnt[:M])
