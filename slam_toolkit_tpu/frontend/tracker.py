"""The per-frame pose tracker: match -> LM -> outlier filter.

Structured like the reference's template method Track = BeforeEstimation
-> EstimatePose -> RetriveEstimation (ref src/posetracker.cpp:42-51) but
as one jittable function:

- BeforeEstimation: projection_match of local-map landmarks into the new
  frame at radius 50 (doubled branch-free if <8 matches,
  ref :181-197).
- EstimatePose: 10-iteration damped LM on the 6-DoF pose with all
  landmarks fixed (ref :53-99).
- RetriveEstimation: reprojection filter at 10px; outliers are dropped
  only if >= 8 inliers survive (ref :199-221).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.frontend.frame import FrameState
from slam_toolkit_tpu.frontend.matching import projection_match
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.ops import pose_lm_kernel
from slam_toolkit_tpu.optim import pose_lm


class TrackResult(NamedTuple):
    T_cw: jnp.ndarray         # (4, 4) estimated pose
    mp_kpt: jnp.ndarray       # (L,) int32 keypoint index per landmark
    mp_xy: jnp.ndarray        # (L, 2) matched keypoint pixel coords —
    #                           already gathered in the tracker so the
    #                           keyframe rule doesn't gather them again
    mp_inlier: jnp.ndarray    # (L,) bool landmark tracked as inlier
    n_matches: jnp.ndarray    # () int32 matches fed to LM
    n_inliers: jnp.ndarray    # () int32 inliers after filtering
    ok: jnp.ndarray           # () bool tracking healthy (>= min_matches)


def track_pose(frame: FrameState, Xw: jnp.ndarray, mp_desc: jnp.ndarray,
               mp_valid: jnp.ndarray, T_pred: jnp.ndarray,
               cam: StereoCamera, cfg: SlamConfig) -> TrackResult:
    """Estimate the frame pose against L fixed landmarks.

    Xw (L, 3) world positions, mp_desc (L, 8), mp_valid (L,) — the local
    map gathered by the caller. T_pred is the constant-velocity prediction
    (ref src/pipeline.cpp:154-166).
    """
    import jax

    m = projection_match(Xw, mp_desc, mp_valid, frame.feats, T_pred, cam,
                         cfg.matcher, cfg.matcher.projection_radius)
    kpt = m.kpt_idx
    # ONE (L, 5) table gather instead of three separate (L,)-gathers
    # (norm_xy, sigma2, xy)
    table = jnp.concatenate([frame.norm_xy, frame.feats.sigma2[:, None],
                             frame.feats.xy], axis=1)
    g = table[kpt]
    z_norm = g[:, :2]
    sigma2 = g[:, 2] / (cam.left.fx * cam.left.fx)
    xy_kpt = g[:, 3:5]
    # whole-solver kernel on CUDA devices, the plain solver elsewhere
    res = pose_lm_kernel.optimize_pose(T_pred, Xw, z_norm, sigma2, m.ok,
                                       cfg.tracker)

    # reprojection filter in *pixels* (ref ReprojectionFilter(10px),
    # src/posetracker.cpp:106-137)
    inlier, _ = pose_lm.reprojection_inliers(
        cam.left, res.T_cw, Xw, xy_kpt, m.ok, cfg.tracker.reprojection_px)
    # only erase outliers when enough inliers survive (ref :211-217)
    n_in = jnp.sum(inlier)
    keep_filtered = n_in >= cfg.tracker.min_matches
    final = jnp.where(keep_filtered, inlier, m.ok)
    return TrackResult(
        T_cw=res.T_cw,
        mp_kpt=kpt,
        mp_xy=xy_kpt,
        mp_inlier=final,
        n_matches=m.n_matches,
        n_inliers=jnp.sum(final),
        ok=jnp.sum(final) >= cfg.tracker.min_matches,
    )
