"""Stereo and projection matching as masked dense Hamming contractions.

Replaces ref src/matcher.cpp entirely:
- StereoMatch (:54-132): the 10px row-bucket candidate generation becomes
  an epipolar |dy| mask, the disparity gate stays, ratio test 0.5.
- ProjectionMatch (:134-209): per-mappoint FLANN radius search becomes a
  radius mask over a dense (L, K) distance matrix; behind-camera and
  out-of-image culling become mask terms; duplicate-target collisions
  keep the best distance.

Everything is shape-static: L mappoint slots x K keypoint slots, invalid
entries pushed to BIG.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from slam_toolkit_tpu.config import MatcherConfig
from slam_toolkit_tpu.geometry import camera as cam_mod
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.ops import hamming
from slam_toolkit_tpu.ops.extractor import FrameFeatures


def stereo_match(left: FrameFeatures, right: FrameFeatures,
                 cam: StereoCamera, cfg: MatcherConfig):
    """Match left keypoints to right keypoints along rectified epipolar rows.

    Returns (right_x (K,) float32 matched right x-coordinate,
             depth (K,) float32, ok (K,) bool).
    """
    dy = jnp.abs(left.xy[:, 1, None] - right.xy[None, :, 1])
    dx = left.xy[:, 0, None] - right.xy[None, :, 0]   # disparity
    # pyramid-level agreement within 1 (detection octave jitters between
    # views; an exact-equality gate rejects ~40% of true pairs)
    same_octave = jnp.abs(left.octave[:, None] - right.octave[None, :]) <= 1
    mask = (left.valid[:, None] & right.valid[None, :] &
            (dy <= cfg.stereo_max_dy) &
            (dx >= cfg.stereo_min_dx) & (dx <= cfg.stereo_max_dx) &
            same_octave)
    dist = hamming.masked_distance(left.desc, right.desc, mask)
    idx, ok = hamming.ratio_test_match(dist, cfg.ratio, cfg.max_hamming)
    # mutual-consistency: the matched right keypoint's own best left
    # keypoint must be this one (cuts the wrong-match tail that otherwise
    # injects gross stereo-depth outliers into BA)
    back = jnp.argmin(dist, axis=0)
    mutual = back[idx] == jnp.arange(idx.shape[0])
    ok = ok & mutual
    right_x = right.xy[idx, 0]
    depth = cam_mod.stereo_depth(cam, left.xy[:, 0], right_x)
    ok = ok & (depth > 0.0)
    return right_x, jnp.where(ok, depth, 0.0), ok


class ProjectionMatches(NamedTuple):
    kpt_idx: jnp.ndarray     # (L,) int32 matched keypoint per landmark
    ok: jnp.ndarray          # (L,) bool
    uv_pred: jnp.ndarray     # (L, 2) predicted pixel coords (for debugging)
    n_matches: jnp.ndarray   # () int32


def projection_match(Xw: jnp.ndarray, mp_desc: jnp.ndarray,
                     mp_valid: jnp.ndarray, frame_feats: FrameFeatures,
                     T_cw: jnp.ndarray, cam: StereoCamera,
                     cfg: MatcherConfig, radius: float) -> ProjectionMatches:
    """Match L landmarks into a frame by predicted projection.

    Implements the doubled-radius retry of the reference
    (src/posetracker.cpp:187-190) branch-free: if fewer than 8 matches
    survive at `radius`, results computed at 2*radius are selected
    instead (one distance matrix, two masks — the matrix dominates cost).
    """
    from slam_toolkit_tpu.ops.match_kernel import topk2_match

    Xc = se3.transform(T_cw, Xw)
    in_front = Xc[..., 2] > 0.05
    uv = cam_mod.project(cam.left, Xc)
    visible = mp_valid & in_front & cam_mod.in_image(cam.left, uv)

    # fused tiled kernel on CUDA (ops/match_kernel.py): Hamming + both
    # radius gates + per-row top-2 in one pass, no (L, K) matrix in
    # device memory. Validity folds into coordinates
    # (invalid entries pushed far apart so the radius gate rejects them).
    a_uv = jnp.where(visible[:, None], uv, 1e7)
    b_xy = jnp.where(frame_feats.valid[:, None], frame_feats.xy, -1e7)
    t2 = topk2_match(mp_desc, frame_feats.desc, a_uv, b_xy, radius)

    def ratio_ok(best, second):
        # track_ratio, not ratio: a pose-guided search window on
        # self-similar near texture holds many look-alikes, and the
        # strict prior-free ratio starves the map of near landmarks
        # (see MatcherConfig.track_ratio); reprojection gating
        # downstream rejects the ambiguity this admits
        return (best <= cfg.max_hamming) & (best < cfg.track_ratio * second)

    ok1 = ratio_ok(t2[:, 0], t2[:, 1])
    ok2 = ratio_ok(t2[:, 3], t2[:, 4])
    # radius choice BEFORE duplicate resolution (duplicates only shave a
    # couple of matches; running keep-best once on the selected set
    # halves the serial scatter passes)
    use_wide = jnp.sum(ok1) < 8
    idx = jnp.where(use_wide, t2[:, 5], t2[:, 2]).astype(jnp.int32)
    ok = jnp.where(use_wide, ok2, ok1)
    best = jnp.where(use_wide, t2[:, 3], t2[:, 0])
    ok = hamming.keep_best_per_target(idx, ok, best,
                                      frame_feats.desc.shape[0])
    return ProjectionMatches(kpt_idx=idx.astype(jnp.int32), ok=ok,
                             uv_pred=uv, n_matches=jnp.sum(ok))
