"""Per-frame state: extraction + normalization as one jitted program.

Replacement for Frame/StereoFrame construction
(ref src/frame.cpp:33-69): extract ORB features, pre-normalize all
keypoints through the camera model (:52-56), and (for keyframes) extract
the right image and stereo-match for depth (:384-409). There is no
kd-tree — radius queries downstream are dense masked distance matrices.

A frame is a pytree of fixed-shape arrays; "no keypoint in this slot"
is feats.valid == False, never a shorter array.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.geometry import camera as cam_mod
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.ops.extractor import FrameFeatures, extract


class FrameState(NamedTuple):
    """Left-image observations of one frame (K = cfg.extractor.max_keypoints)."""
    feats: FrameFeatures          # xy/response/octave/angle/sigma2/desc/valid
    norm_xy: jnp.ndarray          # (K, 2) undistorted normalized coords
    # stereo (filled by add_stereo; zeros/invalid otherwise)
    right_x_norm: jnp.ndarray     # (K,) normalized right x of the stereo match
    depth: jnp.ndarray            # (K,) stereo depth, 0 = no stereo match
    has_stereo: jnp.ndarray       # (K,) bool


def build_frame(image_left: jnp.ndarray, cam: StereoCamera,
                cfg: SlamConfig) -> FrameState:
    """Extract + normalize the left image (the every-frame hot path)."""
    feats = extract(image_left, cfg.extractor)
    norm_xy = cam_mod.pixel_to_normalized(cam.left, feats.xy)
    k = feats.xy.shape[0]
    return FrameState(
        feats=feats,
        norm_xy=jnp.where(feats.valid[:, None], norm_xy, 0.0),
        right_x_norm=jnp.zeros((k,), jnp.float32),
        depth=jnp.zeros((k,), jnp.float32),
        has_stereo=jnp.zeros((k,), bool),
    )


def add_stereo(frame: FrameState, image_left: jnp.ndarray,
               image_right: jnp.ndarray, cam: StereoCamera,
               cfg: SlamConfig) -> FrameState:
    """Extract the right image, stereo-match, refine disparity to subpixel.

    Mirrors the reference's lazy ExtractRightKeypoints (keyframes only,
    src/frame.cpp:384-389) plus a correlation-based subpixel disparity
    sweep the integer-keypoint pairing of src/matcher.cpp:54-132 lacks.
    """
    if cfg.matcher.stereo_method == "sad":
        from slam_toolkit_tpu.ops import brief, pyramid, stereo_sad
        right_x, ok = stereo_sad.match(
            image_left, image_right, frame.feats.xy, frame.feats.valid,
            max_disp=int(cfg.matcher.stereo_max_dx),
            uniqueness=cfg.matcher.stereo_uniqueness)
        if cfg.matcher.stereo_brief_gate:
            # descriptor-consistency gate: SAD proposes, one BRIEF per
            # eye at level 0 verifies — repetitive texture that fools an
            # 11x11 SAD window rarely also matches 256 BRIEF bits. (The
            # reference gets this robustness from its full right-ORB +
            # ratio test, ref src/matcher.cpp:112-128, at ~5x the cost.)
            bl = pyramid.gaussian_blur(image_left, 7,
                                       cfg.extractor.blur_sigma)
            br = pyramid.gaussian_blur(image_right, 7,
                                       cfg.extractor.blur_sigma)
            d_l = brief.upright_patch_descriptors(bl, frame.feats.xy)
            xy_r = jnp.stack([right_x, frame.feats.xy[:, 1]], axis=-1)
            d_r = brief.upright_patch_descriptors(br, xy_r)
            ham = jnp.sum(jax.lax.population_count(d_l ^ d_r), axis=-1)
            ok = ok & (ham <= cfg.matcher.max_hamming)
    else:
        from slam_toolkit_tpu.frontend.matching import stereo_match
        from slam_toolkit_tpu.ops.subpixel import refine_disparity
        right = extract(image_right, cfg.extractor)
        right_x, _, ok = stereo_match(frame.feats, right, cam, cfg.matcher)
        right_x, ok = refine_disparity(image_left, image_right,
                                       frame.feats.xy, right_x, ok)
    depth = cam_mod.stereo_depth(cam, frame.feats.xy[:, 0], right_x)
    ok = ok & (depth > 0.0)
    right_x_norm = (right_x - cam.left.cx) / cam.left.fx
    return frame._replace(
        right_x_norm=jnp.where(ok, right_x_norm, 0.0),
        depth=jnp.where(ok, depth, 0.0),
        has_stereo=ok,
    )


def backproject(frame: FrameState, T_wc: jnp.ndarray) -> jnp.ndarray:
    """World points for stereo-matched keypoints: Xw = T_wc . (ray * z)."""
    ray = jnp.concatenate(
        [frame.norm_xy, jnp.ones_like(frame.depth)[:, None]], axis=-1)
    Xc = ray * frame.depth[:, None]
    from slam_toolkit_tpu.geometry import se3
    return se3.transform(T_wc, Xc)
