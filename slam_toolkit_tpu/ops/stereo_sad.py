"""Left-anchored SAD stereo: per-keypoint correlation sweep.

The reference finds stereo depth by fully extracting ORB on the right
image and descriptor-matching along row bands (ref src/frame.cpp:384-389,
src/matcher.cpp:54-132) — on this engine that meant a second pyramid +
FAST + BRIEF + a dense (K, K) Hamming match per keyframe, then a third
pass to refine disparity to subpixel. This module replaces all of it
with the classic block-matching formulation (what cv::StereoBM computes,
restricted to the keypoints we care about): for each LEFT keypoint,
sweep an 11x11 SAD window across the disparity range on the rectified
right row, take the subpixel parabola minimum, and gate on uniqueness.
Same product (subpixel right-x per left keypoint), ~5x less work, and
no dependence on right-image feature repeatability.

One gather of the left windows and right strips feeds a fused
abs-diff-sum over all shifts; argmin / parabola / uniqueness run
vectorized on the (K, NS) curve.
"""

from __future__ import annotations

import jax.numpy as jnp

WIN = 5                  # half window -> 11x11
PAD = 1                  # parabola neighbors beyond the disparity range


def _shifts(max_disp: int) -> int:
    return max_disp + 2 * PAD + 1      # s = 0 .. max_disp + 2


def _strip_w(max_disp: int) -> int:
    return (2 * WIN + 1) + max_disp + 2 * PAD


def _sad_from_blocks(patch_l: jnp.ndarray, strip: jnp.ndarray,
                     ns: int) -> jnp.ndarray:
    """(K, 11, 11) x (K, 11, SW) -> (K, NS) SAD curves."""
    acc = None
    side = 2 * WIN + 1
    for c in range(side):
        d = jnp.abs(strip[:, :, c:c + ns] - patch_l[:, :, c:c + 1])
        acc = d if acc is None else acc + d
    return jnp.sum(acc, axis=1)


def sad_curve(img_l, img_r, ys0, xl0, xs0, max_disp):
    """(K, NS) SAD of each left 11x11 window against every shift of its
    right-image strip (corners pre-clamped by the caller)."""
    from slam_toolkit_tpu.ops.patches import gather_blocks
    side = 2 * WIN + 1
    patch_l = gather_blocks(img_l, ys0, xl0, side, side)
    strip = gather_blocks(img_r, ys0, xs0, side, _strip_w(max_disp))
    return _sad_from_blocks(patch_l, strip, _shifts(max_disp))


def match(img_left: jnp.ndarray, img_right: jnp.ndarray,
          xy: jnp.ndarray, valid: jnp.ndarray, max_disp: int = 100,
          uniqueness: float = 0.15):
    """Subpixel right-x for each left keypoint on rectified stereo.

    Returns (x_right (K,) f32, ok (K,) bool). ok requires: a SAD minimum
    strictly inside the disparity range, a uniqueness margin vs the best
    SAD outside +/-1 shift (cv::StereoBM's uniquenessRatio), positive
    disparity, and an unclamped correlation window.
    """
    h, w = img_left.shape
    side = 2 * WIN + 1
    sw = _strip_w(max_disp)
    ns = _shifts(max_disp)

    xl = jnp.round(xy[:, 0]).astype(jnp.int32)
    yl = jnp.round(xy[:, 1]).astype(jnp.int32)
    ys0r = yl - WIN
    xl0r = xl - WIN
    xs0r = xl - (max_disp + WIN + PAD)
    ys0 = jnp.clip(ys0r, 0, h - side)
    xl0 = jnp.clip(xl0r, 0, w - side)
    xs0 = jnp.clip(xs0r, 0, w - sw)
    clamped = (ys0 != ys0r) | (xl0 != xl0r)

    sad = sad_curve(img_left, img_right, ys0, xl0, xs0, max_disp)

    col = jnp.arange(ns, dtype=jnp.float32)[None, :]
    inner = (col >= 1) & (col <= ns - 2)
    big = jnp.float32(1e12)
    sad_in = jnp.where(inner, sad, big)
    best = jnp.argmin(sad_in, axis=1)                       # (K,)
    bc = best.astype(jnp.float32)[:, None]

    def pick(off):
        return jnp.sum(jnp.where(col == bc + off, sad, 0.0), axis=1)

    c0, c1, c2 = pick(-1.0), pick(0.0), pick(1.0)
    denom = c0 + c2 - 2.0 * c1
    delta = jnp.where(denom > 1e-6, 0.5 * (c0 - c2) / jnp.maximum(denom, 1e-6),
                      0.0)
    delta = jnp.clip(delta, -1.0, 1.0)

    # uniqueness: best SAD outside the +/-1 neighborhood of the minimum
    away = jnp.abs(col - bc) > 1.0
    second = jnp.min(jnp.where(inner & away, sad, big), axis=1)
    uniq_ok = second > c1 * (1.0 + uniqueness) + 1e-3

    s_sub = bc[:, 0] + delta
    disp = (xl - xs0).astype(jnp.float32) - s_sub - WIN
    x_right = xl.astype(jnp.float32) - disp
    ok = (valid & uniq_ok & ~clamped & (disp > 0.25) &
          (disp <= float(max_disp)) & (best >= 1) & (best <= ns - 2))
    return jnp.where(ok, x_right, 0.0), ok
