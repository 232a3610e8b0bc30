"""Subpixel disparity refinement via batched SAD + parabola fit.

The reference pairs integer keypoint coordinates directly
(StereoMatch, ref src/matcher.cpp:54-132), which quantizes disparity by
~1px and, at stereo depth z = fx*b/d (src/frame.cpp:391-409), produces
z^2/(fx*b) metric depth error. ORB-SLAM-family systems counter this with
a correlation sweep along the epipolar row; we implement that as K
vmapped dynamic_slice block loads (contiguous rows instead of random
element gathers), one (11, 11+2*SEARCH) strip per
keypoint, scored at all shifts via static slices, then a 3-point
parabola for the subpixel minimum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WIN = 5        # half-width of the correlation window (11x11)
SEARCH = 3     # +/- candidate integer shifts around the matched x


def _slice_blocks(img: jnp.ndarray, y0: jnp.ndarray, x0: jnp.ndarray,
                  bh: int, bw: int) -> jnp.ndarray:
    """(K,) corner coords -> (K, bh, bw) blocks (corners pre-clamped by
    the caller); one batched window gather (ops/patches.py)."""
    from slam_toolkit_tpu.ops.patches import gather_blocks
    return gather_blocks(img, y0, x0, bh, bw)


def refine_disparity(img_left: jnp.ndarray, img_right: jnp.ndarray,
                     xy_left: jnp.ndarray, x_right: jnp.ndarray,
                     valid: jnp.ndarray):
    """Refine matched right x-coordinates to subpixel precision.

    xy_left: (K, 2) integer-ish left keypoint coords; x_right: (K,) the
    descriptor-matched right x at the same row. Returns (x_right_refined,
    ok) where ok clears matches whose SAD minimum is at the search edge
    or whose correlation window had to be clamped at an image border.
    """
    h, w = img_left.shape
    n_shifts = 2 * SEARCH + 1
    side = 2 * WIN + 1

    xl = jnp.round(xy_left[:, 0]).astype(jnp.int32)
    yl = jnp.round(xy_left[:, 1]).astype(jnp.int32)
    xr = jnp.round(x_right).astype(jnp.int32)

    # left 11x11 patch (keypoints carry a >=16px extractor border, so the
    # clamp below never fires for real keypoints; it guards padded slots)
    yl0 = jnp.clip(yl - WIN, 0, h - side)
    xl0 = jnp.clip(xl - WIN, 0, w - side)
    patch_l = _slice_blocks(img_left, yl0, xl0, side, side)

    # right strip 11 x (11+2*SEARCH); clamped strips are flagged invalid
    # (the matched x can land near the border at large disparity)
    strip_w = side + 2 * SEARCH
    xr0_raw = xr - WIN - SEARCH
    xr0 = jnp.clip(xr0_raw, 0, w - strip_w)
    clamped = (xr0 != xr0_raw) | (yl0 != yl - WIN) | (xl0 != xl - WIN)
    strip = _slice_blocks(img_right, yl0, xr0, side, strip_w)

    patch_r = jnp.stack([strip[:, :, s:s + side] for s in range(n_shifts)],
                        axis=1)                        # (K, S, 11, 11)
    sad = jnp.sum(jnp.abs(patch_r - patch_l[:, None, :, :]), axis=(2, 3))

    best = jnp.argmin(sad, axis=1)
    at_edge = (best == 0) | (best == n_shifts - 1)
    bc = jnp.clip(best, 1, n_shifts - 2)
    rows = jnp.arange(xl.shape[0])
    c0 = sad[rows, bc - 1]
    c1 = sad[rows, bc]
    c2 = sad[rows, bc + 1]
    denom = c0 + c2 - 2.0 * c1
    delta = jnp.where(jnp.abs(denom) > 1e-6,
                      0.5 * (c0 - c2) / jnp.maximum(denom, 1e-6), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    x_ref = xr.astype(jnp.float32) + bc.astype(jnp.float32) - SEARCH + delta
    ok = valid & ~at_edge & ~clamped
    return jnp.where(ok, x_ref, x_right), ok
