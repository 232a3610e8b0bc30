"""FAST-16 corner detection as fully vectorized XLA ops.

Replaces the per-cell OpenCV FAST calls of the reference
(ref src/orb_extractor.cpp:769-829). Instead of a Python/C++ loop over
30x30 cells with a high->low threshold retry, we compute a dense corner
response over the whole level once (elementwise: 16 shifted views +
bit-mask arc test), 3x3 non-max suppress, then take a per-cell top-k
(ops/topk_grid.py) which plays the role of both the threshold fallback
and the octree culling (ref :539-763) — a deterministic, shape-static
equivalent with the same goal: spatially uniform keypoints ranked by
corner response.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 in angular order, (dy, dx) pairs.
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9  # contiguous run required for a corner (FAST-9/16)


def _arc_from_mask(m: jnp.ndarray) -> jnp.ndarray:
    """int32 bitmask (H, W) -> bool, True if >= ARC_LENGTH consecutive
    circle bits (with wraparound) are set — pure elementwise integer ops."""
    m2 = m | (m << 16)
    r = m2
    for k in range(1, ARC_LENGTH):
        r = r & (m2 >> k)
    return (r & 0xFFFF) != 0


def fast_response(image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST corner response map (H, W) float32; 0 where not a corner.

    Response is the sum over the circle of the excess beyond the threshold
    on the dominant (brighter/darker) side — an elementwise stand-in for
    OpenCV's max-threshold score with near-identical NMS ranking.

    Accumulates bitmasks and scores one shifted view at a time instead
    of materializing a (16, H, W) stack (HBM traffic dominates at these
    arithmetic intensities).
    """
    h, w = image.shape
    padded = jnp.pad(image, 3, mode='edge')
    mask_b = jnp.zeros(image.shape, jnp.int32)
    mask_d = jnp.zeros(image.shape, jnp.int32)
    score_b = jnp.zeros(image.shape, jnp.float32)
    score_d = jnp.zeros(image.shape, jnp.float32)
    for k, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        diff = padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - image
        b = diff > threshold
        d = diff < -threshold
        mask_b = mask_b | (b.astype(jnp.int32) << k)
        mask_d = mask_d | (d.astype(jnp.int32) << k)
        score_b = score_b + jnp.where(b, diff - threshold, 0.0)
        score_d = score_d + jnp.where(d, -diff - threshold, 0.0)
    corner_b = _arc_from_mask(mask_b)
    corner_d = _arc_from_mask(mask_d)
    return jnp.maximum(jnp.where(corner_b, score_b, 0.0),
                       jnp.where(corner_d, score_d, 0.0))


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only 3x3 local maxima (ties broken toward top-left).

    Accumulator form — no (9, H, W) stack materialization."""
    padded = jnp.pad(score, 1, mode='constant', constant_values=-1.0)
    h, w = score.shape
    maxval = None
    earlier = None
    for i, (dy, dx) in enumerate([(dy, dx) for dy in range(3)
                                  for dx in range(3)]):
        v = padded[dy:dy + h, dx:dx + w]
        maxval = v if maxval is None else jnp.maximum(maxval, v)
        if i < 4:  # row-major neighbors before the center
            e = v >= score
            earlier = e if earlier is None else (earlier | e)
    is_max = (score >= maxval) & (score > 0.0)
    return jnp.where(is_max & ~earlier, score, 0.0)


def detect(image: jnp.ndarray, threshold: float,
           border: int) -> jnp.ndarray:
    """FAST + NMS with a border mask; returns the sparse response map."""
    score = nms3x3(fast_response(image, threshold))
    h, w = image.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    valid = ((ys >= border) & (ys < h - border) &
             (xs >= border) & (xs < w - border))
    return jnp.where(valid, score, 0.0)


def dual_response(image: jnp.ndarray, thr_hi: float, thr_lo: float):
    """Both threshold responses in ONE pass over the 16 shifted views
    (the reference's 20->7 threshold fallback,
    ref src/orb_extractor.cpp:769-829). Sharing the diffs roughly halves
    the cost of calling fast_response twice. Returns (resp_hi, resp_lo),
    each identical to fast_response at that threshold."""
    h, w = image.shape
    padded = jnp.pad(image, 3, mode='edge')
    mb_hi = mb_lo = md_hi = md_lo = jnp.zeros(image.shape, jnp.int32)
    sb_hi = sd_hi = sb_lo = sd_lo = jnp.zeros(image.shape, jnp.float32)
    for k, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        diff = padded[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - image
        b_hi, d_hi = diff > thr_hi, diff < -thr_hi
        b_lo, d_lo = diff > thr_lo, diff < -thr_lo
        mb_hi = mb_hi | (b_hi.astype(jnp.int32) << k)
        md_hi = md_hi | (d_hi.astype(jnp.int32) << k)
        mb_lo = mb_lo | (b_lo.astype(jnp.int32) << k)
        md_lo = md_lo | (d_lo.astype(jnp.int32) << k)
        sb_hi = sb_hi + jnp.where(b_hi, diff - thr_hi, 0.0)
        sd_hi = sd_hi + jnp.where(d_hi, -diff - thr_hi, 0.0)
        sb_lo = sb_lo + jnp.where(b_lo, diff - thr_lo, 0.0)
        sd_lo = sd_lo + jnp.where(d_lo, -diff - thr_lo, 0.0)
    hi = jnp.maximum(jnp.where(_arc_from_mask(mb_hi), sb_hi, 0.0),
                     jnp.where(_arc_from_mask(md_hi), sd_hi, 0.0))
    lo = jnp.maximum(jnp.where(_arc_from_mask(mb_lo), sb_lo, 0.0),
                     jnp.where(_arc_from_mask(md_lo), sd_lo, 0.0))
    return hi, lo


def detect_dual(image: jnp.ndarray, thr_hi: float, thr_lo: float,
                border: int) -> jnp.ndarray:
    """One-pass dual-threshold FAST; exactly equivalent to
    where(detect(hi) > 0, detect(lo) + 1e4, detect(lo)) — NMS runs per
    threshold, then high-threshold survivors get the rank boost.

    Tried and rejected: collapsing to ONE shared NMS (boost hi-mask
    corners on the lo response, then a single nms3x3) saves one NMS pass
    but lets strong corners suppress adjacent hi-threshold survivors
    that the per-threshold NMS keeps; measured 3-seed ATE mean 0.222 m
    vs 0.176 m here — a 26% accuracy cost.
    Also tried and rejected: keeping both NMS passes but ranking hi
    corners by their LO scores (drops the hi-score accumulation, 2 of 6
    selects per shifted view). The lo score is not rank-equivalent
    (arcs differ between thresholds), the 3x3 winners among adjacent hi
    corners shift, and the calibrated tiny-world e2e ATE regresses
    0.076 -> 0.141 m."""
    resp_hi, resp_lo = dual_response(image, thr_hi, thr_lo)
    hi = nms3x3(resp_hi)
    lo = nms3x3(resp_lo)
    h, w = image.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    valid = ((ys >= border) & (ys < h - border) &
             (xs >= border) & (xs < w - border))
    eff = jnp.where(hi > 0.0, lo + 1e4, lo)
    return jnp.where(valid, eff, 0.0)
