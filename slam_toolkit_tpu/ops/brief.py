"""Intensity-centroid orientation + rotated BRIEF descriptors.

Counterpart of the reference's IC_Angle
(ref src/orb_extractor.cpp:77-104) and computeOrbDescriptor (:108-147):
instead of per-keypoint C++ loops we gather K patch windows at once and
reduce them as one batched array program.

The 256 sampling pairs are generated here (seeded Gaussian sampling per
the original BRIEF construction, sigma = patch/5, rejected to radius 14
so any rotation stays inside the 31x31 patch). We deliberately do NOT
reuse ORB's learned `bit_pattern_31_` table: descriptors only need to be
self-consistent within this engine (matching + our own trained
vocabulary), not binary-compatible with ORBvoc.txt.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

PATCH_RADIUS = 15
NUM_PAIRS = 256
DESC_WORDS = 8  # 256 bits as 8 x uint32


@functools.lru_cache(maxsize=1)
def sampling_pattern() -> np.ndarray:
    """Deterministic (2, 256, 2) float32 array of (x, y) sample offsets."""
    rng = np.random.default_rng(20260816)
    pts = []
    while len(pts) < NUM_PAIRS * 2:
        cand = rng.normal(0.0, PATCH_RADIUS / 2.4, size=(NUM_PAIRS, 2))
        keep = cand[np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 1.0]
        pts.extend(keep.tolist())
    arr = np.asarray(pts[:NUM_PAIRS * 2], dtype=np.float32)
    return arr.reshape(2, NUM_PAIRS, 2)


@functools.lru_cache(maxsize=1)
def _circular_moment_masks():
    """(31, 31) dx and dy weights inside the radius-15 disc."""
    d = np.arange(-PATCH_RADIUS, PATCH_RADIUS + 1)
    dx = np.broadcast_to(d[None, :], (31, 31)).astype(np.float32)
    dy = np.broadcast_to(d[:, None], (31, 31)).astype(np.float32)
    inside = (dx * dx + dy * dy) <= PATCH_RADIUS * PATCH_RADIUS + 0.5
    return dx * inside, dy * inside


def gather_patches(image: jnp.ndarray, centers_xy: jnp.ndarray,
                   radius: int = PATCH_RADIUS) -> jnp.ndarray:
    """Gather (K, 2r+1, 2r+1) patches at integer centers (x, y).

    Corners are clamped to the image; callers guarantee a detection border
    so clamping only ever touches invalid (masked) keypoints. One
    batched window gather (ops/patches.py).
    """
    from slam_toolkit_tpu.ops.patches import gather_blocks
    h, w = image.shape
    side = 2 * radius + 1
    cx = jnp.round(centers_xy[:, 0]).astype(jnp.int32)
    cy = jnp.round(centers_xy[:, 1]).astype(jnp.int32)
    y0 = jnp.clip(cy - radius, 0, h - side)
    x0 = jnp.clip(cx - radius, 0, w - side)
    return gather_blocks(image, y0, x0, side, side)


def ic_angle(image: jnp.ndarray, centers_xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation (radians) for K keypoints."""
    # moments accumulate ~900 terms: keep f32 even on the bf16 path
    patches = gather_patches(image, centers_xy).astype(jnp.float32)
    wx, wy = _circular_moment_masks()
    m10 = jnp.sum(patches * jnp.asarray(wx), axis=(1, 2))
    m01 = jnp.sum(patches * jnp.asarray(wy), axis=(1, 2))
    return jnp.arctan2(m01, m10)


@functools.lru_cache(maxsize=1)
def _int_pattern() -> np.ndarray:
    """Pattern offsets rounded to integers (the upright sampling grid)."""
    return np.round(sampling_pattern()).astype(np.int64)


def _shift2d(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """Image shifted so out[y, x] = img[y+dy, x+dx] (edge padded)."""
    h, w = img.shape
    pad = max(abs(dx), abs(dy), 1)
    p = jnp.pad(img, pad, mode='edge')
    return p[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def dense_descriptor_map(blurred: jnp.ndarray) -> jnp.ndarray:
    """Upright BRIEF at EVERY pixel: (H, W, 8) packed uint32.

    The per-keypoint gather formulation costs ~0.5M random scalar
    gathers per frame. Densely, each of the 256 pattern comparisons is
    a shifted-image compare (pure elementwise),
    bit-packed with shifts/ors; keypoint descriptors then cost one
    8-word row gather each. Identical bits to compute_descriptors at
    angle 0 for integer keypoint coordinates.
    """
    pat = _int_pattern()                             # (2, 256, 2) ints
    words = []
    for widx in range(DESC_WORDS):
        acc = jnp.zeros(blurred.shape, jnp.uint32)
        for j in range(32):
            k = widx * 32 + j
            ax, ay = int(pat[0, k, 0]), int(pat[0, k, 1])
            bx, by = int(pat[1, k, 0]), int(pat[1, k, 1])
            bit = (_shift2d(blurred, ax, ay) <
                   _shift2d(blurred, bx, by)).astype(jnp.uint32)
            acc = acc | (bit << j)
        words.append(acc)
    return jnp.stack(words, axis=-1)


@functools.lru_cache(maxsize=1)
def _pick_matrix() -> np.ndarray:
    """(31*31, 256) f32: column k = e[flat(a_k)] - e[flat(b_k)]."""
    r = PATCH_RADIUS
    side = 2 * r + 1
    pat = _int_pattern()
    idx_a = (pat[0, :, 1] + r) * side + (pat[0, :, 0] + r)
    idx_b = (pat[1, :, 1] + r) * side + (pat[1, :, 0] + r)
    D = np.zeros((side * side, NUM_PAIRS), np.float32)
    D[idx_a, np.arange(NUM_PAIRS)] += 1.0
    D[idx_b, np.arange(NUM_PAIRS)] -= 1.0
    return D


def upright_patch_descriptors(blurred: jnp.ndarray,
                              centers_xy: jnp.ndarray) -> jnp.ndarray:
    """Upright BRIEF at K keypoints via block loads: (K, 8) packed uint32.

    dense_descriptor_map computes 256 comparisons at EVERY pixel
    (~0.5G ops/level) and per-keypoint element gathers read scattered
    scalars. This middle road vmaps dynamic_slice to load
    one contiguous (31, 31) patch per keypoint, then evaluates the 256
    pattern comparisons as static in-patch picks — identical bits to
    lookup_descriptors(dense_descriptor_map(img), xy) for interior
    integer keypoints (extractor border >= patch_radius+1 guarantees
    interiority for every valid keypoint).
    """
    import jax
    from slam_toolkit_tpu.ops.patches import gather_blocks
    h, w = blurred.shape
    r = PATCH_RADIUS
    side = 2 * r + 1
    cx = jnp.round(centers_xy[:, 0]).astype(jnp.int32)
    cy = jnp.round(centers_xy[:, 1]).astype(jnp.int32)
    y0 = jnp.clip(cy - r, 0, h - side)
    x0 = jnp.clip(cx - r, 0, w - side)
    patches = gather_blocks(blurred, y0, x0, side, side)   # (K, 31, 31)
    flat = patches.reshape(patches.shape[0], side * side)

    # the 256 comparisons as ONE matmul: column k of D is
    # e[idx_a[k]] - e[idx_b[k]], so bit_k = (va - vb < 0) = (flat@D)[k] < 0.
    # f32 path: HIGHEST precision keeps the difference exact. bf16 path
    # (ExtractorConfig.descriptor_dtype): bf16 operands with f32
    # accumulation — rounding only flips near-tie comparisons, at half
    # the patch-gather memory traffic.
    if flat.dtype == jnp.bfloat16:
        va_minus_vb = jnp.dot(
            flat, jnp.asarray(_pick_matrix()).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32)
    else:
        va_minus_vb = jnp.dot(flat, jnp.asarray(_pick_matrix()),
                              precision=jax.lax.Precision.HIGHEST)
    bits = (va_minus_vb < 0.0).astype(jnp.uint32)
    k = bits.shape[0]
    words = bits.reshape(k, DESC_WORDS, 32)
    shifts = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(words * shifts, axis=-1, dtype=jnp.uint32)


def lookup_descriptors(desc_map: jnp.ndarray,
                       centers_xy: jnp.ndarray) -> jnp.ndarray:
    """Gather packed descriptors at integer keypoint coords (K, 8)."""
    h, w = desc_map.shape[:2]
    cx = jnp.clip(jnp.round(centers_xy[:, 0]).astype(jnp.int32), 0, w - 1)
    cy = jnp.clip(jnp.round(centers_xy[:, 1]).astype(jnp.int32), 0, h - 1)
    return desc_map[cy, cx]


def compute_descriptors(blurred: jnp.ndarray, centers_xy: jnp.ndarray,
                        angles: jnp.ndarray) -> jnp.ndarray:
    """Rotation-steered 256-bit BRIEF, packed (K, 8) uint32.

    Samples the blurred image at the pattern offsets rotated by each
    keypoint's angle (rounded to nearest pixel, like the reference's
    cvRound sampling at src/orb_extractor.cpp:117-124).
    """
    h, w = blurred.shape
    pat = jnp.asarray(sampling_pattern())            # (2, 256, 2) xy
    ca, sa = jnp.cos(angles), jnp.sin(angles)        # (K,)
    px = pat[:, :, 0][None, :, :]                    # (1, 2, 256)
    py = pat[:, :, 1][None, :, :]
    rx = px * ca[:, None, None] - py * sa[:, None, None]   # (K, 2, 256)
    ry = px * sa[:, None, None] + py * ca[:, None, None]
    cx = jnp.round(centers_xy[:, 0])[:, None, None]
    cy = jnp.round(centers_xy[:, 1])[:, None, None]
    gx = jnp.clip(jnp.round(cx + rx).astype(jnp.int32), 0, w - 1)
    gy = jnp.clip(jnp.round(cy + ry).astype(jnp.int32), 0, h - 1)
    vals = blurred[gy, gx]                           # (K, 2, 256)
    bits = (vals[:, 0, :] < vals[:, 1, :]).astype(jnp.uint32)  # (K, 256)
    k = bits.shape[0]
    words = bits.reshape(k, DESC_WORDS, 32)
    shifts = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(words * shifts, axis=-1, dtype=jnp.uint32)
