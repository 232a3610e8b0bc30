"""Dense stereo block matching as a shifted-SAD cost volume.

Replacement for cv::cuda::StereoBM(num_disparities=128,
block_size=19) used by the reference's dense tracker
(ref examples/epip_cluster/src/tracker.cpp:54,106-128). The cost volume
is built from D shifted absolute differences box-filtered separably —
pure elementwise + filter work, with the disparity loop as one batched
axis instead of a kernel launch per pixel.

The reference masks computation to Sobel-edge regions (:76-87); the mask
here gates the output rather than the compute (dense fixed-shape compute
instead of divergent masking).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _box_filter(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Separable box filter over the last two axes (same padding), as
    two banded matmuls (ops/sepconv.py), which do N/k times more FLOPs
    than a tap loop; whether direct shifted adds or `lax.conv` are
    faster on the GPU is ROADMAP S3."""
    from slam_toolkit_tpu.ops.sepconv import sep_correlate2d
    taps = np.full((size,), 1.0 / size, np.float32)
    return sep_correlate2d(x, taps, taps)


def disparity(left: jnp.ndarray, right: jnp.ndarray,
              num_disparities: int = 128, block_size: int = 19,
              uniqueness: float = 0.97) -> jnp.ndarray:
    """(H, W) grayscale pair -> (H, W) float32 disparity (0 = invalid).

    Winner-take-all over the SAD cost volume with a uniqueness check and
    3-point parabola subpixel refinement.
    """
    h, w = left.shape
    lf = left.astype(jnp.float32)
    rf = right.astype(jnp.float32)

    def cost_at(d):
        shifted = jnp.pad(rf, ((0, 0), (d, 0)), mode='edge')[:, :w]
        return jnp.abs(lf - shifted)

    # (D, H, W) absolute differences, then box filter each slice
    diffs = jnp.stack([cost_at(d) for d in range(num_disparities)], axis=0)
    cost = _box_filter(diffs, block_size)

    # Winner-take-all WITHOUT gathers: instead of per-pixel indexing
    # into the (D, H, W) volume (`cost[best, rows, cols]`) and
    # jnp.partition for the second-best, everything below is masked
    # min/sum reductions over the D axis that XLA fuses into single
    # passes over the volume (ROADMAP S9 A/Bs this against gathers).
    best = jnp.argmin(cost, axis=0)                       # (H, W)
    c_best = jnp.min(cost, axis=0)
    didx = jnp.arange(num_disparities)[:, None, None]
    # uniqueness: best must beat the runner-up meaningfully
    c_second = jnp.min(jnp.where(didx == best[None], jnp.inf, cost),
                       axis=0)
    unique = c_best <= uniqueness * c_second + 1e-3

    # subpixel parabola around the winner (one-hot masked sums)
    bc = jnp.clip(best, 1, num_disparities - 2)
    c0 = jnp.sum(jnp.where(didx == bc[None] - 1, cost, 0.0), axis=0)
    c1 = jnp.sum(jnp.where(didx == bc[None], cost, 0.0), axis=0)
    c2 = jnp.sum(jnp.where(didx == bc[None] + 1, cost, 0.0), axis=0)
    denom = jnp.maximum(c0 + c2 - 2.0 * c1, 1e-6)
    delta = jnp.clip(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    disp = bc.astype(jnp.float32) + delta

    cols = jnp.arange(w)[None, :]
    valid = unique & (best > 0) & (best < num_disparities - 1) & \
        (cols >= num_disparities)
    return jnp.where(valid, disp, 0.0)


def sobel_edge_mask(image: jnp.ndarray, threshold: float = 50.0,
                    dilate: int = 2) -> jnp.ndarray:
    """Sobel magnitude -> binary edge mask, dilated.

    Replaces the reference's Sobel + threshold + distance-transform mask
    (ref examples/epip_cluster/src/tracker.cpp:76-87); dilation plays the
    role of the distance-transform band.
    """
    from slam_toolkit_tpu.ops.sepconv import sep_correlate2d
    img = image.astype(jnp.float32)
    # Sobel is separable: gx = [1,2,1]^T x [-1,0,1], gy transposed —
    # two banded-matmul passes each (ops/sepconv.py), not 1-channel convs
    gx = sep_correlate2d(img, np.asarray([-1, 0, 1], np.float32),
                         np.asarray([1, 2, 1], np.float32))
    gy = sep_correlate2d(img, np.asarray([1, 2, 1], np.float32),
                         np.asarray([-1, 0, 1], np.float32))
    mag = jnp.sqrt(gx * gx + gy * gy)
    mask = mag > threshold
    if dilate > 0:
        k = np.ones((2 * dilate + 1,), np.float32)
        mask = sep_correlate2d(mask.astype(jnp.float32), k, k) > 0.5
    return mask
