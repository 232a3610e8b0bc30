"""Grid-occupancy keyframe decision.

Replaces Pipeline::DoFrameNeedsNewMappoints / IsKeyframe
(ref src/pipeline.cpp:264-306): split the image into a grid_cols x
grid_rows grid, count tracked-inlier mappoints per cell; the frame
becomes a keyframe if any cell holds fewer than min_per_cell matches or
the total is below min_total. Pure device math returning one scalar
bool, read back by the host driver.
"""

from __future__ import annotations

import jax.numpy as jnp

from slam_toolkit_tpu.config import KeyframeConfig


def needs_keyframe(kpt_xy: jnp.ndarray, inlier: jnp.ndarray,
                   width: int, height: int,
                   cfg: KeyframeConfig) -> jnp.ndarray:
    """kpt_xy (N, 2) matched keypoint coords, inlier (N,) bool."""
    cx = jnp.clip((kpt_xy[:, 0] * cfg.grid_cols / width).astype(jnp.int32),
                  0, cfg.grid_cols - 1)
    cy = jnp.clip((kpt_xy[:, 1] * cfg.grid_rows / height).astype(jnp.int32),
                  0, cfg.grid_rows - 1)
    cell = cy * cfg.grid_cols + cx
    ncells = cfg.grid_cols * cfg.grid_rows
    # broadcast compare + reduce instead of a scatter-add of the (N,)
    # cells into `ncells` bins: the (ncells, N) one-hot sum fuses into
    # one pass
    counts = jnp.sum((cell[None, :] == jnp.arange(ncells)[:, None]) &
                     inlier[None, :], axis=1).astype(jnp.int32)
    total = jnp.sum(counts)
    return (total < cfg.min_total) | jnp.any(counts < cfg.min_per_cell)
