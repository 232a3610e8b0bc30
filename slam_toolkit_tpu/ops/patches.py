"""Patch gather: (K, bh, bw) blocks from one image at dynamic corners.

Every per-keypoint window operation in this engine (BRIEF patches,
IC-angle discs, subpixel-SAD strips — replacing the per-keypoint C++
loops of ref src/orb_extractor.cpp:108-147 and the correlation windows
ORB-SLAM-family stereo uses) needs "gather K small rectangles at
dynamic offsets". Written as vmap(lax.dynamic_slice), XLA emits one
parallel gather for the whole batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_blocks(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray,
                  bh: int, bw: int) -> jnp.ndarray:
    """(K,) int32 pre-clamped corners -> (K, bh, bw) windows of img.

    Callers must guarantee 0 <= ys <= H-bh and 0 <= xs <= W-bw.
    """
    ys = ys.astype(jnp.int32)
    xs = xs.astype(jnp.int32)

    def one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (bh, bw))
    return jax.vmap(one)(ys, xs)
