"""Packed-binary Hamming distance as dense XLA contractions.

Replaces the reference's scalar XOR+popcount loop
(DescriptorDistance, ref include/orb_extractor.h:87-103) and both of its
search structures — row-bucket candidate lists (src/matcher.cpp:60-95)
and FLANN radius queries (src/frame.cpp:157-193) — with one dense
(M, N) distance matrix: XOR broadcast over 8 uint32 words, hardware
popcount, sum. At K=2048 descriptors this is ~34M int ops, far below
one pass over the images themselves; gates (epipolar bands,
search radii, validity) are additive masks on the matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = 1e9  # sentinel distance for masked-out pairs (plain float: a jnp
#            constant here would initialize the JAX backend at import)


def unpack_pm1(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) packed uint32 -> (N, 256) bf16 in {-1, +1}."""
    bits = (desc[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    n = desc.shape[0]
    return (2.0 * bits.reshape(n, 256).astype(jnp.bfloat16) - 1.0)


def distance_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """(M, 8) x (N, 8) packed uint32 -> (M, N) Hamming distances (f32).

    Computed as a matmul: with bits mapped to +/-1, a.b = 256 - 2*hamming,
    so the full distance matrix is one (M, 256) x (256, N) bf16 matmul —
    the XOR+popcount broadcast formulation materializes an (M, N, 8)
    tensor (hundreds of MB).
    """
    fa = unpack_pm1(desc_a)
    fb = unpack_pm1(desc_b)
    # single-pass bf16 is EXACT here (+/-1 products, f32 accumulation),
    # so opt out of any global highest-precision default
    dot = jnp.dot(fa, fb.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.DEFAULT)
    return 0.5 * (256.0 - dot)


def masked_distance(desc_a: jnp.ndarray, desc_b: jnp.ndarray,
                    mask: jnp.ndarray) -> jnp.ndarray:
    """Distance matrix with disallowed pairs pushed to BIG (float32)."""
    d = distance_matrix(desc_a, desc_b).astype(jnp.float32)
    return jnp.where(mask, d, BIG)


def ratio_test_match(dist: jnp.ndarray, ratio: float,
                     max_dist: float):
    """Row-wise best match with best/second-best ratio test.

    dist: (M, N) float32 with BIG at masked pairs.
    Returns (idx (M,) int32 best column, ok (M,) bool passing
    d_best <= max_dist and d_best < ratio * d_second) — the acceptance
    rule of ref src/matcher.cpp:112-128.
    """
    best_idx = jnp.argmin(dist, axis=1)
    m = dist.shape[0]
    rows = jnp.arange(m)
    d_best = dist[rows, best_idx]
    masked = dist.at[rows, best_idx].set(BIG)
    d_second = jnp.min(masked, axis=1)
    ok = (d_best <= max_dist) & (d_best < ratio * d_second)
    return best_idx.astype(jnp.int32), ok


def keep_best_per_target(idx: jnp.ndarray, ok: jnp.ndarray,
                         dist_best: jnp.ndarray, num_targets: int):
    """Resolve duplicate matches to one target: keep the smallest distance.

    Mirrors ProjectionMatch's keep-best-on-collision
    (ref src/matcher.cpp:197-205). Returns a refined `ok` mask.
    """
    m = idx.shape[0]
    src = jnp.arange(m, dtype=jnp.float32)
    # ONE scatter-min on packed (distance, source) keys: Hamming
    # distances are integer-valued f32 <= 256, so dist * 4096 + src is
    # exact and ties break toward the lowest source index — identical to
    # the two-pass (min distance, then min source) resolution
    packed = jnp.where(ok, dist_best * 4096.0 + src, BIG)
    per_target = jnp.full((num_targets,), BIG).at[idx].min(packed)
    return ok & (packed <= per_target[idx])
