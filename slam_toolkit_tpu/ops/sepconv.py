"""Separable correlations as banded-matrix matmuls.

A k-tap 1-D correlation along an axis of length N is the product with an
(N, N) banded matrix: k-times-N elementwise work traded for a full N^2
matrix contraction, a ~65x FLOP "waste" (the same trade the extractor's
matmul pyramid makes, ops/pyramid.py). Whether direct shifted adds or
`lax.conv` are faster on the GPU is ROADMAP S3; the contractions run at
the default matmul precision (TF32 on the GPU), ROADMAP S10. Used by the
dense workload's stereo block matching and Farneback flow
(ref examples/epip_cluster/src/tracker.cpp:54-57 — the components the
reference pushes to CUDA).

Boundary handling is edge-replication (matches `mode='edge'` padding):
out-of-range taps accumulate onto the border element of the band
matrix, which is exactly correlation with edge-padded input.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=64)
def _band_matrix(n: int, taps: tuple) -> np.ndarray:
    """(N, N) matrix B with out[i] = sum_j B[j, i] * x[j] equal to the
    edge-padded correlation of x with `taps` (odd length, centered)."""
    k = len(taps)
    r = k // 2
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(k):
            j = i + t - r
            j = min(max(j, 0), n - 1)          # edge replication
            B[j, i] += taps[t]
    return B


def band_matrix(n: int, taps) -> jnp.ndarray:
    t = tuple(float(x) for x in np.asarray(taps).tolist())
    return jnp.asarray(_band_matrix(n, t))


def correlate_w(x: jnp.ndarray, taps, dtype=jnp.float32) -> jnp.ndarray:
    """Correlate along the LAST axis via one matmul. x: (..., W)."""
    B = band_matrix(x.shape[-1], taps).astype(dtype)
    return jnp.matmul(x.astype(dtype), B,
                      preferred_element_type=jnp.float32)


def correlate_h(x: jnp.ndarray, taps, dtype=jnp.float32) -> jnp.ndarray:
    """Correlate along the SECOND-TO-LAST axis via one matmul."""
    B = band_matrix(x.shape[-2], taps).astype(dtype)
    return jnp.einsum('hg,...hw->...gw', B, x.astype(dtype),
                      preferred_element_type=jnp.float32)


def sep_correlate2d(x: jnp.ndarray, kx, ky,
                    dtype=jnp.float32) -> jnp.ndarray:
    """Separable 2-D correlation (rows taps `ky`, cols taps `kx`) with
    edge padding, over the last two axes, as two matmuls."""
    return correlate_w(correlate_h(x, ky, dtype), kx, dtype)
