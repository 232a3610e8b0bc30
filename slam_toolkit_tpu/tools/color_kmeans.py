"""Color k-means quantization + edge maps over a KITTI sequence.

Counterpart of the reference's epip_cluster auxiliary
scripts (ref examples/epip_cluster/scripts/kmean.py — per-frame
cv.kmeans color quantization followed by Canny; and line.py, an
abandoned edge-display stub): Lloyd iterations run as one jitted
program on device (assignment = argmin over a (P, K) distance matrix,
update = masked mean via segment sums), edges come from the quantized
image's gradient magnitude. Headless: results are returned (and
optionally written as PNGs) instead of cv.imshow.

Usage:
    python -m slam_toolkit_tpu.tools.color_kmeans <image.png> [K] [out/]
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmeans_quantize(pixels: jnp.ndarray, init: jnp.ndarray,
                    k: int = 4, iters: int = 10
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lloyd k-means on (P, C) float pixels. Returns (labels, centers).

    Mirrors cv.kmeans(Z, K, ..., 10 iters) from the reference script;
    the assignment step is one (P, K) distance reduction.
    """

    def step(centers, _):
        d2 = jnp.sum((pixels[:, None, :] - centers[None, :, :]) ** 2,
                     axis=-1)                       # (P, K)
        lab = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(lab, k, dtype=pixels.dtype)  # (P, K)
        sums = onehot.T @ pixels                    # (K, C)
        cnt = jnp.sum(onehot, axis=0)[:, None]
        new = jnp.where(cnt > 0, sums / jnp.maximum(cnt, 1.0), centers)
        return new, None

    centers, _ = jax.lax.scan(step, init, None, length=iters)
    d2 = jnp.sum((pixels[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    return jnp.argmin(d2, axis=1), centers


@jax.jit
def edge_map(img: jnp.ndarray, thresh: float = 1.0) -> jnp.ndarray:
    """Binary edges of a (H, W) image via central-difference gradient
    magnitude (stands in for the reference's cv.Canny(res2, 0, 1),
    whose near-zero thresholds reduce to 'any gradient at all')."""
    gx = jnp.zeros_like(img).at[:, 1:-1].set(img[:, 2:] - img[:, :-2])
    gy = jnp.zeros_like(img).at[1:-1, :].set(img[2:, :] - img[:-2, :])
    return jnp.sqrt(gx * gx + gy * gy) > thresh


def quantize_image(img: np.ndarray, k: int = 4, iters: int = 10,
                   seed: int = 0):
    """(H, W[, C]) uint8/float -> (quantized image, edges, centers)."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    pixels = jnp.asarray(arr.reshape(-1, c))
    # quantile seeding along the brightness axis: deterministic and
    # collapse-free on flat-region images (the reference gets the same
    # robustness from cv.kmeans' attempts=10 restarts)
    flat = arr.reshape(-1, c)
    order = np.argsort(flat.sum(axis=1), kind="stable")
    qidx = order[((np.arange(k) + 0.5) / k * len(order)).astype(int)]
    init = jnp.asarray(flat[qidx])
    labels, centers = kmeans_quantize(pixels, init, k=k, iters=iters)
    quant = np.asarray(centers)[np.asarray(labels)].reshape(h, w, c)
    edges = np.asarray(edge_map(jnp.asarray(quant.mean(axis=-1))))
    return quant.squeeze(), edges, np.asarray(centers)


def main(argv):
    if not argv:
        print(__doc__)
        return 1
    path, k = argv[0], int(argv[1]) if len(argv) > 1 else 4
    out_dir = argv[2] if len(argv) > 2 else "."
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        print(f"cannot read {path}")
        return 1
    quant, edges, centers = quantize_image(img, k=k)
    base = os.path.splitext(os.path.basename(path))[0]
    cv2.imwrite(os.path.join(out_dir, f"{base}_quant{k}.png"),
                np.clip(quant, 0, 255).astype(np.uint8))
    cv2.imwrite(os.path.join(out_dir, f"{base}_edges.png"),
                (edges * 255).astype(np.uint8))
    print(f"centers: {np.sort(centers.ravel())}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
