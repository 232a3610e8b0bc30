"""Profile the dense-clustering workload (epip_cluster parity) at KITTI
scale on the GPU: per-stage device timings for dense_frame /
track_clusters / ransac_round, plus end-to-end DenseTracker.track fps.

Usage:  python scripts/profile_cluster.py [n_frames]
Env:    SLAM_CLUSTER_POINTS (default 18688) pads the sample grid.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.cluster.tracker import DenseConfig, DenseTracker
from slam_toolkit_tpu.data.synthetic import make_cluster_scene


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    import os
    P = int(os.environ.get("SLAM_CLUSTER_POINTS", "18688"))

    print(f"devices: {jax.devices()}")
    scene = make_cluster_scene(n_frames=n_frames)
    cfg = DenseConfig(max_points=P)
    tr = DenseTracker(scene.cam, cfg)

    # ---- stage microbenches on frame 1 vs 0 --------------------------
    gl0 = jnp.asarray(scene.frames[0][0])
    gl1, gr1 = map(jnp.asarray, scene.frames[1])
    t0 = time.perf_counter()
    f = jax.block_until_ready(tr._frame(gl1, gr1, gl0))
    print(f"dense_frame compile+run: {time.perf_counter()-t0:.1f} s")
    for _ in range(2):
        t0 = time.perf_counter()
        f = jax.block_until_ready(tr._frame(gl1, gr1, gl0))
        print(f"dense_frame: {1000*(time.perf_counter()-t0):.1f} ms")

    _, _, grid_shape = __import__(
        "slam_toolkit_tpu.cluster.tracker", fromlist=["_sample_grid"]
    )._sample_grid(376, 1241, cfg.sample_stride, cfg.max_points)
    labels = jnp.zeros((cfg.max_points,), jnp.int32)   # everything cluster 0
    is_ground = jnp.zeros((cfg.max_clusters,), bool).at[0].set(True)
    alive = jnp.zeros((cfg.max_clusters,), bool).at[0].set(True)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    out = jax.block_until_ready(
        tr._track(f, labels, f.depth, is_ground, alive, key, grid_shape))
    print(f"track_clusters compile+run: {time.perf_counter()-t0:.1f} s")
    for _ in range(2):
        t0 = time.perf_counter()
        out = jax.block_until_ready(
            tr._track(f, labels, f.depth, is_ground, alive, key,
                      grid_shape))
        print(f"track_clusters: {1000*(time.perf_counter()-t0):.1f} ms")

    residual = jnp.ones((cfg.max_points,), bool)
    t0 = time.perf_counter()
    r = jax.block_until_ready(
        tr._round(f, residual, f.depth, jnp.asarray(True), key))
    print(f"ransac_round compile+run: {time.perf_counter()-t0:.1f} s")
    for _ in range(2):
        t0 = time.perf_counter()
        r = jax.block_until_ready(
            tr._round(f, residual, f.depth, jnp.asarray(True), key))
        print(f"ransac_round: {1000*(time.perf_counter()-t0):.1f} ms")

    # ---- end-to-end --------------------------------------------------
    tr2 = DenseTracker(scene.cam, cfg)
    t_start = None
    stats = []
    for i, (gl, gr) in enumerate(scene.frames):
        t0 = time.perf_counter()
        o = tr2.track(gl, gr)
        dt = time.perf_counter() - t0
        stats.append((dt, o))
        if i == 2:
            t_start = time.perf_counter()   # skip compile frames
        tag = "skip" if o.get("skipped") else \
            f"trk={o['n_tracked']} new={o['n_new_clusters']} " \
            f"cl={len(o['clusters'])}"
        print(f"frame {i:3d}: {1000*dt:7.1f} ms  {tag}")
    n_timed = len(scene.frames) - 3
    wall = time.perf_counter() - t_start
    print(f"\nfps (frames 3..{len(scene.frames)-1}): {n_timed/wall:.1f}")


if __name__ == "__main__":
    main()
