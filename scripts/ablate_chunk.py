"""Chunk-level ablation: which stage costs what (timed over whole chunks)."""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time
import numpy as np
import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.frontend.frame import build_frame
from slam_toolkit_tpu.frontend.tracker import track_pose
from slam_toolkit_tpu.frontend.matching import projection_match
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.optim import pose_lm
from slam_toolkit_tpu.ops.extractor import extract
from slam_toolkit_tpu.ops import pyramid, fast, topk_grid, brief

cfg = SlamConfig()
cam = StereoCamera.from_config(cfg.camera)
rng = np.random.default_rng(0)
C = 16
images = jnp.asarray(rng.uniform(0, 255, (C, 376, 1241)).astype(np.float32))
jax.block_until_ready(images)

L = cfg.map.track_landmarks
Xw = jnp.asarray(np.stack([rng.uniform(-20, 20, L), rng.uniform(-3, 3, L),
                           rng.uniform(4, 60, L)], -1).astype(np.float32))
desc = jnp.asarray(rng.integers(0, 2**32, (L, 8), dtype=np.uint32))
valid = jnp.ones((L,), bool)


def scan_over(fn, name, n=6):
    @jax.jit
    def run(images):
        def body(carry, img):
            out = fn(img, carry)
            return carry, out
        _, ys = jax.lax.scan(body, jnp.float32(0.0), images)
        return jax.tree.map(lambda y: jnp.sum(y[-1]) if y.dtype != bool
                            else jnp.sum(y[-1]), ys)
    o = run(images); jax.block_until_ready(o)
    t0 = time.perf_counter()
    for _ in range(n):
        o = run(images)
    jax.block_until_ready(o)
    dt = (time.perf_counter() - t0) / (n * C)
    print(f"{name:40s} {1000*dt:7.2f} ms/frame")


scan_over(lambda img, c: build_frame(img, cam, cfg).norm_xy,
          "build_frame (extract+normalize)")
scan_over(lambda img, c: extract(img, cfg.extractor).xy,
          "extract only")
scan_over(lambda img, c: jnp.stack(
    [jnp.sum(l) for l in pyramid.build_pyramid(img, cfg.extractor)]),
    "pyramid only")
scan_over(lambda img, c: jnp.stack(
    [jnp.sum(fast.detect(l, 7.0, 16)) +
     jnp.sum(fast.detect(l, 20.0, 16))
     for l in pyramid.build_pyramid(img, cfg.extractor)]),
    "pyramid + FAST(hi+lo)")
scan_over(lambda img, c: jnp.stack(
    [jnp.sum(pyramid.gaussian_blur(l))
     for l in pyramid.build_pyramid(img, cfg.extractor)]),
    "pyramid + blur")
scan_over(lambda img, c: jnp.sum(brief.dense_descriptor_map(
    pyramid.gaussian_blur(img)).astype(jnp.float32)),
    "blur + dense BRIEF level0 only")


def sel(img, c):
    outs = []
    from slam_toolkit_tpu.ops.extractor import level_budgets
    for l, n_l in zip(pyramid.build_pyramid(img, cfg.extractor),
                      level_budgets(cfg.extractor)):
        s = jnp.maximum(fast.detect(l, 7.0, 16), 0.0)
        xy, r, v = topk_grid.select_keypoints(s, cfg.extractor.cell_size, n_l)
        outs.append(jnp.sum(xy))
    return jnp.stack(outs)


scan_over(sel, "pyramid + FAST + select")


def track_only(img, c):
    # fixed fake frame: skip extraction cost, keep matching+LM
    from slam_toolkit_tpu.ops.extractor import FrameFeatures
    from slam_toolkit_tpu.frontend.frame import FrameState
    K = cfg.extractor.max_keypoints
    feats = FrameFeatures(
        xy=jnp.zeros((K, 2)) + img[0, :2][None, :],  # data-dependent
        response=jnp.ones(K), octave=jnp.zeros(K, jnp.int32),
        angle=jnp.zeros(K), sigma2=jnp.ones(K),
        desc=jnp.zeros((K, 8), jnp.uint32), valid=jnp.ones(K, bool))
    fr = FrameState(feats=feats, norm_xy=jnp.zeros((K, 2)),
                    right_x_norm=jnp.zeros(K), depth=jnp.zeros(K),
                    has_stereo=jnp.zeros(K, bool))
    res = track_pose(fr, Xw, desc, valid, jnp.eye(4), cam, cfg)
    return res.T_cw


scan_over(track_only, "track_pose (match+LM) only")
