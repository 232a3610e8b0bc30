"""One-compile parameter sweep for matcher gates on the synthetic world."""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import jax
import jax.numpy as jnp

from slam_toolkit_tpu.utils import compile_cache
compile_cache.enable()

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.geometry import se3, camera as cm
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.ops.extractor import extract
from slam_toolkit_tpu.ops.hamming import distance_matrix
from slam_toolkit_tpu.data.synthetic import (make_world, render_stereo,
                                             render_view)

cfg = SlamConfig.tiny()
cam = StereoCamera.from_config(cfg.camera)
world = make_world(cfg, seed=1)
T0 = np.eye(4, dtype=np.float32)
T1 = np.asarray(se3.exp(jnp.array([0.08, 0.0, 0.25, 0.0, 0.01, 0.0])))
l0, r0 = render_stereo(world, T0)
l1, _ = render_stereo(world, T1)
_, gt_d0 = render_view(world, T0, return_depth=True)

ex = jax.jit(lambda im: extract(im, cfg.extractor))
f0, fr, f1 = ex(jnp.asarray(l0)), ex(jnp.asarray(r0)), ex(jnp.asarray(l1))
D_lr = np.asarray(distance_matrix(f0.desc, fr.desc)).astype(np.float32)
D_01 = np.asarray(distance_matrix(f0.desc, f1.desc)).astype(np.float32)

xy0, xyr, xy1 = map(np.asarray, (f0.xy, fr.xy, f1.xy))
v0, vr, v1 = map(np.asarray, (f0.valid, fr.valid, f1.valid))
o0, orr, o1 = map(np.asarray, (f0.octave, fr.octave, f1.octave))

# GT geometry for frame0 keypoints
xi = np.clip(np.round(xy0[:, 0]).astype(int), 0, cfg.camera.width - 1)
yi = np.clip(np.round(xy0[:, 1]).astype(int), 0, cfg.camera.height - 1)
z0 = gt_d0[yi, xi]
fxb = cfg.camera.fx * cfg.camera.baseline
true_disp = fxb / np.maximum(z0, 1e-3)

# GT projection into frame 1: backproject kp ray at GT depth, project via T1
nx = (xy0[:, 0] - cfg.camera.cx) / cfg.camera.fx
ny = (xy0[:, 1] - cfg.camera.cy) / cfg.camera.fy
Xw = np.stack([nx * z0, ny * z0, z0], -1)
Xc1 = Xw @ T1[:3, :3].T + T1[:3, 3]
u1 = cfg.camera.fx * Xc1[:, 0] / Xc1[:, 2] + cfg.camera.cx
v1gt = cfg.camera.fy * Xc1[:, 1] / Xc1[:, 2] + cfg.camera.cy


def ratio_match(D, mask, ratio, max_d):
    D = np.where(mask, D, 1e9)
    idx = D.argmin(1)
    best = D[np.arange(len(idx)), idx]
    D2 = D.copy()
    D2[np.arange(len(idx)), idx] = 1e9
    second = D2.min(1)
    ok = (best <= max_d) & (best < ratio * second)
    return idx, ok


print("=== STEREO (frame0 L->R), true disparity check (<1.5px) ===")
dy = np.abs(xy0[:, 1, None] - xyr[None, :, 1])
dx = xy0[:, 0, None] - xyr[None, :, 0]
for octg in [99, 1, 0]:
    for ratio in [0.5, 0.6, 0.7, 0.8, 0.95]:
        mask = (v0[:, None] & vr[None, :] & (dy <= 3) & (dx >= 0) &
                (dx <= 100) &
                (np.abs(o0[:, None] - orr[None, :]) <= octg))
        idx, ok = ratio_match(D_lr, mask, ratio, 80)
        got_disp = xy0[:, 0] - xyr[idx, 0]
        correct = ok & (np.abs(got_disp - true_disp) < 1.5) & (z0 > 0.5)
        print(f"  oct<={octg} ratio={ratio}: matches={ok.sum():4d} "
              f"correct={correct.sum():4d} "
              f"prec={correct.sum()/max(ok.sum(),1):.2f}")

print("=== PROJECTION (frame0 -> frame1 at perfect pred) ===")
d2 = (u1[:, None] - xy1[None, :, 0]) ** 2 + (v1gt[:, None] - xy1[None, :, 1]) ** 2
for radius in [5, 10, 20, 50]:
    for ratio in [0.5, 0.6, 0.7, 0.8, 0.95]:
        mask = (v0[:, None] & v1[None, :] & (d2 <= radius ** 2))
        idx, ok = ratio_match(D_01, mask, ratio, 80)
        du = np.abs(xy1[idx, 0] - u1)
        dv = np.abs(xy1[idx, 1] - v1gt)
        correct = ok & (du < 2) & (dv < 2) & (z0 > 0.5)
        print(f"  r={radius:2d} ratio={ratio}: matches={ok.sum():4d} "
              f"correct={correct.sum():4d} "
              f"prec={correct.sum()/max(ok.sum(),1):.2f}")
