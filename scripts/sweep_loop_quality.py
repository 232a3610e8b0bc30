"""Sweep loop-closure quality knobs on the tiny synthetic revisit circle.

Measures seam self-consistency and ATE for config variants of the
closure gates (min_matches, cooldown, consistency) on both the blind-
drift and low-drift circles, using the per-frame engine on CPU. Used to
pick defaults that neither under-close (drift stays) nor over-close
(noise walks a consistent seam).

Run: JAX_PLATFORMS=cpu python scripts/sweep_loop_quality.py
"""

import os
import sys
import dataclasses

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.data.synthetic import make_world, render_stereo
from slam_toolkit_tpu.evaluation.traj import ate_rmse
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.loop import vocab as V
from slam_toolkit_tpu.ops.extractor import extract
from slam_toolkit_tpu.pipeline.engine import SlamEngine


def circle_T_cw(n, radius):
    step = 2 * np.pi * radius / n
    yaw = 2 * np.pi / n
    T = np.eye(4, dtype=np.float32)
    out = []
    dT = np.asarray(se3.exp(jnp.asarray([0, 0, step, 0, yaw, 0.0],
                                        dtype=jnp.float32)))
    for _ in range(n):
        out.append(T.copy())
        T = np.asarray(se3.normalize(jnp.asarray(dT @ T)))
    return out


def build_track(cfg, blind):
    # tex_size=1024: non-tiling texture (period 42.7 m > 30 m wall span);
    # the default 21 m period aliases loop relative-pose solves — see
    # tests/test_loop_e2e.py circle_setup
    world = make_world(cfg, seed=5, half_width=15.0, half_length=15.0,
                       ground_y=1.6, tex_size=1024)
    n = 48
    gt = circle_T_cw(n, radius=6.0)
    gt = gt + gt[:24]
    frames = [render_stereo(world, T) for T in gt]
    if blind:
        rng = np.random.default_rng(0)
        for i in range(24, 36):
            l, r = frames[i]
            frames[i] = (rng.uniform(0, 255, l.shape).astype(np.float32),
                         rng.uniform(0, 255, r.shape).astype(np.float32))
    return gt, frames


def train_voc(cfg, frames):
    ex = jax.jit(lambda im: extract(im, cfg.extractor))
    corpus = []
    for lf, _ in frames[::4]:
        f = ex(jnp.asarray(lf))
        corpus.append(np.asarray(f.desc)[np.asarray(f.valid)])
    return V.train(np.concatenate(corpus), k=6, levels=3, seed=0)


def seam_error(eng, n_revisit=24):
    traj = eng.trajectory_refined()

    def c(T):
        return np.linalg.inv(T)[:3, 3]

    return float(np.mean([np.linalg.norm(c(traj[48 + i]) - c(traj[i]))
                          for i in range(n_revisit)]))


def run(cfg, frames, gt, voc):
    eng = SlamEngine(cfg, vocab=voc)
    for lf, rf in frames:
        eng.process(lf, rf)
    traj = eng.trajectory_refined()
    ate = ate_rmse(traj, gt, align=True)
    ncl = len([e for e in eng.loop_events if "cand" in e])
    return seam_error(eng), ate, ncl


def main():
    base = SlamConfig.tiny()
    variants = {
        "floor.01": {},
        "floor.05": {"chain_quality_floor": 0.05},
        "floor.2": {"chain_quality_floor": 0.2},
        "floor1": {"chain_quality_floor": 1.0},
        "floor1_sim3": {"chain_quality_floor": 1.0,
                        "pose_graph_group": "sim3"},
        "sim3": {"pose_graph_group": "sim3"},
    }
    for blind in (True, False):
        gt, frames = build_track(base, blind)
        voc = train_voc(base, frames)
        print(f"--- {'blind-drift' if blind else 'low-drift'} circle ---")
        for name, over in variants.items():
            cfg = dataclasses.replace(
                base, loop=dataclasses.replace(base.loop, **over))
            seam, ate, ncl = run(cfg, frames, gt, voc)
            print(f"{name:10s} seam {seam:6.3f} m  ATE {ate:6.3f} m  "
                  f"closures {ncl}")


if __name__ == "__main__":
    main()
