"""End-to-end loop closure drive: box-room circle with revisit.

Usage: python scripts/verify_loop.py
"""
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
from slam_toolkit_tpu.data.synthetic import make_world, render_stereo
from slam_toolkit_tpu.evaluation.traj import ate_rmse
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.loop import vocab as V
from slam_toolkit_tpu.ops.extractor import extract
from slam_toolkit_tpu.pipeline.engine import SlamEngine


def circle_T_cw(n, radius):
    import jax.numpy as jnp
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


def main():
    cfg = SlamConfig.tiny()
    # box room 30x30 m; circle of radius 4 centered inside
    world = make_world(cfg, seed=5, half_width=15.0, half_length=15.0,
                       ground_y=1.6)
    n = 48
    gt = circle_T_cw(n, radius=6.0)
    # 1.5 laps: the second half-lap revisits the start region
    gt = gt + gt[:24]
    frames = [render_stereo(world, T) for T in gt]
    # blind the engine for a stretch mid-lap: tracking coasts on constant
    # velocity, drift accumulates, landmark ids stop flowing across the
    # seam -- the revisit then requires EXPLICIT loop closure
    blind = np.random.default_rng(0)
    for i in range(24, 36):
        l, r = frames[i]
        frames[i] = (blind.uniform(0, 255, l.shape).astype(np.float32),
                     blind.uniform(0, 255, r.shape).astype(np.float32))

    # train a vocabulary on descriptors from this world
    ex = jax.jit(lambda im: extract(im, cfg.extractor))
    corpus = []
    for lf, _ in frames[::4]:
        f = ex(jnp.asarray(lf))
        corpus.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = V.train(np.concatenate(corpus), k=6, levels=3, seed=0)
    print("vocab words:", voc.num_words)

    eng = SlamEngine(cfg, vocab=voc)
    for i, (lf, rf) in enumerate(frames):
        eng.process(lf, rf)
    print("keyframes:", eng.n_keyframes, "loops:", eng.loop_events)
    ate = ate_rmse(eng.trajectory_refined(), gt)
    print("ATE with loop closure:", round(ate, 4))
    traj = eng.trajectory_refined()
    keep = [i for i in range(len(gt)) if not (24 <= i < 40)]
    ate_k = ate_rmse([traj[i] for i in keep], [gt[i] for i in keep])
    # post-revisit segment only, aligned to GT: measures closure quality
    ate_post = ate_rmse(traj[44:], gt[44:])
    print("ATE excl. blind window:", round(ate_k, 4),
          "| post-revisit segment:", round(ate_post, 4))
    cerr = [float(np.linalg.norm(
        np.linalg.inv(traj[i])[:3, 3] - np.linalg.inv(gt[i])[:3, 3]))
        for i in range(len(gt))]
    print("center err profile:", [round(e, 1) for e in cerr])

    # grade each accepted loop edge against ground truth
    import jax.numpy as jnp2
    fid = np.asarray(eng.map.kf_frame_id)
    for k in range(eng.n_closed):
        ci = int(eng.closed_i[k]); cj = int(eng.closed_j[k])
        f_i, f_j = int(fid[ci]), int(fid[cj])
        T_meas = np.asarray(eng.closed_T[k])
        T_gt = gt[f_j] @ np.linalg.inv(gt[f_i])
        err = np.asarray(se3.log(jnp2.asarray(
            T_meas @ np.linalg.inv(T_gt))))
        print(f"loop {f_i}->{f_j}: edge err rho={np.linalg.norm(err[:3]):.3f}m "
              f"phi={np.linalg.norm(err[3:]) * 57.3:.1f}deg")

    # detector introspection on the revisit keyframes
    import jax.numpy as jnp3
    fid = np.asarray(eng.map.kf_frame_id)
    valid = np.asarray(eng.map.kf_valid)
    slots = np.flatnonzero(valid & (fid >= n))      # revisit keyframes
    for s in slots:
        sc = eng._loop_score(eng.map, eng.bow_db, eng.bow_db[int(s)],
                             jnp3.int32(int(s)))
        scores = np.asarray(sc.scores)
        cands = np.flatnonzero(np.asarray(sc.candidates))
        best = np.argsort(-scores)[:3]
        top3 = [(int(b), round(float(scores[b]), 3), int(fid[b]))
                for b in best]
        print(f"kf frame {fid[s]}: minScore={float(sc.min_score):.3f} "
              f"top3={top3} cands={[int(c) for c in cands][:6]}")

    eng2 = SlamEngine(cfg)  # no vocab -> no loop closing
    for lf, rf in frames:
        eng2.process(lf, rf)
    ate2 = ate_rmse(eng2.trajectory_refined(), gt)
    print("ATE without loop closure:", round(ate2, 4))


if __name__ == "__main__":
    main()
