"""Multi-seed ATE/RPE/fps sweep at KITTI scale (SURVEY §6 follow-up).

The headline bench (bench.py) times one seed; this sweep reuses the SAME
compiled programs across seeds (no recompile — shapes are static) and
reports per-seed fps / ATE / RPE plus aggregates. Rendered sequences are
cached next to bench.py's, in `.bench_data/` of the checkout.

Run: python scripts/bench_sweep.py            (on the GPU)
     BENCH_SWEEP_SEEDS=7,11 BENCH_SWEEP_FRAMES=96 python scripts/bench_sweep.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_or_render(cfg, n_frames, seed):
    from slam_toolkit_tpu.data.synthetic import make_sequence
    from slam_toolkit_tpu.utils.paths import data_path
    cache = data_path(f"sweep_{seed}_{n_frames}_"
                      f"{cfg.camera.width}x{cfg.camera.height}")
    if os.path.exists(cache + ".npy"):
        return np.load(cache + ".npy", mmap_mode="r"), \
            list(np.load(cache + ".gt.npy"))
    _, gt, frames = make_sequence(cfg, n_frames=n_frames, seed=seed,
                                  step=0.8)
    stacked = np.stack([
        np.stack([np.clip(l, 0, 255), np.clip(r, 0, 255)])
        for l, r in frames]).astype(np.uint8)
    np.save(cache + ".npy", stacked)
    np.save(cache + ".gt.npy", np.stack(gt))
    return stacked, gt


def main():
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.evaluation.traj import ate_rmse, rpe
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

    cfg = SlamConfig()
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))
    n_frames = int(os.environ.get("BENCH_SWEEP_FRAMES", "96"))
    seeds = [int(s) for s in
             os.environ.get("BENCH_SWEEP_SEEDS", "7,11,13").split(",")]

    results = []
    for seed in seeds:
        stacked, gt = load_or_render(cfg, n_frames, seed)
        chunks = [jnp.asarray(stacked[i:i + chunk], jnp.float32)
                  for i in range(0, n_frames, chunk)]
        jax.block_until_ready(chunks)
        eng = ChunkedSlamEngine(cfg, chunk_size=chunk)
        for c in chunks[:2]:
            eng.process_chunk(c)
        eng.flush()
        t0 = time.perf_counter()
        for c in chunks[2:]:
            eng.process_chunk(c)
        eng.flush()
        dt = time.perf_counter() - t0
        n_timed = sum(int(c.shape[0]) for c in chunks[2:])
        traj = eng.trajectory_refined()
        ate = ate_rmse(traj, gt, align=True)
        rt, rr = rpe(traj, gt)
        row = {"seed": seed, "fps": round(n_timed / dt, 1),
               "ate_m": round(ate, 3), "rpe_t_m": round(rt, 4),
               "rpe_r_deg": round(rr * 57.2958, 3)}
        results.append(row)
        sys.stderr.write(f"[sweep] {row}\n")

    agg = {
        "seeds": len(results),
        "fps_mean": round(float(np.mean([r["fps"] for r in results])), 1),
        "ate_mean": round(float(np.mean([r["ate_m"] for r in results])), 3),
        "ate_max": round(float(np.max([r["ate_m"] for r in results])), 3),
        "per_seed": results,
    }
    print(json.dumps(agg))


if __name__ == "__main__":
    main()
