"""Run the SLAM engine over a KITTI odometry sequence.

The reference's user entrypoint is examples/kitti: dataset scan ->
Pipeline::Track per stereo pair -> Qt/VTK viewer with GT-aligned
trajectory + per-frame ms overlay (ref examples/kitti/src/main.cpp,
src/qmap_viewer.cpp:126-144). This is the counterpart as a headless
CLI:

    python -m slam_toolkit_tpu.run_kitti --root /data/kitti --seq 00 \
        --out /tmp/kitti00 [--vocab voc.txt | --train-vocab] [--classic]

It drives the chunked on-device engine (pipeline/scan_engine.py) —
optionally with BoW loop closing when a vocabulary is given — then
writes the estimated trajectory in the KITTI poses format (3x4 T_wc
rows), a top-down trajectory plot, a map plot, and a stats JSON
(fps / ATE / RPE / keyframes / mappoints / closures).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _auto_config(shape):
    """Pick the SlamConfig matching the sequence's image size."""
    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.data.kitti import kitti_config
    h, w = shape
    if (h, w) == (376, 1241):
        return kitti_config()
    if (h, w) == (96, 128):
        return SlamConfig.tiny()
    raise SystemExit(
        f"no builtin config for {w}x{h} images; standard KITTI is "
        f"1241x376 — pass frames at that size or extend _auto_config")


def _get_vocab(args, ds, cfg):
    from slam_toolkit_tpu.loop import vocab as V
    if args.vocab:
        return V.load_dbow2_text(args.vocab)
    if not args.train_vocab:
        return None
    import jax
    import jax.numpy as jnp
    from slam_toolkit_tpu.ops.extractor import extract
    ex = jax.jit(lambda im: extract(im, cfg.extractor))
    corpus = []
    step = max(1, len(ds) // 40)
    for i in range(0, len(ds), step):
        f = ex(jnp.asarray(ds[i][0]))
        corpus.append(np.asarray(f.desc)[np.asarray(f.valid)])
    voc = V.train(np.concatenate(corpus), k=10, levels=3,
                  seed=args.seed)
    sys.stderr.write(f"[run_kitti] trained {voc.num_words}-word vocab "
                     f"from {len(corpus)} frames\n")
    return voc


def _save_kitti_poses(path, T_cw_list):
    """Estimated trajectory in the KITTI poses format (3x4 T_wc rows —
    the inverse of our camera-from-world convention, matching
    ref src/dataset.cpp:65-85 read direction)."""
    rows = []
    for T in T_cw_list:
        T_wc = np.linalg.inv(np.asarray(T, np.float64))
        rows.append(T_wc[:3, :].reshape(-1))
    np.savetxt(path, np.stack(rows), fmt="%.9e")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="KITTI odometry root (default: $KITTI_ROOT)")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--frames", type=int, default=0,
                    help="limit frame count (0 = whole sequence)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per device dispatch (chunked engine)")
    ap.add_argument("--classic", action="store_true",
                    help="per-frame host-driven engine instead of the "
                         "chunked scan engine")
    ap.add_argument("--vocab", default=None,
                    help="DBoW2 text vocabulary -> enables loop closing")
    ap.add_argument("--train-vocab", action="store_true",
                    help="train a vocabulary from this sequence")
    ap.add_argument("--native-loader", action="store_true",
                    help="decode PNGs through the native prefetch ring")
    ap.add_argument("--out", default=None,
                    help="output dir (poses txt, plots, stats json)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.data.kitti import KittiDataset
    ds = KittiDataset(args.seq, root=args.root)
    n = min(len(ds), args.frames) if args.frames else len(ds)
    cfg = _auto_config(ds[0][0].shape)
    voc = _get_vocab(args, ds, cfg)

    if args.native_loader:
        loader = ds.prefetch_loader(height=cfg.camera.height,
                                    width=cfg.camera.width)
        frames = ((l, r) for i, (l, r) in enumerate(loader) if i < n)
    else:
        frames = (ds[i] for i in range(n))

    t0 = time.perf_counter()
    if args.classic:
        from slam_toolkit_tpu.pipeline.engine import SlamEngine
        eng = SlamEngine(cfg, vocab=voc)
        for i, (l, r) in enumerate(frames):
            eng.process(l, r)
            if (i + 1) % 100 == 0:
                sys.stderr.write(f"[run_kitti] {i + 1}/{n}\n")
        host = eng
    else:
        from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine
        eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=args.chunk)
        eng.warmup()
        buf, done = [], 0
        for l, r in frames:
            buf.append(np.stack([l, r]))
            if len(buf) == args.chunk:
                eng.process_chunk(np.stack(buf))
                done += len(buf)
                buf = []
                if done % (args.chunk * 8) == 0:
                    sys.stderr.write(f"[run_kitti] {done}/{n}\n")
        if buf:
            eng.process_chunk(np.stack(buf))
        eng.flush()
        host = eng._host
    dt = time.perf_counter() - t0

    traj = eng.trajectory_refined()
    closures = [e for e in host.loop_events if "cand" in e] \
        if voc is not None else []
    stats = {
        "sequence": args.seq, "frames": len(traj),
        "fps": round(len(traj) / dt, 2),
        "keyframes": host.n_keyframes,
        "mappoints": int(np.asarray(host.map.mp_valid).sum()),
        "loop_closures": len(closures),
    }
    gt = ds.ground_truth()
    if gt:
        from slam_toolkit_tpu.evaluation.traj import ate_rmse, rpe
        gt = gt[:len(traj)]
        stats["ate_rmse_m"] = round(float(ate_rmse(traj, gt,
                                                   align=True)), 4)
        rt, rr = rpe(traj, gt)
        stats["rpe_trans_m"] = round(float(rt), 4)
        stats["rpe_rot_deg"] = round(float(rr) * 57.29578, 4)
    print(json.dumps(stats))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        _save_kitti_poses(os.path.join(args.out, f"{args.seq}.txt"), traj)
        from slam_toolkit_tpu.evaluation import viz
        viz.plot_trajectory(traj, gt or None,
                            path=os.path.join(args.out, "trajectory.png"))
        viz.plot_map_topdown(host.map,
                             path=os.path.join(args.out, "map.png"))
        with open(os.path.join(args.out, "stats.json"), "w") as f:
            json.dump({**stats, "frame_stats": eng.frame_stats[-200:],
                       "loop_events": host.loop_events}, f, indent=2)
        sys.stderr.write(f"[run_kitti] wrote {args.out}\n")


if __name__ == "__main__":
    main()
