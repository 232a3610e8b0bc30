"""Diagnose WHERE a loop closure distributes its correction on the
low-drift synthetic revisit circle.

For one config variant (env DIAG_OVER="key=val,..." over LoopConfig),
prints:
- every closure event (frame, cur slot, cand slot, inliers),
- the per-keyframe tracking quality (the chain-edge weights' input),
- per-pair seam errors |c(traj[48+i]) - c(traj[i])| closed vs open,
- keyframe positions before/after (via trajectory_refined snapshots).

Run: JAX_PLATFORMS=cpu python scripts/diag_circle_closure.py
"""

import os
import sys
import dataclasses

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.pipeline.engine import SlamEngine
from sweep_loop_quality import build_track, train_voc, seam_error


def per_pair_seam(eng, n_revisit=24):
    traj = eng.trajectory_refined()

    def c(T):
        return np.linalg.inv(T)[:3, 3]

    return np.asarray([np.linalg.norm(c(traj[48 + i]) - c(traj[i]))
                       for i in range(n_revisit)])


def main():
    base = SlamConfig.tiny()
    over = {}
    if os.environ.get("DIAG_OVER"):
        for kv in os.environ["DIAG_OVER"].split(","):
            k, v = kv.split("=")
            cur = getattr(base.loop, k)
            over[k] = type(cur)(float(v)) if isinstance(cur, (int, float)) \
                else v
    cfg = dataclasses.replace(
        base, loop=dataclasses.replace(base.loop, **over))
    blind = os.environ.get("DIAG_BLIND", "0") == "1"
    gt, frames = build_track(base, blind)
    voc = train_voc(base, frames)

    eng = SlamEngine(cfg, vocab=voc)
    for lf, rf in frames:
        eng.process(lf, rf)
    print(f"--- closed ({'blind' if blind else 'low'}-drift, over={over}) ---")
    for e in eng.loop_events:
        print("  event:", e)
    q = np.asarray(eng.map.kf_quality)
    v = np.asarray(eng.map.kf_valid)
    fid = np.asarray(eng.map.kf_frame_id)
    order = np.argsort(np.where(v, fid, 1 << 30))
    live = order[: v.sum()]
    print("  kf (slot, frame, quality):")
    print("   ", [(int(s), int(fid[s]), round(float(q[s]), 1))
                  for s in live])
    pp_closed = per_pair_seam(eng)

    eng_open = SlamEngine(cfg)
    for lf, rf in frames:
        eng_open.process(lf, rf)
    pp_open = per_pair_seam(eng_open)
    print("  pair   open  closed")
    for i in range(len(pp_closed)):
        print(f"  {i:4d}  {pp_open[i]:6.2f}  {pp_closed[i]:6.2f}")
    print(f"  mean   {pp_open.mean():6.2f}  {pp_closed.mean():6.2f}")


if __name__ == "__main__":
    main()
