"""Chunked-engine twin of diag_circle_closure: seam quality of the
scan-engine closure path (detection + pipelined relpose/close) on the
tiny revisit circles.

Run: JAX_PLATFORMS=cpu python scripts/diag_chunked_loop.py
     DIAG_BLIND=1 ... for the blind-drift world.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine
from sweep_loop_quality import build_track, train_voc


def per_pair_seam(traj, n_revisit=24, lap=48):
    def c(T):
        return np.linalg.inv(T)[:3, 3]
    return np.asarray([np.linalg.norm(c(traj[lap + i]) - c(traj[i]))
                       for i in range(n_revisit)])


def main():
    cfg = SlamConfig.tiny()
    blind = os.environ.get("DIAG_BLIND", "0") == "1"
    chunk = int(os.environ.get("DIAG_CHUNK", "8"))
    gt, frames = build_track(cfg, blind)
    voc = train_voc(cfg, frames)

    eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=chunk)
    eng.run(frames)
    traj = eng.trajectory_refined()
    print(f"--- chunked ({'blind' if blind else 'low'}-drift, "
          f"chunk={chunk}) ---")
    for e in eng.loop_events:
        print("  event:", e)
    pp = per_pair_seam(traj)

    eng_open = ChunkedSlamEngine(cfg, chunk_size=chunk)
    eng_open.run(frames)
    pp_open = per_pair_seam(eng_open.trajectory_refined())
    print(f"  seam mean open {pp_open.mean():.3f}  closed {pp.mean():.3f}"
          f"  (replays {eng.n_replays})")


if __name__ == "__main__":
    main()
