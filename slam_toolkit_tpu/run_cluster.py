"""Run the dense motion-clustering workload over a KITTI sequence.

The reference ships epip_cluster as a standalone example binary whose
main loop reads stereo pairs, calls DenseTracker::Track, and shows the
label-mask windows (ref examples/epip_cluster/src/tracker_main.cpp:17-32,
tracker.cpp:746-783 imshow debug views). This is the counterpart as a
headless CLI:

    python -m slam_toolkit_tpu.run_cluster --root /data/kitti --seq 13 \
        [--frames N] [--out /tmp/clusters]

It drives cluster/tracker.DenseTracker per stereo pair and writes, per
processed frame, a cluster label-mask PNG (the MakeMask rasterization,
ref tracker.cpp:394-409: each sampled point paints its stride-sized
cell) plus one stats JSON for the run (per-frame skip gate, cluster
count/size/rigid-fit summary). The reference's suggested sequences are
17 and 13 (ref tracker_main.cpp:4-16).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def label_mask(shape, pts_uv: np.ndarray, labels: np.ndarray,
               stride: int) -> np.ndarray:
    """Rasterize sampled-point labels into a full-size int mask
    (-1 = unlabeled), each point painting its stride x stride cell —
    the MakeMask counterpart (ref tracker.cpp:394-409)."""
    h, w = shape
    mask = np.full((h, w), -1, np.int32)
    half = stride // 2
    for (u, v), lab in zip(pts_uv.astype(np.int32), labels):
        if lab < 0:
            continue
        y0, x0 = max(v - half, 0), max(u - half, 0)
        mask[y0:v + half + 1, x0:u + half + 1] = lab
    return mask


def save_mask_png(path: str, gray: np.ndarray, mask: np.ndarray) -> None:
    """Overlay the label mask on the grayscale frame (one color per
    cluster) — the headless stand-in for the reference's imshow views."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 3.5))
    ax.imshow(gray, cmap="gray", vmin=0, vmax=255)
    shown = np.ma.masked_where(mask < 0, mask)
    ax.imshow(shown, cmap="tab20", alpha=0.45, interpolation="nearest")
    ax.set_axis_off()
    fig.tight_layout(pad=0.1)
    fig.savefig(path, dpi=100)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="KITTI odometry root (default: $KITTI_ROOT)")
    ap.add_argument("--seq", default="13",
                    help="sequence (the reference suggests 17/13)")
    ap.add_argument("--frames", type=int, default=0,
                    help="limit frame count (0 = whole sequence)")
    ap.add_argument("--out", default=None,
                    help="output dir (mask PNGs + stats json)")
    ap.add_argument("--min-flow-p95", type=float, default=None,
                    help="override the motion skip gate (ref: 20 px)")
    args = ap.parse_args(argv)

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.cluster.tracker import DenseConfig, DenseTracker
    from slam_toolkit_tpu.data.kitti import KittiDataset

    ds = KittiDataset(args.seq, root=args.root)
    n = min(len(ds), args.frames) if args.frames else len(ds)
    cam = ds.camera_config()
    h, w = ds[0][0].shape
    # the reference's StereoBM(128, 19) is sized for 1241-px KITTI
    # frames; on small images that sweep exceeds the image width and
    # matches nothing — scale the search down with the frame
    kw = {} if w >= 640 else {"num_disparities": 32, "block_size": 9,
                              "min_cluster_size": 20}
    if args.min_flow_p95 is not None:
        kw["min_flow_p95"] = args.min_flow_p95
    stride = kw.get("sample_stride", DenseConfig().sample_stride)
    grid_pts = len(range(stride // 2, h, stride)) * \
        len(range(stride // 2, w, stride))
    kw["max_points"] = max(DenseConfig().max_points,
                           ((grid_pts + 127) // 128) * 128)
    ccfg = DenseConfig(**kw)
    tracker = DenseTracker(cam, ccfg)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    stats = []
    t0 = time.perf_counter()
    for i in range(n):
        left, right = ds[i]
        out = tracker.track(left, right)
        row = {"frame": i, "skipped": bool(out.get("skipped", False))}
        if not row["skipped"]:
            row["flow_p95"] = round(out["flow_p95"], 2)
            row["n_points"] = out["n_points"]
            row["n_tracked"] = out["n_tracked"]
            row["n_new_clusters"] = out["n_new_clusters"]
            row["clusters"] = [
                {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in c.items()} for c in out["clusters"]]
            if args.out:
                # the tracker's per-point labels ARE the mask source;
                # rasterize them into the MakeMask cell painting
                mask = label_mask(left.shape, out["pts_uv"],
                                  out["labels"], ccfg.sample_stride)
                save_mask_png(os.path.join(args.out, f"mask_{i:06d}.png"),
                              left, mask)
        stats.append(row)
        if (i + 1) % 20 == 0:
            sys.stderr.write(f"[run_cluster] {i + 1}/{n}\n")
    dt = time.perf_counter() - t0

    processed = [s for s in stats if not s["skipped"]]
    summary = {
        "sequence": args.seq, "frames": n,
        "processed": len(processed),
        "fps": round(n / dt, 2),
        "clusters_per_frame": round(float(np.mean(
            [len(s["clusters"]) for s in processed])), 2) if processed
        else 0.0,
    }
    print(json.dumps(summary))
    if args.out:
        with open(os.path.join(args.out, "stats.json"), "w") as fjson:
            json.dump({**summary, "frames_detail": stats}, fjson, indent=2)
        sys.stderr.write(f"[run_cluster] wrote {args.out}\n")


if __name__ == "__main__":
    main()
