"""Quality gates of the dense motion-clustering workload.

Two checks on a `data.synthetic.make_cluster_scene` run of
cluster/tracker.FusedDenseTracker:

- mover persistence: over the last 20 frames each mover box keeps one
  cluster id of its own (the reference's TrackCluster property);
- disparity and flow accuracy against the scene's analytic ground truth,
  as percentile and outlier-share gates.

Percentiles, not RMSE: winner-take-all block matching and
window-averaged flow both have RARE localized outliers by construction
(stereo texture aliases; flow mixing rings at mover boundaries), exactly
like the reference's cv::cuda StereoBM/Farneback output, and an RMSE over
230k pixels measures that 0.04% tail, not the estimator. p95 gates the
estimator; the >3 px share bounds the tail, so a real regression
(aliasing spreading, flow losing a band) still fails.
"""

from __future__ import annotations

import numpy as np

# upper limits: disparity p95 [px], disparity >3 px share, flow EPE p95
# [px], flow >3 px share
LIMITS = {"disp_p95_px": 0.3, "disp_gt3px_frac": 0.005,
          "flow_epe_p95_px": 2.0, "flow_gt3px_frac": 0.06}


def mover_persistence(scene, cfg, outs, n_frames: int, tail: int = 20):
    """(persist, distinct, ids, alive, n_live) over the last `tail`
    frames. outs[k] is the tracker output of frame k+1 (frame 0 seeds
    the tracker); each mover's id is the majority label of the samples
    inside its ground-truth box (10 px inset)."""
    from slam_toolkit_tpu.cluster.tracker import _sample_grid

    h, w = scene.frames[0][0].shape
    grid, _, _ = _sample_grid(h, w, cfg.sample_stride, cfg.max_points)
    uv = grid.astype(np.float32)

    def box_major(out, box):
        x, y, s, _ = box
        m = ((uv[:, 0] >= x + 10) & (uv[:, 0] < x + s - 10)
             & (uv[:, 1] >= y + 10) & (uv[:, 1] < y + s - 10))
        labs = out["labels"][:len(m)][m]
        labs = labs[labs >= 0]
        if labs.size == 0:
            return -1
        vals, cnts = np.unique(labs, return_counts=True)
        return int(vals[np.argmax(cnts)])

    live = [(k + 1, o) for k, o in enumerate(outs) if not o["skipped"]]
    n_movers = len(scene.mover_boxes[0])
    ids = {j: [] for j in range(n_movers)}
    for fidx, o in live:
        if fidx < n_frames - tail:
            continue
        for j, box in enumerate(scene.mover_boxes[fidx]):
            ids[j].append(box_major(o, box))
    persist = all(len(set(v)) == 1 and v[0] >= 0 for v in ids.values() if v)
    firsts = [v[0] for v in ids.values() if v]
    distinct = len(set(firsts)) == len(firsts)
    alive = int((live[-1][1]["sizes"] > 0).sum()) if live else 0
    return persist, distinct, [v[0] if v else None for v in ids.values()], \
        alive, len(live)


def dense_errors(scene, cfg, probes):
    """Worst-of-probes disparity and flow errors of cluster/tracker's
    dense_frame (the program the fused step traces) against
    data.synthetic.cluster_scene_gt; keys as in LIMITS."""
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.cluster.tracker import dense_frame
    from slam_toolkit_tpu.data.synthetic import cluster_scene_gt

    dfj = jax.jit(lambda a, b, p: dense_frame(a, b, p, scene.cam, cfg))
    d_p95, d_frac, f_p95, f_frac = [], [], [], []
    for t in probes:
        gl, gr = scene.frames[t]
        prev = scene.frames[t - 1][0]
        fr = dfj(jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(prev))
        disp = np.asarray(fr.disparity)
        flow = np.asarray(fr.flow)
        gt_d, gt_f, gt_v = cluster_scene_gt(scene, t)
        md = gt_v & (disp > 0)
        derr = np.abs(disp[md] - gt_d[md])
        d_p95.append(float(np.percentile(derr, 95)))
        d_frac.append(float(np.mean(derr > 3.0)))
        epe = np.linalg.norm(flow - gt_f, axis=-1)[gt_v]
        f_p95.append(float(np.percentile(epe, 95)))
        f_frac.append(float(np.mean(epe > 3.0)))
    return {"disp_p95_px": max(d_p95), "disp_gt3px_frac": max(d_frac),
            "flow_epe_p95_px": max(f_p95), "flow_gt3px_frac": max(f_frac)}


def within_limits(errors) -> bool:
    return all(errors[k] <= v for k, v in LIMITS.items())
