"""Offline visualization: trajectory plots + keypoint/track overlays.

Replaces the reference's live Qt/VTK viewer (QMapViewer GT-vs-estimate
trajectory drawing, ref src/qmap_viewer.cpp:237-366; CvViewer 2D
keypoint/track overlay, :386-441) with headless matplotlib/PNG output —
the right shape for headless servers and CI. The GT curve is aligned to the
estimate exactly like the reference re-aligns per keyframe via
AlignTrajectory (src/optimizer.cpp:282-344), here with closed-form
Umeyama.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from slam_toolkit_tpu.evaluation.traj import ate_rmse, camera_centers, umeyama


def plot_trajectory(est_T_cw: Sequence[np.ndarray],
                    gt_T_cw: Optional[Sequence[np.ndarray]] = None,
                    path: str = "trajectory.png",
                    title: str = "") -> str:
    """Top-down (x-z) trajectory plot; GT aligned and overlaid if given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = camera_centers(est_T_cw)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(est[:, 0], est[:, 2], "g-", lw=1.5, label="estimate")
    if gt_T_cw is not None and len(gt_T_cw) >= 3:
        gt = camera_centers(gt_T_cw)
        R, t, s = umeyama(gt, est)
        gt_al = gt @ (s * R).T + t
        ax.plot(gt_al[:, 0], gt_al[:, 2], color="0.5", lw=1.0,
                label="ground truth (aligned)")
        err = ate_rmse(est_T_cw, list(gt_T_cw))
        title = (title + f"  ATE RMSE {err:.3f} m").strip()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_map_topdown(map_state, path: str = "map.png",
                     max_points: int = 20000) -> str:
    """Keyframe trajectory + mappoint cloud, top-down."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from slam_toolkit_tpu.mapping.map_state import mappoint_positions

    valid_kf = np.asarray(map_state.kf_valid)
    kf_T = np.asarray(map_state.kf_T_cw)[valid_kf]
    centers = camera_centers(list(kf_T))
    X = np.asarray(mappoint_positions(map_state))
    mv = np.asarray(map_state.mp_valid)
    X = X[mv][:max_points]

    fig, ax = plt.subplots(figsize=(8, 8))
    if len(X):
        ax.scatter(X[:, 0], X[:, 2], s=0.5, c="0.6", label="mappoints")
    ax.plot(centers[:, 0], centers[:, 2], "g.-", ms=3, lw=1.0,
            label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def draw_keypoints(image: np.ndarray, xy: np.ndarray,
                   valid: Optional[np.ndarray] = None,
                   matches_xy: Optional[np.ndarray] = None,
                   path: str = "frame.png") -> str:
    """CvViewer-style overlay: keypoints (and optional track segments)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xy = np.asarray(xy)
    if valid is not None:
        v = np.asarray(valid)
        xy = xy[v]
        if matches_xy is not None:
            matches_xy = np.asarray(matches_xy)[v]
    fig, ax = plt.subplots(figsize=(12, 12 * image.shape[0] / image.shape[1]))
    ax.imshow(np.asarray(image), cmap="gray", vmin=0, vmax=255)
    ax.plot(xy[:, 0], xy[:, 1], "g+", ms=4)
    if matches_xy is not None:
        for (x0, y0), (x1, y1) in zip(matches_xy, xy):
            ax.plot([x0, x1], [y0, y1], "y-", lw=0.5)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def covisibility_stats(map_state, kf_slot: int) -> Optional[dict]:
    """Observation-count stats of one keyframe's mappoints, excluding
    those it anchors — the viewer's EvaluateCovisibility printout
    (ref src/qmap_viewer.cpp:279-302: max/median of n(mp->keyframes)).

    Returns {"max", "median", "n_mappoints"} or None when fewer than 4
    qualifying mappoints exist (same guard as the reference).
    """
    obs = np.asarray(map_state.kf_obs[kf_slot])
    ids = obs[obs >= 0]
    not_anchored_here = np.asarray(map_state.mp_ref_kf)[ids] != kf_slot
    counts = np.asarray(map_state.mp_obs_count)[ids][not_anchored_here]
    if counts.size < 4:
        return None
    return {"max": int(counts.max()),
            "median": int(np.median(counts)),
            "n_mappoints": int(counts.size)}
