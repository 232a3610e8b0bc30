"""Dense motion clustering: the epip_cluster workload.

Replaces DenseTracker (ref examples/epip_cluster/src/tracker.cpp):
per stereo pair — Sobel edge mask (:76-87), dense block-matching
disparity (:106-128), dense optical flow vs the previous frame
(:130-145), a p95 flow-magnitude skip gate (:147-164,722-724), stride-5
point sampling with disparity gates (:166-200), then TEMPORAL motion
clustering:

  1. `TrackCluster` (ref :518-693): propagate previous-frame cluster
     labels through the flow field (the label mask lookup at the
     flow-warped pixel, :529-544), per-cluster PnP-RANSAC on the
     propagated members (:567-592), re-absorb untracked points by
     reprojection under ground-cluster motion (:595-625) then by 3D
     nearest-neighbor <= 0.5 m (:627-662), and split drifted clusters
     with `EuclideanFilter` (:411-516) keeping only sub-components with
     enough near (<50 m) points.
  2. `RansacCluster` (ref :202-392): iterative RANSAC on the residual
     points — rigid fit, disparity-consistency gate (:274-282),
     Euclidean clustering of the inliers with the ground-2D(r=20 px) /
     object-3D(r=0.5 m) distinction (:315-323), components >= 50 points
     become NEW clusters; smaller components return to the pool.

Fixed-shape design: there is no per-cluster kernel-launch loop and no
FLANN tree. All per-cluster RANSACs run as ONE vmapped dispatch over
fixed cluster slots; label propagation is index arithmetic on the fixed
sample grid (the rasterized mask of ref MakeMask :394-409 never needs
materializing — the grid IS the mask); nearest-neighbor absorption and
Euclidean components are dense masked distance matrices + min-label
propagation. The host driver holds only the inter-frame label state and
the (bounded) residual-RANSAC loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from slam_toolkit_tpu.cluster import flow as flow_mod
from slam_toolkit_tpu.cluster import ransac as ransac_mod
from slam_toolkit_tpu.cluster import stereo_bm
from slam_toolkit_tpu.config import CameraConfig


class DenseConfig(NamedTuple):
    num_disparities: int = 128
    block_size: int = 19
    flow_levels: int = 5
    flow_win: int = 13
    max_flow_x: int = 64               # full-res flow bound [px] — the
    max_flow_y: int = 24               # warp saturates beyond (flow.py)
    sample_stride: int = 5
    min_disparity: float = 2.0
    max_disparity: float = 50.0
    min_flow_p95: float = 20.0
    cluster_radius_3d: float = 0.5     # object clustering / absorption radius [m] (ref :317,:655)
    ground_radius_px: float = 20.0     # ground clustering radius [px] (ref :317)
    min_cluster_size: int = 50         # new-cluster component minimum (ref :297,:352)
    max_points: int = 8192             # padded sample capacity
    max_clusters: int = 16             # cluster-id slot capacity
    track_capacity: int = 2048         # per-cluster gathered member capacity
    min_track_points: int = 20         # candidate-cluster minimum (ref :554)
    min_track_inliers: int = 20        # per-cluster PnP acceptance (ref :581)
    max_rprj_px: float = 2.0           # RANSAC inlier gate [px] (ref :209,:525)
    disp_consistency_px: float = 3.0   # disparity-error gate [px] (ref :280)
    near_z: float = 50.0               # "near" depth for drift splits [m] (ref :481)
    min_near_points: int = 20          # sub-cluster survival count (ref :495)
    max_ransac_rounds: int = 6         # bounded form of ref's while(true) (:238)
    max_window_cells: int = 12         # stencil cap (see _window_cells)


class DenseFrame(NamedTuple):
    """Per-frame device outputs."""
    disparity: jnp.ndarray      # (H, W)
    depth: jnp.ndarray          # (H, W)  fx*b/disp, 0 where invalid (ref :63-74)
    flow: jnp.ndarray           # (H, W, 2)
    edge_mask: jnp.ndarray      # (H, W) bool
    pts_uv: jnp.ndarray         # (P, 2) sampled pixel coords
    pts_xyz: jnp.ndarray        # (P, 3) camera-frame 3D points
    pts_valid: jnp.ndarray      # (P,) bool
    flow_p95: jnp.ndarray       # ()


def _grid_pad(a: jnp.ndarray, c: int, fill):
    return jnp.pad(a, ((c, c), (c, c)) + ((0, 0),) * (a.ndim - 2),
                   constant_values=fill)


def _patches(x2d: jnp.ndarray, c: int, fill) -> jnp.ndarray:
    """All (2c+1)^2 window-shifted copies of a (ny, nx) grid plane as
    ONE (W^2, ny, nx) tensor via lax.conv_general_dilated_patches — a
    single XLA op that compiles quickly, where both a fully-unrolled
    shift stencil and a fori-of-dynamic-slices form took minutes to
    compile. Channel k holds the neighbor at offset
    (k // W - c, k % W - c). Non-float planes ride as f32 (labels
    < 2^24 are exact) and are cast back by the caller."""
    W = 2 * c + 1
    xp = _grid_pad(x2d.astype(jnp.float32), c, fill)
    p = jax.lax.conv_general_dilated_patches(
        xp[None, None], filter_shape=(W, W), window_strides=(1, 1),
        padding='VALID')
    return p[0]


def _window_cells(cam: CameraConfig, cfg: "DenseConfig") -> int:
    """Stencil half-width (in grid cells) covering the clustering radii.

    The sample points live on a regular stride-`s` pixel grid, so every
    radius query is a bounded pixel window: the ground radius is
    `ground_radius_px/s` cells exactly, and two 3D points within
    `cluster_radius_3d` of each other at depth >= z_min (enforced by the
    max_disparity gate) project within ~fx*r/(z_min*s) cells. This is
    what lets the (P, P) distance matrices of the direct FLANN
    translation collapse to stencils (see _grid_cc). Capped at
    cfg.max_window_cells: beyond the cap, 3D-close but pixel-distant
    pairs (possible at depth extremes toward the image edge) connect
    only through intermediate samples — surfaces always have them."""
    z_min = cam.fx * cam.baseline / cfg.max_disparity
    c3d = int(np.ceil(cam.fx * cfg.cluster_radius_3d
                      / (z_min * cfg.sample_stride)))
    cpx = int(np.ceil(cfg.ground_radius_px / cfg.sample_stride))
    if max(c3d, cpx) > cfg.max_window_cells:
        # the cap binds: _grid_cc still connects through intermediate
        # samples, but _grid_absorb has NO such fallback — 3D-close,
        # pixel-distant points are silently not adopted. Defaults give
        # wc=10 < 12 on KITTI; non-default fx/stride/max_disparity can
        # cross it, so make the accuracy tradeoff visible (r4 advisor).
        import sys
        sys.stderr.write(
            f"[cluster] window stencil capped: need {max(c3d, cpx)} "
            f"cells (c3d={c3d}, cpx={cpx}) > max_window_cells="
            f"{cfg.max_window_cells}; 3D absorption may miss "
            f"pixel-distant neighbors\n")
    return min(max(c3d, cpx, 1), cfg.max_window_cells)


def _grid_cc(member: jnp.ndarray, xyz: jnp.ndarray, grid_shape, c: int,
             r3d: float, point_label=None, is_ground_round=None,
             rpx: float = None, stride: int = None,
             n_iter: int = 8) -> jnp.ndarray:
    """Connected components over the sample grid by stencil min-label
    propagation with pointer jumping.

    Replaces the dense (P, P) radius adjacency (the direct translation
    of the reference's FLANN EuclideanCluster, ref tracker.cpp:332-392)
    with a (2c+1)^2 neighborhood stencil on the (ny, nx) grid — the
    arrays stay KB-sized instead of a 349 MB
    adjacency at KITTI scale. Adjacency bits per offset are computed
    once; each of the n_iter sweeps is shifted-min + label-of-label
    jumping (diameter coverage ~2^n_iter window hops).

    member: (P,) bool. xyz: (P, 3). point_label: optional (P,) int —
    adjacency additionally requires equal labels (EuclideanFilter).
    is_ground_round: optional traced bool selecting the ground metric
    (pixel distance, STATIC per offset) over the 3D metric.
    Returns (P,) int32 component roots (grid index), sentinel P for
    non-members and padding."""
    P = member.shape[0]
    ny, nx = grid_shape
    G = ny * nx
    W = 2 * c + 1
    mem = member[:G].reshape(ny, nx)
    X = xyz[:G].reshape(ny, nx, 3)
    r2 = r3d * r3d

    # adjacency (W^2, ny, nx), built ONCE from patches tensors — the
    # self offset is included (a self-edge is a no-op for min-
    # propagation)
    nm = _patches(mem, c, 0.0) > 0.5
    d3 = sum((_patches(X[..., i], c, 1e9) - X[..., i]) ** 2
             for i in range(3))
    ok = d3 <= r2
    if is_ground_round is not None:
        dy, dx = jnp.divmod(jnp.arange(W * W), W)
        okg = ((stride * stride)
               * ((dy - c) ** 2 + (dx - c) ** 2)) <= rpx * rpx
        ok = jnp.where(is_ground_round, okg[:, None, None], ok)
    adj = ok & nm & mem
    if point_label is not None:
        labid = point_label[:G].reshape(ny, nx)
        nid = _patches(labid, c, -7.0).astype(jnp.int32)
        adj = adj & (nid == labid)

    lab0 = jnp.where(mem, jnp.arange(G, dtype=jnp.int32).reshape(ny, nx),
                     G)

    def sweep(_, lab):
        nl = _patches(lab, c, float(G)).astype(jnp.int32)
        best = jnp.min(jnp.where(adj, nl, G), axis=0)
        best = jnp.minimum(lab, best)
        bf = best.reshape(-1)
        jump = bf[jnp.clip(bf, 0, G - 1)]
        bf = jnp.minimum(bf, jnp.where(bf < G, jump, G))
        return bf.reshape(ny, nx)

    lab = jax.lax.fori_loop(0, n_iter, sweep, lab0).reshape(-1)
    comp = jnp.full((P,), P, jnp.int32)
    return comp.at[:G].set(jnp.where(lab < G, lab, P))


def _grid_absorb(point_label: jnp.ndarray, tracked_ok: jnp.ndarray,
                 xyz: jnp.ndarray, grid_shape, c: int):
    """Nearest TRACKED neighbor within the stencil window (the 3D-kNN
    absorption of ref tracker.cpp:627-662 without the (P, P) distance
    matrix). Returns (best_d2 (P,), best_label (P,))."""
    P = point_label.shape[0]
    ny, nx = grid_shape
    G = ny * nx
    X = xyz[:G].reshape(ny, nx, 3)
    lab = point_label[:G].reshape(ny, nx)
    trk = tracked_ok[:G].reshape(ny, nx)

    nt = _patches(trk, c, 0.0) > 0.5                # (W^2, ny, nx)
    nl = _patches(lab, c, -1.0).astype(jnp.int32)
    d3 = sum((_patches(X[..., i], c, 1e9) - X[..., i]) ** 2
             for i in range(3))
    d3 = jnp.where(nt, d3, jnp.inf)
    kbest = jnp.argmin(d3, axis=0)                  # (ny, nx)
    best_d2 = jnp.min(d3, axis=0)
    karange = jnp.arange(d3.shape[0])[:, None, None]
    best_lab = jnp.sum(jnp.where(karange == kbest[None], nl, 0), axis=0)
    best_lab = jnp.where(jnp.isfinite(best_d2), best_lab, -1)
    out_d2 = jnp.full((P,), jnp.inf).at[:G].set(best_d2.reshape(-1))
    out_lab = jnp.full((P,), -1, jnp.int32).at[:G].set(
        best_lab.reshape(-1))
    return out_d2, out_lab


def _sample_grid(h: int, w: int, stride: int, max_points: int):
    ys = np.arange(stride // 2, h, stride)
    xs = np.arange(stride // 2, w, stride)
    uu, vv = np.meshgrid(xs, ys)
    pts = np.stack([uu.ravel(), vv.ravel()], axis=-1).astype(np.int32)
    if pts.shape[0] > max_points:
        raise ValueError(
            f"sample grid {len(ys)}x{len(xs)}={pts.shape[0]} exceeds "
            f"max_points={max_points}; raise max_points or the stride "
            "(label propagation needs the full grid resident)")
    pad = max_points - pts.shape[0]
    mask = np.ones(pts.shape[0], bool)
    if pad > 0:
        pts = np.pad(pts, ((0, pad), (0, 0)))
        mask = np.pad(mask, (0, pad))
    return pts, mask, (len(ys), len(xs))


def dense_frame(gray_l: jnp.ndarray, gray_r: jnp.ndarray,
                prev_gray: jnp.ndarray, cam: CameraConfig,
                cfg: DenseConfig) -> DenseFrame:
    """One jittable per-pair pass: edges, disparity, flow, samples."""
    h, w = gray_l.shape
    edge = stereo_bm.sobel_edge_mask(gray_l)
    disp = stereo_bm.disparity(gray_l, gray_r, cfg.num_disparities,
                               cfg.block_size)
    disp = jnp.where(edge, disp, 0.0)
    depth = jnp.where(disp > 0, cam.fx * cam.baseline
                      / jnp.maximum(disp, 1e-3), 0.0)
    flw = flow_mod.farneback_flow(prev_gray, gray_l,
                                  levels=cfg.flow_levels, win=cfg.flow_win,
                                  max_flow_x=cfg.max_flow_x,
                                  max_flow_y=cfg.max_flow_y)
    mag = jnp.linalg.norm(flw, axis=-1)
    p95 = jnp.percentile(mag.reshape(-1), 95.0)

    grid, gmask, _ = _sample_grid(h, w, cfg.sample_stride, cfg.max_points)
    grid_j = jnp.asarray(grid)
    d = disp[grid_j[:, 1], grid_j[:, 0]]
    ok = jnp.asarray(gmask) & (d > cfg.min_disparity) & \
        (d < cfg.max_disparity)
    z = cam.fx * cam.baseline / jnp.maximum(d, 1e-3)
    x = (grid_j[:, 0] - cam.cx) / cam.fx * z
    y = (grid_j[:, 1] - cam.cy) / cam.fy * z
    xyz = jnp.stack([x, y, z], axis=-1)
    return DenseFrame(disparity=disp, depth=depth, flow=flw, edge_mask=edge,
                      pts_uv=grid_j.astype(jnp.float32),
                      pts_xyz=jnp.where(ok[:, None], xyz, 0.0),
                      pts_valid=ok, flow_p95=p95)


class TrackOut(NamedTuple):
    labels: jnp.ndarray        # (P,) int32, -1 untracked
    cluster_T: jnp.ndarray     # (C, 4, 4) accepted rigid motions
    cluster_ok: jnp.ndarray    # (C,) bool PnP accepted
    cluster_inl: jnp.ndarray   # (C,) int32 inlier counts
    cand_counts: jnp.ndarray   # (C,) int32 propagated-candidate counts


def _grid_cell_index(uv: jnp.ndarray, stride: int, ny: int, nx: int):
    """Pixel coords -> nearest sample-grid point index (the implicit
    label mask of ref MakeMask :394-409: each grid point owns its
    stride-sized cell). Returns (idx (P,), in_grid (P,))."""
    ix = jnp.round((uv[:, 0] - stride // 2) / stride).astype(jnp.int32)
    iy = jnp.round((uv[:, 1] - stride // 2) / stride).astype(jnp.int32)
    ok = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    idx = jnp.clip(iy, 0, ny - 1) * nx + jnp.clip(ix, 0, nx - 1)
    return idx, ok


def track_clusters(f: DenseFrame, prev_labels: jnp.ndarray,
                   prev_depth: jnp.ndarray, is_ground: jnp.ndarray,
                   alive: jnp.ndarray, key: jnp.ndarray,
                   cam: CameraConfig, cfg: DenseConfig,
                   grid_shape) -> TrackOut:
    """TrackCluster (ref tracker.cpp:518-693), one jittable pass.

    All C cluster slots run PnP-RANSAC in ONE vmapped dispatch; the
    per-step absorption and the EuclideanFilter drift split are dense
    masked reductions.
    """
    P = f.pts_uv.shape[0]
    C = cfg.max_clusters
    ny, nx = grid_shape
    h, w = f.depth.shape
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    # -- step 1 (ref :529-544): flow-propagated candidate labels -------
    iy = jnp.clip(f.pts_uv[:, 1].astype(jnp.int32), 0, h - 1)
    ix = jnp.clip(f.pts_uv[:, 0].astype(jnp.int32), 0, w - 1)
    img0 = f.pts_uv - f.flow[iy, ix]                      # prev-frame px
    in_img = ((img0[:, 0] >= 0) & (img0[:, 0] < w)
              & (img0[:, 1] >= 0) & (img0[:, 1] < h))
    cell, cell_ok = _grid_cell_index(img0, cfg.sample_stride, ny, nx)
    cand = jnp.where(f.pts_valid & in_img & cell_ok,
                     prev_labels[cell], -1)               # (P,)

    img0_norm = jnp.stack([(img0[:, 0] - cx) / fx,
                           (img0[:, 1] - cy) / fy], axis=-1)

    member = (cand[None, :] == jnp.arange(C)[:, None]) & alive[:, None]
    counts = member.sum(axis=1)                           # (C,)
    active = alive & (counts >= cfg.min_track_points)     # ref :554

    # -- step 2 (ref :567-592): per-cluster PnP-RANSAC, one dispatch ---
    M = min(cfg.track_capacity, P)
    order = jnp.argsort(~member, axis=1)[:, :M]           # members first
    memb_ok = jnp.take_along_axis(member, order, axis=1)  # (C, M)
    memb_xyz = f.pts_xyz[order]                           # (C, M, 3)
    memb_uv0 = img0_norm[order]                           # (C, M, 2)
    keys = jax.random.split(key, C)
    inlier_norm = cfg.max_rprj_px / fx

    res = jax.vmap(
        lambda X, z, m, k: ransac_mod.pnp_ransac(
            X, z, m, k, n_hypotheses=64,
            inlier_norm=inlier_norm,
            min_inliers=cfg.min_track_inliers)
    )(memb_xyz, memb_uv0, memb_ok, keys)
    cluster_ok = active & res.ok                          # (C,)

    # scatter accepted inliers back to point labels (members are
    # disjoint across clusters, so a plain max-combine is exact)
    inl_gathered = res.inliers & memb_ok & cluster_ok[:, None]  # (C, M)
    point_label = jnp.full((P,), -1, jnp.int32)
    lab_rows = jnp.where(inl_gathered, jnp.arange(C)[:, None], -1)
    point_label = point_label.at[order.reshape(-1)].max(
        lab_rows.reshape(-1).astype(jnp.int32))
    tracked = point_label >= 0

    # -- step 3 (ref :595-625): reprojection re-absorption under
    # GROUND cluster motion (anti-oversegmentation for the ground plane)
    Xc = jnp.einsum('cij,pj->cpi', res.T_cw[:, :3, :3], f.pts_xyz) \
        + res.T_cw[:, None, :3, 3]                        # (C, P, 3)
    zc = jnp.where(Xc[..., 2] > 1e-3, Xc[..., 2], 1.0)
    pred = Xc[..., :2] / zc[..., None]
    rprj_px = jnp.linalg.norm(
        (pred - img0_norm[None]) * jnp.asarray([fx, fy]), axis=-1)
    absorb = (cluster_ok & is_ground)[:, None] & (Xc[..., 2] > 1e-3) \
        & (rprj_px < cfg.max_rprj_px) \
        & (~tracked)[None, :] & f.pts_valid[None, :] & in_img[None, :]
    ground_lab = jnp.max(
        jnp.where(absorb, jnp.arange(C)[:, None], -1), axis=0)
    point_label = jnp.where((point_label < 0) & (ground_lab >= 0),
                            ground_lab, point_label)
    tracked = point_label >= 0

    # -- steps 4-5 (ref :627-662): 3D nearest-neighbor absorption ------
    # stencil form: the nearest tracked point within the radius always
    # sits inside the pixel window (see _window_cells)
    wc = _window_cells(cam, cfg)
    r2 = cfg.cluster_radius_3d ** 2
    nn_d2, nn_lab = _grid_absorb(point_label, tracked & f.pts_valid,
                                 f.pts_xyz, grid_shape, wc)
    adopt = (~tracked) & f.pts_valid & (nn_d2 <= r2)
    point_label = jnp.where(adopt, nn_lab, point_label)
    tracked = point_label >= 0

    # -- step 6 (ref :411-516): EuclideanFilter drift split ------------
    # connected components per NON-ground cluster (adjacency requires
    # same label), keep only sub-components with >= min_near_points
    # near (<near_z) members; everything else drops to -1.
    lab_ground = jnp.where(point_label >= 0, is_ground[
        jnp.clip(point_label, 0, C - 1)], False)
    filt = tracked & ~lab_ground & f.pts_valid
    comp = _grid_cc(filt, f.pts_xyz, grid_shape, wc,
                    cfg.cluster_radius_3d, point_label=point_label)
    near = filt & (f.pts_xyz[:, 2] < cfg.near_z)
    near_count = jnp.zeros((P + 1,), jnp.int32).at[comp].add(
        near.astype(jnp.int32))[comp]
    keep = ~filt | (near_count >= cfg.min_near_points)
    point_label = jnp.where(keep, point_label, -1)

    return TrackOut(labels=point_label, cluster_T=res.T_cw,
                    cluster_ok=cluster_ok,
                    cluster_inl=res.n_inliers.astype(jnp.int32),
                    cand_counts=counts.astype(jnp.int32))


class RansacRoundOut(NamedTuple):
    comp: jnp.ndarray          # (P,) int32 component root per inlier, -1 else
    comp_size: jnp.ndarray     # (P,) int32 component size at each point
    n_step1: jnp.ndarray       # () inliers surviving both gates
    T_cw: jnp.ndarray          # (4, 4)


def ransac_round(f: DenseFrame, residual: jnp.ndarray,
                 prev_depth: jnp.ndarray, is_ground_round: jnp.ndarray,
                 key: jnp.ndarray, cam: CameraConfig,
                 cfg: DenseConfig, grid_shape=None) -> RansacRoundOut:
    """One RansacCluster iteration (ref tracker.cpp:238-389), jittable.

    Rigid RANSAC over the residual pool, the disparity-consistency gate
    (ref :274-282), then Euclidean clustering of the surviving inliers
    with the ground-2D(px)/object-3D(m) coordinate choice (ref
    :315-323). Component-id assignment happens on the host.
    """
    P = f.pts_uv.shape[0]
    h, w = f.depth.shape
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy

    iy = jnp.clip(f.pts_uv[:, 1].astype(jnp.int32), 0, h - 1)
    ix = jnp.clip(f.pts_uv[:, 0].astype(jnp.int32), 0, w - 1)
    img0 = f.pts_uv - f.flow[iy, ix]
    in_img = ((img0[:, 0] >= 0) & (img0[:, 0] < w)
              & (img0[:, 1] >= 0) & (img0[:, 1] < h))
    img0_norm = jnp.stack([(img0[:, 0] - cx) / fx,
                           (img0[:, 1] - cy) / fy], axis=-1)

    pool = residual & f.pts_valid & in_img
    res = ransac_mod.pnp_ransac(
        f.pts_xyz, img0_norm, pool, key, n_hypotheses=100,
        inlier_norm=cfg.max_rprj_px / fx, min_inliers=cfg.min_cluster_size)

    # disparity-consistency gate (ref :274-282): predicted inverse depth
    # in the PREVIOUS camera vs the previous frame's measured depth at
    # the warped pixel, scaled to disparity pixels.
    i0y = jnp.clip(jnp.round(img0[:, 1]).astype(jnp.int32), 0, h - 1)
    i0x = jnp.clip(jnp.round(img0[:, 0]).astype(jnp.int32), 0, w - 1)
    d0 = prev_depth[i0y, i0x]
    Xc = jnp.einsum('ij,pj->pi', res.T_cw[:3, :3], f.pts_xyz) \
        + res.T_cw[:3, 3]
    zc = jnp.maximum(Xc[:, 2], 1e-3)
    disp_err = fx * cam.baseline * jnp.abs(
        1.0 / jnp.maximum(d0, 1e-3) - 1.0 / zc)
    gate = (d0 <= 0.0) | (disp_err <= cfg.disp_consistency_px)
    step1 = res.inliers & pool & gate
    n_step1 = jnp.sum(step1)

    # Euclidean clustering of step-1 inliers: ground rounds use 2D
    # pixel coords r=20 px, object rounds 3D coords r=0.5 m (ref
    # :315-323) — as a grid stencil (ground adjacency is then STATIC
    # per offset: the samples are grid points, so pixel distance is
    # stride*hypot(dy, dx))
    comp = _grid_cc(step1, f.pts_xyz, grid_shape, _window_cells(cam, cfg),
                    cfg.cluster_radius_3d,
                    is_ground_round=is_ground_round,
                    rpx=cfg.ground_radius_px, stride=cfg.sample_stride)
    size = jnp.zeros((P + 1,), jnp.int32).at[comp].add(
        step1.astype(jnp.int32))[comp]
    comp = jnp.where(step1, comp, -1)
    size = jnp.where(step1, size, 0)
    return RansacRoundOut(comp=comp, comp_size=size, n_step1=n_step1,
                          T_cw=res.T_cw)


class FusedState(NamedTuple):
    """Device-resident inter-frame state of the fused dense tracker."""
    labels: jnp.ndarray        # (P,) int32, -1 untracked
    is_ground: jnp.ndarray     # (C,) bool
    alive: jnp.ndarray         # (C,) bool
    ever_created: jnp.ndarray  # () bool (ref's clusters_.empty() test)
    prev_gray: jnp.ndarray     # (H, W)
    prev_depth: jnp.ndarray    # (H, W)


class FusedOut(NamedTuple):
    labels: jnp.ndarray        # (P,) int32
    skipped: jnp.ndarray       # () bool (low-motion gate)
    flow_p95: jnp.ndarray      # ()
    n_points: jnp.ndarray      # () int32 valid samples
    n_tracked: jnp.ndarray     # () int32 labeled samples
    n_new: jnp.ndarray         # () int32 clusters created this frame
    cluster_T: jnp.ndarray     # (C, 4, 4) tracked rigid motions
    cluster_ok: jnp.ndarray    # (C,) bool PnP accepted
    sizes: jnp.ndarray         # (C,) int32 member counts
    is_ground: jnp.ndarray     # (C,) bool


def fused_step(state: FusedState, gl: jnp.ndarray, gr: jnp.ndarray,
               key: jnp.ndarray, cam: CameraConfig, cfg: DenseConfig,
               grid_shape) -> tuple:
    """ONE jittable program per stereo pair: dense_frame + TrackCluster
    + the residual RansacCluster rounds WITH on-device cluster-slot
    allocation.

    The stepwise host driver (DenseTracker.track) syncs with the device
    once per stage, ~8 times per frame. Here the whole
    per-frame loop including the reference's while(true) RansacCluster
    (ref examples/epip_cluster/src/tracker.cpp:238-389) runs on device:
    rounds are a lax.scan whose body is lax.cond-gated (a finished
    round costs nothing), and the host's first-free-slot id allocation
    becomes rank-over-free-slots arithmetic: component roots are the
    points with comp[p]==p, ranked by cumsum, assigned
    argsort(alive)[rank] — bit-identical to the sequential allocator
    (tests/test_dense_tracker.py asserts fused == stepwise labels).

    Skip semantics mirror the reference: below the p95 flow gate the
    state (incl. prev frame) is returned UNCHANGED so motion
    accumulates (ref :722-724, returns before the :750-752 update)."""
    C = cfg.max_clusters
    P = cfg.max_points
    f = dense_frame(gl, gr, state.prev_gray, cam, cfg)
    skip = f.flow_p95 < cfg.min_flow_p95

    def pack(res: FusedOut) -> jnp.ndarray:
        """ONE flat f32 output vector per frame: one readback per
        frame instead of one per output leaf (the scan engine's
        one-packed-array-per-dispatch pattern). Labels are cluster ids
        < 2^24 — exact in f32."""
        return jnp.concatenate([
            res.labels.astype(jnp.float32),
            jnp.stack([res.skipped.astype(jnp.float32),
                       res.flow_p95,
                       res.n_points.astype(jnp.float32),
                       res.n_tracked.astype(jnp.float32),
                       res.n_new.astype(jnp.float32)]),
            res.sizes.astype(jnp.float32),
            res.is_ground.astype(jnp.float32),
            res.cluster_ok.astype(jnp.float32),
            res.cluster_T.reshape(-1)])

    def run(_):
        out = track_clusters(f, state.labels, state.prev_depth,
                             state.is_ground, state.alive, key, cam,
                             cfg, grid_shape)

        def round_body(carry, rnd):
            labels, alive, is_ground, ever, done = carry
            residual = labels < 0
            do = (~done) & (jnp.sum(residual) >= 10)      # ref :239
            ground_round = ~ever                          # ref :315

            def do_round(_):
                rk = jax.random.fold_in(key, 100 + rnd)
                rout = ransac_round(f, residual, state.prev_depth,
                                    ground_round, rk, cam, cfg,
                                    grid_shape)
                comp, size = rout.comp, rout.comp_size
                root = (comp == jnp.arange(P)) \
                    & (size >= cfg.min_cluster_size) \
                    & (rout.n_step1 >= cfg.min_cluster_size)
                rank = jnp.cumsum(root.astype(jnp.int32)) - 1
                free_order = jnp.argsort(alive)   # free slots ascending
                n_free = C - jnp.sum(alive)
                ok_root = root & (rank < n_free)
                cid_root = jnp.where(
                    ok_root, free_order[jnp.clip(rank, 0, C - 1)], -1)
                cid_pt = jnp.where(comp >= 0,
                                   cid_root[jnp.clip(comp, 0, P - 1)], -1)
                assign = cid_pt >= 0
                slot = jnp.where(ok_root, cid_root, C)
                alive2 = alive.at[slot].set(True, mode='drop')
                ground2 = is_ground.at[slot].set(ground_round,
                                                 mode='drop')
                labels2 = jnp.where(assign, cid_pt, labels)
                assigned = jnp.sum(assign)
                ever2 = ever | (assigned > 0)
                done2 = done \
                    | (rout.n_step1 < cfg.min_cluster_size) \
                    | (assigned < cfg.min_cluster_size)   # ref :381-383
                return (labels2, alive2, ground2, ever2, done2,
                        jnp.sum(ok_root))

            def skip_round(_):
                return (labels, alive, is_ground, ever, jnp.bool_(True),
                        jnp.int32(0))

            labels2, alive2, ground2, ever2, done2, n_created = \
                jax.lax.cond(do, do_round, skip_round, None)
            return (labels2, alive2, ground2, ever2, done2), n_created

        carry0 = (out.labels, state.alive, state.is_ground,
                  state.ever_created, jnp.bool_(False))
        (labels, alive, is_ground, ever, _), created = jax.lax.scan(
            round_body, carry0, jnp.arange(cfg.max_ransac_rounds))

        # alive <- labels actually present (ref: mask0_ rebuild :747)
        cnt = jnp.zeros((C + 1,), jnp.int32).at[
            jnp.where(labels >= 0, labels, C)].add(1)
        alive = cnt[:C] > 0
        new_state = FusedState(labels=labels, is_ground=is_ground,
                               alive=alive, ever_created=ever,
                               prev_gray=gl, prev_depth=f.depth)
        res = FusedOut(labels=labels, skipped=jnp.bool_(False),
                       flow_p95=f.flow_p95,
                       n_points=jnp.sum(f.pts_valid).astype(jnp.int32),
                       n_tracked=jnp.sum(labels >= 0).astype(jnp.int32),
                       n_new=jnp.sum(created).astype(jnp.int32),
                       cluster_T=out.cluster_T, cluster_ok=out.cluster_ok,
                       sizes=cnt[:C], is_ground=is_ground)
        return new_state, pack(res)

    def skipped(_):
        res = FusedOut(labels=state.labels, skipped=jnp.bool_(True),
                       flow_p95=f.flow_p95,
                       n_points=jnp.sum(f.pts_valid).astype(jnp.int32),
                       n_tracked=jnp.int32(-1), n_new=jnp.int32(0),
                       cluster_T=jnp.zeros((C, 4, 4)),
                       cluster_ok=jnp.zeros((C,), bool),
                       sizes=jnp.zeros((C,), jnp.int32),
                       is_ground=state.is_ground)
        return state, pack(res)

    return jax.lax.cond(skip, skipped, run, None)


class FusedDenseTracker:
    """Pipelined production driver over fused_step: one dispatch + one
    async readback per frame at queue depth 2, so the readback rides
    behind the next frames' device time (the same overlap the
    SLAM scan engine uses; the reference overlaps nothing — its GPU ops
    block per call, ref tracker.cpp:700-713)."""

    def __init__(self, cam: CameraConfig, cfg: Optional[DenseConfig] = None,
                 queue_depth: int = 2):
        self.cam = cam
        self.cfg = cfg or DenseConfig()
        cfg_, cam_ = self.cfg, cam
        _, _, self._grid_shape = _sample_grid(
            cam.height, cam.width, cfg_.sample_stride, cfg_.max_points)
        gs = self._grid_shape

        @partial(jax.jit, donate_argnums=0)
        def _step(state, gl, gr, k):
            return fused_step(state, gl, gr, k, cam_, cfg_, gs)

        @jax.jit
        def _seed(gl, gr):
            f0 = dense_frame(gl, gr, gl, cam_, cfg_)
            return FusedState(
                labels=jnp.full((cfg_.max_points,), -1, jnp.int32),
                is_ground=jnp.zeros((cfg_.max_clusters,), bool),
                alive=jnp.zeros((cfg_.max_clusters,), bool),
                ever_created=jnp.bool_(False),
                prev_gray=gl, prev_depth=f0.depth)

        self._step_fn = _step
        self._seed_fn = _seed
        self._state = None
        self._queue = []
        self._queue_depth = queue_depth
        self.frame_idx = 0

    def _fold(self) -> dict:
        v = np.asarray(self._queue.pop(0))     # ONE readback per frame
        P, C = self.cfg.max_points, self.cfg.max_clusters
        s = P
        scalars = v[s:s + 5]
        sizes = v[s + 5:s + 5 + C].astype(np.int32)
        isg = v[s + 5 + C:s + 5 + 2 * C] > 0.5
        ok = v[s + 5 + 2 * C:s + 5 + 3 * C] > 0.5
        Ts = v[s + 5 + 3 * C:].reshape(C, 4, 4)
        return {"skipped": bool(scalars[0] > 0.5),
                "flow_p95": float(scalars[1]),
                "n_points": int(scalars[2]),
                "n_tracked": int(scalars[3]),
                "n_new_clusters": int(scalars[4]),
                "labels": v[:P].astype(np.int32),
                "sizes": sizes,
                "is_ground": isg,
                "cluster_T": Ts,
                "cluster_ok": ok}

    def process(self, gray_l, gray_r) -> Optional[dict]:
        """Dispatch one pair; returns the result of the frame dispatched
        queue_depth earlier (None while the pipeline fills)."""
        gl = jnp.asarray(gray_l, jnp.float32)
        gr = jnp.asarray(gray_r, jnp.float32)
        self.frame_idx += 1
        if self._state is None:
            self._state = self._seed_fn(gl, gr)
            return None
        key = jax.random.PRNGKey(self.frame_idx)
        self._state, packed = self._step_fn(self._state, gl, gr, key)
        try:
            packed.copy_to_host_async()
        except Exception:       # non-jax backends in tests
            pass
        self._queue.append(packed)
        # re-issue the async copy for the OLDEST queued result: issued
        # at dispatch time (before the program ran) the copy is silently
        # lost and the fold's np.asarray pays a full synchronous
        # readback (same fix as scan_engine._reissue_copies)
        try:
            self._queue[0].copy_to_host_async()
        except Exception:       # non-jax backends in tests
            pass
        if len(self._queue) > self._queue_depth:
            return self._fold()
        return None

    def flush(self) -> list:
        outs = []
        while self._queue:
            outs.append(self._fold())
        return outs


class DenseTracker:
    """Host driver holding previous-frame state and cluster labels.

    Inter-frame state mirrors the reference's members: `labels` is the
    sample-grid form of mask0_ (ref tracker.cpp:747), `is_ground`/`alive`
    the cluster_ground_/clusters_ maps, `prev_depth` depth0_ (:750), and
    `prev_gray` gray0_ (:751). Cluster-id slots are bounded at
    cfg.max_clusters and dead ids are recycled (deviation from the
    reference's unbounded n_cluster_ counter — required for fixed
    shapes; ids stay stable while a cluster remains tracked).
    """

    def __init__(self, cam: CameraConfig, cfg: Optional[DenseConfig] = None):
        self.cam = cam
        self.cfg = cfg or DenseConfig()
        self.prev_gray: Optional[jnp.ndarray] = None
        self.prev_frame: Optional[DenseFrame] = None
        self.prev_depth: Optional[jnp.ndarray] = None
        self.frame_idx = 0
        cfg_ = self.cfg
        cam_ = cam
        self.labels: Optional[np.ndarray] = None          # (P,) int32
        self.is_ground = np.zeros(cfg_.max_clusters, bool)
        self.alive = np.zeros(cfg_.max_clusters, bool)
        self.ever_created = False
        self._grid_shape = None

        @jax.jit
        def _frame(gl, gr, pg):
            return dense_frame(gl, gr, pg, cam_, cfg_)

        def _track(f, prev_labels, prev_depth, is_ground, alive, key,
                   grid_shape):
            return track_clusters(f, prev_labels, prev_depth, is_ground,
                                  alive, key, cam_, cfg_, grid_shape)

        def _round(f, residual, prev_depth, is_ground_round, key,
                   grid_shape):
            return ransac_round(f, residual, prev_depth, is_ground_round,
                                key, cam_, cfg_, grid_shape)

        self._frame = _frame
        self._track = jax.jit(_track, static_argnames=("grid_shape",))
        self._round = jax.jit(_round, static_argnames=("grid_shape",))

    def _alloc_cluster(self, ground: bool) -> int:
        """Allocate a cluster id slot; -1 when capacity is exhausted."""
        free = np.flatnonzero(~self.alive)
        if free.size == 0:
            return -1
        cid = int(free[0])
        self.alive[cid] = True
        self.is_ground[cid] = ground
        return cid

    def track(self, gray_l: np.ndarray, gray_r: np.ndarray) -> dict:
        """Process one stereo pair; returns cluster summary (host dict).

        Mirrors DenseTracker::Track (ref tracker.cpp:695-784): first
        frame only seeds depth/gray; low-motion frames are skipped
        WITHOUT advancing the reference frame (ref returns before the
        gray0_/depth0_ update at :750-752, so motion accumulates until
        the p95 gate passes).
        """
        cfg = self.cfg
        gl = jnp.asarray(gray_l, jnp.float32)
        gr = jnp.asarray(gray_r, jnp.float32)
        self.frame_idx += 1
        if self._grid_shape is None:
            _, _, self._grid_shape = _sample_grid(
                gl.shape[0], gl.shape[1], cfg.sample_stride, cfg.max_points)
        if self.prev_gray is None:
            # seed: depth only (ref :710-714)
            f0 = self._frame(gl, gr, gl)
            self.prev_gray = gl
            self.prev_depth = f0.depth
            return {"skipped": True, "reason": "first frame"}

        f = self._frame(gl, gr, self.prev_gray)
        if float(f.flow_p95) < cfg.min_flow_p95:
            return {"skipped": True, "reason": "low motion",
                    "flow_p95": float(f.flow_p95)}

        key = jax.random.PRNGKey(self.frame_idx)
        P = int(f.pts_uv.shape[0])
        clusters = []

        # ---- 1) TrackCluster: propagate previous labels (ref :740-741)
        if self.labels is not None and self.alive.any():
            out = self._track(f, jnp.asarray(self.labels),
                              self.prev_depth, jnp.asarray(self.is_ground),
                              jnp.asarray(self.alive), key,
                              self._grid_shape)
            labels = np.array(out.labels)        # copy: host loop mutates
            ok = np.asarray(out.cluster_ok)
            inl = np.asarray(out.cluster_inl)
            Ts = np.asarray(out.cluster_T)
            for cid in np.flatnonzero(ok):
                clusters.append({
                    "id": int(cid), "tracked": True,
                    "is_ground": bool(self.is_ground[cid]),
                    "size": int((labels == cid).sum()),
                    "rigid_inliers": int(inl[cid]), "ok": True,
                    "T": Ts[cid],
                })
        else:
            labels = np.full(P, -1, np.int32)

        # ---- 2) RansacCluster on the residual pool (ref :743-744) ----
        residual = labels < 0
        n_new = 0
        for rnd in range(cfg.max_ransac_rounds):
            if int(residual.sum()) < 10:                  # ref :239
                break
            ground_round = not self.ever_created          # ref :315
            rout = self._round(f, jnp.asarray(residual), self.prev_depth,
                               jnp.asarray(ground_round),
                               jax.random.fold_in(key, 100 + rnd),
                               self._grid_shape)
            comp = np.asarray(rout.comp)
            size = np.asarray(rout.comp_size)
            if int(rout.n_step1) < cfg.min_cluster_size:  # ref :297
                break
            big_roots = np.unique(comp[(comp >= 0)
                                       & (size >= cfg.min_cluster_size)])
            assigned = 0
            T_round = np.asarray(rout.T_cw)
            for root in big_roots:
                cid = self._alloc_cluster(ground_round)
                if cid < 0:
                    break                                 # capacity full
                members = comp == root
                labels[members] = cid
                residual[members] = False
                assigned += int(members.sum())
                n_new += 1
                clusters.append({
                    "id": cid, "tracked": False,
                    "is_ground": bool(self.is_ground[cid]),
                    "size": int(members.sum()),
                    "rigid_inliers": int(members.sum()), "ok": True,
                    "T": T_round,
                })
                self.ever_created = True
            if assigned < cfg.min_cluster_size:           # ref :381-383
                break

        # ---- 3) persist state: the label grid is the new mask0_ ------
        self.alive = np.isin(np.arange(cfg.max_clusters), labels)
        self.labels = labels
        self.prev_gray = gl
        self.prev_depth = f.depth
        self.prev_frame = f

        return {"skipped": False, "flow_p95": float(f.flow_p95),
                "n_points": int(f.pts_valid.sum()),
                "n_tracked": int((labels >= 0).sum()),
                "n_new_clusters": n_new,
                "labels": labels,
                "pts_uv": np.asarray(f.pts_uv),
                "clusters": clusters}
