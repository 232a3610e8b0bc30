"""Headline benchmark: tracking + local-BA throughput at KITTI scale.

Prints ONE JSON line {"metric", "value", "unit", ..., "device"}; the
device is JAX's platform, device kind and device count. It runs only on
a GPU and fails without one.

Workload mirrors the reference's per-frame loop (ref src/pipeline.cpp:
143-225 + mapping-thread local BA :137-138) on KITTI-sized synthetic
stereo frames (1241x376, 2000 ORB features): the chunked on-device
driver (pipeline/scan_engine.py) runs ORB extraction, matching, pose LM,
the keyframe decision, stereo landmark supply, and local bundle
adjustment inside one lax.scan program; the host touches the device once
per chunk. Ground truth doubles as an accuracy check (ATE printed to
stderr).

Frames are staged in device memory before timing (staging stands in
for the upload pipeline a production host would overlap). Rendered
frames are cached under `.bench_data/` in the checkout.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np

from slam_toolkit_tpu.utils.paths import data_path


def _device() -> dict:
    """JAX's first device as {"platform", "kind", "count"}; exits 1
    when it is not a GPU (no CPU number is ever printed as a device
    metric)."""
    import jax
    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    if d.platform != "gpu":
        sys.stderr.write(f"[bench] FATAL: needs a GPU, JAX found {info}\n")
        sys.exit(1)
    return info


def _emit(out: dict) -> None:
    out["device"] = _device()
    print(json.dumps(out))


def stage_loop(cfg, n: int, chunk: int, track_kind: str = "clothoid"):
    """Render-or-map the loop cell's revisiting drive and train-or-load
    its vocabulary, both cached in the checkout's data directory:
    returns ((N, 2, H, W) uint8 frames, gt poses, vocabulary, lap,
    revisit), the drive re-entering its start at frame `lap` for
    `revisit` frames.

    track_kind "fig8": figure-eight — TWO distinct closures (each lobe
    closes at the shared junction), the second landing AFTER the first
    correction, plus a final pass over lobe 1's start (ref closed-loop
    replay ring src/loopcloser.cpp:160-191)."""
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.data.synthetic import (loop_track, make_world,
                                                 render_stereo)
    from slam_toolkit_tpu.loop import vocab as V
    from slam_toolkit_tpu.ops.extractor import extract

    step = 0.8
    if track_kind == "fig8":
        lobe = (n - 2 * chunk) // 3 // chunk * chunk
        revisit = n - 3 * lobe
        lap = 3 * lobe                       # final pass starts here
        extent = lobe * step / 3.0
    else:
        lap = (n * 17 // 20) // chunk * chunk   # close the track at ~85%,
        revisit = n - lap                        # then re-drive the start
        extent = lap * step / 4.0                # rough track half-extent

    t_setup = time.perf_counter()
    cache = data_path(
        f"loop_seq_v2_{track_kind + '_' if track_kind != 'clothoid' else ''}"
        f"{n}_{cfg.camera.width}x{cfg.camera.height}")
    if os.path.exists(cache + ".npy"):
        stacked = np.load(cache + ".npy", mmap_mode="r")
        gt = list(np.load(cache + ".gt.npy"))
        sys.stderr.write(f"[bench-loop] mapped {n} cached frames\n")
    else:
        # tex_size/texels_per_m chosen so the wrap period (2048/12 =
        # 170 m) exceeds the scene diameter: with the default 21 m
        # tiling, loop relative-pose locked onto a texture-period-
        # shifted solution with 148 self-consistent "inliers" and a
        # 14 m-wrong translation. Real imagery does not tile; the
        # synthetic world must not either.
        # NOTE (r5): a fine-detail octave + lens-PSF variant of this
        # world (make_world detail_texels_per_m/psf_sigma, kept
        # available) was built to give the near field matchable
        # structure — without it near matches are inherently aliased
        # (8.5 px/texel magnified blobs at z=7 m), the map goes
        # far-only, and the loop edge inherits the far-field
        # yaw/lateral valley (r5 dissection). Measured END-TO-END it
        # degraded tracking (open-loop drift 1.9 -> 5.1 m even with the
        # 0.7 px PSF: the detail's pixel-footprint variance decorrelates
        # descriptors under motion), so the bench stays on the plain
        # world and the near-geometry fix lives in the loop measurement
        # (relpose_stereo_aug) instead.
        world = make_world(cfg, seed=7, half_width=extent + 12.0,
                           half_length=extent + 12.0, ground_y=1.6,
                           tex_size=2048, texels_per_m=12.0)
        if track_kind == "fig8":
            from slam_toolkit_tpu.data.synthetic import fig8_track
            f8 = fig8_track(lobe, step=step)
            lobe1, lobe2 = f8[:lobe], f8[lobe:]
            gt = lobe1 + lobe1 + lobe2 + lobe1[:revisit]
        else:
            track = loop_track(lap, step=step)
            gt = track + track[:revisit]
        frames = [render_stereo(world, T) for T in gt]
        stacked = np.stack([
            np.stack([np.clip(l, 0, 255), np.clip(r, 0, 255)])
            for l, r in frames]).astype(np.uint8)
        np.save(cache + ".npy", stacked)
        np.save(cache + ".gt.npy", np.stack(gt))
        sys.stderr.write(f"[bench-loop] rendered {n} frames in "
                         f"{time.perf_counter() - t_setup:.1f}s\n")

    voc_path = data_path(f"loop_vocab_{n}.txt")
    if os.path.exists(voc_path):
        voc = V.load_dbow2_text(voc_path)   # exercises the DBoW2 loader
    else:
        ex = jax.jit(lambda im: extract(im, cfg.extractor))
        corpus = []
        for i in range(0, n, 8):
            f = ex(jnp.asarray(stacked[i, 0], jnp.float32))
            corpus.append(np.asarray(f.desc)[np.asarray(f.valid)])
        voc = V.train(np.concatenate(corpus), k=10, levels=3, seed=0)
        V.save_dbow2_text(voc, voc_path)
        sys.stderr.write(f"[bench-loop] trained vocab in "
                         f"{time.perf_counter() - t_setup:.1f}s\n")
    return stacked, gt, voc, lap, revisit


def main_loop():
    """BENCH_LOOP=1: full-SLAM variant — KITTI-scale circular revisit
    with a trained binary vocabulary, BoW loop detection and pose-graph
    closing active between chunks (ref src/loopdetector.cpp +
    src/loopcloser.cpp). Reports fps with the
    loop machinery on, plus closure count and the loop-seam error
    (distance between both visits' estimates of the same physical pose —
    the quantity closure exists to shrink). BENCH_LOOP_TRACK=fig8 drives
    the figure-eight (stage_loop)."""
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.evaluation.traj import ate_rmse
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

    cfg = SlamConfig()
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))
    n = int(os.environ.get("BENCH_FRAMES", "320"))
    track_kind = os.environ.get("BENCH_LOOP_TRACK", "clothoid")
    stacked, gt, voc, lap, revisit = stage_loop(cfg, n, chunk, track_kind)

    chunks = [jnp.asarray(stacked[i:i + chunk], jnp.float32)
              for i in range(0, n, chunk)]
    jax.block_until_ready(chunks)

    # BENCH_LOOP_VOCAB=0: same track, detector off — the open-loop drift
    # reference the closure numbers are judged against.
    # BENCH_LOOP_GROUP=sim3: 7-DoF essential-graph closing.
    # BENCH_LOOP_OVER="key=val,key=val": override LoopConfig fields
    # (ints/floats/strs parsed by the field's current type) for on-chip
    # closure-quality experiments.
    if os.environ.get("BENCH_LOOP_VOCAB", "1") == "0":
        voc = None
    import dataclasses
    if os.environ.get("BENCH_LOOP_GROUP"):
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
            cfg.loop, pose_graph_group=os.environ["BENCH_LOOP_GROUP"]))
    if os.environ.get("BENCH_LOOP_OVER"):
        over = {}
        for kv in os.environ["BENCH_LOOP_OVER"].split(","):
            k, v = kv.split("=")
            cur = getattr(cfg.loop, k)
            over[k] = type(cur)(float(v)) if isinstance(cur, (int, float)) \
                else v
        sys.stderr.write(f"[bench-loop] overrides: {over}\n")
        cfg = dataclasses.replace(cfg,
                                  loop=dataclasses.replace(cfg.loop, **over))

    warmup_chunks = 3
    t0 = time.perf_counter()
    eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=chunk)
    for c in chunks[:warmup_chunks]:
        eng.process_chunk(c)
    eng.flush()
    eng.warmup()       # closure-path compiles happen HERE, not mid-run
    sys.stderr.write(f"[bench-loop] warmup (compile) in "
                     f"{time.perf_counter() - t0:.1f}s\n")
    t0 = time.perf_counter()
    for c in chunks[warmup_chunks:]:
        eng.process_chunk(c)
    eng.flush()
    dt = time.perf_counter() - t0
    n_timed = sum(int(c.shape[0]) for c in chunks[warmup_chunks:])

    traj = eng.trajectory_refined()
    ate = ate_rmse(traj, gt, align=True)
    centers = np.stack([-np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3]
                        for T in traj])
    seam = float(np.mean(np.linalg.norm(
        centers[lap:lap + revisit] - centers[:revisit], axis=1)))
    if track_kind == "fig8":
        lobe = lap // 3
        s_lap2 = float(np.mean(np.linalg.norm(
            centers[lobe:2 * lobe:4] - centers[:lobe:4], axis=1)))
        s_lobe2 = float(np.linalg.norm(centers[3 * lobe - 1] - centers[0]))
        sys.stderr.write(f"[bench-loop] fig8 seams: lap2 {s_lap2:.3f} m, "
                         f"lobe2-end {s_lobe2:.3f} m, final-pass "
                         f"{seam:.3f} m\n")
    # seam DISSECTION: where does the residual seam
    # error live? The per-revisit-index profile separates a constant
    # offset (bad loop edge / graph residual) from re-accumulating
    # drift (the revisit not actually tracking lap-1 landmarks after
    # the merge).
    prof = np.linalg.norm(centers[lap:lap + revisit] - centers[:revisit],
                          axis=1)
    q = max(revisit // 4, 1)
    sys.stderr.write(
        f"[bench-loop] seam profile: first-q {prof[:q].mean():.3f} m, "
        f"mid {prof[q:3 * q].mean():.3f} m, last-q {prof[3 * q:].mean():.3f} m "
        f"(constant offset => edge/graph error; growth => revisit "
        f"re-drift)\n")
    gt_centers = np.stack([-np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3]
                           for T in gt])
    drift_rel = np.linalg.norm(
        (centers[lap:lap + revisit] - centers[lap])
        - (gt_centers[lap:lap + revisit] - gt_centers[lap]), axis=1)
    sys.stderr.write(
        f"[bench-loop] revisit drift vs GT (rebased at lap start): "
        f"end {drift_rel[-1]:.3f} m\n")
    closures = [e for e in eng.loop_events if "cand" in e]
    fps = n_timed / dt
    # steady-state cost of ONE chunk with the pipeline drained after it
    # — device execution plus one readback, no overlap. The gap between
    # blocked_ms/chunk and the pipelined wall/frame is what queue-depth-2
    # pipelining hides.
    blocked = []
    for c in chunks[:3]:
        t0 = time.perf_counter()
        eng.process_chunk(c)
        eng.flush()
        blocked.append((time.perf_counter() - t0) * 1000.0)
    blocked_ms = min(blocked)
    sys.stderr.write(
        f"[bench-loop] {n_timed} frames in {dt:.2f}s, {fps:.1f} fps, "
        f"ATE {ate:.3f} m, seam {seam:.3f} m, closures {len(closures)}, "
        f"replays {eng.n_replays}, keyframes {eng._host.n_keyframes}; "
        f"blocked chunk {blocked_ms:.1f} ms "
        f"({blocked_ms / chunk:.2f} ms/frame blocked vs "
        f"{1000.0 / fps:.2f} ms/frame pipelined)\n")
    for e in closures:
        brief = {k: v for k, v in e.items()
                 if k not in ("T_meas", "T_cand_pre")}
        sys.stderr.write(f"[bench-loop] closure: {brief}\n")
        # loop-edge measurement error vs GT (seam dissection: is the
        # residual seam the MEASUREMENT's fault or the graph's?)
        if "T_meas" in e and e.get("fid_cand", -1) >= 0:
            T_meas = np.asarray(e["T_meas"])
            T_cand = np.asarray(e["T_cand_pre"])
            E_meas = T_meas @ np.linalg.inv(T_cand)
            E_gt = np.asarray(gt[e["frame"]]) @ np.linalg.inv(
                np.asarray(gt[e["fid_cand"]]))
            D = E_meas @ np.linalg.inv(E_gt)
            ang = np.degrees(np.arccos(np.clip(
                (np.trace(D[:3, :3]) - 1) / 2, -1, 1)))
            # express the translation error in the CANDIDATE camera
            # frame (x=right, y=down, z=forward): a z-dominant error
            # means depth-direction bias (stereo depth of far points),
            # x/y means lateral mismatch (aliasing / rotation leak)
            t_cam = np.asarray(gt[e["fid_cand"]])[:3, :3] @ D[:3, 3]
            sys.stderr.write(
                f"[bench-loop]   loop-edge error vs GT: "
                f"{np.linalg.norm(D[:3, 3]):.3f} m / {ang:.2f} deg; "
                f"in cand cam frame xyz=({t_cam[0]:+.2f}, {t_cam[1]:+.2f},"
                f" {t_cam[2]:+.2f}) m\n")
    out = {
        "metric": "kitti_scale_full_slam_loop_fps" + (
            f"_{track_kind}" if track_kind != "clothoid" else ""),
        "value": round(fps, 2),
        "unit": "frames/s",
        "ate_m": round(ate, 3),
        "seam_m": round(seam, 3),
        "closures": len(closures),
        "replays": eng.n_replays,
        "blocked_chunk_ms": round(blocked_ms, 1),
        "chunk": chunk,
    }
    if track_kind == "fig8":
        out["seam_lap2_m"] = round(s_lap2, 3)
        out["seam_lobe2_m"] = round(s_lobe2, 3)
    _emit(out)


def main_cluster():
    """BENCH_CLUSTER=1: the dense motion-clustering workload (the
    reference's ONLY GPU-accelerated component — cv::cuda::StereoBM +
    FarnebackOpticalFlow + per-cluster solvePnPRansac, ref
    examples/epip_cluster/src/tracker.cpp:54-57,700-713) at KITTI
    resolution (1241x376, stride-5 grid = 18.6k samples) with temporal
    cluster tracking active. Runs the fused single-program tracker
    (cluster/tracker.py fused_step) pipelined at queue depth 2 over a
    synthetic scene of a laterally-translating camera through a
    depth-banded world plus 3 independent movers; reports fps and
    asserts the movers carry PERSISTENT cluster ids (the reference's
    TrackCluster property) with per-mover rigid motions."""
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.cluster.tracker import (DenseConfig,
                                                  FusedDenseTracker)
    from slam_toolkit_tpu.data.synthetic import make_cluster_scene

    n = int(os.environ.get("BENCH_FRAMES", "60"))
    warm = 5
    scene = make_cluster_scene(n_frames=n)
    cfg = DenseConfig(max_points=18688)
    t0 = time.perf_counter()
    tr = FusedDenseTracker(scene.cam, cfg, queue_depth=2)
    outs = []
    t_start = None
    # stage frames in device memory before timing, like the headline
    # bench (the upload is overlapped by a production host's pipeline)
    staged = [(jnp.asarray(gl, jnp.float32), jnp.asarray(gr, jnp.float32))
              for gl, gr in scene.frames]
    jax.block_until_ready(staged)
    for i, (gl, gr) in enumerate(staged):
        o = tr.process(gl, gr)
        if o is not None:
            outs.append(o)
        if i == 1:
            sys.stderr.write(f"[bench] cluster warmup (compile) "
                             f"{time.perf_counter() - t0:.0f}s\n")
        if i == warm - 1:
            t_start = time.perf_counter()
    outs += tr.flush()
    wall = time.perf_counter() - t_start
    fps = (n - warm) / wall

    # ---- quality: mover id persistence + distinctness ----------------
    from slam_toolkit_tpu.evaluation import cluster_gates
    persist, distinct, ids, alive, n_live = \
        cluster_gates.mover_persistence(scene, cfg, outs, n)
    sys.stderr.write(
        f"[bench] cluster: {fps:.1f} fps, {n_live}/{n} live frames, "
        f"{alive} clusters alive, mover ids {ids} "
        f"persist={persist} distinct={distinct}\n")
    if not (persist and distinct):
        sys.stderr.write("[bench] FAIL: mover tracking unstable\n")
        sys.exit(1)

    # ---- quality: disparity / flow accuracy vs analytic GT -----------
    # probe frames run the SAME jitted dense_frame the fused step
    # traces, outside the timed window; the scene's GT is exact
    t_probe0 = time.perf_counter()
    q = cluster_gates.dense_errors(scene, cfg, (10, n // 2, n - 2))
    # one blocked fused step: device time plus one readback
    from slam_toolkit_tpu.cluster.tracker import dense_frame
    dfj = jax.jit(lambda a, b, p: dense_frame(a, b, p, scene.cam, cfg))
    probe = [jnp.asarray(scene.frames[2][0]), jnp.asarray(scene.frames[2][1]),
             jnp.asarray(scene.frames[1][0])]
    jax.block_until_ready(dfj(*probe))
    t0 = time.perf_counter()
    jax.block_until_ready(dfj(*probe))
    dense_ms = (time.perf_counter() - t0) * 1000.0
    sys.stderr.write(
        f"[bench] cluster quality: disparity p95 {q['disp_p95_px']:.2f} px "
        f"/ >3px {100 * q['disp_gt3px_frac']:.2f}%, flow EPE p95 "
        f"{q['flow_epe_p95_px']:.2f} px / >3px "
        f"{100 * q['flow_gt3px_frac']:.2f}% (worst of 3 probe frames, "
        f"{time.perf_counter() - t_probe0:.1f}s); blocked dense_frame "
        f"{dense_ms:.1f} ms\n")
    if not cluster_gates.within_limits(q):
        sys.stderr.write("[bench] FAIL: disparity/flow accuracy "
                         "regressed\n")
        sys.exit(1)
    _emit({
        "metric": "kitti_scale_dense_cluster_fps",
        "value": round(fps, 2),
        "unit": "frames/s",
        "frames": "staged",
        "disp_p95_px": round(q["disp_p95_px"], 3),
        "disp_gt3px_frac": round(q["disp_gt3px_frac"], 5),
        "flow_epe_p95_px": round(q["flow_epe_p95_px"], 3),
        "flow_gt3px_frac": round(q["flow_gt3px_frac"], 5),
        "dense_frame_ms": round(dense_ms, 1),
    })


def stage_frames(cfg, n_frames):
    """Render-or-mmap the straight synthetic sequence shared by main()
    and main_dp(): returns ((N, 2, H, W) uint8, gt list). Rendering
    KITTI-size frames takes about a second each on one core, so the
    result is cached on disk."""
    from slam_toolkit_tpu.data.synthetic import make_sequence
    cache = os.environ.get(
        "BENCH_CACHE",
        data_path(f"bench_seq_v2_{n_frames}_{cfg.camera.width}x"
                   f"{cfg.camera.height}.npz"))
    t0 = time.perf_counter()
    if cache and os.path.exists(cache + ".npy"):
        stacked = np.load(cache + ".npy", mmap_mode="r")
        gt = list(np.load(cache + ".gt.npy"))
        sys.stderr.write(f"[bench] mapped {n_frames} cached frames in "
                         f"{time.perf_counter() - t0:.1f}s\n")
    else:
        world, gt, frames = make_sequence(cfg, n_frames=n_frames, seed=7,
                                          step=0.8)
        stacked = np.stack([
            np.stack([np.clip(l, 0, 255), np.clip(r, 0, 255)])
            for l, r in frames]).astype(np.uint8)
        sys.stderr.write(f"[bench] rendered {n_frames} frames in "
                         f"{time.perf_counter() - t0:.1f}s\n")
        if cache:
            np.save(cache + ".npy", stacked)
            np.save(cache + ".gt.npy", np.stack(gt))
    return stacked, gt


def main_dp():
    """BENCH_DP=B: data-parallel variant — the FULL engine step (track +
    keyframe cond + stereo supply + insert + cull + local BA) over B
    independent sequences on one device (across devices the same lanes
    ride parallel/mesh.multi_sequence_shard_chunk with zero
    collectives).
    BENCH_DP_MODE picks the lane layout: "lane" (default,
    multi_sequence_lane_chunk — keyframe cond stays real branching) or
    "vmap" (multi_sequence_chunk — both-branch masked cond). Reports
    AGGREGATE frames/s across lanes."""
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.evaluation.traj import ate_rmse
    from slam_toolkit_tpu.parallel.mesh import (batched_bootstrap,
                                                batched_empty_map,
                                                multi_sequence_chunk,
                                                multi_sequence_lane_chunk)

    # BENCH_TINY=1: tiny config on CPU — harness smoke test only
    cfg = SlamConfig.tiny() if os.environ.get("BENCH_TINY") \
        else SlamConfig()
    B = int(os.environ.get("BENCH_DP", "4"))
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))
    n_frames = int(os.environ.get("BENCH_FRAMES", "160"))
    warmup_chunks = 3

    stacked, gt = stage_frames(cfg, n_frames)

    from slam_toolkit_tpu.geometry.camera import StereoCamera
    cam = StereoCamera.from_config(cfg.camera)
    # every lane runs the same cached sequence (lanes share no state, so
    # identical inputs measure the same work as distinct ones). Frame 0
    # bootstraps; the ragged tail is dropped so every chunk keeps the
    # compiled shape (a short tail chunk would recompile mid-run).
    n_full = (n_frames - 1) // chunk * chunk
    if n_full < n_frames - 1:
        sys.stderr.write(f"[bench-dp] dropping {n_frames - 1 - n_full} "
                         f"tail frames (not a full {chunk}-chunk)\n")
    chunks = [jnp.asarray(jnp.broadcast_to(
        jnp.asarray(stacked[i:i + chunk], jnp.float32)[:, None],
        (chunk, B, 2) + stacked.shape[2:]))
        for i in range(1, 1 + n_full, chunk)]
    jax.block_until_ready(chunks)

    boot = batched_bootstrap(cfg, cam)
    first = jnp.broadcast_to(jnp.asarray(stacked[0], jnp.float32),
                             (B, 2) + stacked.shape[2:])
    carry = jax.jit(boot)(batched_empty_map(cfg, B),
                          first[:, 0], first[:, 1])
    # BENCH_DP_MODE: "lane" (default; lax.map over lanes — the keyframe
    # cond stays real control flow, so lanes only pay keyframe events
    # they trigger) or "vmap" (both-branch masked cond: every lane pays
    # the event cost every frame)
    dp_mode = os.environ.get("BENCH_DP_MODE", "lane")
    step = (multi_sequence_lane_chunk if dp_mode == "lane"
            else multi_sequence_chunk)(cfg, cam)

    t0 = time.perf_counter()
    packs = []
    for c in chunks[:warmup_chunks]:
        carry, packed = step(carry, c)
        packs.append(packed)
    jax.block_until_ready(packs[-1])
    sys.stderr.write(f"[bench-dp] warmup (compile) in "
                     f"{time.perf_counter() - t0:.1f}s\n")

    t0 = time.perf_counter()
    for c in chunks[warmup_chunks:]:
        carry, packed = step(carry, c)
        packs.append(packed)
    jax.block_until_ready(packed)
    dt = time.perf_counter() - t0
    n_timed = sum(int(c.shape[0]) for c in chunks[warmup_chunks:])

    rows = np.concatenate([np.asarray(p) for p in packs])  # (N, B, 36)
    assert np.isfinite(rows).all(), "non-finite DP engine output"
    # raw per-chunk poses of lane 0 (no anchor refinement): coarse
    # accuracy sanity only
    traj0 = [rows[i, 0, :16].reshape(4, 4) for i in range(rows.shape[0])]
    ate = ate_rmse(traj0, gt[1:1 + len(traj0)], align=True)
    agg_fps = B * n_timed / dt
    sys.stderr.write(
        f"[bench-dp] {n_timed} frames x {B} lanes in {dt:.2f}s — "
        f"{agg_fps:.1f} aggregate fps ({n_timed / dt:.1f}/lane), "
        f"lane-0 ATE {ate:.3f} m, "
        f"keyframes/lane {int(np.asarray(carry.m.kf_valid.sum(-1))[0])}\n")
    _emit({
        "metric": f"kitti_scale_dp{B}_aggregate_fps",
        "value": round(agg_fps, 2),
        "unit": "frames/s",
    })


def _sweep_seed(cfg, chunk, stacked, gt):
    """One short sweep run over an already-staged sequence; reuses the
    compiled chunk program (shapes are static across seeds). Returns
    (fps, ate_m)."""
    import time

    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.evaluation.traj import ate_rmse
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

    n = stacked.shape[0] // chunk * chunk
    chunks = [jnp.asarray(stacked[i:i + chunk], jnp.float32)
              for i in range(0, n, chunk)]
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
    return n_timed / dt, ate_rmse(traj, gt[:len(traj)], align=True)


def _multi_seed_sweep(cfg, chunk, stacked7, gt7):
    """BENCH_SEEDS (default 3): 96-frame runs over distinct world seeds
    so the JSON carries mean/max ATE across seeds instead of one seed's
    keypoint-selection luck (single-seed ATE moves about ±0.05 m). Seed
    7's row is the prefix of the already-staged headline sequence;
    extra seeds render-or-mmap their own cache."""
    import sys
    n_seeds = int(os.environ.get("BENCH_SEEDS", "3"))
    if n_seeds <= 1:
        return None
    sweep_frames = int(os.environ.get("BENCH_SWEEP_FRAMES", "96"))
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from bench_sweep import load_or_render
    rows = []
    for seed in (7, 11, 13, 17, 19)[:n_seeds]:
        if seed == 7:
            stacked, gt = stacked7[:sweep_frames], gt7[:sweep_frames]
        else:
            stacked, gt = load_or_render(cfg, sweep_frames, seed)
        fps, ate = _sweep_seed(cfg, chunk, stacked, gt)
        rows.append({"seed": seed, "fps": round(fps, 1),
                     "ate_m": round(ate, 3)})
        sys.stderr.write(f"[bench-sweep] {rows[-1]}\n")
    ates = [r["ate_m"] for r in rows]
    return {"seeds": len(rows), "frames": sweep_frames,
            "ate_mean_m": round(float(np.mean(ates)), 3),
            "ate_max_m": round(float(np.max(ates)), 3),
            "per_seed": rows}


def main():
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.evaluation.traj import ate_rmse
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

    cfg = SlamConfig()  # full KITTI-scale shapes
    if os.environ.get("BENCH_METHOD"):
        # BENCH_METHOD=direct: photometric tracking in the chunked
        # engine (the Method-strategy axis, ref include/method.h:33-50)
        import dataclasses
        cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
            cfg.tracker, method=os.environ["BENCH_METHOD"]))
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))
    # keep n_frames a multiple of chunk: a ragged tail chunk would
    # recompile the scan inside the timed window
    n_frames = int(os.environ.get("BENCH_FRAMES", "160"))
    warmup_chunks = 3
    stacked, gt = stage_frames(cfg, n_frames)
    chunks = []
    for i in range(0, n_frames, chunk):
        chunks.append(jnp.asarray(stacked[i:i + chunk], jnp.float32))
    jax.block_until_ready(chunks)

    t_setup = time.perf_counter()
    eng = ChunkedSlamEngine(cfg, chunk_size=chunk)
    for c in chunks[:warmup_chunks]:
        eng.process_chunk(c)
    eng.flush()
    sys.stderr.write(f"[bench] warmup (compile) in "
                     f"{time.perf_counter() - t_setup:.1f}s\n")

    t0 = time.perf_counter()
    for c in chunks[warmup_chunks:]:
        eng.process_chunk(c)
    eng.flush()                 # drain the pipelined in-flight chunk
    dt = time.perf_counter() - t0

    n_timed = sum(int(c.shape[0]) for c in chunks[warmup_chunks:])
    fps = n_timed / dt
    from slam_toolkit_tpu.evaluation.traj import rpe
    traj = eng.trajectory_refined()
    ate = ate_rmse(traj, gt, align=True)
    rpe_t, rpe_r = rpe(traj, gt)
    n_kf = eng._host.n_keyframes
    sys.stderr.write(
        f"[bench] {n_timed} frames in {dt:.2f}s, {fps:.1f} fps, "
        f"ATE {ate:.3f} m, RPE {rpe_t:.4f} m / {rpe_r * 57.2958:.3f} deg, "
        f"keyframes {n_kf}, "
        f"mappoints {int(eng.map.mp_valid.sum())}\n")

    # one chunk with the pipeline drained: device execution plus one
    # readback, no overlap
    blocked = []
    for c in chunks[:3]:
        t0 = time.perf_counter()
        eng.process_chunk(c)
        eng.flush()
        blocked.append((time.perf_counter() - t0) * 1000.0)
    blocked_ms = min(blocked)
    sys.stderr.write(f"[bench] blocked chunk {blocked_ms:.1f} ms "
                     f"({blocked_ms / chunk:.2f} ms/frame blocked vs "
                     f"{1000.0 / fps:.2f} ms/frame pipelined)\n")

    method = os.environ.get("BENCH_METHOD", "")
    out = {
        "metric": "kitti_scale_track_lba_fps" + (f"_{method}" if method
                                                 else ""),
        "value": round(fps, 2),
        "unit": "frames/s",
        "ate_m": round(ate, 3),
        "rpe_t_m": round(rpe_t, 4),
        "blocked_chunk_ms": round(blocked_ms, 1),
        "chunk": chunk,
    }
    if not method:      # sweep only for the headline indirect config
        sweep = _multi_seed_sweep(cfg, chunk, stacked, gt)
        if sweep:
            out["sweep"] = sweep
    _emit(out)


if __name__ == "__main__":
    _device()
    if os.environ.get("BENCH_LOOP"):
        main_loop()
    elif os.environ.get("BENCH_DP"):
        main_dp()
    elif os.environ.get("BENCH_CLUSTER"):
        main_cluster()
    else:
        main()
