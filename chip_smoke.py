"""Smoke run of the SLAM engine on NVIDIA GPUs.

    python chip_smoke.py           # one card: kernels, chunked engine,
                                   # per-frame API, dense cluster step
    python chip_smoke.py --multi   # four cards: sharded sequence lanes

Drives the main path once through the entry points a user calls, at the
full KITTI width of `SlamConfig()` on synthetic frames rendered from a
seed, and checks every result against the repository's own references.
Each phase prints its numbers; a failed phase exits nonzero. The last
line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}},
printed only when every phase passed. Without a GPU the script exits
nonzero before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 7                  # world seed of the synthetic KITTI-scale drive
STEP = 0.8                # metres per frame
CHUNK = 16                # frames per chunk program
N_CHUNKS = 4              # one warm-up chunk + three measured
PER_FRAME = 12            # frames through SlamEngine.process
# ATE gate on the 64-frame full-width run: max(2 x CPU ATE,
# CPU ATE + 0.05 m) with the CPU ATE 0.0648 m of the same frames run
# by JAX on the CPU (CHANGES.md)
ATE_GATE_M = 0.1296
CLUSTER_FRAMES = 60
MULTI_LANES = 4           # one lane per card
MULTI_CHUNK = 8
MULTI_CHUNKS = 2


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- device


def device_info() -> dict:
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    check(info["platform"] == "gpu", f"needs a GPU; JAX found {info}")
    return info


def card_lines() -> list:
    """`nvidia-smi` name and power limit, one line per card (a child
    process that does not touch JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    check(r.returncode == 0 and bool(lines),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return lines


def wall_ms(fn, args, reps: int = 50) -> float:
    """Host wall time per call, pipelined: `reps` calls enqueued back to
    back, one sync at the end. Includes what dispatch and launch gaps
    leave the device idle."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    jax.block_until_ready([fn(*args) for _ in range(reps)])
    return (time.perf_counter() - t0) * 1000.0 / reps


def kernel_times(kernel, plain, args) -> str:
    """A kernel and its plain XLA version per call: device-busy time
    from a profiler trace of 50 calls (utils/timing.device_ms), and the
    pipelined wall time of 50 more."""
    from slam_toolkit_tpu.utils.timing import device_ms

    def one(fn):
        dev = device_ms(fn, args)
        dev = "not measured" if dev is None else f"{dev:.4f} ms"
        return f"device {dev}, wall {wall_ms(fn, args):.4f} ms/call"
    return f"kernel: {one(kernel)}; XLA: {one(plain)}"


# --------------------------------------------------------------- kernels


def matcher_case(cfg, seed: int = 0):
    """Production-width projection-matching inputs: L landmarks against
    K keypoints over the image, half the landmarks projecting within a
    few pixels of a keypoint whose descriptor differs by a few bits."""
    import jax.numpy as jnp
    L, K = cfg.map.track_landmarks, cfg.extractor.max_keypoints
    w, h = cfg.camera.width, cfg.camera.height
    rng = np.random.default_rng(seed)
    b_desc = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint32)
    b_xy = rng.uniform(0, [w, h], (K, 2)).astype(np.float32)
    a_desc = rng.integers(0, 2 ** 32, (L, 8), dtype=np.uint32)
    a_uv = rng.uniform(0, [w, h], (L, 2)).astype(np.float32)
    near = min(L // 2, K)
    src = rng.permutation(K)[:near]
    flips = np.uint32(1) << rng.integers(0, 32, (near, 8)).astype(np.uint32)
    a_desc[:near] = b_desc[src] ^ (flips * (rng.uniform(size=(near, 8))
                                           < 0.3))
    a_uv[:near] = b_xy[src] + rng.normal(0, 3.0, (near, 2))
    return tuple(jnp.asarray(x) for x in (a_desc, b_desc, a_uv, b_xy))


def pose_case(cfg, seed: int = 0):
    """Production-width motion-only LM inputs: N = track_landmarks
    observations up to 60 m, per-octave sigmas, 10% gross outliers,
    every 13th slot invalid; the start pose is off by a frame's motion."""
    import jax.numpy as jnp
    from slam_toolkit_tpu.geometry import se3
    n = cfg.map.track_landmarks
    fx = cfg.camera.fx
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 2, n),
                   rng.uniform(4, 60, n)], -1).astype(np.float32)
    T_true = np.asarray(se3.exp(jnp.asarray(
        [0.02, -0.01, 0.8, 0.003, 0.01, -0.002], jnp.float32)))
    Xc = (T_true[:3, :3] @ Xw.T).T + T_true[:3, 3]
    octave = rng.integers(0, 8, n)
    sigma2 = ((1.2 ** (2 * octave)) / fx ** 2).astype(np.float32)
    z = Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1.0, (n, 2)) * \
        np.sqrt(sigma2)[:, None]
    z[: n // 10] += rng.normal(0, 0.05, (n // 10, 2))
    mask = np.ones(n, bool)
    mask[::13] = False
    return (jnp.eye(4), jnp.asarray(Xw), jnp.asarray(z.astype(np.float32)),
            jnp.asarray(sigma2), jnp.asarray(mask))


def phase_kernels(cfg) -> None:
    """Each hand-written kernel at production width against its plain
    reference: the matcher exactly, the pose LM within rotation 1e-4,
    translation 1e-3 m and 99.9% inlier-mask agreement of the reference
    run at HIGHEST precision (f32 sums in another order)."""
    import jax
    from slam_toolkit_tpu.ops import match_kernel as mk
    from slam_toolkit_tpu.ops import pose_lm_kernel as pk
    from slam_toolkit_tpu.optim import pose_lm

    r = float(cfg.matcher.projection_radius)
    args = matcher_case(cfg)
    kern = jax.jit(lambda *a: mk._topk2_triton(*a, r))
    ref = jax.jit(lambda *a: mk._topk2_xla(*a, r))
    got, want = np.asarray(kern(*args)), np.asarray(ref(*args))
    n_best = int((want[:, 0] < mk.BIG).sum())
    check(np.array_equal(got, want),
          f"matcher kernel differs from _topk2_xla in "
          f"{int((got != want).any(axis=1).sum())} rows")
    log(f"[kernels] matcher {args[0].shape[0]}x{args[1].shape[0]} r={r}: "
        f"exact match ({n_best} rows with a candidate); "
        f"{kernel_times(kern, ref, args)}")

    tcfg = cfg.tracker
    args = pose_case(cfg)
    kern = jax.jit(lambda *a: pk.optimize_pose_triton(*a, tcfg))
    plain = jax.jit(lambda *a: pose_lm.optimize_pose(*a, tcfg))
    with jax.default_matmul_precision("highest"):
        exact = jax.jit(lambda *a: pose_lm.optimize_pose(*a, tcfg))(*args)
    got = kern(*args)
    T_g, T_e = np.asarray(got.T_cw), np.asarray(exact.T_cw)
    d_rot = float(np.abs(T_g[:3, :3] - T_e[:3, :3]).max())
    d_t = float(np.abs(T_g[:3, 3] - T_e[:3, 3]).max())
    thr = tcfg.huber_delta ** 2
    agree = float(np.mean((np.asarray(got.inlier_r2) <= thr)
                          == (np.asarray(exact.inlier_r2) <= thr)))
    log(f"[kernels] pose LM N={args[1].shape[0]}: rotation diff {d_rot:.3g}, "
        f"translation diff {d_t:.3g} m, inlier agreement {agree:.5f}; "
        f"{kernel_times(kern, plain, args)}")
    check(np.isfinite(T_g).all() and d_rot <= 1e-4 and d_t <= 1e-3
          and agree >= 0.999, "pose LM kernel outside its tolerance")


# ------------------------------------------------------------- main path


def render(cfg, n_frames: int, step: float = STEP):
    """(N, 2, H, W) float32 stereo frames and the ground-truth poses of
    data.synthetic.make_sequence."""
    from slam_toolkit_tpu.data.synthetic import make_sequence
    _, gt, frames = make_sequence(cfg, n_frames=n_frames, seed=SEED,
                                  step=step)
    imgs = np.stack([np.stack([left, right]) for left, right in frames])
    return imgs.astype(np.float32), gt


def _accuracy(traj, gt) -> dict:
    from slam_toolkit_tpu.evaluation.traj import ate_rmse, rpe
    poses = np.stack(traj)
    check(np.isfinite(poses).all(), "non-finite pose")
    rpe_t, rpe_r = rpe(traj, gt)
    return {"ate_m": float(ate_rmse(traj, gt, align=True)),
            "rpe_t_m": float(rpe_t), "rpe_r_deg": float(np.degrees(rpe_r))}


def run_chunked(cfg, imgs, gt, chunk: int) -> dict:
    """Bootstrap on frame 0, one warm-up chunk (compiles), then the
    measured chunks through pipeline/scan_engine.ChunkedSlamEngine."""
    import jax
    import jax.numpy as jnp
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

    chunks = [jnp.asarray(imgs[i:i + chunk])
              for i in range(1, len(imgs), chunk)]
    jax.block_until_ready(chunks)
    t0 = time.perf_counter()
    eng = ChunkedSlamEngine(cfg, chunk_size=chunk)
    eng.process_chunk(imgs[:1])
    eng.process_chunk(chunks[0])
    eng.flush()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in chunks[1:]:
        eng.process_chunk(c)
    eng.flush()
    dt = time.perf_counter() - t0
    n_timed = sum(int(c.shape[0]) for c in chunks[1:])
    out = _accuracy(eng.trajectory_refined(), gt)
    out.update(compile_s=compile_s, fps=n_timed / dt, frames=len(gt),
               timed_frames=n_timed, keyframes=int(eng._host.n_keyframes),
               mappoints=int(eng.map.mp_valid.sum()))
    return out


def run_per_frame(cfg, imgs, gt, n_frames: int) -> dict:
    """The README's usage path: pipeline/engine.SlamEngine.process per
    stereo pair."""
    from slam_toolkit_tpu.pipeline.engine import SlamEngine

    eng = SlamEngine(cfg)
    t0 = time.perf_counter()
    for left, right in imgs[:n_frames]:
        eng.process(left, right)
    out = _accuracy(eng.trajectory_refined(), gt[:n_frames])
    out.update(seconds=time.perf_counter() - t0, frames=n_frames,
               keyframes=int(eng.n_keyframes))
    return out


def phase_main(cfg, info: dict, cards: list) -> None:
    import jax

    t0 = time.perf_counter()
    imgs, gt = render(cfg, 1 + N_CHUNKS * CHUNK)
    log(f"[main] rendered {len(imgs)} frames of {cfg.camera.width}x"
        f"{cfg.camera.height} in {time.perf_counter() - t0:.1f} s")
    res = run_chunked(cfg, imgs, gt, CHUNK)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"[main] chunked engine: compile+warm-up {res['compile_s']:.1f} s; "
        f"{res['timed_frames']} measured frames at {res['fps']:.1f} fps "
        f"(information only; {info['kind']}, {cards[0]}); "
        f"ATE {res['ate_m']:.4f} m, RPE {res['rpe_t_m']:.4f} m / "
        f"{res['rpe_r_deg']:.4f} deg, keyframes {res['keyframes']}, "
        f"mappoints {res['mappoints']}, peak device memory {peak} bytes")
    check(res["ate_m"] <= ATE_GATE_M,
          f"chunked ATE {res['ate_m']:.4f} m above the {ATE_GATE_M} m gate")

    pf = run_per_frame(cfg, imgs, gt, PER_FRAME)
    log(f"[per-frame] SlamEngine.process over {pf['frames']} frames in "
        f"{pf['seconds']:.1f} s (compiles included): ATE {pf['ate_m']:.4f} m, "
        f"keyframes {pf['keyframes']}")
    check(pf["ate_m"] <= ATE_GATE_M,
          f"per-frame ATE {pf['ate_m']:.4f} m above the {ATE_GATE_M} m gate")


# --------------------------------------------------------- dense cluster


def phase_cluster(n_frames: int = CLUSTER_FRAMES) -> None:
    """cluster/tracker.FusedDenseTracker at 376x1241 with the bench's
    quality gates (evaluation/cluster_gates)."""
    import jax.numpy as jnp
    from slam_toolkit_tpu.cluster.tracker import (DenseConfig,
                                                  FusedDenseTracker)
    from slam_toolkit_tpu.data.synthetic import make_cluster_scene
    from slam_toolkit_tpu.evaluation import cluster_gates

    scene = make_cluster_scene(n_frames=n_frames)
    dcfg = DenseConfig(max_points=18688)
    t0 = time.perf_counter()
    tr = FusedDenseTracker(scene.cam, dcfg, queue_depth=2)
    outs = []
    for left, right in scene.frames:
        o = tr.process(jnp.asarray(left), jnp.asarray(right))
        if o is not None:
            outs.append(o)
    outs += tr.flush()
    wall = time.perf_counter() - t0
    persist, distinct, ids, alive, n_live = \
        cluster_gates.mover_persistence(scene, dcfg, outs, n_frames)
    q = cluster_gates.dense_errors(scene, dcfg,
                                   (10, n_frames // 2, n_frames - 2))
    log(f"[cluster] {n_frames} frames in {wall:.1f} s (compile included), "
        f"{n_live} live, {alive} clusters alive, mover ids {ids} "
        f"persist={persist} distinct={distinct}; disparity p95 "
        f"{q['disp_p95_px']:.4f} px, >3 px {q['disp_gt3px_frac']:.6f}; "
        f"flow EPE p95 {q['flow_epe_p95_px']:.4f} px, >3 px "
        f"{q['flow_gt3px_frac']:.6f} (limits {cluster_gates.LIMITS})")
    check(persist and distinct, "cluster movers lost their ids")
    check(cluster_gates.within_limits(q), "cluster disparity/flow gates")


# ----------------------------------------------------------- four cards


def lane_frames(imgs, lanes: int, chunk: int, n_chunks: int):
    """Lane b drives frames b, b+1, ...: (first (B, 2, H, W),
    [chunk images (C, B, 2, H, W)])."""
    span = 1 + chunk * n_chunks
    per_lane = np.stack([imgs[b:b + span] for b in range(lanes)], axis=1)
    return per_lane[0], [per_lane[1 + k * chunk:1 + (k + 1) * chunk]
                         for k in range(n_chunks)]


def run_multi(cfg, imgs, n_dev: int, chunk: int, n_chunks: int) -> dict:
    """parallel/mesh.multi_sequence_shard_chunk over an n_dev mesh, one
    lane per device, against multi_sequence_lane_chunk on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from slam_toolkit_tpu.geometry.camera import StereoCamera
    from slam_toolkit_tpu.parallel import mesh as mesh_mod

    check(len(jax.devices()) >= n_dev,
          f"needs {n_dev} devices, JAX sees {len(jax.devices())}")
    cam = StereoCamera.from_config(cfg.camera)
    mesh = mesh_mod.make_mesh(n_dev)
    first, chunks = lane_frames(imgs, n_dev, chunk, n_chunks)
    boot = jax.jit(mesh_mod.batched_bootstrap(cfg, cam))

    t0 = time.perf_counter()
    first_sh = mesh_mod.shard_batch(mesh, jnp.asarray(first))
    carry = boot(mesh_mod.shard_batch(
        mesh, mesh_mod.batched_empty_map(cfg, n_dev)),
        first_sh[:, 0], first_sh[:, 1])
    step = mesh_mod.multi_sequence_shard_chunk(cfg, cam, mesh)
    img_sh = NamedSharding(mesh, P(None, "seq"))
    sharded = []
    for c in chunks:
        carry, packed = step(carry, jax.device_put(jnp.asarray(c), img_sh))
        sharded.append(packed)
    sharding = str(sharded[-1].sharding)
    sharded = np.concatenate([np.asarray(p) for p in sharded])
    t_sharded = time.perf_counter() - t0

    t0 = time.perf_counter()
    dev0 = jax.devices()[0]
    with jax.default_device(dev0):
        carry = boot(mesh_mod.batched_empty_map(cfg, n_dev),
                     jnp.asarray(first[:, 0]), jnp.asarray(first[:, 1]))
        lane = mesh_mod.multi_sequence_lane_chunk(cfg, cam)
        single = []
        for c in chunks:
            carry, packed = lane(carry, jnp.asarray(c))
            single.append(packed)
        single = np.concatenate([np.asarray(p) for p in single])
    t_single = time.perf_counter() - t0
    return {"sharded": sharded, "single": single,
            "sharding": sharding, "t_sharded": t_sharded,
            "t_single": t_single}


def phase_multi(cfg) -> None:
    imgs, _ = render(cfg, MULTI_LANES + MULTI_CHUNK * MULTI_CHUNKS)
    res = run_multi(cfg, imgs, MULTI_LANES, MULTI_CHUNK, MULTI_CHUNKS)
    a, b = res["sharded"], res["single"]
    check(a.shape == b.shape and np.isfinite(a).all(),
          f"sharded rows {a.shape} vs {b.shape}, or non-finite")
    bitwise = bool(np.array_equal(a, b))
    pose_diff = float(np.abs(a[..., :16] - b[..., :16]).max())
    flags_equal = bool(np.array_equal(a[..., 32:35], b[..., 32:35]))
    log(f"[multi] {MULTI_LANES} lanes x {MULTI_CHUNKS} chunks of "
        f"{MULTI_CHUNK} frames at {cfg.camera.width}x{cfg.camera.height}: "
        f"sharded over {MULTI_LANES} cards {res['t_sharded']:.1f} s, one "
        f"card {res['t_single']:.1f} s (compiles included), packed rows "
        f"sharded as {res['sharding']}; sharded == "
        f"unsharded bitwise: {bitwise}; max pose-entry diff {pose_diff:.3g}"
        f", slot/ok/keyframe flags equal: {flags_equal}")
    # tolerance when the two programs differ in the last bits (XLA may
    # pick other kernels per device count): identical tracking and
    # keyframe decisions, pose entries within 1e-3
    check(bitwise or (flags_equal and pose_diff <= 1e-3),
          "sharded lanes diverged from the one-card lanes")


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: run only the sharded-lanes phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        from slam_toolkit_tpu.config import SlamConfig
        from slam_toolkit_tpu.utils import compile_cache
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    try:
        info = device_info()
        cards = card_lines()
        log(f"[device] {info['kind']} x{info['count']} "
            f"(platform {info['platform']})")
        for line in cards:
            log(f"[device] nvidia-smi: {line}")
        log(f"[device] compile cache: {compile_cache.enable()}")
        cfg = SlamConfig()
        if args.multi:
            phase_multi(cfg)
        else:
            phase_kernels(cfg)
            phase_main(cfg, info, cards)
            phase_cluster()
    except Exception as e:  # report any phase failure, then exit nonzero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
