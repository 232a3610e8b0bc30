"""End-to-end A/B of the hand-written GPU kernels, and the device times
behind each kernel decision.

    python scripts/kernel_ab.py [--out FILE]

On one GPU, for each Triton kernel on the per-frame path (the
projection matcher, the motion-only pose LM) it runs chip_smoke's main
phase (ChunkedSlamEngine at SlamConfig() over the seed-7 synthetic
drive, one warm-up chunk, then 9 measured chunks of 16 frames) in
PAIRS pairs: one run as shipped and one with that kernel swapped for
its plain XLA reference. Pairs alternate which side runs first. A
kernel is kept only when it wins at least nine tenths of its pairs and
the two medians differ by more than the interquartile spread of the
plain side's runs.

Before the pairs it prints device times read from profiler traces: each
kept kernel against its plain form (chip_smoke's kernel phase), and the
plain XLA forms that replaced the removed kernels, at production shapes.
The last line of standard output is the JSON summary.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

PAIRS = 10
CHUNKS = 10          # 16-frame chunks per run, the first one warm-up


def plain_forms():
    """kernel name -> (module, attribute, plain replacement)."""
    from slam_toolkit_tpu.ops import match_kernel, pose_lm_kernel
    from slam_toolkit_tpu.optim import pose_lm
    return {
        "matcher": (match_kernel, "topk2_match",
                    lambda a, b, c, d, r: match_kernel._topk2_xla(
                        a, b, c, d, float(r))),
        "pose_lm": (pose_lm_kernel, "optimize_pose", pose_lm.optimize_pose),
    }


def removed_kernel_times(cfg) -> dict:
    """The plain XLA forms that replaced the removed kernels, at the
    shapes the engine calls them with: device-busy ms per call from a
    profiler trace, and pipelined wall ms per call."""
    import jax
    import jax.numpy as jnp
    from chip_smoke import wall_ms
    from slam_toolkit_tpu.geometry import se3
    from slam_toolkit_tpu.ops import fast, stereo_sad
    from slam_toolkit_tpu.ops.patches import gather_blocks
    from slam_toolkit_tpu.optim.local_ba import BAProblem, solve_ba
    from slam_toolkit_tpu.utils import timing

    def times(fn, args, reps=50):
        return {"device_ms": timing.device_ms(fn, args, reps),
                "wall_ms": wall_ms(fn, args, reps)}

    H, W = cfg.camera.height, cfg.camera.width
    K = cfg.extractor.max_keypoints
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    img2 = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    out = {}
    ys = jnp.asarray(rng.integers(0, H - 31, K).astype(np.int32))
    xs = jnp.asarray(rng.integers(0, W - 31, K).astype(np.int32))
    f = jax.jit(lambda a, y, x: gather_blocks(a, y, x, 31, 31))
    for dt in (jnp.float32, jnp.bfloat16):
        out[f"patch_gather_{jnp.dtype(dt).name}"] = times(
            f, (img.astype(dt), ys, xs))

    md = int(cfg.matcher.stereo_max_dx)
    side = 2 * stereo_sad.WIN + 1
    xl = rng.integers(min(120, W // 2), W - 20, K)
    yl = rng.integers(20, H - 20, K)
    sad_args = (img, img2,
                jnp.asarray(np.clip(yl - 5, 0, H - side).astype(np.int32)),
                jnp.asarray(np.clip(xl - 5, 0, W - side).astype(np.int32)),
                jnp.asarray(np.clip(xl - (md + 6), 0,
                                    W - stereo_sad._strip_w(md))
                            .astype(np.int32)))
    out["sad_curve"] = times(jax.jit(
        lambda a, b, y, x, s: stereo_sad.sad_curve(a, b, y, x, s, md)),
        sad_args)

    out["fast_nms_level0"] = times(jax.jit(
        lambda a: fast.detect_dual(a, 20.0, 7.0,
                                   cfg.extractor.patch_radius + 1)), (img,))

    Wk, P = cfg.local_ba.window_keyframes, cfg.local_ba.max_points
    T = se3.exp(jnp.stack([jnp.array([0.0, 0.0, 0.8 * i, 0.0, 0.01 * i, 0.0])
                           for i in range(Wk)]))
    X = jnp.asarray(np.stack([rng.uniform(-10, 10, P), rng.uniform(-3, 2, P),
                              rng.uniform(5, 60, P)], -1).astype(np.float32))
    Xc = jnp.einsum("wij,pj->wpi", T[:, :3, :3], X, precision="highest") \
        + T[:, :3, 3][:, None]
    z = jnp.stack([Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2],
                   (Xc[..., 0] - 0.54) / Xc[..., 2]], -1)
    obs = jnp.asarray(rng.uniform(size=(Wk, P)) < 0.6) & (Xc[..., 2] > 1)
    prob = BAProblem(
        T_cw=se3.exp(0.01 * jnp.asarray(rng.normal(size=(Wk, 6)),
                                        jnp.float32)) @ T,
        pose_fixed=jnp.zeros(Wk, bool).at[0].set(True),
        pose_valid=jnp.ones(Wk, bool), Xw=X + 0.05,
        point_valid=jnp.ones(P, bool), z=z,
        inv_sigma=jnp.full((Wk, P), 700.0), obs_mask=obs, stereo_mask=obs,
        baseline=jnp.float32(0.54))
    out["local_ba_solve"] = times(jax.jit(
        lambda p: solve_ba(p, iters=cfg.local_ba.num_iterations)), (prob,),
        reps=20)
    return out


def quartiles(xs) -> dict:
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "runs": [float(x) for x in xs]}


def verdict(kernel_fps, plain_fps) -> dict:
    wins = sum(k > p for k, p in zip(kernel_fps, plain_fps))
    k, p = quartiles(kernel_fps), quartiles(plain_fps)
    gap = k["median"] - p["median"]
    iqr = p["q3"] - p["q1"]
    return {"pairs": len(kernel_fps), "wins": wins, "fps_kernel": k,
            "fps_plain": p, "median_gap": gap, "plain_iqr": iqr,
            "keep": wins >= 0.9 * len(kernel_fps) and gap > iqr}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the summary JSON here")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.pipeline import scan_engine
    from slam_toolkit_tpu.utils import compile_cache, timing
    from slam_toolkit_tpu.utils.paths import data_path

    info = cs.device_info()
    cards = cs.card_lines()
    cs.log(f"[ab] {info['kind']} x{info['count']}; nvidia-smi: {cards[0]}; "
           f"compile cache {compile_cache.enable()}")
    cfg = SlamConfig()
    summary = {"device": info, "card": cards[0]}
    cs.phase_kernels(cfg)
    trace = timing.load_trace(data_path("trace/device_ms"))
    cs.log("[ab] device-plane lines of the last trace: " + "; ".join(
        f"{p.name}: {sorted({ln.name for ln in p.lines})}"
        for p in trace.planes if p.name.startswith(timing.DEVICE_PLANE)))
    summary["removed_kernels_xla_ms"] = removed_kernel_times(cfg)
    cs.log(f"[ab] plain XLA forms of the removed kernels, per call: "
           f"{summary['removed_kernels_xla_ms']}")

    forms = plain_forms()
    imgs, gt = cs.render(cfg, 1 + CHUNKS * cs.CHUNK)

    # one chunk program per arm, reused by every run of that arm
    make_chunk_fn, programs, arm = scan_engine.make_chunk_fn, {}, [None]

    def chunk_fn(c, cam):
        if arm[0] not in programs:
            programs[arm[0]] = make_chunk_fn(c, cam)
        return programs[arm[0]]
    scan_engine.make_chunk_fn = chunk_fn

    @contextlib.contextmanager
    def plain(name):
        mod, attr, repl = forms[name]
        shipped = getattr(mod, attr)
        setattr(mod, attr, repl)
        try:
            yield
        finally:
            setattr(mod, attr, shipped)

    def run(name, with_kernel: bool) -> dict:
        arm[0] = None if with_kernel else name
        with plain(name) if not with_kernel else contextlib.nullcontext():
            r = cs.run_chunked(cfg, imgs, gt, cs.CHUNK)
        cs.log(f"[ab] {name} {'kernel' if with_kernel else 'plain '} "
               f"{r['fps']:.3f} fps over {r['timed_frames']} frames, "
               f"ATE {r['ate_m']:.4f} m, keyframes {r['keyframes']}")
        return r

    runs = {n: {"kernel": [], "plain": []} for n in forms}
    for i in range(PAIRS):
        for name in forms:
            order = (True, False) if i % 2 == 0 else (False, True)
            for with_kernel in order:
                side = "kernel" if with_kernel else "plain"
                runs[name][side].append(run(name, with_kernel))
    for name in forms:
        v = verdict([r["fps"] for r in runs[name]["kernel"]],
                    [r["fps"] for r in runs[name]["plain"]])
        v["ate_m"] = {s: statistics.median(r["ate_m"] for r in rs)
                      for s, rs in runs[name].items()}
        summary[name] = v
        cs.log(f"[ab] {name}: kernel wins {v['wins']}/{v['pairs']}, median "
               f"{v['fps_kernel']['median']:.3f} vs "
               f"{v['fps_plain']['median']:.3f} fps (gap "
               f"{v['median_gap']:.3f}, plain IQR {v['plain_iqr']:.3f}): "
               f"{'keep' if v['keep'] else 'delete'}")
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
