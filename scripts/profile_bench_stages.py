"""Stage split of the REAL bench workload: extract / +track / +KF / +BA.

Unlike profile_scan_variants.py (random images, where tracking failure
forces a keyframe every frame), this uses the bench's rendered sequence
(bench.stage_frames) and a warm map from actually running the engine, so the KF rate
and match density are the production ones. Chunks are dispatched chained
(carry flows) and blocked once at the end — the same pipelining bench.py
gets — so host syncs are amortized identically across variants.

Run: python scripts/profile_bench_stages.py   (on the GPU)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 16
N_FRAMES = 160


def main():
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from bench import stage_frames
    from slam_toolkit_tpu.config import SlamConfig
    from slam_toolkit_tpu.pipeline import scan_engine
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

    cfg = SlamConfig()
    stacked, _ = stage_frames(cfg, N_FRAMES)
    chunks = [jnp.asarray(stacked[i:i + CHUNK], jnp.float32)
              for i in range(0, N_FRAMES, CHUNK)]
    jax.block_until_ready(chunks)

    # warm engine state: run the first 3 chunks through the real engine
    eng = ChunkedSlamEngine(cfg, chunk_size=CHUNK)
    for c in chunks[:3]:
        eng.process_chunk(c)
    eng.flush()
    carry0 = eng._carry_cache if eng._carry_cache is not None \
        else eng._carry()
    work = chunks[3:]

    def fresh_carry():
        # the chunk fn DONATES its input carry; every pass needs its own
        # deep copy or the second rep reads dead buffers
        return jax.tree.map(jnp.copy, carry0)

    def bench_fn(fn, reps=3):
        # compile + one untimed pass
        c = fresh_carry()
        for imgs in work:
            c, p = fn(c, imgs)
        jax.block_until_ready(p)
        best = float("inf")
        for _ in range(reps):
            c = fresh_carry()
            t0 = time.perf_counter()
            for imgs in work:
                c, p = fn(c, imgs)
            jax.block_until_ready(p)
            best = min(best, time.perf_counter() - t0)
        return best / (len(work) * CHUNK) * 1e3

    variants = [("extract", {"SLAM_SCAN_STAGE": "extract"}),
                ("track", {"SLAM_SCAN_STAGE": "track"}),
                ("full_noba", {"SLAM_SCAN_NO_BA": "1"}),
                ("full", {})]
    if "--kf" in sys.argv:
        # component splits of the KF branch. ALL variants run with
        # SLAM_SCAN_FORCE_KF so the branch fires every frame — without
        # it, skipping stereo/insert starves tracking, ~res.ok forces
        # 100% keyframes in the skip variant only, and the deltas
        # measure the workload shift instead of the component
        fkf = {"SLAM_SCAN_FORCE_KF": "1"}
        variants = [("full", dict(fkf)),
                    ("no_stereo", dict(fkf, SLAM_SCAN_SKIP="stereo")),
                    ("no_insert", dict(fkf, SLAM_SCAN_SKIP="insert")),
                    ("no_cull", dict(fkf, SLAM_SCAN_SKIP="cull")),
                    ("no_snapshot", dict(fkf, SLAM_SCAN_SKIP="snapshot")),
                    ("no_ba", dict(fkf, SLAM_SCAN_NO_BA="1"))]

    results = {}
    for stage, env in variants:
        for k in ("SLAM_SCAN_STAGE", "SLAM_SCAN_NO_BA", "SLAM_SCAN_SKIP",
                  "SLAM_SCAN_FORCE_KF"):
            os.environ.pop(k, None)
        os.environ.update(env)
        fn = scan_engine.make_chunk_fn(cfg, eng.cam)
        results[stage] = bench_fn(fn)
        print(f"{stage:12s}: {results[stage]:6.3f} ms/frame", flush=True)
    for k in ("SLAM_SCAN_STAGE", "SLAM_SCAN_NO_BA", "SLAM_SCAN_SKIP",
              "SLAM_SCAN_FORCE_KF"):
        os.environ.pop(k, None)

    if "--kf" in sys.argv:
        for s in ("no_stereo", "no_insert", "no_cull", "no_snapshot",
                  "no_ba"):
            print(f"-> {s[3:]:18s}: {results['full'] - results[s]:6.3f} "
                  f"ms/KF-event")
    else:
        print(f"-> track (match+LM)   : {results['track'] - results['extract']:6.3f} ms/frame")
        print(f"-> KF branch w/o BA   : {results['full_noba'] - results['track']:6.3f} ms/frame (amortized)")
        print(f"-> BA                 : {results['full'] - results['full_noba']:6.3f} ms/frame (amortized)")


if __name__ == "__main__":
    main()
