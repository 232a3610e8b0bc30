"""Per-stage wall-time breakdown of the full-SLAM loop bench.

Wraps the host engine's loop-machinery entry points (_bow, _loop_score,
_covis, _relpose, _close, the per-chunk packed readback) with
block_until_ready + perf_counter buckets, then runs the same workload as
`BENCH_LOOP=1 python bench.py` and prints where the non-track wall time
goes: the gap between loop-on and loop-off fps is host-side closure
machinery, and this script says which piece.

Run on the GPU: `python scripts/profile_loop_stages.py`
(honours BENCH_FRAMES / BENCH_CHUNK).
"""

import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.utils import compile_cache
compile_cache.enable()

from slam_toolkit_tpu.config import SlamConfig
from bench import stage_loop
from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

BUCKETS = defaultdict(float)
COUNTS = defaultdict(int)


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        out = jax.block_until_ready(out)
        BUCKETS[name] += time.perf_counter() - t0
        COUNTS[name] += 1
        return out
    return wrap


def main():
    cfg = SlamConfig()
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))
    n = int(os.environ.get("BENCH_FRAMES", "320"))
    stacked, _, voc, _, _ = stage_loop(cfg, n, chunk)

    chunks = [jnp.asarray(stacked[i:i + chunk], jnp.float32)
              for i in range(0, n, chunk)]
    jax.block_until_ready(chunks)

    eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=chunk)
    h = eng._host
    for name in ("_bow", "_loop_score", "_covis", "_relpose", "_close",
                 "_bow_register", "_refresh_kf_mirrors"):
        setattr(h, name, timed(name, getattr(h, name)))

    orig_consume = h._consume_scores
    def consume_wrap(*a, **k):
        t0 = time.perf_counter()
        out = orig_consume(*a, **k)
        BUCKETS["consume_scores_total"] += time.perf_counter() - t0
        COUNTS["consume_scores_total"] += 1
        return out
    h._consume_scores = consume_wrap

    orig_disp = eng._dispatch
    def disp_wrap(*a, **k):
        t0 = time.perf_counter()
        out = orig_disp(*a, **k)
        BUCKETS["dispatch_total"] += time.perf_counter() - t0
        COUNTS["dispatch_total"] += 1
        return out
    eng._dispatch = disp_wrap

    # also bucket the whole between-chunk loop pass and the fold readback
    for nm in ("_loop_dispatch", "_loop_phase1", "_loop_phase2"):
        def mk(nm):
            orig = getattr(eng, nm)
            def wrap(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                BUCKETS[nm + "_total"] += time.perf_counter() - t0
                COUNTS[nm + "_total"] += 1
                return out
            return wrap
        setattr(eng, nm, mk(nm))

    orig_fold = eng._fold_one
    def fold_wrap():
        t0 = time.perf_counter()
        out = orig_fold()
        BUCKETS["fold_one_total"] += time.perf_counter() - t0
        COUNTS["fold_one_total"] += 1
        return out
    eng._fold_one = fold_wrap

    warm = 3
    t0 = time.perf_counter()
    for c in chunks[:warm]:
        eng.process_chunk(c)
    eng.flush()
    eng.warmup()
    print(f"warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    for k in list(BUCKETS):
        BUCKETS[k] = 0.0
        COUNTS[k] = 0

    t0 = time.perf_counter()
    for c in chunks[warm:]:
        eng.process_chunk(c)
    eng.flush()
    dt = time.perf_counter() - t0
    n_timed = sum(int(c.shape[0]) for c in chunks[warm:])
    print(f"{n_timed} frames in {dt:.2f}s ({n_timed/dt:.1f} fps), "
          f"closures {len([e for e in eng.loop_events if 'cand' in e])}, "
          f"replays {eng.n_replays}, KFs {eng._host.n_keyframes}")
    for k in sorted(BUCKETS, key=lambda k: -BUCKETS[k]):
        print(f"  {k:28s} {BUCKETS[k]*1000:9.1f} ms  x{COUNTS[k]:4d}"
              f"  ({100*BUCKETS[k]/dt:5.1f}% of wall)")


if __name__ == "__main__":
    main()
