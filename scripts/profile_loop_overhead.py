"""Attribute loop-mode's per-chunk overhead vs the headline bench.

Loop mode (BENCH_LOOP=1) runs slower than the headline (no vocab).
Candidates: the _bow_register program in the device stream, the mapping
worker's covis/relpose dispatches, and host-side phase work contending
for the CPU. This times each device program standalone at production
shapes on the live bench map.

Run: python scripts/profile_loop_overhead.py   (on the GPU; renders or
reuses the loop bench's frames and vocabulary, bench.stage_loop)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def t(fn, *a, n=20):
    import jax
    out = fn(*a)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [fn(*a) for _ in range(n)]
    jax.block_until_ready(outs[-1])
    return (time.perf_counter() - t0) / n * 1000.0, out


def main():
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.config import SlamConfig
    from bench import stage_loop
    from slam_toolkit_tpu.pipeline.scan_engine import (ChunkedSlamEngine,
                                                       PACK_WIDTH)

    cfg = SlamConfig()
    chunk = 16
    n_warm = 4 * chunk
    stacked, _, voc, _, _ = stage_loop(cfg, 320, chunk)

    eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=chunk)
    for i in range(0, n_warm, chunk):
        eng.process_chunk(jnp.asarray(stacked[i:i + chunk], jnp.float32))
    eng.flush()
    h = eng._host

    imgs = jnp.asarray(stacked[n_warm:n_warm + chunk], jnp.float32)
    # chunk program alone (blocked). _chunk DONATES its input carry, so
    # each timed call consumes a fresh device copy of a pristine carry
    # (copy cost reported separately for subtraction).
    carry0 = eng._carry()
    eng._carry_cache = None     # keep the engine's own mirrors intact

    def copy_tree(x):
        return jax.tree_util.tree_map(
            lambda a: jnp.copy(a) if hasattr(a, "dtype") else a, x)

    ms_copy, _ = t(lambda: copy_tree(carry0), n=8)
    ms_chunk, out = t(lambda: eng._chunk(copy_tree(carry0), imgs), n=8)
    ms_chunk -= ms_copy
    packed = out[1]

    # BoW register+score program on the chunk output (donates bow_db —
    # same fresh-copy treatment)
    db0 = copy_tree(h.bow_db)
    ms_dbcopy, _ = t(lambda: copy_tree(db0), n=8)
    ms_bow, _ = t(lambda: h._bow_register(h.map, copy_tree(db0),
                                          packed)[1], n=8)
    ms_bow -= ms_dbcopy

    # covis prefetch (8-slot batch)
    ms_covis, _ = t(lambda: h._covis(h.map, jnp.zeros((8,), jnp.int32)),
                    n=8)
    # speculative relpose
    z = jnp.int32(0)
    ms_rel, _ = t(lambda: h._relpose(h.map, z, z), n=4)

    print(f"chunk program (16 frames, blocked): {ms_chunk:7.1f} ms "
          f"({ms_chunk / chunk:.2f} ms/frame)")
    print(f"_bow_register (BOW_ROWS rows):      {ms_bow:7.1f} ms")
    print(f"_covis (8 slots):                   {ms_covis:7.1f} ms")
    print(f"_relpose (one candidate):           {ms_rel:7.1f} ms")
    print(f"loop steady-state adds ~_bow_register per chunk to the "
          f"device stream; worker relpose/covis only on candidate folds")


if __name__ == "__main__":
    main()
