"""On-chip timing of the BoW pipeline at the reference's ORBvoc scale.

The reference loads a k=10, L=6 ~= 1M-word vocabulary at every startup
(ref src/pipeline.cpp:60-67, thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:
1338-1398) and walks its inverted file per keyframe. This script
instantiates that configuration (loop/vocab.synthesize) and times the
device runtime path at production shapes:

  - descent+top-w query: 6 gather+argmin-over-10 levels over the
    1,111,111-node tables + K-space top-w compaction (vocab.bow_topw)
  - db register: TopWBow row write at a dynamic slot
  - scoring: topw_l1_score of one query against the full F=1024 ring
  - the engine's fused _bow_register (BOW_ROWS keyframes per chunk)

Run:  python scripts/bench_vocab_1m.py          (on the GPU)
      JAX_PLATFORMS=cpu python scripts/bench_vocab_1m.py

Writes one JSON line to stdout; timings/bytes go to stderr.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timeit(fn, *a, n=20, warm=3):
    import jax
    for _ in range(warm):
        out = fn(*a)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*a)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1000.0, out


def main():
    import jax
    import jax.numpy as jnp

    from slam_toolkit_tpu.utils import compile_cache
    compile_cache.enable()

    from slam_toolkit_tpu.loop import vocab as V
    from slam_toolkit_tpu.utils.paths import data_path

    K = int(os.environ.get("VOC_K_FEATS", "2048"))   # features/keyframe
    W = int(os.environ.get("VOC_TOP_W", "500"))      # sparse row width
    F = int(os.environ.get("VOC_DB_F", "1024"))      # keyframe ring

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cache = data_path("voc_1m.npz")
    if os.path.exists(cache):
        voc = V.load(cache)
        sys.stderr.write(f"[voc1m] loaded cached tree in "
                         f"{time.perf_counter() - t0:.1f}s\n")
    else:
        corpus = rng.integers(0, 2 ** 32, (50_000, 8), dtype=np.uint32)
        voc = V.synthesize(k=10, levels=6, seed=0, corpus=corpus)
        V.save(voc, cache)
        sys.stderr.write(f"[voc1m] synthesized k=10 L=6 tree in "
                         f"{time.perf_counter() - t0:.1f}s\n")
    assert voc.num_words == 10 ** 6
    hbm = (voc.nodes.size * 4 + voc.children.size * 4 +
           voc.word_id.size * 4 + voc.weights.size * 4)
    sys.stderr.write(f"[voc1m] nodes {voc.nodes.shape[0]:,}; vocabulary "
                     f"HBM {hbm / 1e6:.1f} MB (nodes "
                     f"{voc.nodes.size * 4 / 1e6:.1f} + children "
                     f"{voc.children.size * 4 / 1e6:.1f} + word_id "
                     f"{voc.word_id.size * 4 / 1e6:.1f} + idf "
                     f"{voc.weights.size * 4 / 1e6:.1f})\n")

    desc = jnp.asarray(rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint32))
    valid = jnp.ones((K,), bool)

    # 1) descent only (word ids)
    words_fn = jax.jit(lambda d: V.descriptor_words(voc, d, valid))
    ms_desc, _ = timeit(words_fn, desc)
    # 2) full sparse query (descent + K-space top-w)
    q_fn = jax.jit(lambda d: V.bow_query(voc, d, valid, sparse=True,
                                         top_w=W))
    ms_query, q = timeit(q_fn, desc)
    # 3) register at a dynamic slot
    db = V.make_bow_db(voc, F, sparse=True, top_w=W)
    set_fn = jax.jit(lambda db, s, q: V.db_set(db, s, q))
    ms_set, db = timeit(set_fn, db, jnp.int32(17), q)
    # 4) score against the full ring
    score_fn = jax.jit(V.bow_score)
    ms_score, _ = timeit(score_fn, q, db)

    db_bytes = db.words.size * 4 + db.weights.size * 4
    sys.stderr.write(
        f"[voc1m] per-keyframe on {jax.devices()[0].platform}: descent "
        f"{ms_desc:.2f} ms, query(descent+topw) {ms_query:.2f} ms, "
        f"register {ms_set:.2f} ms, score-vs-{F} {ms_score:.2f} ms; "
        f"db {db_bytes / 1e6:.1f} MB (dense would be "
        f"{F * voc.num_words * 4 / 1e9:.1f} GB)\n")

    print(json.dumps({
        "metric": "orbvoc_1m_query_ms",
        "value": round(ms_query, 3),
        "unit": "ms/keyframe",
        "descent_ms": round(ms_desc, 3),
        "register_ms": round(ms_set, 3),
        "score_ms": round(ms_score, 3),
        "vocab_hbm_mb": round(hbm / 1e6, 1),
        "db_mb": round(db_bytes / 1e6, 1),
    }))


if __name__ == "__main__":
    main()
