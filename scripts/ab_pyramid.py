"""Same-process A/B of pyramid modes inside a scan (per-frame ms)."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp
import dataclasses

from slam_toolkit_tpu.utils import compile_cache
compile_cache.enable()

from slam_toolkit_tpu.config import ExtractorConfig
from slam_toolkit_tpu.ops import pyramid

C = 16
rng = np.random.default_rng(0)
images = jnp.asarray(rng.uniform(0, 255, (C, 376, 1241)).astype(np.float32))
jax.block_until_ready(images)


def consume(levels):
    return sum(jnp.sum(lv.ravel()[:4096]) for lv in levels)


def timed(cfg, name, n=8):
    @jax.jit
    def run(images):
        def body(c, img):
            return c + consume(pyramid.build_pyramid(img, cfg)), 0.0
        return jax.lax.scan(body, jnp.float32(0.0), images)[0]
    o = run(images); jax.block_until_ready(o)
    best = 1e9
    for _ in range(n):
        t0 = time.perf_counter()
        o = run(images); jax.block_until_ready(o)
        best = min(best, time.perf_counter() - t0)
    print(f"{name:24s} {best / C * 1e3:6.3f} ms/frame (best of {n})")
    return best


mat = dataclasses.replace(ExtractorConfig(), pyramid_mode="matmul")
pol = dataclasses.replace(ExtractorConfig(), pyramid_mode="poly")
for rep in range(2):
    timed(mat, f"matmul rep{rep}")
    timed(pol, f"poly rep{rep}")
