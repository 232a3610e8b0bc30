"""Trace two bench chunks on the GPU and rank the device's kernels.

Uses the bench's rendered sequence (bench.stage_frames) and traces two
mid-sequence chunks: a warm map with the production keyframe rate.
Prints the device-busy share of the traced window and the kernels with
the most device time; writes the trace and the full per-kernel table
under `.bench_data/trace/` in the checkout.

Run: python scripts/trace_chunk.py   (on the GPU)
"""
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.utils import compile_cache, timing
from slam_toolkit_tpu.utils.paths import data_path

compile_cache.enable()

from bench import stage_frames
from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

CHUNK = 16
N_FRAMES = 160

cfg = SlamConfig()
stacked, _ = stage_frames(cfg, N_FRAMES)
chunks = [jnp.asarray(stacked[i:i + CHUNK], jnp.float32)
          for i in range(0, N_FRAMES, CHUNK)]
jax.block_until_ready(chunks)
eng = ChunkedSlamEngine(cfg, chunk_size=CHUNK)
for c in chunks[:6]:
    eng.process_chunk(c)
eng.flush()

logdir = data_path("trace/chunk")
t0 = time.perf_counter()
with timing.device_trace(logdir):
    eng.process_chunk(chunks[6])
    eng.process_chunk(chunks[7])
    eng.flush()
window_ns = (time.perf_counter() - t0) * 1e9

events = timing.device_events(timing.load_trace(logdir))
busy = timing.busy_ns(events)
per_kernel = collections.defaultdict(lambda: [0, 0.0])
for name, _, dur in events:
    per_kernel[name][0] += 1
    per_kernel[name][1] += dur
rows = sorted(({"kernel": k, "calls": n, "device_ms": ns / 1e6}
               for k, (n, ns) in per_kernel.items()),
              key=lambda r: -r["device_ms"])
print(f"{2 * CHUNK} frames: device busy {busy / 1e6:.3f} ms of a "
      f"{window_ns / 1e6:.3f} ms window (busy share "
      f"{busy / window_ns:.4f}), {len(events)} device events")
for r in rows[:25]:
    print(f"{r['device_ms']:10.4f} ms  x{r['calls']:5d}  {r['kernel'][:90]}")
out = data_path("trace/chunk_kernels.json")
with open(out, "w") as f:
    json.dump({"device": jax.devices()[0].device_kind, "frames": 2 * CHUNK,
               "busy_ms": busy / 1e6, "window_ms": window_ns / 1e6,
               "kernels": rows}, f, indent=1)
print("wrote", out)
