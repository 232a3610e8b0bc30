"""Per-stage timing + profiling harness.

The reference's only instrumentation is one steady_clock measurement
around Track() (ref src/pipeline.cpp:144,209-212) shown in the viewer.
Here: a StageTimer that forces device completion per stage (wall-clock
truth under async dispatch), a jax.profiler hook for real traces, and
the reduction of a trace to device time (busy time on the GPU planes).
"""

from __future__ import annotations

import contextlib
import glob
import os
import shutil
import time
from collections import defaultdict
from typing import Dict, List

import jax


class StageTimer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        box: List = []
        yield box
        if self.sync and box:
            jax.block_until_ready(box[0])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def time_stage(self, name: str, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.sync:
            out = jax.block_until_ready(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {1000*tot/max(n,1):9.2f} ms/call "
                         f"x{n:5d} = {tot:7.2f} s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace around a block (view with TensorBoard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# ------------------------------------------------ trace -> device metrics

DEVICE_PLANE = "/device:GPU"
# lines the profiler derives from the kernel lines (a module's or an
# op's span); counting them would fill the launch gaps inside a module
DERIVED_LINE = "XLA "


def load_trace(logdir: str):
    """The newest `.xplane.pb` under `logdir` as jax.profiler.ProfileData."""
    files = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no profiler trace under {logdir}")
    return jax.profiler.ProfileData.from_file(max(files, key=os.path.getmtime))


def device_events(profile) -> List[tuple]:
    """(name, start_ns, duration_ns) of every kernel and copy the device
    planes of a trace record."""
    out = []
    for plane in profile.planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            if line.name.startswith(DERIVED_LINE):
                continue
            out += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' intervals: the time in which
    at least one operation ran on a device."""
    total, end = 0.0, float("-inf")
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def device_ms(fn, args, reps: int = 50, logdir: str = None):
    """Device time per call of `fn(*args)` in ms: the device-busy time of
    a profiler trace of `reps` back-to-back calls, over `reps`. None when
    the trace holds no device events (no GPU)."""
    from slam_toolkit_tpu.utils.paths import data_path
    jax.block_until_ready(fn(*args))
    logdir = logdir or data_path("trace/device_ms")
    shutil.rmtree(logdir, ignore_errors=True)
    with device_trace(logdir):
        jax.block_until_ready([fn(*args) for _ in range(reps)])
    busy = busy_ns(device_events(load_trace(logdir)))
    return busy / reps / 1e6 if busy else None
