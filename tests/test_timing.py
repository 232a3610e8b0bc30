"""utils/timing.py: the reduction of a profiler trace to device time,
and utils/paths.py: where run-time data lives."""

import os
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import pytest

from slam_toolkit_tpu.utils import paths, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ev(name, start, dur):
    return NS(name=name, start_ns=start, duration_ns=dur)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 10), (20, 5)], 15.0),               # disjoint
    ([(0, 10), (5, 10)], 15.0),               # overlapping, two streams
    ([(0, 30), (5, 5), (10, 5)], 30.0),       # nested
    ([(40, 10), (0, 10), (5, 10)], 25.0),     # out of order
])
def test_busy_ns_is_the_union_of_intervals(intervals, busy):
    events = [("k", s, d) for s, d in intervals]
    assert timing.busy_ns(events) == busy


def test_device_events_read_gpu_kernel_lines_only():
    """Host planes and the profiler's derived module/op lines are
    skipped: the derived spans would count launch gaps as busy."""
    profile = NS(planes=[
        NS(name="/host:CPU", lines=[NS(name="python",
                                       events=[_ev("host", 0, 1000)])]),
        NS(name="/device:GPU:0", lines=[
            NS(name="Stream #13(Compute)", events=[_ev("topk2_match", 0, 7),
                                                    _ev("fusion", 10, 3)]),
            NS(name="XLA Modules", events=[_ev("jit_f", 0, 13)]),
            NS(name="XLA Ops", events=[_ev("fusion", 10, 3)]),
        ]),
    ])
    events = timing.device_events(profile)
    assert events == [("topk2_match", 0, 7), ("fusion", 10, 3)]
    assert timing.busy_ns(events) == 10.0


def test_device_ms_is_not_measured_without_a_gpu(tmp_path):
    """On the CPU the trace has no device plane: None, never a host
    number under a device name."""
    f = jax.jit(lambda x: (x * 2.0).sum())
    ms = timing.device_ms(f, (jnp.ones((64, 64)),), reps=3,
                          logdir=str(tmp_path / "trace"))
    assert ms is None
    assert timing.load_trace(str(tmp_path / "trace")).planes


def test_data_dir_is_inside_the_checkout_and_ignored(monkeypatch, tmp_path):
    assert paths.DATA_DIR == os.path.join(REPO, ".bench_data")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".bench_data/" in f.read().split()
    monkeypatch.setattr(paths, "DATA_DIR", str(tmp_path / "data"))
    p = paths.data_path("trace/chunk/x.json")
    assert p == str(tmp_path / "data" / "trace" / "chunk" / "x.json")
    assert os.path.isdir(os.path.dirname(p))
