"""Test environment: CPU with an 8-device virtual mesh by default.

Multi-device sharding tests run against
XLA_FLAGS=--xla_force_host_platform_device_count=8 (SURVEY.md §4's
recommendation). Tests that need a GPU carry the `gpu` marker and skip
on the CPU; on a machine with a card,
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` runs them, and
`python chip_smoke.py` covers the same kernels end to end.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from slam_toolkit_tpu.utils import compile_cache  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")
compile_cache.enable()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none. Decided
    at run time, never at import or collection, so every pytest-xdist
    worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return devs[0]
