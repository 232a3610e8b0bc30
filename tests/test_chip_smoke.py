"""chip_smoke.py: refuses to run without a GPU or outside a checkout,
and its main-phase and sharded-lane functions at SlamConfig.tiny()."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from slam_toolkit_tpu.config import SlamConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True])
def test_exits_nonzero_without_gpu(tmp_path, alone):
    """On a CPU-only machine (and alone in a directory, without the
    package) the script fails and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_main_phase_tiny():
    cfg = SlamConfig.tiny()
    imgs, gt = chip_smoke.render(cfg, 9, step=0.25)
    assert imgs.shape == (9, 2, 96, 128)
    res = chip_smoke.run_chunked(cfg, imgs, gt, chunk=4)
    assert res["frames"] == 9 and res["timed_frames"] == 4
    assert res["ate_m"] < 0.15, res
    assert res["keyframes"] >= 2 and res["mappoints"] > 50


def test_sharded_lanes_tiny_match_one_device():
    """The --multi phase on four virtual CPU devices: bitwise equal."""
    cfg = SlamConfig.tiny()
    imgs, _ = chip_smoke.render(cfg, 4 + 2 * 2, step=0.25)
    res = chip_smoke.run_multi(cfg, imgs, n_dev=4, chunk=2, n_chunks=2)
    assert res["sharded"].shape == (4, 4, 36)
    assert "seq" in res["sharding"]
    np.testing.assert_array_equal(res["sharded"], res["single"])
