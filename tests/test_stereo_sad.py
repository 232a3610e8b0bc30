"""ops/stereo_sad.py: correlation stereo against known disparities."""

import numpy as np
import pytest
import jax.numpy as jnp

from slam_toolkit_tpu.ops import stereo_sad
from slam_toolkit_tpu.ops.stereo_sad import (_shifts, _strip_w, sad_curve,
                                             WIN, PAD)


def _textured_pair(h, w, disp, seed=0):
    """Right image = left shifted by `disp` px (constant disparity)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w + 200)).astype(np.float32)
    # smooth a little so subpixel parabola is meaningful
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) * 0.25 + base * 0.5 +
                np.roll(base, -1, ax) * 0.25)
    left = base[:, 100:100 + w]
    right = base[:, 100 + disp:100 + disp + w]
    return jnp.asarray(left), jnp.asarray(right)


def test_recovers_constant_disparity():
    h, w, d = 96, 512, 23
    left, right = _textured_pair(h, w, d)
    rng = np.random.default_rng(1)
    k = 64
    xy = np.stack([rng.uniform(150, w - 20, k),
                   rng.uniform(20, h - 20, k)], -1).astype(np.float32)
    xr, ok = stereo_sad.match(left, right, jnp.asarray(xy),
                              jnp.ones(k, bool), max_disp=60)
    xr, ok = np.asarray(xr), np.asarray(ok)
    assert ok.mean() > 0.9
    err = np.abs((np.round(xy[ok, 0]) - xr[ok]) - d)
    assert np.median(err) < 0.25, np.median(err)


@pytest.mark.slow
def test_uniqueness_rejects_flat_regions():
    h, w = 96, 384
    left = jnp.zeros((h, w), jnp.float32)
    right = jnp.zeros((h, w), jnp.float32)
    xy = jnp.asarray([[200.0, 48.0], [250.0, 30.0]], jnp.float32)
    _, ok = stereo_sad.match(left, right, xy, jnp.ones(2, bool), max_disp=60)
    assert not bool(np.asarray(ok).any())


def test_sad_curve_matches_brute_force():
    """Every (keypoint, shift) SAD equals a direct numpy sum over the
    11x11 window, including keypoints whose corners were clamped."""
    h, w, d = 96, 512, 17
    left, right = _textured_pair(h, w, d, seed=2)
    rng = np.random.default_rng(3)
    k = 48
    max_disp = 60
    side = 2 * WIN + 1
    xl = np.concatenate([rng.integers(120, w - 20, k - 4), [0, 3, w - 1, 70]])
    yl = np.concatenate([rng.integers(20, h - 20, k - 4), [0, h - 1, 2, 50]])
    ys0 = np.clip(yl - WIN, 0, h - side).astype(np.int32)
    xl0 = np.clip(xl - WIN, 0, w - side).astype(np.int32)
    xs0 = np.clip(xl - (max_disp + WIN + PAD), 0,
                  w - _strip_w(max_disp)).astype(np.int32)
    out = np.asarray(sad_curve(left, right, jnp.asarray(ys0),
                               jnp.asarray(xl0), jnp.asarray(xs0), max_disp))
    L, R = np.asarray(left), np.asarray(right)
    ns = _shifts(max_disp)
    assert out.shape == (k, ns)
    ref = np.empty((k, ns), np.float32)
    for i in range(k):
        patch = L[ys0[i]:ys0[i] + side, xl0[i]:xl0[i] + side]
        for s in range(ns):
            win = R[ys0[i]:ys0[i] + side, xs0[i] + s:xs0[i] + s + side]
            ref[i, s] = np.abs(win - patch).sum()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-2)
