"""ops/patches.py: the window gather against numpy slicing."""

import numpy as np
import pytest
import jax.numpy as jnp

from slam_toolkit_tpu.ops.patches import gather_blocks


def _numpy_blocks(img, ys, xs, bh, bw):
    return np.stack([img[y:y + bh, x:x + bw] for y, x in zip(ys, xs)])


def _case(h, w, bh, bw, k, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ys = rng.integers(0, h - bh + 1, k, dtype=np.int32)
    xs = rng.integers(0, w - bw + 1, k, dtype=np.int32)
    return img, ys, xs


@pytest.mark.parametrize("bh,bw,k", [(31, 31, 64), (11, 17, 40),
                                     (11, 11, 130)])
def test_matches_numpy_slicing(bh, bw, k):
    img, ys, xs = _case(96, 384, bh, bw, k, seed=bh * 100 + bw)
    out = gather_blocks(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs),
                        bh, bw)
    assert out.shape == (k, bh, bw)
    np.testing.assert_array_equal(np.asarray(out),
                                  _numpy_blocks(img, ys, xs, bh, bw))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_corner_extremes(dtype):
    """Corners at 0 and at the largest legal offset on both axes, in
    both descriptor-path dtypes: the windows are copied bit for bit."""
    h, w, bh, bw = 64, 300, 31, 31
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32)) \
        .astype(dtype)
    ys = np.asarray([0, h - bh, 1, h - bh, 7, 8, 0], np.int32)
    xs = np.asarray([0, w - bw, w - bw, 0, 127, 128, w - bw], np.int32)
    out = gather_blocks(img, jnp.asarray(ys), jnp.asarray(xs), bh, bw)
    assert out.dtype == dtype
    ref = _numpy_blocks(np.asarray(img.astype(jnp.float32)), ys, xs, bh, bw)
    np.testing.assert_array_equal(np.asarray(out.astype(jnp.float32)), ref)
