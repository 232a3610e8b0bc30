"""ops/match_kernel.py: the fused top-2 matcher vs the dense reference.

The Triton kernel runs here in Pallas interpret mode; outputs must equal
`_topk2_xla` exactly (distances are integers, argbest is the first
minimum, empty gates report BIG with argbest 0).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from slam_toolkit_tpu.ops.match_kernel import (BIG, _topk2_triton,
                                               _topk2_xla, topk2_match)


def _case(m, n, seed, w=640.0, h=480.0):
    rng = np.random.default_rng(seed)
    a_desc = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    b_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    # half the targets are near-duplicates of queries so real matches and
    # ratio-test discriminations both occur
    b_desc[: m // 2] = a_desc[: m // 2]
    a_uv = rng.uniform(0, [w, h], (m, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [w, h], (n, 2)).astype(np.float32)
    b_xy[: m // 2] = a_uv[: m // 2] + rng.normal(0, 3, (m // 2, 2))
    return tuple(jnp.asarray(x) for x in (a_desc, b_desc, a_uv, b_xy))


@pytest.mark.parametrize("m,n,seed", [(64, 256, 0), (100, 300, 1),
                                      (40, 129, 2)])
def test_kernel_matches_reference_interpret(m, n, seed):
    args = _case(m, n, seed)
    ref = np.asarray(_topk2_xla(*args, 25.0))
    out = np.asarray(_topk2_triton(*args, 25.0, interpret=True))
    assert (ref[:, 0] < BIG).sum() > m // 3          # gates are not empty
    np.testing.assert_array_equal(out, ref)


def test_empty_gates_interpret():
    """No target within either radius -> BIG distances, argbest 0."""
    a_desc, b_desc, a_uv, b_xy = _case(48, 128, 3)
    out = np.asarray(_topk2_triton(a_desc, b_desc, a_uv + 1e6, b_xy, 25.0,
                                   interpret=True))
    ref = np.asarray(_topk2_xla(a_desc, b_desc, a_uv + 1e6, b_xy, 25.0))
    np.testing.assert_array_equal(out, ref)
    assert (out[:, [0, 1, 3, 4]] == BIG).all()
    assert (out[:, [2, 5]] == 0).all()


def test_ties_take_first_column_interpret():
    """Equal Hamming distances at several columns, in different keypoint
    tiles: argbest is the lowest column, second equals best."""
    rng = np.random.default_rng(4)
    m, n = 8, 384
    a_desc = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    b_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    a_uv = rng.uniform(100, 300, (m, 2)).astype(np.float32)
    b_xy = np.full((n, 2), -1e7, np.float32)
    for i in range(m):
        for c in (5 + i, 130 + i, 300 + i):        # three tiles, one tie
            b_desc[c] = a_desc[i]
            b_xy[c] = a_uv[i] + 1.0
    args = tuple(jnp.asarray(x) for x in (a_desc, b_desc, a_uv, b_xy))
    out = np.asarray(_topk2_triton(*args, 25.0, interpret=True))
    np.testing.assert_array_equal(out, np.asarray(_topk2_xla(*args, 25.0)))
    np.testing.assert_array_equal(out[:, 2], 5 + np.arange(m))
    assert (out[:, 0] == 0).all() and (out[:, 1] == 0).all()


def test_kernel_under_vmap_interpret():
    """Batched lanes (the multi-sequence layout) through the kernel's
    batching rule."""
    lanes = [_case(32, 128, 10 + i) for i in range(3)]
    stacked = [jnp.stack(x) for x in zip(*lanes)]
    out = jax.vmap(lambda *a: _topk2_triton(*a, 20.0, interpret=True))(
        *stacked)
    ref = jax.vmap(lambda *a: _topk2_xla(*a, 20.0))(*stacked)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_cpu_dispatch_lowers_reference():
    """Off CUDA the public entry compiles the plain reference: no Triton
    call in the program, and the same numbers."""
    args = _case(64, 256, 5)
    fn = jax.jit(lambda *a: topk2_match(*a, 25.0))
    assert "triton" not in fn.lower(*args).as_text().lower()
    np.testing.assert_array_equal(np.asarray(fn(*args)),
                                  np.asarray(_topk2_xla(*args, 25.0)))


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu):
    """Production width: 3072 landmarks x 2048 keypoints, compiled."""
    with jax.default_device(gpu):
        args = _case(3072, 2048, 6, w=1241.0, h=376.0)
        out = np.asarray(jax.jit(lambda *a: _topk2_triton(*a, 50.0))(*args))
        ref = np.asarray(jax.jit(lambda *a: _topk2_xla(*a, 50.0))(*args))
    np.testing.assert_array_equal(out, ref)
