"""ops/pose_lm_kernel.py: the fused LM solve vs optim.pose_lm.

The Triton kernel runs here in Pallas interpret mode. Tolerance: f32
sums are taken in another order than the reference's contractions, so
poses agree to 1e-4 in rotation and 1e-3 m in translation, and the final
inlier residuals to a few per cent.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import TrackerConfig
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.optim import pose_lm
from slam_toolkit_tpu.ops import pose_lm_kernel


def _problem(seed, n=300, noise=1e-3):
    rng = np.random.default_rng(seed)
    Xw = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                   rng.uniform(4, 60, n)], -1).astype(np.float32)
    T_true = np.asarray(se3.exp(jnp.asarray(
        rng.uniform(-0.2, 0.2, 6).astype(np.float32))))
    Xc = (T_true[:3, :3] @ Xw.T).T + T_true[:3, 3]
    z = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    z += rng.normal(0, noise, z.shape).astype(np.float32)
    sigma2 = np.full(n, 1e-6, np.float32)
    mask = np.ones(n, bool)
    mask[:: 13] = False
    return (jnp.asarray(Xw), jnp.asarray(z), jnp.asarray(sigma2),
            jnp.asarray(mask), T_true)


def _assert_matches(out, ref):
    T_o, T_r = np.asarray(out.T_cw), np.asarray(ref.T_cw)
    np.testing.assert_allclose(T_o[:3, :3], T_r[:3, :3], atol=1e-4)
    np.testing.assert_allclose(T_o[:3, 3], T_r[:3, 3], atol=1e-3)
    np.testing.assert_array_equal(T_o[3], [0.0, 0.0, 0.0, 1.0])
    r_ref = np.asarray(ref.inlier_r2)
    r_out = np.asarray(out.inlier_r2)
    fin = np.isfinite(r_ref)
    assert (np.isfinite(r_out) == fin).all()
    np.testing.assert_allclose(r_out[fin], r_ref[fin], rtol=5e-2, atol=1e-3)


@pytest.mark.parametrize("seed,n", [(0, 300), (1, 512), (2, 1000)])
def test_kernel_recovers_pose_interpret(seed, n):
    """Pose recovery at N that is (512) and is not (300, 1000) a power
    of two: the padded rows carry zero weight."""
    cfg = TrackerConfig()
    Xw, z, sigma2, mask, T_true = _problem(seed, n=n)
    T0 = jnp.eye(4)
    ref = pose_lm.optimize_pose(T0, Xw, z, sigma2, mask, cfg)
    out = pose_lm_kernel.optimize_pose_triton(T0, Xw, z, sigma2, mask, cfg,
                                              interpret=True)
    assert out.inlier_r2.shape == (n,)
    assert float(jnp.linalg.norm(out.T_cw - T_true)) < 0.02
    _assert_matches(out, ref)
    np.testing.assert_allclose(float(out.cost), float(ref.cost), rtol=1e-3)


def test_kernel_outlier_rejection_interpret():
    """Gross outliers must not drag the kernel's pose away."""
    cfg = TrackerConfig()
    Xw, z, sigma2, mask, T_true = _problem(7)
    z_np = np.array(z)
    z_np[: 30] += 0.5                     # 10% gross outliers
    z = jnp.asarray(z_np)
    out = pose_lm_kernel.optimize_pose_triton(jnp.eye(4), Xw, z, sigma2,
                                              mask, cfg, interpret=True)
    assert float(jnp.linalg.norm(out.T_cw - T_true)) < 0.05
    _assert_matches(out, pose_lm.optimize_pose(jnp.eye(4), Xw, z, sigma2,
                                               mask, cfg))


def test_cpu_dispatch_lowers_reference():
    """Off CUDA the public entry compiles the plain solver."""
    cfg = TrackerConfig()
    Xw, z, sigma2, mask, _ = _problem(3)
    fn = jax.jit(lambda *a: pose_lm_kernel.optimize_pose(*a, cfg))
    args = (jnp.eye(4), Xw, z, sigma2, mask)
    assert "triton" not in fn.lower(*args).as_text().lower()
    got = fn(*args)
    ref = pose_lm.optimize_pose(*args, cfg)
    np.testing.assert_array_equal(np.asarray(got.T_cw), np.asarray(ref.T_cw))


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu):
    """Production width: N = 3072 observations, compiled."""
    cfg = TrackerConfig()
    with jax.default_device(gpu):
        Xw, z, sigma2, mask, _ = _problem(8, n=3072)
        args = (jnp.eye(4), Xw, z, sigma2, mask)
        out = jax.jit(lambda *a: pose_lm_kernel.optimize_pose_triton(
            *a, cfg))(*args)
        ref = jax.jit(lambda *a: pose_lm.optimize_pose(*a, cfg))(*args)
    _assert_matches(out, ref)
