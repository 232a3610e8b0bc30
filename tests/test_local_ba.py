import jax
import jax.numpy as jnp
import numpy as np

from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.optim.local_ba import BAProblem, solve_ba


def make_problem(key, W=4, P=64, noise=0.0, pose_noise=0.05,
                 point_noise=0.2, baseline=0.5):
    ks = jax.random.split(key, 6)
    # true poses along a line
    xi = jnp.stack([jnp.array([0.0, 0.0, 0.5 * i, 0.0, 0.02 * i, 0.0])
                    for i in range(W)])
    T_true = se3.exp(xi)
    X_true = jnp.concatenate([
        jax.random.uniform(ks[0], (P, 2), minval=-8.0, maxval=8.0),
        jax.random.uniform(ks[1], (P, 1), minval=8.0, maxval=30.0)], axis=-1)

    Xc = jnp.einsum('wij,pj->wpi', T_true[:, :3, :3], X_true) \
        + T_true[:, :3, 3][:, None, :]
    u = Xc[..., 0] / Xc[..., 2]
    v = Xc[..., 1] / Xc[..., 2]
    ur = (Xc[..., 0] - baseline) / Xc[..., 2]
    z = jnp.stack([u, v, ur], axis=-1)
    if noise > 0:
        z = z + noise * jax.random.normal(ks[2], z.shape)
    obs = Xc[..., 2] > 1.0
    sigma = 1.0 / 700.0
    inv_sigma = jnp.full((W, P), 1.0 / sigma)

    # perturb initial guesses; first pose fixed at truth (gauge)
    dxi = pose_noise * jax.random.normal(ks[3], (W, 6))
    dxi = dxi.at[0].set(0.0)
    T_init = se3.exp(dxi) @ T_true
    X_init = X_true + point_noise * jax.random.normal(ks[4], (P, 3))

    prob = BAProblem(
        T_cw=T_init,
        pose_fixed=jnp.zeros(W, bool).at[0].set(True),
        pose_valid=jnp.ones(W, bool),
        Xw=X_init,
        point_valid=jnp.ones(P, bool),
        z=z,
        inv_sigma=inv_sigma,
        obs_mask=obs,
        stereo_mask=obs,
        baseline=jnp.float32(baseline),
    )
    return prob, T_true, X_true


def test_ba_recovers_poses_and_points():
    prob, T_true, X_true = make_problem(jax.random.PRNGKey(0))
    res = jax.jit(lambda pr: solve_ba(pr, iters=15))(prob)
    perr = jnp.abs(se3.log(res.T_cw @ se3.inv(T_true))).max()
    xerr = jnp.abs(res.Xw - X_true).max()
    assert float(perr) < 1e-3, float(perr)
    assert float(xerr) < 5e-3, float(xerr)


def test_ba_fixed_pose_untouched():
    prob, T_true, _ = make_problem(jax.random.PRNGKey(1))
    res = solve_ba(prob, iters=5)
    np.testing.assert_allclose(np.asarray(res.T_cw[0]),
                               np.asarray(prob.T_cw[0]), atol=1e-7)


def test_ba_masked_points_untouched():
    prob, T_true, X_true = make_problem(jax.random.PRNGKey(2))
    pv = prob.point_valid.at[:10].set(False)
    prob = prob._replace(point_valid=pv)
    res = solve_ba(prob, iters=8)
    np.testing.assert_allclose(np.asarray(res.Xw[:10]),
                               np.asarray(prob.Xw[:10]), atol=1e-7)
    perr = jnp.abs(se3.log(res.T_cw @ se3.inv(T_true))).max()
    assert float(perr) < 1e-3


def test_ba_mono_only_with_one_stereo_anchor():
    """Reference-style problem: mono edges + stereo anchor only at ref kf."""
    prob, T_true, X_true = make_problem(jax.random.PRNGKey(3))
    # stereo only on the first observing kf per point
    first = jnp.argmax(prob.obs_mask, axis=0)
    stereo = jnp.zeros_like(prob.obs_mask).at[
        first, jnp.arange(prob.Xw.shape[0])].set(True) & prob.obs_mask
    prob = prob._replace(stereo_mask=stereo)
    res = solve_ba(prob, iters=15)
    perr = jnp.abs(se3.log(res.T_cw @ se3.inv(T_true))).max()
    assert float(perr) < 5e-3, float(perr)


def test_ba_noisy_reduces_cost():
    prob, T_true, X_true = make_problem(jax.random.PRNGKey(4),
                                        noise=0.5 / 700.0)
    res = solve_ba(prob, iters=10)
    prob_at_result = prob._replace(T_cw=res.T_cw, Xw=res.Xw)
    res2 = solve_ba(prob_at_result, iters=1)
    assert float(res.cost) <= float(solve_ba(prob, iters=1).cost)
    perr = jnp.abs(se3.log(res.T_cw @ se3.inv(T_true))).max()
    assert float(perr) < 0.02


def test_ba_masked_pose_slot_untouched():
    """An invalid pose slot and invalid points keep their inputs while
    the valid free poses still converge."""
    prob, T_true, X_true = make_problem(jax.random.PRNGKey(5))
    prob = prob._replace(pose_valid=prob.pose_valid.at[3].set(False),
                         point_valid=prob.point_valid.at[40:].set(False))
    res = jax.jit(lambda pr: solve_ba(pr, iters=8))(prob)
    np.testing.assert_array_equal(np.asarray(res.T_cw[3]),
                                  np.asarray(prob.T_cw[3]))
    np.testing.assert_array_equal(np.asarray(res.Xw[40:]),
                                  np.asarray(prob.Xw[40:]))
    perr = jnp.abs(se3.log(res.T_cw[:3] @ se3.inv(T_true[:3]))).max()
    assert float(perr) < 1e-3, float(perr)
    assert np.all(np.asarray(res.edge_r2)[3] == 0.0)
