"""Motion-only pose estimation: batched Levenberg-Marquardt on SE(3).

Replaces the reference's g2o graph of one free VertexSE3Expmap with all
mappoints fixed/marginalized (StandardPoseTracker::InitializeGraph,
ref src/posetracker.cpp:73-99; LM x10 :66-67). Residuals are normalized
reprojection errors with per-octave information and a Huber kernel
(ref src/method.cpp:59-80), whitened so the Huber delta is the standard
sqrt(5.991).

The whole solve is a lax.scan of `num_iterations` damped Gauss-Newton
steps over fixed-shape arrays — one 6x6 dense solve per iteration, no
data-dependent shapes, so it fuses into the tracking program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import TrackerConfig
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.optim import robust

_HI = jax.lax.Precision.HIGHEST


class PoseLMResult(NamedTuple):
    T_cw: jnp.ndarray        # (4, 4) optimized pose
    cost: jnp.ndarray        # () final robust cost
    inlier_r2: jnp.ndarray   # (N,) squared whitened residual norms at optimum


def _residuals(T_cw: jnp.ndarray, Xw: jnp.ndarray, z_norm: jnp.ndarray,
               inv_sigma: jnp.ndarray, stereo=None):
    """Whitened normalized-reprojection residuals and camera-frame points.

    r = (pi(T Xw) - z) / sigma, shape (N, 2). Points behind the camera are
    flagged (their weight is zeroed by the caller mask).

    stereo: optional (z_right_norm (N,), stereo_mask (N,), baseline ())
    adds a third row ((x - b)/z - ur_n)/sigma, zeroed where no stereo
    measurement exists — the reference's stereo edge residual
    (EdgeStereoSE3ProjectXYZ, ref src/method.cpp:43-57). The stereo row
    pins the view-axis translation and scale that pure reprojection
    leaves weakly observable.
    """
    Xc = se3.transform(T_cw, Xw)
    z = Xc[..., 2]
    good = z > 1e-3
    zsafe = jnp.where(good, z, 1.0)
    pred = jnp.stack([Xc[..., 0] / zsafe, Xc[..., 1] / zsafe], axis=-1)
    r = (pred - z_norm) * inv_sigma[:, None]
    if stereo is not None:
        z_right, s_mask, b = stereo
        pred_r = (Xc[..., 0] - b) / zsafe
        r3 = (pred_r - z_right) * inv_sigma * s_mask
        r = jnp.concatenate([r, r3[:, None]], axis=-1)
    return r, Xc, good


def _jacobian(Xc: jnp.ndarray, inv_sigma: jnp.ndarray,
              stereo=None) -> jnp.ndarray:
    """d(whitened residual)/d(xi) for left-mult update T <- exp(xi) T.

    J = 1/sigma * [dpi/dXc] @ [I | -hat(Xc)], shape (N, 2, 6),
    xi layout [rho(3), phi(3)]. With `stereo` (see _residuals) a third
    row for the right-x residual, zeroed where no stereo.
    """
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = jnp.where(z > 1e-3, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    # dpi/dXc (2x3)
    # row u: [1/z, 0, -x/z^2]; row v: [0, 1/z, -y/z^2]
    # dXc/drho = I ; dXc/dphi = -hat(Xc)
    # J_u = [1/z, 0, -x/z^2 | -x*y/z^2, 1 + x^2/z^2, -y/z]
    # J_v = [0, 1/z, -y/z^2 | -(1 + y^2/z^2), x*y/z^2, x/z]
    ju = jnp.stack([iz, zero, -x * iz2,
                    -x * y * iz2, 1.0 + x * x * iz2, -y * iz], axis=-1)
    jv = jnp.stack([zero, iz, -y * iz2,
                    -(1.0 + y * y * iz2), x * y * iz2, x * iz], axis=-1)
    rows = [ju, jv]
    if stereo is not None:
        _, s_mask, b = stereo
        xb = x - b
        # d((x-b)/z)/dXc = [1/z, 0, -(x-b)/z^2]; chain with [I | -hat(Xc)]
        jr = jnp.stack([iz, zero, -xb * iz2,
                        -xb * y * iz2, 1.0 + x * xb * iz2, -y * iz],
                       axis=-1) * s_mask[:, None]
        rows.append(jr)
    J = jnp.stack(rows, axis=-2)  # (N, 2 or 3, 6)
    return J * inv_sigma[:, None, None]


def _robust_cost(r: jnp.ndarray, w_valid: jnp.ndarray, delta: float):
    rn = jnp.linalg.norm(r, axis=-1)
    return jnp.sum(robust.huber_cost(rn, delta) * w_valid)


def reprojection_inliers(cam_left, T_cw: jnp.ndarray, Xw: jnp.ndarray,
                         xy_obs: jnp.ndarray, ok: jnp.ndarray,
                         px_thresh: float):
    """Post-solve pixel-space inlier gate shared by the tracker, loop
    relative pose, and relocalization (the reference's
    ReprojectionFilter, src/posetracker.cpp:106-137): in front of the
    camera AND reprojecting within px_thresh of the observation.
    Returns (inlier_mask, depths)."""
    from slam_toolkit_tpu.geometry import camera as cam_mod
    Xc = se3.transform(T_cw, Xw)
    uv = cam_mod.project(cam_left, Xc)
    err_px = jnp.linalg.norm(uv - xy_obs, axis=-1)
    inlier = ok & (Xc[..., 2] > 0.0) & (err_px <= px_thresh)
    return inlier, Xc[..., 2]


def optimize_pose(T_init: jnp.ndarray, Xw: jnp.ndarray, z_norm: jnp.ndarray,
                  sigma2: jnp.ndarray, weight_mask: jnp.ndarray,
                  cfg: TrackerConfig, stereo=None) -> PoseLMResult:
    """LM over cfg.num_iterations with accept/reject damping.

    Xw (N,3) fixed landmarks, z_norm (N,2) normalized observations,
    sigma2 (N,) per-octave variances, weight_mask (N,) 0/1 validity.
    stereo: optional (z_right_norm, stereo_mask, baseline) — see
    _residuals; trace-time None keeps the 2-row hot tracking path.
    """
    inv_sigma = jax.lax.rsqrt(jnp.maximum(sigma2, 1e-12))
    w_valid = weight_mask.astype(jnp.float32)
    # a point pushed BEHIND the camera must cost more than any plausible
    # reprojection error, not drop out of the cost: comparing costs over
    # different active sets lets an ill-conditioned step that throws
    # every landmark behind the camera collapse the cost to 0 and be
    # accepted (the solver then stalls on a garbage pose)
    behind_cost = robust.huber_cost(jnp.float32(1e3), cfg.huber_delta)

    def cost_at(T):
        r, _, good = _residuals(T, Xw, z_norm, inv_sigma, stereo)
        return _robust_cost(r, w_valid * good, cfg.huber_delta) + \
            behind_cost * jnp.sum(w_valid * (1.0 - good))

    def step(carry, _):
        T, lam, cost = carry
        r, Xc, good = _residuals(T, Xw, z_norm, inv_sigma, stereo)
        w = w_valid * good
        rn = jnp.linalg.norm(r, axis=-1)
        w_rob = w * robust.huber_weight(rn, cfg.huber_delta)
        J = _jacobian(Xc, inv_sigma, stereo)
        # H = sum_i w_i J_i^T J_i ; b = -sum_i w_i J_i^T r_i, in full
        # f32: a TF32 contraction (the GPU default for f32 dots) rounds
        # the ~1e6..1e9-magnitude whitened terms to ~3 decimal digits
        H = jnp.einsum('nri,n,nrj->ij', J, w_rob, J, precision=_HI)
        b = -jnp.einsum('nri,n,nr->i', J, w_rob, r, precision=_HI)
        H_damped = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
        xi = jnp.linalg.solve(H_damped, b)
        T_try = se3.normalize(se3.compose(se3.exp(xi), T))
        cost_try = cost_at(T_try)
        accept = cost_try < cost
        T_new = jnp.where(accept, T_try, T)
        lam_new = jnp.where(accept, lam * cfg.lm_lambda_down,
                            lam * cfg.lm_lambda_up)
        cost_new = jnp.where(accept, cost_try, cost)
        return (T_new, lam_new, cost_new), cost_new

    init = (T_init, jnp.float32(cfg.lm_lambda0), cost_at(T_init))
    (T_fin, _, cost_fin), _ = jax.lax.scan(
        step, init, None, length=cfg.num_iterations)
    r_fin, _, good = _residuals(T_fin, Xw, z_norm, inv_sigma, stereo)
    r2 = jnp.sum(r_fin * r_fin, axis=-1)
    r2 = jnp.where(w_valid * good > 0, r2, jnp.inf)
    return PoseLMResult(T_cw=T_fin, cost=cost_fin, inlier_r2=r2)
