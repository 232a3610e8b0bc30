"""Batched Sim(3) operations in pure jnp.

The reference's loop closer optimizes an SE(3) pose graph and carries a
TODO to upgrade it to Sim(3) (ref src/loopcloser.cpp:107 "TODO ... SE3
-> Sim3"), the standard fix for scale drift in the ORB-SLAM family
(monocular, or long stereo loops with degraded baselines). This module
provides the group ops the Sim(3) pose graph (optim/pose_graph.py)
needs.

Representation: (..., 4, 4) matrices [[s*R, t], [0, 1]]; tangent
vectors are (..., 7) with layout [rho(3), phi(3), sigma] — translation,
rotation, log-scale — and the left-multiplicative convention
S_new = Exp(xi) @ S_old, matching geometry/se3.py. With sigma = 0 every
function reduces exactly to its SE(3) counterpart.

All functions broadcast over leading batch dims and are jit/vmap-safe
(small-angle/small-scale branches are jnp.where on series expansions;
both branches NaN-free).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.geometry.se3 import hat, so3_exp, so3_log

_EPS = 1e-8
_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def make(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3), (..., 3), (...,) -> (..., 4, 4) with block s*R."""
    return se3.make(R * s[..., None, None], t)


def scale_of(S: jnp.ndarray) -> jnp.ndarray:
    """Recover s from the [[s*R, t], [0, 1]] block (det(sR) = s^3)."""
    sR = S[..., :3, :3]
    # row norms of s*R are s (R orthonormal); average the three for noise
    return jnp.mean(jnp.linalg.norm(sR, axis=-1), axis=-1)


def rotation_of(S: jnp.ndarray) -> jnp.ndarray:
    return S[..., :3, :3] / scale_of(S)[..., None, None]


def inv(S: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse: (R, t, s)^-1 = (R^T, -(1/s) R^T t, 1/s)."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    t_inv = -s_inv[..., None] * jnp.einsum(
        '...ij,...j->...i', Rt, S[..., :3, 3], precision=_HI)
    return make(Rt, t_inv, s_inv)


def _calc_W(theta2: jnp.ndarray, sigma: jnp.ndarray, W_phi: jnp.ndarray):
    """The Sim(3) translation mixer W = int_0^1 e^{sigma u} R(u phi) du
    = C I + A hat(phi) + B hat(phi)^2, so that Exp translation t = W rho.

    Closed forms (s = e^sigma, theta = |phi|, c = theta^2 + sigma^2):
      C = (s - 1) / sigma
      A = (s sin(theta) sigma + theta (1 - s cos(theta))) / (theta c)
      B = (C - ((s cos(theta) - 1) sigma + s sin(theta) theta) / c)
          / theta^2
    with series fallbacks at theta -> 0 and/or sigma -> 0. Every
    selected-against branch is computed on clamped-safe denominators.
    """
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    s = jnp.exp(sigma)
    small_t = theta2 < 1e-8
    small_s = jnp.abs(sigma) < 1e-5
    sigma_safe = jnp.where(small_s, 1.0, sigma)
    theta_safe = jnp.where(small_t, 1.0, theta)
    t2_safe = jnp.where(small_t, 1.0, theta2)
    c = theta2 + sigma * sigma
    c_safe = jnp.where(c < _EPS, 1.0, c)

    C = jnp.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                  (s - 1.0) / sigma_safe)

    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    # generic A, B (theta > 0, any sigma)
    A_gen = (a * sigma + (1.0 - b) * theta) / (theta_safe * c_safe)
    B_gen = (C - ((b - 1.0) * sigma + a * theta) / c_safe) / t2_safe
    # theta -> 0, sigma != 0: A = (s(sigma-1)+1)/sigma^2,
    #                         B = (s(sigma^2-2 sigma+2) - 2)/(2 sigma^3)
    s2 = sigma_safe * sigma_safe
    A_t0 = (s * (sigma - 1.0) + 1.0) / s2
    B_t0 = (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0) \
        / (2.0 * s2 * sigma_safe)
    # sigma -> 0 (any theta): the SE(3) V-matrix coefficients
    A_s0 = jnp.where(small_t, 0.5 - theta2 / 24.0,
                     (1.0 - jnp.cos(theta)) / t2_safe)
    B_s0 = jnp.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - jnp.sin(theta)) / (t2_safe * theta_safe))

    A = jnp.where(small_s, A_s0, jnp.where(small_t, A_t0, A_gen))
    B = jnp.where(small_s, B_s0, jnp.where(small_t, B_t0, B_gen))

    eye = jnp.broadcast_to(jnp.eye(3, dtype=W_phi.dtype), W_phi.shape)
    return (C[..., None, None] * eye + A[..., None, None] * W_phi
            + B[..., None, None] * _mm(W_phi, W_phi))


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 7) [rho, phi, sigma] -> (..., 4, 4) similarity."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    theta2 = jnp.sum(phi * phi, axis=-1)
    R = so3_exp(phi)
    W = _calc_W(theta2, sigma, hat(phi))
    t = jnp.einsum('...ij,...j->...i', W, rho, precision=_HI)
    return make(R, t, jnp.exp(sigma))


def log(S: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 7) [rho, phi, sigma].

    rho deliberately stays a batched LU `linalg.solve` (not the ~30-op
    adjugate inverse): in a closed-form-inverse A/B on the loop bench
    the f32 adjugate's round-off measurably moved the pose-graph
    optimum (clothoid ATE 0.858 -> 1.465 m)."""
    s = scale_of(S)
    sigma = jnp.log(s)
    R = S[..., :3, :3] / s[..., None, None]
    phi = so3_log(R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    W = _calc_W(theta2, sigma, hat(phi))
    rho = jnp.linalg.solve(W, S[..., :3, 3][..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return _mm(A, B)


def adjoint(S: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 7, 7) adjoint in [rho, phi, sigma] layout:

        Ad = [[ s R,  hat(t) R,  -t ],
              [  0,      R,       0 ],
              [  0,      0,       1 ]]
    """
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    batch = S.shape[:-2]
    Ad = jnp.zeros(batch + (7, 7), S.dtype)
    Ad = Ad.at[..., :3, :3].set(s[..., None, None] * R)
    Ad = Ad.at[..., :3, 3:6].set(_mm(hat(t), R))
    Ad = Ad.at[..., :3, 6].set(-t)
    Ad = Ad.at[..., 3:6, 3:6].set(R)
    Ad = Ad.at[..., 6, 6].set(1.0)
    return Ad


def transform(S: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) similarity to points (..., 3)."""
    return jnp.einsum('...ij,...j->...i', S[..., :3, :3], X,
                      precision=_HI) + S[..., :3, 3]


def normalize(S: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize the rotation factor, preserving scale."""
    s = scale_of(S)
    R = S[..., :3, :3] / s[..., None, None]
    Rn = se3.normalize(se3.make(R, jnp.zeros_like(S[..., :3, 3])))[..., :3, :3]
    return make(Rn, S[..., :3, 3], s)


def from_se3(T: jnp.ndarray, s: jnp.ndarray | float = 1.0) -> jnp.ndarray:
    """Lift an SE(3) pose (optionally with a scale) to Sim(3)."""
    s = jnp.asarray(s, T.dtype)
    s = jnp.broadcast_to(s, T.shape[:-2])
    return make(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(S: jnp.ndarray) -> jnp.ndarray:
    """Project back to SE(3) as [R, t/s] — the ORB-SLAM convention for
    converting a corrected Sim(3) camera-from-world into a metric pose
    (x_cam = s R x_w + t measures in the DRIFTED local scale; dividing
    by s re-expresses the camera at unit scale, keeping its optical
    center -(1/s) R^T t). Anchored inverse depths scale as
    invd' = invd * s for landmarks anchored in this keyframe."""
    s = scale_of(S)
    return se3.make(rotation_of(S), S[..., :3, 3] / s[..., None])
