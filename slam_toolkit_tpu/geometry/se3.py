"""Batched SE(3) operations in pure jnp.

Replaces the reference's g2o::SE3Quat usage (src/common.h:126-135,
src/method.cpp:82-89). Poses are stored as (..., 4, 4) homogeneous
matrices; tangent vectors are (..., 6) with layout [rho(3), phi(3)]
(translation first, rotation second) and the left-multiplicative
convention used by g2o's VertexSE3Expmap: T_new = Exp(xi) @ T_old.

All functions broadcast over leading batch dimensions, making them safe
under vmap/jit/scan (no data-dependent control flow; the
small-angle branch is a jnp.where on Taylor expansions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8
_HI = jax.lax.Precision.HIGHEST  # 4x4/3x3 pose math: bf16 matmul error
#                                   compounds across thousands of frames


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([zeros, -wz, wy], axis=-1),
        jnp.stack([wz, zeros, -wx], axis=-1),
        jnp.stack([-wy, wx, zeros], axis=-1),
    ], axis=-2)


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) skew -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _so3_coeffs(theta2: jnp.ndarray):
    """Rodrigues coefficients A=sin/t, B=(1-cos)/t^2, C=(1-A)/t^2, stable at 0.

    Both `where` branches are NaN-free (0/0 at theta=0 would otherwise
    poison jax_debug_nans runs and reverse-mode gradients).
    """
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < 1e-8
    t2_safe = jnp.where(small, 1.0, theta2)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / t2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / t2_safe)
    return a, b, c


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    a, b, _ = _so3_coeffs(theta2)
    W = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 3) rotation vector. Stable up to theta < pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sin_t = jnp.sin(theta)
    small = theta < 1e-4
    # theta/sin(theta), Taylor near 0
    scale = jnp.where(small, 1.0 + theta * theta / 6.0,
                      theta / jnp.where(small, 1.0, sin_t))
    phi_generic = w * scale[..., None]
    # near theta = pi, fall back to diagonal-based axis extraction
    near_pi = theta > 3.0
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), 0.0)
    axis_abs = jnp.sqrt(axis2)
    # fix signs from off-diagonal sums: sign(axis_i * axis_j) = sign(R_ij + R_ji)
    s0 = jnp.sign(w[..., 0] + _EPS)  # sin>0 part may vanish; keep deterministic
    sx = jnp.where(jnp.abs(w[..., 0]) > 1e-6, jnp.sign(w[..., 0]), s0)
    sy = jnp.where(jnp.abs(w[..., 1]) > 1e-6, jnp.sign(w[..., 1]),
                   jnp.sign(R[..., 0, 1] + R[..., 1, 0]) * sx)
    sz = jnp.where(jnp.abs(w[..., 2]) > 1e-6, jnp.sign(w[..., 2]),
                   jnp.sign(R[..., 0, 2] + R[..., 2, 0]) * sx)
    axis = axis_abs * jnp.stack([sx, sy, sz], axis=-1)
    phi_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], phi_pi, phi_generic)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) twist [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(phi * phi, axis=-1)
    a, b, c = _so3_coeffs(theta2)
    W = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * _mm(W, W)
    V = eye + b[..., None, None] * W + c[..., None, None] * _mm(W, W)
    t = jnp.einsum('...ij,...j->...i', V, rho, precision=_HI)
    return make(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) twist [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    a, b, _ = _so3_coeffs(theta2)
    W = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    small = theta2 < 1e-8
    coef = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     (1.0 - a / (2.0 * b)) / jnp.maximum(theta2, _EPS))
    Vinv = eye - 0.5 * W + coef[..., None, None] * _mm(W, W)
    rho = jnp.einsum('...ij,...j->...i', Vinv, t, precision=_HI)
    return jnp.concatenate([rho, phi], axis=-1)


def make(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,))
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Full-precision pose composition A @ B."""
    return _mm(A, B)


def identity(batch: tuple = (), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), batch + (4, 4))


def inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE3 inverse (no linalg.inv)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make(Rt, -jnp.einsum('...ij,...j->...i', Rt, t, precision=_HI))


def transform(T: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to points (..., 3)."""
    return jnp.einsum('...ij,...j->...i', T[..., :3, :3], X,
                      precision=_HI) + T[..., :3, 3]


def normalize(T: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize the rotation block (Gram-Schmidt) to fight f32 drift."""
    R = T[..., :3, :3]
    x = R[..., :, 0]
    x = x / (jnp.linalg.norm(x, axis=-1, keepdims=True) + _EPS)
    y = R[..., :, 1]
    y = y - jnp.sum(x * y, axis=-1, keepdims=True) * x
    y = y / (jnp.linalg.norm(y, axis=-1, keepdims=True) + _EPS)
    z = jnp.cross(x, y)
    Rn = jnp.stack([x, y, z], axis=-1)
    return make(Rn, T[..., :3, 3])
