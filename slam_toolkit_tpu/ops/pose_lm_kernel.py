"""Whole-solver Triton kernel for motion-only pose LM.

optim/pose_lm.py expresses one LM solve as a `num_iterations`-step
lax.scan of small fusions plus a 6x6 solve per step: at N = 3072
observations each piece carries a few microseconds of work, so on a GPU
the solve is bound by kernel launches, not by arithmetic. This kernel
runs the ENTIRE loop in one program: the observations stay in registers
as coordinate rows, the 21 Hessian terms and 6 gradient terms are block
reductions, the 6x6 system is solved by unrolled Gauss-Jordan on
scalars, and the SE3 exponential and re-orthonormalization run on
scalars too. One launch instead of ~200.

Same residuals, Huber IRLS weights, behind-camera penalty,
accept/reject damping and final inlier r2 as optim.pose_lm.optimize_pose
(the plain reference), up to f32 summation order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import TrackerConfig
from slam_toolkit_tpu.optim import pose_lm
from slam_toolkit_tpu.optim.pose_lm import PoseLMResult

_PAIRS = [(a, b) for a in range(6) for b in range(a, 6)]


def _solve6(H, b):
    """Gauss-Jordan on the damped SPD 6x6 system of scalars.

    Jacobi-scaled first: whitened-reprojection normal equations mix
    ~1e6..1e9 magnitudes across translation/rotation blocks, and
    pivot-free f32 elimination on the raw system loses ~20% of a
    rotation component. With a unit diagonal the no-pivot elimination
    is accurate to ~1e-6."""
    d = [jax.lax.rsqrt(jnp.maximum(H[i][i], 1e-30)) for i in range(6)]
    M = [[H[i][j] * d[i] * d[j] for j in range(6)] + [b[i] * d[i]]
         for i in range(6)]
    for k in range(6):
        inv = 1.0 / M[k][k]
        row = [v * inv for v in M[k]]
        M = [row if i == k else [M[i][j] - M[i][k] * row[j]
                                 for j in range(7)]
             for i in range(6)]
    return [M[i][6] * d[i] for i in range(6)]


def _exp_se3(xi):
    """Twist [rho(3), phi(3)] of scalars -> 3x4 rows (geometry/se3.exp)."""
    rho, (px, py, pz) = xi[:3], xi[3:]
    th2 = px * px + py * py + pz * pz
    th = jnp.sqrt(jnp.maximum(th2, 1e-16))
    small = th2 < 1e-8
    t2s = jnp.where(small, 1.0, th2)
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / t2s)
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - a) / t2s)
    W = [[0.0, -pz, py], [pz, 0.0, -px], [-py, px, 0.0]]
    WW = [[sum(W[i][k] * W[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    R = [[eye[i][j] + a * W[i][j] + b * WW[i][j] for j in range(3)]
         for i in range(3)]
    V = [[eye[i][j] + b * W[i][j] + c * WW[i][j] for j in range(3)]
         for i in range(3)]
    t = [sum(V[i][k] * rho[k] for k in range(3)) for i in range(3)]
    return [R[i] + [t[i]] for i in range(3)]


def _compose(A, B):
    """3x4 rows A, B (implicit [0 0 0 1] last rows) -> A @ B."""
    return [[sum(A[i][k] * B[k][j] for k in range(3))
             + (A[i][3] if j == 3 else 0.0) for j in range(4)]
            for i in range(3)]


def _normalize(T):
    """Gram-Schmidt on the rotation columns (geometry/se3.normalize)."""
    x = [T[i][0] for i in range(3)]
    nx = jnp.sqrt(sum(v * v for v in x)) + 1e-8
    x = [v / nx for v in x]
    y = [T[i][1] for i in range(3)]
    xy = sum(x[i] * y[i] for i in range(3))
    y = [y[i] - xy * x[i] for i in range(3)]
    ny = jnp.sqrt(sum(v * v for v in y)) + 1e-8
    y = [v / ny for v in y]
    z = [x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
         x[0] * y[1] - x[1] * y[0]]
    return [[x[i], y[i], z[i], T[i][3]] for i in range(3)]


def _pose_lm_kernel(T_ref, X_ref, Z_ref, isg_ref, wv_ref, oT_ref, or2_ref,
                    *, cfg: TrackerConfig):
    delta = float(cfg.huber_delta)
    X0, X1, X2 = X_ref[0, :], X_ref[1, :], X_ref[2, :]
    Z0, Z1 = Z_ref[0, :], Z_ref[1, :]
    isg = isg_ref[:]
    wv = wv_ref[:]
    # the 16-entry pose rides in as a vector; a masked sum extracts each
    # scalar (vector loads only — no per-element pointer loads)
    tv = T_ref[:]
    lane = jax.lax.broadcasted_iota(jnp.int32, tv.shape, 0)
    T0 = [[jnp.sum(jnp.where(lane == 4 * i + j, tv, 0.0)) for j in range(4)]
          for i in range(3)]

    def residuals(T):
        xc = T[0][0] * X0 + T[0][1] * X1 + T[0][2] * X2 + T[0][3]
        yc = T[1][0] * X0 + T[1][1] * X1 + T[1][2] * X2 + T[1][3]
        zc = T[2][0] * X0 + T[2][1] * X1 + T[2][2] * X2 + T[2][3]
        good = zc > 1e-3
        zs = jnp.where(good, zc, 1.0)
        ru = (xc / zs - Z0) * isg
        rv = (yc / zs - Z1) * isg
        return xc, yc, zs, good.astype(jnp.float32), ru, rv

    # a point pushed behind the camera costs a large constant instead of
    # dropping out (same guard as optim/pose_lm.py cost_at)
    behind = delta * (1e3 - 0.5 * delta)

    def cost_of(T):
        _, _, _, good, ru, rv = residuals(T)
        rn = jnp.sqrt(ru * ru + rv * rv)
        rho = jnp.where(rn <= delta, 0.5 * rn * rn, delta * (rn - 0.5 * delta))
        return jnp.sum(rho * wv * good) + behind * jnp.sum(wv * (1.0 - good))

    def step(_, carry):
        T = [list(carry[4 * i:4 * i + 4]) for i in range(3)]
        lam, cost = carry[12], carry[13]
        xc, yc, zs, good, ru, rv = residuals(T)
        rn = jnp.sqrt(ru * ru + rv * rv)
        w = wv * good * jnp.minimum(1.0, delta / jnp.maximum(rn, 1e-12))
        iz = 1.0 / zs
        iz2 = iz * iz
        # Jacobian rows (pose_lm._jacobian), whitened; None marks the
        # structural zeros so their products are never formed
        ju = [iz * isg, None, -xc * iz2 * isg, -xc * yc * iz2 * isg,
              (1.0 + xc * xc * iz2) * isg, -yc * iz * isg]
        jv = [None, iz * isg, -yc * iz2 * isg, -(1.0 + yc * yc * iz2) * isg,
              xc * yc * iz2 * isg, xc * iz * isg]

        def dot(p, q):
            return None if p is None or q is None else p * q

        def wsum(*terms):
            terms = [t for t in terms if t is not None]
            return jnp.sum(w * sum(terms[1:], terms[0])) if terms else 0.0

        H = [[None] * 6 for _ in range(6)]
        for a, b in _PAIRS:
            H[a][b] = H[b][a] = wsum(dot(ju[a], ju[b]), dot(jv[a], jv[b]))
        g = [-wsum(dot(ju[a], ru), dot(jv[a], rv)) for a in range(6)]
        Hd = [[H[i][j] * (1.0 + lam) + 1e-9 if i == j else H[i][j]
               for j in range(6)] for i in range(6)]
        xi = _solve6(Hd, g)
        T_try = _normalize(_compose(_exp_se3(xi), T))
        cost_try = cost_of(T_try)
        accept = cost_try < cost
        T_new = [jnp.where(accept, T_try[i][j], T[i][j])
                 for i in range(3) for j in range(4)]
        lam_new = jnp.where(accept, lam * float(cfg.lm_lambda_down),
                            lam * float(cfg.lm_lambda_up))
        return (*T_new, lam_new, jnp.where(accept, cost_try, cost))

    init = tuple(T0[i][j] for i in range(3) for j in range(4)) + (
        jnp.float32(cfg.lm_lambda0), cost_of(T0))
    out = jax.lax.fori_loop(0, int(cfg.num_iterations), step, init)
    T_f = [list(out[4 * i:4 * i + 4]) for i in range(3)]

    _, _, _, good, ru, rv = residuals(T_f)
    or2_ref[:] = jnp.where(wv * good > 0, ru * ru + rv * rv, jnp.inf)
    # [T rows 0..2, last row 0 0 0 1, cost, zero padding] in one store
    vals = [T_f[i][j] for i in range(3) for j in range(4)] + \
        [0.0, 0.0, 0.0, 1.0, out[13]]
    lane = jax.lax.broadcasted_iota(jnp.int32, oT_ref.shape, 0)
    acc = jnp.zeros(oT_ref.shape, jnp.float32)
    for k, v in enumerate(vals):
        acc = jnp.where(lane == k, v, acc)
    oT_ref[:] = acc


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def optimize_pose_triton(T_init: jnp.ndarray, Xw: jnp.ndarray,
                         z_norm: jnp.ndarray, sigma2: jnp.ndarray,
                         weight_mask: jnp.ndarray, cfg: TrackerConfig,
                         interpret: bool = False) -> PoseLMResult:
    """The fused solve (Pallas through Triton), one program. N is padded
    to a power of two with zero-weight rows."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = Xw.shape[0]
    n_pad = pl.next_power_of_2(n)

    def rows(x):                           # (N, c) -> (c, n_pad)
        return jnp.pad(x.T.astype(jnp.float32), ((0, 0), (0, n_pad - n)))

    isg = jax.lax.rsqrt(jnp.maximum(sigma2, 1e-12))
    out, r2 = pl.pallas_call(
        functools.partial(_pose_lm_kernel, cfg=cfg),
        out_shape=(jax.ShapeDtypeStruct((32,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32)),
        compiler_params=plgpu.CompilerParams(num_warps=16, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="pose_lm",
    )(T_init.reshape(16).astype(jnp.float32), rows(Xw), rows(z_norm),
      rows(isg[:, None])[0], rows(weight_mask[:, None])[0])
    return PoseLMResult(T_cw=out[:16].reshape(4, 4), cost=out[16],
                        inlier_r2=r2[:n])


def optimize_pose(T_init: jnp.ndarray, Xw: jnp.ndarray, z_norm: jnp.ndarray,
                  sigma2: jnp.ndarray, weight_mask: jnp.ndarray,
                  cfg: TrackerConfig) -> PoseLMResult:
    """optim.pose_lm.optimize_pose through the fused kernel on CUDA
    devices; every other platform lowers the plain reference."""
    return jax.lax.platform_dependent(
        T_init, Xw, z_norm, sigma2, weight_mask,
        cuda=lambda *a: optimize_pose_triton(*a, cfg),
        default=lambda *a: pose_lm.optimize_pose(*a, cfg))
