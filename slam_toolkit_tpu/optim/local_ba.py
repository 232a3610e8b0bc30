"""Local bundle adjustment: masked fixed-shape Schur-complement LM.

Replaces the reference's g2o local-window BA (StandardLocalMapper,
ref src/localmapper.cpp:39-162; solver setup src/method.cpp:23-116) with
a batched solver XLA can fuse:

- W keyframe pose slots x P landmark slots, all padded/masked
- every (pose, point) observation is a 3-row stereo-capable edge
  (u_n, v_n, u_right_n); the third row's weight is zero where no stereo
  measurement exists. This generalizes the reference's design of mono
  measurement edges (src/method.cpp:59-80) plus a single stereo anchor
  edge to the ref frame (src/localmapper.cpp:103-117, method.cpp:43-57):
  scale is pinned wherever stereo exists, not only at the anchor.
- Schur complement over the point blocks: P batched 3x3 inverses, a
  (6W, 6W) reduced camera system solved dense, batched back-substitution
  — the classic sparse-BA structure expressed as einsums on fixed shapes.
- Levenberg-Marquardt with accept/reject damping, `iters` fixed steps
  under lax.scan (reference runs 10, src/pipeline.cpp:137-138).

Fixed poses (oldest-in-window + out-of-window anchors,
ref src/localmapper.cpp:62-75) get identity rows in the reduced system.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.optim import robust

# every contraction of the solve runs in full f32: the GPU's default for
# f32 dots is TF32 (~3 decimal digits), which the whitened ~1e6-scale
# normal equations and the Schur complement cannot absorb
_HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    T_cw: jnp.ndarray        # (W, 4, 4) initial keyframe poses
    pose_fixed: jnp.ndarray  # (W,) bool — fixed gauge / out-of-window
    pose_valid: jnp.ndarray  # (W,) bool — slot in use
    Xw: jnp.ndarray          # (P, 3) initial landmark positions
    point_valid: jnp.ndarray  # (P,) bool
    z: jnp.ndarray           # (W, P, 3) normalized (u, v, u_right)
    inv_sigma: jnp.ndarray   # (W, P) 1/sigma per observation
    obs_mask: jnp.ndarray    # (W, P) bool
    stereo_mask: jnp.ndarray  # (W, P) bool — third residual row active
    baseline: jnp.ndarray    # () stereo baseline (normalized-x units = meters)
    point_free: jnp.ndarray = None  # (P,) bool — optimizable landmarks.
    #                          None = all free. A point anchored OUTSIDE
    #                          the window stays FIXED: its residuals
    #                          still pull the window POSES (constant-
    #                          point edges), but the window cannot drag
    #                          old structure off its out-of-window
    #                          observations (the reference constrains
    #                          such points with fixed out-of-window
    #                          pose edges + the anchor stereo edge,
    #                          ref src/localmapper.cpp:86-117; measured
    #                          here: on a revisit, window-only BA walked
    #                          re-used lap-1 landmarks meters away from
    #                          their own keyframes' poses)


class BAResult(NamedTuple):
    T_cw: jnp.ndarray        # (W, 4, 4) optimized poses
    Xw: jnp.ndarray          # (P, 3) optimized landmarks
    cost: jnp.ndarray        # () final robust cost
    edge_r2: jnp.ndarray     # (W, P) final squared whitened residual norms


def _edge_terms(T_cw, Xw, z, inv_sigma, w_mask, s_mask, baseline, delta,
                trim_sigma: float = 1e9):
    """Residuals, robust weights, and Jacobians for every (pose, point).

    trim_sigma: edges whose whitened norm exceeds it get zero weight —
    the fixed-shape equivalent of g2o demoting outlier edges between
    optimization rounds. Huber alone leaves a linear tail that lets a
    50-sigma wrong match out-pull dozens of inliers.
    """
    R = T_cw[:, :3, :3]                        # (W, 3, 3)
    t = T_cw[:, :3, 3]                         # (W, 3)
    # full f32: reduced precision on the ~100 m coordinates injects
    # multi-sigma noise into every whitened residual (the solver then
    # rejects all its steps). The contraction is only 3-wide.
    Xc = jnp.einsum('wij,pj->wpi', R, Xw, precision=_HI) + t[:, None, :]
    x, y, zc = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    good = zc > 1e-3
    zs = jnp.where(good, zc, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    xb = x - baseline

    pred = jnp.stack([x * iz, y * iz, xb * iz], axis=-1)
    r = (pred - z) * inv_sigma[..., None]                    # (W, P, 3)
    row_w = jnp.stack([w_mask, w_mask, w_mask & s_mask],
                      axis=-1).astype(jnp.float32) * good[..., None]
    # robust weight from the active-row whitened norm, with outlier trim
    rn = jnp.sqrt(jnp.sum(r * r * row_w, axis=-1) + 1e-12)
    keep = (rn <= trim_sigma)[..., None]
    w_rob = robust.huber_weight(rn, delta)[..., None] * row_w * keep

    # dpi/dXc rows: u=(x/z), v=(y/z), ur=((x-b)/z)
    zero = jnp.zeros_like(x)
    dpi = jnp.stack([
        jnp.stack([iz, zero, -x * iz2], axis=-1),
        jnp.stack([zero, iz, -y * iz2], axis=-1),
        jnp.stack([iz, zero, -xb * iz2], axis=-1),
    ], axis=-2)                                              # (W, P, 3, 3)
    dpi = dpi * inv_sigma[..., None, None]

    # pose: dXc/dxi = [I | -hat(Xc)]  (left-mult update)
    hatX = se3.hat(Xc)                                       # (W, P, 3, 3)
    Jp = jnp.concatenate([dpi, -jnp.einsum('wpab,wpbc->wpac', dpi, hatX,
                                           precision=_HI)],
                         axis=-1)                            # (W, P, 3, 6)
    # point: dXc/dXw = R_w
    Jl = jnp.einsum('wpab,wbc->wpac', dpi, R, precision=_HI)  # (W, P, 3, 3)
    return r, w_rob, Jp, Jl, row_w


def _residual_terms(T_cw, Xw, z, inv_sigma, w_mask, s_mask, baseline):
    """Residuals and active-row weights only — no Jacobians.

    The LM accept/reject test only needs the trial cost; computing the
    full _edge_terms there wasted ~40% of each iteration on dpi/Jp/Jl
    tensors that were thrown away."""
    R = T_cw[:, :3, :3]
    t = T_cw[:, :3, 3]
    Xc = jnp.einsum('wij,pj->wpi', R, Xw, precision=_HI) + t[:, None, :]
    x, y, zc = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    good = zc > 1e-3
    zs = jnp.where(good, zc, 1.0)
    iz = 1.0 / zs
    pred = jnp.stack([x * iz, y * iz, (x - baseline) * iz], axis=-1)
    r = (pred - z) * inv_sigma[..., None]
    row_w = jnp.stack([w_mask, w_mask, w_mask & s_mask],
                      axis=-1).astype(jnp.float32) * good[..., None]
    n_behind = jnp.sum(w_mask & ~good)
    return r, row_w, n_behind


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form batched 3x3 inverse (adjugate/determinant).

    The cofactor form is ~30 elementwise ops instead of jnp.linalg.inv's
    vmapped LU.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    m00 = e * i - f * h
    m01 = c * h - b * i
    m02 = b * f - c * e
    m10 = f * g - d * i
    m11 = a * i - c * g
    m12 = c * d - a * f
    m20 = d * h - e * g
    m21 = b * g - a * h
    m22 = a * e - b * d
    det = a * m00 + b * m10 + c * m20
    det = jnp.where(jnp.abs(det) < 1e-12,
                    jnp.where(det < 0, -1e-12, 1e-12), det)
    inv = jnp.stack([
        jnp.stack([m00, m01, m02], axis=-1),
        jnp.stack([m10, m11, m12], axis=-1),
        jnp.stack([m20, m21, m22], axis=-1),
    ], axis=-2)
    return inv / det[..., None, None]


def _cost(r, row_w, delta, trim_sigma: float = 1e9):
    rn = jnp.sqrt(jnp.sum(r * r * row_w, axis=-1) + 1e-12)
    active = jnp.any(row_w > 0, axis=-1)
    # trimmed edges contribute a constant (their cost at the trim point),
    # so removing an edge never *rewards* the objective
    c = jnp.where(rn <= trim_sigma, robust.huber_cost(rn, delta),
                  robust.huber_cost(jnp.full_like(rn, trim_sigma), delta))
    return jnp.sum(c * active)


def solve_ba(p: BAProblem, iters: int = 10, huber_delta: float = 2.4477468,
             lambda0: float = 1e-4, lambda_up: float = 10.0,
             lambda_down: float = 0.1, trim_sigma: float = 1e9) -> BAResult:
    W = p.T_cw.shape[0]
    P = p.Xw.shape[0]
    w_mask = p.obs_mask & p.pose_valid[:, None] & p.point_valid[None, :]
    free_pose = (~p.pose_fixed) & p.pose_valid
    free_pt = p.point_valid if p.point_free is None \
        else (p.point_valid & p.point_free)

    # an edge whose point lands BEHIND its camera must cost more than
    # any plausible reprojection error, not drop out: comparing costs
    # over different active sets lets a large finite step that throws
    # all points behind all cameras collapse the cost to 0 and be
    # accepted (the finite-update guard does not catch it)
    behind_cost = robust.huber_cost(jnp.float32(1e3), huber_delta)

    def cost_at(T, X):
        r, row_w, n_behind = _residual_terms(T, X, p.z, p.inv_sigma,
                                             w_mask, p.stereo_mask,
                                             p.baseline)
        return _cost(r, row_w, huber_delta, trim_sigma) + \
            behind_cost * n_behind

    def step(carry, _):
        T, X, lam, cost = carry
        r, w_rob, Jp, Jl, _ = _edge_terms(T, X, p.z, p.inv_sigma, w_mask,
                                          p.stereo_mask, p.baseline,
                                          huber_delta, trim_sigma)
        # block accumulations. Pose blocks see every edge; point blocks
        # (and the Schur coupling) only the FREE points' — a fixed point
        # contributes exactly a constant-point pose edge.
        w_rob_l = w_rob * free_pt[None, :, None].astype(jnp.float32)
        Hpp = jnp.einsum('wpra,wpr,wprb->wab', Jp, w_rob, Jp,
                         precision=_HI)                         # (W, 6, 6)
        Hll = jnp.einsum('wpra,wpr,wprb->pab', Jl, w_rob_l, Jl,
                         precision=_HI)                         # (P, 3, 3)
        Hpl = jnp.einsum('wpra,wpr,wprb->wpab', Jp, w_rob_l, Jl,
                         precision=_HI)                         # (W,P,6,3)
        bp = -jnp.einsum('wpra,wpr,wpr->wa', Jp, w_rob, r,
                         precision=_HI)                         # (W, 6)
        bl = -jnp.einsum('wpra,wpr,wpr->pa', Jl, w_rob_l, r,
                         precision=_HI)                         # (P, 3)

        # damping; absolute floors keep Hll_inv bounded in f32 — without
        # them a weakly-constrained point block inverts to ~1e16 and the
        # Schur einsum overflows to inf - inf = NaN
        eyew = jnp.eye(6)
        eyep = jnp.eye(3)
        Hpp_d = Hpp + lam * Hpp * eyew + 1e-6 * eyew
        Hll_d = Hll + lam * Hll * eyep + 1e-4 * eyep
        # guard empty/invalid points with identity blocks
        pt_active = free_pt & (jnp.sum(w_mask, axis=0) > 0)
        Hll_d = jnp.where(pt_active[:, None, None], Hll_d, eyep)
        bl = jnp.where(pt_active[:, None], bl, 0.0)
        Hll_inv = _inv3x3(Hll_d)                                # (P, 3, 3)

        # Schur complement S = Hpp - Hpl Hll^-1 Hlp, rhs = bp - Hpl Hll^-1 bl
        HplHinv = jnp.einsum('wpab,pbc->wpac', Hpl, Hll_inv,
                             precision=_HI)                     # (W, P, 6, 3)
        S_off = jnp.einsum('ipac,jpbc->ijab', HplHinv, Hpl,
                           precision=_HI)                       # (W, W, 6, 6)
        S = -S_off
        S = S.at[jnp.arange(W), jnp.arange(W)].add(Hpp_d)
        rhs = bp - jnp.einsum('wpab,pb->wa', HplHinv, bl,
                              precision=_HI)                    # (W, 6)

        # freeze fixed/invalid poses: identity rows/cols, zero rhs
        fp = free_pose.astype(jnp.float32)
        S = S * fp[:, None, None, None] * fp[None, :, None, None]
        S = S.at[jnp.arange(W), jnp.arange(W)].add(
            (1.0 - fp)[:, None, None] * eyew)
        rhs = rhs * fp[:, None]

        Sd = S.transpose(0, 2, 1, 3).reshape(6 * W, 6 * W)
        dp = jnp.linalg.solve(Sd, rhs.reshape(6 * W)).reshape(W, 6)
        dp = dp * fp[:, None]

        # back-substitute points: dl = Hll^-1 (bl - Hlp^T dp)
        Hlp_dp = jnp.einsum('wpab,wa->pb', Hpl, dp, precision=_HI)  # (P, 3)
        dl = jnp.einsum('pab,pb->pa', Hll_inv, bl - Hlp_dp, precision=_HI)
        dl = jnp.where(pt_active[:, None], dl, 0.0)

        T_try = jnp.where(free_pose[:, None, None],
                          se3.normalize(se3.compose(se3.exp(dp), T)), T)
        X_try = p.point_valid[:, None] * (X + dl) + \
            (~p.point_valid)[:, None] * X
        cost_try = cost_at(T_try, X_try)
        # a NaN step can masquerade as zero cost (all rows go inactive);
        # require the update itself to be finite before accepting
        finite = jnp.all(jnp.isfinite(dp)) & jnp.all(jnp.isfinite(dl))
        accept = (cost_try < cost) & finite
        T_new = jnp.where(accept, T_try, T)
        X_new = jnp.where(accept, X_try, X)
        lam_new = jnp.where(accept,
                            jnp.maximum(lam * lambda_down, 1e-7),
                            lam * lambda_up)
        cost_new = jnp.where(accept, cost_try, cost)
        return (T_new, X_new, lam_new, cost_new), cost_new

    init = (p.T_cw, p.Xw, jnp.float32(lambda0), cost_at(p.T_cw, p.Xw))
    (T_f, X_f, _, cost_f), _ = jax.lax.scan(step, init, None, length=iters)
    r, row_w, _ = _residual_terms(T_f, X_f, p.z, p.inv_sigma, w_mask,
                               p.stereo_mask, p.baseline)
    r2 = jnp.sum(r * r * row_w, axis=-1)
    return BAResult(T_cw=T_f, Xw=X_f, cost=cost_f, edge_r2=r2)
