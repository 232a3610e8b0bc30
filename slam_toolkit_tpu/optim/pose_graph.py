"""Pose-graph optimization for loop closing: SE(3) and Sim(3).

Replaces the reference's g2o pose graph (LoopCloser::CloseLoop,
ref src/loopcloser.cpp:104-220): odometry chain edges between
consecutive keyframes with anisotropic information (translation 100,
rotation 100 except a damped vertical-rotation term 0.01,
ref :113-116), loop edges for the new and all remembered closures
(:160-185), oldest keyframe fixed (:158), LM 20 iterations (:187-189).

Edge residual matches the reference's EdgeSE3 (src/optimizer.cpp:271-280):
r = log(T_j . T_i^-1 . C^-1) with measurement C = T_j_meas . T_i_meas^-1.

The Sim(3) variant realizes the reference's own TODO
(src/loopcloser.cpp:107 "SE3 -> Sim3"): identical graph structure with
7-DoF vertices [rho, phi, sigma] and similarity measurements, the
ORB-SLAM-style essential-graph correction that absorbs scale drift.
Both solvers share one masked fixed-shape LM core, parameterized by the
group's (log, inv, exp-update, adjoint) — the only structural
difference between the two.

Fixed shapes: N pose slots, E edge slots, masked. The normal system is
(D*N, D*N) dense — at N <= 512 keyframes that is a small dense solve and
entirely fusable, so no sparse machinery is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.geometry import se3, sim3
from slam_toolkit_tpu.optim import robust

_HI = jax.lax.Precision.HIGHEST  # pose math never runs at bf16 default
#                                  (see geometry/se3.py:20)


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HI)


class PoseGraphProblem(NamedTuple):
    T_cw: jnp.ndarray       # (N, 4, 4) initial poses (SE3, or Sim3 mats)
    pose_valid: jnp.ndarray  # (N,) bool
    pose_fixed: jnp.ndarray  # (N,) bool
    edge_i: jnp.ndarray     # (E,) int32 source pose index
    edge_j: jnp.ndarray     # (E,) int32 target pose index
    edge_T_ji: jnp.ndarray  # (E, 4, 4) measured T_j . T_i^-1
    edge_info: jnp.ndarray  # (E, D) diagonal information [rho, phi(, sigma)]
    edge_valid: jnp.ndarray  # (E,) bool


class _SE3Ops(NamedTuple):
    """Group hooks for the shared LM core."""
    dim: int

    def log(self, T):
        return se3.log(T)

    def inv(self, T):
        return se3.inv(T)

    def update(self, dx, T):
        return se3.normalize(se3.compose(se3.exp(dx), T))

    def adjoint(self, T):
        R = T[..., :3, :3]
        t = T[..., :3, 3]
        E = T.shape[0]
        Ad = jnp.zeros((E, 6, 6))
        Ad = Ad.at[:, :3, :3].set(R)
        Ad = Ad.at[:, :3, 3:].set(jnp.matmul(
            se3.hat(t), R, precision=jax.lax.Precision.HIGHEST))
        Ad = Ad.at[:, 3:, 3:].set(R)
        return Ad


class _Sim3Ops(NamedTuple):
    dim: int

    def log(self, S):
        return sim3.log(S)

    def inv(self, S):
        return sim3.inv(S)

    def update(self, dx, S):
        return sim3.normalize(sim3.compose(sim3.exp(dx), S))

    def adjoint(self, S):
        return sim3.adjoint(S)


def _solve_graph(prob: PoseGraphProblem, ops, iters: int,
                 lambda0: float, lambda_up: float, lambda_down: float,
                 huber_delta: float) -> jnp.ndarray:
    """Masked dense LM over a pose graph on the group `ops` describes.

    For r = log(Tj Ti^-1 C^-1) with left-mult updates Tj <- exp(dj) Tj,
    Ti <- exp(di) Ti, to first order (small residual):
      dr/ddj ~= J_l^-1(r) ~= I   (identity approx, standard for
                                  pose-graph LM; g2o does the same)
      dr/ddi ~= -Ad(Tj Ti^-1)
    """
    N = prob.T_cw.shape[0]
    E = prob.edge_i.shape[0]
    D = ops.dim
    ew = (prob.edge_valid & prob.pose_valid[prob.edge_i] &
          prob.pose_valid[prob.edge_j]).astype(jnp.float32)
    free = ((~prob.pose_fixed) & prob.pose_valid).astype(jnp.float32)
    C_inv = ops.inv(prob.edge_T_ji)

    def residuals(T):
        return ops.log(_mm(_mm(T[prob.edge_j], ops.inv(T[prob.edge_i])),
                           C_inv))

    def cost_at(T):
        r = residuals(T)
        rw = jnp.sqrt(jnp.sum(r * r * prob.edge_info, axis=-1) + 1e-12)
        return jnp.sum(robust.huber_cost(rw, huber_delta) * ew)

    def step(carry, _):
        T, lam, cost = carry
        r = residuals(T)
        rw = jnp.sqrt(jnp.sum(r * r * prob.edge_info, axis=-1) + 1e-12)
        w_rob = robust.huber_weight(rw, huber_delta) * ew
        Jj = jnp.broadcast_to(jnp.eye(D), (E, D, D))
        Ji = -ops.adjoint(_mm(T[prob.edge_j], ops.inv(T[prob.edge_i])))
        info_w = prob.edge_info * w_rob[:, None]               # (E, D)

        # assemble H (N, N, D, D) and b (N, D) by scatter-add over edges
        Hii = jnp.einsum('eai,ea,eaj->eij', Ji, info_w, Ji)
        Hjj = jnp.einsum('eai,ea,eaj->eij', Jj, info_w, Jj)
        Hij = jnp.einsum('eai,ea,eaj->eij', Ji, info_w, Jj)
        bi = -jnp.einsum('eai,ea,ea->ei', Ji, info_w, r)
        bj = -jnp.einsum('eai,ea,ea->ei', Jj, info_w, r)

        H = jnp.zeros((N, N, D, D))
        H = H.at[prob.edge_i, prob.edge_i].add(Hii)
        H = H.at[prob.edge_j, prob.edge_j].add(Hjj)
        H = H.at[prob.edge_i, prob.edge_j].add(Hij)
        H = H.at[prob.edge_j, prob.edge_i].add(
            jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((N, D))
        b = b.at[prob.edge_i].add(bi)
        b = b.at[prob.edge_j].add(bj)

        # damping + gauge/invalid freezing
        diag = jnp.einsum('nnij->nij', H)
        H = H.at[jnp.arange(N), jnp.arange(N)].set(
            diag + lam * diag * jnp.eye(D) + 1e-6 * jnp.eye(D))
        H = H * free[:, None, None, None] * free[None, :, None, None]
        H = H.at[jnp.arange(N), jnp.arange(N)].add(
            (1.0 - free)[:, None, None] * jnp.eye(D))
        b = b * free[:, None]

        Hd = H.transpose(0, 2, 1, 3).reshape(D * N, D * N)
        dx = jnp.linalg.solve(Hd, b.reshape(-1)).reshape(N, D)
        dx = dx * free[:, None]
        T_try = jnp.where((free > 0)[:, None, None], ops.update(dx, T), T)
        cost_try = cost_at(T_try)
        accept = cost_try < cost
        return (jnp.where(accept, T_try, T),
                jnp.where(accept, lam * lambda_down, lam * lambda_up),
                jnp.where(accept, cost_try, cost)), cost

    init = (prob.T_cw, jnp.float32(lambda0), cost_at(prob.T_cw))
    (T_f, _, _), _ = jax.lax.scan(step, init, None, length=iters)
    return T_f


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 20,
                     lambda0: float = 1e-4, lambda_up: float = 10.0,
                     lambda_down: float = 0.1,
                     huber_delta: float = 1e9) -> jnp.ndarray:
    """SE(3) pose graph; edge_info is (E, 6). Returns (N, 4, 4) poses."""
    return _solve_graph(prob, _SE3Ops(dim=6), iters, lambda0, lambda_up,
                        lambda_down, huber_delta)


def solve_pose_graph_sim3(prob: PoseGraphProblem, iters: int = 20,
                          lambda0: float = 1e-4, lambda_up: float = 10.0,
                          lambda_down: float = 0.1,
                          huber_delta: float = 1e9) -> jnp.ndarray:
    """Sim(3) pose graph; T_cw / edge_T_ji are similarity matrices
    [[s*R, t], [0, 1]] and edge_info is (E, 7) [rho, phi, sigma].
    Returns optimized (N, 4, 4) similarities (sim3.to_se3 /
    sim3.scale_of split them back into pose + scale)."""
    return _solve_graph(prob, _Sim3Ops(dim=7), iters, lambda0, lambda_up,
                        lambda_down, huber_delta)
