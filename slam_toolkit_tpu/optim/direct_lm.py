"""Direct photometric pose alignment: 8-DoF (SE3 + affine brightness) LM.

Counterpart of the reference's direct method, which exists in
the tree but is not wired into its Pipeline (DirectStereoMethod,
ref src/method.cpp:128-191; BrightenDirectPoseTracker,
src/posetracker.cpp:250-353; photometric edge EdgeProjectBrightenXYZ with
the 8-point residual pattern, src/optimizer.cpp:39-57,109-248;
8-DoF VertexBrightenSE3, :59-73).

State: (T_cw, a, b) — brightness-affine model e^-a (I - b)
(ref BrightenSE3, include/common.h:126-135). Residual per landmark and
pattern offset:
    r = e^-a (I(pi(T Xw) + d_k) - b) - e^-a0 (I0(u0 + d_k) - b0)
with the 8-offset pattern of Pattern::GetPattern (:39-57). Jacobians use
the image gradient chain rule (:177-248), here via bilinear-sampled
central differences. Coarse-to-fine runs over the frame pyramid with
ratio 0.6 (DirectPyramid, :15-37) in the caller.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.geometry import camera as cam_mod
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.geometry.camera import Camera
from slam_toolkit_tpu.optim import robust

# 8-point residual pattern (x, y) offsets around the projection — a
# spread-out star like the reference's Pattern (src/optimizer.cpp:39-57)
PATTERN = ((0.0, 0.0), (-2.0, 0.0), (2.0, 0.0), (0.0, -2.0),
           (0.0, 2.0), (-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0))


class DirectState(NamedTuple):
    T_cw: jnp.ndarray   # (4, 4)
    a: jnp.ndarray      # () brightness gain (log-scale)
    b: jnp.ndarray      # () brightness offset


class DirectResult(NamedTuple):
    state: DirectState
    cost: jnp.ndarray
    res_norm: jnp.ndarray   # (N,) final per-landmark photometric rms


def _pattern_samples(image: jnp.ndarray, uv: jnp.ndarray):
    """All 8 pattern intensities + central-difference gradients from ONE
    8x8 window gather per landmark.

    The previous formulation bilinear-sampled every pattern point and
    every gradient-stencil shift independently — ~160 random image
    gathers per landmark per residual call (whether plain bilinear
    gathers are faster on the GPU is ROADMAP S6). The
    pattern spans +-2 px, bilinear needs +1 and the +-0.5 gradient
    stencil another half-pixel, so every integer pixel any sample
    touches lives in [floor(uv)-3, floor(uv)+4]: gather that 8x8 window
    once (ops/patches.gather_blocks — the same window gather the
    extractor's BRIEF patches use) and resample it into shifted 7x7
    grids (grid(f)[r, c] = bilinear image value at a static integer
    offset plus the per-landmark fraction f). Pattern intensities index
    the (fu, fv) grid statically; the +-0.5 gradient pairs sit exactly
    1 px apart so they SHARE a fractional part (fu+-0.5 mod 1) — one
    extra grid per axis and a per-landmark 2-way select between static
    taps reproduces the old bilinear +-0.5 central differences
    BIT-comparably, with zero dynamic gathers."""
    from slam_toolkit_tpu.ops.patches import gather_blocks
    h, w = image.shape
    u0 = jnp.floor(uv[:, 0])
    v0 = jnp.floor(uv[:, 1])
    xs = jnp.clip(u0.astype(jnp.int32) - 3, 0, max(w - 8, 0))
    ys = jnp.clip(v0.astype(jnp.int32) - 3, 0, max(h - 8, 0))
    win = gather_blocks(image, ys, xs, 8, 8)             # (N, 8, 8)
    fu = (uv[:, 0] - u0)[:, None, None]
    fv = (uv[:, 1] - v0)[:, None, None]

    def grid(fx, fy):
        return ((1.0 - fy) * (1.0 - fx) * win[:, :-1, :-1] +
                (1.0 - fy) * fx * win[:, :-1, 1:] +
                fy * (1.0 - fx) * win[:, 1:, :-1] +
                fy * fx * win[:, 1:, 1:])                # (N, 7, 7)

    B = grid(fu, fv)
    fm_u = jnp.where(fu >= 0.5, fu - 0.5, fu + 0.5)
    fm_v = jnp.where(fv >= 0.5, fv - 0.5, fv + 0.5)
    Gx = grid(fm_u, fv)
    Gy = grid(fu, fm_v)

    import numpy as np
    pat = np.asarray(PATTERN, np.int32)
    rows, cols = 3 + pat[:, 1], 3 + pat[:, 0]            # static, in [1,5]
    ival = B[:, rows, cols]                              # (N, 8)
    # I(p+0.5) - I(p-0.5): positions 1 px apart on the fm grid; which
    # static tap pair depends only on whether the fraction wrapped
    hi_u = fu[:, :, 0] >= 0.5                            # (N, 1)
    hi_v = fv[:, :, 0] >= 0.5
    gx = jnp.where(hi_u,
                   Gx[:, rows, cols + 1] - Gx[:, rows, cols],
                   Gx[:, rows, cols] - Gx[:, rows, cols - 1])
    gy = jnp.where(hi_v,
                   Gy[:, rows + 1, cols] - Gy[:, rows, cols],
                   Gy[:, rows, cols] - Gy[:, rows - 1, cols])
    return ival, gx, gy


def photometric_residuals(state: DirectState, image: jnp.ndarray,
                          cam: Camera, Xw: jnp.ndarray,
                          ref_vals: jnp.ndarray, valid: jnp.ndarray,
                          scale: float):
    """Residuals r (N, 8), Jacobian J (N, 8, 8), validity (N,).

    ref_vals: (N, 8) brightness-corrected reference intensities
    e^-a0 (I0 - b0) sampled at the anchor frame. `scale` maps full-res
    pixels to this pyramid level.
    """
    Xc = se3.transform(state.T_cw, Xw)
    good = (Xc[..., 2] > 0.1) & valid
    uv_full = cam_mod.project(cam, Xc)
    uv = uv_full * scale
    h, w = image.shape
    inb = ((uv[:, 0] > 3) & (uv[:, 0] < w - 4) &
           (uv[:, 1] > 3) & (uv[:, 1] < h - 4))
    good = good & inb

    ival, gx, gy = _pattern_samples(image, uv)       # (N, 8) each

    ea = jnp.exp(-state.a)
    r = ea * (ival - state.b) - ref_vals             # (N, 8)

    # chain rule: dr/d(uv_full) = ea * grad * scale ; duv/dXc ; dXc/dxi
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zs = jnp.where(good, z, 1.0)
    iz = 1.0 / zs
    iz2 = iz * iz
    fx, fy = cam.fx, cam.fy
    # du/dxi rows (pinhole, distortion ignored for the gradient)
    # twist layout [rho, phi], matching pose_lm's left-mult convention
    du = jnp.stack([fx * iz, jnp.zeros_like(x), -fx * x * iz2,
                    -fx * x * y * iz2, fx * (1 + x * x * iz2),
                    -fx * y * iz], axis=-1)          # (N, 6)
    dv = jnp.stack([jnp.zeros_like(x), fy * iz, -fy * y * iz2,
                    -fy * (1 + y * y * iz2), fy * x * y * iz2,
                    fy * x * iz], axis=-1)
    J_geo = (gx[..., None] * du[:, None, :] +
             gy[..., None] * dv[:, None, :]) * (ea * scale)   # (N, 8, 6)
    J_a = (-ea * (ival - state.b))[..., None]                 # (N, 8, 1)
    J_b = jnp.broadcast_to(-ea, r.shape)[..., None]
    J = jnp.concatenate([J_geo, J_a, J_b], axis=-1)           # (N, 8, 8)
    return r, J, good


def optimize_direct(state0: DirectState, image: jnp.ndarray, cam: Camera,
                    Xw: jnp.ndarray, ref_vals: jnp.ndarray,
                    valid: jnp.ndarray, scale: float, iters: int = 10,
                    huber_delta: float = 9.0,
                    prior_ab: float = 1e-2) -> DirectResult:
    """Damped LM over (xi, a, b) at one pyramid level.

    prior_ab: quadratic prior pinning brightness params (the reference's
    EdgeBrightenessPrior, src/optimizer.cpp:75-95).
    """

    def cost_at(st):
        r, _, good = photometric_residuals(st, image, cam, Xw, ref_vals,
                                           valid, scale)
        rn = jnp.linalg.norm(r, axis=-1)
        return jnp.sum(robust.huber_cost(rn, huber_delta) * good) + \
            0.5 * prior_ab * (st.a ** 2 + st.b ** 2)

    def step(carry, _):
        st, lam, cost = carry
        r, J, good = photometric_residuals(st, image, cam, Xw, ref_vals,
                                           valid, scale)
        rn = jnp.linalg.norm(r, axis=-1)
        w = good * robust.huber_weight(rn, huber_delta)
        H = jnp.einsum('npi,n,npj->ij', J, w, J)
        g = -jnp.einsum('npi,n,np->i', J, w, r)
        H = H.at[6, 6].add(prior_ab).at[7, 7].add(prior_ab)
        g = g.at[6].add(-prior_ab * st.a).at[7].add(-prior_ab * st.b)
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(8)
        dx = jnp.linalg.solve(Hd, g)
        st_try = DirectState(
            T_cw=se3.normalize(se3.compose(se3.exp(dx[:6]), st.T_cw)),
            a=st.a + dx[6], b=st.b + dx[7])
        c_try = cost_at(st_try)
        finite = jnp.all(jnp.isfinite(dx))
        accept = (c_try < cost) & finite
        st_new = jax.tree.map(
            lambda a_, b_: jnp.where(accept, a_, b_), st_try, st)
        return (st_new,
                jnp.where(accept, jnp.maximum(lam * 0.1, 1e-7), lam * 10.0),
                jnp.where(accept, c_try, cost)), None

    init = (state0, jnp.float32(1e-4), cost_at(state0))
    (st_f, _, cost_f), _ = jax.lax.scan(step, init, None, length=iters)
    r, _, good = photometric_residuals(st_f, image, cam, Xw, ref_vals,
                                       valid, scale)
    rms = jnp.sqrt(jnp.mean(r * r, axis=-1))
    return DirectResult(state=st_f, cost=cost_f,
                        res_norm=jnp.where(good, rms, jnp.inf))


def reference_values(state: DirectState, image: jnp.ndarray, cam: Camera,
                     Xw: jnp.ndarray, valid: jnp.ndarray,
                     scale: float) -> jnp.ndarray:
    """Brightness-corrected pattern intensities in the anchor frame."""
    Xc = se3.transform(state.T_cw, Xw)
    uv = cam_mod.project(cam, Xc) * scale
    vals, _, _ = _pattern_samples(image, uv)
    return jnp.exp(-state.a) * (vals - state.b)
