"""Fused projection matching: Hamming + radius gates + top-2, one kernel.

The XLA formulation of projection matching (`_topk2_xla`) materializes
the (L, K) f32 Hamming matrix and the (L, K) squared pixel distances,
then per search radius of the reference's doubled-radius retry (ref
src/posetracker.cpp:187-190) a masked copy, an argmin, a scatter and a
second min: about eight full passes over L x K per frame.

The Triton kernel reads only the descriptors and coordinates. Each
program owns a block of landmark rows and loops over keypoint tiles,
keeping a running (best, second, argbest) for BOTH radii in registers:
Hamming by XOR + popcount of the 8 packed words, the pixel gates in
registers, nothing of size L x K in device memory.

Values are PACKED as int32 `ham << 16 | column`: one min-reduction
yields best AND argbest with jnp.argmin's first-minimum tie-break, and
the running second-best stays a plain min in packed space. Outputs
match `_topk2_xla` exactly: best and second distance, argbest, and the
BIG sentinel (argbest 0) for rows whose gate is empty.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

BIG = 1e9
_SHIFT = 16                          # packed = ham << 16 | column
_EMPTY = 2 ** 31 - 1                 # packed sentinel: no candidate
_BLOCK_L = 32                        # landmark rows per program
_BLOCK_K = 128                       # keypoint columns per loop step


def _topk2_xla(a_desc, b_desc, a_uv, b_xy, radius: float):
    """Plain reference: dense (L, K) distances, masked argmin + second."""
    from slam_toolkit_tpu.ops import hamming
    dist = hamming.distance_matrix(a_desc, b_desc).astype(jnp.float32)
    d2 = jnp.sum((a_uv[:, None, :] - b_xy[None, :, :]) ** 2, axis=-1)
    rows = jnp.arange(a_desc.shape[0])
    cols = []
    for rsq in (radius * radius, 4.0 * radius * radius):
        md = jnp.where(d2 <= rsq, dist, BIG)
        idx = jnp.argmin(md, axis=1)
        best = md[rows, idx]
        sec = jnp.min(md.at[rows, idx].set(BIG), axis=1)
        cols += [best, sec, idx.astype(jnp.float32)]
    zero = jnp.zeros_like(cols[0])
    return jnp.stack(cols + [zero, zero], axis=1)


def _merge_top2(v, p, q):
    """Fold a (BL, BK) tile of packed values into the running best p and
    second-best q (both (BL,)). Packed values are unique per column, so
    masking the tile minimum removes exactly the argbest column."""
    tmin = jnp.min(v, axis=1)
    tsec = jnp.min(jnp.where(v == tmin[:, None], _EMPTY, v), axis=1)
    q = jnp.minimum(jnp.minimum(q, tsec), jnp.maximum(p, tmin))
    return jnp.minimum(p, tmin), q


def _topk2_kernel(a_ref, auv_ref, b_ref, bxy_ref, out_ref, *, n: int,
                  r1sq: float, r2sq: float):
    from jax.experimental import pallas as pl

    a_words = [a_ref[w, :] for w in range(8)]              # (BL,) int32
    au = auv_ref[0, :]
    av = auv_ref[1, :]
    bl = au.shape[0]
    n_tiles = b_ref.shape[1] // _BLOCK_K

    def tile(t, carry):
        p1, q1, p2, q2 = carry
        off = t * _BLOCK_K
        cols = pl.ds(off, _BLOCK_K)
        ham = jnp.zeros((bl, _BLOCK_K), jnp.int32)
        for w in range(8):
            ham = ham + jax.lax.population_count(
                a_words[w][:, None] ^ b_ref[w, cols][None, :])
        du = au[:, None] - bxy_ref[0, cols][None, :]
        dv = av[:, None] - bxy_ref[1, cols][None, :]
        d2 = du * du + dv * dv
        col = off + jax.lax.broadcasted_iota(jnp.int32, (bl, _BLOCK_K), 1)
        packed = (ham << _SHIFT) | col
        v2 = jnp.where((d2 <= r2sq) & (col < n), packed, _EMPTY)
        p2, q2 = _merge_top2(v2, p2, q2)
        v1 = jnp.where(d2 <= r1sq, v2, _EMPTY)
        p1, q1 = _merge_top2(v1, p1, q1)
        return p1, q1, p2, q2

    empty = jnp.full((bl,), _EMPTY, jnp.int32)
    p1, q1, p2, q2 = jax.lax.fori_loop(0, n_tiles, tile, (empty,) * 4)

    def dist(p):
        return jnp.where(p == _EMPTY, BIG, (p >> _SHIFT).astype(jnp.float32))

    def arg(p):
        return jnp.where(p == _EMPTY, 0, p & ((1 << _SHIFT) - 1)) \
            .astype(jnp.float32)

    zero = jnp.zeros((bl,), jnp.float32)
    for c, v in enumerate((dist(p1), dist(q1), arg(p1),
                           dist(p2), dist(q2), arg(p2), zero, zero)):
        out_ref[c, :] = v


def _pad_cols(x, width):
    return jnp.pad(x, ((0, 0), (0, width - x.shape[1])))


@functools.partial(jax.jit, static_argnames=("radius", "interpret"))
def _topk2_triton(a_desc, b_desc, a_uv, b_xy, radius: float,
                  interpret: bool = False):
    """The fused kernel (Pallas through Triton). Same contract as
    `_topk2_xla`; K must stay below 2**16 for the packed column."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    m, n = a_desc.shape[0], b_desc.shape[0]
    if n >= 1 << _SHIFT:
        raise ValueError(f"topk2 kernel packs columns in {_SHIFT} bits; "
                         f"got {n} keypoints")
    mp = -(-m // _BLOCK_L) * _BLOCK_L
    kp = -(-n // _BLOCK_K) * _BLOCK_K

    def words(d, width):                 # (N, 8) u32 -> (8, width) i32
        return _pad_cols(jax.lax.bitcast_convert_type(d, jnp.int32).T, width)

    kernel = functools.partial(
        _topk2_kernel, n=n, r1sq=float(radius * radius),
        r2sq=float(4.0 * radius * radius))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((8, mp), jnp.float32),
        grid=(mp // _BLOCK_L,),
        in_specs=[pl.BlockSpec((8, _BLOCK_L), lambda i: (0, i)),
                  pl.BlockSpec((2, _BLOCK_L), lambda i: (0, i)),
                  pl.BlockSpec((8, kp), lambda i: (0, 0)),
                  pl.BlockSpec((2, kp), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, _BLOCK_L), lambda i: (0, i)),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="topk2_match",
    )(words(a_desc, mp), _pad_cols(a_uv.T, mp),
      words(b_desc, kp), _pad_cols(b_xy.T, kp))
    return out[:, :m].T


def topk2_match(a_desc: jnp.ndarray, b_desc: jnp.ndarray,
                a_uv: jnp.ndarray, b_xy: jnp.ndarray, radius: float):
    """Top-2 Hamming matches under two pixel-radius gates (r, 2r).

    a_desc (M, 8) u32 / a_uv (M, 2): query landmarks (fold validity in by
    pushing invalid uv out of the image, e.g. +1e9). b_desc (N, 8) u32 /
    b_xy (N, 2): target keypoints, same convention. Returns (M, 8) f32:
    [best_r, second_r, argbest_r, best_2r, second_2r, argbest_2r, 0, 0].

    The fused kernel runs on CUDA devices; every other platform lowers
    the plain reference.
    """
    r = float(radius)
    return jax.lax.platform_dependent(
        a_desc, b_desc, a_uv, b_xy,
        cuda=lambda *a: _topk2_triton(*a, r),
        default=lambda *a: _topk2_xla(*a, r))
