"""Spatially-uniform keypoint selection: per-cell top-k + global top-n.

Deterministic, shape-static replacement for the reference's quad-tree
culling (DistributeOctTree, ref src/orb_extractor.cpp:539-763) and its
per-cell high/low-threshold retry (:769-829). The goal is identical —
N keypoints spread uniformly over the image, strongest response first —
but expressed as two top-k reductions that XLA fuses.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _pad_to_multiple(score: jnp.ndarray, cell: int) -> jnp.ndarray:
    h, w = score.shape
    ph = (-h) % cell
    pw = (-w) % cell
    if ph or pw:
        score = jnp.pad(score, ((0, ph), (0, pw)), constant_values=0.0)
    return score


def _topk_rows(cells: jnp.ndarray, k: int):
    """Row-wise top-k by k rounds of (max, first-argmax, mask-by-where).

    Matches lax.top_k output (values descending, ties in index order) but
    avoids its full-sort custom call — for small k the k*6 elementwise
    passes measured several times cheaper than sorting 900-wide
    rows. (An .at[...] scatter variant of this loop was tried and is
    slower: the scatter rewrites the whole array per pass; the `where` on
    a broadcast column-index compare fuses instead.)
    """
    n, s = cells.shape
    col = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :], (n, s))
    cur = cells
    vals, idxs = [], []
    for _ in range(k):
        m = jnp.max(cur, axis=1, keepdims=True)
        first = jnp.min(jnp.where(cur >= m, col, s), axis=1, keepdims=True)
        vals.append(m)
        idxs.append(first)
        cur = jnp.where(col == first, -jnp.inf, cur)
    return (jnp.concatenate(vals, axis=1),
            jnp.concatenate(idxs, axis=1).astype(jnp.int32))


def select_keypoints(score: jnp.ndarray, cell_size: int, num_out: int,
                     per_cell: int = 4) -> Tuple[jnp.ndarray, jnp.ndarray,
                                                 jnp.ndarray]:
    """Pick `num_out` keypoints from a sparse response map.

    Stage 1: within each cell_size x cell_size cell keep the top `per_cell`
    responses (spatial uniformity). Stage 2: among survivors, boost each
    cell's single best response so every non-empty cell lands one keypoint
    before any cell lands its second (the octree guarantee), then take a
    global top-`num_out`.

    Returns (xy [num_out, 2] float32 in pixel coords, response [num_out],
    valid [num_out] bool). Invalid slots have response 0.
    """
    h, w = score.shape
    padded = _pad_to_multiple(score, cell_size)
    ph, pw = padded.shape
    ncy, ncx = ph // cell_size, pw // cell_size
    cells = padded.reshape(ncy, cell_size, ncx, cell_size)
    cells = cells.transpose(0, 2, 1, 3).reshape(ncy * ncx, cell_size * cell_size)

    k = min(per_cell, cell_size * cell_size)
    top_vals, top_idx = _topk_rows(cells, k)             # (ncells, k)

    # rank-0 entries (cell winners) get a large additive boost so the global
    # top-k fills breadth-first across cells, mirroring octree behavior.
    boost = jnp.where(jnp.arange(k)[None, :] == 0,
                      jnp.where(top_vals > 0.0, 1e6, 0.0), 0.0)
    ranked = jnp.where(top_vals > 0.0, top_vals + boost, -1.0)

    flat_vals = ranked.reshape(-1)
    flat_true = top_vals.reshape(-1)
    cell_ids = jnp.repeat(jnp.arange(ncy * ncx), k)
    inner = top_idx.reshape(-1)

    n = min(num_out, flat_vals.shape[0])
    sel_vals, sel = jax.lax.top_k(flat_vals, n)
    sel_cell = cell_ids[sel]
    sel_inner = inner[sel]
    cy, cx = sel_cell // ncx, sel_cell % ncx
    iy, ix = sel_inner // cell_size, sel_inner % cell_size
    ys = cy * cell_size + iy
    xs = cx * cell_size + ix
    valid = sel_vals > 0.0
    xy = jnp.stack([xs, ys], axis=-1).astype(jnp.float32)
    resp = jnp.where(valid, flat_true[sel], 0.0)
    if n < num_out:
        pad = num_out - n
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        resp = jnp.pad(resp, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    return xy, resp, valid
