"""The full ORB extractor: pyramid -> FAST -> select -> orient -> describe.

One jittable function replacing ORBextractor::extract
(ref src/orb_extractor.cpp:1043-1105). Per-level feature budgets follow
the reference's geometric split (:435-446); the two-threshold retry
(:769-829) becomes a response-priority trick (high-threshold corners
outrank low-threshold ones before per-cell selection); octree culling
(:539-763) becomes the per-cell top-k of ops/topk_grid.py.

Output is a fixed-shape FrameFeatures pytree — padded keypoint slots are
flagged invalid, never dropped, so the whole frontend stays shape-static
under jit.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax.numpy as jnp

from slam_toolkit_tpu.config import ExtractorConfig
from slam_toolkit_tpu.ops import brief, fast, pyramid, topk_grid


class FrameFeatures(NamedTuple):
    xy: jnp.ndarray        # (K, 2) float32, level-0 pixel coords
    response: jnp.ndarray  # (K,) float32
    octave: jnp.ndarray    # (K,) int32
    angle: jnp.ndarray     # (K,) float32 radians
    sigma2: jnp.ndarray    # (K,) float32 per-octave measurement variance
    desc: jnp.ndarray      # (K, 8) uint32 packed 256-bit rBRIEF
    valid: jnp.ndarray     # (K,) bool


def level_budgets(cfg: ExtractorConfig) -> List[int]:
    """Geometric per-level feature split (ref src/orb_extractor.cpp:435-446)."""
    q = 1.0 / cfg.scale_factor
    n0 = cfg.num_features * (1.0 - q) / (1.0 - q ** cfg.num_levels)
    budgets = [int(round(n0 * q ** i)) for i in range(cfg.num_levels - 1)]
    budgets.append(max(cfg.num_features - sum(budgets), 0))
    return budgets


def extract(image: jnp.ndarray, cfg: ExtractorConfig) -> FrameFeatures:
    """(H, W) float32 grayscale -> FrameFeatures with cfg.max_keypoints slots."""
    levels = pyramid.build_pyramid(image, cfg)
    budgets = level_budgets(cfg)
    border = cfg.patch_radius + 1

    parts = []
    for lvl, (img_l, n_l) in enumerate(zip(levels, budgets)):
        if n_l == 0:
            continue
        # one-pass dual-threshold FAST: high-threshold corners outrank
        # low-threshold fallbacks via a +1e4 rank boost
        if cfg.dual_threshold:
            eff = fast.detect_dual(img_l, float(cfg.fast_threshold_high),
                                   float(cfg.fast_threshold_low), border)
        else:
            eff = fast.detect(img_l, float(cfg.fast_threshold_low), border)
        # adaptive per-cell depth: rank>=2 picks only matter once the
        # budget exceeds the number of (nonempty) cells, so large levels
        # (thousands of cells, budget in the hundreds) need depth 1 while
        # the smallest levels (tens of cells) need the full 4. Each extra
        # rank costs a masked-argmax pass over the whole level, so this
        # cuts stage-1 selection ~4x on the biggest levels.
        ncells = ((img_l.shape[0] + cfg.cell_size - 1) // cfg.cell_size) * \
                 ((img_l.shape[1] + cfg.cell_size - 1) // cfg.cell_size)
        per_cell = min(4, max(1, -(-4 * n_l // ncells)))
        xy, _, valid = topk_grid.select_keypoints(eff, cfg.cell_size, n_l,
                                                  per_cell=per_cell)
        # report the true (un-boosted) response, not the ranking value
        ix = xy.astype(jnp.int32)
        raw = eff[ix[:, 1], ix[:, 0]]
        resp = jnp.where(valid, jnp.where(raw >= 1e4, raw - 1e4, raw), 0.0)
        blurred = pyramid.gaussian_blur(img_l, 7, cfg.blur_sigma)
        if cfg.descriptor_dtype == "bfloat16":
            # descriptors compare SMOOTHED intensities at distinct
            # offsets; bf16's ~1-LSB rounding at 255 scale only flips
            # pairs that were within noise anyway (bench-validated)
            blurred = blurred.astype(jnp.bfloat16)
        if cfg.steer_rotation:
            angle = brief.ic_angle(img_l, xy)
            desc = brief.compute_descriptors(blurred, xy, angle)
        else:
            # upright: per-keypoint contiguous patch loads + static
            # in-patch picks — avoids both the dense every-pixel BRIEF
            # (~0.5G ops/level) and random element gathers
            angle = jnp.zeros((n_l,), jnp.float32)
            desc = brief.upright_patch_descriptors(blurred, xy)
        scale = cfg.scale_factor ** lvl
        parts.append(FrameFeatures(
            xy=xy * scale,
            response=resp,
            octave=jnp.full((n_l,), lvl, jnp.int32),
            angle=angle,
            sigma2=jnp.full((n_l,), scale * scale, jnp.float32),
            desc=desc,
            valid=valid,
        ))

    feats = FrameFeatures(*[jnp.concatenate(f, axis=0) for f in zip(*parts)])
    total = feats.xy.shape[0]
    pad = cfg.max_keypoints - total
    if pad > 0:
        feats = FrameFeatures(
            xy=jnp.pad(feats.xy, ((0, pad), (0, 0))),
            response=jnp.pad(feats.response, (0, pad)),
            octave=jnp.pad(feats.octave, (0, pad)),
            angle=jnp.pad(feats.angle, (0, pad)),
            sigma2=jnp.pad(feats.sigma2, (0, pad), constant_values=1.0),
            desc=jnp.pad(feats.desc, ((0, pad), (0, 0))),
            valid=jnp.pad(feats.valid, (0, pad)),
        )
    # zero out coordinates of invalid slots (keeps downstream masks honest)
    feats = feats._replace(
        xy=jnp.where(feats.valid[:, None], feats.xy, 0.0),
        response=jnp.where(feats.valid, feats.response, 0.0))
    return feats
