"""Image pyramid + Gaussian blur as XLA convolutions.

Replaces ORBextractor::ComputePyramid (ref src/orb_extractor.cpp:1107-1132):
8 levels at scale factor 1.2, each level bilinearly downsampled from level 0.
Levels keep static shapes derived from the config, so the whole pyramid is
one traced program. The 19px reflected border of the reference is handled
by masking detections near edges instead of physically padding.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import ExtractorConfig


def level_shapes(height: int, width: int,
                 cfg: ExtractorConfig) -> List[Tuple[int, int]]:
    """Static (h, w) per pyramid level.

    matmul mode matches cvRound semantics (round(dim / 1.2**i)); poly
    mode follows the exact 6:5 cascade (each level padded up to a
    multiple of 6, then shrunk by exactly 5/6 — within 6 px of cvRound).
    """
    if _use_poly(cfg):
        shapes = [(height, width)]
        for _ in range(cfg.num_levels - 1):
            h, w = shapes[-1]
            shapes.append((5 * (-(-h // 6)), 5 * (-(-w // 6))))
        return shapes
    shapes = []
    for s in cfg.scales:
        shapes.append((int(round(height / s)), int(round(width / s))))
    return shapes


def _use_poly(cfg: ExtractorConfig) -> bool:
    return (cfg.pyramid_mode == "poly"
            and abs(cfg.scale_factor - 1.2) < 1e-9)


_RESIZE_CACHE = {}


def _resize_matrix(n_in: int, n_out: int):
    """Bilinear interpolation matrix (n_out, n_in), host-cached numpy
    (pixel-center sampling, like cv::resize INTER_LINEAR)."""
    import numpy as np
    key = (n_in, n_out)
    if key not in _RESIZE_CACHE:
        x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0.0, n_in - 1.0)
        x0 = np.floor(x).astype(np.int64)
        x1 = np.minimum(x0 + 1, n_in - 1)
        f = x - x0
        M = np.zeros((n_out, n_in), np.float32)
        M[np.arange(n_out), x0] += (1.0 - f)
        M[np.arange(n_out), x1] += f
        _RESIZE_CACHE[key] = M
    return _RESIZE_CACHE[key]


def resize_bilinear(image: jnp.ndarray, out_hw: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize of a 2D image to a static target shape.

    Expressed as two banded interpolation MATMULS (out = Ry @ img @ Cx^T)
    instead of column gathers (ROADMAP S9 A/Bs the two on the GPU).
    """
    h, w = image.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return image
    Ry = jnp.asarray(_resize_matrix(h, oh), image.dtype)
    Cx = jnp.asarray(_resize_matrix(w, ow), image.dtype)
    # HIGH matches f32 to ~1e-3 on 0..255 intensities — far below the
    # FAST thresholds (7/20) and BRIEF comparison noise; single-pass
    # bf16 (DEFAULT) is NOT enough (its ~0.4% error shifts FAST corners
    # and flips bits). What HIGH lowers to on the GPU is ROADMAP S10.
    hp = jax.lax.Precision.HIGH
    return jnp.matmul(jnp.matmul(Ry, image, precision=hp), Cx.T,
                      precision=hp)


# 6:5 polyphase taps. Pixel-center sampling at ratio exactly 1.2 gives
# source x = 1.2*o + 0.1 for output o; within a group of 5 outputs /
# 6 inputs the integer part is o mod 5 and the fraction cycles through
# 0.1, 0.3, 0.5, 0.7, 0.9 — and x0+1 never crosses the 6-row group, so
# the whole resize is five static-stride weighted adds.
_POLY_W0 = (0.9, 0.7, 0.5, 0.3, 0.1)


def _pad_to_6(img: jnp.ndarray, axis: int) -> jnp.ndarray:
    n = img.shape[axis]
    pad = (-n) % 6
    if pad == 0:
        return img
    cfgpad = [(0, 0), (0, 0)]
    cfgpad[axis] = (0, pad)
    return jnp.pad(img, cfgpad, mode='edge')


def poly_down_rows(img: jnp.ndarray) -> jnp.ndarray:
    """(h, w) -> (5*ceil(h/6), w) exact-1.2 bilinear downsample of rows."""
    img = _pad_to_6(img, 0)
    m, w = img.shape[0] // 6, img.shape[1]
    g = img.reshape(m, 6, w)
    outs = [w0 * g[:, p, :] + (1.0 - w0) * g[:, p + 1, :]
            for p, w0 in enumerate(_POLY_W0)]
    return jnp.stack(outs, axis=1).reshape(5 * m, w)


def poly_down_cols(img: jnp.ndarray) -> jnp.ndarray:
    """(h, w) -> (h, 5*ceil(w/6)) exact-1.2 bilinear downsample of cols."""
    img = _pad_to_6(img, 1)
    h, m = img.shape[0], img.shape[1] // 6
    g = img.reshape(h, m, 6)
    outs = [w0 * g[:, :, p] + (1.0 - w0) * g[:, :, p + 1]
            for p, w0 in enumerate(_POLY_W0)]
    return jnp.stack(outs, axis=2).reshape(h, 5 * m)


def build_pyramid(image: jnp.ndarray, cfg: ExtractorConfig) -> List[jnp.ndarray]:
    """Level-0 image (H, W) float32 -> list of per-level images.

    Cascaded: each level resamples the PREVIOUS level, exactly like the
    reference's ComputePyramid (ref src/orb_extractor.cpp:1107-1132,
    cv::resize level-to-level) — and ~2x cheaper than resizing every
    level from level 0, since source sizes shrink geometrically.

    poly mode replaces the banded interpolation matmuls with the exact
    6:5 polyphase shift-add (see _POLY_W0): bandwidth-bound elementwise
    work in full f32 instead of reduced-precision matmuls."""
    h, w = image.shape
    out = [image]
    if _use_poly(cfg):
        for _ in range(cfg.num_levels - 1):
            out.append(poly_down_cols(poly_down_rows(out[-1])))
        return out
    for hw in level_shapes(h, w, cfg)[1:]:
        out.append(resize_bilinear(out[-1], hw))
    return out


@functools.lru_cache(maxsize=8)
def _gaussian_kernel1d(size: int, sigma: float) -> tuple:
    import math
    half = size // 2
    vals = [math.exp(-(i - half) ** 2 / (2.0 * sigma * sigma))
            for i in range(size)]
    s = sum(vals)
    return tuple(v / s for v in vals)


def gaussian_blur(image: jnp.ndarray, size: int = 7,
                  sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect-101 padding.

    Matches the pre-BRIEF GaussianBlur(7x7, sigma=2, BORDER_REFLECT_101)
    at ref src/orb_extractor.cpp:1086. Implemented as weighted shifted
    adds (one elementwise stream at memory bandwidth), not lax.conv.
    """
    k = _gaussian_kernel1d(size, sigma)
    half = size // 2
    padded = jnp.pad(image, ((half, half), (half, half)), mode='reflect')
    h, w = image.shape
    rows = None
    for i in range(size):
        term = k[i] * padded[i:i + h, :]
        rows = term if rows is None else rows + term
    out = None
    for i in range(size):
        term = k[i] * rows[:, i:i + w]
        out = term if out is None else out + term
    return out
