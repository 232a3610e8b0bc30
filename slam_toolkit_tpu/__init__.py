"""slam_toolkit_tpu — a stereo visual-SLAM engine in JAX for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of geonuklee/slam-toolkit
(reference: ORB-SLAM2-family stereo pipeline, C++/g2o/DBoW2) as
fixed-shape accelerator programs:

- All per-frame compute (ORB pyramid extraction, descriptor matching,
  motion-only pose LM, local bundle adjustment) runs inside jitted XLA
  programs over fixed-shape, masked arrays.
- Matching is XOR+popcount Hamming over dense (landmark, keypoint)
  tiles (a fused Triton kernel on CUDA) instead of FLANN kd-trees.
- Bundle adjustment is a masked, batched Schur-complement
  Levenberg-Marquardt solver instead of g2o.
- Loop detection is dense bag-of-words scoring against a device-resident
  hierarchical binary vocabulary instead of a DBoW2 inverted file.
- The reference's two-thread (tracking/mapping) design becomes
  asynchronously dispatched jitted step functions over an immutable
  map pytree.
"""

__version__ = "0.1.0"

from slam_toolkit_tpu.config import SlamConfig  # noqa: F401
