"""Multi-sequence SLAM over a device mesh.

The reference is strictly single-process/single-sequence (SURVEY.md
§2.4); the scale axis here is data parallelism over independent
sequences ("vmap N KITTI sequences across a device mesh"). Every
per-sequence program in this engine is pure and shape-static, so
batching is literally vmap + sharding annotations: each device tracks
its own sequences, no collectives on the hot path (embarrassingly
parallel). The mesh is one flat `seq` axis: every card reaches every
other at the same rate, so no other shape would help.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.frontend.frame import build_frame
from slam_toolkit_tpu.frontend.tracker import track_pose
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.mapping.ba_adapter import local_ba_step
from slam_toolkit_tpu.mapping.map_state import (MapState, camera_frustum,
                                                empty_map,
                                                gather_local_landmarks)


def make_mesh(n_devices: int) -> Mesh:
    import numpy as np
    devs = np.asarray(jax.devices()[:n_devices], dtype=object)
    return Mesh(devs.reshape(n_devices), ("seq",))


def batched_empty_map(cfg: SlamConfig, batch: int) -> MapState:
    one = empty_map(cfg)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (batch,) + x.shape),
                        one)


def batched_track_step(cfg: SlamConfig, cam: StereoCamera):
    """Returns f(maps, images, T_preds) -> (T_cw, n_inliers), vmapped over
    the sequence axis. jit/pjit-ready."""

    def one(m: MapState, image: jnp.ndarray, T_pred: jnp.ndarray):
        frame = build_frame(image, cam, cfg)
        Xw, desc, ids, valid = gather_local_landmarks(
            m, cfg.map.track_landmarks, cfg.map.track_recent_kfs,
            cfg.map.track_covis_kfs, cfg.map.track_covis_min,
            camera_frustum(cfg.camera))
        res = track_pose(frame, Xw, desc, valid, T_pred, cam, cfg)
        return res.T_cw, res.n_inliers

    return jax.vmap(one)


def batched_map_step(cfg: SlamConfig, cam: StereoCamera):
    """Returns f(maps) -> maps running local BA per sequence."""

    def one(m: MapState) -> MapState:
        return local_ba_step(m, cam, cfg)

    return jax.vmap(one)


def shard_batch(mesh: Mesh, tree):
    """Place a batched pytree with the leading axis sharded over `seq`."""
    sharding = NamedSharding(mesh, P("seq"))

    def put(x):
        return jax.device_put(x, NamedSharding(
            mesh, P(*( ("seq",) + (None,) * (x.ndim - 1) ))))

    return jax.tree.map(put, tree)


def multi_sequence_step(cfg: SlamConfig, cam: StereoCamera, mesh: Mesh):
    """One jitted DP step: track every sequence, then local-BA every map.

    Shardings: all operands batch-sharded over `seq`; XLA partitions the
    whole program with zero cross-device communication.
    """
    track = batched_track_step(cfg, cam)
    ba = batched_map_step(cfg, cam)

    @jax.jit
    def step(maps: MapState, images: jnp.ndarray, T_preds: jnp.ndarray):
        T_new, n_inl = track(maps, images, T_preds)
        maps2 = ba(maps)
        return maps2, T_new, n_inl

    return step


def batched_bootstrap(cfg: SlamConfig, cam: StereoCamera):
    """f(maps, lefts, rights) -> batched ChunkCarry: insert frame 0 of
    every sequence as its first keyframe (the host bootstrap of
    pipeline/engine.py process(), batched)."""
    from slam_toolkit_tpu.frontend.frame import add_stereo
    from slam_toolkit_tpu.pipeline.scan_engine import ChunkCarry

    def one(m: MapState, left, right):
        from slam_toolkit_tpu.mapping.map_state import insert_keyframe
        frame = build_frame(left, cam, cfg)
        frame = add_stereo(frame, left, right, cam, cfg)
        L = cfg.map.track_landmarks
        # full bootstrap quality — unmeasured, not bad (see
        # pipeline/engine._make_keyframe)
        m2, slot = insert_keyframe(
            m, frame, jnp.eye(4), jnp.int32(0),
            jnp.zeros((L,), jnp.int32), jnp.zeros((L,), jnp.int32),
            jnp.zeros((L,), bool), cfg,
            quality=jnp.float32(2 * cfg.tracker.min_matches))
        lm = gather_local_landmarks(m2, L, cfg.map.track_recent_kfs,
                                    cfg.map.track_covis_kfs,
                                    cfg.map.track_covis_min,
                                    camera_frustum(cfg.camera))
        return ChunkCarry(
            m=m2, T_cw=jnp.eye(4), velocity=jnp.eye(4),
            lm_Xw=lm[0], lm_desc=lm[1], lm_ids=lm[2], lm_valid=lm[3],
            latest_slot=slot.astype(jnp.int32), latest_T=m2.kf_T_cw[slot],
            frame_id=jnp.int32(1), inlier_peak=jnp.float32(0.0))

    return jax.vmap(one)


def multi_sequence_engine(cfg: SlamConfig, cam: StereoCamera, mesh: Mesh):
    """The FULL engine step batched over sequences: tracking, keyframe
    decision, stereo landmark supply, keyframe insertion, weak-mappoint
    culling, and local BA — the complete scan-engine frame body
    (pipeline/scan_engine.make_frame_body) vmapped over the `seq` axis,
    so per-sequence maps GROW independently.

    Returns (bootstrap, step):
      bootstrap(maps, lefts, rights) -> carry          (frame 0 per seq)
      step(carry, lefts, rights) -> (carry, packed (B, 36))

    Under vmap the keyframe lax.cond lowers to masked execution of both
    branches; a sequence that doesn't need a keyframe keeps its map
    bit-identical via the select. Shard the batched carry/images over
    `seq` (shard_batch) and XLA partitions the whole program with zero
    cross-device communication.
    """
    vbody = _vmapped_frame_body(cfg, cam)

    @jax.jit
    def step(carry, lefts, rights):
        return vbody(carry, lefts, rights)

    return jax.jit(batched_bootstrap(cfg, cam)), step


def _vmapped_frame_body(cfg: SlamConfig, cam: StereoCamera):
    """The full per-frame engine body (scan_engine.make_frame_body)
    vmapped over the sequence axis — shared by the per-frame and
    chunked DP steps so the two paths cannot diverge."""
    from slam_toolkit_tpu.pipeline.scan_engine import make_frame_body

    body = make_frame_body(cfg, cam)

    def one(carry, left, right):
        frame = build_frame(left, cam, cfg)
        return body(carry, (frame, left, right))

    return jax.vmap(one)


def _lane_chunk_body(cfg: SlamConfig, cam: StereoCamera):
    """One sequence's chunk as a lax.map-able lane:
    (carry_lane, images_lane (C, 2, H, W)) -> (carry_lane, packed (C, 36)).

    Because the lane runs UNBATCHED, the keyframe lax.cond stays real
    dynamic control flow — a lane only pays the keyframe-event cost
    (stereo supply + insert + cull + BA + snapshot) on its own
    keyframes. Under vmap that cond lowers to masked execution of both
    branches, so EVERY lane pays the event cost EVERY frame (measured:
    vmapped DP-4 runs at ~0.4x the aggregate of four independent runs)."""
    from slam_toolkit_tpu.pipeline.scan_engine import make_frame_body

    body = make_frame_body(cfg, cam)

    def lane(args):
        c_lane, imgs_lane = args
        def step(c, stereo):
            frame = build_frame(stereo[0], cam, cfg)
            return body(c, (frame, stereo[0], stereo[1]))
        return jax.lax.scan(step, c_lane, imgs_lane)

    return lane


def multi_sequence_lane_chunk(cfg: SlamConfig, cam: StereoCamera):
    """Single-device DP chunk with REAL keyframe branching: lax.map over
    lanes (sequential per lane) of the unbatched chunked scan.

    Same signature as multi_sequence_chunk: (carry, images (C, B, 2, H,
    W)) -> (carry, packed (C, B, 36)). Lanes execute one after another
    on the device, but each lane's frames skip the keyframe event unless
    that lane needs one — the vmapped variant's both-branch masking
    costs more than lane serialization whenever the keyframe rate is
    low (the common case: ~1 KF per 5 frames)."""
    import functools

    lane = _lane_chunk_body(cfg, cam)

    @functools.partial(jax.jit, donate_argnums=0)
    def chunk(carry, images):
        imgs_lanes = jnp.moveaxis(images, 1, 0)        # (B, C, 2, H, W)
        carry_out, packed = jax.lax.map(lane, (carry, imgs_lanes))
        return carry_out, jnp.moveaxis(packed, 0, 1)   # (C, B, 36)

    return chunk


def multi_sequence_shard_chunk(cfg: SlamConfig, cam: StereoCamera,
                               mesh: Mesh):
    """Multi-chip DP chunk: shard_map over the `seq` mesh axis.

    This — not vmap — is the idiomatic cross-chip layout: inside a shard
    the program is the UNBATCHED chunked scan (lax.map over the shard's
    local lanes), so the keyframe lax.cond remains genuine per-device
    control flow and each chip only pays keyframe events its own
    sequences trigger. Sequences are independent, so the lowered program
    has ZERO collectives and the inter-card links stay idle. vmap
    remains the right tool for intra-chip lane batching of
    branch-free stages, shard_map for the cross-chip axis.

    carry: batched pytree with leading axis B sharded over `seq`
    (shard_batch); images: (C, B, 2, H, W), B divisible by mesh size.
    Returns (carry, packed (C, B, 36)) with the same shardings.
    """
    import functools

    lane = _lane_chunk_body(cfg, cam)

    def shard_body(carry_sl, images_sl):
        imgs_lanes = jnp.moveaxis(images_sl, 1, 0)
        carry_out, packed = jax.lax.map(lane, (carry_sl, imgs_lanes))
        return carry_out, jnp.moveaxis(packed, 0, 1)

    # check_vma=False: the varying-manual-axes type check rejects scan
    # carries seeded from literals deep in the shared solvers (pose LM's
    # damping scan). There is no cross-shard communication anywhere in
    # the body, so the check has nothing to protect here.
    sm = jax.shard_map(shard_body, mesh=mesh,
                       in_specs=(P("seq"), P(None, "seq")),
                       out_specs=(P("seq"), P(None, "seq")),
                       check_vma=False)
    return jax.jit(sm, donate_argnums=0)


def multi_sequence_chunk(cfg: SlamConfig, cam: StereoCamera):
    """Chunked variant of multi_sequence_engine's step: lax.scan over C
    frames of the vmapped full frame body, one dispatch per chunk per
    ALL sequences — the DP counterpart of scan_engine.make_chunk_fn.
    images: (C, B, 2, H, W); returns (carry, packed (C, B, 36)). The
    carry is donated (same rationale as the single-sequence chunk: the
    first in-place map update inside the scan must not force a copy of
    every per-sequence map array)."""
    import functools

    vbody = _vmapped_frame_body(cfg, cam)

    @functools.partial(jax.jit, donate_argnums=0)
    def chunk(carry, images):
        def step(c, imgs):
            return vbody(c, imgs[:, 0], imgs[:, 1])
        return jax.lax.scan(step, carry, images)

    return chunk
