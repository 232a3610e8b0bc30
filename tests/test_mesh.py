"""DP multi-sequence SLAM on the 8-device virtual CPU mesh.

"vmap N KITTI sequences across a device mesh": the FULL engine step (tracking + keyframe insertion + local BA,
parallel/mesh.multi_sequence_engine) must run batched over sequences
with per-sequence maps growing independently, and the batch axis must
stay sharded over the mesh through the whole step."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.data.synthetic import make_sequence
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.parallel import mesh as mesh_mod

N_DEV = 4  # divides the 8 virtual CPU devices; keeps the test light


@pytest.fixture(scope="module")
def dp_run():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"need {N_DEV} devices")
    cfg = SlamConfig.tiny()
    cam = StereoCamera.from_config(cfg.camera)
    mesh = mesh_mod.make_mesh(N_DEV)

    # distinct worlds/trajectories per sequence -> maps must diverge
    seqs = [make_sequence(cfg, n_frames=6, seed=100 + i,
                          step=0.2 + 0.05 * i) for i in range(N_DEV)]
    lefts = np.stack([[l for l, _ in s[2]] for s in seqs])   # (B, T, H, W)
    rights = np.stack([[r for _, r in s[2]] for s in seqs])

    maps = mesh_mod.shard_batch(mesh, mesh_mod.batched_empty_map(cfg, N_DEV))
    boot, step = mesh_mod.multi_sequence_engine(cfg, cam, mesh)
    carry = boot(maps, jnp.asarray(lefts[:, 0]), jnp.asarray(rights[:, 0]))
    packs = []
    for t in range(1, lefts.shape[1]):
        carry, packed = step(carry, jnp.asarray(lefts[:, t]),
                             jnp.asarray(rights[:, t]))
        packs.append(np.asarray(packed))
    jax.block_until_ready(carry)
    return cfg, mesh, seqs, carry, np.stack(packs, axis=1)  # (B, T-1, 36)


@pytest.mark.slow
def test_maps_grow_independently(dp_run):
    cfg, mesh, seqs, carry, packs = dp_run
    n_kf = np.asarray(carry.m.kf_valid.sum(axis=1))
    n_mp = np.asarray(carry.m.mp_valid.sum(axis=1))
    assert (n_kf >= 1).all()
    assert (n_mp > 50).all(), f"mappoints per sequence: {n_mp}"
    # sequences saw different worlds: landmark clouds must differ
    Xw0 = np.asarray(carry.lm_Xw[0])
    Xw1 = np.asarray(carry.lm_Xw[1])
    assert not np.allclose(Xw0, Xw1)


def test_tracking_quality_per_sequence(dp_run):
    cfg, mesh, seqs, carry, packs = dp_run
    for b, (world, gt, frames) in enumerate(seqs):
        ok = packs[b, :, 33]
        assert ok.mean() > 0.5, f"sequence {b} lost tracking"
        # final pose translation sane vs GT (~1.5 m path, 6 frames;
        # seed-dependent texture richness puts the worst sequence ~0.5 m)
        T_est = packs[b, -1, :16].reshape(4, 4)
        c_est = -T_est[:3, :3].T @ T_est[:3, 3]
        T_gt = gt[-1]
        c_gt = -T_gt[:3, :3].T @ T_gt[:3, 3]
        assert np.linalg.norm(c_est - c_gt) < 0.8, \
            f"sequence {b}: est {c_est} vs gt {c_gt}"


def test_sharding_held(dp_run):
    cfg, mesh, seqs, carry, packs = dp_run
    spec = carry.m.kf_T_cw.sharding.spec
    assert spec and spec[0] == "seq", f"batch axis not sharded: {spec}"


@pytest.mark.slow
def test_chunked_dp_matches_per_frame(dp_run):
    """multi_sequence_chunk (lax.scan over the vmapped frame body — the
    BENCH_DP dispatch granularity) must produce the same packed outputs
    as per-frame stepping."""
    cfg, mesh, seqs, carry0, packs = dp_run
    cam = StereoCamera.from_config(cfg.camera)
    lefts = np.stack([[l for l, _ in s[2]] for s in seqs])
    rights = np.stack([[r for _, r in s[2]] for s in seqs])
    maps = mesh_mod.shard_batch(mesh,
                                mesh_mod.batched_empty_map(cfg, N_DEV))
    boot, _ = mesh_mod.multi_sequence_engine(cfg, cam, mesh)
    carry = boot(maps, jnp.asarray(lefts[:, 0]), jnp.asarray(rights[:, 0]))
    chunk = mesh_mod.multi_sequence_chunk(cfg, cam)
    # images (C, B, 2, H, W): frames 1..T-1 in one chunk
    imgs = jnp.asarray(np.stack(
        [np.stack([lefts[:, t], rights[:, t]], axis=1)
         for t in range(1, lefts.shape[1])]))
    carry, packed = chunk(carry, imgs)              # (C, B, 36)
    got = np.transpose(np.asarray(packed), (1, 0, 2))   # (B, C, 36)
    np.testing.assert_allclose(got, packs, rtol=1e-4, atol=1e-4)


def _dp_inputs(cfg, seqs, mesh):
    cam = StereoCamera.from_config(cfg.camera)
    lefts = np.stack([[l for l, _ in s[2]] for s in seqs])
    rights = np.stack([[r for _, r in s[2]] for s in seqs])
    maps = mesh_mod.shard_batch(mesh,
                                mesh_mod.batched_empty_map(cfg, N_DEV))
    boot = jax.jit(mesh_mod.batched_bootstrap(cfg, cam))
    carry = boot(maps, jnp.asarray(lefts[:, 0]), jnp.asarray(rights[:, 0]))
    imgs = jnp.asarray(np.stack(
        [np.stack([lefts[:, t], rights[:, t]], axis=1)
         for t in range(1, lefts.shape[1])]))
    return cam, carry, imgs


@pytest.mark.slow
def test_lane_chunk_matches_vmap(dp_run):
    """multi_sequence_lane_chunk (lax.map over lanes — the keyframe cond
    stays real control flow) must produce the same packed outputs as the
    vmapped chunk: lane serialization is a pure execution-strategy
    change, never a results change."""
    cfg, mesh, seqs, carry0, packs = dp_run
    cam, carry, imgs = _dp_inputs(cfg, seqs, mesh)
    carry, packed = mesh_mod.multi_sequence_lane_chunk(cfg, cam)(carry, imgs)
    got = np.transpose(np.asarray(packed), (1, 0, 2))
    np.testing.assert_allclose(got, packs, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_shard_chunk_matches_vmap_and_holds_sharding(dp_run):
    """multi_sequence_shard_chunk (shard_map over `seq`, unbatched scan
    per shard) must agree with the vmapped chunk and keep every output
    sharded over the mesh — the multi-chip DP layout with zero
    collectives."""
    cfg, mesh, seqs, carry0, packs = dp_run
    cam, carry, imgs = _dp_inputs(cfg, seqs, mesh)
    step = mesh_mod.multi_sequence_shard_chunk(cfg, cam, mesh)
    carry, packed = step(carry, imgs)
    got = np.transpose(np.asarray(packed), (1, 0, 2))
    np.testing.assert_allclose(got, packs, rtol=1e-4, atol=1e-4)
    assert packed.sharding.spec[1] == "seq"
    assert carry.m.kf_T_cw.sharding.spec[0] == "seq"
