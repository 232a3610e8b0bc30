"""The SLAM engine: host driver around jitted device programs.

Counterpart of the reference Pipeline (ref src/pipeline.cpp):
the two-thread producer/consumer design (tracking thread + mapping
thread over one mutex-protected map, :95-141) becomes a handful of
jitted pure functions over an immutable MapState pytree, dispatched
asynchronously by the JAX runtime — tracking of frame N+1 can overlap
local BA of keyframe N without locks because states are values, not
shared memory.

Per-frame hot path (ref Track(), :143-225):
  build_frame -> constant-velocity predict -> gather local landmarks ->
  track_pose (match + LM + filter) -> keyframe rule
Keyframe path (ref :198-204 producer + AddMappoints :243-262):
  add_stereo -> insert_keyframe (supply mappoints) -> local BA
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.loop.detector import \
    acc_score_retrieval as det_acc_retrieval
from slam_toolkit_tpu.frontend.frame import FrameState, add_stereo, build_frame
from slam_toolkit_tpu.frontend.tracker import TrackResult, track_pose
from slam_toolkit_tpu.geometry import se3
from slam_toolkit_tpu.geometry.camera import StereoCamera
from slam_toolkit_tpu.mapping import keyframe as kf_rule
from slam_toolkit_tpu.mapping.ba_adapter import local_ba_step
from slam_toolkit_tpu.mapping.map_state import (MapState, camera_frustum,
                                                empty_map,
                                                gather_local_landmarks,
                                                insert_keyframe)


MAX_CLOSED_LOOPS = 16
# keyframe rows per chunk the batched BoW register/score program
# processes (see engine._bow_register / scan_engine._loop_phase1)
BOW_ROWS = 4
# compact pose-graph problem sizes (see loop/closer.close_loop `tier`)
_PG_TIERS = (32, 64, 128, 256, 512, 1024)


class SlamEngine:
    """Stereo visual odometry / SLAM over a fixed-capacity device map.

    Pass a trained Vocabulary to enable loop detection + closing
    (the mapping()-thread work of ref src/pipeline.cpp:98-141).
    """

    def __init__(self, cfg: Optional[SlamConfig] = None,
                 cam: Optional[StereoCamera] = None,
                 vocab=None):
        self.cfg = cfg or SlamConfig()
        self.cam = cam or StereoCamera.from_config(self.cfg.camera)
        self.vocab = vocab
        self.map = empty_map(self.cfg)
        self.T_cw = jnp.eye(4)
        self.velocity = jnp.eye(4)          # dT: T_cur = dT @ T_prev
        self.frame_id = 0
        self.n_keyframes = 0
        self._tier_margin = 2           # see _close_tier
        self.trajectory: List[np.ndarray] = []      # poses as processed
        # keyframe-anchored trajectory: (kf_slot, T_frame . T_kf^-1) per
        # frame, so loop-closure corrections to keyframes retro-correct
        # every frame (the reference's rigid non-KF re-attachment,
        # ref src/loopcloser.cpp:195-208)
        self._traj_anchor: List[tuple] = []
        self.frame_stats: List[dict] = []
        self._loop_events: List[dict] = []
        # events whose T_cand_pre is still an async-copied device row —
        # materialized to a list on the next loop_events read (the
        # eager per-closure kf_T_cw readback blocked the mapping worker
        # while holding the scan engine's loop lock; r4 advisor)
        self._lazy_events: List[dict] = []
        if vocab is not None:
            from slam_toolkit_tpu.loop.detector import ConsistencyTracker
            from slam_toolkit_tpu.loop import vocab as vocab_mod
            f = self.cfg.map.max_keyframes
            self._bow_sparse = vocab_mod.use_sparse(vocab, self.cfg.loop)
            self.bow_db = vocab_mod.make_bow_db(
                vocab, f, self._bow_sparse, self.cfg.loop.bow_top_words)
            self.consistency = ConsistencyTracker(
                self.cfg.loop.consistency_threshold)
            self.closed_i = jnp.zeros(MAX_CLOSED_LOOPS, jnp.int32)
            self.closed_j = jnp.zeros(MAX_CLOSED_LOOPS, jnp.int32)
            self.closed_T = jnp.tile(jnp.eye(4), (MAX_CLOSED_LOOPS, 1, 1))
            self.closed_valid = jnp.zeros(MAX_CLOSED_LOOPS, bool)
            self.closed_w = jnp.ones(MAX_CLOSED_LOOPS, jnp.float32)
            self.n_closed = 0
            # (frame_cur, frame_cand, inliers) per closure, for the
            # same-seam dedup gate (cfg.loop.closure_dedup_frames)
            self._closed_pairs: list = []
            # post-closure detection cooldown (ORB-SLAM2 mLastLoopKFid+10;
            # the reference's unfinished last_loop_kf_)
            self._last_closure_nkf = -(10 ** 9)
            # pose-graph tier programs built so far + the background
            # compile thread keeping the next tier ahead of closures
            self._compiled_tiers: set = set()
            self._tier_thread = None
        self._compile()

    @property
    def loop_events(self) -> List[dict]:
        """Structured closure/reloc event log. Materializes any pending
        device-resident diagnostics (async-copied at closure time) on
        first read — consumers see plain lists, json-serializable."""
        if self._lazy_events:
            for e in self._lazy_events:
                e["T_cand_pre"] = np.asarray(e["T_cand_pre"]).tolist()
            self._lazy_events = []
        return self._loop_events

    @loop_events.setter
    def loop_events(self, v) -> None:        # checkpoint restore
        self._loop_events = list(v)
        self._lazy_events = []

    # ----- jitted programs -------------------------------------------------
    def _compile(self):
        cfg, cam = self.cfg, self.cam

        @jax.jit
        def _build(img):
            return build_frame(img, cam, cfg)

        @jax.jit
        def _stereo(frame, img_l, img_r):
            return add_stereo(frame, img_l, img_r, cam, cfg)

        @jax.jit
        def _snapshot(m: MapState):
            """Keyframe-event bundle: landmark snapshot + host mirrors.

            One jitted program per KF event. Anything eager here (slicing
            with a fresh python index, int(arr.sum())) would compile a NEW
            program per distinct value.
            """
            lm = gather_local_landmarks(
                m, cfg.map.track_landmarks, cfg.map.track_recent_kfs,
                cfg.map.track_covis_kfs, cfg.map.track_covis_min,
                camera_frustum(cfg.camera))
            fid = jnp.where(m.kf_valid, m.kf_frame_id, -1)
            slot = jnp.argmax(fid)
            counts = jnp.stack([slot.astype(jnp.int32),
                                jnp.sum(m.kf_valid).astype(jnp.int32)])
            return lm, m.kf_T_cw[slot], counts

        @jax.jit
        def _track(frame: FrameState, Xw, desc, valid, T_prev, velocity,
                   kf_T_latest):
            """Per-frame hot path. Returns device state + ONE packed host
            vector so the driver pays a single readback per frame."""
            T_pred = se3.compose(velocity, T_prev)
            res = track_pose(frame, Xw, desc, valid, T_pred, cam, cfg)
            matched_xy = res.mp_xy
            needs = kf_rule.needs_keyframe(
                matched_xy, res.mp_inlier, cfg.camera.width,
                cfg.camera.height, cfg.keyframe)
            T_new = jnp.where(res.ok, res.T_cw, T_pred)
            vel_new = se3.normalize(se3.compose(T_new, se3.inv(T_prev)))
            T_rel = se3.compose(T_new, se3.inv(kf_T_latest))
            packed = jnp.concatenate([
                T_new.reshape(-1), T_rel.reshape(-1),
                jnp.stack([res.ok.astype(jnp.float32),
                           needs.astype(jnp.float32),
                           res.n_inliers.astype(jnp.float32)])])
            return res, T_new, vel_new, packed

        @jax.jit
        def _insert(m, frame, T_cw, frame_id, ids, kpts, inliers,
                    lm_Xw, lm_valid, quality):
            from slam_toolkit_tpu.mapping.culling import cull_weak_mappoints
            m2, slot = insert_keyframe(m, frame, T_cw, frame_id, ids, kpts,
                                       inliers, cfg, quality=quality,
                                       lm_snapshot=(lm_Xw, lm_valid))
            m2 = cull_weak_mappoints(m2, frame_id,
                                     cfg.map.mp_cull_grace_frames,
                                     cfg.map.mp_cull_min_obs)
            return m2, slot

        @jax.jit
        def _ba(m):
            return local_ba_step(m, cam, cfg)

        @jax.jit
        def _cull(m):
            from slam_toolkit_tpu.mapping.culling import cull_most_redundant
            return cull_most_redundant(m, min_fraction=0.8,
                                       protect_recent=cfg.local_ba
                                       .window_keyframes)

        @jax.jit
        def _cull_any(m):
            # forced eviction at capacity: when nothing clears the 0.8
            # redundancy bar the engine must degrade (evict the MOST
            # redundant unprotected keyframe anyway), not crash — the
            # reference never hard-fails on memory either, it just
            # drops old frames (CullingOldFrames,
            # ref src/pipeline_map.cpp:100-129)
            from slam_toolkit_tpu.mapping.culling import cull_most_redundant
            return cull_most_redundant(m, min_fraction=0.0,
                                       protect_recent=cfg.local_ba
                                       .window_keyframes)

        if cfg.tracker.method == "direct":
            from slam_toolkit_tpu.frontend.direct_tracker import track_direct
            from slam_toolkit_tpu.frontend.matching import projection_match
            from slam_toolkit_tpu.geometry import camera as cam_mod
            from slam_toolkit_tpu.optim.direct_lm import DirectState

            @jax.jit
            def _track_dir(frame: FrameState, img, Xw, desc, valid, T_prev,
                           velocity, kf_T_latest, kf_img, kf_ab):
                """Direct-method hot path: photometric pose against the
                latest keyframe image (ref BrightenDirectPoseTracker,
                src/posetracker.cpp:250-353), then post-hoc keypoint
                binding at direct_bind_px for the same bookkeeping the
                indirect path produces (ref :278-317)."""
                T_pred = se3.compose(velocity, T_prev)
                ref_state = DirectState(T_cw=kf_T_latest, a=kf_ab[0],
                                        b=kf_ab[1])
                dres = track_direct(kf_img, ref_state, img, T_pred,
                                    cam.left, Xw, valid)
                T_dir = se3.normalize(dres.state.T_cw)
                mm = projection_match(Xw, desc, valid, frame.feats, T_dir,
                                      cam, cfg.matcher,
                                      cfg.tracker.direct_bind_px)
                Xc = se3.transform(T_dir, Xw)
                uv = cam_mod.project(cam.left, Xc)
                err_px = jnp.linalg.norm(
                    uv - frame.feats.xy[mm.kpt_idx], axis=-1)
                inlier = mm.ok & (Xc[..., 2] > 0.0) & \
                    (err_px <= cfg.tracker.direct_bind_px)
                n_in = jnp.sum(inlier)
                ok = n_in >= cfg.tracker.min_matches
                res = TrackResult(T_cw=T_dir, mp_kpt=mm.kpt_idx,
                                  mp_xy=frame.feats.xy[mm.kpt_idx],
                                  mp_inlier=inlier, n_matches=mm.n_matches,
                                  n_inliers=n_in, ok=ok)
                matched_xy = res.mp_xy
                needs = kf_rule.needs_keyframe(
                    matched_xy, res.mp_inlier, cfg.camera.width,
                    cfg.camera.height, cfg.keyframe)
                T_new = jnp.where(ok, T_dir, T_pred)
                vel_new = se3.normalize(se3.compose(T_new, se3.inv(T_prev)))
                T_rel = se3.compose(T_new, se3.inv(kf_T_latest))
                packed = jnp.concatenate([
                    T_new.reshape(-1), T_rel.reshape(-1),
                    jnp.stack([ok.astype(jnp.float32),
                               needs.astype(jnp.float32),
                               n_in.astype(jnp.float32),
                               dres.state.a, dres.state.b])])
                return res, T_new, vel_new, packed

            self._track_direct = _track_dir

        self._build, self._stereo = _build, _stereo
        self._track, self._insert, self._ba = _track, _insert, _ba
        self._cull, self._cull_any, self._snapshot = _cull, _cull_any, \
            _snapshot
        self._kf_img = None
        self._kf_ab = jnp.zeros((2,))
        # device-resident landmark snapshot + host mirrors of slow-moving
        # state, refreshed only at keyframe events
        self._lm, self._latest_kf_T_dev, counts = _snapshot(self.map)
        self._latest_slot_host = 0
        self._inlier_peak = 0.0
        self._n_kf_valid_host = 0
        self._latest_kf_T_host = np.eye(4, dtype=np.float32)

        if self.vocab is not None:
            from slam_toolkit_tpu.loop import closer as closer_mod
            from slam_toolkit_tpu.loop import detector as det_mod
            from slam_toolkit_tpu.loop import vocab as vocab_mod
            voc = self.vocab

            sparse = self._bow_sparse
            top_w = cfg.loop.bow_top_words

            @jax.jit
            def _bow(desc, valid):
                return vocab_mod.bow_query(voc, desc, valid, sparse, top_w)

            @jax.jit
            def _loop_score(m, bow_db, query, slot):
                return det_mod.score_query(m, bow_db, query, slot, cfg.loop)

            @jax.jit
            def _covis(m, slots):
                # batched: one dispatch for ALL candidates instead of
                # one dispatch and one readback per candidate
                return jax.vmap(det_mod.covisibility_counts,
                                in_axes=(None, 0))(m, slots)

            @jax.jit
            def _relpose(m, cur, cand):
                """Returns (RelPoseResult, packed (20,) f32). The packed
                vector [T(16), n_inliers, ok, scale, n_near] exists so
                HOST consumers pay ONE device->host fetch per
                measurement instead of one per NamedTuple leaf.
                Device-side consumers
                (the close program) keep using the unpacked arrays — no
                readback there."""
                rel = closer_mod.relative_pose(m, cur, cand, cam, cfg)
                packed = jnp.concatenate([
                    rel.T_cw.reshape(-1),
                    jnp.stack([rel.n_inliers.astype(jnp.float32),
                               rel.ok.astype(jnp.float32),
                               jnp.asarray(rel.scale, jnp.float32),
                               rel.n_near.astype(jnp.float32)])])
                return rel, packed

            @jax.jit
            def _reloc(m, feats, norm, cand):
                return closer_mod.relocalize_frame(m, feats, norm, cand,
                                                   cam, cfg)

            self._reloc_fn = _reloc

            @jax.jit
            def _kf_row(T_all, idx):
                # dynamic-index row gather: indexing kf_T_cw with a
                # python int compiles a one-off program per distinct
                # slot; a traced index is one compile total
                return T_all[idx]

            self._kf_row = _kf_row

            @functools.partial(jax.jit, static_argnums=12)
            def _close(m, cur, cand, T_loop, ci, cj, cT, cv, cw, k, scale,
                       q, tier):
                """Close + merge + record, ONE program. The loop
                measurement (T_loop relative to the PRE-closure candidate
                pose) and the closed-loop ring update used to run as
                eager host ops with fresh python ints — each closure
                compiled ~6 one-off programs. `tier`
                (static) sizes the compact pose-graph solve to the live
                keyframe count instead of the 1024-slot ring. `scale` is
                the detected loop scale (RelPoseResult.scale), consumed
                only under cfg.loop.pose_graph_group == "sim3"; `q` is
                the relative-pose inlier count, turned into the loop
                edge's information weight (and remembered in the `cw`
                ring for replayed edges)."""
                w = jnp.clip(q / (2.0 * cfg.loop.min_matches),
                             cfg.loop.loop_edge_min_weight, 1.0)
                # SE3 ring record: the raw measurement relative to the
                # PRE-correction candidate pose (the frame the re-track
                # was expressed in); it stays valid because SE3 closing
                # never rescales the map
                loop_T_se3 = T_loop @ se3.inv(m.kf_T_cw[cand])
                m = closer_mod.close_loop(m, cur, cand, T_loop, ci, cj, cT,
                                          cv, cfg, tier=tier,
                                          loop_scale=scale, loop_weight=w,
                                          prev_loops_w=cw)
                if cfg.loop.pose_graph_group == "sim3":
                    # record the ring edge POST-correction at UNIT scale:
                    # close_loop just rescaled anchored depths (invd * s),
                    # so the map is metric again — replaying the original
                    # scaled measurement in a later solve would assert the
                    # (already removed) drift and re-multiply invd by it
                    loop_T = m.kf_T_cw[cur] @ se3.inv(m.kf_T_cw[cand])
                else:
                    loop_T = loop_T_se3
                m = closer_mod.merge_mappoints(m, cur, cand, cam, cfg)
                return (m, ci.at[k].set(cand), cj.at[k].set(cur),
                        cT.at[k].set(loop_T), cv.at[k].set(True),
                        cw.at[k].set(w))

            @functools.partial(jax.jit, donate_argnums=1)
            def _bow_register(m, bow_db, packed):
                """BoW-compute + database-register + score one chunk's
                new keyframes in one dispatch. The scan engine's
                between-chunk loop registration previously did this per
                keyframe with eager ops (`kf_desc[slot]` gathers,
                `bow_db.at[slot].set`) — each distinct python slot value
                compiled a fresh program and paid a device sync.

                `packed` is the chunk program's (C, 36) device output —
                slot/keyframe flags are sliced ON DEVICE (columns 32/34),
                so registration costs zero host->device uploads.

                Each query scores against the db AFTER the whole batch
                registered (vs strictly-sequential registration); the
                detector's min_kf_gap temporal gate excludes the batch
                peers from candidacy anyway, so detection semantics are
                unchanged.

                Only the chunk's first BOW_ROWS keyframe rows are
                processed: vmapping the BoW descent + db scoring over
                all C=16 rows paid the full per-row cost for the
                typical 1-3 actual keyframes. Row selection is top_k on a
                priority that ranks keyframe rows by position, so the
                device's row order is EXACTLY the host's ascending
                kf_rows list (scan_engine._loop_phase1 maps sc rows
                back by that invariant). A chunk with more than
                BOW_ROWS keyframes DETECTS only the first BOW_ROWS —
                bounded staleness on a pathological burst (the decay
                rule fires ~1 KF per 5 frames in practice) — but the
                overflow rows are still REGISTERED via
                _bow_register_only (dispatched host-side at fold time;
                see that program's docstring for why a zero dense row
                is poison)."""
                slots = packed[:, 32].astype(jnp.int32)
                slot_valid = packed[:, 34] > 0.5
                C = packed.shape[0]
                K = min(BOW_ROWS, C)
                # priority: keyframe rows first, earliest first; top_k
                # is order-preserving on ties so non-kf padding rows are
                # the earliest non-kf rows (their results are dropped)
                prio = jnp.where(slot_valid,
                                 C - jnp.arange(C, dtype=jnp.int32),
                                 jnp.int32(0))
                vals, rows = jax.lax.top_k(prio, K)
                sel_slots = slots[rows]
                sel_valid = vals > 0

                def bv(s):
                    desc = m.kf_desc[s].reshape(-1, 8)
                    return vocab_mod.bow_query(voc, desc,
                                               m.kf_kpt_valid[s],
                                               sparse, top_w)
                qs = jax.vmap(bv)(sel_slots)        # (K, W) or TopWBow
                # non-keyframe rows scatter out of bounds -> dropped
                F = (bow_db.words if sparse else bow_db).shape[0]
                safe = jnp.where(sel_valid, sel_slots, F)
                db = vocab_mod.db_set(bow_db, safe, qs)
                sc = jax.vmap(
                    lambda q, s: det_mod.score_query(m, db, q, s, cfg.loop)
                )(qs, sel_slots)
                return db, sc

            @functools.partial(jax.jit, donate_argnums=1)
            def _bow_register_only(m, bow_db, slots, valid):
                """Register-and-score pass for keyframe rows beyond the
                first BOW_ROWS of a chunk (rare overflow path; host
                dispatches it from scan_engine._loop_phase1 when the
                packed readback shows >BOW_ROWS keyframes). Without
                registration the cap left overflow keyframes with
                all-zero DENSE BoW rows forever — a zero row scores
                1 - 0.5*|q|_1 = 0.5 against every L1-normalized query,
                far above min_score_floor, so the unregistered keyframe
                became a persistent false loop/reloc candidate whose
                inflated accScore group could suppress genuine
                candidates (r3 advisor, medium). The returned scores
                feed the overflow rows through the SAME detection path
                as the capped rows (r4 verdict #6 — the reference
                detects on every keyframe, ref src/loopdetector.cpp:
                38-154); the common path (<=BOW_ROWS keyframes/chunk)
                never dispatches this."""
                def bv(s):
                    desc = m.kf_desc[s].reshape(-1, 8)
                    return vocab_mod.bow_query(voc, desc,
                                               m.kf_kpt_valid[s],
                                               sparse, top_w)
                qs = jax.vmap(bv)(slots)
                F = (bow_db.words if sparse else bow_db).shape[0]
                safe = jnp.where(valid, slots, F)
                db = vocab_mod.db_set(bow_db, safe, qs)
                sc = jax.vmap(
                    lambda q, s: det_mod.score_query(m, db, q, s, cfg.loop)
                )(qs, slots)
                return db, sc

            @jax.jit
            def _seam_ba(m, cur, cand):
                from slam_toolkit_tpu.mapping.ba_adapter import seam_ba_step
                return seam_ba_step(m, cur, cand, cam, cfg)

            self._bow, self._loop_score, self._covis = _bow, _loop_score, _covis
            self._relpose, self._close = _relpose, _close
            self._bow_register = _bow_register
            self._bow_register_only = _bow_register_only
            self._seam_ba = _seam_ba

    # ----- driver -----------------------------------------------------------
    def process(self, left, right) -> np.ndarray:
        """Track one stereo pair; returns the estimated T_cw (4, 4).

        Hot-path budget: one image upload + one _track dispatch + ONE
        small packed readback per non-keyframe frame. Everything else
        (stereo, insertion, BA, loops, snapshot refresh) happens only at
        keyframe events.
        """
        import time
        self._t_frame0 = time.perf_counter()
        img_l = left if isinstance(left, jnp.ndarray) \
            else jnp.asarray(left, jnp.float32)
        frame = self._build(img_l)

        if self.n_keyframes == 0:
            img_r = right if isinstance(right, jnp.ndarray) \
                else jnp.asarray(right, jnp.float32)
            self._make_keyframe(frame, img_l, img_r, self.T_cw,
                                ids=None, kpts=None, inliers=None,
                                run_ba=False)
            self._finish_frame(np.eye(4, dtype=np.float32),
                               np.eye(4, dtype=np.float32), 0, True)
            return np.asarray(self.T_cw)

        Xw, desc, ids, valid = self._lm
        if self.cfg.tracker.method == "direct":
            res, T_new, vel_new, packed = self._track_direct(
                frame, img_l, Xw, desc, valid, self.T_cw, self.velocity,
                self._latest_kf_T_dev, self._kf_img, self._kf_ab)
            self._kf_ab = packed[35:37]
        else:
            res, T_new, vel_new, packed = self._track(
                frame, Xw, desc, valid, self.T_cw, self.velocity,
                self._latest_kf_T_dev)
        packed_np = np.asarray(packed)           # the one readback
        tracked_ok = packed_np[32] > 0.5
        needs_kf = packed_np[33] > 0.5
        n_inliers = int(packed_np[34])
        T_np = packed_np[:16].reshape(4, 4)
        T_rel_np = packed_np[16:32].reshape(4, 4)

        if not tracked_ok and self.vocab is not None:
            # relocalization (absent from the reference, which always
            # trusts constant velocity, ref src/pipeline.cpp:154-166)
            reloc = self._try_relocalize(frame)
            if reloc is not None:
                res, T_new, vel_new, packed = self._track(
                    frame, Xw, desc, valid, reloc, jnp.eye(4),
                    self._latest_kf_T_dev)
                packed_np = np.asarray(packed)
                tracked_ok = packed_np[32] > 0.5
                needs_kf = packed_np[33] > 0.5
                n_inliers = int(packed_np[34])
                T_np = packed_np[:16].reshape(4, 4)
                T_rel_np = packed_np[16:32].reshape(4, 4)

        self.T_cw, self.velocity = T_new, vel_new

        # relative decay rule (cfg.keyframe.decay_ratio): fire when
        # inliers fall below a fraction of the running max since the
        # last keyframe — the grid rule alone under-fires on dense maps
        if n_inliers < self.cfg.keyframe.decay_ratio * self._inlier_peak:
            needs_kf = True
        self._inlier_peak = 0.0 if (needs_kf or not tracked_ok) else \
            max(self._inlier_peak, float(n_inliers))

        if needs_kf or not tracked_ok:
            img_r = right if isinstance(right, jnp.ndarray) \
                else jnp.asarray(right, jnp.float32)
            self._make_keyframe(frame, img_l, img_r, T_new,
                                ids=ids, kpts=res.mp_kpt,
                                inliers=res.mp_inlier, run_ba=True)
            # poses may have shifted in BA; refresh device + host state
            T_np = self._latest_kf_T_host
            T_rel_np = np.eye(4, dtype=np.float32)
            self.T_cw = self._latest_kf_T_dev
        self._finish_frame(T_np, T_rel_np, n_inliers, bool(needs_kf))
        return T_np

    def _latest_slot(self) -> int:
        fid = jnp.where(self.map.kf_valid, self.map.kf_frame_id, -1)
        return int(jnp.argmax(fid))

    def _refresh_kf_mirrors(self):
        """Refresh host mirrors + device landmark snapshot after any map
        mutation (insert / BA / loop closure / cull). One jitted dispatch
        + one small readback."""
        self._lm, self._latest_kf_T_dev, counts = self._snapshot(self.map)
        counts_np = np.asarray(counts)
        self._latest_slot_host = int(counts_np[0])
        self._n_kf_valid_host = int(counts_np[1])
        self._latest_kf_T_host = np.asarray(self._latest_kf_T_dev)

    def _make_keyframe(self, frame, img_l, img_r, T_cw, ids, kpts, inliers,
                       run_ba: bool):
        cap = self.cfg.map.max_keyframes
        if self._n_kf_valid_host >= cap - 2:
            # near capacity: cull redundant keyframes (mapping/culling.py);
            # if nothing is redundant enough the map is genuinely full
            for attempt in range(4):
                kf_T_pre = np.asarray(self.map.kf_T_cw)
                self.map, slot = self._cull(self.map)
                s = int(slot)
                if s < 0:
                    # nothing clears the redundancy bar: forced eviction
                    self.map, slot = self._cull_any(self.map)
                    s = int(slot)
                if s < 0:
                    break
                # trajectory entries anchored to the culled slot must move
                # to a surviving keyframe before the slot is reused
                self._refresh_kf_mirrors()
                new_anchor = self._latest_slot_host
                T_new_inv = np.linalg.inv(kf_T_pre[new_anchor])
                for i, (sl, rel) in enumerate(self._traj_anchor):
                    if sl == s:
                        T_abs = rel @ kf_T_pre[s]
                        self._traj_anchor[i] = (new_anchor, T_abs @ T_new_inv)
            self._refresh_kf_mirrors()
            if self._n_kf_valid_host >= cap - 2:
                raise RuntimeError(f"keyframe capacity {cap} exhausted "
                                   f"(nothing redundant to cull)")
        frame = self._stereo(frame, img_l, img_r)
        if self.cfg.tracker.method in ("direct", "hybrid"):
            # the new keyframe becomes the photometric anchor; its (a, b)
            # are whatever tracking last estimated (bootstrap: 0, 0)
            self._kf_img = img_l if isinstance(img_l, jnp.ndarray) \
                else jnp.asarray(img_l, jnp.float32)
        if ids is None:
            L = self.cfg.map.track_landmarks
            ids = jnp.zeros((L,), jnp.int32)
            kpts = jnp.zeros((L,), jnp.int32)
            inliers = jnp.zeros((L,), bool)
            # bootstrap / relocalization seed: no tracking preceded this
            # insert, so the default quality (tracked-inlier count) would
            # be 0 — and close_loop's quality de-weighting would then let
            # the pose graph dump the WHOLE loop correction into this
            # keyframe's chain edge (measured on the bench clothoid:
            # closed ATE 3.42 m vs 1.22 m with a uniform chain, loop
            # candidate = keyframe 0). Full weight: unmeasured, not bad.
            quality = jnp.float32(2 * self.cfg.tracker.min_matches)
        else:
            quality = jnp.sum(inliers.astype(jnp.float32))
        self.map, slot = self._insert(self.map, frame, T_cw,
                                      jnp.int32(self.frame_id), ids, kpts,
                                      inliers, self._lm[0], self._lm[3],
                                      quality)
        self.n_keyframes += 1
        if self.vocab is not None:
            self._loop_step(frame, int(slot))
        if run_ba and self.n_keyframes >= 3:
            self.map = self._ba(self.map)
        self._refresh_kf_mirrors()
        if self.vocab is not None:
            self._precompile_tiers_async()

    def _try_relocalize(self, frame):
        """BoW-rank keyframes against the lost frame; re-track the best.
        Returns a corrected T_pred or None."""
        from slam_toolkit_tpu.loop.vocab import bow_score
        q = self._bow(frame.feats.desc, frame.feats.valid)
        scores = np.array(bow_score(q, self.bow_db))  # writable copy
        scores[~np.asarray(self.map.kf_valid)] = -1.0
        for cand in np.argsort(-scores)[:3]:
            if scores[cand] <= 0.0:
                break
            rel = self._reloc_fn(self.map, frame.feats, frame.norm_xy,
                                 jnp.int32(int(cand)))
            if bool(rel.ok):
                self.loop_events.append(
                    {"frame": self.frame_id, "reloc_to": int(cand),
                     "inliers": int(rel.n_inliers)})
                return rel.T_cw
        return None

    def warmup_loop_programs(self):
        """Pre-compile the closure-path programs (covis, relative pose,
        close+merge). These only run when a closure actually fires —
        without warmup the FIRST real closure pays their compiles in
        the middle of the timed pipeline. All three are pure
        fixed-iteration functions, safe to trace on the empty map."""
        if self.vocab is None:
            return
        z = jnp.int32(0)
        # BOTH covis batch shapes the pipeline uses (pads to multiples
        # of 8): a 16-wide candidate batch first appearing at the
        # closure fold recompiled _covis mid-run (a stall right where
        # the pipeline is busiest)
        outs = [self._covis(self.map, jnp.zeros((8,), jnp.int32)),
                self._covis(self.map, jnp.zeros((16,), jnp.int32))]
        outs.append(self._relpose(self.map, z, z))
        # the closure diagnostic's row gather: left out of warmup it
        # compiled at the FIRST closure
        outs.append(self._kf_row(self.map.kf_T_cw, z))
        if self.cfg.loop.seam_ba:
            outs.append(self._seam_ba(empty_map(self.cfg), z, z))
        jax.block_until_ready(outs)
        # compile the tier a closure would use RIGHT NOW plus the next
        # one up. Fixed tiers[:2] missed the scan engine's raised margin
        # (queue_depth * chunk keyframes may be in flight), and a tier
        # compile at closure time stalls the pipeline for its whole
        # compile
        for tier in self._tiers_ahead():
            self._warm_tier(tier)

    def _tiers_ahead(self):
        """The pose-graph tier a closure would need now, and the next
        tier up (keyframe growth during the compile window)."""
        cur = self._close_tier()
        out = [cur]
        for t in _PG_TIERS:
            if t > cur and t <= self.cfg.map.max_keyframes:
                out.append(t)
                break
        return out

    def _warm_tier(self, tier: int):
        """Compile (and cache) the close program for one tier by running
        it on a FRESH empty map with identity inputs (freed right
        after). Never the live map: the chunked engine donates the live
        map's buffers to the next chunk program, so a reference captured
        by the background compile thread can be deleted before the RPC
        lands. Pure function: executing it costs one small device solve
        and nothing else."""
        if tier in self._compiled_tiers:
            return
        z = jnp.int32(0)
        dummy = empty_map(self.cfg)
        out = self._close(dummy, z, z, jnp.eye(4),
                          jnp.zeros(MAX_CLOSED_LOOPS, jnp.int32),
                          jnp.zeros(MAX_CLOSED_LOOPS, jnp.int32),
                          jnp.tile(jnp.eye(4), (MAX_CLOSED_LOOPS, 1, 1)),
                          jnp.zeros(MAX_CLOSED_LOOPS, bool),
                          jnp.ones(MAX_CLOSED_LOOPS, jnp.float32),
                          z, jnp.float32(1.0), jnp.float32(100.0), tier)
        jax.block_until_ready(out)
        self._compiled_tiers.add(tier)

    def _precompile_tiers_async(self):
        """Keep the next closure's tier compiled AHEAD of the closure:
        kick a daemon thread compiling any tier in _tiers_ahead() not
        yet built. Called after keyframe growth (cheap no-op when
        everything is compiled). The closure path joins the thread via
        _ensure_tier, so the worst case degrades to today's synchronous
        compile, never a double compile."""
        if self.vocab is None:
            return
        missing = [t for t in self._tiers_ahead()
                   if t not in self._compiled_tiers]
        if not missing:
            return
        if self._tier_thread is not None and self._tier_thread.is_alive():
            return
        import threading

        def work(tiers=tuple(missing)):
            for t in tiers:
                self._warm_tier(t)

        self._tier_thread = threading.Thread(target=work, daemon=True)
        self._tier_thread.start()

    def _ensure_tier(self, tier: int):
        """Block until `tier`'s close program exists: join an in-flight
        background compile if one is running, else compile here."""
        if tier in self._compiled_tiers:
            return
        if self._tier_thread is not None and self._tier_thread.is_alive():
            self._tier_thread.join()
        self._warm_tier(tier)

    def _close_tier(self) -> int:
        """Smallest pose-graph tier covering the live keyframe count,
        plus _tier_margin: 2 for this engine (the host mirror can lag
        the newest insert); the chunked scan engine raises it to cover
        keyframes its in-flight chunks may have inserted beyond the
        mirror — a too-small tier would exclude the newest keyframes
        from the closure solve."""
        F = self.cfg.map.max_keyframes
        need = min(self._n_kf_valid_host + self._tier_margin, F)
        for t in _PG_TIERS:
            if need <= t <= F:
                return t
        return F

    # ----- loop closing (the mapping-thread work) ----------------------------
    def _loop_step(self, frame, slot: int):
        from slam_toolkit_tpu.loop.vocab import db_set
        q = self._bow(frame.feats.desc, frame.feats.valid)
        self.bow_db = db_set(self.bow_db, slot, q)
        self._loop_kf_detect(slot, q)

    def _loop_kf_detect(self, slot: int, q):
        """Detection + consistency + closure for one new keyframe."""
        if self.n_keyframes < 3:
            return
        sc = self._loop_score(self.map, self.bow_db, q, jnp.int32(slot))
        self._consume_scores(slot, np.asarray(sc.candidates),
                             np.asarray(sc.scores))

    def _detect_accept(self, slot: int, cand_mask: np.ndarray,
                       scores: np.ndarray, covis_of: Optional[dict],
                       fid: int) -> list:
        """Detection half: accScore groups + consistency. Returns the
        accepted candidate slots, strongest first ([] = nothing to
        close). Pure host arithmetic apart from the covis fallback
        dispatch — safe to call without ever blocking on the device."""
        if self.n_keyframes < 3:
            return []
        if (self.n_keyframes - self._last_closure_nkf
                < self.cfg.loop.closure_cooldown_kfs):
            # post-closure cooldown: the seam was just corrected; an
            # immediate re-closure would re-inject measurement noise at
            # full edge weight (ORB-SLAM2's mLastLoopKFid+10 gate; the
            # reference's unfinished last_loop_kf_)
            self.consistency.update([])
            return []
        if not cand_mask.any():
            self.consistency.update([])
            return []
        raw_slots = np.flatnonzero(cand_mask)
        nc = len(raw_slots)
        if covis_of is not None and all(int(s) in covis_of
                                        for s in raw_slots):
            covis_rows = np.stack([covis_of[int(s)] for s in raw_slots])
        else:
            # one batched dispatch, padded to a multiple of 8 so
            # candidate-count jitter doesn't recompile the vmapped
            # program every call
            padn = 8 * ((nc + 7) // 8)
            slots_pad = np.zeros(padn, np.int32)
            slots_pad[:nc] = raw_slots
            covis_rows = np.asarray(
                self._covis(self.map, jnp.asarray(slots_pad)))[:nc]
        # accumulate over covisibility groups, keep > 0.75 * best group
        # (ref src/pipeline_map.cpp:224-269; suppresses single-frame
        # BoW aliasing)
        cand_slots, _ = det_acc_retrieval(
            scores, raw_slots, covis_rows,
            self.cfg.loop.acc_score_ratio, self.cfg.loop.acc_group_size)
        if len(cand_slots) == 0:
            self.consistency.update([])
            return []
        row_of = {int(c): i for i, c in enumerate(raw_slots)}
        # covisibility group per candidate (candidate + its neighbors)
        groups = []
        for cs in cand_slots:
            cov = covis_rows[row_of[int(cs)]]
            grp = set(np.flatnonzero(
                cov >= self.cfg.loop.min_covisibility).tolist())
            grp.add(int(cs))
            groups.append(grp)
        accepted = self.consistency.update(groups)
        if os.environ.get("SLAM_LOOP_DEBUG"):
            # loop-detection decision trace (diagnosis of closure-timing
            # issues; see scripts/diag_chunked_loop.py)
            import sys
            sys.stderr.write(
                f"[det] fid={fid} slot={slot} raw={raw_slots.tolist()} "
                f"cands={[int(c) for c in cand_slots]} "
                f"groups={[sorted(g) for g in groups]} "
                f"accepted={accepted}\n")
        if not accepted:
            return []
        # strongest consistent candidate first (ref picks most matches)
        accepted.sort(key=lambda ci: -scores[cand_slots[ci]])
        return [int(cand_slots[ci]) for ci in accepted]

    def _closure_is_dup(self, fid: int, fid_cand: int, n_new: int) -> bool:
        """Same-seam dedup: if this pair re-measures an already-closed
        loop, only a STRONGER measurement may refine it (a weaker one
        re-injects noise into a corrected seam — measured 0.19 ->
        0.89 m on the synthetic revisit circle)."""
        W = self.cfg.loop.closure_dedup_frames
        return any(abs(fid - fj) <= W and
                   abs(fid_cand - fi) <= W and n_new <= n_old
                   for fj, fi, n_old in self._closed_pairs)

    def _dispatch_close(self, slot: int, cand: int, rel, fid: int,
                        fid_cand: int, vals=None) -> None:
        """Closure half, given an accepted+measured relative pose:
        dispatch the close program (+ optional seam BA), update the
        rings and bookkeeping. Does NOT block on the device — callers
        that need the corrected map synchronously read self.map after.

        vals: the (20,) host copy of _relpose's packed output, if the
        caller already fetched it — avoids 4 more small device reads
        for the event bookkeeping."""
        n_new = int(rel.n_inliers) if vals is None else int(vals[16])
        k = self.n_closed % MAX_CLOSED_LOOPS
        tier = self._close_tier()
        self._ensure_tier(tier)
        # pre-correction candidate pose for the seam-dissection record
        # below (must be DISPATCHED before the close program reassigns
        # map). Async row copy, materialized lazily at the next
        # loop_events read — the old synchronous full-kf_T_cw readback
        # ran on every closure while the mapping worker held the scan
        # engine's loop lock, stalling the main thread's next chunk
        # dispatch for the readback duration (r4 advisor)
        T_cand_pre = self._kf_row(self.map.kf_T_cw, jnp.int32(cand))
        try:
            T_cand_pre.copy_to_host_async()
        except Exception:       # non-jax arrays in tests
            pass
        corr_m = None
        if self.cfg.loop.seam_ba:
            # closure-correction magnitude at the current keyframe
            # (gates seam BA below): distance between the measured loop
            # pose's camera center and the pre-closure estimate's.
            # Synchronous readback — only paid when seam BA is on.
            T_pre = np.asarray(self.map.kf_T_cw)[slot]
            T_meas = np.asarray(rel.T_cw)
            corr_m = float(np.linalg.norm(
                T_pre[:3, :3].T @ T_pre[:3, 3]
                - T_meas[:3, :3].T @ T_meas[:3, 3]))
        (self.map, self.closed_i, self.closed_j, self.closed_T,
         self.closed_valid, self.closed_w) = self._close(
            self.map, jnp.int32(slot), jnp.int32(cand), rel.T_cw,
            self.closed_i, self.closed_j, self.closed_T,
            self.closed_valid, self.closed_w, jnp.int32(k), rel.scale,
            rel.n_inliers.astype(jnp.float32), tier)
        if (self.cfg.loop.seam_ba
                and corr_m >= self.cfg.loop.seam_ba_min_corr_m):
            # re-optimize structure around the just-closed seam
            # (the reference's always-run post-closure local BA,
            # ref src/pipeline.cpp:137-138) — but only when the
            # closure actually moved things (seam_ba_min_corr_m)
            self.map = self._seam_ba(self.map, jnp.int32(slot),
                                     jnp.int32(cand))
        self.n_closed += 1
        self._last_closure_nkf = self.n_keyframes
        self._closed_pairs.append((fid, fid_cand, n_new))
        self.consistency.reset()
        ev = {"frame": fid, "kf_slot": slot, "cand": cand,
              "inliers": n_new, "fid_cand": fid_cand,
              # near-landmark participation of the accepted edge (depth
              # gate / refine diagnostics: 0 near inliers = the solve sat
              # in the far-depth ambiguity valley)
              "n_near": int(vals[19]) if vals is not None
              else int(np.asarray(rel.n_near)),
              # detected current/candidate scale ratio (sim3 edges apply
              # it; a wrong estimate rescales anchored depths and shows
              # up as revisit re-drift)
              "scale": round(float(vals[18]), 5) if vals is not None
              else round(float(np.asarray(rel.scale)), 5),
              # raw measurement diagnostics (seam dissection): the
              # re-tracked current-keyframe pose in the candidate side's
              # PRE-correction world, and that pre-correction candidate
              # pose — lets an evaluator with GT compute the loop edge's
              # own error separately from the graph residual. T_cand_pre
              # stays a device row until loop_events is read.
              "T_meas": (vals[:16].reshape(4, 4) if vals is not None
                         else np.asarray(rel.T_cw)).tolist(),
              "T_cand_pre": T_cand_pre}
        self._loop_events.append(ev)
        self._lazy_events.append(ev)

    def _consume_scores(self, slot: int, cand_mask: np.ndarray,
                        scores: np.ndarray, covis_of: Optional[dict] = None,
                        frame_id: Optional[int] = None):
        """Host half of detection: consistency + closure, given the
        (already read back) candidate mask and score row for one new
        keyframe. Driven per-KF by _loop_kf_detect; the scan engine
        drives the two halves (_detect_accept / _dispatch_close)
        separately so the relpose measurement can overlap a chunk of
        device time instead of blocking the fold."""
        fid = self.frame_id if frame_id is None else frame_id
        for cand in self._detect_accept(slot, cand_mask, scores,
                                        covis_of, fid):
            rel, pk = self._relpose(self.map, jnp.int32(slot),
                                    jnp.int32(cand))
            vals = np.asarray(pk)           # ONE fetch for all fields
            if not vals[17] > 0.5:          # ok flag
                continue
            # Read the WHOLE (F,) id array: indexing the device array
            # with the python `cand` compiled a one-off gather program
            # per distinct slot
            fid_cand = int(np.asarray(self.map.kf_frame_id)[cand])
            if self._closure_is_dup(fid, fid_cand, int(vals[16])):
                continue
            self._dispatch_close(slot, cand, rel, fid, fid_cand,
                                 vals=vals)
            break

    def _finish_frame(self, T_np: np.ndarray, T_rel_np: np.ndarray,
                      n_inliers: int, is_kf: bool):
        self.trajectory.append(T_np)
        self._traj_anchor.append((self._latest_slot_host, T_rel_np))
        import time
        elapsed_ms = 1000.0 * (time.perf_counter()
                               - getattr(self, "_t_frame0", time.perf_counter()))
        # per-frame wall clock, the reference's FrameInfo::elapsed_ms_
        # (ref src/pipeline.cpp:144,209-212)
        self.frame_stats.append(
            {"frame": self.frame_id, "inliers": n_inliers, "kf": is_kf,
             "elapsed_ms": round(elapsed_ms, 2)})
        self.frame_id += 1

    def trajectory_refined(self) -> List[np.ndarray]:
        """Per-frame poses re-expressed against CURRENT keyframe poses,
        so pose-graph/BA corrections propagate to the whole trajectory."""
        kf_T = np.asarray(self.map.kf_T_cw)
        return [rel @ kf_T[slot] for slot, rel in self._traj_anchor]

    # ----- introspection ----------------------------------------------------
    def num_mappoints(self) -> int:
        return int(self.map.mp_valid.sum())

    def keyframe_poses(self) -> np.ndarray:
        valid = np.asarray(self.map.kf_valid)
        return np.asarray(self.map.kf_T_cw)[valid]
