"""Fine-grained timing inside the loop-mode host machinery.

Splits the host engine's _consume_scores call (which
profile_loop_stages.py times as one bucket) and _consume_loop_entry's
pre-work into sections to find a blocking op.

Run on the GPU: `python scripts/profile_consume.py`.
"""

import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from slam_toolkit_tpu.utils import compile_cache
compile_cache.enable()

from bench import stage_loop
from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.loop.detector import (ConsistencyTracker,
                                            acc_score_retrieval)
from slam_toolkit_tpu.pipeline import engine as engine_mod
from slam_toolkit_tpu.pipeline.scan_engine import ChunkedSlamEngine

B = defaultdict(float)
N = defaultdict(int)


def tick(name, t0):
    dt = time.perf_counter() - t0
    B[name] += dt
    N[name] += 1
    return time.perf_counter()


def patched_consume(self, slot, cand_mask, scores, covis_of=None,
                    frame_id=None):
    t = time.perf_counter()
    fid = self.frame_id if frame_id is None else frame_id
    if self.n_keyframes < 3:
        return
    if (self.n_keyframes - self._last_closure_nkf
            < self.cfg.loop.closure_cooldown_kfs):
        self.consistency.update([])
        return
    if not cand_mask.any():
        self.consistency.update([])
        t = tick("early_no_cand", t)
        return
    raw_slots = np.flatnonzero(cand_mask)
    nc = len(raw_slots)
    t = tick("flatnonzero", t)
    if covis_of is not None and all(int(s) in covis_of for s in raw_slots):
        covis_rows = np.stack([covis_of[int(s)] for s in raw_slots])
        t = tick("covis_from_prefetch", t)
    else:
        padn = 8 * ((nc + 7) // 8)
        slots_pad = np.zeros(padn, np.int32)
        slots_pad[:nc] = raw_slots
        covis_rows = np.asarray(
            self._covis(self.map, jnp.asarray(slots_pad)))[:nc]
        t = tick("covis_fallback_dispatch", t)
    cand_slots, _ = acc_score_retrieval(
        scores, raw_slots, covis_rows,
        self.cfg.loop.acc_score_ratio, self.cfg.loop.acc_group_size)
    t = tick("acc_retrieval", t)
    if len(cand_slots) == 0:
        self.consistency.update([])
        return
    row_of = {int(c): i for i, c in enumerate(raw_slots)}
    groups = []
    for cs in cand_slots:
        cov = covis_rows[row_of[int(cs)]]
        grp = set(np.flatnonzero(
            cov >= self.cfg.loop.min_covisibility).tolist())
        grp.add(int(cs))
        groups.append(grp)
    accepted = self.consistency.update(groups)
    t = tick("groups_update", t)
    if not accepted:
        return
    accepted.sort(key=lambda ci: -scores[cand_slots[ci]])
    for ci in accepted:
        cand = int(cand_slots[ci])
        rel, _ = self._relpose(self.map, jnp.int32(slot), jnp.int32(cand))
        ok = bool(rel.ok)
        t = tick("relpose_sync", t)
        if not ok:
            continue
        n_new = int(rel.n_inliers)
        fid_cand = int(np.asarray(self.map.kf_frame_id)[cand])
        W = self.cfg.loop.closure_dedup_frames
        t = tick("dedup_reads", t)
        if any(abs(fid - fj) <= W and abs(fid_cand - fi) <= W
               and n_new <= n_old for fj, fi, n_old in self._closed_pairs):
            continue
        k = self.n_closed % engine_mod.MAX_CLOSED_LOOPS
        tier = self._close_tier()
        self._ensure_tier(tier)
        t = tick("ensure_tier", t)
        (self.map, self.closed_i, self.closed_j, self.closed_T,
         self.closed_valid, self.closed_w) = self._close(
            self.map, jnp.int32(slot), jnp.int32(cand), rel.T_cw,
            self.closed_i, self.closed_j, self.closed_T,
            self.closed_valid, self.closed_w, jnp.int32(k), rel.scale,
            rel.n_inliers.astype(jnp.float32), tier)
        self.n_closed += 1
        self._last_closure_nkf = self.n_keyframes
        self._closed_pairs.append((fid, fid_cand, n_new))
        self.consistency.reset()
        self.loop_events.append(
            {"frame": fid, "kf_slot": slot, "cand": cand,
             "inliers": int(rel.n_inliers)})
        t = tick("close_dispatch", t)
        break


def main():
    cfg = SlamConfig()
    if os.environ.get("BENCH_LOOP_GROUP"):
        import dataclasses
        cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
            cfg.loop, pose_graph_group=os.environ["BENCH_LOOP_GROUP"]))
    n = int(os.environ.get("BENCH_FRAMES", "320"))
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))

    # bench.py's loop sequence + vocab (rendered and trained once)
    stacked, _, voc, _, _ = stage_loop(cfg, n, chunk)

    from slam_toolkit_tpu.pipeline.engine import SlamEngine
    SlamEngine._consume_scores = patched_consume

    import types
    eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=chunk)

    # time the scan-engine fold phases too
    for nm in ("_loop_phase1", "_loop_phase2"):
        def mk(nm):
            orig = getattr(eng, nm)
            def wrap(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                tick(nm, t0)
                return out
            return wrap
        setattr(eng, nm, mk(nm))

    # split _dispatch internals: carry rebuild vs chunk call vs loop reg
    orig_chunkfn = eng._chunk
    def chunk_timed(carry, imgs):
        t0 = time.perf_counter()
        out = orig_chunkfn(carry, imgs)
        dt = time.perf_counter() - t0
        if dt > 0.05:
            print(f"      [chunk call {dt * 1e3:.0f} ms]", file=sys.stderr)
        return out
    eng._chunk = chunk_timed
    orig_carry = eng._carry
    def carry_timed():
        t0 = time.perf_counter()
        out = orig_carry()
        dt = time.perf_counter() - t0
        if dt > 0.05:
            print(f"      [carry rebuild {dt * 1e3:.0f} ms]",
                  file=sys.stderr)
        return out
    eng._carry = carry_timed
    orig_ld = eng._loop_dispatch
    def ld_timed(*a):
        t0 = time.perf_counter()
        out = orig_ld(*a)
        dt = time.perf_counter() - t0
        if dt > 0.05:
            print(f"      [loop_dispatch {dt * 1e3:.0f} ms]",
                  file=sys.stderr)
        return out
    eng._loop_dispatch = ld_timed

    # per-call timeline of the two pipeline halves
    for nm in ("_dispatch", "_fold_one"):
        def mk(nm):
            orig = getattr(eng, nm)
            def wrap(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                dt = time.perf_counter() - t0
                tick(nm, t0)
                if dt > 0.05:
                    print(f"    [{nm} took {dt * 1e3:.0f} ms]",
                          file=sys.stderr)
                return out
            return wrap
        setattr(eng, nm, mk(nm))

    # closure-fold internals: host-engine sub-calls + the finisher
    h = eng._host
    for nm in ("_detect_accept", "_dispatch_close", "_relpose",
               "_snapshot", "_covis"):
        def mkh(nm):
            orig = getattr(h, nm)

            def wrap(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                dt = time.perf_counter() - t0
                tick("h." + nm, t0)
                if dt > 0.02:
                    print(f"      [h.{nm} took {dt * 1e3:.0f} ms]",
                          file=sys.stderr)
                return out
            return wrap
        setattr(h, nm, mkh(nm))
    orig_fin = eng._finish_pending_closures

    def fin_timed(*a, **k):
        t0 = time.perf_counter()
        out = orig_fin(*a, **k)
        dt = time.perf_counter() - t0
        tick("finish_pending", t0)
        if dt > 0.02:
            print(f"    [finish_pending took {dt * 1e3:.0f} ms]",
                  file=sys.stderr)
        return out
    eng._finish_pending_closures = fin_timed

    chunks = [jnp.asarray(stacked[i:i + chunk], jnp.float32)
              for i in range(0, n, chunk)]
    jax.block_until_ready(chunks)
    t0 = time.perf_counter()
    for c in chunks[:3]:
        eng.process_chunk(c)
    eng.flush()
    eng.warmup()
    print(f"warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    for i, c in enumerate(chunks[3:]):
        tc = time.perf_counter()
        eng.process_chunk(c)
        print(f"chunk {i}: {1e3 * (time.perf_counter() - tc):.0f} ms",
              file=sys.stderr)
    eng.flush()
    dt = time.perf_counter() - t0
    n_timed = sum(int(c.shape[0]) for c in chunks[3:])
    print(f"{n_timed} frames in {dt:.2f}s ({n_timed / dt:.1f} fps), "
          f"closures {len([e for e in eng.loop_events if 'cand' in e])}, "
          f"KFs {eng._host.n_keyframes}")
    for k in sorted(B, key=lambda k: -B[k]):
        print(f"  {k:28s} {B[k] * 1e3:8.1f} ms  x {N[k]:3d} "
              f"({100 * B[k] / dt:5.1f}% of wall)")


if __name__ == "__main__":
    main()
