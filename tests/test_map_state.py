"""Unit tests for the map-state slot allocator and landmark dedup.

These two helpers sit on the keyframe-event hot path and are written
as dense compare-reduce / sorted-adjacency forms;
the tests pin their contract independently of the e2e suites.
"""

import jax.numpy as jnp
import numpy as np

from slam_toolkit_tpu.config import SlamConfig
from slam_toolkit_tpu.mapping.map_state import (allocate_slots, empty_map,
                                                unique_prioritized)


def test_allocate_slots_first_free_order():
    free = jnp.array([False, True, False, True, True, False, True, False])
    want = jnp.array([True, False, True, True])
    slots = np.asarray(allocate_slots(free, want, 4))
    # the i-th real request gets the i-th free slot; masked request -> N
    assert slots.tolist() == [1, 8, 3, 4]


def test_allocate_slots_overflow_gets_sentinel():
    free = jnp.array([True, False, False, True])
    want = jnp.ones((4,), bool)
    slots = np.asarray(allocate_slots(free, want, 4))
    assert slots[0] == 0 and slots[1] == 3
    # only two free slots exist: requests 2 and 3 must get the sentinel,
    # NEVER an occupied slot (a real allocation there would overwrite a
    # live landmark through the drop-mode scatters downstream)
    assert slots[2] == 4 and slots[3] == 4


def test_allocate_slots_no_free():
    free = jnp.zeros((6,), bool)
    want = jnp.ones((3,), bool)
    assert np.asarray(allocate_slots(free, want, 3)).tolist() == [6, 6, 6]


def _tiny_map():
    return empty_map(SlamConfig.tiny())


def test_unique_prioritized_dedups_and_ignores_negatives():
    m = _tiny_map()
    M = m.mp_valid.shape[0]
    ids = jnp.array([5, -1, 3, 5, 3, 7, -1, 3], jnp.int32)
    out = np.asarray(unique_prioritized(ids, 6, m))
    got = sorted(x for x in out if x < M)
    assert got == [3, 5, 7]
    assert all(x == M for x in out if x not in (3, 5, 7))


def test_unique_prioritized_established_first_truncation():
    m = _tiny_map()
    M = m.mp_valid.shape[0]
    # 9, 11 appear twice in the window (established); 2, 4, 6 once
    ids = jnp.array([2, 9, 4, 11, 9, 6, 11, -1], jnp.int32)
    out = np.asarray(unique_prioritized(ids, 2, m))
    # only 2 slots: the in-window-re-observed landmarks must win
    assert sorted(out.tolist()) == [9, 11]


def test_unique_prioritized_fill_and_sentinel():
    m = _tiny_map()
    M = m.mp_valid.shape[0]
    ids = jnp.array([4, 4, 4, -1], jnp.int32)
    out = np.asarray(unique_prioritized(ids, 3, m))
    assert out[0] == 4 and out[1] == M and out[2] == M
