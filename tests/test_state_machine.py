"""Equivalence pins for the run-segmented replay (models/state_machine.py).

replay_single must be element-for-element equivalent to the sequential
oracle replay_single_seq on any stream the engines can emit: below-runs,
rising edges, conservative device extras (>= thr entries that are not
edges), runs at array boundaries, goal_ind suppression chains.
"""

import numpy as np
import pytest

from kmergma.models.state_machine import (
    candidate_stream_from_dists,
    replay_single,
    replay_single_seq,
)


def _assert_same(stream, dist0, thr, k=6, ws=50, seq_len=100000, buff=50, cmi_offset=None):
    a = replay_single_seq(list(stream), dist0, thr, k, ws, seq_len, buff, cmi_offset)
    b = replay_single(list(stream), dist0, thr, k, ws, seq_len, buff, cmi_offset)
    assert a == b


def test_empty_stream():
    _assert_same([], 12.0, 30.0)


def test_single_run_no_edge():
    _assert_same([(5, 10.0), (6, 9.0), (7, 11.0)], 50.0, 30.0)


def test_single_run_with_edge():
    _assert_same([(5, 10.0), (6, 9.0), (7, 31.0)], 50.0, 30.0)


def test_run_not_beating_entry_min():
    # run minimum >= dist0: no update, the edge must not emit
    _assert_same([(5, 20.0), (6, 21.0), (7, 31.0)], 10.0, 30.0)


def test_ties_keep_first_attainment():
    _assert_same([(5, 9.0), (6, 9.0), (7, 8.0), (8, 8.0), (9, 31.0)], 50.0, 30.0)


def test_goal_ind_suppression_chain():
    # two nearby runs: second edge lands inside goal_ind of the first
    stream = [(5, 9.0), (6, 31.0), (8, 7.0), (9, 31.0), (200, 6.0), (201, 31.0)]
    _assert_same(stream, 50.0, 30.0, ws=50)


def test_conservative_extras_between_runs():
    # device-threshold extras: >= thr entries that are neither below nor edges
    stream = [(3, 40.0), (5, 9.0), (6, 31.0), (10, 35.0), (11, 33.0), (300, 8.0), (301, 32.0), (400, 34.0)]
    _assert_same(stream, 50.0, 30.0)


def test_non_adjacent_indices_still_order_driven():
    # the sequential machine has NO index logic: an index gap before the
    # first >= thr element still makes that element the edge
    stream = [(5, 9.0), (100, 31.0)]
    _assert_same(stream, 50.0, 30.0)


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_random_dist_arrays(seed):
    rng = np.random.default_rng(seed)
    nw = 3000
    dists = rng.uniform(20.0, 45.0, nw)
    # plant a few deep dips of varying widths (hit shapes)
    for _ in range(rng.integers(1, 8)):
        c = int(rng.integers(10, nw - 10))
        w = int(rng.integers(1, 9))
        dists[c : c + w] = rng.uniform(5.0, 29.0, w)
    thr = 30.0
    stream = list(candidate_stream_from_dists(dists, thr))
    # inject conservative extras (the device bound is a superset)
    extra = [(int(j), float(dists[j])) for j in rng.integers(1, nw, 15) if dists[j] >= thr]
    merged = sorted(set(stream) | set(extra))
    for ws in (20, 120):
        _assert_same(merged, float(dists[0]), thr, ws=ws, seq_len=nw + 300, buff=50)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_dense_subthreshold(seed):
    # hit-dense shape: long below-runs with rough interiors
    rng = np.random.default_rng(100 + seed)
    nw = 5000
    dists = rng.uniform(29.0, 33.0, nw)  # straddles thr densely
    thr = 31.0
    stream = list(candidate_stream_from_dists(dists, thr))
    _assert_same(stream, float(dists[0]), thr, ws=60, seq_len=nw + 300)


def test_strobe_cmi_offset():
    _assert_same([(5, 9.0), (6, 31.0)], 50.0, 30.0, cmi_offset=0)
