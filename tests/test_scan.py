"""Scan-op correctness: the parallel exact-integer formulation must equal the
brute-force per-window spectrum distance (the reference's definition,
GenomeMiner.jl:46-47) on random data, and the candidate-stream machinery
must be exact across tile boundaries."""

import numpy as np
import pytest

from kmergma.models.state_machine import candidate_stream_from_dists, replay_single
from kmergma.ops.scan import (
    ScanEngine,
    check_int32_headroom,
    scan_window_distances,
    scan_window_distances_np,
)


@pytest.mark.parametrize("n,k,ws,r", [(600, 6, 289, 84), (400, 4, 97, 7), (2000, 6, 289, 84)])
def test_scan_matches_bruteforce(n, k, ws, r):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 40, 4**k).astype(np.int32)
    expected = scan_window_distances_np(codes, s, k, ws, r)
    import jax.numpy as jnp

    got = np.asarray(scan_window_distances(jnp.asarray(codes), jnp.asarray(s), k, ws, r))
    assert got.tolist() == expected.tolist()


def test_engine_stream_matches_full_replay():
    rng = np.random.default_rng(7)
    n, k, ws, r = 5000, 6, 289, 12
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)

    d_full = scan_window_distances_np(codes, s, k, ws, r) / (2.0 * k * r * r)
    thr = float(np.percentile(d_full, 5))  # force several sub-threshold runs

    engine = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=1024)  # multiple tiles
    dist0, stream, _ = engine.record_stream(codes, thr)
    assert dist0 == d_full[0]

    hits_stream = replay_single(stream, dist0, thr, k, ws, n, buff=10)
    hits_full = replay_single(
        candidate_stream_from_dists(d_full, thr), d_full[0], thr, k, ws, n, buff=10
    )
    assert [(h.cmi, h.dist, h.start, h.stop) for h in hits_stream] == [
        (h.cmi, h.dist, h.start, h.stop) for h in hits_full
    ]
    assert len(hits_stream) > 0


def test_engine_collect_dists_exact():
    rng = np.random.default_rng(3)
    n, k, ws, r = 3000, 6, 289, 5
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 6, 4**k).astype(np.int32)
    engine = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=1024)
    _, _, dists = engine.record_stream(codes, thr=10.0, collect_dists=True)
    expected = scan_window_distances_np(codes, s, k, ws, r) / (2.0 * k * r * r)
    assert dists.tolist() == expected.tolist()


def test_headroom_guard():
    s = np.full(4096, 10**5, dtype=np.int64)
    with pytest.raises(OverflowError):
        check_int32_headroom(s, ws=289, k=6, r=10**4)


def test_segmented_pipeline_matches_single_transfer():
    """Long records take the pipelined per-segment transfer+compute path
    (transfer-compute overlap); streams must be bit-identical to the
    whole-record single-transfer path."""
    import numpy as np
    from kmergma.ops.scan import ScanEngine

    rng = np.random.default_rng(21)
    k, ws, r = 6, 289, 12
    codes = rng.integers(0, 4, 70000, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)
    eng = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=8192)
    _, probe, _ = eng.record_stream(codes, thr=1e9, codes_dev=eng.prepare_codes(codes))
    thr = float(np.percentile([v for _, v in probe], 5))

    # explicit prep -> single-transfer path; no prep + nw > 2*chunk -> segmented
    d0_a, stream_a, _ = eng.record_stream(codes, thr, codes_dev=eng.prepare_codes(codes))
    assert codes.shape[0] - ws + 1 > 2 * eng.chunk
    d0_b, stream_b, _ = eng.record_stream(codes, thr)
    assert d0_a == d0_b
    assert stream_a == stream_b


import pytest as _pytest


@_pytest.mark.parametrize("k,ws,r,n,seed", [
    (3, 20, 1, 3000, 0),
    (4, 33, 2, 5000, 1),
    (5, 64, 7, 8000, 2),
    (6, 289, 84, 12000, 3),
    (7, 150, 3, 9000, 4),
    (2, 9, 5, 700, 5),
])
def test_engine_stream_fuzz_vs_oracle(k, ws, r, n, seed):
    """Engine candidate streams vs the brute-force oracle across parameter
    shapes (k, ws, r) - the reference test strategy's golden-vector idea
    extended to randomized conformance."""
    import numpy as np
    from kmergma.models.state_machine import candidate_stream_from_dists, replay_single
    from kmergma.ops.scan import ScanEngine, scan_window_distances_np

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 3 * r, 4**k).astype(np.int64)
    scale = 2.0 * k * r * r
    d = scan_window_distances_np(codes, s, k, ws, r).astype(np.float64) / scale
    thr = float(np.percentile(d, 3))

    eng = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=2048)
    d0, stream, _ = eng.record_stream(codes, thr)
    assert d0 == d[0]
    expected = replay_single(candidate_stream_from_dists(d, thr), d[0], thr, k, ws, n, buff=7)
    got = replay_single(stream, d0, thr, k, ws, n, buff=7)
    assert [(h.cmi, h.dist, h.start, h.stop) for h in got] == [
        (h.cmi, h.dist, h.start, h.stop) for h in expected
    ]
    # below-threshold stream values are the exact distances
    below = {j: v for j, v in stream if v < thr}
    for j, v in below.items():
        assert v == d[j]


def test_bitmap_pack_roundtrip():
    """Device bit-pack / host unpack of activity bitmaps is exact for
    non-multiple-of-32 block counts (the D2H compression path)."""
    import numpy as np

    from kmergma.ops.scan import _pack_bitmap_words, _unpack_bitmap_words

    rng = np.random.default_rng(0)
    for nb in (1, 31, 32, 33, 1000, 4096):
        bits = rng.integers(0, 2, nb).astype(np.int32)
        words = np.asarray(_pack_bitmap_words(bits))
        got = _unpack_bitmap_words(words, nb)
        assert got.tolist() == bits.astype(bool).tolist(), nb


def test_bound_below_exact_and_tight_at_full_depth():
    """Certified partial-depth lower bounds: L <= D always, equality at
    depth = W - 1."""
    import jax.numpy as jnp

    from kmergma.ops.scan import scan_window_lower_bounds

    rng = np.random.default_rng(11)
    n, k, ws, r = 2500, 6, 289, 84
    w = ws - k + 1
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 40, 4**k).astype(np.int32)
    d = np.asarray(scan_window_distances(jnp.asarray(codes), jnp.asarray(s), k, ws, r))
    for depth in (1, 8, 32):
        lb = np.asarray(
            scan_window_lower_bounds(jnp.asarray(codes), jnp.asarray(s), k, ws, r, depth)
        )
        assert (lb <= d).all()
    full = np.asarray(
        scan_window_lower_bounds(jnp.asarray(codes), jnp.asarray(s), k, ws, r, w - 1)
    )
    assert full.tolist() == d.tolist()


@pytest.mark.parametrize("n,k,ws", [(3000, 6, 289), (1000, 4, 97)])
@pytest.mark.parametrize("depth", [None, 1, 4, 16, 32, "w-1"])
def test_bitmap_pass_vs_bruteforce(n, k, ws, depth):
    """The span pass of the bitmap scan (_scan_span_bound) against the
    brute-force oracle: exact distances (depth None) equal it, certified
    bounds never exceed it and equal it at full depth w - 1."""
    import jax.numpy as jnp

    from kmergma.ops.scan import _scan_span_bound

    rng = np.random.default_rng(n + k)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 40, 4**k).astype(np.int32)
    r = 17
    want = scan_window_distances_np(codes, s, k, ws, r)
    if depth == "w-1":
        depth = ws - k
    got = np.asarray(_scan_span_bound(jnp.asarray(codes), jnp.asarray(s), k, ws, r, depth))
    if depth is None or depth == ws - k:
        assert got.tolist() == want.tolist()
    else:
        assert (got <= want).all()
        assert got[0] <= want[0]


@pytest.mark.parametrize("depth", [1, 16, None])
def test_engine_bound_path_stream_exact(depth):
    rng = np.random.default_rng(3)
    n, k, ws, r = 6000, 6, 289, 12
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)
    d_full = scan_window_distances_np(codes, s, k, ws, r) / (2.0 * k * r * r)
    thr = float(np.percentile(d_full, 5))

    exact = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=1024, bound_depth=None)
    bound = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=1024, bound_depth=depth)
    d0_e, stream_e, _ = exact.record_stream(codes, thr)
    d0_b, stream_b, _ = bound.record_stream(codes, thr)
    assert d0_e == d0_b == d_full[0]
    assert stream_e == stream_b
    assert len(stream_e) > 0


def test_scan_rows_d_matches_per_row_oracle():
    """The batched region recompute (_scan_rows_d - the hit-dense hot
    path) equals the brute-force oracle on every row."""
    import jax
    import jax.numpy as jnp

    from kmergma.ops.scan import _scan_rows_d

    rng = np.random.default_rng(21)
    k, ws, r, rspan, n_rows = 5, 101, 9, 256, 5
    s = rng.integers(0, 12, 4**k).astype(np.int32)
    rows = rng.integers(0, 4, (n_rows, rspan + ws - 1), dtype=np.int8)
    got = np.asarray(
        jax.jit(_scan_rows_d, static_argnums=(2, 3, 4))(jnp.asarray(rows), jnp.asarray(s), k, ws, r)
    )
    for i in range(n_rows):
        want = scan_window_distances_np(rows[i], s, k, ws, r)
        assert got[i].tolist() == want.tolist(), f"row {i}"
