"""Seeded randomized conformance campaigns, committed.

CI-budget versions of the one-off campaigns recorded in
docs/design.md ("Randomized conformance campaigns"): production engines
pinned against exact oracles across RANDOMIZED parameter shapes, so the
50/50 / 48/48 / 40/40 / 8/8 guarantees re-run automatically on every
suite run instead of living only in run logs.

Oracles:
  * engine fuzz   -> HostScanEngine (exact int64 rolling recurrence,
                     the reference's own algorithm, GenomeMiner.jl:42-77)
  * sharded fuzz  -> single-device ScanEngine (itself golden-pinned)
  * exact match   -> bytes.find (overlapping occurrences)
  * strobes       -> NumPy extraction vs the jnp device extraction
"""

import numpy as np
import pytest

from kmergma.models.state_machine import replay_single
from kmergma.ops.kmers import kmer_count
from kmergma.ops.scan import ScanEngine
from kmergma.ops.scan_host import HostScanEngine, scan_window_distances_np_i64


def _random_problem(seed: int):
    """Random (profile, codes, shape) with planted mutants so below-runs
    and rising edges exist; shapes span the supported envelope."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(4, 8))          # 4..7
    ws = int(rng.integers(60, 301))      # 60..300
    r = int(rng.integers(1, 13))         # 1..12
    n = int(rng.integers(20_000, 50_000))
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(1_500, n - ws - 100, int(rng.integers(4_000, 9_000))):
        mutant = refs[pos % r].copy()
        nmut = int(rng.integers(0, max(1, ws // 4)))
        idx = rng.integers(0, ws, nmut)
        mutant[idx] = rng.integers(0, 4, nmut)
        codes[pos : pos + ws] = mutant
    return k, ws, r, n, s, codes, rng


def _pick_thr(d: np.ndarray, scale: float, rng) -> float:
    """A threshold inside the distance distribution (some hits, not all)."""
    pct = float(rng.uniform(1.0, 6.0))
    return float(np.percentile(d / scale, pct))


@pytest.mark.parametrize("seed", range(10))
def test_engine_fuzz_vs_host_oracle(seed):
    """Production device engine vs the exact int64 host engine across
    random (k, ws, r, n, thr, chunk, depth, assembly-mode) shapes: the
    replayed hit lists must be identical (one-off campaign: 50/50)."""
    k, ws, r, n, s, codes, rng = _random_problem(seed)
    host = HostScanEngine(s, k=k, ws=ws, r=r)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = _pick_thr(d, host.scale, rng)

    chunk = 1 << int(rng.integers(12, 14))
    depth = int(rng.choice([8, 16]))
    eng = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=chunk, bound_depth=depth)
    eng.assemble_mode = str(rng.choice(["reduced", "full"]))
    if rng.integers(0, 2):
        eng.full_fetch_windows = 0  # force the reduced/words machinery

    d0_h, stream_h, _ = host.record_stream(codes, thr)
    d0_e, stream_e, _ = eng.record_stream(codes, thr)
    assert d0_e == d0_h
    buff = int(rng.integers(5, 60))
    hits_h = replay_single(stream_h, d0_h, thr, k, ws, n, buff)
    hits_e = replay_single(stream_e, d0_e, thr, k, ws, n, buff)
    assert hits_e == hits_h, (seed, k, ws, r, thr)
    assert len(hits_h) > 0  # the fixture must actually produce hits


@pytest.mark.parametrize(
    "seed,n_dev",
    [(0, 2), (1, 4), (2, 8), (3, 8), (4, 2), (5, 4), (6, 8), (7, 3),
     (8, 2), (9, 4), (10, 1), (11, 8)],
)
def test_sharded_fuzz_vs_single_device(seed, n_dev):
    """Sharded engine across 1/2/3/4/8-device meshes vs the single-device
    engine: bit-identical streams (one-off campaign: 48/48)."""
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.sharded_scan import ShardedScanEngine

    rng = np.random.default_rng(100 + seed)
    k = 6
    ws = int(rng.integers(100, 300))
    r = int(rng.integers(2, 13))
    n = int(rng.integers(25_000, 45_000))
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(1_000, n - ws - 100, 3_000):
        mutant = refs[pos % r].copy()
        idx = rng.integers(0, ws, ws // 6)
        mutant[idx] = rng.integers(0, 4, ws // 6)
        codes[pos : pos + ws] = mutant

    single = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=4096)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = _pick_thr(d, single.scale, rng)
    d0_a, stream_a, _ = single.record_stream(codes, thr)

    sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=make_mesh(n_dev), chunk_windows=2048)
    d0_b, stream_b, _ = sharded.record_stream(codes, thr)
    assert d0_b == d0_a
    assert stream_b == stream_a, (seed, n_dev)
    hits = replay_single(stream_a, d0_a, thr, k, ws, n, 20)
    assert len(hits) > 0


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.mark.parametrize("seed", range(10))
def test_exact_match_fuzz_vs_bytes_find(seed):
    """Device prefix-register exact match vs the bytes.find oracle across
    random subjects (N-bearing) and query lengths 1..40 (one-off campaign: 40/40)."""
    from kmergma.ops.exact_match import match_starts_engine, match_starts_np

    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(50_000, 200_000))
    sub = _BASES[rng.integers(0, 4, n)].tobytes()
    # sprinkle N runs (encode as code 3 like the reference, Consts.jl:22-28)
    sub = bytearray(sub)
    for _ in range(int(rng.integers(0, 5))):
        p = int(rng.integers(0, n - 10))
        ln = int(rng.integers(1, 10))
        sub[p : p + ln] = b"N" * ln
    sub = bytes(sub)

    qlen = int(rng.integers(1, 41))
    if rng.integers(0, 2):
        # planted query: slice of the subject (guaranteed occurrences)
        p = int(rng.integers(0, n - qlen))
        q = sub[p : p + qlen]
    else:
        q = _BASES[rng.integers(0, 4, qlen)].tobytes()

    # oracle: all overlapping occurrences via bytes.find
    expect, start = [], sub.find(q)
    while start != -1:
        expect.append(start)
        start = sub.find(q, start + 1)

    got_dev = match_starts_engine(sub, q).tolist()
    got_np = match_starts_np(sub, q).tolist()
    assert got_dev == expect, (seed, qlen)
    assert got_np == expect, (seed, qlen)


@pytest.mark.parametrize("seed", range(6))
def test_strobe_extraction_fuzz_host_vs_device(seed):
    """NumPy vs jnp strobe extraction across random (w_min, w_max, q)
    shapes: bit-identical codes (one-off campaign: 8/8)."""
    import jax.numpy as jnp

    from kmergma.ops.strobemers import strobe_2_mer_codes, strobe_2_mer_codes_jnp

    rng = np.random.default_rng(300 + seed)
    w_min = int(rng.integers(3, 7))
    w_max = w_min + int(rng.integers(1, 5))
    q = int(rng.integers(2, 12))
    n = int(rng.integers(5_000, 30_000))
    codes = rng.integers(0, 4, n, dtype=np.int8)
    host = strobe_2_mer_codes(codes, s=2, w_min=w_min, w_max=w_max, q=q)
    dev = np.asarray(strobe_2_mer_codes_jnp(jnp.asarray(codes), s=2, w_min=w_min, w_max=w_max, q=q))
    assert host.shape == dev.shape
    assert np.array_equal(host, dev.astype(np.int64)), (seed, w_min, w_max, q)


@pytest.mark.parametrize("seed", range(6))
def test_cluster_engine_fuzz_vs_host_oracle(seed):
    """Cluster-mode streams vs an INDEPENDENT oracle: each cluster's
    stream recomputed from the exact int64 host distances (the reference's
    own recurrence), truncated at the Omn loop bound - then both replayed
    through the Omn state machine to identical hit events."""
    from kmergma.models.state_machine import replay_omn
    from kmergma.ops.scan_cluster import ClusterScanEngine

    rng = np.random.default_rng(400 + seed)
    k = int(rng.integers(4, 7))
    m = int(rng.integers(2, 5))
    n = int(rng.integers(20_000, 40_000))

    class P:
        def __init__(self, ws, r, g):
            self.windowsize = ws
            self.n_records = r
            self.sum_kfv = np.zeros(4**k, dtype=np.int64)
            self.refs = [g.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
            for ref in self.refs:
                self.sum_kfv += kmer_count(ref, k).astype(np.int64)

    base_ws = int(rng.integers(80, 200))
    profiles = [
        P(base_ws + int(rng.integers(0, 4)), int(rng.integers(1, 6)), rng)
        for _ in range(m)
    ]
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(2_000, n - 300, int(rng.integers(3_000, 6_000))):
        src = profiles[pos % m]
        mutant = src.refs[pos % src.n_records].copy()
        idx = rng.integers(0, src.windowsize, src.windowsize // 6)
        mutant[idx] = rng.integers(0, 4, idx.shape[0])
        codes[pos : pos + src.windowsize] = mutant

    eng = ClusterScanEngine(profiles, k=k, chunk_windows=1 << 13)
    max_ws = max(p.windowsize for p in profiles)
    imax = n - max_ws - k + 2

    # thresholds from each cluster's own distance distribution
    thrs = []
    oracle = []
    for p in profiles:
        d = scan_window_distances_np_i64(codes, p.sum_kfv, k, p.windowsize, p.n_records)
        scale = 2.0 * k * p.n_records * p.n_records
        thrs.append(float(np.percentile(d / scale, float(rng.uniform(1.5, 5.0)))))
        oracle.append((d, scale))

    got = eng.record_streams(codes, thrs)

    # independent per-cluster stream from the host distances
    want = []
    for (d, scale), thr in zip(oracle, thrs):
        # the float64 comparison IS the conformance contract the engine's
        # exact integer threshold reproduces (_thr_exact)
        below = (d / scale) < thr
        below[imax + 1 :] = False  # the Omn loop bound
        mask = below.copy()
        mask[1:] |= below[:-1]
        mask[0] = False
        mask[imax + 2 :] = False
        idx = np.nonzero(mask)[0]
        want.append((float(d[0]) / scale, list(zip(idx.tolist(), (d[idx] / scale).tolist()))))

    def events(pairs):
        out = []
        replay_omn(
            [p[1] for p in pairs], [p[0] for p in pairs], thrs, k,
            [p.windowsize for p in profiles], n,
            lambda ev: out.append((ev.cluster, ev.cmi, ev.dist, ev.edge_dist)) or True,
        )
        return out

    assert [g[0] for g in got] == [w[0] for w in want]  # dist0s
    ev_got, ev_want = events(got), events(want)
    assert ev_got == ev_want, (seed, k, m)
    assert len(ev_want) > 0
