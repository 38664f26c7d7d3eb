"""Single-profile device-planned assembly (ops/scan.py _planned_record /
_planned_dispatch): stream bit-equality with the host-planned path, the
reduced, segmented and full-fetch assemblies against the exact int64 host
engine, overflow fallback, and the tiny-record clamp."""

import numpy as np
import pytest

from kmergma.models.state_machine import replay_single
from kmergma.ops.kmers import kmer_count
from kmergma.ops.scan import ScanEngine


def _problem(seed, n=50_000, k=6, ws=240, r=5):
    rng = np.random.default_rng(seed)
    s = np.zeros(4**k, dtype=np.int64)
    refs = [rng.integers(0, 4, ws, dtype=np.int8) for _ in range(r)]
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(2_000, n - ws - 100, 5_000):
        mutant = refs[pos % r].copy()
        idx = rng.integers(0, ws, ws // 5)
        mutant[idx] = rng.integers(0, 4, idx.shape[0])
        codes[pos : pos + ws] = mutant
    return s, codes


def _engines(s, k, ws, r, **kw):
    # chunk >= nw/2: the planned branch only serves whole-record (non-
    # segmented) scans, i.e. nw <= 2*chunk
    planned = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=1 << 15, **kw)
    hostp = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=1 << 15, **kw)
    hostp.device_plan = False
    assert planned.device_plan
    return planned, hostp


@pytest.mark.parametrize("seed,thr_pct", [(0, 3.0), (1, 5.0)])
def test_planned_split_matches_host_planned(seed, thr_pct):
    s, codes = _problem(seed)
    planned, hostp = _engines(s, 6, 240, 5)
    d = None
    from kmergma.ops.scan_host import scan_window_distances_np_i64

    d = scan_window_distances_np_i64(codes, s, 6, 240, 5)
    thr = float(np.percentile(d / planned.scale, thr_pct))
    a = planned.record_stream(codes, thr)
    b = hostp.record_stream(codes, thr)
    assert a[:2] == b[:2]
    hits = replay_single(a[1], a[0], thr, 6, 240, codes.shape[0], 30)
    assert len(hits) > 0


def test_planned_reduced_matches_host_reduced():
    """full_fetch_windows=0 forces the run-reduce machinery on both paths:
    the minimal streams must still be identical."""
    s, codes = _problem(3)
    planned, hostp = _engines(s, 6, 240, 5)
    planned.full_fetch_windows = 0
    hostp.full_fetch_windows = 0
    from kmergma.ops.scan_host import scan_window_distances_np_i64

    d = scan_window_distances_np_i64(codes, s, 6, 240, 5)
    thr = float(np.percentile(d / planned.scale, 4.0))
    a = planned.record_stream(codes, thr)
    b = hostp.record_stream(codes, thr)
    assert a[:2] == b[:2]
    assert len(a[1]) > 0


def test_planned_overflow_falls_back_and_grows():
    s, codes = _problem(4)
    planned, hostp = _engines(s, 6, 240, 5)
    planned.plan_regions = 2
    planned.plan_regions_max = 8
    from kmergma.ops.scan_host import scan_window_distances_np_i64

    d = scan_window_distances_np_i64(codes, s, 6, 240, 5)
    thr = float(np.percentile(d / planned.scale, 4.0))
    a = planned.record_stream(codes, thr)
    b = hostp.record_stream(codes, thr)
    assert a[:2] == b[:2]
    # direct-jump growth: the bucket lands on the tier that fits the
    # record's true region count (or maxes out and disables planning)
    assert planned.plan_regions > 2


def test_planned_tiny_record_tail_clamp():
    """A record whose active tail block expands past nw must not emit an
    out-of-range region (regression: negative-limit region rows)."""
    s, codes = _problem(5, n=900, ws=240, r=5)
    planned, hostp = _engines(s, 6, 240, 5)
    # threshold high enough that the tail windows are active
    a = planned.record_stream(codes, 1e9)
    b = hostp.record_stream(codes, 1e9)
    assert a[:2] == b[:2]
    assert len(a[1]) == codes.shape[0] - 240  # every window active


def test_planned_run_slot_overflow_falls_back(monkeypatch):
    """A record with more below-runs than the fused-reduce slot bucket
    must fall back to the separate run-reduce trip - identical stream
    (dense multi-Gbp records with tens of thousands of candidates take
    this path when they exceed the production bucket).  The bucket is
    shrunk via the module global, with a UNIQUE chunk so the planned jit
    traces fresh at the patched size (the global is read at trace time
    and is not part of the jit key)."""
    import kmergma.ops.scan as S

    monkeypatch.setattr(S, "_RED_RUNS", 64)
    s, codes = _problem(6)
    planned = ScanEngine(s, k=6, ws=240, r=5, chunk_windows=3 * (1 << 13))
    hostp = ScanEngine(s, k=6, ws=240, r=5, chunk_windows=3 * (1 << 13))
    hostp.device_plan = False
    planned.full_fetch_windows = 0
    hostp.full_fetch_windows = 0
    from kmergma.ops.scan_host import scan_window_distances_np_i64

    d = scan_window_distances_np_i64(codes, s, 6, 240, 5)
    # a mid-distribution threshold yields ~400 runs >> the shrunk bucket
    thr = float(np.percentile(d / planned.scale, 45.0))
    calls = {"fallback": 0}
    real = S.ScanEngine._stream_from_reduction

    def counting(self, *a, **k):
        calls["fallback"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(S.ScanEngine, "_stream_from_reduction", counting)
    a = planned.record_stream(codes, thr)
    monkeypatch.setattr(S.ScanEngine, "_stream_from_reduction", real)
    b = hostp.record_stream(codes, thr)
    assert calls["fallback"] == 1  # the run bucket genuinely overflowed
    assert a[:2] == b[:2]
    assert len(a[1]) > 2 * 64  # the fixture has > bucket runs


def _low_complexity_problem(seed, n=40_000, k=6, ws=240, r=6):
    """References sharing a poly-A run, so max(S) >= 256."""
    rng = np.random.default_rng(seed)
    refs = []
    for _ in range(r):
        ref = rng.integers(0, 4, ws, dtype=np.int8)
        ref[20:80] = 0
        refs.append(ref)
    s = np.zeros(4**k, dtype=np.int64)
    for ref in refs:
        s += kmer_count(ref, k).astype(np.int64)
    assert s.max() >= 256
    codes = rng.integers(0, 4, n, dtype=np.int8)
    for pos in range(1_500, n - ws - 100, 4_000):
        mutant = refs[pos % r].copy()
        idx = rng.integers(0, ws, ws // 6)
        mutant[idx] = rng.integers(0, 4, idx.shape[0])
        codes[pos : pos + ws] = mutant
    return s, codes


@pytest.mark.parametrize("problem", ["random", "low_complexity"])
@pytest.mark.parametrize("mode", ["planned", "host_planned", "reduced", "segmented", "full"])
def test_assembly_modes_vs_host_engine(mode, problem):
    """Every stream assembly of the bitmap pass replays to the exact int64
    host engine's hits (full-fetch streams are element-identical)."""
    from kmergma.ops.scan_host import HostScanEngine, scan_window_distances_np_i64

    k, ws, r = 6, 240, (5 if problem == "random" else 6)
    s, codes = _problem(7) if problem == "random" else _low_complexity_problem(8)
    chunk = 1 << 13 if mode == "segmented" else 1 << 15
    eng = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=chunk)
    if mode == "host_planned":
        eng.device_plan = False
    elif mode == "reduced":
        eng.full_fetch_windows = 0
    elif mode == "full":
        eng.assemble_mode = "full"
    if mode == "segmented":
        assert codes.shape[0] - ws + 1 > 2 * eng.chunk
    host = HostScanEngine(s, k=k, ws=ws, r=r)
    d = scan_window_distances_np_i64(codes, s, k, ws, r)
    thr = float(np.percentile(d / host.scale, 4.0))
    d0_e, stream_e, _ = eng.record_stream(codes, thr)
    d0_h, stream_h, _ = host.record_stream(codes, thr)
    assert d0_e == d0_h
    n = codes.shape[0]
    hits_e = replay_single(stream_e, d0_e, thr, k, ws, n, 30)
    assert hits_e == replay_single(stream_h, d0_h, thr, k, ws, n, 30)
    assert len(hits_e) > 0
    if mode == "full":
        assert stream_e == stream_h
