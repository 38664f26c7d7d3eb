"""Regression tests for scan boundary conditions: candidates at the very
end of a record must not be misattributed by region-slice clamping."""

import numpy as np

from kmergma.models.state_machine import candidate_stream_from_dists, replay_single
from kmergma.ops.scan import ScanEngine, scan_window_distances_np


def _oracle_stream(codes, s, k, ws, r, thr_scaled):
    d = scan_window_distances_np(codes, s, k, ws, r).astype(np.float64)
    scale = 2.0 * k * r * r
    return d[0] / scale, list(candidate_stream_from_dists(d / scale, thr_scaled / scale))


def test_candidates_at_record_end():
    """Force sub-threshold windows in the last few windows of the record
    (worst case for region fetch-back near nw)."""
    rng = np.random.default_rng(3)
    k, ws, r = 6, 97, 5
    motif = rng.integers(0, 4, ws, dtype=np.int8)
    n = 3000
    codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[n - ws :] = motif  # strong match ending exactly at the last window
    from kmergma.ops.kmers import rolling_kmer_codes

    # profile = r * spectrum of the motif (so the final window distance = 0)
    spec = (np.bincount(rolling_kmer_codes(motif, k), minlength=4**k) * r).astype(np.int64)

    engine = ScanEngine(spec, k=k, ws=ws, r=r, chunk_windows=1024)
    thr = 5.0
    d0, stream, _ = engine.record_stream(codes, thr)

    scale = 2.0 * k * r * r
    d_full = scan_window_distances_np(codes, spec, k, ws, r).astype(np.float64) / scale
    expected = replay_single(
        candidate_stream_from_dists(d_full, thr), d_full[0], thr, k, ws, n, buff=5
    )
    got = replay_single(stream, d0, thr, k, ws, n, buff=5)
    assert [(h.cmi, h.dist) for h in got] == [(h.cmi, h.dist) for h in expected]
    # the terminal run is truncated by the record end (no rising edge), so
    # verify the stream itself contains the final below-threshold windows
    last_below = [j for j, v in stream if v < thr]
    assert last_below and max(last_below) == n - ws  # last window index


def test_candidate_exactly_at_span_boundary():
    rng = np.random.default_rng(9)
    k, ws, r = 6, 97, 4
    motif = rng.integers(0, 4, ws, dtype=np.int8)
    n = 4000
    chunk = 1024
    codes = rng.integers(0, 4, n, dtype=np.int8)
    # place a match so its window minimum lands exactly at window index 1024
    codes[chunk : chunk + ws] = motif
    from kmergma.ops.kmers import rolling_kmer_codes

    spec = (np.bincount(rolling_kmer_codes(motif, k), minlength=4**k) * r).astype(np.int64)
    engine = ScanEngine(spec, k=k, ws=ws, r=r, chunk_windows=chunk)
    thr = 5.0
    d0, stream, _ = engine.record_stream(codes, thr)

    scale = 2.0 * k * r * r
    d_full = scan_window_distances_np(codes, spec, k, ws, r).astype(np.float64) / scale
    expected = replay_single(
        candidate_stream_from_dists(d_full, thr), d_full[0], thr, k, ws, n, buff=5
    )
    got = replay_single(stream, d0, thr, k, ws, n, buff=5)
    assert [(h.cmi, h.dist) for h in got] == [(h.cmi, h.dist) for h in expected]
    assert len(got) == 1


def test_segment_boundary_straddling_hit(ref_fasta):
    """A planted gene straddling the segmented pipeline's segment boundary
    must produce the identical stream and hits as the single-transfer path."""
    import numpy as np

    from kmergma.models.state_machine import replay_single
    from kmergma.ops.reference import gen_ref_ws_cons
    from kmergma.ops.scan import ScanEngine
    from kmergma.utils.fasta import as_records

    profile = gen_ref_ws_cons(ref_fasta, 6)
    k, ws = profile.k, profile.windowsize
    eng = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records, chunk_windows=8192)
    seg = 2 * eng.chunk  # segment length in windows

    rng = np.random.default_rng(13)
    n = 3 * seg + ws
    codes = rng.integers(0, 4, n, dtype=np.int8)
    gene = as_records(ref_fasta)[0].codes
    # straddle the first segment boundary, and place one mid-segment too
    for pos in (seg - gene.shape[0] // 2, seg + seg // 2):
        codes[pos : pos + gene.shape[0]] = gene

    d0_a, stream_a, _ = eng.record_stream(codes, 30.0, codes_dev=eng.prepare_codes(codes))
    d0_b, stream_b, _ = eng.record_stream(codes, 30.0)  # segmented
    assert d0_a == d0_b
    assert stream_a == stream_b
    hits = replay_single(stream_b, d0_b, 30.0, k, ws, n, buff=50)
    # the straddling plant must be found, with its minimum near the boundary
    assert hits and abs(hits[0].cmi - (seg - gene.shape[0] // 2)) < ws


def test_below_runs_straddle_region_boundaries():
    """Below-threshold runs crossing region boundaries (regions tile runs of
    active blocks at rspan windows) must replay identically to the oracle -
    including the run-continuation flag between ADJACENT regions and the
    gap between separate runs."""
    rng = np.random.default_rng(17)
    k, ws, r = 5, 64, 4
    n = 12000
    codes = rng.integers(0, 4, n, dtype=np.int8)
    # plant several wide near-profile stretches so runs span > rspan windows
    from kmergma.ops.kmers import kmer_count

    motif = rng.integers(0, 4, ws, dtype=np.int8)
    s = (r * kmer_count(motif, k)).astype(np.int64)
    for start in (2000, 2600, 7000):
        codes[start : start + 400] = np.tile(motif, 7)[:400]

    eng = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=2048)
    eng.rspan = 128  # force many tiny regions; runs straddle several
    eng.block = 64
    d = scan_window_distances_np(codes, s, k, ws, r)
    thr_scaled = float(np.percentile(d, 8))
    thr = thr_scaled / eng.scale
    d0_o, st_o = _oracle_stream(codes, s, k, ws, r, thr_scaled)
    eng.assemble_mode = "full"
    d0_e, st_e, _ = eng.record_stream(codes, thr)
    assert d0_e == d0_o
    # the full-mode engine stream is a SUPERSET (conservative device
    # threshold) with exact values: every oracle below-threshold entry must
    # appear verbatim
    got = dict(st_e)
    for j, v in st_o:
        if v < thr:
            assert got.get(j) == v, (j, v, got.get(j))
    # and the minima replay is bit-identical (the actual contract)
    h_o = replay_single(st_o, d0_o, thr, k, ws, n, 50)
    h_e = replay_single(st_e, d0_e, thr, k, ws, n, 50)
    assert h_e == h_o and len(h_e) > 0

    # the production REDUCED stream (run minima + edges only) replays
    # bit-identically through the same straddling-run structure
    eng.assemble_mode = "reduced"
    d0_r, st_r, _ = eng.record_stream(codes, thr)
    assert d0_r == d0_o
    h_r = replay_single(st_r, d0_r, thr, k, ws, n, 50)
    assert h_r == h_o
