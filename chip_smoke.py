"""On-card smoke test of the scan path: goldens, real-size conformance, timing.

Run from the repository root on a machine with NVIDIA GPUs:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

One card runs, in one process:

  1. goldens: ``find_genes`` on Alp_V_locus.fasta (3 hits), the Loci.fasta
     hit loci, and the cluster-mode golden;
  2. single profile: ``find_genes`` with alignment over a seeded 512 Mbp
     FASTA (records of 256, 192 and 64 Mbp, the 84 reference genes planted
     every 5 Mbp) against the exact int64 host engine, and every planted
     gene covered by a hit or, where the reference's minima machine carries
     a lower minimum into it, found by that machine started afresh;
  3. cluster mode (m=6) on the 64 Mbp record against an int64 host oracle;
  4. strobemer: device extraction against host extraction on the 64 Mbp
     record, and against the sequential NumPy oracle on a 4 Mbp slice;
  5. exact match over the 256 Mbp record against ``bytes.find``, and the
     device aligner against the native DP on windows around planted genes;
  6. timing: the median of 5 ``find_genes`` runs, the bitmap pass's time,
     share and kernels per span, a span-size sweep, set-up seconds and peak
     device memory.

Every device result is an integer, so every comparison is bit-exact.  A
phase that fails raises, and the script exits non-zero; it also exits
non-zero when JAX finds no GPU.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
REF = os.path.join(DATA, "Alp_V_ref.fasta")
LOCUS = os.path.join(DATA, "Alp_V_locus.fasta")
LOCI = os.path.join(DATA, "Loci.fasta")

GENOME_MBP = (256, 192, 64)
PLANT_SPACING = 5_000_000
CLUSTER_CUTOFFS = [7, 12, 20, 25]
SPAN_SWEEP = tuple(1 << e for e in range(19, 24))
EXACT_QUERY = "CACAGTG"

GOLDEN_HITS = [
    "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
    "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
    "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
]
GOLDEN_LOCI = [8543, 20425, 221912, 234018, 450875, 467930, 477868]
GOLDEN_CLUSTER_THRS = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
GOLDEN_CLUSTER_HITS = [
    "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
    "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
    "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them (a
    subprocess that stays off JAX)."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else f"nvidia-smi rc={out.returncode}"


CARD = "not queried"


def report(phase: str, **fields) -> None:
    """One line per phase: its numbers, and the card they were taken on."""
    print(json.dumps({"phase": phase, **fields, "card": CARD}), flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _hit_pairs(hits) -> list:
    return [(h.description, h.seq) for h in hits]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def make_genome(sizes_bp, seed: int, spacing: int):
    """Seeded random records with the reference genes planted every
    ``spacing`` bp (cycling through the reference set).

    Returns (records, planted) where ``records`` is a list of FastaRecord
    and ``planted`` a list of (record index, 0-based start, length)."""
    from kmergma.utils.fasta import FastaRecord, as_records

    genes = [r.seq.upper() for r in as_records(REF)]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    records, planted = [], []
    gi = 0
    for ri, n in enumerate(sizes_bp):
        rng = np.random.default_rng(seed + ri)
        seq = bases[rng.integers(0, 4, n, dtype=np.int8)]
        for pos in range(spacing // 2, n - 2_000, spacing):
            g = np.frombuffer(genes[gi % len(genes)], dtype=np.uint8)
            gi += 1
            seq[pos : pos + g.shape[0]] = g
            planted.append((ri, pos, g.shape[0]))
        records.append(FastaRecord(f"chr{ri + 1} seeded random, seed {seed + ri}", seq.tobytes()))
    return records, planted


def write_fasta_file(path: str, records, width: int = 100) -> None:
    """Write records as FASTA with ``width``-column sequence lines."""
    with open(path, "wb") as fh:
        for rec in records:
            fh.write(b">" + rec.description.encode() + b"\n")
            seq = np.frombuffer(rec.seq, dtype=np.uint8)
            full = seq.shape[0] // width
            body = np.empty((full, width + 1), dtype=np.uint8)
            body[:, :width] = seq[: full * width].reshape(full, width)
            body[:, width] = ord("\n")
            fh.write(body.tobytes())
            if seq.shape[0] > full * width:
                fh.write(seq[full * width :].tobytes() + b"\n")


# --------------------------------------------------------------------------
# phases (no device checks in here: they run at any size on any backend)
# --------------------------------------------------------------------------


def phase_goldens() -> dict:
    import kmergma as km

    t0 = time.perf_counter()
    hits = km.find_genes(genome_path=LOCUS, ref_path=REF, verbose=False)[0]
    _check([h.description for h in hits] == GOLDEN_HITS, "find_genes golden hits differ")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # explicit threshold below the estimate warns
        loci = km.find_genes(
            genome_path=LOCI, ref_path=REF, kmer_dist_thr=30,
            do_return_hit_loci=True, verbose=False,
        )[1]
    _check(loci == GOLDEN_LOCI, f"Loci.fasta hit loci {loci} != golden")
    chits = km.find_genes_cluster_mode(
        genome_path=LOCUS, ref_path=REF, kmer_dist_thrs=GOLDEN_CLUSTER_THRS,
        buffer=100, verbose=False,
    )[0]
    _check([h.description for h in chits] == GOLDEN_CLUSTER_HITS, "cluster golden hits differ")
    return {"hits": len(hits), "loci": len(loci), "cluster_hits": len(chits),
            "seconds": time.perf_counter() - t0}


def phase_single(fasta: str, planted) -> dict:
    """find_genes (alignment on) against the exact int64 host engine."""
    import kmergma as km
    from kmergma.models.miner import mine_genome
    from kmergma.models.state_machine import replay_single
    from kmergma.ops.reference import gen_ref_ws_cons
    from kmergma.ops.scan_host import HostScanEngine
    from kmergma.ops.thresholds import estimate_optimal_threshold
    from kmergma.utils.fasta import as_records

    t0 = time.perf_counter()
    hits, loci = km.find_genes(genome_path=fasta, ref_path=REF, do_return_hit_loci=True, verbose=False)
    first_s = time.perf_counter() - t0

    profile = gen_ref_ws_cons(REF, 6)
    thr = estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0)
    host = HostScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records)
    want = mine_genome(fasta, profile, thr=thr, get_hit_loci=True, engine=host)
    _check(_hit_pairs(hits) == _hit_pairs(want.hits), "find_genes hits differ from the int64 host engine")
    _check(loci == want.hit_loci, "find_genes hit loci differ from the int64 host engine")

    # planted-gene coverage.  A gene with a window below the threshold can
    # still get no hit: the reference's minima machine keeps its running
    # minimum after a rising edge it suppresses (one within ws of the last
    # hit), so a later gene must beat that carried minimum.  Every gene the
    # hits miss must therefore be found by the same machine started afresh
    # ws before the gene; any other miss fails the phase.
    recs = as_records(fasta)
    offsets = np.cumsum([0] + [len(r) for r in recs])
    spans = [(lo, lo + int(h.description.rsplit("Len = ", 1)[1]) - 1) for lo, h in zip(loci, hits)]
    ws = profile.windowsize
    uncovered = []
    for ri, pos, ln in planted:
        g0 = offsets[ri] + pos + 1
        if any(a <= g0 + ln - 1 and b >= g0 for a, b in spans):
            continue
        lo = max(0, pos - ws)
        piece = recs[ri].codes[lo : pos + ln + ws]
        dist0, stream, _ = host.record_stream(piece, thr)
        fresh = replay_single(stream, dist0, thr, k=6, ws=ws, seq_len=len(piece), buff=50)
        _check(any(h.start <= pos - lo + ln and h.stop > pos - lo for h in fresh),
               f"planted gene at record {ri}, {pos} gets no hit even from a fresh minima machine")
        best = min(d for _, d in stream) if stream else dist0
        uncovered.append((ri, pos, round(best, 2)))
    return {"hits": len(hits), "planted": len(planted), "covered": len(planted) - len(uncovered),
            "uncovered": uncovered, "thr": thr, "first_call_s": first_s}


class HostClusterOracle:
    """Cluster-mode streams from the exact int64 host distances: every
    below-threshold window and its rising edge, cut at the Omn loop bound
    (the oracle of tests/test_conformance_fuzz.py)."""

    def __init__(self, profiles, k: int):
        from kmergma.ops.scan_host import HostScanEngine

        self.k = k
        self.max_ws = max(p.windowsize for p in profiles)
        self.hosts = [HostScanEngine(p.sum_kfv, k=k, ws=p.windowsize, r=p.n_records) for p in profiles]

    def prepare_codes(self, codes):
        return None

    def record_streams(self, codes, thrs, codes_dev=None, seg_tracker=None):
        n = codes.shape[0]
        imax = n - self.max_ws - self.k + 2
        out = []
        for host, thr in zip(self.hosts, thrs):
            d = host._dists(np.asarray(codes, dtype=np.int8))
            below = (d / host.scale) < thr
            below[imax + 1 :] = False
            mask = below.copy()
            mask[1:] |= below[:-1]
            mask[0] = False
            mask[imax + 2 :] = False
            idx = np.nonzero(mask)[0]
            out.append((float(d[0]) / host.scale, list(zip(idx.tolist(), (d[idx] / host.scale).tolist()))))
        return out


def phase_cluster(fasta: str) -> dict:
    """find_genes_cluster_mode (m=6) against the int64 host oracle: hits
    through the public API, and the engine's streams replayed."""
    import kmergma as km
    from kmergma.models.omn_miner import mine_genome_clusters
    from kmergma.models.state_machine import replay_omn
    from kmergma.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma.ops.scan_cluster import ClusterScanEngine
    from kmergma.ops.thresholds import estimate_optimal_thresholds
    from kmergma.utils.fasta import as_records

    t0 = time.perf_counter()
    hits, loci = km.find_genes_cluster_mode(
        genome_path=fasta, ref_path=REF, cluster_cutoffs=CLUSTER_CUTOFFS,
        do_return_hit_loci=True, verbose=False,
    )
    api_s = time.perf_counter() - t0
    clusters = eliminate_null_params(cluster_ref_api(REF, 6, cutoffs=CLUSTER_CUTOFFS))
    profiles = clusters.profiles
    thrs = list(map(float, estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=7.0)))
    oracle = HostClusterOracle(profiles, 6)
    want = mine_genome_clusters(fasta, profiles, thr_vec=thrs, buff=100, gap_open=-200,
                                engine=oracle, get_hit_loci=True)
    _check(_hit_pairs(hits) == _hit_pairs(want.hits), "cluster-mode hits differ from the int64 host oracle")
    _check(loci == want.hit_loci, "cluster-mode hit loci differ from the int64 host oracle")

    wss = [p.windowsize for p in profiles]
    n_events = 0
    for rec in as_records(fasta):
        got = ClusterScanEngine(profiles, k=6).record_streams(rec.codes, thrs)
        ref = oracle.record_streams(rec.codes, thrs)
        _check([g[0] for g in got] == [r[0] for r in ref], "cluster dist0s differ from the oracle")

        def events(pairs):
            out = []
            replay_omn([p[1] for p in pairs], [p[0] for p in pairs], thrs, 6, wss, len(rec),
                       lambda ev: out.append((ev.cluster, ev.cmi, ev.dist, ev.edge_dist)) or True)
            return out

        ev = events(got)
        _check(ev == events(ref), "cluster streams replay differently from the oracle")
        n_events += len(ev)
    return {"m": len(profiles), "hits": len(hits), "events": n_events, "api_s": api_s}


def phase_strobe(fasta: str, slice_bp: int) -> dict:
    """strobemer_find_genes against host extraction, and on the first
    ``slice_bp`` of the first record against the sequential NumPy oracle."""
    import kmergma as km
    from kmergma.models.miner import fmt_dist
    from kmergma.models.state_machine import candidate_stream_from_dists, replay_single
    from kmergma.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma.ops.scan_strobe import strobe_scan_distances_np
    from kmergma.utils.fasta import FastaRecord, as_records

    thr = 30.0
    t0 = time.perf_counter()
    hits, loci = km.strobemer_find_genes(
        genome_path=fasta, ref_path=REF, kmer_dist_thr=thr, do_return_hit_loci=True, verbose=False,
    )
    api_s = time.perf_counter() - t0
    prof = gen_strobe_ref_ws_cons(REF)
    host = strobe_mine_genome(fasta, prof, thr=thr, get_hit_loci=True, device_extract=False)
    _check(_hit_pairs(hits) == _hit_pairs(host.hits), "strobemer hits differ from host extraction")
    _check(loci == host.hit_loci, "strobemer hit loci differ from host extraction")

    rec = as_records(fasta)[0]
    piece = FastaRecord(rec.identifier, rec.seq[:slice_bp])
    dev = strobe_mine_genome([piece], prof, thr=thr, do_align=False, device_extract=True)
    d = strobe_scan_distances_np(piece.codes, prof.sum_kfv, prof.s, prof.w_min, prof.w_max,
                                 prof.q, prof.windowsize, prof.n_records)
    dists = d.astype(np.float64) / (2.0 * prof.k * prof.n_records**2)
    raw = replay_single(candidate_stream_from_dists(dists, thr), float(dists[0]), thr,
                        k=prof.k, ws=prof.windowsize, seq_len=len(piece), buff=50, cmi_offset=0)
    want = [
        f"{piece.identifier} | dist = {fmt_dist(h.dist)} | MatchPos = {h.start}:{h.stop}"
        f" | GenomePos = 0 | Len = {h.stop - h.start + 1}"
        for h in raw
    ]
    _check([h.description for h in dev.hits] == want, "strobemer slice hits differ from the NumPy oracle")
    return {"hits": len(hits), "slice_bp": slice_bp, "slice_hits": len(want), "api_s": api_s}


def phase_exact(seq: bytes) -> dict:
    """km.exact_match over one record against overlapping bytes.find."""
    import kmergma as km

    q = EXACT_QUERY.encode()
    want, at = [], seq.find(q)
    while at != -1:
        want.append(at + 1)
        at = seq.find(q, at + 1)
    t0 = time.perf_counter()
    got = km.exact_match(EXACT_QUERY, seq) or []
    s = time.perf_counter() - t0
    _check([a for a, _ in got] == want, "exact_match starts differ from bytes.find")
    return {"query": EXACT_QUERY, "bp": len(seq), "matches": len(want), "seconds": s}


def phase_align_device(records, planted) -> dict:
    """The device aligner (ops/align_device.py, reachable with
    KMERGMA_ALIGN_DEVICE=1) against the production native DP, on hit-shaped
    windows (the consensus window plus the buffer) around planted genes."""
    from kmergma.ops.align import align_hits_batch
    from kmergma.ops.align_device import semiglobal_align_device
    from kmergma.ops.reference import gen_ref_ws_cons
    from kmergma.utils.native import get_lib

    _check(get_lib() is not None, "the native DP did not build")
    profile = gen_ref_ws_cons(REF, 6)
    ws, q = profile.windowsize, profile.consensus_ws
    windows = [records[ri].seq[max(0, pos - 50) : pos + ws + 50].decode().upper() for ri, pos, _ in planted]
    t0 = time.perf_counter()
    native = align_hits_batch(q, windows)
    native_s = time.perf_counter() - t0
    semiglobal_align_device(q, windows, -69, -1)  # compile
    t0 = time.perf_counter()
    dev = semiglobal_align_device(q, windows, -69, -1)
    dev_s = time.perf_counter() - t0
    _check([(a.score, a.cigar_runs) for a in dev] == [(a.score, a.cigar_runs) for a in native],
           "device alignments differ from the native DP")
    return {"windows": len(windows), "native_s": native_s, "device_s": dev_s}


def phase_timing(fasta: str, total_bp: int, first_call_s: float, repeats: int = 5) -> dict:
    """Median find_genes wall time (alignment on) after the warm-up call."""
    import kmergma as km

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        km.find_genes(genome_path=fasta, ref_path=REF, verbose=False)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"runs_s": times, "median_s": med, "mbp_per_s": total_bp / med / 1e6,
            "setup_s": first_call_s - med}


def _bitmap_inputs(records):
    import jax.numpy as jnp

    from kmergma.ops.reference import gen_ref_ws_cons
    from kmergma.ops.scan import ScanEngine

    profile = gen_ref_ws_cons(REF, 6)
    eng = ScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records)
    thr_dev = jnp.asarray(np.asarray([eng._thr_int(30.0)], dtype=np.int32))
    preps = [(eng.prepare_codes(r.codes), eng._nv(len(r) - eng.ws + 1)) for r in records]
    return eng, thr_dev, preps


def _run_bitmaps(eng, thr_dev, preps):
    from kmergma.ops.scan import _scan_record_bitmaps

    outs = [
        _scan_record_bitmaps(
            prep.dev, nv, eng.s_dev, thr_dev, k=eng.k, ws=eng.ws, r=eng.r,
            span=eng.chunk, block=eng.block, n_spans=prep.n_spans, depth=eng.bound_depth,
        )
        for prep, nv in preps
    ]
    for o in outs:
        o.block_until_ready()


def device_kernel_stats(trace_dir: str) -> dict:
    """Kernel events and busy time on the first GPU plane of a trace."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    _check(bool(paths), "profiler wrote no trace")
    pd = ProfileData.from_file(paths[0])
    gpu = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    _check(bool(gpu), f"no GPU plane in the trace: {[p.name for p in pd.planes]}")
    plane = sorted(gpu, key=lambda p: p.name)[0]
    lines = {}
    intervals = []
    for line in plane.lines:
        evs = list(line.events)
        lines[line.name] = len(evs)
        if line.name.startswith("Stream"):
            intervals += [(e.start_ns, e.start_ns + e.duration_ns) for e in evs]
    intervals.sort()
    busy, end = 0.0, -1.0
    for a, b in intervals:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    return {"kernels": len(intervals), "lines": lines, "busy_ns": busy, "window_ns": window}


def phase_bitmap(records, find_genes_s: float, repeats: int = 5) -> dict:
    """The bitmap pass alone (block_until_ready) over every record, its
    share of find_genes, and device kernels per span from one trace."""
    import jax

    eng, thr_dev, preps = _bitmap_inputs(records)
    _run_bitmaps(eng, thr_dev, preps)  # compile
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _run_bitmaps(eng, thr_dev, preps)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    out = {"span": eng.chunk, "median_s": med, "share_of_find_genes": med / find_genes_s}
    n_spans = sum(p.n_spans for p, _ in preps)
    with tempfile.TemporaryDirectory() as td:
        jax.profiler.start_trace(td)
        _run_bitmaps(eng, thr_dev, preps)
        jax.profiler.stop_trace()
        stats = device_kernel_stats(td)
    out.update(kernels=stats["kernels"], spans=n_spans, kernels_per_span=stats["kernels"] / n_spans,
               busy_share=stats["busy_ns"] / stats["window_ns"] if stats["window_ns"] else 0.0,
               trace_lines=stats["lines"])
    return out


def phase_span_sweep(records, spans, repeats: int = 2) -> dict:
    """mine_genome (alignment on) over the parsed records at each span size."""
    from kmergma.models.miner import mine_genome
    from kmergma.ops.reference import gen_ref_ws_cons
    from kmergma.ops.scan import ScanEngine
    from kmergma.ops.thresholds import estimate_optimal_threshold

    profile = gen_ref_ws_cons(REF, 6)
    thr = estimate_optimal_threshold(profile.mean_kfv, profile.windowsize, buffer=8.0)
    total = sum(len(r) for r in records)
    out = {}
    for span in spans:
        eng = ScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
                         chunk_windows=span)
        t0 = time.perf_counter()
        mine_genome(records, profile, thr=thr, engine=eng)
        first = time.perf_counter() - t0
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            mine_genome(records, profile, thr=thr, engine=eng)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        out[str(span)] = {"first_s": first, "median_s": med, "mbp_per_s": total / med / 1e6}
    return out


def phase_four(fasta: str, n_dev: int) -> dict:
    """Sharded find_genes / cluster mode against one card, and the
    profile-sharded k=10 engine against the int64 host engine."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import kmergma as km
    from kmergma.models.state_machine import replay_single
    from kmergma.ops.kmers import kmer_count
    from kmergma.ops.scan_host import HostScanEngine
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.tp_lookup import TPScanEngine

    mesh = make_mesh(n_dev)
    placed = jax.device_put(np.zeros((n_dev, 8), np.uint8), NamedSharding(mesh, P("data", None)))
    cards = {s.device.id for s in placed.addressable_shards}
    _check(len(cards) == n_dev, f"mesh shards land on {len(cards)} cards, not {n_dev}")

    t0 = time.perf_counter()
    one = km.find_genes(genome_path=fasta, ref_path=REF, do_return_hit_loci=True, verbose=False)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    many = km.find_genes(genome_path=fasta, ref_path=REF, do_return_hit_loci=True, verbose=False, devices=n_dev)
    many_s = time.perf_counter() - t0
    _check(_hit_pairs(one[0]) == _hit_pairs(many[0]) and one[1] == many[1],
           "sharded find_genes hits differ from one card")

    t0 = time.perf_counter()
    c_one = km.find_genes_cluster_mode(genome_path=fasta, ref_path=REF, verbose=False)[0]
    c_one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c_many = km.find_genes_cluster_mode(genome_path=fasta, ref_path=REF, verbose=False, devices=n_dev)[0]
    c_many_s = time.perf_counter() - t0
    _check(_hit_pairs(c_one) == _hit_pairs(c_many), "sharded cluster-mode hits differ from one card")

    rng = np.random.default_rng(10)
    k, ws, r, n = 10, 1200, 3, 9000
    s = np.zeros(4**k, dtype=np.int64)
    for _ in range(r):
        s += kmer_count(rng.integers(0, 4, ws, dtype=np.int8), k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    codes[4000 : 4000 + ws] = rng.integers(0, 4, ws, dtype=np.int8)
    thr = 120.0
    d0_h, st_h, _ = HostScanEngine(s, k=k, ws=ws, r=r).record_stream(codes, thr)
    d0_t, st_t, _ = TPScanEngine(s, k=k, ws=ws, r=r, mesh=mesh).record_stream(codes, thr)
    _check(d0_t == d0_h, "k=10 TP engine dist0 differs from the host engine")
    _check(len(st_t) > 0, "k=10 fixture produced no candidate windows")
    h_t = replay_single(st_t, d0_t, thr, k, ws, n, 50)
    _check(h_t == replay_single(st_h, d0_h, thr, k, ws, n, 50), "k=10 TP engine hits differ from the host engine")
    return {"cards": n_dev, "hits": len(one[0]), "one_card_s": one_s, "sharded_s": many_s,
            "cluster_hits": len(c_one), "cluster_one_card_s": c_one_s, "cluster_sharded_s": c_many_s,
            "k10_candidates": len(st_t), "k10_hits": len(h_t)}


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the four-card sharded paths")
    ap.add_argument("--seed", type=int, default=7, help="seed of the synthetic genome")
    args = ap.parse_args(argv)

    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    import jax

    devices = jax.devices()
    dev = devices[0]
    print(f"devices: {devices}", flush=True)
    print(f"platform={dev.platform} kind={dev.device_kind} count={len(devices)}", flush=True)
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 2

    from kmergma.backend import policy
    from kmergma.utils.native import get_lib

    print(f"native library loaded: {get_lib() is not None}", flush=True)
    pol = policy()
    print(f"policy: {pol}", flush=True)

    sizes = [m * 1_000_000 for m in GENOME_MBP]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        records, planted = make_genome(sizes, args.seed, PLANT_SPACING)
        fasta = os.path.join(td, "genome.fasta")
        write_fasta_file(fasta, records)
        report("data", records_mbp=list(GENOME_MBP), planted=len(planted), seconds=time.perf_counter() - t0)

        if args.four:
            report("four", **phase_four(fasta, 4))
            count = 4
        else:
            report("goldens", **phase_goldens())
            single = phase_single(fasta, planted)
            report("single", **single)
            small = os.path.join(td, "chr3.fasta")
            write_fasta_file(small, records[2:3])
            report("cluster", **phase_cluster(small))
            _check(pol.device_strobe_extract, "GPU policy must extract strobemers on the device")
            report("strobe", **phase_strobe(small, slice_bp=4_000_000))
            report("exact", **phase_exact(records[0].seq))
            report("align_device", **phase_align_device(records, planted))
            timing = phase_timing(fasta, sum(sizes), single["first_call_s"])
            report("timing", **timing)
            report("bitmap", **phase_bitmap(records, timing["median_s"]))
            report("span_sweep", **phase_span_sweep(records, SPAN_SWEEP))
            count = 1
    stats = dev.memory_stats() or {}
    report("memory", peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
