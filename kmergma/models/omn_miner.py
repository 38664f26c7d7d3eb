"""Cluster-mode (multi-profile) genome miner - the device-scan
``Omn_KmerGMA!`` (ref KmerGMA.jl/src/OmnGenomeMiner.jl:7-162).

Each cluster profile scans with its own windowsize and exact integer scale
(its cluster size R_m); all m clusters are scanned in ONE device pass per
record (ops/scan_cluster.ClusterScanEngine shares K codes and the pair-count
hot loop across clusters).  The m per-cluster candidate streams are merged in
(i, cluster) order and replayed through the reference's exact hit-processing
semantics, including both overlap suppressions:

  * pre-alignment: reject if the candidate minimum index lies inside the
    previous accepted hit's range (OmnGenomeMiner.jl:126),
  * post-alignment: reject unless the trimmed range is fully left or right
    of the previous hit (OmnGenomeMiner.jl:139),

and the quirk that rejected hits do NOT reset the cluster's running minimum
(OmnGenomeMiner.jl:153 only executes on accept).  The main loop is bounded
by the LARGEST windowsize (i <= len - max(ws) - k + 2, OmnGenomeMiner.jl:89),
so smaller clusters' trailing windows are never scanned - reproduced here.
"""

from __future__ import annotations

import time

import numpy as np

from ..ops.align import cigar_to_unitrange, semiglobal_align
from ..ops.reference import RefProfile
from ..ops.scan_cluster import ClusterScanEngine
from ..utils.fasta import FastaRecord, PathOrRecords, as_records
from .miner import MineResult, ScanStats, fmt_dist
from .state_machine import OmnHitEvent, replay_omn


def mine_genome_clusters(
    genome: PathOrRecords,
    profiles: list[RefProfile],
    thr_vec: list[float],
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -200,
    gap_extend: int = -1,
    do_return_dists: bool = False,
    do_return_align: bool = False,
    get_hit_loci: bool = False,
    engine: ClusterScanEngine | None = None,
    checkpoint_path: str | None = None,
) -> MineResult:
    m = len(profiles)
    if len(thr_vec) != m:
        raise ValueError(f"{m} cluster profiles but {len(thr_vec)} thresholds")
    k = profiles[0].k
    windowsizes = [p.windowsize for p in profiles]
    maxws = max(windowsizes)
    # ONE fused device pass per record for all m clusters (K codes and the
    # pair-count hot loop shared per distinct windowsize) - this beats the
    # reference's m x slowdown (OmnGenomeMiner.jl / README.md:50) instead of
    # reproducing it with m serial engines.  ``engine`` may supply a
    # ShardedClusterScanEngine for multi-chip runs.
    cluster_engine = engine if engine is not None else ClusterScanEngine(profiles, k=k)

    res = MineResult()
    res.stats = stats = ScanStats()
    t_start = time.perf_counter()
    dist_parts: list[list[np.ndarray]] = [[] for _ in range(m)]

    # Per-record checkpoint/resume (SURVEY.md section 5.4): cluster-mode
    # state (prev_range, per-cluster minima) resets per record, so resuming
    # from the next unprocessed record is exact.
    ckpt = None
    if checkpoint_path is not None:
        from ..utils.checkpoint import ScanCheckpoint

        genome_id = (
            f"{genome if isinstance(genome, str) else 'records'}|cluster"
            f"|k={k}|ws={windowsizes}|thr={list(thr_vec)}"
        )
        ckpt = ScanCheckpoint.load_or_create(checkpoint_path, genome_id)
        res.hits.extend(ckpt.restore_hits())
        res.hit_loci.extend(ckpt.hit_loci)

    records = as_records(genome)

    # Cross-record transfer-compute overlap (mirrors models/miner.py): the
    # NEXT eligible record's (async) H2D is dispatched before the current
    # record's streams are assembled, so multi-contig cluster scans keep
    # the link busy under compute.  The sharded cluster engine manages its
    # own per-shard transfers and opts out via prepare_codes() -> None.
    prefetched: dict[int, object] = {}

    def _prefetch_after(idx: int) -> None:
        for j in range(idx + 1, len(records)):
            if ckpt and j < ckpt.next_record:
                continue
            n_j = len(records[j])
            if n_j - maxws - k + 2 >= 1:
                # bound double-held device memory like miner.py's gate
                # (test doubles / exotic engines may lack ``chunk``)
                limit = 2 * getattr(cluster_engine, "chunk", 0)
                if n_j <= limit and j not in prefetched:
                    prefetched[j] = cluster_engine.prepare_codes(records[j].codes)
                return

    genome_pos = ckpt.genome_pos if ckpt else 0
    for record_idx, record in enumerate(records):
        if ckpt and record_idx < ckpt.next_record:
            continue
        hits_before, loci_before = len(res.hits), len(res.hit_loci)
        seq_len = len(record)
        imax = seq_len - maxws - k + 2
        if imax < 1:
            stats.records_skipped += 1
            genome_pos += seq_len
            if ckpt:
                ckpt.record_done(record_idx, genome_pos, [], [])
            continue
        stats.records_scanned += 1
        stats.bp_scanned += seq_len
        stats.windows_scanned += m * imax

        # one H2D per record, shared by all cluster engines
        shared_dev = prefetched.pop(record_idx, None)
        if shared_dev is None:
            shared_dev = cluster_engine.prepare_codes(record.codes)
        _prefetch_after(record_idx)
        if do_return_dists:
            # debug path: full per-window distances need the dense per-
            # cluster scan (one device pass per cluster)
            dist0s, streams = [], []
            for ind in range(m):
                d0, stream, dists = cluster_engine.engines[ind].record_stream(
                    record.codes, thr_vec[ind], collect_dists=True,
                    codes_dev=shared_dev,
                )
                dist0s.append(d0)
                streams.append(stream)
                dist_parts[ind].append(dists[1 : imax + 1])
        else:
            pairs = cluster_engine.record_streams(
                record.codes, thr_vec, codes_dev=shared_dev,
                # sharded cluster engines resume MID-RECORD from the last
                # completed span batch; others ignore the tracker
                seg_tracker=ckpt.segment_tracker(record_idx) if ckpt else None,
            )
            dist0s = [p[0] for p in pairs]
            streams = [p[1] for p in pairs]
        stats.candidate_windows += sum(len(s) for s in streams)

        prev_range = (0, 0)  # 1-based inclusive; (0,0) matches Julia's 0:0

        def process(ev: OmnHitEvent) -> bool:
            nonlocal prev_range
            cmi = ev.cmi
            if prev_range[0] <= cmi <= prev_range[1]:
                return False
            ws_i = windowsizes[ev.cluster]
            lo = max(cmi - buff, 1)
            hi = min(cmi + ws_i - 1 + buff, seq_len)
            rng = (lo, hi)
            if do_align:
                # NOTE: aligns against the stored cluster consensus - already
                # truncated to ws for real clusters, full-length for the
                # appended average cluster (OmnGenomeMiner.jl:131 uses
                # consensus_seqs[ind] as-is).
                window = record.seq[lo - 1 : hi].decode("ascii").upper()
                aln = semiglobal_align(
                    profiles[ev.cluster].consensus, window, gap_open, gap_extend
                )
                if do_return_align:
                    # the reference collects the alignment BEFORE the second
                    # overlap check (OmnGenomeMiner.jl:132)
                    res.alignments.append(aln)
                alo, ahi = cigar_to_unitrange(aln)
                rng = (max(1, lo + alo - 1), min(lo + ahi - 1, seq_len))
            if not (rng[1] < prev_range[0] or rng[0] > prev_range[1]):
                return False

            desc = (
                f"{record.identifier} | Dist = {fmt_dist(ev.dist)}"
                f" | KFV = {ev.cluster + 1}"
                f" | MatchPos = {rng[0]}:{rng[1]}"
                f" | GenomePos = {genome_pos}"
                f" | Len = {rng[1] - rng[0] + 1}"
            )
            res.hits.append(FastaRecord(desc, record.seq[rng[0] - 1 : rng[1]].upper()))
            if get_hit_loci:
                res.hit_loci.append(rng[0] + genome_pos)
            prev_range = rng
            return True

        replay_omn(streams, dist0s, thr_vec, k, windowsizes, seq_len, process)
        genome_pos += seq_len
        if ckpt:
            ckpt.record_done(
                record_idx, genome_pos, res.hits[hits_before:], res.hit_loci[loci_before:]
            )

    if ckpt:
        ckpt.done()
    stats.hits = len(res.hits)
    stats.wall_seconds = time.perf_counter() - t_start
    if do_return_dists:
        res.dists = [
            np.concatenate(parts) if parts else np.empty(0) for parts in dist_parts
        ]
    return res
