"""Single-profile genome miner - the device-scan ``ac_gma_testing!``
(ref KmerGMA.jl/src/GenomeMiner.jl:4-109).

Pipeline per contig (records shorter than the windowsize are skipped,
GenomeMiner.jl:37-39):

  1. device: tiled exact-integer window-distance scan + candidate
     compaction (ops/scan.ScanEngine),
  2. host: exact replay of the minima/dedupe state machine
     (models/state_machine.replay_single),
  3. host: optional semi-global alignment trim of each rare hit
     (ops/align.align_unitrange),
  4. hit records formatted exactly like the reference
     ("id | dist = a | MatchPos = b:c | GenomePos = e | Len = f",
     ref Alignment.jl:57-81).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.align import (
    AlignResult,
    align_hits_batch,
    cigar_to_unitrange,
    semiglobal_align,
)
from ..ops.reference import RefProfile
from ..ops.scan import ScanEngine
from ..utils.fasta import FastaRecord, PathOrRecords, as_records
from .state_machine import replay_single


def fmt_dist(x: float) -> str:
    """Julia's string(round(x, digits=2)): IEEE round-half-even to 2
    decimals, shortest-repr formatting."""
    return repr(round(float(x), 2))


@dataclass
class MineResult:
    hits: list[FastaRecord] = field(default_factory=list)
    hit_loci: list[int] = field(default_factory=list)
    alignments: list[AlignResult] = field(default_factory=list)
    dists: np.ndarray | None = None  # concatenated per-window distances
    stats: "ScanStats | None" = None


@dataclass
class ScanStats:
    """Observability counters for a mine run (the reference has only
    @info strings, SURVEY.md section 5.5)."""

    records_scanned: int = 0
    records_skipped: int = 0
    bp_scanned: int = 0
    windows_scanned: int = 0
    candidate_windows: int = 0
    hits: int = 0
    wall_seconds: float = 0.0

    @property
    def mbp_per_second(self) -> float:
        return self.bp_scanned / self.wall_seconds / 1e6 if self.wall_seconds else 0.0


def record_kmergma(
    record: FastaRecord,
    profile: RefProfile,
    thr: float = 30,
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -69,
    gap_extend: int = -1,
    engine: ScanEngine | None = None,
) -> list[FastaRecord]:
    """Single-record scan with the MultiThread miner's output format
    (ref KmerGMA.jl/src/MultiThread/GenomeMiner.jl:8-98): identical
    hit set to the standard miner (its CMI is stored pre-incremented,
    ``i_left + 1`` at GenomeMiner.jl:73, instead of post-incremented at the
    rising edge - same replayed value), but the description has NO
    ``GenomePos`` field (GenomeMiner.jl:87-93).  Golden strings pinned by
    test-KmerGMA.jl:229-254.

    The reference's per-thread scratch fan-out (its only parallelism
    construct, disabled in-source) is superseded by the SPMD sharded scan
    (parallel/sharded_scan.py); this surface exists for output conformance.
    """
    k, ws = profile.k, profile.windowsize
    seq_len = len(record)
    if seq_len < ws:
        return []
    if engine is None:
        engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records)
    dist0, stream, _ = engine.record_stream(record.codes, thr)
    hits: list[FastaRecord] = []
    for hit in replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=seq_len, buff=buff):
        start, stop = hit.start, hit.stop
        if do_align:
            window = record.seq[start - 1 : stop].decode("ascii").upper()
            aln = semiglobal_align(profile.consensus_ws, window, gap_open, gap_extend)
            lo, hi = cigar_to_unitrange(aln)
            start, stop = max(1, hit.start + lo - 1), min(hit.start + hi - 1, seq_len)
        desc = (
            f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
            f" | MatchPos = {start}:{stop}"
            f" | Len = {stop - start + 1}"
        )
        hits.append(FastaRecord(desc, record.seq[start - 1 : stop].upper()))
    return hits


def mine_genome(
    genome: PathOrRecords,
    profile: RefProfile,
    thr: float,
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -69,
    gap_extend: int = -1,
    do_return_dists: bool = False,
    do_return_align: bool = False,
    get_hit_loci: bool = False,
    engine: ScanEngine | None = None,
    checkpoint_path: str | None = None,
) -> MineResult:
    import time

    k, ws = profile.k, profile.windowsize
    if engine is None:
        try:
            import jax

            if 4**k > 2**18 and len(jax.devices()) > 1:
                # big k (more than 2^18 bins): shard the profile axis over
                # the mesh (parallel/tp_lookup.py)
                from ..parallel.tp_lookup import TPScanEngine

                engine = TPScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records)
            else:
                engine = ScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records)
        except OverflowError:
            # beyond the device int32 headroom: exact int64 host engine
            from ..ops.scan_host import HostScanEngine

            engine = HostScanEngine(profile.sum_kfv, k=k, ws=ws, r=profile.n_records)
    consensus_ws = profile.consensus_ws
    res = MineResult()
    res.stats = stats = ScanStats()
    dist_parts: list[np.ndarray] = []
    t_start = time.perf_counter()

    ckpt = None
    if checkpoint_path is not None:
        from ..utils.checkpoint import ScanCheckpoint

        genome_id = f"{genome if isinstance(genome, str) else 'records'}|k={k}|ws={ws}|thr={thr}"
        ckpt = ScanCheckpoint.load_or_create(checkpoint_path, genome_id)
        res.hits.extend(ckpt.restore_hits())
        res.hit_loci.extend(ckpt.hit_loci)

    records = as_records(genome)

    # Cross-record transfer-compute overlap: dispatch the NEXT eligible
    # record's (async) H2D before scanning the current one, so multi-contig
    # genomes keep the link busy under compute.  Records long enough for
    # the segmented in-record pipeline manage their own transfers.
    prefetched: dict[int, object] = {}

    def _prefetch_after(idx: int) -> None:
        if not getattr(engine, "prefetch_h2d", False):
            return
        for j in range(idx + 1, len(records)):
            if ckpt and j < ckpt.next_record:
                continue
            n_j = len(records[j])
            if n_j >= ws and (n_j - ws + 1) <= 2 * engine.chunk:
                if j not in prefetched:
                    prefetched[j] = engine.prepare_codes(records[j].codes)
                return

    genome_pos = ckpt.genome_pos if ckpt else 0
    for record_idx, record in enumerate(records):
        if ckpt and record_idx < ckpt.next_record:
            continue
        hits_before, loci_before = len(res.hits), len(res.hit_loci)
        seq_len = len(record)
        if seq_len < ws:
            # ref GenomeMiner.jl:37-39: `continue` also skips genome_pos
            stats.records_skipped += 1
            if ckpt:
                ckpt.record_done(record_idx, genome_pos, [], [])
            continue
        codes_dev = prefetched.pop(record_idx, None)
        _prefetch_after(record_idx)
        dist0, stream, dists = engine.record_stream(
            record.codes, thr, collect_dists=do_return_dists, codes_dev=codes_dev,
            # long records resume mid-record from the last finished segment
            seg_tracker=ckpt.segment_tracker(record_idx) if ckpt else None,
        )
        stats.records_scanned += 1
        stats.bp_scanned += seq_len
        stats.windows_scanned += seq_len - ws + 1
        stats.candidate_windows += len(stream)
        if dists is not None:
            dist_parts.append(dists[1:])  # the reference records only the iterative phase

        raw_hits = replay_single(stream, dist0, thr, k=k, ws=ws, seq_len=seq_len, buff=buff)
        alns = None
        if do_align and raw_hits:
            # align on the buffered windows only (never materialise a full
            # uppercased copy of a multi-Gbp contig), ALL hits of the record
            # in one batched wavefront (ops/align.semiglobal_align_batch -
            # bit-identical to per-hit alignment, ~hit-count x less NumPy
            # dispatch overhead at hit-dense genome scale)
            windows = [
                record.seq[h.start - 1 : h.stop].decode("ascii").upper()
                for h in raw_hits
            ]
            alns = align_hits_batch(consensus_ws, windows, gap_open, gap_extend)
        for hit_i, hit in enumerate(raw_hits):
            start, stop = hit.start, hit.stop
            if do_align:
                # remap with the reference's semantics: the CIGAR range
                # counts query-only (I) ops too, so the trimmed range can
                # extend BEYOND the window, clamped only at the contig end
                # (ref Alignment.jl:49-51)
                aln = alns[hit_i]
                if do_return_align:
                    res.alignments.append(aln)
                lo, hi = cigar_to_unitrange(aln)
                start, stop = max(1, hit.start + lo - 1), min(hit.start + hi - 1, seq_len)
            desc = (
                f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
                f" | MatchPos = {start}:{stop}"
                f" | GenomePos = {genome_pos}"
                f" | Len = {stop - start + 1}"
            )
            res.hits.append(FastaRecord(desc, record.seq[start - 1 : stop].upper()))
            if get_hit_loci:
                res.hit_loci.append(start + genome_pos)
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
        res.dists = np.concatenate(dist_parts) if dist_parts else np.empty(0)
    return res
