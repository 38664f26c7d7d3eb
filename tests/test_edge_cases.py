"""Edge-case parity tests - including the quirks the reference itself
documents as unhandled (OmnGenomeMiner.jl:168-170), whose behaviour we
replicate rather than fix."""

import numpy as np

from kmergma import gen_ref_ws_cons
from kmergma.models.miner import mine_genome
from kmergma.models.state_machine import RawHit, candidate_stream_from_dists, replay_single
from kmergma.utils.fasta import FastaRecord, read_fasta


def test_first_window_hit_is_missed():
    """Reference edge case: a gene at position 1 sets currminim=dist0 at
    init, so later sub-threshold windows never beat it -> NO hit
    (GenomeMiner.jl:57 initialises currminim to the first window's
    distance; OmnGenomeMiner.jl:169 documents this)."""
    # distances: window 0 is the global minimum, run stays below thr=10
    dists = np.array([1.0, 2.0, 3.0, 50.0, 50.0])
    hits = replay_single(candidate_stream_from_dists(dists, 10.0), dists[0], 10.0, k=6, ws=3, seq_len=20, buff=0)
    assert hits == []


def test_interior_hit_is_found():
    dists = np.array([50.0, 40.0, 5.0, 4.0, 6.0, 50.0, 50.0])
    hits = replay_single(candidate_stream_from_dists(dists, 10.0), dists[0], 10.0, k=6, ws=3, seq_len=20, buff=0)
    assert len(hits) == 1
    assert hits[0].dist == 4.0
    assert hits[0].cmi == 6 + 3 - 1 + 1  # j=3, i_left=k+j-1, then +1 on edge


def test_goal_ind_dedupes_overlapping_hits():
    # two sub-threshold dips within one windowsize -> second suppressed
    dists = np.array([50.0] + [5.0, 50.0] * 2 + [50.0] * 3)
    hits = replay_single(candidate_stream_from_dists(dists, 10.0), dists[0], 10.0, k=6, ws=10, seq_len=40, buff=0)
    assert len(hits) == 1


def test_trailing_run_produces_no_hit():
    """A run still below threshold when the record ends is dropped
    (the reference's loop exits without the rising edge)."""
    dists = np.array([50.0, 50.0, 5.0, 4.0, 3.0])
    hits = replay_single(candidate_stream_from_dists(dists, 10.0), dists[0], 10.0, k=6, ws=3, seq_len=10, buff=0)
    assert hits == []


def test_record_exactly_windowsize(ref_fasta):
    """len == ws: init window computed, zero iterative windows, no hits,
    and genome_pos still skips per the reference's `continue` semantics."""
    profile = gen_ref_ws_cons(ref_fasta, 6)
    ws = profile.windowsize
    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, ws))
    res = mine_genome([FastaRecord("exact", seq.encode())], profile, thr=30, do_align=False)
    assert res.hits == []
    assert res.stats.records_scanned == 1


def test_short_record_skipped_and_genome_pos(ref_fasta, mini_genome):
    """A short first record is skipped WITHOUT advancing genome_pos
    (GenomeMiner.jl:37-39 `continue` precedes the accumulation)."""
    profile = gen_ref_ws_cons(ref_fasta, 6)
    mini = next(read_fasta(mini_genome))
    records = [FastaRecord("short", b"ACGT" * 10), mini]
    res = mine_genome(records, profile, thr=30, do_align=False, get_hit_loci=True)
    base = mine_genome([mini], profile, thr=30, do_align=False, get_hit_loci=True)
    assert res.hit_loci == base.hit_loci  # GenomePos unaffected by the skip
    assert res.stats.records_skipped == 1


def test_record_len_guard():
    """Per-record int32 indexing limit raises a clear error (multi-record
    genomes of any total size are the supported path, bench.py 3G run)."""
    import pytest

    from kmergma.ops.scan import _check_record_len

    _check_record_len(2**31 - 3)  # largest allowed
    with pytest.raises(ValueError, match="per-record device indexing limit"):
        _check_record_len(2**31)
