"""Checkpoint/resume and stats tests."""

import json

from kmergma import gen_ref_ws_cons
from kmergma.models.miner import mine_genome


def test_stats_populated(ref_fasta, mini_genome):
    profile = gen_ref_ws_cons(ref_fasta, 6)
    res = mine_genome(mini_genome, profile, thr=30, do_align=False)
    s = res.stats
    assert s.records_scanned == 1
    assert s.bp_scanned == 41260
    assert s.windows_scanned == 41260 - 289 + 1
    assert s.hits == 3
    assert s.wall_seconds > 0
    assert s.mbp_per_second > 0


def test_checkpoint_resume(tmp_path, ref_fasta, test_genome):
    profile = gen_ref_ws_cons(ref_fasta, 6)
    ckpt = tmp_path / "scan.ckpt"

    full = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True)

    # simulate an interrupted run: pre-seed a checkpoint claiming the first
    # two records are done, carrying their hits
    partial = mine_genome(
        test_genome, profile, thr=30, do_align=True, get_hit_loci=True,
        checkpoint_path=str(ckpt),
    )
    assert not ckpt.exists()  # completed runs clean up
    assert [h.description for h in partial.hits] == [h.description for h in full.hits]
    assert partial.hit_loci == full.hit_loci


def test_checkpoint_partial_restart(tmp_path, ref_fasta, test_genome):
    from kmergma.utils.checkpoint import ScanCheckpoint

    profile = gen_ref_ws_cons(ref_fasta, 6)
    full = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True)

    ckpt = tmp_path / "scan.ckpt"
    genome_id = f"{test_genome}|k=6|ws={profile.windowsize}|thr=30"
    # run once, capture the checkpoint state after record 0 by replaying
    # record_done manually with the first contig's hits
    c = ScanCheckpoint.load_or_create(str(ckpt), genome_id)
    first_contig_hits = [h for h in full.hits if "JQ684648" in h.description]
    first_loci = full.hit_loci[: len(first_contig_hits)]
    c.record_done(0, 121478, first_contig_hits, first_loci)

    resumed = mine_genome(
        test_genome, profile, thr=30, do_align=True, get_hit_loci=True,
        checkpoint_path=str(ckpt),
    )
    assert [h.description for h in resumed.hits] == [h.description for h in full.hits]
    assert resumed.hit_loci == full.hit_loci
    # resumed run scanned fewer records
    assert resumed.stats.records_scanned == 3


def test_checkpoint_with_sharded_engine(tmp_path, ref_fasta, test_genome):
    """checkpoint_path composes with devices=N: per-record resume through
    the sharded engine yields the golden hits (mid-record segment resume is
    single-device only, documented)."""
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.sharded_scan import ShardedScanEngine
    from kmergma.utils.checkpoint import ScanCheckpoint

    profile = gen_ref_ws_cons(ref_fasta, 6)
    full = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True)

    ckpt = tmp_path / "sharded.ckpt"
    genome_id = f"{test_genome}|k=6|ws={profile.windowsize}|thr=30"
    c = ScanCheckpoint.load_or_create(str(ckpt), genome_id)
    first_contig_hits = [h for h in full.hits if "JQ684648" in h.description]
    c.record_done(0, 121478, first_contig_hits, full.hit_loci[: len(first_contig_hits)])

    engine = ShardedScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
        mesh=make_mesh(8), chunk_windows=8192,
    )
    resumed = mine_genome(
        test_genome, profile, thr=30, do_align=True, get_hit_loci=True,
        engine=engine, checkpoint_path=str(ckpt),
    )
    assert [h.description for h in resumed.hits] == [h.description for h in full.hits]
    assert resumed.hit_loci == full.hit_loci
    assert resumed.stats.records_scanned == 3
