"""Failure-detection and recovery tests (SURVEY.md sections 5.3-5.4):
retry of transient device-transport failures, and kill-resume through the
per-record checkpoint for both miners."""

import numpy as np
import pytest

import jax

from kmergma.ops import scan as scan_mod
from kmergma.ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from kmergma.ops.scan import ScanEngine, _with_retry


class _Flaky:
    """Raises JaxRuntimeError on the first ``fails`` calls, then delegates."""

    def __init__(self, fn, fails: int):
        self.fn, self.remaining, self.calls = fn, fails, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.remaining > 0:
            self.remaining -= 1
            raise jax.errors.JaxRuntimeError("injected transport failure")
        return self.fn(*a, **kw)


def test_with_retry_recovers_once():
    flaky = _Flaky(lambda: 42, fails=1)
    assert _with_retry(lambda: flaky(), attempts=2, delay_s=0.0) == 42
    assert flaky.calls == 2


def test_with_retry_surfaces_persistent_failure():
    flaky = _Flaky(lambda: 42, fails=5)
    with pytest.raises(jax.errors.JaxRuntimeError):
        _with_retry(lambda: flaky(), attempts=2, delay_s=0.0)


def test_record_stream_retries_failed_region_fetch(monkeypatch):
    """A transient failure in the compact region fetch must be retried
    transparently and produce the identical stream."""
    rng = np.random.default_rng(5)
    k, ws, r = 6, 100, 4
    codes = rng.integers(0, 4, 20000, dtype=np.int8)
    s = rng.integers(0, 8, 4**k).astype(np.int32)
    eng = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=4096)
    _, probe, _ = eng.record_stream(codes, thr=1e9)
    thr = float(np.percentile([v for _, v in probe], 5))
    expected = eng.record_stream(codes, thr)

    # make retries instant, then inject one failure into each region-fetch
    # variant: the device path (explicit prep) and the host-row path (the
    # segmented long-record pipeline)
    monkeypatch.setattr(
        scan_mod, "_with_retry", lambda fn, attempts=2, delay_s=5.0: _with_retry(fn, attempts, 0.0)
    )
    # whole-record scans ride the planned dispatch
    flaky_dev = _Flaky(scan_mod._planned_dispatch, fails=1)
    monkeypatch.setattr(scan_mod, "_planned_dispatch", flaky_dev)
    got = eng.record_stream(codes, thr, codes_dev=eng.prepare_codes(codes))
    assert flaky_dev.calls >= 2  # failed once, retried
    assert got[0] == expected[0] and got[1] == expected[1]

    flaky_rows = _Flaky(scan_mod._scan_region_rows_summarized, fails=1)
    monkeypatch.setattr(scan_mod, "_scan_region_rows_summarized", flaky_rows)
    got = eng.record_stream(codes, thr)  # nw > 2*chunk -> segmented path
    assert flaky_rows.calls >= 2
    assert got[0] == expected[0] and got[1] == expected[1]

    # the "full" assembly fallback path keeps its own retry coverage
    eng.assemble_mode = "full"
    flaky_full = _Flaky(scan_mod._scan_regions_dense, fails=1)
    monkeypatch.setattr(scan_mod, "_scan_regions_dense", flaky_full)
    got = eng.record_stream(codes, thr, codes_dev=eng.prepare_codes(codes))
    assert flaky_full.calls >= 2
    assert got[0] == expected[0]
    hits_a = got[1]
    eng.assemble_mode = "reduced"


def test_prepare_codes_retries_failed_transfer(monkeypatch):
    rng = np.random.default_rng(6)
    eng = ScanEngine(np.ones(4**5, np.int64), k=5, ws=64, r=1, chunk_windows=2048)
    monkeypatch.setattr(
        scan_mod, "_with_retry", lambda fn, attempts=2, delay_s=5.0: _with_retry(fn, attempts, 0.0)
    )
    flaky = _Flaky(jax.device_put, fails=1)
    monkeypatch.setattr(scan_mod.jax, "device_put", flaky)
    codes = rng.integers(0, 4, 5000, dtype=np.int8)
    prep = eng.prepare_codes(codes)
    assert flaky.calls >= 2
    assert np.asarray(prep.dev[:5000]).tolist() == codes.tolist()


class _DyingEngine:
    """Cluster-engine wrapper that dies after N records (kill simulation)."""

    def __init__(self, inner, die_after: int):
        self.inner, self.left = inner, die_after

    def prepare_codes(self, codes):
        return self.inner.prepare_codes(codes)

    def record_streams(self, codes, thrs, codes_dev=None, seg_tracker=None):
        if self.left == 0:
            raise KeyboardInterrupt("simulated kill")
        self.left -= 1
        return self.inner.record_streams(
            codes, thrs, codes_dev=codes_dev, seg_tracker=seg_tracker
        )

    @property
    def engines(self):
        return self.inner.engines


def test_cluster_miner_kill_resume(tmp_path, ref_fasta, test_genome):
    """Kill the cluster miner mid-genome; resuming from the checkpoint must
    reproduce the uninterrupted hit set exactly."""
    from kmergma.models.omn_miner import mine_genome_clusters
    from kmergma.ops.scan_cluster import ClusterScanEngine

    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]
    full = mine_genome_clusters(test_genome, clusters.profiles, thr_vec=thrs, buff=100)

    ckpt = str(tmp_path / "cluster.ckpt")
    dying = _DyingEngine(ClusterScanEngine(clusters.profiles, k=6), die_after=2)
    with pytest.raises(KeyboardInterrupt):
        mine_genome_clusters(
            test_genome, clusters.profiles, thr_vec=thrs, buff=100,
            engine=dying, checkpoint_path=ckpt,
        )
    import os

    assert os.path.exists(ckpt)  # partial progress persisted
    resumed = mine_genome_clusters(
        test_genome, clusters.profiles, thr_vec=thrs, buff=100, checkpoint_path=ckpt,
    )
    assert [h.description for h in resumed.hits] == [h.description for h in full.hits]
    assert [h.seq for h in resumed.hits] == [h.seq for h in full.hits]
    assert not os.path.exists(ckpt)  # completed checkpoints are removed


def test_find_genes_checkpoint_api(tmp_path, mini_genome, ref_fasta):
    """checkpoint_path is reachable from the public API (find_genes)."""
    from kmergma.api import find_genes

    from tests.test_api_golden import REFERENCE_GOLDEN_HITS

    ckpt = str(tmp_path / "fg.ckpt")
    hits = find_genes(
        genome_path=mini_genome, ref_path=ref_fasta, verbose=False, checkpoint_path=ckpt
    )[0]
    assert [h.description for h in hits] == REFERENCE_GOLDEN_HITS


def test_strobe_miner_checkpoint_resume(tmp_path, ref_fasta, test_genome):
    """The strobemer miner checkpoints per record and resumes to the exact
    uninterrupted hit set (parity with the k-mer miners)."""
    from kmergma.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma.utils.checkpoint import ScanCheckpoint

    profile = gen_strobe_ref_ws_cons(ref_fasta)
    full = strobe_mine_genome(test_genome, profile, thr=30, do_align=False, get_hit_loci=True)
    assert len(full.hits) > 0

    # simulate an interrupted run: pre-seed a checkpoint that has finished
    # the first two records with the hits the full run produced there
    import json
    import os

    ckpt_path = str(tmp_path / "strobe.ckpt")
    gid = (
        f"strobe|{test_genome}|s=2|wmin=3|wmax=5|q=5"
        f"|ws={profile.windowsize}|thr=30"
    )
    ck = ScanCheckpoint.load_or_create(ckpt_path, gid)
    from kmergma.utils.fasta import as_records

    recs = as_records(test_genome)
    pos0 = len(recs[0])
    done = [h for h in full.hits if h.description.startswith(recs[0].identifier)]
    loci_done = full.hit_loci[: len(done)]
    ck.record_done(0, pos0, done, loci_done)
    assert os.path.exists(ckpt_path)

    resumed = strobe_mine_genome(
        test_genome, profile, thr=30, do_align=False, get_hit_loci=True,
        checkpoint_path=ckpt_path,
    )
    assert [h.description for h in resumed.hits] == [h.description for h in full.hits]
    assert resumed.hit_loci == full.hit_loci
    assert not os.path.exists(ckpt_path)  # completed checkpoints are removed


def test_mid_record_segment_resume(tmp_path, ref_fasta):
    """A record spanning several segments killed mid-scan resumes from the
    last finished SEGMENT (SURVEY section 5.4 'last completed tile index'),
    recomputing only the remaining segments and producing identical hits."""
    from kmergma.models.miner import mine_genome
    from kmergma.utils.fasta import FastaRecord, as_records

    profile = gen_ref_ws_cons(ref_fasta, 6)
    rng = np.random.default_rng(5)
    n = 120_000
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
    refs = as_records(ref_fasta)
    for pos in (20_000, 55_000, 90_000):  # plant genes in distinct segments
        g = refs[pos % len(refs)].seq.upper()
        seq[pos : pos + len(g)] = np.frombuffer(g, dtype=np.uint8)
    record = FastaRecord("big", seq.tobytes())

    # small chunks -> segment = 8192 windows -> ~15 segments
    engine = ScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
        chunk_windows=4096,
    )
    ckpt = str(tmp_path / "seg.ckpt")
    baseline = mine_genome([record], profile, thr=30, engine=engine, get_hit_loci=True)
    assert len(baseline.hits) >= 3

    # kill after 4 completed segments
    real = engine._segmented_bitmaps
    calls = {"segments": 0}

    def killer(codes, nw, thr_int, tracker=None):
        class Boom(Exception):
            pass

        if tracker is not None:
            orig_done = tracker.done_segment

            def counting_done(si, words, fp):
                orig_done(si, words, fp)
                calls["segments"] += 1
                if calls["segments"] >= 4:
                    raise KeyboardInterrupt("killed mid-record")

            tracker.done_segment = counting_done
        return real(codes, nw, thr_int, tracker)

    engine._segmented_bitmaps = killer
    with pytest.raises(KeyboardInterrupt):
        mine_genome([record], profile, thr=30, engine=engine,
                    get_hit_loci=True, checkpoint_path=ckpt)
    import json

    data = json.load(open(ckpt))
    assert data["seg_next"] >= 4 and data["seg_record"] == 0

    # resume from the persisted segments
    engine._segmented_bitmaps = real
    res = mine_genome([record], profile, thr=30, engine=engine,
                      get_hit_loci=True, checkpoint_path=ckpt)
    assert [h.description for h in res.hits] == [h.description for h in baseline.hits]
    assert res.hit_loci == baseline.hit_loci
    import os

    assert not os.path.exists(ckpt)  # completed -> checkpoint removed


def test_segment_resume_discards_stale_parameters(tmp_path, ref_fasta):
    """Persisted segment words from a run with DIFFERENT engine parameters
    must be discarded on resume (their word layout/offsets differ), not
    silently misread - results must still be exact."""
    import json

    from kmergma.models.miner import mine_genome
    from kmergma.utils.fasta import FastaRecord, as_records

    profile = gen_ref_ws_cons(ref_fasta, 6)
    rng = np.random.default_rng(6)
    n = 120_000
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)]
    refs = as_records(ref_fasta)
    g = refs[0].seq.upper()
    seq[40_000 : 40_000 + len(g)] = np.frombuffer(g, dtype=np.uint8)
    record = FastaRecord("big", seq.tobytes())

    eng_a = ScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize,
                       r=profile.n_records, chunk_windows=4096)
    baseline = mine_genome([record], profile, thr=30, engine=eng_a, get_hit_loci=True)

    # run 1 dies after 2 segments with chunk 4096
    real = eng_a._segmented_bitmaps
    count = {"n": 0}

    def killer(codes, nw, thr_int, tracker=None):
        if tracker is not None:
            orig = tracker.done_segment

            def boom(si, words, fp):
                orig(si, words, fp)
                count["n"] += 1
                if count["n"] >= 2:
                    raise KeyboardInterrupt()

            tracker.done_segment = boom
        return real(codes, nw, thr_int, tracker)

    eng_a._segmented_bitmaps = killer
    ckpt = str(tmp_path / "stale.ckpt")
    with pytest.raises(KeyboardInterrupt):
        mine_genome([record], profile, thr=30, engine=eng_a, checkpoint_path=ckpt)
    assert json.load(open(ckpt))["seg_next"] >= 2

    # run 2 resumes with a DIFFERENT chunk: stored segments must be ignored
    eng_b = ScanEngine(profile.sum_kfv, k=6, ws=profile.windowsize,
                       r=profile.n_records, chunk_windows=8192)
    res = mine_genome([record], profile, thr=30, engine=eng_b,
                      checkpoint_path=ckpt, get_hit_loci=True)
    assert [h.description for h in res.hits] == [h.description for h in baseline.hits]
    assert res.hit_loci == baseline.hit_loci


def test_sharded_mid_record_segment_resume(tmp_path, ref_fasta):
    """Sharded engine: a record spanning >=3 segment batches killed
    mid-scan resumes from the last batch every shard completed, and only
    the remaining batches are recomputed (SURVEY 5.4 'last completed tile
    index per shard')."""
    import json
    import os

    from kmergma.models.miner import mine_genome
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.sharded_scan import ShardedScanEngine
    from kmergma.utils.fasta import FastaRecord, as_records

    profile = gen_ref_ws_cons(ref_fasta, 6)
    rng = np.random.default_rng(7)
    n = 120_000
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].copy()
    refs = as_records(ref_fasta)
    for pos in (15_000, 48_000, 76_000, 104_000):  # genes in distinct batches
        g = refs[pos % len(refs)].seq.upper()
        seq[pos : pos + len(g)] = np.frombuffer(g, dtype=np.uint8)
    record = FastaRecord("big", seq.tobytes())

    # nw ~ 119.7k windows / (8 dev * 4 spans * 1024) -> 4 segment batches
    engine = ShardedScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
        mesh=make_mesh(8), chunk_windows=1024,
    )
    baseline = mine_genome([record], profile, thr=30, engine=engine, get_hit_loci=True)
    assert len(baseline.hits) >= 4

    ckpt = str(tmp_path / "shseg.ckpt")
    real_segmented = engine._segmented_sharded_bitmaps

    def killer(codes, nw, thr_int, tracker):
        orig_done = tracker.done_segment

        def dying_done(si, words, fp):
            orig_done(si, words, fp)
            if si + 1 >= 2:
                raise KeyboardInterrupt("killed mid-record")

        tracker.done_segment = dying_done
        return real_segmented(codes, nw, thr_int, tracker)

    engine._segmented_sharded_bitmaps = killer
    with pytest.raises(KeyboardInterrupt):
        mine_genome([record], profile, thr=30, engine=engine,
                    get_hit_loci=True, checkpoint_path=ckpt)
    data = json.load(open(ckpt))
    assert data["seg_record"] == 0 and data["seg_next"] == 2

    # resume: ONLY the 2 remaining batches rerun through the SPMD pass
    engine._segmented_sharded_bitmaps = real_segmented
    real_pass = engine._sharded_pass
    calls = {"n": 0}

    def counting_pass(codes, nv, spd):
        calls["n"] += 1
        return real_pass(codes, nv, spd)

    engine._sharded_pass = counting_pass
    res = mine_genome([record], profile, thr=30, engine=engine,
                      get_hit_loci=True, checkpoint_path=ckpt)
    assert calls["n"] == 2
    assert [h.description for h in res.hits] == [h.description for h in baseline.hits]
    assert res.hit_loci == baseline.hit_loci
    assert not os.path.exists(ckpt)  # completed -> checkpoint removed


def test_sharded_segmented_stream_equals_unsegmented(tmp_path, ref_fasta, mini_genome):
    """The segmented (checkpointed) sharded pass must produce the same
    stream as the one-dispatch pass (8-device CPU mesh)."""
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.sharded_scan import ShardedScanEngine
    from kmergma.utils.checkpoint import ScanCheckpoint
    from kmergma.utils.fasta import as_records

    profile = gen_ref_ws_cons(ref_fasta, 6)
    record = as_records(mini_genome)[0]
    thr = 30.0
    engine = ShardedScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
        mesh=make_mesh(8), chunk_windows=1024,
    )
    d0_a, stream_a, _ = engine.record_stream(record.codes, thr)
    ckpt = ScanCheckpoint.load_or_create(str(tmp_path / "s.ckpt"), "g")
    d0_b, stream_b, _ = engine.record_stream(
        record.codes, thr, seg_tracker=ckpt.segment_tracker(0)
    )
    assert ckpt.seg_next >= 2  # the segmented path actually ran
    assert (d0_b, stream_b) == (d0_a, stream_a)
    assert len(stream_a) > 0


def test_sharded_cluster_mid_record_segment_resume(tmp_path, ref_fasta):
    """Sharded CLUSTER engine: a record spanning >=3 segment batches killed
    mid-scan resumes from the last batch every shard completed, with only
    the remaining batches recomputed (SURVEY 5.4, cluster variant)."""
    import json
    import os

    from kmergma.models.omn_miner import mine_genome_clusters
    from kmergma.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.sharded_scan import ShardedClusterScanEngine
    from kmergma.utils.fasta import FastaRecord, as_records

    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0][: len(clusters.profiles)]
    rng = np.random.default_rng(9)
    n = 120_000
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, n)].copy()
    refs = as_records(ref_fasta)
    for pos in (15_000, 48_000, 76_000, 104_000):
        g = refs[pos % len(refs)].seq.upper()
        seq[pos : pos + len(g)] = np.frombuffer(g, dtype=np.uint8)
    record = FastaRecord("bigc", seq.tobytes())

    def fresh():
        return ShardedClusterScanEngine(
            clusters.profiles, k=6, mesh=make_mesh(8), chunk_windows=1024
        )

    baseline = mine_genome_clusters([record], clusters.profiles, thr_vec=thrs,
                                    engine=fresh(), get_hit_loci=True)
    assert len(baseline.hits) >= 3

    engine = fresh()
    ckpt = str(tmp_path / "shcseg.ckpt")
    real_segmented = engine._segmented_cluster_bitmaps

    def killer(codes, n_valids, thr_ints, tracker):
        orig_done = tracker.done_segment

        def dying_done(si, words, fp):
            orig_done(si, words, fp)
            if si + 1 >= 2:
                raise KeyboardInterrupt("killed mid-record")

        tracker.done_segment = dying_done
        return real_segmented(codes, n_valids, thr_ints, tracker)

    engine._segmented_cluster_bitmaps = killer
    with pytest.raises(KeyboardInterrupt):
        mine_genome_clusters([record], clusters.profiles, thr_vec=thrs,
                             engine=engine, get_hit_loci=True, checkpoint_path=ckpt)
    data = json.load(open(ckpt))
    assert data["seg_record"] == 0 and data["seg_next"] == 2

    # resume: only the remaining batches rerun through the SPMD pass
    engine._segmented_cluster_bitmaps = real_segmented
    calls = {"n": 0}
    real_pass = engine._cluster_pass

    def counting_pass(codes, nv, thr_ints, spd):
        calls["n"] += 1
        return real_pass(codes, nv, thr_ints, spd)

    engine._cluster_pass = counting_pass
    res = mine_genome_clusters([record], clusters.profiles, thr_vec=thrs,
                               engine=engine, get_hit_loci=True, checkpoint_path=ckpt)
    assert calls["n"] == 2  # 4 batches, 2 persisted
    assert [h.description for h in res.hits] == [h.description for h in baseline.hits]
    assert res.hit_loci == baseline.hit_loci
    assert not os.path.exists(ckpt)


def test_sharded_cluster_segmented_equals_unsegmented(tmp_path, ref_fasta, mini_genome):
    """The segmented (checkpointed) sharded cluster pass must produce the
    same per-cluster streams as the one-dispatch pass."""
    from kmergma.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma.parallel.mesh import make_mesh
    from kmergma.parallel.sharded_scan import ShardedClusterScanEngine
    from kmergma.utils.checkpoint import ScanCheckpoint
    from kmergma.utils.fasta import as_records

    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0][: len(clusters.profiles)]
    record = as_records(mini_genome)[0]
    engine = ShardedClusterScanEngine(
        clusters.profiles, k=6, mesh=make_mesh(8), chunk_windows=1024
    )
    a = engine.record_streams(record.codes, thrs)
    ckpt = ScanCheckpoint.load_or_create(str(tmp_path / "sc.ckpt"), "g")
    b = engine.record_streams(record.codes, thrs, seg_tracker=ckpt.segment_tracker(0))
    assert ckpt.seg_next >= 2  # the segmented path actually ran
    assert b == a
    assert any(len(s) > 0 for _, s in a)
