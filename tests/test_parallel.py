"""Multi-device sharding tests on the 8-virtual-CPU-device mesh
(SURVEY.md section 4: shard-merge logic tested without several cards)."""

import numpy as np
import pytest

import jax

from kmergma.ops.reference import gen_ref_ws_cons
from kmergma.ops.scan import ScanEngine
from kmergma.parallel.mesh import make_mesh
from kmergma.parallel.sharded_scan import ShardedClusterScanEngine, ShardedScanEngine


def test_mesh_shapes():
    m = make_mesh(8, n_clusters=2)
    assert m.shape["clusters"] == 2 and m.shape["data"] == 4
    m = make_mesh(8)
    assert m.shape["clusters"] == 1 and m.shape["data"] == 8


def test_sharded_stream_equals_single_device():
    rng = np.random.default_rng(11)
    n, k, ws, r = 40000, 6, 289, 12
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)

    single = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=4096)
    thr_probe, stream_probe, _ = single.record_stream(codes, thr=1e9)
    # pick a threshold that creates runs crossing span boundaries
    vals = np.array([v for _, v in stream_probe])
    thr = float(np.percentile(vals, 4))

    d0_a, stream_a, _ = single.record_stream(codes, thr)
    sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=make_mesh(8), chunk_windows=2048)
    d0_b, stream_b, _ = sharded.record_stream(codes, thr)

    # production parity: the sharded engine IS the pruned-bitmap engine,
    # so the streams are bit-identical (not just equivalent under replay)
    assert d0_a == d0_b
    assert stream_a == stream_b

    from kmergma.models.state_machine import replay_single

    hits_a = replay_single(stream_a, d0_a, thr, k, ws, n, buff=10)
    hits_b = replay_single(stream_b, d0_b, thr, k, ws, n, buff=10)
    assert hits_a == hits_b


def test_sharded_miner_golden(ref_fasta, test_genome):
    """The sharded engine must reproduce the golden hit set bit-for-bit."""
    from kmergma.models.miner import mine_genome

    profile = gen_ref_ws_cons(ref_fasta, 6)
    engine = ShardedScanEngine(
        profile.sum_kfv, k=6, ws=profile.windowsize, r=profile.n_records,
        mesh=make_mesh(8), chunk_windows=8192,
    )
    res = mine_genome(test_genome, profile, thr=30, do_align=True, get_hit_loci=True, engine=engine)
    assert res.hit_loci == [8543, 20425, 221912, 234018, 450875, 467930, 477868]


def test_find_genes_devices_golden(mini_genome, ref_fasta):
    """The public API's ``devices=`` path must reproduce the golden hit set."""
    from kmergma.api import find_genes

    from tests.test_api_golden import REFERENCE_GOLDEN_HITS

    hits = find_genes(
        genome_path=mini_genome, ref_path=ref_fasta, verbose=False, devices=8
    )[0]
    assert [h.description for h in hits] == REFERENCE_GOLDEN_HITS


def test_find_genes_cluster_mode_devices_golden(mini_genome, ref_fasta):
    from kmergma.api import find_genes_cluster_mode

    hits = find_genes_cluster_mode(
        genome_path=mini_genome,
        ref_path=ref_fasta,
        kmer_dist_thrs=[35.0, 31.0, 38.0, 34.0, 27.0, 27.0],
        buffer=100,
        verbose=False,
        devices=8,
    )[0]
    assert [h.description for h in hits] == [
        "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
        "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
        "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
    ]


def test_sharded_cluster_streams_match_serial(ref_fasta, mini_genome):
    """Sharded cluster streams are bit-identical to the single-device
    cluster engine on real data."""
    from kmergma.ops.reference import cluster_ref_api, eliminate_null_params
    from kmergma.ops.scan_cluster import ClusterScanEngine
    from kmergma.utils.fasta import as_records

    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    record = as_records(mini_genome)[0]
    thrs = [35.0, 31.0, 38.0, 34.0, 27.0, 27.0]

    single = ClusterScanEngine(clusters.profiles, k=6, chunk_windows=8192)
    sharded = ShardedClusterScanEngine(
        clusters.profiles, k=6, mesh=make_mesh(8), chunk_windows=8192
    )
    a = single.record_streams(record.codes, thrs)
    b = sharded.record_streams(record.codes, thrs)
    assert a == b


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (4096,)


def test_tp_profile_lookup_matches_replicated():
    """Profile-axis TP: the sharded S[K] lookup equals the replicated one
    (SURVEY.md section 2.2 TP row, for large-k tables)."""
    import jax.numpy as jnp

    from kmergma.parallel.tp_lookup import shard_profile, tp_profile_lookup

    rng = np.random.default_rng(8)
    k = 7  # 16384 bins -> 2048 per device on the 8-device mesh
    s = rng.integers(0, 50, 4**k).astype(np.int32)
    kcodes = rng.integers(0, 4**k, 100000).astype(np.int32)

    mesh = make_mesh(8)
    s_dev = shard_profile(s, mesh)
    got = np.asarray(tp_profile_lookup(jnp.asarray(kcodes), s_dev, mesh=mesh))
    assert got.tolist() == s[kcodes].tolist()


def test_tp_engine_matches_host_k10():
    """The TP engine scans a k=10 (4^10 = 1M bins) profile ON the mesh with
    the table sharded, producing streams and hits bit-identical to the exact
    int64 host engine (the big-k regime: a 1M-bin table, below the
    int32-headroom guard)."""
    from kmergma.models.state_machine import replay_single
    from kmergma.ops.scan_host import HostScanEngine
    from kmergma.parallel.tp_lookup import TPScanEngine

    rng = np.random.default_rng(10)
    k, ws, r = 10, 1200, 3
    n = 9000
    # profile from r random records so S is sparse but realistic
    from kmergma.ops.kmers import kmer_count

    s = np.zeros(4**k, dtype=np.int64)
    for _ in range(r):
        s += kmer_count(rng.integers(0, 4, ws, dtype=np.int8), k).astype(np.int64)
    codes = rng.integers(0, 4, n, dtype=np.int8)
    # plant one reference-like region so candidates exist
    ref_like = rng.integers(0, 4, ws, dtype=np.int8)
    codes[4000 : 4000 + ws] = ref_like

    host = HostScanEngine(s, k=k, ws=ws, r=r)
    d0_h, stream_h, _ = host.record_stream(codes, thr := 120.0)

    tp = TPScanEngine(s, k=k, ws=ws, r=r, mesh=make_mesh(8), chunk_windows=4096)
    tp.assemble_mode = "full"  # full streams: element-wise oracle check
    d0_t, stream_t, _ = tp.record_stream(codes, thr)
    assert d0_t == d0_h
    assert stream_t == stream_h
    assert len(stream_t) > 0

    # reduced assembly (production default): minimal equivalent stream -
    # identical REPLAY, not identical elements
    tp.assemble_mode = "reduced"
    tp.full_fetch_windows = 0
    d0_r, stream_r, _ = tp.record_stream(codes, thr)
    assert d0_r == d0_h
    hits_h = replay_single(stream_h, d0_h, thr, k, ws, n, 50)
    hits_r = replay_single(stream_r, d0_r, thr, k, ws, n, 50)
    assert hits_r == hits_h
    assert len(stream_r) > 0
    hits_h = replay_single(stream_h, d0_h, thr, k, ws, n, 50)
    hits_t = replay_single(stream_t, d0_t, thr, k, ws, n, 50)
    assert hits_t == hits_h


def test_mine_genome_routes_big_k_to_tp(monkeypatch):
    """mine_genome's engine selection routes k=10 profiles through the TP
    engine when a mesh is available (tp_lookup's production caller)."""
    from kmergma.models import miner as miner_mod
    from kmergma.ops.reference import RefProfile

    seen = {}
    import kmergma.parallel.tp_lookup as tpl

    real = tpl.TPScanEngine

    class Spy(real):
        def __init__(self, *a, **kw):
            seen["used"] = True
            super().__init__(*a, **kw)

    monkeypatch.setattr(tpl, "TPScanEngine", Spy)
    rng = np.random.default_rng(0)
    from kmergma.ops.kmers import kmer_count
    from kmergma.utils.fasta import FastaRecord

    k, ws = 10, 600
    seq = rng.integers(0, 4, ws, dtype=np.int8)
    s = kmer_count(seq, k).astype(np.int64)
    prof = RefProfile(
        mean_kfv=s.astype(np.float64), sum_kfv=s, n_records=1, windowsize=ws,
        consensus="A" * ws, k=k,
    )
    rec = FastaRecord("contig", bytes(b"ACGT"[c] for c in rng.integers(0, 4, 3000)))
    res = miner_mod.mine_genome([rec], prof, thr=200.0, do_align=False)
    assert seen.get("used"), "big-k scan did not route through TPScanEngine"
    assert res.stats.records_scanned == 1
