"""Conformance of the one-pass cluster engine (ops/scan_cluster.py):
per-cluster candidate streams must be bit-identical to running each
cluster's ScanEngine serially (the original production path)."""

import numpy as np
import pytest

from kmergma.ops.reference import RefProfile, cluster_ref_api, eliminate_null_params
from kmergma.ops.scan import ScanEngine
from kmergma.ops.scan_cluster import ClusterScanEngine


def _mk_profile(rng, k, ws, r):
    """A synthetic integer summed profile of r random records of length ws."""
    from kmergma.ops.kmers import kmer_count

    sums = np.zeros(4**k, dtype=np.int64)
    for _ in range(r):
        sums += kmer_count(rng.integers(0, 4, size=ws, dtype=np.int8), k).astype(np.int64)
    return RefProfile(
        mean_kfv=sums / r, sum_kfv=sums, n_records=r, windowsize=ws,
        consensus="A" * ws, k=k,
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_cluster_streams_match_serial_engines(seed):
    rng = np.random.default_rng(seed)
    k = 5
    windowsizes = [96, 96, 101, 120]  # two shared-ws clusters + two singletons
    profiles = [_mk_profile(rng, k, ws, r) for ws, r in zip(windowsizes, [3, 5, 4, 2])]
    codes = rng.integers(0, 4, size=5000, dtype=np.int8)
    # plant a near-profile region so some clusters see dense candidates
    thrs = [55.0, 60.0, 50.0, 58.0]

    ce = ClusterScanEngine(profiles, k=k)
    fused = ce.record_streams(codes, thrs)

    max_ws = max(windowsizes)
    for ci, (p, thr) in enumerate(zip(profiles, thrs)):
        eng = ScanEngine(p.sum_kfv, k=k, ws=p.windowsize, r=p.n_records)
        prep = eng.prepare_codes(codes, max_ws=max_ws)
        d0, stream, _ = eng.record_stream(codes, thr, codes_dev=prep)
        assert fused[ci][0] == d0, f"cluster {ci} dist0 mismatch"
        assert fused[ci][1] == stream, f"cluster {ci} stream mismatch"


def test_cluster_groups_share_windowsize(ref_fasta):
    clusters = eliminate_null_params(cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25]))
    ce = ClusterScanEngine(clusters.profiles, k=6)
    # reference test set: 6 clusters with windowsizes [288,288,288,289,290,289]
    # -> 3 groups, so the pair-count hot loop runs 3x not 6x per span
    assert len(ce.groups) == 3
    assert sum(len(g[2]) for g in ce.groups) == 6


def test_cluster_engine_thr_count_mismatch():
    rng = np.random.default_rng(0)
    profiles = [_mk_profile(rng, 4, 50, 2)]
    ce = ClusterScanEngine(profiles, k=4)
    with pytest.raises(ValueError):
        ce.record_streams(rng.integers(0, 4, size=200, dtype=np.int8), [1.0, 2.0])
