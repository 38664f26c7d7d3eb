"""Exact int64 host engine (ops/scan_host.py): the beyond-int32 fallback."""

import numpy as np
import pytest

from kmergma.ops.scan import ScanEngine, check_int32_headroom, scan_window_distances_np
from kmergma.ops.scan_host import (
    HostScanEngine,
    check_int64_headroom,
    scan_window_distances_np_i64,
)
from kmergma.utils.native import scan_rolling_i64_native


def test_native_rolling_matches_oracle():
    rng = np.random.default_rng(1)
    k, ws, r = 5, 60, 7
    codes = rng.integers(0, 4, 3000, dtype=np.int8)
    s = rng.integers(0, 12, 4**k).astype(np.int64)
    oracle = scan_window_distances_np(codes, s, k, ws, r)
    d = scan_rolling_i64_native(codes, s, k, ws, r)
    if d is None:
        pytest.skip("native toolchain unavailable")
    assert d.tolist() == oracle.tolist()
    # numpy fallback agrees too
    assert scan_window_distances_np_i64(codes, s, k, ws, r).tolist() == oracle.tolist()


def test_host_engine_stream_matches_device_engine():
    rng = np.random.default_rng(2)
    k, ws, r = 6, 120, 9
    codes = rng.integers(0, 4, 20000, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int64)
    dev = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=4096)
    host = HostScanEngine(s, k=k, ws=ws, r=r)
    _, probe, _ = host.record_stream(codes, thr=1e9)
    thr = float(np.percentile([v for _, v in probe], 5))
    dev.assemble_mode = "full"  # full streams: element-wise comparison below
    d0_a, stream_a, _ = dev.record_stream(codes, thr)
    d0_b, stream_b, _ = host.record_stream(codes, thr)
    assert d0_a == d0_b
    # host streams carry exact values for edges too; the device stream's
    # edge stand-ins replay identically, so compare through the replay
    from kmergma.models.state_machine import replay_single

    hits_a = replay_single(stream_a, d0_a, thr, k, ws, codes.shape[0], buff=10)
    hits_b = replay_single(stream_b, d0_b, thr, k, ws, codes.shape[0], buff=10)
    assert hits_a == hits_b
    # below-threshold entries bit-identical
    below_a = sorted((j, v) for j, v in stream_a if v < thr)
    below_b = sorted((j, v) for j, v in stream_b if v < thr)
    assert below_a == below_b

    # the production reduced assembly replays identically
    dev.assemble_mode = "reduced"
    d0_r, stream_r, _ = dev.record_stream(codes, thr)
    hits_r = replay_single(stream_r, d0_r, thr, k, ws, codes.shape[0], buff=10)
    assert hits_r == hits_b


def test_miner_falls_back_beyond_int32(ref_fasta, mini_genome):
    """A profile scaled beyond int32 headroom must route through the host
    engine and still produce the same hits as an equivalent scaled-down
    profile on the device engine."""
    from kmergma.models.miner import mine_genome
    from kmergma.ops.reference import gen_ref_ws_cons

    profile = gen_ref_ws_cons(ref_fasta, 6)
    # inflate the denominator far past int32 headroom: S*m, R*m keeps the
    # mean profile (and therefore all true distances) identical
    m = 3000
    big = type(profile)(
        mean_kfv=profile.mean_kfv,
        sum_kfv=profile.sum_kfv * m,
        n_records=profile.n_records * m,
        windowsize=profile.windowsize,
        consensus=profile.consensus,
        k=profile.k,
    )
    with pytest.raises(OverflowError):
        check_int32_headroom(big.sum_kfv, big.windowsize, big.k, big.n_records)
    check_int64_headroom(big.sum_kfv, big.windowsize, big.k, big.n_records)

    res_big = mine_genome(mini_genome, big, thr=30, get_hit_loci=True)
    res_ref = mine_genome(mini_genome, profile, thr=30, get_hit_loci=True)
    assert [h.description for h in res_big.hits] == [h.description for h in res_ref.hits]
    assert res_big.hit_loci == res_ref.hit_loci
