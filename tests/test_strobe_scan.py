"""Device strobemer scan must match the sequential reference recurrence
exactly (including the off-by-one drift closed form)."""

import numpy as np

import jax.numpy as jnp

from kmergma.ops.scan_strobe import strobe_scan_from_codes, strobe_scan_distances_np
from kmergma.ops.strobemers import strobe_2_mer_codes


def test_strobe_scan_matches_sequential_oracle():
    rng = np.random.default_rng(21)
    s, w_min, w_max, q, ws, r = 2, 3, 5, 5, 97, 11
    k = w_max + s - 1
    codes = rng.integers(0, 4, 3000, dtype=np.int8)
    sprof = rng.integers(0, 9, 4 ** (2 * s)).astype(np.int32)

    expected = strobe_scan_distances_np(codes, sprof, s, w_min, w_max, q, ws, r)
    sc = strobe_2_mer_codes(codes, s, w_min, w_max, q)
    n_steps = codes.shape[0] - ws - 1
    got = np.asarray(
        strobe_scan_from_codes(
            jnp.asarray(sc.astype(np.int32)), jnp.asarray(sprof), ws - k, r, n_steps
        )
    )
    assert got.tolist() == expected.tolist()


def test_strobe_scan_float_matches_miner_recurrence():
    """The scaled-integer distances equal the float recurrence the
    strobe miner runs (up to float64 accumulation noise)."""
    from kmergma.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome

    profile = gen_strobe_ref_ws_cons("tests/data/Alp_V_ref.fasta")
    res = strobe_mine_genome(
        "tests/data/Alp_V_locus.fasta", profile, thr=30, do_return_dists=True, do_align=False
    )

    from kmergma.utils.fasta import read_fasta

    rec = next(read_fasta("tests/data/Alp_V_locus.fasta"))
    k = profile.k
    # integer path needs the integer summed spectrum: rebuild it
    import numpy as np
    from kmergma.ops.strobemers import ungapped_strobe_2_mer_count_into

    sums = np.zeros(4 ** (2 * profile.s))
    n = 0
    for r2 in read_fasta("tests/data/Alp_V_ref.fasta"):
        ungapped_strobe_2_mer_count_into(r2.codes, sums, profile.s, profile.w_min, profile.w_max, profile.q)
        n += 1
    d_scaled = strobe_scan_distances_np(
        rec.codes, sums.astype(np.int64), profile.s, profile.w_min, profile.w_max,
        profile.q, profile.windowsize, n,
    )
    dist_exact = d_scaled[1:] / (2.0 * k * n * n)
    assert res.dists.shape[0] == dist_exact.shape[0]
    np.testing.assert_allclose(res.dists, dist_exact, rtol=0, atol=1e-6)


def test_strobe_span_engine_hits_match_dense_replay():
    """The production span engine's hits (fixed compiled shapes, pruned
    bitmap + region machinery) equal replaying the dense sequential-oracle
    distance array - hit-level bit-equality for the strobe path."""
    from kmergma.models.state_machine import candidate_stream_from_dists, replay_single
    from kmergma.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma.utils.fasta import read_fasta

    profile = gen_strobe_ref_ws_cons("tests/data/Alp_V_ref.fasta")
    thr = 30.0
    res = strobe_mine_genome(
        "tests/data/Alp_V_locus.fasta", profile, thr=thr, do_align=False,
        get_hit_loci=True, chunk_windows=4096,  # force several spans
    )

    rec = next(read_fasta("tests/data/Alp_V_locus.fasta"))
    d_scaled = strobe_scan_distances_np(
        rec.codes, profile.sum_kfv, profile.s, profile.w_min, profile.w_max,
        profile.q, profile.windowsize, profile.n_records,
    )
    scale = 2.0 * profile.k * profile.n_records**2
    dists = d_scaled.astype(np.float64) / scale
    raw = replay_single(
        candidate_stream_from_dists(dists, thr), float(dists[0]), thr,
        k=profile.k, ws=profile.windowsize, seq_len=len(rec), buff=50, cmi_offset=0,
    )
    assert len(res.hits) == len(raw) > 0
    for hit, got in zip(raw, res.hits):
        assert f"MatchPos = {hit.start}:{hit.stop}" in got.description


def test_device_extract_matches_host_path(ref_fasta, mini_genome):
    """strobe_mine_genome's device-extraction path (the one bench.py times:
    quarter-packed genome H2D -> strobe_2_mer_codes_jnp -> span engine) must
    produce the same hits as host extraction."""
    from kmergma.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome

    prof = gen_strobe_ref_ws_cons(ref_fasta)
    host = strobe_mine_genome(
        mini_genome, prof, thr=30.0, get_hit_loci=True, device_extract=False
    )
    dev = strobe_mine_genome(
        mini_genome, prof, thr=30.0, get_hit_loci=True, device_extract=True
    )
    assert [h.description for h in dev.hits] == [h.description for h in host.hits]
    assert dev.hit_loci == host.hit_loci
    assert len(dev.hits) > 0


def test_device_extract_with_genome_dev(ref_fasta, mini_genome):
    """The genome_dev fast path (device-resident genome codes, as the bench
    supplies) matches the transfer path."""
    import jax.numpy as jnp

    from kmergma.models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome
    from kmergma.utils.fasta import as_records

    prof = gen_strobe_ref_ws_cons(ref_fasta)
    rec = as_records(mini_genome)[0]
    pad = np.zeros(1 << 16, dtype=np.int8)
    gdev = jnp.asarray(np.concatenate([rec.codes, pad]))
    a = strobe_mine_genome([rec], prof, thr=30.0, device_extract=True)
    b = strobe_mine_genome([rec], prof, thr=30.0, genome_dev=[gdev])
    assert [h.description for h in a.hits] == [h.description for h in b.hits]
