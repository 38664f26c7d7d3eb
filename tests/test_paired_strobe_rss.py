"""PairedKmers, Strobemers and RSS conformance tests
(reference test-KmerGMA.jl:154-162,346-366 and test-StrobemerGMA.jl)."""

import numpy as np

from kmergma.ops.kmers import as_kmer, as_uint
from kmergma.ops.paired_kmers import (
    as_index,
    initialize_kmers,
    kmer_pair_count,
    kmer_pair_count_into,
)
from kmergma.ops.rss import HUMAN_RSSV, align_rss, is_rss, rss_dist
from kmergma.ops.strobemers import (
    get_strobe_2_mer,
    randstrobe_score,
    ungapped_strobe_2_mer_count,
)

from .conftest import TEST_SEQ


class TestPairedKmers:
    def test_initialize(self):
        assert initialize_kmers(TEST_SEQ, 6) == (228, 228)
        assert as_kmer(initialize_kmers(TEST_SEQ, 3)[0], 2) == "AT"

    def test_as_index(self):
        assert as_index(as_uint("ATGC"), as_uint("ATGC"), 4) == 14650

    def test_pair_count_golden(self):
        assert kmer_pair_count(TEST_SEQ, 1).tolist() == [4.0] * 16
        b2 = kmer_pair_count(TEST_SEQ, 2)
        assert b2.sum() == 49.0
        assert round(float(b2.mean()), 5) == 0.19141

    def test_pair_count_into(self):
        bins = np.zeros(16)
        kmer_pair_count_into(TEST_SEQ, 1, bins)
        assert bins.tolist() == [4.0] * 16
        bins = np.zeros(256)
        kmer_pair_count_into(TEST_SEQ, 2, bins)
        assert bins.sum() == 49.0
        assert round(float(bins.mean()), 5) == 0.19141


class TestStrobemers:
    def test_scores(self):
        assert randstrobe_score("ATGC", "GTGT", 5) == 4
        assert randstrobe_score("ATGC", "GTGT", 7) == 6

    def test_get_strobe_2_mer(self):
        assert get_strobe_2_mer("ATCTCTGTTT") == "AT--CT----"
        assert get_strobe_2_mer(TEST_SEQ) == "ATGC----"
        assert get_strobe_2_mer("ATCTCTGTTT", with_gap=False) == "ATCT"
        assert get_strobe_2_mer(TEST_SEQ, with_gap=False) == "ATGC"

    def test_ungapped_count(self):
        counts = ungapped_strobe_2_mer_count(TEST_SEQ, s=1, w_min=2, w_max=4)
        assert round(float(counts.mean()), 4) == 0.3125
        assert counts[3] == 2  # Julia counts[4]
        assert counts[4] == counts[11] == counts[14] == 1


class TestRSS:
    def test_align_rss_cigar(self):
        window = (TEST_SEQ + HUMAN_RSSV + TEST_SEQ)[:44]
        assert align_rss(window).cigar == "8D28=8D"

    def test_rss_dist(self):
        assert rss_dist(HUMAN_RSSV, HUMAN_RSSV) == 0
        assert rss_dist(HUMAN_RSSV[:-1] + "T", HUMAN_RSSV) == 1

    def test_is_rss(self):
        window = (TEST_SEQ + HUMAN_RSSV + TEST_SEQ)[:44]
        assert is_rss(window) is True
        assert is_rss(TEST_SEQ * 6) is False


class TestStrobeMiner:
    def test_strobe_find_genes_runs(self, mini_genome, ref_fasta):
        from kmergma.api import strobemer_find_genes

        out = strobemer_find_genes(
            genome_path=mini_genome, ref_path=ref_fasta, verbose=False, do_return_hit_loci=True
        )
        hits, loci = out
        assert len(hits) == len(loci)
        # the scan must at least rediscover the strongest V-gene locus
        assert any(6700 <= l <= 7200 for l in loci)


def test_strobe_codes_jnp_matches_numpy():
    """Device strobemer extraction == the NumPy extraction bit-for-bit
    (incl. the reference's overflow-selection semantics)."""
    import jax.numpy as jnp

    from kmergma.ops.strobemers import strobe_2_mer_codes, strobe_2_mer_codes_jnp

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 5000, dtype=np.int8)
    for (s, w_min, w_max, q) in [(2, 3, 5, 5), (2, 2, 6, 7), (3, 4, 8, 11)]:
        want = strobe_2_mer_codes(codes, s, w_min, w_max, q)
        got = np.asarray(strobe_2_mer_codes_jnp(jnp.asarray(codes), s, w_min, w_max, q))
        assert got.tolist() == want.tolist(), (s, w_min, w_max, q)


def test_paired_kmer_device_matches_host_fuzz():
    """kmer_pair_count_device (rolling codes + histogram outer product)
    must equal the host O(n^2) loop bit-for-bit, including the carried
    inner-register quirk in the first k-1 steady-state positions."""
    from kmergma.ops.paired_kmers import kmer_pair_count, kmer_pair_count_device

    rng = np.random.default_rng(3)
    for k in (1, 2, 3, 4):
        for n in (0, 1, 2, k - 1, k, k + 1, 7, 50, 333):
            if n < 0:
                continue
            codes = rng.integers(0, 4, n, dtype=np.int8)
            host = kmer_pair_count(codes, k)
            dev = kmer_pair_count_device(codes, k)
            assert dev.tolist() == host.tolist(), (k, n)
