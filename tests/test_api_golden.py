"""API-level golden conformance + warning-path tests
(reference test-KmerGMA.jl:256-296)."""

import warnings

import pytest

from kmergma.api import find_genes, find_genes_cluster_mode, write_results


REFERENCE_GOLDEN_HITS = [
    "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
    "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
    "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
]


def test_find_genes_golden(mini_genome, ref_fasta):
    # reference test-KmerGMA.jl:257-263, DEFAULT (auto-threshold) path.
    # The threshold estimator replays Julia's seeded Xoshiro stream
    # bit-for-bit (utils/julia_rand.py), so the auto threshold lands on the
    # reference's side of the knife-edge window at dist 29.51 and the hit
    # set equals the reference golden exactly.
    a = find_genes(genome_path=mini_genome, ref_path=ref_fasta, verbose=False)[0]
    assert [h.description for h in a] == REFERENCE_GOLDEN_HITS


def test_find_genes_explicit_threshold(mini_genome, ref_fasta):
    # An explicit threshold below the auto estimate warns but yields the
    # same hit set (the 29.51 knife-edge window only matters above it).
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # explicit thr below estimate warns
        a = find_genes(
            genome_path=mini_genome, ref_path=ref_fasta, kmer_dist_thr=28.0, verbose=False
        )[0]
    assert [h.description for h in a] == REFERENCE_GOLDEN_HITS


def test_find_genes_cluster_mode_golden(mini_genome, ref_fasta):
    # reference test-KmerGMA.jl:265-271
    a = find_genes_cluster_mode(
        genome_path=mini_genome,
        ref_path=ref_fasta,
        kmer_dist_thrs=[35.0, 31.0, 38.0, 34.0, 27.0, 27.0],
        buffer=100,
        verbose=False,
    )[0]
    assert [h.description for h in a] == [
        "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
        "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24193 | GenomePos = 0 | Len = 287",
        "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
    ]


def test_output_ordering(mini_genome, ref_fasta):
    out = find_genes(
        genome_path=mini_genome,
        ref_path=ref_fasta,
        do_return_hit_loci=True,
        do_return_align=True,
        do_return_dists=True,
        verbose=False,
    )
    assert len(out) == 4  # hits, loci, aligns, dists - fixed priority order
    hits, loci, aligns, dists = out
    assert len(hits) == len(loci) == len(aligns) == 3
    assert dists.shape[0] == 41260 - 289


class TestWarnings:
    def test_low_k_warns(self, mini_genome, ref_fasta):
        with pytest.warns(UserWarning, match="Such a low k value of 3"):
            find_genes(genome_path=mini_genome, ref_path=ref_fasta, k=3, verbose=False)

    def test_low_k_warns_cluster(self, mini_genome, ref_fasta):
        with pytest.warns(UserWarning, match="Such a low k value of 3"):
            find_genes_cluster_mode(
                genome_path=mini_genome, ref_path=ref_fasta, k=3, verbose=False
            )

    def test_return_dists_warns(self, mini_genome, ref_fasta):
        with pytest.warns(UserWarning, match="do_return_dists to true may be very memory intensive"):
            find_genes(
                genome_path=mini_genome, ref_path=ref_fasta, verbose=False, do_return_dists=True
            )

    def test_too_high_thresholds_warn(self, mini_genome, ref_fasta):
        with pytest.warns(UserWarning, match=r"at index/indicies 1, 2, 4, 5, 6 for k = 6"):
            find_genes_cluster_mode(
                genome_path=mini_genome,
                ref_path=ref_fasta,
                verbose=False,
                kmer_dist_thrs=[100.0, 200.0, 20.0, 300.0, 200.0, 100.0],
            )


def test_write_results(tmp_path, mini_genome, ref_fasta):
    from kmergma.utils.fasta import read_fasta

    hits = find_genes(genome_path=mini_genome, ref_path=ref_fasta, verbose=False)[0]
    out = tmp_path / "hits.fasta"
    write_results(hits, str(out))
    back = list(read_fasta(out))
    assert [r.description for r in back] == [h.description for h in hits]
    assert [r.seq for r in back] == [h.seq for h in hits]
