"""End-to-end golden conformance tests: hit records must match the reference
implementation bit-for-bit on the real test fastas
(reference test-KmerGMA.jl:164-296).  These are the conformance oracle for
this rebuild (SURVEY.md section 4)."""

import numpy as np
import pytest

from kmergma import cluster_ref_api, gen_ref_ws_cons
from kmergma.models.miner import mine_genome
from kmergma.models.omn_miner import mine_genome_clusters


@pytest.fixture(scope="module")
def profile6(ref_fasta):
    return gen_ref_ws_cons(ref_fasta, 6)


class TestGenomeMiner:
    def test_no_align(self, profile6, test_genome):
        # reference test-KmerGMA.jl:167-177 (the Julia vector was pre-seeded
        # with one junk record, so its length 8 = 7 real hits)
        res = mine_genome(test_genome, profile6, thr=30, do_align=False)
        assert len(res.hits) == 7
        assert res.hits[1].description == (
            "JQ684648.1 | dist = 9.21 | MatchPos = 20380:20768 | GenomePos = 0 | Len = 389"
        )
        assert res.hits[4].description == (
            "AM773548.1 | dist = 8.1 | MatchPos = 6807:7195 | GenomePos = 444023 | Len = 389"
        )

    def test_align_and_hit_loci(self, profile6, test_genome):
        # reference test-KmerGMA.jl:179-193
        res = mine_genome(test_genome, profile6, thr=30, do_align=True, get_hit_loci=True)
        assert len(res.hits) == 7
        assert res.hit_loci == [8543, 20425, 221912, 234018, 450875, 467930, 477868]
        assert res.hits[1].description == (
            "JQ684648.1 | dist = 9.21 | MatchPos = 20425:20713 | GenomePos = 0 | Len = 289"
        )
        assert res.hits[4].description == (
            "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 444023 | Len = 289"
        )
        assert res.hits[5].description == (
            "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 444023 | Len = 295"
        )

    def test_return_dists(self, profile6, test_genome):
        # reference test-KmerGMA.jl:195-211: thr=10, no align (the Julia
        # testset title says buff=0 but the call leaves the default 50)
        res = mine_genome(
            test_genome, profile6, thr=10, do_align=False, do_return_dists=True
        )
        assert res.dists.shape[0] == 484127
        assert round(float(res.dists.mean())) == 46
        assert len(res.hits) == 3
        assert res.hits[0].description == (
            "JQ684648.1 | dist = 9.21 | MatchPos = 20380:20768 | GenomePos = 0 | Len = 389"
        )
        assert res.hits[-1].description == (
            "AM773548.1 | dist = 8.1 | MatchPos = 6807:7195 | GenomePos = 444023 | Len = 389"
        )


class TestOmnMiner:
    def test_custom_thresholds(self, ref_fasta, mini_genome):
        # reference test-KmerGMA.jl:215-226 (passes 6 thresholds for 5
        # clusters; the extra one is unused)
        clusters = cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25], include_avg=False)
        res = mine_genome_clusters(
            mini_genome, clusters.profiles, thr_vec=[37, 33, 38, 34, 28], buff=200
        )
        assert [h.description for h in res.hits] == [
            "AM773548.1 | Dist = 20.17 | KFV = 3 | MatchPos = 6852:7139 | GenomePos = 0 | Len = 288",
            "AM773548.1 | Dist = 33.96 | KFV = 4 | MatchPos = 23907:24198 | GenomePos = 0 | Len = 292",
            "AM773548.1 | Dist = 26.17 | KFV = 3 | MatchPos = 33845:34132 | GenomePos = 0 | Len = 288",
        ]


class TestMiniGenome:
    def test_single_profile_mini(self, profile6, mini_genome):
        # matches the reference MultiThread single-record golden
        # (test-KmerGMA.jl:233-249) and findGenes (:257-263)
        res = mine_genome(mini_genome, profile6, thr=30, do_align=True)
        assert [h.description for h in res.hits] == [
            "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | GenomePos = 0 | Len = 289",
            "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | GenomePos = 0 | Len = 295",
            "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | GenomePos = 0 | Len = 289",
        ]

    def test_hit_sequences_roundtrip(self, profile6, mini_genome):
        from kmergma.utils.fasta import read_fasta

        res = mine_genome(mini_genome, profile6, thr=30, do_align=True)
        genome = next(read_fasta(mini_genome)).seq_str().upper()
        h = res.hits[0]
        assert h.seq_str() == genome[6852 - 1 : 7140]


class TestRecordKmerGMA:
    """MultiThread record-level output format (ref MultiThread/GenomeMiner.jl,
    golden strings test-KmerGMA.jl:229-254): same hits, no GenomePos field."""

    def test_single_record_golden(self, mini_genome, ref_fasta):
        from kmergma.models.miner import record_kmergma
        from kmergma.ops.reference import gen_ref_ws_cons
        from kmergma.utils.fasta import as_records

        profile = gen_ref_ws_cons(ref_fasta, 6)
        record = as_records(mini_genome)[0]
        hits = record_kmergma(record, profile, thr=30)
        assert [h.description for h in hits] == [
            "AM773548.1 | dist = 8.1 | MatchPos = 6852:7140 | Len = 289",
            "AM773548.1 | dist = 24.87 | MatchPos = 23907:24201 | Len = 295",
            "AM773548.1 | dist = 10.99 | MatchPos = 33845:34133 | Len = 289",
        ]

    def test_short_record_skipped(self, ref_fasta):
        from kmergma.models.miner import record_kmergma
        from kmergma.ops.reference import gen_ref_ws_cons
        from kmergma.utils.fasta import FastaRecord

        profile = gen_ref_ws_cons(ref_fasta, 6)
        assert record_kmergma(FastaRecord("tiny", b"ACGT" * 10), profile) == []
