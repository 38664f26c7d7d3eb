"""Golden tests for consensus profiles, reference generation and clustering,
ported from the reference suite (reference test-KmerGMA.jl:28-112)."""

import numpy as np

from kmergma import (
    Profile,
    cluster_ref_api,
    eliminate_null_params,
    gen_ref_ws_cons,
    get_cluster_index,
)
from kmergma.consts import encode_seq
from kmergma.utils.fasta import read_fasta

from .conftest import TEST_CONSENSUS_SEQ, TEST_SEQ


class TestProfile:
    def test_empty(self):
        assert Profile(2).counts.tolist() == [[0, 0]] * 4
        assert Profile(3)["A"].tolist() == [0, 0, 0]

    def test_add_and_lengthen(self):
        # reference test-KmerGMA.jl:32-45
        a = Profile(8)
        a.add(TEST_SEQ)
        assert a.counts.tolist() == [
            [1, 0, 0, 0, 1, 0, 0, 0],
            [0, 0, 0, 1, 0, 0, 0, 1],
            [0, 0, 1, 0, 0, 0, 1, 0],
            [0, 1, 0, 0, 0, 1, 0, 0],
        ]
        a.lengthen(9)
        assert a.len == 9
        a.add(TEST_SEQ[:7] + "G")
        a.add(TEST_SEQ[:7] + "G")
        assert a.counts.tolist() == [
            [3, 0, 0, 0, 3, 0, 0, 0, 0],
            [0, 0, 0, 3, 0, 0, 0, 1, 0],
            [0, 0, 3, 0, 0, 0, 3, 2, 0],
            [0, 3, 0, 0, 0, 3, 0, 0, 0],
        ]
        assert a.consensus_str()[:8] == TEST_SEQ[:7] + "G"


class TestGenRefWsCons:
    def test_k1_golden(self, ref_fasta):
        # reference test-KmerGMA.jl:50-51
        ref = gen_ref_ws_cons(ref_fasta, 1)
        assert ref.mean_kfv.tolist() == [63.25, 73.70238095238095, 89.26190476190476, 62.38095238095238]
        assert ref.windowsize == 289
        assert ref.consensus == TEST_CONSENSUS_SEQ

        ref2, maxlen = gen_ref_ws_cons(ref_fasta, 1, get_maxlen=True)
        assert maxlen == 299
        assert ref2.mean_kfv.tolist() == ref.mean_kfv.tolist()

    def test_k2_golden(self, ref_fasta):
        assert gen_ref_ws_cons(ref_fasta, 2).mean_kfv.tolist() == [
            11.178571428571429, 15.964285714285714, 24.154761904761905, 11.88095238095238,
            22.76190476190476, 17.904761904761905, 8.154761904761905, 24.88095238095238,
            18.607142857142858, 22.202380952380953, 30.369047619047617, 18.07142857142857,
            10.702380952380953, 17.047619047619047, 26.166666666666664, 7.5476190476190474,
        ]

    def test_k6_golden_slice(self, ref_fasta):
        kfv = gen_ref_ws_cons(ref_fasta, 6).mean_kfv
        assert kfv[4:10].tolist() == [
            0.011904761904761904, 0.023809523809523808, 0.0, 0.0, 0.023809523809523808, 0.0,
        ]

    def test_record_vector_input(self, ref_fasta):
        recs = list(read_fasta(ref_fasta))
        ref = gen_ref_ws_cons(recs, 1)
        assert ref.mean_kfv.tolist() == [63.25, 73.70238095238095, 89.26190476190476, 62.38095238095238]
        assert ref.windowsize == 289


class TestClusterRefApi:
    def test_get_cluster_index(self):
        assert get_cluster_index(5, [1, 2, 6, 10]) == 3
        assert get_cluster_index(12, [1, 2, 6, 10]) == 5
        assert get_cluster_index(0, [1, 2, 6, 10]) == 1

    def test_no_avg(self, ref_fasta):
        # reference test-KmerGMA.jl:76-82
        a = cluster_ref_api(ref_fasta, 1, cutoffs=[7, 12, 20, 25], include_avg=False)
        assert [kfv.tolist() for kfv in a.kfvs] == [
            [62.785714285714285, 72.78571428571429, 89.78571428571429, 62.642857142857146],
            [63.13333333333333, 71.33333333333333, 90.53333333333333, 62.6],
            [63.5, 70.71428571428571, 90.78571428571429, 64.07142857142857],
            [62.54545454545455, 68.72727272727273, 91.36363636363636, 64.54545454545455],
            [63.666666666666664, 78.53333333333333, 86.9, 60.56666666666667],
        ]
        assert a.windowsizes == [288, 288, 289, 287, 290]
        assert len(a.consensus_seqs) == 5
        assert a.consensus_seqs[0][:4] == "CAGG"
        assert a.invalid == [False] * 5

    def test_with_avg(self, ref_fasta):
        # reference test-KmerGMA.jl:86-92
        a = cluster_ref_api(ref_fasta, 1, cutoffs=[7, 12, 20, 25])
        assert a.kfvs[-1].tolist() == [63.25, 73.70238095238095, 89.26190476190476, 62.38095238095238]
        assert a.windowsizes == [288, 288, 289, 287, 290, 289]
        assert len(a.consensus_seqs) == 6
        assert a.invalid == [False] * 6

    def test_eliminate_null_params(self, ref_fasta):
        # reference test-KmerGMA.jl:107-110
        clusters = cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25])
        kept = eliminate_null_params(clusters)
        assert kept.windowsizes == [288, 288, 288, 289, 290, 289]
        assert len(kept.kfvs) == len(kept.consensus_seqs) == 6
