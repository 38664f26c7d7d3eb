"""Threshold-estimation tests (reference test-KmerGMA.jl:114-126).

These goldens are BIT-EXACT with the reference: utils/julia_rand.py
replicates Julia's seeded Xoshiro256++ task-local RNG, BioSequences'
``randdnaseq`` sampling, and the NDL range sampler, so the pinned values
are the reference's own.
"""

import numpy as np

from kmergma import (
    cluster_ref_api,
    estimate_optimal_threshold,
    estimate_optimal_thresholds,
    gen_ref_ws_cons,
)
from kmergma.consts import decode_seq, encode_seq
from kmergma.ops.thresholds import mutate_seq, mutate_seq_codes
from kmergma.utils.julia_rand import JuliaXoshiro


def test_julia_xoshiro_core():
    # Julia: Random.seed!(42); rand() - known stream head
    rng = JuliaXoshiro(42)
    assert rng.rand_float64() == 0.6293451231426089


def test_single_threshold_reference_golden(ref_fasta):
    # reference test-KmerGMA.jl:115-116: Int(round(...)) == 27
    ref = gen_ref_ws_cons(ref_fasta, 6)
    thr = estimate_optimal_threshold(ref.mean_kfv, 299, buffer=12)
    assert round(thr) == 27
    # determinism of the seeded stream
    assert thr == estimate_optimal_threshold(ref.mean_kfv, 299, buffer=12)


def test_cluster_thresholds_reference_golden(ref_fasta):
    # reference test-KmerGMA.jl:118-120: rounded == [38, 33, 41, 37, 29]
    clusters = cluster_ref_api(ref_fasta, 6, cutoffs=[7, 12, 20, 25], include_avg=False)
    thrs = estimate_optimal_thresholds(clusters.kfvs, clusters.windowsizes, buffer=8)
    assert [round(t) for t in thrs] == [38, 33, 41, 37, 29]


def test_mutate_seq_reference_goldens():
    # reference test-KmerGMA.jl:122-125 (Random.seed!(42) before each)
    assert mutate_seq("ATGC", 0.5, seed=42) == "AGGC"
    assert mutate_seq("ATGCATGC", 0.5, seed=42) == "AGGCGTCC"


def test_mutate_seq_codes_properties():
    rng = JuliaXoshiro(42)
    codes = encode_seq("ATGC")
    out1 = mutate_seq_codes(codes, 0.5, rng)
    out2 = mutate_seq_codes(codes, 0.5, JuliaXoshiro(42))
    assert out1.tolist() == out2.tolist()
    assert decode_seq(out2) == "AGGC"
    # every mutated position differs from the original at rate 1.0
    big = np.zeros(1000, dtype=np.int8)
    mut = mutate_seq_codes(big, 1.0, JuliaXoshiro(0))
    assert (mut != big).all()
