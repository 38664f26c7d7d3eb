"""Golden-vector unit tests for the k-mer primitives, ported from the
reference suite (reference test/test_folder/test-KmerGMA.jl:1-26)."""

import numpy as np

from kmergma import as_kmer, as_uint, kmer_count, kmer_dist
from kmergma.consts import decode_seq, encode_seq, get_k
from kmergma.ops.kmers import kmer_count_into, rolling_kmer_codes

from .conftest import TEST_KFV, TEST_SEQ


def test_kmer_count_k1():
    assert kmer_count(TEST_SEQ, 1).tolist() == [2, 2, 2, 2]


def test_kmer_count_k2_golden():
    assert kmer_count(TEST_SEQ, 2).tolist() == TEST_KFV


def test_kmer_count_into():
    bins = np.zeros(4)
    kmer_count_into(TEST_SEQ, 1, bins)
    assert bins.tolist() == [2, 2, 2, 2]
    bins = np.zeros(16)
    kmer_count_into(TEST_SEQ, 2, bins)
    assert bins.tolist() == TEST_KFV


def test_kmer_dist_golden():
    # reference test-KmerGMA.jl:18-19
    a = TEST_SEQ * 25 + "A" + TEST_SEQ * 25
    b = TEST_SEQ * 25 + "G" + TEST_SEQ * 25
    assert kmer_dist(a, b, 2) == 1.0
    a = TEST_SEQ * 25 + "AA" + TEST_SEQ * 25
    b = TEST_SEQ * 25 + "GT" + TEST_SEQ * 25
    assert kmer_dist(a, b, 2) == 2.0


def test_codec_roundtrip():
    # reference test-KmerGMA.jl:23-24
    assert as_uint(TEST_SEQ) == 14649
    assert as_kmer(14649, 8) == TEST_SEQ


def test_encode_n_maps_to_t():
    assert encode_seq("ANGC").tolist() == encode_seq("ATGC").tolist()


def test_encode_rejects_iupac():
    import pytest

    with pytest.raises(ValueError):
        encode_seq("ATGY")


def test_decode_roundtrip():
    assert decode_seq(encode_seq("acgtACGT")) == "ACGTACGT"


def test_rolling_kmer_codes():
    k = rolling_kmer_codes(encode_seq("ATGC"), 2)
    # AT=0b0011=3, TG=0b1110=14, GC=0b1001=9
    assert k.tolist() == [3, 14, 9]


def test_get_k():
    assert get_k(4096) == 6
    assert get_k(16) == 2
