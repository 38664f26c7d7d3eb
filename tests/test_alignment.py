"""Alignment-layer tests (reference test-KmerGMA.jl:128-162)."""

from kmergma.ops.align import (
    align_unitrange,
    cigar_to_unitrange,
    semiglobal_align,
)
from kmergma.utils.fasta import read_fasta

from .conftest import TEST_CONSENSUS_SEQ, TEST_SEQ

HUMAN_RSSV = "CACAGTG" + "N" * 12 + "ACAAAAACC"


def test_cigar_to_unitrange():
    # reference test-KmerGMA.jl:130-136
    r = semiglobal_align("ATGCATGC", "GGGGGATGCATGCAAAAA", -5, -1)
    assert cigar_to_unitrange(r) == (6, 13)
    r = semiglobal_align("ATGCATGC", "GGGGGATGCTTATGCAAAAA", -5, -1)
    assert cigar_to_unitrange(r) == (6, 15)


def test_align_unitrange_golden(eight_seqs):
    # reference test-KmerGMA.jl:139-145
    rec = next(read_fasta(eight_seqs))
    assert align_unitrange(
        rec.seq_str(), 450, 900, TEST_CONSENSUS_SEQ, 289, 1000
    ) == (501, 789)


def test_rss_cigar():
    # reference test-KmerGMA.jl:155-156: semiglobal of the RSS motif into
    # its flanked context gives cigar 8D28=8D
    b = (TEST_SEQ + HUMAN_RSSV + TEST_SEQ)[:44]
    r = semiglobal_align(HUMAN_RSSV, b, -69, -1)
    assert r.cigar == "8D28=8D"


def test_single_run_cigar_gives_empty_range():
    # the reference's parser drops the final run; a 1-run cigar yields an
    # empty range (lower+1, num_sum) = (1, 0)
    r = semiglobal_align("ACGT", "ACGT", -5, -1)
    assert r.cigar == "4="
    assert cigar_to_unitrange(r) == (1, 0)


def test_affine_gap_scoring():
    # one gap of length 2: go + 2*ge
    r = semiglobal_align("AACC", "AATTCC", -5, -1)
    assert r.score == 4 * 5 + (-5 - 2)


def test_batch_align_matches_single_fuzz():
    # semiglobal_align_batch must be bit-identical to per-hit alignment:
    # mixed subject lengths (grouping path), mutations, indels, IUPAC codes
    import numpy as np

    from kmergma.ops.align import semiglobal_align_batch

    rng = np.random.default_rng(7)
    letters = np.frombuffer(b"ATGCN", dtype=np.uint8)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 60))
    subjects = []
    for _ in range(23):
        n = int(rng.integers(40, 120))
        subjects.append(bytes(letters[rng.integers(0, 5, n)]).decode())
    for go, ge in [(-69, -1), (-5, -2)]:
        batch = semiglobal_align_batch(query, subjects, go, ge)
        for s, r in zip(subjects, batch):
            single = semiglobal_align(query, s, go, ge)
            assert r.score == single.score
            assert r.cigar == single.cigar


def test_batch_align_empty():
    from kmergma.ops.align import semiglobal_align_batch

    assert semiglobal_align_batch("ACGT", []) == []


def test_device_align_matches_host_fuzz():
    """The device DP + traceback (ops/align_device.py) is bit-identical to
    the host aligner: same scores, same CIGARs, across gap models, IUPAC
    codes and mixed subject lengths."""
    import numpy as np

    from kmergma.ops.align_device import semiglobal_align_device

    rng = np.random.default_rng(11)
    letters = "ATGCN"
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 70))
    subjects = []
    for _ in range(19):
        n = int(rng.integers(50, 140))
        subjects.append("".join(letters[i] for i in rng.integers(0, 5, n)))
    for go, ge in [(-69, -1), (-5, -2), (-200, -1)]:
        dev = semiglobal_align_device(query, subjects, go, ge)
        for s, r in zip(subjects, dev):
            single = semiglobal_align(query, s, go, ge)
            assert r.score == single.score
            assert r.cigar == single.cigar


def test_device_align_indel_mutants_fuzz():
    """Realistic hit shapes: near-identical subjects with substitutions AND
    indels (multi-run CIGARs exercising every RLE branch: diagonal chains,
    E and F gap runs, leading/trailing free gaps) - device == host."""
    import numpy as np

    from kmergma.ops.align_device import semiglobal_align_device

    rng = np.random.default_rng(12)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 120))
    subjects = []
    for _ in range(16):
        s = list(query)
        for _ in range(int(rng.integers(0, 12))):  # substitutions
            s[int(rng.integers(0, len(s)))] = "ATGC"[int(rng.integers(0, 4))]
        for _ in range(int(rng.integers(0, 3))):  # deletions from subject
            p = int(rng.integers(0, len(s) - 5))
            del s[p : p + int(rng.integers(1, 5))]
        for _ in range(int(rng.integers(0, 3))):  # insertions into subject
            p = int(rng.integers(0, len(s)))
            s[p:p] = ["ATGC"[int(rng.integers(0, 4))] for _ in range(int(rng.integers(1, 5)))]
        pad_l = "".join("ATGC"[i] for i in rng.integers(0, 4, int(rng.integers(0, 30))))
        pad_r = "".join("ATGC"[i] for i in rng.integers(0, 4, int(rng.integers(0, 30))))
        subjects.append(pad_l + "".join(s) + pad_r)
    dev = semiglobal_align_device(query, subjects, -69, -1)
    for s, r in zip(subjects, dev):
        single = semiglobal_align(query, s, -69, -1)
        assert r.score == single.score
        assert r.cigar == single.cigar


def test_device_align_run_overflow_falls_back(monkeypatch):
    """Hits whose CIGAR run count exceeds the device RLE buffer must fall
    back to the exact host oracle (forced here by shrinking the cap)."""
    import numpy as np

    import kmergma.ops.align_device as ad

    monkeypatch.setattr(ad, "RLE_CAP", 2)
    rng = np.random.default_rng(13)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 60))
    subjects = ["".join("ATGCN"[i] for i in rng.integers(0, 5, 90)) for _ in range(5)]
    dev = ad.semiglobal_align_device(query, subjects, -69, -1)
    for s, r in zip(subjects, dev):
        single = semiglobal_align(query, s, -69, -1)
        assert r.score == single.score
        assert r.cigar == single.cigar


def test_batch_align_without_native_toolchain(monkeypatch):
    """semiglobal_align_batch must fall back to the NumPy wavefront (and
    stay bit-identical) when the native library is unavailable."""
    import numpy as np

    import kmergma.utils.native as native_mod
    from kmergma.ops.align import semiglobal_align_batch

    monkeypatch.setattr(native_mod, "get_lib", lambda: None)
    rng = np.random.default_rng(14)
    query = "".join("ATGC"[i] for i in rng.integers(0, 4, 50))
    subjects = ["".join("ATGCN"[i] for i in rng.integers(0, 5, 80)) for _ in range(6)]
    got = semiglobal_align_batch(query, subjects, -69, -1)
    for s, r in zip(subjects, got):
        single = semiglobal_align(query, s, -69, -1)
        assert r.score == single.score
        assert r.cigar == single.cigar
