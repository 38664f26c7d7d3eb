"""ExactMatch conformance tests (reference test-KmerGMA.jl:298-344)."""

import pytest

from kmergma.ops.exact_match import exact_match, first_match
from kmergma.utils.fasta import fasta_id_to_cumulative_len_dict, read_fasta


class TestSingleSeq:
    def test_basic(self):
        assert exact_match("GAG", "CCCCCCCGAGCTTTT") == [(8, 10)]
        assert exact_match("GAG", "CGAGCCCGAGCTTTT") == [(2, 4), (8, 10)]

    def test_overlap(self):
        assert exact_match("GAG", "CGAGAGAGAAGGCCGAGCTTTT") == [(2, 4), (4, 6), (6, 8), (15, 17)]
        assert exact_match("GAG", "CGAGAGAGAAGGCCGAGCTTTT", overlap=False) == [(2, 4), (6, 8), (15, 17)]

    def test_no_match(self):
        assert exact_match("GAG", "CCCCCCTTT") is None


class TestReader:
    def test_subseq_of_first_record(self, ref_fasta):
        rec = next(read_fasta(ref_fasta))
        subseq = rec.seq_str()[41:69]  # 1-based 42:69
        assert exact_match(subseq, ref_fasta) == {"AM773729|IGHV1-1*01|Vicugna": [(42, 69)]}

    def test_record_as_query(self, ref_fasta):
        rec = next(read_fasta(ref_fasta))
        assert exact_match(rec, ref_fasta) == {"AM773729|IGHV1-1*01|Vicugna": [(1, 296)]}

    def test_no_match_string(self, ref_fasta):
        assert exact_match("AAAAAAAAA", ref_fasta) == "no match"

    def test_multi_record(self, ref_fasta):
        assert exact_match("AAATT", ref_fasta) == {
            "AM773729|IGHV1-1*01|Vicugna": [(174, 178)],
            "AM939700|IGHV1S5*01|Vicugna": [(174, 178)],
        }

    def test_open_reader_subject(self, ref_fasta):
        """The reference dispatches exactMatch on a live FASTA.Reader
        (ref ExactMatch.jl:100-121); open binary and text handles both work."""
        with open(ref_fasta, "rb") as fh:
            assert exact_match("AAATT", fh) == exact_match("AAATT", ref_fasta)
        with open(ref_fasta, "r") as fh:
            assert exact_match("AAATT", fh) == exact_match("AAATT", ref_fasta)


def test_engine_exact_match_matches_host(test_genome):
    """The prefix-register engine path must find exactly the true matches."""
    from kmergma.ops.exact_match import match_starts_engine, match_starts_np
    from kmergma.utils.fasta import read_fasta

    rec = next(read_fasta(test_genome))
    sub = rec.seq.upper()
    q = sub[20000:20030]  # real 30-mer from the genome
    assert match_starts_engine(sub, q).tolist() == match_starts_np(sub, q).tolist()
    # reversed-query control: must yield only its own true occurrences
    # (usually none)
    qq = q[::-1]
    assert match_starts_engine(sub, qq).tolist() == match_starts_np(sub, qq).tolist()
    # short queries (below the 16-base register) ride the masked compare:
    # plenty of occurrences, same answer
    for qlen in (3, 7, 15, 16, 17):
        qs = sub[1000 : 1000 + qlen]
        assert match_starts_engine(sub, qs).tolist() == match_starts_np(sub, qs).tolist()


def test_engine_compiles_once_across_queries(test_genome):
    """Different queries and query lengths share ONE compiled program
    (the old spectrum engine recompiled the full
    bitmap pipeline per query length)."""
    from kmergma.ops import exact_match as em
    from kmergma.utils.fasta import read_fasta

    rec = next(read_fasta(test_genome))
    sub = rec.seq.upper()
    em.match_starts_engine(sub, sub[100:130])
    fn = em._prefix_match_bitmaps_fn()
    size0 = fn._cache_size()
    em.match_starts_engine(sub, sub[500:541])  # different length + content
    em.match_starts_engine(sub, sub[900:908])  # below the register width
    assert fn._cache_size() == size0


def test_first_match(ref_fasta):
    out = first_match(ref_fasta, "AAATT")
    assert ("AM773729|IGHV1-1*01|Vicugna", (174, 178)) in out


def test_empty_query_rejected():
    with pytest.raises(ValueError):
        exact_match("", "ACGT")


def test_cumulative_len_dict(test_genome):
    # reference test-KmerGMA.jl:336-344 (keys are full descriptions)
    d = fasta_id_to_cumulative_len_dict(test_genome)
    assert d == {
        "JQ684648.1 Lama glama clone V03 IgH locus genomic sequence": 0,
        "JQ684647.1 Lama glama clone F07 IgH locus genomic sequence": 121478,
        "AM773548.1 Lama pacos germline IgHV region, Vh3-S1, Vh2-S1 and vhh3-S1 genes": 444023,
        "AM773729.1 Lama pacos germline IgH locus: proximal IgHV region genes, complete IgHD region genes, complete IgHJ region genes and complete IgHC region genes": 221227,
    }
