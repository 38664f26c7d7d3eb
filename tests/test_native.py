"""Native C++ fasta loader: builds with g++ and agrees with the Python
parser on the real fixtures."""

import numpy as np
import pytest

from kmergma.utils.fasta import read_fasta, read_fasta_native
from kmergma.utils.native import get_lib


@pytest.fixture(scope="module")
def lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("no C++ toolchain available")
    return lib


def test_native_matches_python(lib, ref_fasta, test_genome):
    for path in (ref_fasta, test_genome):
        py = list(read_fasta(path))
        nat = read_fasta_native(path)
        assert nat is not None
        assert [r.description for r in nat] == [r.description for r in py]
        for a, b in zip(nat, py):
            assert a.codes.tolist() == b.codes.tolist()
            assert a.seq.upper() == b.seq.upper()


def test_native_encode(lib):
    import ctypes

    seq = b"acgtNACGT"
    out = np.empty(len(seq), dtype=np.int8)
    rc = lib.encode_seq(seq, len(seq), out.ctypes.data_as(ctypes.c_void_p))
    assert rc == 0
    assert out.tolist() == [0, 1, 2, 3, 3, 0, 1, 2, 3]


def test_native_rejects_bad_char(lib, tmp_path):
    p = tmp_path / "bad.fasta"
    p.write_text(">x\nACGTYACGT\n")
    with pytest.raises(ValueError, match="invalid nucleotide"):
        read_fasta_native(str(p))


def test_native_miner_golden(lib, ref_fasta, test_genome):
    """End-to-end: the native loader feeds the miner to the same hit set."""
    from kmergma.models.miner import mine_genome
    from kmergma.ops.reference import gen_ref_ws_cons

    profile = gen_ref_ws_cons(ref_fasta, 6)
    recs = read_fasta_native(test_genome)
    res = mine_genome(recs, profile, thr=30, do_align=True, get_hit_loci=True)
    assert res.hit_loci == [8543, 20425, 221912, 234018, 450875, 467930, 477868]


def test_as_records_native_is_production_path(lib, test_genome, monkeypatch):
    """as_records routes paths through the native loader (exact bytes,
    case preserved) and yields identical records to the Python fallback."""
    from kmergma.utils import fasta as fasta_mod

    native_recs = fasta_mod.as_records(test_genome)
    monkeypatch.setattr(fasta_mod, "read_fasta_native", lambda p: None)
    py_recs = fasta_mod.as_records(test_genome)
    assert [r.description for r in native_recs] == [r.description for r in py_recs]
    for a, b in zip(native_recs, py_recs):
        assert a.seq == b.seq  # raw bytes, exact
        assert a.codes.tolist() == b.codes.tolist()
