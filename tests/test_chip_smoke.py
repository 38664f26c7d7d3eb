"""chip_smoke.py off the card: it refuses to run without a GPU, and its
phase functions hold at a tiny size on the CPU (the same code checks the
real sizes on the card)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SIZES = [300_000, 200_000, 150_000]
SPACING = 50_000


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_exits_nonzero_without_a_gpu():
    out = _run(REPO, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    records, planted = cs.make_genome(SIZES, 7, SPACING)
    d = tmp_path_factory.mktemp("genome")
    fasta = str(d / "genome.fasta")
    cs.write_fasta_file(fasta, records)
    small = str(d / "chr3.fasta")
    cs.write_fasta_file(small, records[2:3])
    return records, planted, fasta, small


def test_make_genome_plants_reference_genes(genome):
    from kmergma.utils.fasta import as_records

    records, planted, fasta, _ = genome
    assert [len(r) for r in records] == SIZES
    parsed = as_records(fasta)
    assert [r.seq for r in parsed] == [r.seq for r in records]
    genes = [r.seq.upper() for r in as_records(cs.REF)]
    for i, (ri, pos, ln) in enumerate(planted):
        assert records[ri].seq[pos : pos + ln] == genes[i % len(genes)]


def test_phase_goldens():
    out = cs.phase_goldens()
    assert (out["hits"], out["loci"], out["cluster_hits"]) == (3, 7, 3)


def test_phase_single(genome):
    _, planted, fasta, _ = genome
    out = cs.phase_single(fasta, planted)
    assert out["planted"] == len(planted)
    assert out["covered"] == len(planted) and out["uncovered"] == []


def test_phase_single_carried_minimum(tmp_path):
    """Reference genes 73 and 74 in a row: 73 leaves a suppressed rising
    edge whose minimum the machine carries, so 74 and the gene after it get
    no hit; the phase accepts the misses because a fresh machine finds them."""
    from kmergma.utils.fasta import FastaRecord, as_records

    genes = [r.seq.upper() for r in as_records(cs.REF)]
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[np.random.default_rng(0).integers(0, 4, 40_000, dtype=np.int8)]
    planted = []
    for gi, pos in ((73, 5_000), (74, 15_000), (0, 25_000)):
        g = np.frombuffer(genes[gi], dtype=np.uint8)
        seq[pos : pos + g.shape[0]] = g
        planted.append((0, pos, g.shape[0]))
    fasta = str(tmp_path / "carried.fasta")
    cs.write_fasta_file(fasta, [FastaRecord("carried", seq.tobytes())])
    out = cs.phase_single(fasta, planted)
    assert out["hits"] == 1
    assert [(ri, pos) for ri, pos, _ in out["uncovered"]] == [(0, 15_000), (0, 25_000)]
    assert all(best < out["thr"] for _, _, best in out["uncovered"])


def test_phase_single_fails_on_a_gene_no_machine_finds(genome):
    """A "planted" gene over plain random sequence is a miss no carried
    minimum explains: the phase fails."""
    _, planted, fasta, _ = genome
    with pytest.raises(AssertionError, match="fresh minima machine"):
        cs.phase_single(fasta, planted + [(0, SPACING, 289)])


def test_phase_cluster(genome):
    out = cs.phase_cluster(genome[3])
    assert out["m"] == 6 and out["events"] > 0


def test_phase_strobe(genome):
    out = cs.phase_strobe(genome[3], slice_bp=60_000)
    assert out["slice_hits"] > 0


def test_phase_exact():
    """A subject above the device threshold (1 Mbp) takes the device scan."""
    records, _ = cs.make_genome([1_200_000], 3, 400_000)
    out = cs.phase_exact(records[0].seq)
    assert out["matches"] > 0


def test_phase_align_device(genome):
    records, planted = genome[0], genome[1]
    out = cs.phase_align_device(records, planted)
    assert out["windows"] == len(planted)


def test_phase_span_sweep(genome):
    records = genome[0]
    out = cs.phase_span_sweep(records, (1 << 15, 1 << 16), repeats=1)
    assert set(out) == {str(1 << 15), str(1 << 16)}
    assert all(v["median_s"] > 0 for v in out.values())


def test_phase_four_on_virtual_devices(genome):
    """The four-card phase on four of the CPU mesh's virtual devices."""
    out = cs.phase_four(genome[2], 4)
    assert out["cards"] == 4 and out["k10_candidates"] > 0
