"""Test harness.

Tests run on CPU with 8 virtual XLA devices so multi-chip sharding logic is
exercised without several cards (SURVEY.md section 4 implication (3)).  Must be set
before JAX initialises.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Pin the CPU backend via jax.config, whatever JAX_PLATFORMS says.
import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import pytest

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def ref_fasta() -> str:
    """84 camelid V-gene references (reference test fixture Alp_V_ref.fasta)."""
    return str(DATA / "Alp_V_ref.fasta")


@pytest.fixture(scope="session")
def mini_genome() -> str:
    """41,260 bp single-contig mini genome (Alp_V_locus.fasta, 3 true hits)."""
    return str(DATA / "Alp_V_locus.fasta")


@pytest.fixture(scope="session")
def test_genome() -> str:
    """485,283 bp 4-contig genome (Loci.fasta, 7-8 hits)."""
    return str(DATA / "Loci.fasta")


@pytest.fixture(scope="session")
def eight_seqs() -> str:
    """8 identical 1 kb loci (8_ident_Alp_V_loci.fasta, alignment fixture)."""
    return str(DATA / "8_ident_Alp_V_loci.fasta")


# Shared sequence fixtures mirroring the reference harness
# (reference test/runtests.jl:47-51).
TEST_SEQ = "ATGCATGC"
TEST_CONSENSUS_SEQ = (
    "CAGGTGCAGCTGGTGGAGTCTGGGGGAGGCTTGGTGCAGCCTGGGGGGTCTCTGAGACTCTCCTGTGCAGCCTCTGGATTCACC"
    "TTCAGTAGCTATGCCATGAGCTGGGTCCGCCAGGCTCCAGGGAAGGGGCTCGAGTGGGTCTCAGCTATTAATAGTGGTGGTGGT"
    "AGCACATACTATGCAGACTCCGTGAAGGGCCGATTCACCATCTCCAGAGACAACGCCAAGAACACGCTGTATCTGCAAATGAAC"
    "AGCCTGAAACCTGAGGGCACGGCCGTGTATTACTGTGGTAAAGAAGA"
)
TEST_KFV = [0.0, 0.0, 0.0, 2.0, 1.0, 0.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0, 0.0, 2.0, 0.0]


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """XLA:CPU keeps every compiled executable mmap'd; a full-suite run
    accumulates ~65k mappings and hits the kernel's DEFAULT
    vm.max_map_count (65530), segfaulting the compiler mid-suite
    (64,420 maps measured at the crash).  Dropping JAX's executable caches
    at module boundaries keeps the count bounded; per-module recompiles
    are CPU-cheap."""
    yield
    jax.clear_caches()
