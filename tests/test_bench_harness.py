"""Pins for the benchmark harness's device-side genome generator.

bench.py generates synthetic genomes ON DEVICE (nothing crosses the H2D
link); the hash must stay bit-identical to the NumPy version so benchmark
genomes are reproducible across backends.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hash_codes_np(pos, seed):
    with np.errstate(over="ignore"):
        x = pos * np.uint32(0x9E3779B9) + np.uint32(seed)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return ((x >> np.uint32(7)) & 3).astype(np.int8)


def test_device_random_genome_content():
    import jax.numpy as jnp

    from bench import _device_random_genome
    from kmergma.ops.reference import gen_ref_ws_cons
    from kmergma.ops.scan import ScanEngine

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    profile = gen_ref_ws_cons(os.path.join(here, "tests/data/Alp_V_ref.fasta"), 6)
    eng = ScanEngine(profile.sum_kfv, k=profile.k, ws=profile.windowsize, r=profile.n_records)
    prep = _device_random_genome(eng, 100_000, seed=42, max_ws=profile.windowsize + 1)
    codes = np.asarray(prep.dev)
    assert codes.dtype == np.int8
    want = _hash_codes_np(np.arange(codes.shape[0], dtype=np.uint32), 42)
    assert (codes == want).all()
    assert set(np.unique(codes)) <= {0, 1, 2, 3}
