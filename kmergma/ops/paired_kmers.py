"""Gapped k-mer-pair spectrum (ref KmerGMA.jl/src/PairedKmers.jl).

The reference flags this module "has unfixed bugs, do not use; proof of
concept" (PairedKmers.jl:6) yet exports and unit-tests it, so its exact
behaviour - including the quirk that the second rolling register is NOT
reset between outer-loop passes (PairedKmers.jl:44-47), carrying state from
the end of one pass into the start of the next - is part of the conformance
surface (reference test-KmerGMA.jl:346-366) and is replicated here.
"""

from __future__ import annotations

import numpy as np

from ..consts import encode_seq


def _codes(seq) -> np.ndarray:
    return seq if isinstance(seq, np.ndarray) else encode_seq(seq)


def initialize_kmers(seq, k: int) -> tuple[int, int]:
    """Prime both registers with the first k-1 bases (ref PairedKmers.jl:15-21)."""
    codes = _codes(seq)
    kmer = 0
    for c in codes[: k - 1]:
        kmer = (kmer << 2) + int(c)
    return kmer, kmer


def as_index(kmer1: int, kmer2: int, k: int) -> int:
    """1-based paired-spectrum index ((kmer2 << 2k) | kmer1) + 1
    (ref PairedKmers.jl:23-25)."""
    return ((kmer2 << (k << 1)) | kmer1) + 1


def kmer_pair_count(seq, k: int = 3) -> np.ndarray:
    """Paired k-mer spectrum, 4^(2k) float64 bins (ref PairedKmers.jl:36-50).

    O(n^2) nested rolling loop, replicated verbatim including the
    carried-over inner register.
    """
    bins = np.zeros(4 ** (2 * k), dtype=np.float64)
    kmer_pair_count_into(seq, k, bins)
    return bins


def kmer_pair_count_into(seq, k: int, bins: np.ndarray) -> None:
    """In-place variant (ref PairedKmers.jl:52-65)."""
    codes = _codes(seq)
    n = codes.shape[0]
    mask = (4**k) - 1
    kmer_i, kmer_j = initialize_kmers(codes, k)
    view = codes[k - 1 : n]  # Julia's view(seq, k:n)

    # Exact replication of the nested rolling registers.  The inner register
    # kmer_j deliberately persists across outer iterations.  After its first
    # full pass the register content at each inner position is
    # pass-invariant (the roll window saturates after k steps), so passes
    # 2..m share one precomputed index row - only pass 1 differs in its
    # first k-1 positions.
    m = view.shape[0]
    if m == 0:
        return

    # kmer_j values for pass 1 (carrying the initialisation register).
    kj = kmer_j
    pass1 = np.empty(m, dtype=np.int64)
    for t in range(m):
        kj = ((kj << 2) & mask) + int(view[t])
        pass1[t] = kj
    # steady-state pass: register carried from the end of the previous pass.
    pass_rest = np.empty(m, dtype=np.int64)
    for t in range(m):
        kj = ((kj << 2) & mask) + int(view[t])
        pass_rest[t] = kj
    # Passes 3.. equal pass 2 iff the carried register produces the same
    # values; after min(k-1, m) steps both agree, and the carry-in to every
    # pass >= 3 equals pass 2's carry-in (the last k-1 bases of view).
    # Verify cheaply and fall back to the literal loop if not.
    kj2 = int(pass_rest[-1])
    pass3 = np.empty(min(m, k), dtype=np.int64)
    for t in range(pass3.shape[0]):
        kj2 = ((kj2 << 2) & mask) + int(view[t])
        pass3[t] = kj2
    steady = np.array_equal(pass3, pass_rest[: pass3.shape[0]])

    ki = kmer_i
    for p in range(m):
        ki = ((ki << 2) & mask) + int(view[p])
        if p == 0:
            inner = pass1
        elif steady or p == 1:
            inner = pass_rest
        else:  # pragma: no cover - literal fallback
            inner = np.empty(m, dtype=np.int64)
            for t in range(m):
                kj = ((kj << 2) & mask) + int(view[t])
                inner[t] = kj
        idx = ((inner << (k << 1)) | ki)
        np.add.at(bins, idx, 1.0)


def kmer_pair_count_device(seq, k: int = 3) -> np.ndarray:
    """Device paired spectrum, bit-identical to ``kmer_pair_count``.

    Data-parallel reformulation of the reference's O(n^2) nested rolling loop
    (ref PairedKmers.jl:36-50): both registers are plain rolling k-mer code
    streams of the SAME sequence (the outer register ki[p] and the inner
    pass-1 stream are literally ``rolling_kmer_codes(codes, k)``; the
    steady-state inner stream differs only in its first k-1 positions,
    where the carried register mixes the sequence tail - the reference's
    famous carry quirk).  The p >= 1 passes all share one inner stream, so
    their joint counts factor into an OUTER PRODUCT of two histograms:

        bins[(v << 2k) | u] = cv[v] * cu[u]   (+ the pass-0 column)

    O(n + 4^2k) work instead of O(n^2): the histograms run on device
    (segment_sum), the tiny outer product on host in float64 (products up
    to n^2 exceed int32).  Equality with the host loop is fuzz-pinned in
    tests/test_paired_strobe_rss.py.
    """
    import jax
    import jax.numpy as jnp

    from .scan import rolling_kmer_codes_jnp

    codes = _codes(seq)
    n = codes.shape[0]
    nbins2 = 4 ** (2 * k)
    bins = np.zeros(nbins2, dtype=np.float64)
    m = n - (k - 1)
    if m <= 0:
        return bins
    nb = 4**k
    mask = nb - 1

    @jax.jit
    def device_part(codes_dev):
        kc = rolling_kmer_codes_jnp(codes_dev, k)  # ki[p] AND the pass-1 stream
        # steady-state inner head: carry = code of the sequence tail
        carry = kc[kc.shape[0] - 1]
        head = []
        for t in range(min(k - 1, m)):  # short sequences: m < k-1 head entries
            carry = ((carry << 2) & mask) + codes_dev[k - 1 + t].astype(jnp.int32)
            head.append(carry)
        pass_rest = (
            jnp.concatenate([jnp.stack(head), kc[len(head) :]]) if head else kc
        )
        ones = jnp.ones(kc.shape[0], dtype=jnp.int32)
        cu = jax.ops.segment_sum(ones[1:], kc[1:], num_segments=nb)
        cv = jax.ops.segment_sum(ones, pass_rest, num_segments=nb)
        c1 = jax.ops.segment_sum(ones, kc, num_segments=nb)  # pass-0 inner
        return cu, cv, c1, kc[0]

    cu, cv, c1, u0 = (np.asarray(x) for x in device_part(jnp.asarray(codes)))
    out = cv.astype(np.float64)[:, None] * cu.astype(np.float64)[None, :]
    out[:, int(u0)] += c1.astype(np.float64)
    return out.reshape(-1)
