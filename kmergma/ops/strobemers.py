"""Randstrobe (2-strobe) primitives (ref KmerGMA.jl/src/StrobemerGMA/Strobemers.jl).

Per Sahlin's randstrobes the second strobe should minimise the hash
(u(s1) + u(s2)) mod q over the window [w_min, w_max], ties to the farther
position.  The reference, however, initialises ``min_score::Int = 2 << 63``
(Strobemers.jl:52) which OVERFLOWS Int64 to 0, so its `<=` selection
actually picks the LAST candidate whose score is exactly 0, falling back to
w_min when no score is 0.  That overflow behaviour is pinned by the golden
spectrum test (reference test-StrobemerGMA.jl:13-18) and is replicated here
bit-for-bit.

The extraction is vectorised over positions (all candidate offsets compared
at once) - the data-parallel replacement for the reference's per-position
recompute loop (Strobemers.jl:90-114) - and doubles as the host
implementation.
"""

from __future__ import annotations

import numpy as np

from ..consts import encode_seq
from .kmers import as_uint, rolling_kmer_codes


def randstrobe_score(s1, s2, q: int) -> int:
    """(u(s1) + u(s2)) mod q (ref Strobemers.jl:12-14)."""
    return (as_uint(s1) + as_uint(s2)) % q


def _codes(seq) -> np.ndarray:
    return seq if isinstance(seq, np.ndarray) else encode_seq(seq)


def strobe_2_mer_codes(
    codes: np.ndarray, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5
) -> np.ndarray:
    """Vectorised randstrobe codes for every position.

    Returns u[i] = 2-bit code of the ungapped 2s-mer strobemer anchored at
    0-based position i, for i in [0, n - (w_max+s-1)]: first strobe =
    s-mer at i, second = s-mer at the score-minimising offset in
    [w_min-1, w_max-1] (1-based [w_min, w_max]), ties to the farther offset.
    """
    k = w_max + s - 1
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return np.zeros(0, dtype=np.int64)
    u = rolling_kmer_codes(codes, s)  # s-mer code at every position
    first = u[:m]
    # candidate second strobes at offsets d = w_min-1 .. w_max-1
    cands = np.stack([u[d : d + m] for d in range(w_min - 1, w_max)], axis=0)
    scores = (first[None, :] + cands) % q
    # reference semantics (overflow-initialised min): last zero-score
    # candidate wins, else w_min.
    is_zero = scores == 0
    rev = is_zero[::-1]
    last_zero = rev.shape[0] - 1 - np.argmax(rev, axis=0)
    sel = np.where(is_zero.any(axis=0), last_zero, 0)
    second = cands[sel, np.arange(m)]
    return (first << (2 * s)) | second


def strobe_2_mer_codes_jnp(codes, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5):
    """Device-side strobe_2_mer_codes (same overflow-selection semantics).

    ``codes`` is an int8/int32 device array; returns int32[m] with
    m = len(codes) - (w_max + s - 1) + 1.  Gather-free: the winning second
    strobe is materialised with w_max - w_min + 1 selects.  Bit-identical
    to the NumPy extraction (tests/test_paired_strobe_rss.py).
    """
    import jax.numpy as jnp

    from .scan import rolling_kmer_codes_jnp

    k = w_max + s - 1
    m = codes.shape[0] - k + 1
    u = rolling_kmer_codes_jnp(codes, s)
    first = u[:m]
    cands = [u[d : d + m] for d in range(w_min - 1, w_max)]
    scores = [(first + c) % q for c in cands]
    # reference semantics (overflow-initialised min): the LAST zero-score
    # candidate wins, else the w_min candidate (see module docstring)
    sel = jnp.zeros(m, dtype=jnp.int32)
    for d, sc in enumerate(scores):
        sel = jnp.where(sc == 0, d, sel)  # last zero wins; default index 0
    second = cands[0]
    for d in range(1, len(cands)):
        second = jnp.where(sel == d, cands[d], second)
    return (first << (2 * s)) | second


def get_strobe_2_mer(
    seq, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5, with_gap: bool = True
) -> str:
    """The randstrobe of the leading window of ``seq``
    (ref Strobemers.jl:45-65), as a string; gapped form pads with '-'."""
    if isinstance(seq, bytes):
        seq = seq.decode("ascii")
    elif isinstance(seq, np.ndarray):
        from ..consts import decode_seq

        seq = decode_seq(seq)
    text = seq.upper()
    first = text[:s]
    min_score = 0  # the reference's 2 << 63 Int64 overflow
    min_ind = w_min
    for i in range(w_min, w_max + 1):  # 1-based window starts
        cur = randstrobe_score(first, text[i - 1 : i - 1 + s], q)
        if cur <= min_score:  # only score-0 candidates can win; last wins
            min_score = cur
            min_ind = i
    second = text[min_ind - 1 : min_ind - 1 + s]
    if not with_gap:
        return first + second
    return (
        first
        + "-" * (min_ind - s - 1)
        + second
        + "-" * (len(text) - min_ind - s + 1)
    )


def ungapped_strobe_2_mer_count(
    seq, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5
) -> np.ndarray:
    """Strobemer spectrum: 4^(2s) bins over all anchored positions
    (ref Strobemers.jl:90-102)."""
    bins = np.zeros(4 ** (2 * s), dtype=np.float64)
    ungapped_strobe_2_mer_count_into(seq, bins, s, w_min, w_max, q)
    return bins


def ungapped_strobe_2_mer_count_into(
    seq, bins: np.ndarray, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5
) -> None:
    codes = _codes(seq)
    sc = strobe_2_mer_codes(codes, s, w_min, w_max, q)
    if sc.size:
        np.add.at(bins, sc, 1.0)
