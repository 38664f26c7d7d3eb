"""Exact-occurrence search (ref KmerGMA.jl/src/ExactMatch.jl).

Two engines behind one API:
  * a device scan (``match_starts_engine``): a QUERY-INDEPENDENT rolling
    32-bit prefix-register compare + host byte verification - the
    device replacement for BioSequences' Boyer-Moore search (SURVEY.md
    section 7 item 8), used for large subjects.  The scan compares the
    subject's rolling 16-base 2-bit register against the query's (masked
    to min(16, |q|) bases), so ONE compiled program serves EVERY query and
    query length - no per-query recompiles; random-DNA candidate rate is
    4^-16 per position, and candidates are byte-verified on host;
  * a host fallback on ``bytes.find`` for small inputs (no device round-trip).

Matching is on raw uppercased sequence bytes, so N only matches N -
identical to ``ExactSearchQuery(isequal)`` symbol equality (the 2-bit
register folds N into T, which only ever widens the candidate set the byte
verification then filters).

Overlap semantics (ref ExactMatch.jl:20-43): overlap=True restarts the
search one past each match START (yielding every occurrence); overlap=False
restarts one past each match END (greedy non-overlapping).
"""

from __future__ import annotations

from functools import partial
from typing import Union

import numpy as np

from ..utils.fasta import FastaRecord, PathOrRecords, as_records, read_fasta

Query = Union[str, bytes, FastaRecord]

_DEVICE_MIN = 1 << 20  # below this, bytes.find beats a device round-trip
_PREFIX = 16  # bases folded into the 32-bit match register
_BLOCK = 512  # windows per activity-bitmap block


def _as_bytes(x: Query) -> bytes:
    if isinstance(x, FastaRecord):
        return x.seq.upper()
    if isinstance(x, str):
        return x.upper().encode("ascii")
    return bytes(x).upper()


def match_starts_np(subject: bytes, query: bytes) -> np.ndarray:
    """All 0-based match start positions (host path, bytes.find)."""
    out = []
    start = subject.find(query)
    while start != -1:
        out.append(start)
        start = subject.find(query, start + 1)
    return np.asarray(out, dtype=np.int64)


def _ranges(starts: np.ndarray, qlen: int, overlap: bool) -> list[tuple[int, int]]:
    """1-based inclusive ranges with the reference's restart semantics."""
    out: list[tuple[int, int]] = []
    next_allowed = 0
    for s in starts:
        s = int(s)
        if overlap or s >= next_allowed:
            out.append((s + 1, s + qlen))
            next_allowed = s + qlen
    return out


def exact_match(
    query: Query,
    subject: "Query | PathOrRecords",
    overlap: bool = True,
    use_device: bool | None = None,
):
    """All exact occurrences of ``query`` in ``subject``.

    Sequence/record subject -> list of 1-based (start, stop) tuples, or
    ``None`` if no match.  Path / record-collection subject -> dict mapping
    record identifier to its range list, or the string "no match"
    (ref ExactMatch.jl:89-121).
    """
    q = _as_bytes(query)
    if not q:
        raise ValueError("empty query sequence")

    if isinstance(subject, (str, bytes)) and not _looks_like_path(subject):
        return _match_one(q, _as_bytes(subject), overlap, use_device)
    if isinstance(subject, FastaRecord):
        return _match_one(q, _as_bytes(subject), overlap, use_device)

    # path or iterable of records
    records = list(read_fasta(subject)) if _looks_like_path(subject) else as_records(subject)
    found: dict[str, list[tuple[int, int]]] = {}
    for rec in records:
        rng = _match_one(q, _as_bytes(rec), overlap, use_device)
        if rng is not None:
            found[rec.identifier] = rng
    return found if found else "no match"


def _looks_like_path(x) -> bool:
    import os

    return isinstance(x, (str, bytes)) and os.path.exists(x)


def _prefix_match_bitmaps_fn():
    """The (lazily imported, module-cached) jitted bitmap pass."""
    import jax
    import jax.numpy as jnp

    global _bitmaps_jit
    if _bitmaps_jit is not None:
        return _bitmaps_jit

    @partial(jax.jit, static_argnames=("span", "n_spans"))
    def _prefix_match_bitmaps(codes_dev, qm, n_valid, *, span, n_spans):
        """Per-block any(prefix-register match) bitmap over the subject.

        ``qm`` int32[2] = [masked query register, mask] - the ONLY
        query-dependent input, passed as data so every query shares the
        compiled program.  Register r[i] packs codes[i..i+15] MSB-first in
        32 bits (int32 wraparound; identical on host and device).
        """

        def step(_, i):
            start = i * span
            c = jax.lax.dynamic_slice(codes_dev, (start,), (span + _PREFIX - 1,))
            reg = jnp.zeros(span, dtype=jnp.int32)
            for t in range(_PREFIX):
                reg = reg + (c[t : t + span].astype(jnp.int32) << (2 * (_PREFIX - 1 - t)))
            below = ((reg & qm[1]) == qm[0]) & (start + jnp.arange(span) < n_valid[0])
            return _, below.reshape(span // _BLOCK, _BLOCK).any(axis=1)

        _, bm = jax.lax.scan(step, 0, jnp.arange(n_spans))
        return bm

    _bitmaps_jit = _prefix_match_bitmaps
    return _bitmaps_jit


_bitmaps_jit = None
_subject_cache: dict = {}  # (id, len, hash, total) -> device codes
# Cap on device memory pinned by cached subject code arrays (int8, `total`
# bytes per entry).  Without a byte cap, four 512 Mbp subjects would pin
# ~2 GB indefinitely.  Oldest entries evict first.
_SUBJECT_CACHE_MAX_BYTES = 1 << 30


def _query_register(q: bytes) -> tuple[int, int]:
    """(masked register, mask) of the query's first min(16, |q|) bases,
    as int32 bit patterns (MSB-aligned, low bits free)."""
    from ..consts import encode_seq

    kp = min(_PREFIX, len(q))
    qcodes = encode_seq(q[:kp]).astype(np.uint32)
    reg = np.uint32(0)
    for c in qcodes:
        reg = np.uint32((int(reg) << 2) | int(c))
    reg = np.uint32((int(reg) << (2 * (_PREFIX - kp))) & 0xFFFFFFFF)
    mask = np.uint32((0xFFFFFFFF << (32 - 2 * kp)) & 0xFFFFFFFF)
    i32 = lambda u: int(np.asarray([u], dtype=np.uint32).view(np.int32)[0])
    return i32(np.uint32(int(reg) & int(mask))), i32(mask)


def match_starts_engine(sub: bytes, q: bytes) -> np.ndarray:
    """Exact occurrences via the device prefix-register scan.

    One quarter-packed H2D of the subject, one bitmap pass (compiled once
    per subject-size bucket, shared by all queries), one tiny bitmap fetch;
    active blocks are byte-verified with ``bytes.find`` on host.
    """
    import jax
    import jax.numpy as jnp

    from ..backend import ensure_compile_cache, policy
    from .scan import _span_bucket, _unpack_codes, _with_retry
    from ..consts import encode_seq
    from ..utils.native import pack_quarters_native

    ensure_compile_cache()
    n = len(sub)
    qlen = len(q)
    n_valid = n - qlen + 1
    span = policy().span_windows
    n_spans = _span_bucket(max(1, -(-n_valid // span)))
    total = -(-(n_spans * span + _PREFIX) // 4) * 4

    # repeated queries against the same subject reuse its device transfer
    # (hash(bytes) is cached per object, so the key costs O(n) only once;
    # id+len+hash makes stale-id reuse after GC effectively impossible)
    key = (id(sub), n, hash(sub), total)
    codes_dev = _subject_cache.get(key)
    if codes_dev is None:
        # evict oldest entries until the new entry fits the byte budget
        # (dict preserves insertion order); a single over-budget subject
        # still gets cached alone so repeat queries reuse its transfer
        held = sum(k[3] for k in _subject_cache)
        while _subject_cache and held + total > _SUBJECT_CACHE_MAX_BYTES:
            oldest = next(iter(_subject_cache))
            del _subject_cache[oldest]
            held -= oldest[3]
        if len(_subject_cache) >= 4:
            _subject_cache.clear()
        codes = encode_seq(sub)
        packed = pack_quarters_native(codes, total)
        if packed is None:
            padded = np.zeros(total, dtype=np.uint8)
            padded[:n] = codes.view(np.uint8)
            qq = padded.reshape(4, total // 4)
            packed = (qq[0] | (qq[1] << 2) | (qq[2] << 4) | (qq[3] << 6)).astype(np.uint8)
        codes_dev = _unpack_codes(jax.device_put(packed))
        _subject_cache[key] = codes_dev

    reg, mask = _query_register(q)
    qm = jnp.asarray(np.asarray([reg, mask], dtype=np.int32))
    nv = jnp.asarray(np.asarray([n_valid], dtype=np.int32))
    fn = _prefix_match_bitmaps_fn()
    bm = _with_retry(
        lambda: np.asarray(fn(codes_dev, qm, nv, span=span, n_spans=n_spans))
    ).reshape(-1)

    # host byte-verification over runs of active blocks
    out: list[int] = []
    active = np.nonzero(bm)[0]
    if active.size:
        run_breaks = np.nonzero(np.diff(active) > 1)[0]
        run_lo = np.concatenate([[0], run_breaks + 1])
        run_hi = np.concatenate([run_breaks, [active.size - 1]])
        for lo_i, hi_i in zip(run_lo, run_hi):
            lo = int(active[lo_i]) * _BLOCK
            hi = min((int(active[hi_i]) + 1) * _BLOCK, n_valid)
            start = sub.find(q, lo)
            while start != -1 and start < hi:
                out.append(start)
                start = sub.find(q, start + 1)
    return np.asarray(out, dtype=np.int64)


def _match_one(q: bytes, sub: bytes, overlap: bool, use_device: bool | None):
    if len(sub) < len(q):
        return None
    if use_device is None:
        use_device = len(sub) >= _DEVICE_MIN
    starts = match_starts_engine(sub, q) if use_device else match_starts_np(sub, q)
    if starts.size == 0:
        return None
    return _ranges(starts, len(q), overlap)


def first_match(source: PathOrRecords, query: Query) -> list[tuple[str, tuple[int, int]]]:
    """First occurrence per record (ref ExactMatch.jl:8-16; returns instead
    of printing)."""
    q = _as_bytes(query)
    out = []
    for rec in as_records(source):
        sub = _as_bytes(rec)
        pos = sub.find(q)
        if pos != -1:
            out.append((rec.identifier, (pos + 1, pos + len(q))))
    return out
