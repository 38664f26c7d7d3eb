"""ctypes binding + on-demand build of the native C++ IO library.

Builds ``kmergma/native/fastaio.cpp`` into a cached shared object with
g++ on first use (no pip / pybind11 dependency) and exposes a fast
mmap-based fasta loader.  Falls back silently to the pure-Python parser if
no toolchain is available - everything works without the native path, it is
a data-loader accelerator for multi-gigabase inputs.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None | bool" = None  # None = not tried, False = unavailable

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "fastaio.cpp")


def _build_lib() -> "ctypes.CDLL | None":
    so_path = _SRC.replace(".cpp", ".so")
    try:
        if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(_SRC):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", so_path, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
        lib = ctypes.CDLL(so_path)
        lib.semiglobal_batch  # newest symbol check (stale .so -> AttributeError)
    except (OSError, subprocess.SubprocessError, AttributeError):
        return None

    lib.fasta_stats.restype = ctypes.c_int
    lib.fasta_stats.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.fasta_parse.restype = ctypes.c_int
    lib.fasta_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.encode_seq.restype = ctypes.c_long
    lib.encode_seq.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p]
    lib.pack_quarters.restype = None
    lib.pack_quarters.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
    ]
    lib.scan_rolling_i64.restype = ctypes.c_int
    lib.scan_rolling_i64.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.semiglobal_batch.restype = ctypes.c_int
    lib.semiglobal_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int,            # a_idx, m
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,  # b_flat, b_off, b_len, n_subj
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # nuc44, gap_open, gap_extend
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ops_flat, ops_off, n_ops
        ctypes.c_void_p, ctypes.c_int,            # scores, n_threads
    ]
    return lib


def semiglobal_batch_native(a_idx: np.ndarray, bs: "list[np.ndarray]", nuc44: np.ndarray, gap_open: int, gap_extend: int):
    """Native threaded batch aligner.

    a_idx int8[m], bs = per-subject int8 letter-index arrays.  Returns
    (scores int64[n], ops int8 flat in traceback order, ops_off, n_ops) or
    None when the native library is unavailable.  Raises on a DP
    invariant violation (never observed; the fuzz suite pins equality).
    """
    lib = get_lib()
    if lib is None:
        return None
    m = int(a_idx.shape[0])
    n_subj = len(bs)
    b_len = np.asarray([b.shape[0] for b in bs], dtype=np.int64)
    b_off = np.zeros(n_subj, dtype=np.int64)
    np.cumsum(b_len[:-1], out=b_off[1:])
    b_flat = np.concatenate(bs).astype(np.int8) if n_subj else np.zeros(0, np.int8)
    caps = m + b_len + 2
    ops_off = np.zeros(n_subj, dtype=np.int64)
    np.cumsum(caps[:-1], out=ops_off[1:])
    ops_flat = np.empty(int(caps.sum()), dtype=np.int8)
    n_ops = np.empty(n_subj, dtype=np.int64)
    scores = np.empty(n_subj, dtype=np.int64)
    a8 = np.ascontiguousarray(a_idx, dtype=np.int8)
    nuc = np.ascontiguousarray(nuc44, dtype=np.int32)
    rc = lib.semiglobal_batch(
        a8.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(m),
        b_flat.ctypes.data_as(ctypes.c_void_p),
        b_off.ctypes.data_as(ctypes.c_void_p),
        b_len.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(n_subj),
        nuc.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(gap_open), ctypes.c_int(gap_extend),
        ops_flat.ctypes.data_as(ctypes.c_void_p),
        ops_off.ctypes.data_as(ctypes.c_void_p),
        n_ops.ctypes.data_as(ctypes.c_void_p),
        scores.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(min(8, os.cpu_count() or 1)),
    )
    if rc != 0:
        raise AssertionError("native traceback: inconsistent DP cell")
    return scores, ops_flat, ops_off, n_ops


def get_lib() -> "ctypes.CDLL | None":
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_lib() or False
    return _LIB or None


def load_fasta_native(path: str):
    """Parse a fasta file with the native library.

    Returns (codes, seq_bytes, offsets, lengths, descriptions) where
    ``codes`` is one contiguous int8 array of all records' 2-bit codes and
    ``seq_bytes`` the raw (case-preserved, whitespace-stripped) sequence
    bytes at the same offsets, or None if the native path is unavailable.
    Raises ValueError on invalid nucleotides (matching the Python parser).
    """
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        try:
            buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            return np.zeros(0, np.int8), np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, np.int64), []
        try:
            n = len(buf)
            n_records = ctypes.c_long()
            total_seq = ctypes.c_long()
            cbuf = (ctypes.c_char * n).from_buffer_copy(buf)
        finally:
            buf.close()

    rc = lib.fasta_stats(cbuf, n, ctypes.byref(n_records), ctypes.byref(total_seq))
    if rc != 0:
        raise ValueError(f"no fasta records found in {path}")
    nr = n_records.value
    codes = np.empty(total_seq.value, dtype=np.int8)
    seq_bytes = np.empty(total_seq.value, dtype=np.uint8)
    offsets = np.empty(nr, dtype=np.int64)
    lengths = np.empty(nr, dtype=np.int64)
    desc_buf = ctypes.create_string_buffer(n)
    desc_lens = np.empty(nr, dtype=np.int64)
    rc = lib.fasta_parse(
        cbuf, n,
        codes.ctypes.data_as(ctypes.c_void_p),
        seq_bytes.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
        desc_buf, n,
        desc_lens.ctypes.data_as(ctypes.c_void_p),
        nr,
    )
    if rc == -2:
        raise ValueError(
            f"invalid nucleotide character at byte {offsets[0]} of {path} (only A/C/G/T/N supported)"
        )
    if rc != 0:
        raise ValueError(f"malformed fasta file {path}")
    descs, d = [], 0
    raw = desc_buf.raw
    for r in range(nr):
        descs.append(raw[d : d + int(desc_lens[r])].decode("ascii"))
        d += int(desc_lens[r])
    return codes, seq_bytes, offsets, lengths, descs

def pack_quarters_native(codes: np.ndarray, total: int) -> "np.ndarray | None":
    """Quarter-wise 2-bit pack of ``codes`` zero-padded to ``total`` bases.

    Returns uint8[total // 4] (the layout ops.scan._unpack_codes expects),
    or None if the native library is unavailable.  Saves the padded int8
    copy and ~5x the numpy packing time on genome-scale inputs.
    """
    lib = get_lib()
    if lib is None:
        return None
    assert total % 4 == 0 and total >= codes.shape[0]
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    out = np.empty(total // 4, dtype=np.uint8)
    lib.pack_quarters(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(codes.shape[0]),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(total),
    )
    return out


def scan_rolling_i64_native(
    codes: np.ndarray, s_profile: np.ndarray, k: int, ws: int, r: int
) -> "np.ndarray | None":
    """Exact int64 scaled window distances via the native O(1)/bp rolling
    recurrence (the reference's own algorithm, GenomeMiner.jl:42-77).

    Returns int64[n - ws + 1], or None if the native library is
    unavailable.  Raises OverflowError if D would exceed int64.
    """
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    s64 = np.ascontiguousarray(s_profile, dtype=np.int64)
    nw = codes.shape[0] - ws + 1
    out = np.empty(max(nw, 1), dtype=np.int64)
    rc = lib.scan_rolling_i64(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(codes.shape[0]),
        s64.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(s64.shape[0]),
        ctypes.c_int(k),
        ctypes.c_int(ws),
        ctypes.c_longlong(r),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise OverflowError("scaled window distance exceeds int64")
    return out
