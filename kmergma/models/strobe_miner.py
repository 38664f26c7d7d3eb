"""Experimental strobemer scan engine
(ref KmerGMA.jl/src/StrobemerGMA/StrobeGenomeMiner.jl and StrobeRefGen.jl).

The reference recomputes each boundary strobemer from scratch per position
(StrobeGenomeMiner.jl:50-57, O(n*(w_max-w_min))); here strobemer codes for
ALL positions are extracted once, vectorised (ops/strobemers.strobe_2_mer_codes),
and only the O(1)/step distance recurrence runs sequentially.  The
recurrence is replicated exactly - including the reference's off-by-one
right-boundary anchor (seq[i+ws-k] rather than i+ws-k+1) whose drift makes
the rolling spectrum diverge from the true window spectrum; bit-parity with
the reference requires keeping it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

from ..ops.align import align_hits_batch, cigar_to_unitrange
from ..ops.consensus import Profile
from ..ops.scan import ScanEngine
from ..ops.strobemers import strobe_2_mer_codes, ungapped_strobe_2_mer_count_into
from ..utils.fasta import FastaRecord, PathOrRecords, as_records
from .miner import MineResult, fmt_dist


@dataclass
class StrobeProfile:
    mean_kfv: np.ndarray  # float64[4^(2s)]
    sum_kfv: np.ndarray  # int64[4^(2s)], exact integer sum (scan path)
    n_records: int
    windowsize: int
    consensus: str
    s: int
    w_min: int
    w_max: int
    q: int

    @property
    def k(self) -> int:
        return self.w_max + self.s - 1


def gen_strobe_ref_ws_cons(
    source: PathOrRecords, s: int = 2, w_min: int = 3, w_max: int = 5, q: int = 5
) -> StrobeProfile:
    """Strobemer-spectrum analogue of gen_ref_ws_cons (ref StrobeRefGen.jl:4-43)."""
    records = as_records(source)
    if not records:
        raise ValueError("reference set is empty")
    sums = np.zeros(4 ** (2 * s), dtype=np.float64)
    profile = Profile(1)
    n, cum = 0, 0
    for rec in records:
        n += 1
        cum += len(rec)
        ungapped_strobe_2_mer_count_into(rec.codes, sums, s, w_min, w_max, q)
        profile.lengthen(len(rec))
        profile.add(rec.codes)
    inv = 1.0 / n
    return StrobeProfile(
        mean_kfv=sums * inv,
        sum_kfv=sums.astype(np.int64),
        n_records=n,
        windowsize=int(np.round(cum * inv)),
        consensus=profile.consensus_str(),
        s=s,
        w_min=w_min,
        w_max=w_max,
        q=q,
    )


class StrobeSpanEngine(ScanEngine):
    """Production strobemer span engine: the StrobeGMA recurrence as a k=1
    spectrum scan.

    The reference's drift-bug recurrence (see ops/scan_strobe.py) evolves
    counts c_j = slidingcount_w(K, j) + e_x with x = K[w] the persistently
    double-counted strobemer, so its distance is EXACTLY

        D[j] = || r (u_j + e_x) - S ||^2  =  || r u_j - (S - r e_x) ||^2

    - a plain width-w sliding SPECTRUM distance against the modified profile
    S - r e_x.  That makes the whole production ScanEngine machinery (fixed
    compiled span shapes, certified lower-bound pruning, batched region
    recompute, checkpointable streams) apply verbatim with k=1 over the
    strobemer code alphabet; record length never recompiles.  Bit-equality with the sequential reference recurrence is
    pinned by tests/test_strobe_scan.py.
    """

    #: 4s-bit strobe codes (256 values at s=2) ship 1 byte each - 4x less
    #: H2D than int32; set per instance below

    #: The k-mer engine's depth-32 lower bound is USELESS here: with only
    #: 4^(2s) = 256 strobe values, random equal-pair collisions are 16x more
    #: frequent than for 6-mers, so the partial pair count misses most of
    #: ||c||^2 and the depth-32 bound flags ~99% of random windows (measured:
    #: mean L 16.6 vs mean D 48.2; depth >= ~256 of w = 282 is needed for any
    #: pruning).  Exact mode (depth None) computes true distances at
    #: O(W)/bp and its bitmap prunes perfectly,
    #: so the region recompute touches only genuinely active windows.

    def __init__(self, strobe_profile: StrobeProfile, xstar: int, chunk_windows: int | None = None, bound_depth: int | None = None):
        p = strobe_profile
        w = p.windowsize - p.k  # the reference's effective rolling width
        s_mod = p.sum_kfv.astype(np.int64).copy()
        s_mod[xstar] -= p.n_records
        super().__init__(
            s_mod, k=1, ws=w, r=p.n_records,
            chunk_windows=chunk_windows, bound_depth=bound_depth,
        )
        self.pack_codes = "byte" if 4 ** (2 * p.s) <= 256 else False
        # distances are reported in the reference's 1/(2 k_eff r^2) unit
        self.scale = 2.0 * p.k * p.n_records * p.n_records


_extract_jit = None


def _strobe_extract_padded(codes_dev, *, s, w_min, w_max, q, total):
    """Device strobemer extraction padded to the span engine's layout
    (int32; ONE module-level jit - keyed by (strobe params, genome bucket,
    span bucket) - so repeated records reuse the trace)."""
    import jax
    import jax.numpy as jnp

    global _extract_jit
    if _extract_jit is None:
        from ..ops.strobemers import strobe_2_mer_codes_jnp

        @partial(jax.jit, static_argnames=("s", "w_min", "w_max", "q", "total"))
        def run(codes_dev, *, s, w_min, w_max, q, total):
            sc = strobe_2_mer_codes_jnp(codes_dev, s, w_min, w_max, q).astype(jnp.int32)
            if sc.shape[0] >= total:
                return jax.lax.slice(sc, (0,), (total,))
            return jnp.pad(sc, (0, total - sc.shape[0]))

        _extract_jit = run
    return _extract_jit(codes_dev, s=s, w_min=w_min, w_max=w_max, q=q, total=total)


def _genome_codes_to_device(codes: np.ndarray):
    """Quarter-packed H2D of raw 2-bit genome codes (bucketed length so
    repeated record sizes share compiles), for on-device extraction."""
    import jax

    from ..ops.scan import _span_bucket, _unpack_codes
    from ..utils.native import pack_quarters_native

    n = codes.shape[0]
    total = -(-_span_bucket(n + 64) // 4) * 4
    packed = pack_quarters_native(codes, total)
    if packed is None:
        padded = np.zeros(total, dtype=np.uint8)
        padded[:n] = codes.view(np.uint8)
        qq = padded.reshape(4, total // 4)
        packed = (qq[0] | (qq[1] << 2) | (qq[2] << 4) | (qq[3] << 6)).astype(np.uint8)
    return _unpack_codes(jax.device_put(packed))


def strobe_mine_genome(
    genome: PathOrRecords,
    profile: StrobeProfile,
    thr: float = 33.5,
    buff: int = 50,
    do_align: bool = True,
    gap_open: int = -69,
    gap_extend: int = -5,  # StrobeGMA's default score model (StrobeGenomeMiner.jl:17)
    score_threshold: int = 0,
    do_return_dists: bool = False,
    do_return_align: bool = False,
    get_hit_loci: bool = False,
    chunk_windows: int | None = None,
    checkpoint_path: str | None = None,
    genome_dev: "list | None" = None,
    device_extract: bool | None = None,
    engine_cache: "dict | None" = None,
) -> MineResult:
    """Mine a genome with the strobemer engine.

    Where the backend policy says so (the GPU), or when
    ``device_extract=True`` / ``genome_dev`` is given, the strobemer
    extraction runs ON DEVICE: the record crosses the link as
    quarter-packed 2-bit GENOME codes (4 bases/byte) and
    ``strobe_2_mer_codes_jnp`` + the span scan stay on the device - the
    path bench.py times.  ``genome_dev`` optionally supplies
    already-device-resident genome code arrays per record (synthetic
    benches; padded at least ``_span_bucket`` long).  The host-extraction
    fallback ships strobe codes byte-packed (StrobeSpanEngine.pack_codes).
    """
    import jax.numpy as jnp

    from ..backend import policy
    from ..ops.scan import PreparedCodes, _span_bucket
    from ..ops.scan_strobe import strobe_scan_from_codes
    from .state_machine import candidate_stream_from_dists, replay_single

    if device_extract is None:
        device_extract = genome_dev is not None or policy().device_strobe_extract

    s, w_min, w_max, q = profile.s, profile.w_min, profile.w_max, profile.q
    k = profile.k
    ws = profile.windowsize
    r = profile.n_records
    w = ws - k
    scale = 2.0 * k * r * r
    consensus_ws = profile.consensus[:ws]

    res = MineResult()
    dist_parts: list[np.ndarray] = []
    # per x* (usually one); ``engine_cache`` lets repeated calls (timed
    # loops, many small genomes) reuse engines and their device caches
    engines: dict[int, StrobeSpanEngine] = (
        engine_cache if engine_cache is not None else {}
    )

    ckpt = None
    if checkpoint_path is not None:
        from ..utils.checkpoint import ScanCheckpoint

        genome_id = (
            f"strobe|{genome if isinstance(genome, str) else 'records'}"
            f"|s={s}|wmin={w_min}|wmax={w_max}|q={q}|ws={ws}|thr={thr}"
        )
        ckpt = ScanCheckpoint.load_or_create(checkpoint_path, genome_id)
        res.hits.extend(ckpt.restore_hits())
        res.hit_loci.extend(ckpt.hit_loci)

    genome_pos = ckpt.genome_pos if ckpt else 0
    for record_idx, record in enumerate(as_records(genome)):
        if ckpt and record_idx < ckpt.next_record:
            continue
        hits_before, loci_before = len(res.hits), len(res.hit_loci)
        seq_len = len(record)
        if seq_len < ws:
            # ref StrobeGenomeMiner.jl:36: `continue` skips genome_pos too
            if ckpt:
                ckpt.record_done(record_idx, genome_pos, [], [])
            continue
        n_steps = seq_len - ws - 1
        if n_steps < 1:
            # degenerate record: only the init window exists (host path)
            sc = strobe_2_mer_codes(record.codes, s, w_min, w_max, q)
            sprof = jnp.asarray(profile.sum_kfv.astype(np.int32))
            d_scaled = np.asarray(
                strobe_scan_from_codes(jnp.asarray(sc.astype(np.int32)), sprof, w, r, max(n_steps, 0))
            )
            dists = d_scaled.astype(np.float64) / scale
            dist0, stream = float(dists[0]), list(candidate_stream_from_dists(dists, thr))
        else:
            nw = n_steps + 1
            sc_prep = None
            if device_extract:
                # on-device extraction: the record crosses the link as
                # quarter-packed GENOME codes (or is already resident)
                gdev = (
                    genome_dev[record_idx]
                    if genome_dev is not None
                    else _genome_codes_to_device(record.codes)
                )
                tmpl = engines.get(-1)
                if tmpl is None:
                    tmpl = engines[-1] = StrobeSpanEngine(profile, 0, chunk_windows=chunk_windows)
                n_spans = _span_bucket(max(1, -(-nw // tmpl.chunk)))
                total = -(-(n_spans * tmpl.chunk + tmpl.rspan + tmpl.ws + 1) // 4) * 4
                sc_dev = _strobe_extract_padded(
                    gdev, s=s, w_min=w_min, w_max=w_max, q=q, total=total
                )
                xstar = int(np.asarray(sc_dev[w : w + 1])[0])
                sc_prep = PreparedCodes(sc_dev, n_spans)
                # shape carrier only (record_stream reads just its length)
                sc_shape = np.empty(nw + tmpl.ws - 1, dtype=tmpl._codes_dtype())
            else:
                # host extraction, byte-packed H2D (StrobeSpanEngine)
                sc = strobe_2_mer_codes(record.codes, s, w_min, w_max, q)
                xstar = int(sc[w])
            eng = engines.get(xstar)
            if eng is None:
                if len(engines) > 16:
                    tmpl_keep = engines.pop(-1, None)
                    engines.clear()
                    if tmpl_keep is not None:
                        engines[-1] = tmpl_keep
                eng = engines[xstar] = StrobeSpanEngine(profile, xstar, chunk_windows=chunk_windows)
            if sc_prep is not None:
                dist0, stream, dists = eng.record_stream(
                    sc_shape, thr, collect_dists=do_return_dists, codes_dev=sc_prep
                )
            else:
                dist0, stream, dists = eng.record_stream(
                    sc[: n_steps + w], thr, collect_dists=do_return_dists
                )
        if do_return_dists:
            dist_parts.append(np.asarray(dists[1:]) if dists is not None else np.empty(0))

        raw_hits = replay_single(
            stream, dist0, thr,
            k=k, ws=ws, seq_len=seq_len, buff=buff, cmi_offset=0,
        )

        alns = None
        if do_align and raw_hits:
            windows = [
                record.seq[h.start - 1 : h.stop].decode("ascii").upper()
                for h in raw_hits
            ]
            alns = align_hits_batch(consensus_ws, windows, gap_open, gap_extend)
        for hit_i, hit in enumerate(raw_hits):
            lo, hi = hit.start, hit.stop
            rng = (lo, hi)
            keep = True
            if do_align:
                aln = alns[hit_i]
                if aln.score < score_threshold:
                    keep = False  # ref Alignment.jl:96-98 score filter
                else:
                    if do_return_align:
                        res.alignments.append(aln)
                    alo, ahi = cigar_to_unitrange(aln)
                    rng = (max(1, lo + alo - 1), min(lo + ahi - 1, seq_len))
            if keep:
                desc = (
                    f"{record.identifier} | dist = {fmt_dist(hit.dist)}"
                    f" | MatchPos = {rng[0]}:{rng[1]}"
                    f" | GenomePos = {genome_pos}"
                    f" | Len = {rng[1] - rng[0] + 1}"
                )
                res.hits.append(FastaRecord(desc, record.seq[rng[0] - 1 : rng[1]].upper()))
                if get_hit_loci:
                    res.hit_loci.append(rng[0] + genome_pos)
        genome_pos += seq_len
        if ckpt:
            ckpt.record_done(
                record_idx, genome_pos, res.hits[hits_before:], res.hit_loci[loci_before:]
            )

    if ckpt:
        ckpt.done()
    if do_return_dists:
        res.dists = np.concatenate(dist_parts) if dist_parts else np.empty(0)
    return res
