"""The rolling k-mer-spectrum distance scan - the framework's hot path.

A data-parallel redesign of the reference's sequential O(1)/bp rolling update
(ref KmerGMA.jl/src/GenomeMiner.jl:60-77).  The reference carries a
mutable 4^k count vector and a Float64 distance accumulator along the
sequence - an inherently sequential recurrence.  We reformulate it as a
fully parallel computation in **exact scaled integers**:

Let R be the number of reference records and S = R * refVec the *integer*
summed reference spectrum.  Define the scaled distance of window p as

    D[p] = || R * c_p - S ||^2          (c_p = integer window spectrum)

so that the reference's kmerDist = D[p] / (2k * R^2) exactly (the mean
profile refVec = S / R).  The transition p -> p+1 removes k-mer l = K[p]
and adds r = K[p+W] (W = ws - k + 1), giving

    D[p+1] - D[p] = 2R^2*[l != r] + 2R^2*(c_p[r] - c_p[l]) + 2R*(S[l] - S[r])

which is the exact scaled-integer form of the reference's
``+= SF*(1 + c[r] + ref[l] - ref[r] - c[l])`` update (GenomeMiner.jl:70-77).
The window-count terms are de-sequentialised by the identities

    c_p[r] = #{ d in 1..W   : K[p+W-d] == K[p+W] }     (match-into-window)
    c_p[l] = #{ d in 0..W-1 : K[p+d]   == K[p]   }     (match-out-of-window)

- pure elementwise shifted comparisons (O(W)/bp of int ops, no gather or
scatter in the hot loop), followed by ONE cumulative sum.  Integer math makes
every window distance an exact rational, sidestepping the reference's float64
accumulation drift entirely (SURVEY.md section 7, hard part 2).

All shapes are static.  The exact pass's d-loop is a ``lax.fori_loop`` over
dynamic slices; the bitmap pass's shallow bound loop is unrolled, so XLA
fuses its compares into one elementwise kernel per span.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import ensure_compile_cache, policy


def rolling_kmer_codes_jnp(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Device version of ops.kmers.rolling_kmer_codes: K[i] = code of k-mer at i."""
    n = codes.shape[0]
    m = n - k + 1
    out = jnp.zeros(m, dtype=jnp.int32)
    for t in range(k):
        out = out + (codes[t : t + m].astype(jnp.int32) << (2 * (k - 1 - t)))
    return out


@partial(jax.jit, static_argnames=("k", "ws", "r"))
def scan_window_distances(codes: jnp.ndarray, s_profile: jnp.ndarray, k: int, ws: int, r: int) -> jnp.ndarray:
    """Exact scaled window distances D[s] for every window start s in [0, n-ws].

    Args:
      codes: int8/int32[n] 2-bit codes of one contig (or tile incl. halo).
      s_profile: int32[4^k] integer summed reference spectrum S = R * refVec.
      k, ws, r: k-mer length, window size, profile denominator R.

    Returns int32[n-ws+1]; true distance = D / (2k R^2).
    """
    n = codes.shape[0]
    w = ws - k + 1  # k-mers per window
    nw = n - ws + 1  # number of windows
    kcodes = rolling_kmer_codes_jnp(codes, k)
    g = jnp.take(s_profile, kcodes)  # S[K[i]]

    # First-window scaled distance, computed directly.
    c0 = jax.ops.segment_sum(
        jnp.ones(w, dtype=jnp.int32), kcodes[:w], num_segments=s_profile.shape[0]
    )
    diff0 = r * c0 - s_profile  # |entries| <= max(R*W, max(S)) < 2^15.5, squares fit int32
    d0 = jnp.sum(diff0 * diff0)

    if nw <= 1:
        return d0[None]

    kl = kcodes[: nw - 1]  # leaving k-mer of each transition
    kr = kcodes[w : w + nw - 1]  # entering k-mer

    def body(d, ab):
        a, b = ab
        # c_p[r]: compare entering k-mer with window k-mer at depth d (d = 1..W)
        a = a + (jax.lax.dynamic_slice(kcodes, (w - d,), (nw - 1,)) == kr)
        # c_p[l]: compare leaving k-mer with window k-mer at offset d-1 (0..W-1)
        b = b + (jax.lax.dynamic_slice(kcodes, (d - 1,), (nw - 1,)) == kl)
        return a, b

    # derive the zero carry from kl so its sharding/varying type matches the
    # body output under shard_map (see shard-map scan-vma docs)
    zero = jnp.zeros_like(kl)
    a, b = jax.lax.fori_loop(1, w + 1, body, (zero, zero))

    r2 = jnp.int32(2 * r * r)
    delta = r2 * (kl != kr) + r2 * (a - b) + (2 * r) * (g[: nw - 1] - g[w : w + nw - 1])
    return jnp.concatenate([d0[None], d0 + jnp.cumsum(delta)])


#: pair-count depths up to this are unrolled into straight-line code, which
#: XLA fuses into one elementwise kernel per span (a fori_loop costs
#: several kernels per depth step on the GPU - PERF.md, bring-up); deeper
#: loops (exact mode, depth w - 1) stay a fori_loop to bound program size
_UNROLL_DEPTH = 32


def _depth_loop(depth: int, body, init):
    """``body(d, acc)`` folded over d = 1..depth (static ``depth``)."""
    if depth <= _UNROLL_DEPTH:
        acc = init
        for d in range(1, depth + 1):
            acc = body(d, acc)
        return acc
    return jax.lax.fori_loop(1, depth + 1, body, init)


def _lower_bound_base(kcodes, g, s_profile, w: int, r: int, depth: int):
    """L[0] = r^2 (w + 2 P̂_0) - 2 r G_0 + ||S||^2 (the first window of a span).

    P̂_0 counts the first window's equal-k-mer pairs at partner distance
    <= depth; G_0 is the window's profile-projection sum.  All int32 (the
    headroom guard bounds every term).
    """
    k0 = kcodes[:w]
    idx = jnp.arange(w, dtype=jnp.int32)

    def body(d, acc):
        return acc + jnp.sum(
            ((jnp.roll(k0, -d) == k0) & (idx < w - d)).astype(jnp.int32)
        )

    p0 = _depth_loop(depth, body, jnp.int32(0))
    g0 = jnp.sum(g[:w])
    s2 = jnp.sum(s_profile * s_profile)
    return jnp.int32(r * r) * (jnp.int32(w) + 2 * p0) - jnp.int32(2 * r) * g0 + s2


def _pair_ab(kcodes: jnp.ndarray, w: int, nt: int, depth: int) -> jnp.ndarray:
    """Net pair-match delta ab[p] for transitions p in [0, nt) at partner
    distances 1..depth:

        ab[p] = sum_d eq(K[p+w-d], K[p+w]) - eq(K[p+d], K[p])

    ``kcodes`` must hold at least nt + w codes.  Returns int32[nt].
    """
    kl = kcodes[:nt]
    kr = kcodes[w : w + nt]

    def body(d, ab):
        a, b = ab
        # pairs gained by the entering k-mer at partner distance d
        a = a + (jax.lax.dynamic_slice(kcodes, (w - d,), (nt,)) == kr)
        # pairs lost by the leaving k-mer at partner distance d
        b = b + (jax.lax.dynamic_slice(kcodes, (d,), (nt,)) == kl)
        return a, b

    zero = jnp.zeros_like(kl)
    a, b = _depth_loop(depth, body, (zero, zero))
    return a - b


@partial(jax.jit, static_argnames=("k", "ws", "r", "depth"))
def scan_window_lower_bounds(
    codes: jnp.ndarray, s_profile: jnp.ndarray, k: int, ws: int, r: int, depth: int
) -> jnp.ndarray:
    """Certified scaled lower bounds L[p] <= D[p] for every window.

    Counts only equal-k-mer pairs whose in-window distance is <= ``depth``
    (P̂_p <= P_p), so with ||c_p||^2 = W + 2 P_p:

        L[p] = r^2 (W + 2 P̂_p) - 2 r (c_p . S) + ||S||^2  <=  D[p]

    with equality at depth = W - 1.  D < thr implies L < thr, so a bitmap
    built from L flags a superset of the exact pass at O(depth)/bp instead
    of O(W)/bp; flagged regions are then recomputed exactly.
    """
    n = codes.shape[0]
    w = ws - k + 1
    nw = n - ws + 1
    kcodes = rolling_kmer_codes_jnp(codes, k)
    g = jnp.take(s_profile, kcodes)
    l0 = _lower_bound_base(kcodes, g, s_profile, w, r, depth)
    if nw <= 1:
        return l0[None]

    ab = _pair_ab(kcodes, w, nw - 1, depth)
    delta = jnp.int32(2 * r * r) * ab + (2 * r) * (g[: nw - 1] - g[w : w + nw - 1])
    return jnp.concatenate([l0[None], l0 + jnp.cumsum(delta)])


def _plan_and_summarize(codes_dev, flat, rmeta, s_profile, *, k, ws, r, rspan, n_regions, block):
    """Device region planning + summarized recompute from a flat bool
    block-activity bitmap - the tail of the planned single-profile
    dispatch (_planned_dispatch).

    Mirrors ScanEngine._plan_starts's coverage (active blocks expanded one
    right, block 0 forced, coarsened to the rspan grid) with a
    cumsum+searchsorted compaction (no scatter), then
    runs _regions_summarized_multi_body over the planned starts.  Returns
    (d_flat, blob) with blob = [below words | borderline count | dist0 |
    starts | valid count | overflow] as one uint32 fetch.
    """
    sb = rspan // block
    n_blocks = flat.shape[0]
    shifted = jnp.pad(flat[:-1], (1, 0))
    active = (flat | shifted).at[0].set(True)
    asb = active.reshape(n_blocks // sb, sb).any(axis=1)
    # clamp to the record: expansion past the last valid window must not
    # emit a region starting >= nw (host _plan_starts clamps hi to nw)
    sb_starts = jnp.arange(asb.shape[0], dtype=jnp.int32) * rspan
    asb = asb & (sb_starts < rmeta[2])
    counts = jnp.cumsum(asb.astype(jnp.int32))
    nvr = counts[-1]
    overflow = (nvr > n_regions).astype(jnp.uint32)
    targets = jnp.arange(1, n_regions + 1, dtype=jnp.int32)
    sb_idx = jnp.searchsorted(counts, targets, side="left")
    starts = jnp.where(sb_idx >= asb.shape[0], 0, sb_idx).astype(jnp.int32) * rspan
    d_flat, words, red = _regions_summarized_multi_body(
        codes_dev, starts, s_profile[None], rmeta,
        k=k, rspan=rspan, n_regions=n_regions, specs=((ws, r),),
        region_valid=nvr[None],
        reduce_mi=(rmeta[2] - 1)[None],  # mi = nw - 1
    )
    blob = jnp.concatenate(
        [words, starts.astype(jnp.uint32), nvr[None].astype(jnp.uint32),
         overflow[None], red.astype(jnp.uint32)]
    )
    return d_flat, blob


@partial(jax.jit, static_argnames=("k", "ws", "r", "span", "block", "n_spans", "depth", "rspan", "n_regions"))
def _planned_dispatch(codes_dev, nv, s_profile, thr_dev, rmeta, *, k, ws, r, span, block, n_spans, depth, rspan, n_regions):
    """The span bitmap scan, the device region plan and the summarized
    recompute in ONE dispatch.  Returns (d_flat, blob, packed_bitmap) - the
    packed bitmap is fetched only on region-bucket overflow (host-planned
    fallback)."""
    bm = _scan_record_bitmaps(
        codes_dev, nv, s_profile, thr_dev, k=k, ws=ws, r=r, span=span,
        block=block, n_spans=n_spans, depth=depth,
    )
    flat = bm.reshape(-1).astype(bool)
    d_flat, blob = _plan_and_summarize(
        codes_dev, flat, rmeta, s_profile,
        k=k, ws=ws, r=r, rspan=rspan, n_regions=n_regions,
        block=block,
    )
    return d_flat, blob, _pack_bitmap_words(bm.reshape(-1))


def check_int32_headroom(s_profile: np.ndarray, ws: int, k: int, r: int) -> None:
    """Guard the exact-integer path against int32 overflow.

    Worst-case D = R^2 W^2 + 2 R W max(S) + ||S||^2 (window concentrated on
    one k-mer disjoint from the profile hotspots).  Realistic reference sets
    (R ~ 10^2) sit far below int32; huge R would need the float64 CPU path.
    """
    w = ws - k + 1
    s_max = int(np.max(np.abs(s_profile))) if s_profile.size else 0
    bound = r * r * w * w + 2 * r * w * s_max + int(np.dot(s_profile, s_profile))
    if bound >= 2**31:
        raise OverflowError(
            f"scaled-integer scan would overflow int32 (bound {bound:.3g}); "
            "use the exact int64 host engine (ops.scan_host.HostScanEngine - "
            "models.miner.mine_genome falls back to it automatically)"
        )


def _scan_span_bound(codes, s_profile, k, ws, r, depth):
    """Span distances (depth None) or certified lower bounds (depth set)."""
    if depth is None:
        return scan_window_distances(codes, s_profile, k, ws, r)
    return scan_window_lower_bounds(codes, s_profile, k, ws, r, depth)


@partial(jax.jit, static_argnames=("k", "ws", "r", "span", "block", "n_spans", "depth"))
def _scan_record_bitmaps(codes_dev, n_valid, s_profile, thr_int, *, k, ws, r, span, block, n_spans, depth=None):
    """Scan a whole record (n_spans regular spans); return ONLY the activity
    bitmaps (``any(D < thr)`` per ``block`` windows).

    One device call and one small fetch per record, with zero per-span host scalars (span starts are computed on
    device from the loop index).  Distances are NOT kept - the few active
    regions are recomputed on demand (_scan_regions_dense), trading negligible
    recompute for not holding or shipping O(genome) distance arrays.

    With ``depth`` set, the pass computes certified lower bounds L <= D at
    O(depth)/bp instead of exact distances at O(W)/bp; the bitmap is then a
    superset of the exact one (safe: the region recompute is always exact).
    """

    def step(_, i):
        start = i * span
        codes = jax.lax.dynamic_slice(codes_dev, (start,), (span + ws - 1,))
        d = _scan_span_bound(codes, s_profile, k, ws, r, depth)
        below = (d < thr_int[0]) & (start + jnp.arange(span) < n_valid[0])
        return _, below.reshape(span // block, block).any(axis=1)

    _, bitmaps = jax.lax.scan(step, 0, jnp.arange(n_spans))
    return bitmaps  # (n_spans, span // block)


def _scan_rows_d(rows, s_profile, k: int, ws: int, r: int):
    """Exact scaled distances for a BATCH of region rows in one fused pass.

    rows: int8[n, rspan + ws - 1] codes (one active region per row); returns
    int32[n, rspan] with row i's d[p] = D[starts[i] + p] - bit-identical to
    scan_window_distances on each row (tests/test_scan.py pins this).

    This is the hit-dense hot path: all active regions of a record are
    recomputed exactly in ONE batched device pass (batched K-code build,
    one profile lookup over the flattened batch, the pair-count loop with
    regions as rows, batched cumsum) instead of a
    sequential ``lax.map`` over per-region scans - the per-region dispatch
    latency and the O(rspan) tail work vanish into the batch.
    """
    n, total = rows.shape
    w = ws - k + 1
    rspan = total - ws + 1
    m = total - k + 1  # K codes per row
    kc = rows[:, 0:m].astype(jnp.int32) << (2 * (k - 1))
    for t in range(1, k):
        kc = kc + (rows[:, t : t + m].astype(jnp.int32) << (2 * (k - 1 - t)))
    g = jnp.take(s_profile, kc.reshape(-1)).reshape(n, m)

    # First-window distance per row, scatter-free (a per-row segment_sum
    # lowers to scatter):
    #   D0 = r^2 ||c0||^2 - 2 r (c0 . S) + ||S||^2
    # with ||c0||^2 = the full w x w equality-Gram sum of the window's
    # K codes (regions are rare, so the (n, w, w) compare is tiny) and
    # c0 . S = sum of g over the window.
    k0 = kc[:, :w]
    gram = (k0[:, :, None] == k0[:, None, :]).astype(jnp.int32)
    c0_sq = jnp.sum(gram, axis=(1, 2))
    s2 = jnp.sum(s_profile * s_profile)
    d0 = jnp.int32(r * r) * c0_sq - jnp.int32(2 * r) * jnp.sum(g[:, :w], axis=1) + s2
    if rspan == 1:
        return d0[:, None]

    nt = rspan - 1
    kl = kc[:, :nt]
    kr = kc[:, w : w + nt]

    def body(d, acc):
        a, b = acc
        a = a + (jax.lax.dynamic_slice_in_dim(kc, w - d, nt, axis=1) == kr)
        b = b + (jax.lax.dynamic_slice_in_dim(kc, d - 1, nt, axis=1) == kl)
        return a, b

    zero = jnp.zeros_like(kl)
    a, b = jax.lax.fori_loop(1, w + 1, body, (zero, zero))
    ab = a - b

    r2 = jnp.int32(2 * r * r)
    delta = r2 * (kl != kr) + r2 * ab + (2 * r) * (g[:, :nt] - g[:, w : w + nt])
    return jnp.concatenate([d0[:, None], d0[:, None] + jnp.cumsum(delta, axis=1)], axis=1)


@partial(jax.jit, static_argnames=("k", "ws", "r", "rspan", "n_regions"))
def _scan_regions_dense(codes_dev, starts, s_profile, *, k, ws, r, rspan, n_regions):
    """Exact distances of all active regions: ONE device call, ONE fetch.

    ``starts`` is padded to the static ``n_regions`` bucket (pad entries
    repeat start 0, ignored on host).  Rows are sliced on device (a small
    batched gather - regions are rare) and scanned as one batch."""
    rows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(codes_dev, (s,), (rspan + ws - 1,))
    )(starts)
    return _scan_rows_d(rows, s_profile, k, ws, r)


@partial(jax.jit, static_argnames=("k", "rspan", "n_regions", "specs"))
def _scan_regions_dense_multi(codes_dev, starts_flat, s_stack, *, k, rspan, n_regions, specs):
    """Exact region distances for ALL m clusters: ONE device call, ONE fetch.

    ``specs`` is a static tuple of (ws, r) per cluster; every cluster shares
    ONE ``n_regions`` bucket (the max over clusters - a single value in the
    jit key instead of the per-cluster product of buckets, each of which
    would compile anew).
    ``starts_flat`` concatenates each cluster's padded starts in spec order.
    Returns a flat int32[m * n_regions * rspan] (cluster-major, row-major)
    so the host pays one D2H transfer for every cluster's region recompute
    instead of m.
    """
    outs = []
    for ci, (ws, r) in enumerate(specs):
        starts = jax.lax.slice(starts_flat, (ci * n_regions,), ((ci + 1) * n_regions,))
        rows = jax.vmap(
            lambda s, ws=ws: jax.lax.dynamic_slice(codes_dev, (s,), (rspan + ws - 1,))
        )(starts)
        outs.append(_scan_rows_d(rows, s_stack[ci], k, ws, r).reshape(-1))
    return jnp.concatenate(outs)


@partial(jax.jit, static_argnames=("k", "ws", "r", "rspan", "n_regions"))
def _scan_region_rows_dense(rows, s_profile, *, k, ws, r, rspan, n_regions):
    """Dense region fetch over PRE-SLICED rows (the sharded-engine variant:
    when the record lives sharded across devices, active regions are shipped
    as explicit host-sliced rows - no device holds the whole record)."""
    return _scan_rows_d(rows, s_profile, k, ws, r)


def _below_and_words(d, starts, meta, n_valid_rows=None):
    """(below bool[n_regions, rspan], packed words blob) - the below mask
    feeds the fused run-reduce tail; the blob is _below_words_and_count's
    output (packed bits + borderline count + dist0)."""
    rspan = d.shape[1]
    cols = jnp.arange(rspan, dtype=jnp.int32)[None, :]
    valid = (starts[:, None] + cols) < meta[2]
    if n_valid_rows is not None:
        rows = jnp.arange(d.shape[0], dtype=jnp.int32)[:, None]
        valid = valid & (rows < n_valid_rows)
    below = (d < meta[0]) & valid
    border = (d >= meta[1]) & below
    words = _pack_bitmap_words(below.astype(jnp.int32).reshape(-1))
    count = jnp.sum(border, dtype=jnp.int32).astype(jnp.uint32)
    d0 = d[0, 0].astype(jnp.uint32)  # starts[0] == 0 always (window 0)
    return below, jnp.concatenate([words, count[None], d0[None]])


#: in-dispatch run-reduce slot bucket: per-profile capacity of the
#: run reduction (overflowing records fall back to the separate
#: run-reduce round trip - same results, one more trip).  4096 covers the
#: ~2-3.6k runs/record of the dense multi-Gbp bench records (43k stream
#: entries over 6 x 512 Mbp) at +60 KB of blob - the 1024 bucket sent
#: every such record through the fallback trip.
_RED_RUNS = 4096


def _device_run_reduce(d, below, starts, rspan, mi, run_bucket=None):
    """Run extraction + per-run (min, first-argmin) + edge values ON
    DEVICE - the run-reduce round trip folded into the planned dispatch
    (host equivalents: _extract_runs + _run_pieces + _run_reduce).

    d/below: int32/bool[n_regions, rspan]; starts: int32[n_regions] region
    start windows (device-planned grid: ascending, adjacent exactly where
    a run can cross a boundary); mi: last stream index (nw-1, or the Omn
    imax bound).  Run boundaries come from cumsum + searchsorted (no
    scatter); the per-run minima from a SEGMENTED prefix-scan carrying
    (min, first-argmin) with segments reset at run rises, read at run
    falls - pure elementwise work plus one log-depth scan.

    Returns int32[1 + 5*run_bucket] (run_bucket defaults to _RED_RUNS):
      [n_runs, run_arg_win[R], run_min[R], edge_win[R], edge_val[R],
       edge_ok[R]] - exactly the per-run data the host stream needs;
    slot overflow is detected by the caller via n_runs.
    """
    R = _RED_RUNS if run_bucket is None else run_bucket
    n_regions = d.shape[0]
    dfl = d.reshape(-1)
    nfl = dfl.shape[0]
    idxs = jnp.arange(nfl, dtype=jnp.int32)
    # win/contig as broadcasts, not genome-region-sized table gathers
    cols = jnp.arange(rspan, dtype=jnp.int32)[None, :]
    win = (starts[:, None] + cols).reshape(-1)
    fl = below.reshape(-1) & (win <= mi)
    fl = fl.at[0].set(False)  # window 0 = dist0, never in the stream
    starts_prev = jnp.concatenate([starts[:1] + 1, starts[:-1]])  # adj[0]=False
    adj = starts == starts_prev + rspan
    contig = jnp.concatenate(
        [adj[:, None], jnp.ones((n_regions, rspan - 1), bool)], axis=1
    ).reshape(-1)
    prev_b = jnp.concatenate([jnp.zeros(1, bool), fl[:-1]]) & contig
    rise = fl & ~prev_b
    nxt_contig = jnp.concatenate([contig[1:], jnp.zeros(1, bool)])
    nxt_b = jnp.concatenate([fl[1:], jnp.zeros(1, bool)]) & nxt_contig
    fall = fl & ~nxt_b
    cr = jnp.cumsum(rise.astype(jnp.int32))
    cf = jnp.cumsum(fall.astype(jnp.int32))
    n_runs = cr[-1]
    tr = jnp.arange(1, R + 1, dtype=jnp.int32)
    hi_f = jnp.clip(jnp.searchsorted(cf, tr, side="left"), 0, nfl - 1).astype(jnp.int32)
    jv = tr <= n_runs
    edge_win = jnp.where(jv, win[hi_f] + 1, 0)
    edge_ok = jv & nxt_contig[hi_f] & (win[hi_f] + 1 <= mi)
    edge_val = dfl[jnp.clip(hi_f + 1, 0, nfl - 1)]  # garbage where ~edge_ok

    # segmented prefix (min, first-argmin): segment starts at each rise,
    # ties keep the LEFT argument (the reference's strict-< minima update)
    val = jnp.where(fl, dfl, jnp.int32(2**31 - 1))
    flag = rise.astype(jnp.int32)

    def comb(a, b):
        fa, ma, aa = a
        fb, mb, ab = b
        tb = fb > 0
        m = jnp.where(tb, mb, jnp.minimum(ma, mb))
        arg = jnp.where(tb, ab, jnp.where(mb < ma, ab, aa))
        return fa | fb, m, arg

    _, mscan, ascan = jax.lax.associative_scan(comb, (flag, val, idxs))
    run_min = jnp.where(jv, mscan[hi_f], 0)
    run_arg_win = jnp.where(jv, win[jnp.clip(ascan[hi_f], 0, nfl - 1)], 0)
    return jnp.concatenate([
        n_runs[None], run_arg_win, run_min, edge_win,
        edge_val, edge_ok.astype(jnp.int32),
    ])


def _below_words_and_count(d, starts, meta, n_valid_rows=None):
    """Shared tail of the summarized region passes: packed conservative
    below bits + the borderline count + the record's first-window distance
    (see _scan_regions_summarized).

    d: int32[n_regions, rspan]; starts: int32[n_regions]; meta: int32[3] =
    [thr_int, thr_lo, nw].  Returns uint32[ceil(n_regions*rspan/32) + 2]
    with [borderline count, D[window 0]] appended - carrying dist0 in the
    words fetch lets a candidate-free record (the common sparse case) skip
    the run-reduce round trip entirely.

    ``n_valid_rows`` (traced scalar, optional) masks region slots >= it:
    the device-planned path (_plan_and_summarize) pads
    unused slots with start 0, whose recomputed windows must not leak
    below/borderline bits.
    """
    return _below_and_words(d, starts, meta, n_valid_rows)[1]


@partial(jax.jit, static_argnames=("k", "ws", "r", "rspan", "n_regions"))
def _scan_regions_summarized(codes_dev, starts, s_profile, meta, *, k, ws, r, rspan, n_regions):
    """Exact distances of all active regions + a COMPACT summary.

    Returns (d, words): ``d`` stays on device (the run-reduce pass gathers
    from it); only ``words`` - 1 bit per window of conservative-below flags
    plus one trailing borderline-count word - is fetched, 32x (+values)
    fewer D2H bytes than shipping ``d`` itself.

    ``meta`` is int32[3] = [thr_int, thr_lo, nw]: thr_int is the engine's
    conservative superset threshold; thr_lo the certainly-below bound
    (float64 host replay of any d < thr_lo is guaranteed < thr).  Windows
    with d in [thr_lo, thr_int) are BORDERLINE - their below/above status
    cannot be decided in integer space - and their count is appended so the
    host can fall back to the full fetch when (rarely) nonzero.
    """
    rows = jax.vmap(
        lambda s: jax.lax.dynamic_slice(codes_dev, (s,), (rspan + ws - 1,))
    )(starts)
    d = _scan_rows_d(rows, s_profile, k, ws, r)
    return d, _below_words_and_count(d, starts, meta)


@partial(jax.jit, static_argnames=("k", "ws", "r", "rspan", "n_regions"))
def _scan_region_rows_summarized(rows, starts, s_profile, meta, *, k, ws, r, rspan, n_regions):
    """Summarized variant over pre-sliced rows (sharded engines)."""
    d = _scan_rows_d(rows, s_profile, k, ws, r)
    return d, _below_words_and_count(d, starts, meta)


def _regions_summarized_multi_body(codes_dev, starts_flat, s_stack, meta, *, k, rspan, n_regions, specs, region_valid=None, reduce_mi=None):
    """Body of the summarized multi-cluster region pass (shared between the
    standalone jit below and the planned single-profile dispatch).

    ``region_valid`` (optional int32[m]) gives each cluster's count of
    device-planned region slots; padded slots are masked out of the below
    bits and borderline counts.  ``reduce_mi`` (optional int32[m] of last
    stream indices) additionally runs the fused run-reduce per cluster
    (_device_run_reduce) and returns its sections as a third output -
    zero further round trips for in-bucket records.
    """
    m = len(specs)
    d_parts = []
    word_parts = []
    count_parts = []
    d0_parts = []
    red_parts = []
    for ci, (ws, r) in enumerate(specs):
        starts = jax.lax.slice(starts_flat, (ci * n_regions,), ((ci + 1) * n_regions,))
        rows = jax.vmap(
            lambda s, ws=ws: jax.lax.dynamic_slice(codes_dev, (s,), (rspan + ws - 1,))
        )(starts)
        d = _scan_rows_d(rows, s_stack[ci], k, ws, r)
        cmeta = jnp.stack([meta[ci], meta[m + ci], meta[2 * m + ci]])
        below, wc = _below_and_words(
            d, starts, cmeta,
            n_valid_rows=None if region_valid is None else region_valid[ci],
        )
        if reduce_mi is not None:
            red_parts.append(
                _device_run_reduce(d, below, starts, rspan, reduce_mi[ci])
            )
        d_parts.append(d.reshape(-1))
        word_parts.append(wc[:-2])
        count_parts.append(wc[-2:-1])
        d0_parts.append(wc[-1:])
    d_flat = jnp.concatenate(d_parts)
    words = jnp.concatenate(word_parts + count_parts + d0_parts)
    if reduce_mi is None:
        return d_flat, words
    return d_flat, words, jnp.concatenate(red_parts)


@partial(jax.jit, static_argnames=("k", "rspan", "n_regions", "specs"))
def _scan_regions_summarized_multi(codes_dev, starts_flat, s_stack, meta, *, k, rspan, n_regions, specs):
    """Summarized region pass for ALL m clusters in one dispatch.

    specs: static ((ws, r), ...) per cluster; every cluster shares ONE
    ``n_regions`` bucket (the max over clusters) so the jit key is a single
    bucket value instead of the per-cluster product.
    ``meta`` is int32[3m] = [thr_int_c...] + [thr_lo_c...] + [nw_c...].
    Returns (d_flat, words): d_flat is int32[m * n_regions * rspan]
    (cluster-major, row-major) kept on device; words packs each cluster's
    below bits back to back, then m borderline-count words, then m
    first-window distances.
    """
    return _regions_summarized_multi_body(
        codes_dev, starts_flat, s_stack, meta,
        k=k, rspan=rspan, n_regions=n_regions, specs=specs,
    )


@partial(jax.jit, static_argnames=("n_pieces", "bucket"))
def _run_reduce(d_flat, packed, *, n_pieces, bucket):
    """Per-run-piece (min, first-argmin) + edge-value gather over the
    device-resident region distances.

    The host state-machine replay (models/state_machine.py) consumes, per
    maximal below-threshold run, only the run's minimum, the FIRST index
    attaining it, and the exact value of the rising-edge window after it -
    so instead of fetching every region distance, the host sends the run
    extents (flat indices into d_flat, split into <= ``bucket``-length
    pieces) and fetches back KBs of reductions.  jnp.argmin's
    first-occurrence semantics matches the reference's strict-< minima
    update.

    ``packed`` is ONE int32 array (one H2D transfer): piece start flats,
    piece lengths, then edge flats (index 0 = dist0 always first).  Returns
    one int32[2 * n_pieces + n_edges] (one D2H): piece mins, piece argmins,
    edge values.
    """
    flat = d_flat.reshape(-1)
    nmax = flat.shape[0] - 1
    piece_starts = jax.lax.slice(packed, (0,), (n_pieces,))
    piece_lens = jax.lax.slice(packed, (n_pieces,), (2 * n_pieces,))
    edge_idx = jax.lax.slice(packed, (2 * n_pieces,), (packed.shape[0],))
    off = jnp.arange(bucket, dtype=jnp.int32)[None, :]
    idx = jnp.clip(piece_starts[:, None] + off, 0, nmax)
    vals = jnp.take(flat, idx.reshape(-1)).reshape(idx.shape)
    masked = jnp.where(off < piece_lens[:, None], vals, jnp.int32(2**31 - 1))
    mins = jnp.min(masked, axis=1)
    argmins = jnp.argmin(masked, axis=1).astype(jnp.int32)
    edges = jnp.take(flat, jnp.clip(edge_idx, 0, nmax))
    return jnp.concatenate([mins, argmins, edges])


_RUN_BUCKET = 512  # piece length of the run-reduce gather
#: below this many region windows, fetching the raw distance rows (one
#: round trip, <= ~256 KB) beats the words+reduce round-trip pair
_FULL_FETCH_WINDOWS = 1 << 16


def _extract_runs(bits: np.ndarray, starts, rspan: int, max_index: int):
    """Below-run extents + rising-edge indices from per-region below bits.

    ``bits``: bool[>= len(starts) * rspan] (region-major); ``starts``: the
    region start windows (sorted, disjoint; adjacent exactly where a run
    can cross a region boundary).  All outputs are FLAT indices
    (region * rspan + col) into the region-major distance array - which are
    contiguous across adjacent regions, so every run is one flat interval.

    Window 0 (dist0, never part of the iterated stream) and windows past
    ``max_index`` are masked out, exactly like the old full-fetch stream's
    ``gidx >= 1`` filter and the Omn replay's i <= imax bound.

    Returns (run_lo, run_hi, edge_flat) int64 arrays; edge_flat is -1 where
    a run has no in-coverage rising edge (record end / max_index cut).
    """
    used = len(starts)
    sa = np.asarray(starts, dtype=np.int64)
    flat = bits[: used * rspan].reshape(used, rspan).copy()
    cols = np.arange(rspan, dtype=np.int64)
    flat &= (sa[:, None] + cols[None, :]) <= max_index
    flat[0, 0] = False
    flat = flat.reshape(-1)
    adj = np.empty(used, dtype=bool)
    adj[0] = False
    if used > 1:
        adj[1:] = sa[1:] == sa[:-1] + rspan
    breaks = np.nonzero(~adj)[0] * rspan  # flat positions opening a new extent
    prev = np.empty_like(flat)
    prev[0] = False
    prev[1:] = flat[:-1]
    prev[breaks] = False
    nxt = np.empty_like(flat)
    nxt[-1] = False
    nxt[:-1] = flat[1:]
    ends = breaks - 1
    nxt[ends[ends >= 0]] = False
    run_lo = np.nonzero(flat & ~prev)[0]
    run_hi = np.nonzero(flat & ~nxt)[0]

    edge = run_hi + 1
    # an edge exists iff the next window is inside the same covered extent
    # and within max_index (coverage guarantees every true rising edge of a
    # run is in an active-expanded block, hence in an adjacent region)
    in_cov = edge < used * rspan
    crosses = (edge % rspan == 0) & in_cov
    ok_cross = np.ones_like(in_cov)
    ok_cross[crosses] = adj[(edge[crosses] // rspan)]
    g_edge = np.where(in_cov, sa[np.clip(edge // rspan, 0, used - 1)] + edge % rspan, 0)
    has = in_cov & ok_cross & (g_edge <= max_index)
    return run_lo, run_hi, np.where(has, edge, -1)


def _run_pieces(run_lo: np.ndarray, run_hi: np.ndarray, bucket: int):
    """Split runs into <= bucket-length pieces for the fixed-shape gather.

    Returns (run_ids, piece_starts, piece_lens) with pieces grouped by run
    in order (the host recombines with first-min-wins semantics)."""
    lens = run_hi - run_lo + 1
    n_pieces = -(-lens // bucket)
    total = int(n_pieces.sum())
    run_ids = np.repeat(np.arange(len(run_lo)), n_pieces)
    first = np.cumsum(n_pieces) - n_pieces
    offs = np.arange(total) - first[run_ids]
    p_start = run_lo[run_ids] + offs * bucket
    p_len = np.minimum(bucket, run_hi[run_ids] + 1 - p_start)
    return run_ids, p_start, p_len


def _combine_pieces(run_ids, p_start, mins, argmins, n_runs):
    """Per-run (min, first-argmin) from per-piece reductions: first piece
    attaining the run minimum wins (strict-< left-to-right semantics)."""
    bounds = np.searchsorted(run_ids, np.arange(n_runs))
    run_min = np.minimum.reduceat(mins, bounds)
    cand = np.where(mins == run_min[run_ids], np.arange(len(mins)), 1 << 60)
    first_piece = np.minimum.reduceat(cand, bounds)
    arg_flat = p_start[first_piece] + argmins[first_piece]
    return run_min, arg_flat


@partial(jax.jit, static_argnames=("k", "ws", "r", "chunk"))
def _scan_at_full(codes_dev, start, s_profile, *, k, ws, r, chunk):
    codes = jax.lax.dynamic_slice(codes_dev, (start,), (chunk + ws - 1,))
    return scan_window_distances(codes, s_profile, k, ws, r)


@jax.jit
def _pack_bitmap_words(bm_flat):
    """0/1 int32[nb] -> uint32[ceil(nb/32)] bit-packed (zero-padded).

    Activity bitmaps leave the device once per record; packed they cost
    1 bit per block instead of 4 bytes - 32x less D2H traffic (4 MB ->
    125 KB per 512 Mbp record).  Word w bit i = block 32*w + i.
    """
    nb = bm_flat.shape[0]
    pad = (-nb) % 32
    if pad:
        bm_flat = jnp.pad(bm_flat, (0, pad))
    words = bm_flat.reshape(-1, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, :], axis=1, dtype=jnp.uint32)


def _unpack_bitmap_words(words: np.ndarray, n_blocks: int) -> np.ndarray:
    """Host inverse of _pack_bitmap_words -> bool[n_blocks]."""
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n_blocks].astype(bool)


def _with_retry(fn, attempts: int = 2, delay_s: float = 5.0):
    """Retry a device call once on a runtime error before surfacing it
    (SURVEY.md 5.3).  The scan is stateless per call, so a retry is always
    safe."""
    import time as _time

    last = None
    for attempt in range(attempts):
        try:
            return fn()
        except jax.errors.JaxRuntimeError as e:  # pragma: no cover - env specific
            last = e
            if attempt + 1 < attempts:
                _time.sleep(delay_s)
    raise last


@jax.jit
def _unpack_codes(packed):
    """uint8 (4 bases/byte, QUARTER-wise fields) -> int8 codes.

    Byte b packs code b of each genome quarter in its four 2-bit fields, so
    unpacking is a concat of four 1D shifted views - no interleave and no
    (n, 4) int8 intermediate at genome scale.
    """
    return jnp.concatenate(
        [((packed >> (2 * j)) & 3).astype(jnp.int8) for j in range(4)]
    )


def _check_record_len(n: int) -> None:
    """Per-record guard: device window indices/positions are int32.

    2^31-1 bp per record is ~8x the largest human chromosome; multi-Gbp
    GENOMES are fine - they are multiple records (the reference streams
    records the same way, GenomeMiner.jl:31-32)."""
    if n >= 2**31 - 2:
        raise ValueError(
            f"record of {n} bp exceeds the per-record device indexing limit "
            "(int32, ~2.1 Gbp); split the record - real contigs are far "
            "smaller, and multi-record genomes of any total size are supported"
        )


def _span_bucket(n: int) -> int:
    """Round span counts up to {1, 1.5} x power-of-two (<= 33% padding waste)."""
    b = 1
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b <<= 1
    return b


class PreparedCodes:
    """A record's codes on device, padded for regular-span slicing."""

    def __init__(self, dev, n_spans: int):
        self.dev = dev
        self.n_spans = n_spans


class ScanEngine:
    """Host-side driver of the tiled device scan for one reference profile.

    Tiles a record's windows into fixed-shape chunks (with ws-1 bp halo,
    SURVEY.md section 5.7 overlapped tiling); each tile's first-window
    spectrum is recomputed on device, making tiles independent.  Emits the
    sparse candidate stream for the exact host replay.
    """

    #: miners may dispatch the NEXT record's H2D before scanning the
    #: current one (cross-record transfer-compute overlap); engines that
    #: manage their own transfers (sharded, host) opt out
    prefetch_h2d = True

    #: 2-bit genome codes ship quarter-packed (4 bases/byte); engines whose
    #: code alphabet exceeds 2 bits ship "byte" (1 code/byte, alphabet <=
    #: 256 - the strobemer engine's 4^(2s)=256 codes at s=2, 4x less H2D
    #: than int32) or False (unpacked int32)
    pack_codes: "bool | str" = True

    def __init__(self, s_profile: np.ndarray, k: int, ws: int, r: int, chunk_windows: int | None = None, bound_depth: int | None = 16):
        ensure_compile_cache()
        check_int32_headroom(s_profile, ws, k, r)
        self.s_dev = jnp.asarray(s_profile.astype(np.int32))
        self.k, self.ws, self.r = k, ws, r
        # Bitmap passes use certified lower bounds at this pair depth
        # (None = exact distances).  Equality holds at depth = W - 1, so
        # clamping keeps short windows exact.  Default 16: the bound's low
        # tail is set by the profile-projection term, not the pair count -
        # on 8 Mbp random DNA the q1e-6 tail is 31.55 at depth 16 vs 31.64
        # at depth 32 (same flood margin), real-genome skirts widen ~10%,
        # and the pair stage halves.
        if bound_depth is not None:
            bound_depth = min(bound_depth, ws - k)
        self.bound_depth = bound_depth
        if chunk_windows is None:
            chunk_windows = policy().span_windows
        self.chunk = chunk_windows
        self.block = 512  # bitmap granularity (windows per activity block)
        # region-recompute granularity (hit fetch-back): regions tile RUNS of
        # active blocks tightly, so small spans keep the exact O(W)/bp
        # recompute - and the d-array fetch - proportional to the truly-
        # active windows (rspan = 2^16 bins recomputed ~70x more
        # windows than were active; 2^10 halves the fetch bytes vs 2^11 at
        # unchanged recompute cost - the batched pass makes regions ~free)
        self.rspan = 1 << 10
        #: device-side region planning (bitmap pass + plan + summarized
        #: recompute as ONE dispatch): default on for the
        #: reduced assembly mode; KMERGMA_DEVPLAN=0 opts out.  Records
        #: denser than the region bucket fall back to the host-planned
        #: path per record (the packed bitmap rides the same dispatch) and
        #: the bucket grows adaptively.
        self.device_plan = os.environ.get("KMERGMA_DEVPLAN", "") != "0"
        self.plan_regions = 256
        self.plan_regions_max = 1024
        self._thr_cache: tuple[float, object] | None = None
        self._nv_cache: dict[int, object] = {}  # n_valid H2D arrays by value
        self._meta_cache: dict[tuple, object] = {}  # summarized-pass metas
        # Stream assembly mode: "reduced" (default) fetches 1 bit/window of
        # below flags plus per-run (min, first-argmin) and edge-value
        # reductions - the replay provably needs nothing else - instead of
        # every region distance (32x+ fewer D2H bytes).  Records
        # with BORDERLINE integer distances (cannot be classified below/
        # above threshold on device; ~0 expected per record) fall back to
        # the exact full fetch automatically.  KMERGMA_ASSEMBLE=full opts
        # out entirely.
        self.assemble_mode = os.environ.get("KMERGMA_ASSEMBLE", "reduced")
        #: adaptive cutover: records whose active regions cover fewer
        #: windows than this fetch the raw distance rows in ONE round trip
        #: instead of the words+reduce pair (tests lower it to pin the
        #: reduced machinery on small fixtures)
        self.full_fetch_windows = _FULL_FETCH_WINDOWS
        self.scale = 2.0 * k * r * r

    def _thr_int(self, thr: float) -> np.int32:
        # Conservative device-side threshold: superset of the exact host
        # comparison (extra candidates are no-ops in the replay).
        return np.int32(min(np.floor(thr * self.scale) + 2, 2**31 - 1))

    def _thr_exact(self, thr: float) -> np.int32:
        """The EXACT integer threshold T: d < T  <=>  float64(d / scale)
        < thr - the precise comparison the host replay performs on stream
        values.  float64 division by a positive constant is monotone in d,
        so T exists and a 5-int search around floor(thr * scale) finds it;
        with T on both sides of the summarized pass's borderline interval,
        device below bits are exact and the full-fetch fallback never fires.
        """
        t0 = np.floor(thr * self.scale)
        if not np.isfinite(t0) or t0 >= 2**31 - 8:
            return np.int32(2**31 - 1)
        t = max(int(t0) - 2, -(2**31) + 8)
        while np.float64(t) / self.scale < thr:
            t += 1
        return np.int32(t)

    def _meta3(self, thr: float, nw: int):
        """Cached int32[3] = [thr_exact, thr_exact, nw] device array for
        the summarized region pass (one tiny H2D per distinct key).  Both
        bounds collapse onto the exact threshold, so the borderline set is
        empty by construction (the count plumbing remains as a guard)."""
        key = (float(thr), nw)
        dev = self._meta_cache.get(key)
        if dev is None:
            if len(self._meta_cache) > 64:
                self._meta_cache.clear()
            t = self._thr_exact(thr)
            dev = jnp.asarray(np.asarray([t, t, nw], dtype=np.int32))
            self._meta_cache[key] = dev
        return dev

    def _codes_dtype(self):
        if self.pack_codes is True:
            return np.int8
        if self.pack_codes == "byte":
            return np.uint8
        return np.int32

    def _nv(self, nw: int):
        """Cached device array for a record's window count - repeated scans
        of same-length records (and timed loops) skip the small H2D transfer."""
        dev = self._nv_cache.get(nw)
        if dev is None:
            if len(self._nv_cache) > 64:
                self._nv_cache.clear()
            dev = jnp.asarray(np.asarray([nw], dtype=np.int32))
            self._nv_cache[nw] = dev
        return dev

    def prepare_codes(self, codes: np.ndarray, max_ws: int | None = None) -> PreparedCodes:
        """One H2D transfer of a record, padded for regular-span slicing.

        Codes cross the host->device link packed 4 bases/byte and are
        unpacked on device.  The result can be shared by several
        engines scanning the same record (cluster mode) when padded for the
        largest windowsize; span counts are independent of ws by padding
        ceil(n/span)+bucket spans.
        """
        codes = np.asarray(codes, dtype=self._codes_dtype())
        n = codes.shape[0]
        _check_record_len(n)
        n_spans = _span_bucket(max(1, -(-n // self.chunk)))
        # headroom for region-recompute slices near the record end: a region
        # may start just below nw and extend rspan windows (dynamic_slice
        # would otherwise clamp and silently misattribute windows)
        total = n_spans * self.chunk + self.rspan + (max_ws if max_ws is not None else self.ws) + 1
        total = -(-total // 4) * 4
        # large records round up to a multiple of 64 Mi codes, so records of
        # similar length share one padded shape (and its compiled programs)
        unit = 64 << 20
        if total > unit:
            total = -(-total // unit) * unit
        if self.pack_codes is not True:
            padded = np.zeros(total, dtype=self._codes_dtype())
            padded[:n] = codes
            return PreparedCodes(_with_retry(lambda: jax.device_put(padded)), n_spans)
        from ..utils.native import pack_quarters_native

        packed = pack_quarters_native(codes, total)
        if packed is None:  # pure-numpy fallback (no g++ toolchain)
            padded = np.zeros(total, dtype=np.uint8)
            padded[:n] = codes.view(np.uint8)
            q = padded.reshape(4, total // 4)  # quarter-wise fields (see _unpack_codes)
            packed = (q[0] | (q[1] << 2) | (q[2] << 4) | (q[3] << 6)).astype(np.uint8)
        return PreparedCodes(_unpack_codes(_with_retry(lambda: jax.device_put(packed))), n_spans)

    def record_stream(self, codes: np.ndarray, thr: float, collect_dists: bool = False, codes_dev=None, seg_tracker=None):
        """Scan one record; return (dist0, stream, dists_or_None).

        ``dist0`` is the init-window distance, ``stream`` a sorted list of
        (window index >= 1, exact float64 distance) covering every window
        that can influence the minima state machine at threshold ``thr``.
        ``codes_dev`` may pass a pre-transferred padded device array
        (see ``prepare_codes``).  ``seg_tracker`` (utils.checkpoint.
        SegmentTracker) persists/restores per-segment progress on the
        long-record segmented path - mid-record checkpointing.
        """
        n = codes.shape[0]
        _check_record_len(n)
        nw = n - self.ws + 1
        assert nw >= 1
        thr_int = self._thr_int(thr)
        stream: list[tuple[int, float]] = []
        dist0 = None
        full_dists = np.empty(nw, dtype=np.float64) if collect_dists else None

        if codes_dev is None and not collect_dists and nw > 2 * self.chunk:
            # long records: pipelined per-segment transfer + bitmap dispatch
            # (transfer-compute overlap); active regions are re-fetched from
            # host codes, so no whole-record device array is ever held
            if self._thr_cache is None or self._thr_cache[0] != float(thr_int):
                self._thr_cache = (float(thr_int), jnp.asarray(np.asarray([thr_int], dtype=np.int32)))
            codes = np.asarray(codes, dtype=self._codes_dtype())
            bitmaps = _with_retry(
                lambda: self._segmented_bitmaps(codes, nw, thr_int, seg_tracker)
            )
            dist0, stream = self._assemble_stream(codes, nw, thr, bitmaps)
            return dist0, stream, None

        if codes_dev is None:
            codes_dev = self.prepare_codes(codes)
        prep: PreparedCodes = codes_dev

        if collect_dists:
            host_prev_below = False
            start = 0
            while start < nw:
                t = min(self.chunk, nw - start)
                d = np.asarray(
                    _scan_at_full(
                        prep.dev, np.int32(start), self.s_dev,
                        k=self.k, ws=self.ws, r=self.r, chunk=self.chunk,
                    )
                )[:t]
                full_dists[start : start + t] = d / self.scale
                self._stream_from_full(d, start, host_prev_below, thr_int, stream)
                host_prev_below = bool(d[t - 1] < thr_int)
                start += t
            return float(full_dists[0]), stream, full_dists

        # Bitmap path: ONE device call for the whole record returns only the
        # per-block activity bitmaps (one small fetch); the host recomputes
        # distances for the few active regions.  Zero per-span host scalars.
        if self._thr_cache is None or self._thr_cache[0] != float(thr_int):
            self._thr_cache = (float(thr_int), jnp.asarray(np.asarray([thr_int], dtype=np.int32)))
        thr_dev = self._thr_cache[1]

        if self.device_plan and self.assemble_mode == "reduced":
            dist0, stream = self._planned_record(prep, nw, thr, thr_int, thr_dev)
            return dist0, stream, full_dists

        n_blocks = prep.n_spans * (self.chunk // self.block)
        bitmaps = _with_retry(
            lambda: _unpack_bitmap_words(
                np.asarray(
                    _pack_bitmap_words(
                        _scan_record_bitmaps(
                            prep.dev, self._nv(nw), self.s_dev, thr_dev,
                            k=self.k, ws=self.ws, r=self.r, span=self.chunk, block=self.block,
                            n_spans=prep.n_spans, depth=self.bound_depth,
                        ).reshape(-1)
                    )
                ),
                n_blocks,
            )
        )
        dist0, stream = self._assemble_stream(prep, nw, thr, bitmaps)
        return dist0, stream, full_dists

    def _planned_record(self, prep: "PreparedCodes", nw: int, thr: float, thr_int, thr_dev):
        """One-dispatch planned record.

        The bitmap pass, the device region plan and the exact summarized
        recompute run as ONE jit, and the run extraction + per-piece minima
        ride the same dispatch - ONE host round trip per record for
        in-bucket, borderline-free records.  Slot-bucket overflow falls back to the
        separate run-reduce trip; region-bucket overflow to the
        host-planned path (bucket jumps straight to the fitting tier).
        Returns (dist0, stream).
        """
        rspan = min(self.chunk, self.rspan)
        n_regions = self.plan_regions
        rmeta = self._meta3(thr, nw)
        n_blocks = prep.n_spans * (self.chunk // self.block)
        d_h, blob_h, packed_h = _with_retry(
            lambda: _planned_dispatch(
                prep.dev, self._nv(nw), self.s_dev, thr_dev, rmeta,
                k=self.k, ws=self.ws, r=self.r, span=self.chunk,
                block=self.block, n_spans=prep.n_spans,
                depth=self.bound_depth, rspan=rspan, n_regions=n_regions,
            )
        )
        blob = _with_retry(lambda: np.asarray(blob_h))
        W = n_regions * rspan // 32
        words = blob[: W + 2]
        o = W + 2
        starts_arr = blob[o : o + n_regions].astype(np.int64)
        o += n_regions
        nvr = int(blob[o])
        overflow = int(blob[o + 1])
        red = blob[o + 2 :].view(np.int32)
        if overflow:
            # jump straight to the bucket that fits (nvr = the TRUE count,
            # it rides the blob even on overflow) - tier-by-tier growth
            # would cost one compile per tier
            while self.plan_regions < nvr and self.plan_regions < self.plan_regions_max:
                self.plan_regions *= 2
            if nvr > self.plan_regions_max:
                self.device_plan = False
            flat = _unpack_bitmap_words(
                _with_retry(lambda: np.asarray(packed_h)), n_blocks
            )
            return self._assemble_stream(prep, nw, thr, flat)
        if nvr > (3 * n_regions) // 4 and self.plan_regions < self.plan_regions_max:
            self.plan_regions = min(self.plan_regions * 2, self.plan_regions_max)
        starts = starts_arr[:nvr].tolist()
        # same raw-distance cutover as the host-planned path, keyed on the
        # host path's equivalent bucket so the two cut over together and
        # streams stay bit-identical everywhere
        if _span_bucket(max(1, nvr)) * rspan <= self.full_fetch_windows:
            d_all = _with_retry(lambda: np.asarray(d_h)).reshape(n_regions, rspan)
            return self._stream_from_region_dists(
                d_all[:nvr], starts, rspan, nw, thr_int
            )
        if int(words[-2]) > 0:
            # borderline integer distances present (non-exact threshold
            # injected): exact full fetch (rare)
            d_all = _with_retry(lambda: np.asarray(d_h)).reshape(n_regions, rspan)
            return self._stream_from_region_dists(
                d_all[:nvr], starts, rspan, nw, thr_int
            )
        dist0 = float(np.int64(words[-1])) / self.scale
        # fused run-reduce rode the blob: zero further round trips unless
        # the record overflowed the run/piece slot buckets
        stream = self._stream_from_device_reduce(red, dist0)
        if stream is not None:
            return dist0, stream
        bits = _unpack_bitmap_words(words[:-2], n_regions * rspan)[: nvr * rspan]
        return self._stream_from_reduction(d_h, bits, starts, rspan, nw - 1, dist0)

    def _stream_from_device_reduce(self, red: np.ndarray, dist0: float, run_bucket: "int | None" = None):
        """Stream assembly from a fetched _device_run_reduce section: the
        per-run (first-argmin window, min) entries plus the rising-edge
        entries, merge-sorted - bit-identical to _finish_reduction's
        output by construction.  Returns None on run-slot overflow (the
        caller falls back to the separate run-reduce round trip)."""
        R = _RED_RUNS if run_bucket is None else run_bucket
        n_runs = int(red[0])
        if n_runs > R:
            return None
        if n_runs == 0:
            return []
        o = 1
        arg_win = red[o : o + R][:n_runs].astype(np.int64)
        o += R
        run_min = red[o : o + R][:n_runs].astype(np.int64)
        o += R
        edge_win = red[o : o + R][:n_runs].astype(np.int64)
        o += R
        edge_val = red[o : o + R][:n_runs].astype(np.int64)
        o += R
        edge_ok = red[o : o + R][:n_runs].astype(bool)
        idx = np.concatenate([arg_win, edge_win[edge_ok]])
        vals = np.concatenate([run_min, edge_val[edge_ok]]).astype(np.float64) / self.scale
        order = np.argsort(idx, kind="stable")
        return list(zip(idx[order].tolist(), vals[order].tolist()))

    def _segmented_bitmaps(self, codes: np.ndarray, nw: int, thr_int, tracker=None) -> np.ndarray:
        """Pipelined whole-record bitmaps: transfer-compute overlap.

        Splits the record into fixed segments of 2 x chunk windows, and for
        each segment DISPATCHES its (packed, chunked) H2D transfer and its
        bitmap pass without blocking, fetching results two segments behind -
        so segment i+1's transfer rides the link while segment i computes
        (SURVEY.md section 2.2 PP row: double-buffered device feeds).  The
        sliding fetch also bounds live device memory to ~3 segments, so
        arbitrarily long records never exhaust HBM.

        ``tracker`` (utils.checkpoint.SegmentTracker) makes the pass
        resumable MID-RECORD: each fetched segment's packed words are
        persisted, and a resumed scan restores them and recomputes only
        the remaining segments (SURVEY section 5.4).
        """
        seg = 2 * self.chunk
        blocks_per_seg = seg // self.block
        thr_dev = jnp.asarray(np.asarray([thr_int], dtype=np.int32))
        start_seg = 0
        out: list[np.ndarray] = []
        if tracker is not None:
            # every parameter that shapes the stored words or their segment
            # offsets - stale-parameter checkpoints are discarded, not
            # misread (words from a different chunk/block/threshold would
            # silently misalign the restored bitmaps)
            fp = (
                f"{self.k}|{self.ws}|{self.r}|{self.chunk}|{self.block}|"
                f"{int(thr_int)}|{self.bound_depth}|{nw}"
            )
            start_seg, restored = tracker.resume(fp)
            out = [_unpack_bitmap_words(w, blocks_per_seg) for w in restored]
        pending: list = []  # (seg_idx, prep, words_handle) not yet fetched

        def fetch_one():
            si, _prep, wh = pending.pop(0)
            w = np.asarray(wh)
            out.append(_unpack_bitmap_words(w, blocks_per_seg))
            if tracker is not None:
                tracker.done_segment(si, w, fp)

        for si, off in enumerate(range(0, nw, seg)):
            if si < start_seg:
                continue  # restored from the checkpoint
            seg_codes = codes[off : off + seg + self.ws - 1]
            prep = self.prepare_codes(seg_codes)  # async H2D dispatch
            # this segment owns windows [off, off + seg); its codes slice
            # covers exactly those, so clamp validity to the segment too
            # (prepare_codes buckets by code length, which may round up to
            # an extra span - those trailing blocks are trimmed below)
            nv_seg = min(nw - off, seg)
            bm = _scan_record_bitmaps(
                prep.dev, self._nv(nv_seg), self.s_dev, thr_dev,
                k=self.k, ws=self.ws, r=self.r, span=self.chunk, block=self.block,
                n_spans=prep.n_spans, depth=self.bound_depth,
            )
            # bit-pack ON DISPATCH so the deferred fetch ships 1 bit/block
            wh = _pack_bitmap_words(bm.reshape(-1))
            pending.append((si, prep, wh))
            if len(pending) > 2:  # fetch behind the dispatch front
                fetch_one()
        while pending:
            fetch_one()
        return np.concatenate(out)

    def _assemble_stream(self, source, nw: int, thr: float, bitmaps: np.ndarray, max_index: int | None = None):
        """Turn a record's activity bitmaps into the exact candidate stream.

        Recomputes the few active regions exactly on device (one batched
        call, one fetch) and assembles the sorted (window index >= 1, exact
        distance) stream plus the record's first-window distance.  Shared by
        the single-profile path, the one-pass cluster engine
        (ops/scan_cluster.py) and the sharded engines
        (parallel/sharded_scan.py), which compute bitmaps their own way but
        assemble streams through here.

        ``source`` is either a PreparedCodes (regions sliced from the
        whole-record device array) or the record's host codes (regions
        shipped as explicit rows - the sharded path, where no single device
        holds the whole record).
        """
        return self._assemble_finish(self._assemble_plan(source, nw, thr, bitmaps, max_index))

    def _assemble_plan(self, source, nw: int, thr: float, bitmaps: np.ndarray, max_index: int | None = None) -> dict:
        """Phase 1 of stream assembly: derive the active regions and
        DISPATCH their exact batched recompute without blocking.

        Splitting dispatch from fetch lets callers with several independent
        assemblies (the cluster engine's m per-cluster streams) put every
        fetch in flight before the first blocking read - the round-trip
        latencies overlap instead of summing.

        Regions TILE RUNS of active blocks (rspan windows per region,
        adjacent within a run, disjoint always), so the exact O(W)/bp
        recompute covers ~the active windows only - not whole power-of-two
        bins around them.

        ``max_index`` bounds the stream (cluster mode's i <= imax loop
        bound, applied at reduction time so run minima never see windows
        the reference would not scan); default = every window.
        """
        thr_int = self._thr_int(thr)
        starts, rspan = self._plan_starts(bitmaps, nw)
        n_regions = _span_bucket(len(starts))
        starts_pad = np.zeros(n_regions, dtype=np.int32)
        starts_pad[: len(starts)] = starts
        reduced = self.assemble_mode == "reduced"

        if reduced:
            meta = self._meta3(thr, nw)

            def dispatch():
                return self._dispatch_regions_summarized(
                    source, starts_pad, rspan, n_regions, meta
                )
        else:

            def dispatch():
                return self._dispatch_regions_dense(source, starts_pad, nw, rspan, n_regions)

        try:
            handles = dispatch()
        except jax.errors.JaxRuntimeError:  # transport hiccup: retry at fetch
            handles = None
        return {
            "handles": handles, "dispatch": dispatch, "reduced": reduced,
            "nw": nw, "thr_int": thr_int, "starts": starts, "rspan": rspan,
            "n_regions": n_regions,
            "max_index": nw - 1 if max_index is None else min(max_index, nw - 1),
        }

    def _plan_starts(self, bitmaps: np.ndarray, nw: int) -> tuple[list[int], int]:
        """Region planning: starts of rspan-window regions TILING the runs
        of active blocks (adjacent within a run, disjoint always), so the
        exact O(W)/bp recompute covers ~the active windows only."""
        block = self.block
        # active blocks, expanded one block right (covers every rising edge)
        active = bitmaps.copy()
        active[1:] |= bitmaps[:-1]
        active[0] = True  # window 0 (dist0)

        rspan = min(self.chunk, self.rspan)
        starts: list[int] = []
        cover_end = 0  # windows covered so far (exclusive)
        for b in np.nonzero(active)[0]:
            lo = max(int(b) * block, cover_end)
            hi = min((int(b) + 1) * block, nw)
            while lo < hi:
                starts.append(lo)
                cover_end = lo + rspan
                lo = cover_end
        return starts, rspan

    def _assemble_finish(self, plan: dict):
        """Phase 2: fetch the summary (or, in "full" mode / on borderline
        distances, every region distance), reduce, and assemble the exact
        candidate stream (re-dispatching once on a transport failure)."""
        nw, thr_int = plan["nw"], plan["thr_int"]
        starts, rspan = plan["starts"], plan["rspan"]
        if not plan["reduced"]:
            try:
                if plan["handles"] is None:
                    raise jax.errors.JaxRuntimeError("deferred dispatch failure")
                d_all = np.asarray(plan["handles"])
            except jax.errors.JaxRuntimeError:
                d_all = _with_retry(lambda: np.asarray(plan["dispatch"]()))
            return self._stream_from_region_dists(d_all, starts, rspan, nw, thr_int)

        try:
            if plan["handles"] is None:
                raise jax.errors.JaxRuntimeError("deferred dispatch failure")
            d_handle, words_handle = plan["handles"]
        except jax.errors.JaxRuntimeError:
            d_handle, words_handle = _with_retry(plan["dispatch"])
        if len(starts) * rspan <= self.full_fetch_windows:
            # few active regions: the raw distance rows are small enough
            # that ONE fetch beats the words+reduce round-trip pair
            d_all = _with_retry(lambda: np.asarray(d_handle))
            return self._stream_from_region_dists(d_all, starts, rspan, nw, thr_int)
        words = _with_retry(lambda: np.asarray(words_handle))
        if int(words[-2]) > 0:
            # borderline integer distances present: the below/above split
            # cannot be certified on device - exact full fetch (rare)
            d_all = _with_retry(lambda: np.asarray(d_handle))
            return self._stream_from_region_dists(d_all, starts, rspan, nw, thr_int)
        bits = _unpack_bitmap_words(words[:-2], plan["n_regions"] * rspan)
        dist0 = float(np.int64(words[-1])) / self.scale
        return self._stream_from_reduction(
            d_handle, bits, starts, rspan, plan["max_index"], dist0
        )

    def _stream_from_reduction(self, d_handle, bits, starts, rspan, max_index, dist0):
        """Reduced-path stream assembly: extract runs on host from the
        below bits, reduce them on device (_run_reduce), synthesize the
        minimal equivalent stream.  A candidate-free record (no runs, no
        edges) returns without any further device round trip - dist0
        arrived with the words fetch.  Returns (dist0, stream).
        """
        if starts[0] != 0:
            raise AssertionError("scan bitmap path missed window 0")
        run_lo, run_hi, edge_flat = _extract_runs(bits, starts, rspan, max_index)
        if len(run_lo) == 0:
            return dist0, []
        run_ids, p_start, p_len = _run_pieces(run_lo, run_hi, _RUN_BUCKET)
        edge_ok = edge_flat >= 0
        edge_list = edge_flat[edge_ok]
        out = self._reduce_on_device(d_handle, [(p_start, p_len, edge_list)])[0]
        return self._finish_reduction(
            out, starts, rspan, run_lo, run_hi, edge_flat, edge_ok,
            run_ids, p_start, dist0,
        )

    def _reduce_on_device(self, d_handle, requests: list):
        """Run _run_reduce over one or more (p_start, p_len, edge_list)
        request groups against one device distance array: ONE packed H2D,
        ONE dispatch, ONE D2H for all of them (the cluster engine's m
        clusters batch through here).  Returns one int32 result array per
        request, [mins | argmins | edge_vals]."""
        n_pieces = sum(len(r[0]) for r in requests)
        n_edges = sum(len(r[2]) for r in requests)
        # flat distance indices ride int32 in the packed request; the
        # record-length (<2^31-2 bp) and cluster flat-total (<2^31) guards
        # keep them in range - assert rather than silently wrap
        for ps, _pl, el in requests:
            if (len(ps) and int(np.max(ps)) >= 2**31) or (
                len(el) and int(np.max(el)) >= 2**31
            ):
                raise AssertionError("flat distance index exceeds int32 range")
        np_b = _span_bucket(max(1, n_pieces))
        ne_b = _span_bucket(max(1, n_edges))
        packed = np.zeros(2 * np_b + ne_b, dtype=np.int32)
        off = 0
        for ps, _pl, _el in requests:
            packed[off : off + len(ps)] = ps
            off += len(ps)
        off = np_b
        for _ps, pl, _el in requests:
            packed[off : off + len(pl)] = pl
            off += len(pl)
        off = 2 * np_b
        for _ps, _pl, el in requests:
            packed[off : off + len(el)] = el
            off += len(el)
        res = _with_retry(
            lambda: np.asarray(
                _run_reduce(
                    d_handle, jnp.asarray(packed), n_pieces=np_b, bucket=_RUN_BUCKET
                )
            )
        )
        outs = []
        po = 0
        eo = 0
        for ps, _pl, el in requests:
            outs.append(
                np.concatenate(
                    [
                        res[po : po + len(ps)],
                        res[np_b + po : np_b + po + len(ps)],
                        res[2 * np_b + eo : 2 * np_b + eo + len(el)],
                    ]
                )
            )
            po += len(ps)
            eo += len(el)
        return outs

    def _finish_reduction(self, out, starts, rspan, run_lo, run_hi, edge_flat, edge_ok, run_ids, p_start, dist0):
        """Synthesize (dist0, stream) from a fetched reduction result."""
        n_p = len(p_start)
        mins, argmins = out[:n_p], out[n_p : 2 * n_p]
        edge_vals = out[2 * n_p :]
        n_runs = len(run_lo)
        if n_runs == 0:
            return dist0, []
        run_min, arg_flat = _combine_pieces(run_ids, p_start, mins, argmins, n_runs)
        sa = np.asarray(starts, dtype=np.int64)
        g_min = sa[arg_flat // rspan] + arg_flat % rspan
        ef = edge_flat[edge_ok]
        g_edge = sa[ef // rspan] + ef % rspan
        idx = np.concatenate([g_min, g_edge])
        vals = np.concatenate([run_min, edge_vals]).astype(np.float64) / self.scale
        order = np.argsort(idx, kind="stable")
        return dist0, list(zip(idx[order].tolist(), vals[order].tolist()))

    def _stream_from_region_dists(self, d_all: np.ndarray, starts: list[int], rspan: int, nw: int, thr_int) -> tuple[float, list[tuple[int, float]]]:
        """Assemble (dist0, sorted candidate stream) from fetched region
        distance rows d_all[i] = D[starts[i] : starts[i] + rspan]."""
        if starts[0] != 0:
            raise AssertionError("scan bitmap path missed window 0")
        dist0 = float(d_all[0, 0]) / self.scale

        parts_idx: list[np.ndarray] = []
        parts_val: list[np.ndarray] = []
        prev_end_below = False  # run continuing across adjacent regions
        prev_start = -(1 << 60)
        for i, start in enumerate(starts):
            limit = min(rspan, nw - start)
            d = d_all[i, :limit]
            below = d < thr_int
            prev = np.empty(limit, dtype=bool)
            prev[0] = prev_end_below and (prev_start + rspan == start)
            prev[1:] = below[:-1]
            keep = np.nonzero(below | prev)[0]
            parts_idx.append(keep + start)
            parts_val.append(d[keep].astype(np.float64) / self.scale)
            prev_end_below = bool(below[limit - 1])
            prev_start = start

        gidx = np.concatenate(parts_idx) if parts_idx else np.empty(0, np.int64)
        gvals = np.concatenate(parts_val) if parts_val else np.empty(0)
        keep = gidx >= 1  # regions are sorted and disjoint: stream is sorted
        return dist0, list(zip(gidx[keep].tolist(), gvals[keep].tolist()))

    def _region_rows(self, codes_np: np.ndarray, starts, rspan: int) -> np.ndarray:
        """Slice (and zero-pad) explicit region rows from host codes."""
        rows = np.zeros((len(starts), rspan + self.ws - 1), dtype=codes_np.dtype)
        for i, s in enumerate(starts):
            seg = codes_np[int(s) : int(s) + rspan + self.ws - 1]
            rows[i, : seg.shape[0]] = seg
        return rows

    def _dispatch_regions_dense(self, source, starts_pad, nw, rspan, n_regions):
        """Dispatch the batched exact region recompute; returns the device
        handle (the caller materialises it, possibly after other dispatches)."""
        if isinstance(source, PreparedCodes):
            return _scan_regions_dense(
                source.dev, jnp.asarray(starts_pad), self.s_dev,
                k=self.k, ws=self.ws, r=self.r, rspan=rspan,
                n_regions=n_regions,
            )
        rows = self._region_rows(source, starts_pad, rspan)
        return _scan_region_rows_dense(
            jnp.asarray(rows), self.s_dev,
            k=self.k, ws=self.ws, r=self.r, rspan=rspan,
            n_regions=n_regions,
        )

    def _dispatch_regions_summarized(self, source, starts_pad, rspan, n_regions, meta):
        """Dispatch the summarized region recompute (reduced assembly);
        returns (d handle, words handle) - only words is ever fetched."""
        if isinstance(source, PreparedCodes):
            return _scan_regions_summarized(
                source.dev, jnp.asarray(starts_pad), self.s_dev, meta,
                k=self.k, ws=self.ws, r=self.r, rspan=rspan,
                n_regions=n_regions,
            )
        rows = self._region_rows(source, starts_pad, rspan)
        return _scan_region_rows_summarized(
            jnp.asarray(rows), jnp.asarray(starts_pad), self.s_dev, meta,
            k=self.k, ws=self.ws, r=self.r, rspan=rspan,
            n_regions=n_regions,
        )

    def _stream_from_full(self, d: np.ndarray, offset: int, prev_below: bool, thr_int: int, stream: list) -> None:
        below = d < thr_int
        mask = below.copy()
        mask[1:] |= below[:-1]
        mask[0] |= prev_below
        for j in np.nonzero(mask)[0]:
            gj = offset + int(j)
            if gj >= 1:
                stream.append((gj, float(d[j]) / self.scale))


def scan_window_distances_np(codes: np.ndarray, s_profile: np.ndarray, k: int, ws: int, r: int) -> np.ndarray:
    """Brute-force NumPy oracle: direct per-window spectra (test/validation only)."""
    from .kmers import rolling_kmer_codes

    n = codes.shape[0]
    kcodes = rolling_kmer_codes(codes, k)
    w = ws - k + 1
    nw = n - ws + 1
    s64 = s_profile.astype(np.int64)
    out = np.empty(nw, dtype=np.int64)
    counts = np.bincount(kcodes[:w], minlength=s_profile.shape[0]).astype(np.int64)
    for p in range(nw):
        if p > 0:
            counts[kcodes[p - 1]] -= 1
            counts[kcodes[p - 1 + w]] += 1
        diff = r * counts - s64
        out[p] = np.dot(diff, diff)
    return out
