"""One-pass multi-profile (cluster) scan engine.

The reference's cluster mode is m x the cost of the single scan (one rolling
update per cluster per bp, ref KmerGMA.jl/src/OmnGenomeMiner.jl:89-158,
README.md:50 "40/m Mbp/s").  This engine beats that m x by sharing everything
profile-independent across clusters in ONE device pass per record:

  * K codes are computed once per span (not once per cluster),
  * the pair-match delta ``ab`` and the first-window pair count ``p0`` -
    the O(depth)/bp hot loops - depend only on (windowsize, depth), so
    clusters are grouped by windowsize and each group runs the pair loop
    ONCE (cluster windowsizes cluster tightly: e.g. the reference
    test set yields [288,288,288,289,290,289] -> 3 groups for 6 clusters),
  * only the cheap per-cluster tail (profile lookup g = S_m[K], scaled
    delta assembly, cumsum, threshold bitmap) runs per cluster, fused by
    XLA into the same elementwise pipeline.

Asymptotically the pass costs O(G*depth + m)/bp instead of m*O(depth)/bp,
where G = #distinct windowsizes <= m.  The per-cluster candidate streams are
then assembled through each cluster's ScanEngine region machinery (exact
recompute of rare active regions) and replayed by the sequential Omn state
machine - bit-exact with the serial per-cluster path by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .scan import (
    ScanEngine,
    _depth_loop,
    _pair_ab,
    _with_retry,
    rolling_kmer_codes_jnp,
)


def _shared_p0(kcodes: jnp.ndarray, w: int, depth: int) -> jnp.ndarray:
    """First-window equal-k-mer pair count at partner distance <= depth -
    the profile-independent part of ops.scan._lower_bound_base."""
    k0 = kcodes[:w]
    idx = jnp.arange(w, dtype=jnp.int32)

    def body(d, acc):
        return acc + jnp.sum(
            ((jnp.roll(k0, -d) == k0) & (idx < w - d)).astype(jnp.int32)
        )

    return _depth_loop(depth, body, jnp.int32(0))


def _span_bitmaps(codes_span, pos, s_stack, thr_ints, n_valids, s2, *, k, block, groups):
    """Activity bitmaps of one span for ALL clusters: (m, span // block).

    ``codes_span`` holds span + max_ws - 1 codes; ``pos`` the span's global
    window indices (for validity masking); groups/s_stack/thr_ints as in
    _cluster_record_bitmaps.  K codes are built once, the pair-count hot
    loop (ab, p0) runs once per windowsize group, ALL m profile lookups
    are one batched table gather, and the per-cluster delta/cumsum/bitmap
    tails are batched per group.  Shared by the single-device and sharded
    passes.
    """
    span = pos.shape[0]
    m = s_stack.shape[0]
    nt = span - 1
    max_w = max(g[0] for g in groups) - k + 1
    kcodes_all = rolling_kmer_codes_jnp(codes_span, k)
    kc_max = jax.lax.slice(kcodes_all, (0,), (span + max_w - 1,))
    g_all = jax.vmap(lambda s: jnp.take(s, kc_max))(s_stack)  # (m, span + max_w - 1)
    bitmaps: list = [None] * m
    for ws, depth, idxs, rs in groups:
        w = ws - k + 1
        kc = jax.lax.slice(kcodes_all, (0,), (span + w - 1,))
        ab = _pair_ab(kc, w, nt, depth)
        p0 = _shared_p0(kc, w, depth)
        sel = np.asarray(idxs)
        g_g = g_all[sel]  # (mg, ...) static row gather
        r_vec = jnp.asarray(np.asarray(rs, dtype=np.int32))[:, None]  # (mg, 1)
        l0 = (
            r_vec[:, 0] * r_vec[:, 0] * (jnp.int32(w) + 2 * p0)
            - 2 * r_vec[:, 0] * jnp.sum(g_g[:, :w], axis=1)
            + s2[sel]
        )
        delta = (2 * r_vec * r_vec) * ab[None, :] + (2 * r_vec) * (
            g_g[:, :nt] - g_g[:, w : w + nt]
        )
        bounds = jnp.concatenate(
            [l0[:, None], l0[:, None] + jnp.cumsum(delta, axis=1)], axis=1
        )
        below = (bounds < thr_ints[sel][:, None]) & (pos[None, :] < n_valids[sel][:, None])
        bm_g = below.reshape(len(idxs), span // block, block).any(axis=2)
        for j, ci in enumerate(idxs):
            bitmaps[ci] = bm_g[j]
    return jnp.stack(bitmaps)


@partial(jax.jit, static_argnames=("k", "span", "block", "n_spans", "groups"))
def _cluster_record_bitmaps(codes_dev, n_valids, s_stack, thr_ints, *, k, span, block, n_spans, groups):
    """Activity bitmaps for ALL clusters in one device pass.

    groups: static tuple of (ws, depth, cluster_index_tuple, r_tuple) with
    clusters grouped by windowsize; ``s_stack`` is the (m, 4^k) stack of
    integer summed profiles, ``thr_ints``/``n_valids`` the per-cluster
    scaled thresholds and window counts.

    Returns bool[n_spans, m, span // block].
    """
    max_ws = max(g[0] for g in groups)
    s2 = jnp.sum(s_stack * s_stack, axis=1)  # (m,) ||S_m||^2

    def step(_, i):
        start = i * span
        codes = jax.lax.dynamic_slice(codes_dev, (start,), (span + max_ws - 1,))
        pos = start + jnp.arange(span, dtype=jnp.int32)
        return _, _span_bitmaps(
            codes, pos, s_stack, thr_ints, n_valids, s2,
            k=k, block=block, groups=groups,
        )

    _, out = jax.lax.scan(step, 0, jnp.arange(n_spans))
    return out  # (n_spans, m, span // block)


class ClusterScanEngine:
    """Host-side driver of the one-pass multi-profile scan.

    Wraps one ScanEngine per cluster (for the exact region recompute and
    stream assembly) but replaces their m serial bitmap passes with the
    single shared pass above.  One H2D transfer per record, shared by all
    clusters (padded for the largest windowsize).
    """

    def __init__(
        self,
        profiles: list,
        k: int,
        chunk_windows: int | None = None,
        bound_depth: int | None = 16,
    ):
        self.k = k
        self.engines = [
            ScanEngine(
                p.sum_kfv,
                k=k,
                ws=p.windowsize,
                r=p.n_records,
                chunk_windows=chunk_windows,
                bound_depth=bound_depth,
            )
            for p in profiles
        ]
        e0 = self.engines[0]
        self.chunk, self.block = e0.chunk, e0.block
        self.max_ws = max(e.ws for e in self.engines)
        # group clusters by (ws, clamped depth); exact mode (depth None)
        # uses depth = w - 1 where the lower bound equals the distance
        by_key: dict[tuple[int, int], list[int]] = {}
        for ci, e in enumerate(self.engines):
            depth = e.bound_depth if e.bound_depth is not None else e.ws - k
            by_key.setdefault((e.ws, depth), []).append(ci)
        self.groups = tuple(
            (ws, depth, tuple(cis), tuple(self.engines[ci].r for ci in cis))
            for (ws, depth), cis in sorted(by_key.items())
        )
        self.s_stack = jnp.stack([e.s_dev for e in self.engines])
        self._small_cache: dict = {}

    def prepare_codes(self, codes: np.ndarray):
        return self.engines[0].prepare_codes(codes, max_ws=self.max_ws)

    def record_streams(
        self, codes: np.ndarray, thrs: list[float], codes_dev=None, seg_tracker=None
    ) -> list[tuple[float, list[tuple[int, float]]]]:
        """Scan one record against every cluster profile in one device pass.

        Returns one (dist0, stream) per cluster - the exact contract of
        ScanEngine.record_stream, consumed by state_machine.replay_omn.
        ``seg_tracker`` (mid-record segment resume) applies to the SHARDED
        cluster engine only; this one-dispatch engine checkpoints per
        record.
        """
        if len(thrs) != len(self.engines):
            raise ValueError(f"{len(self.engines)} clusters but {len(thrs)} thresholds")
        n = codes.shape[0]
        prep = codes_dev if codes_dev is not None else self.prepare_codes(codes)
        n_valids = np.array([n - e.ws + 1 for e in self.engines], dtype=np.int32)
        if (n_valids < 1).any():
            raise ValueError("record shorter than a cluster windowsize")
        thr_ints = np.array(
            [e._thr_int(t) for e, t in zip(self.engines, thrs)], dtype=np.int32
        )
        # cache the two small per-record device arrays (most genomes repeat
        # a few record lengths)
        key = (tuple(n_valids.tolist()), tuple(thr_ints.tolist()))
        devs = self._small_cache.get(key)
        if devs is None:
            if len(self._small_cache) > 64:
                self._small_cache.clear()
            devs = (jnp.asarray(n_valids), jnp.asarray(thr_ints))
            self._small_cache[key] = devs
        bitmaps = _with_retry(
            lambda: np.asarray(
                _cluster_record_bitmaps(
                    prep.dev, devs[0], self.s_stack, devs[1],
                    k=self.k, span=self.chunk, block=self.block,
                    n_spans=prep.n_spans, groups=self.groups,
                )
            )
        )  # (n_spans, m, blocks)
        by_cluster = [bitmaps[:, ci, :].reshape(-1) for ci in range(len(self.engines))]
        return self._streams_from_bitmaps(prep, by_cluster, n_valids, thr_ints, thrs, seq_len=n)

    def _streams_from_bitmaps(self, prep, by_cluster, n_valids, thr_ints, thrs, seq_len=None):
        """COMBINED region recompute for all m clusters: one device call and
        one fetch instead of m.

        In "reduced" assembly mode (the default) the fetch is the packed
        below bits + per-run reductions for ALL clusters - KBs instead of
        the multi-MB distance rows.
        ``seq_len`` bounds every stream at the Omn loop's i <= imax
        (ref OmnGenomeMiner.jl:89) so run minima never see windows the
        reference would not scan.
        """
        from .scan import (
            _RUN_BUCKET,
            _extract_runs,
            _run_pieces,
            _scan_regions_dense_multi,
            _scan_regions_summarized_multi,
            _span_bucket,
            _unpack_bitmap_words,
        )

        e0 = self.engines[0]
        m = len(self.engines)
        rspan = min(e0.chunk, e0.rspan)
        all_starts: list[list[int]] = []
        for ci, eng in enumerate(self.engines):
            starts, _ = eng._plan_starts(np.asarray(by_cluster[ci]), int(n_valids[ci]))
            all_starts.append(starts)
        n_regions = _span_bucket(max(len(s) for s in all_starts))
        starts_flat = np.zeros(m * n_regions, dtype=np.int32)
        for ci, starts in enumerate(all_starts):
            starts_flat[ci * n_regions : ci * n_regions + len(starts)] = starts
        specs = tuple((eng.ws, eng.r) for eng in self.engines)

        if e0.assemble_mode != "reduced":
            d_flat = _with_retry(
                lambda: np.asarray(
                    _scan_regions_dense_multi(
                        prep.dev, jnp.asarray(starts_flat), self.s_stack,
                        k=self.k, rspan=rspan, n_regions=n_regions,
                        specs=specs,
                    )
                )
            )
            return self._streams_full_fetch(
                d_flat, all_starts, rspan, n_regions, n_valids, thr_ints
            )

        t_exact = np.asarray(
            [eng._thr_exact(thr) for eng, thr in zip(self.engines, thrs)], dtype=np.int32
        )
        key = ("rmeta", tuple(t_exact.tolist()), tuple(n_valids.tolist()))
        meta = self._small_cache.get(key)
        if meta is None:
            if len(self._small_cache) > 64:
                self._small_cache.clear()
            # exact integer thresholds on BOTH borderline bounds: device
            # below bits equal the host float64 comparison exactly (see
            # ScanEngine._thr_exact), so the full-fetch fallback never fires
            meta = jnp.asarray(np.concatenate([t_exact, t_exact, n_valids]).astype(np.int32))
            self._small_cache[key] = meta

        d_flat_h, words_h = _with_retry(
            lambda: _scan_regions_summarized_multi(
                prep.dev, jnp.asarray(starts_flat), self.s_stack, meta,
                k=self.k, rspan=rspan, n_regions=n_regions, specs=specs,
            )
        )
        flat_total = m * n_regions * rspan
        if flat_total <= e0.full_fetch_windows or flat_total >= 2**31:
            # few active regions across all clusters: one raw fetch beats
            # the words+reduce round-trip pair (sparse real genomes).
            # The >= 2^31 guard keeps the reduced path's packed int32
            # flat indices (base = ci*n_regions*rspan) from wrapping on a
            # pathologically large dense multi-cluster record
            d_flat = _with_retry(lambda: np.asarray(d_flat_h))
            return self._streams_full_fetch(
                d_flat, all_starts, rspan, n_regions, n_valids, thr_ints
            )
        words = _with_retry(lambda: np.asarray(words_h))
        return self._streams_from_summary(
            d_flat_h, words, all_starts, rspan, n_regions, n_valids, thr_ints, seq_len
        )

    def _streams_from_summary(self, d_flat_h, words, all_starts, rspan, n_regions, n_valids, thr_ints, seq_len):
        """Assemble all m streams from a FETCHED summary (below words +
        borderline counts + dist0s) and the device-resident distance rows.
        """
        from .scan import (
            _RUN_BUCKET,
            _extract_runs,
            _run_pieces,
            _unpack_bitmap_words,
        )

        e0 = self.engines[0]
        m = len(self.engines)
        if int(words[-2 * m : -m].sum()) > 0:
            # borderline integer distances somewhere: exact full fetch
            d_flat = _with_retry(lambda: np.asarray(d_flat_h))
            return self._streams_full_fetch(
                d_flat, all_starts, rspan, n_regions, n_valids, thr_ints
            )
        dist0s = [
            float(np.int64(words[-m + ci])) / eng.scale
            for ci, eng in enumerate(self.engines)
        ]

        imax = None if seq_len is None else seq_len - self.max_ws - self.k + 2
        # each cluster's packed below-bit words are exactly this long ONLY
        # because chunk is forced to a multiple of block=512 by the engine;
        # make that cross-module coupling explicit
        assert n_regions * rspan % 32 == 0, (n_regions, rspan)
        words_per = n_regions * rspan // 32
        requests = []
        infos = []
        for ci, (eng, starts) in enumerate(zip(self.engines, all_starts)):
            bits = _unpack_bitmap_words(
                words[ci * words_per : (ci + 1) * words_per], n_regions * rspan
            )
            mi = int(n_valids[ci]) - 1
            if imax is not None:
                mi = min(mi, imax)
            run_lo, run_hi, edge_flat = _extract_runs(bits, starts, rspan, mi)
            run_ids, p_start, p_len = _run_pieces(run_lo, run_hi, _RUN_BUCKET)
            base = ci * n_regions * rspan
            edge_ok = edge_flat >= 0
            edge_list = edge_flat[edge_ok].astype(np.int64) + base
            requests.append((p_start + base, p_len, edge_list))
            infos.append((eng, starts, run_lo, run_hi, edge_flat, edge_ok, run_ids, p_start))
        if sum(len(r[0]) + len(r[2]) for r in requests) == 0:
            return [(d0, []) for d0 in dist0s]  # no runs anywhere: done
        outs = e0._reduce_on_device(d_flat_h, requests)
        return [
            eng._finish_reduction(
                out, starts, rspan, run_lo, run_hi, edge_flat, edge_ok, run_ids,
                p_start, dist0s[ci],
            )
            for ci, (out, (eng, starts, run_lo, run_hi, edge_flat, edge_ok, run_ids, p_start))
            in enumerate(zip(outs, infos))
        ]

    def _streams_full_fetch(self, d_flat, all_starts, rspan, n_regions, n_valids, thr_ints):
        out = []
        for ci, (eng, starts) in enumerate(zip(self.engines, all_starts)):
            d_all = d_flat[ci * n_regions * rspan : (ci + 1) * n_regions * rspan].reshape(
                n_regions, rspan
            )
            out.append(
                eng._stream_from_region_dists(
                    d_all, starts, rspan, int(n_valids[ci]), int(thr_ints[ci])
                )
            )
        return out
