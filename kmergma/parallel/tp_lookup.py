"""Profile-axis tensor parallelism: the 4^k spectrum table sharded over
devices, and the TP scan engine built on it.

SURVEY.md section 2.2 marks TP optional - at the reference's k=6 the 4^k
table is 16 KB and replication is free.  For large k (k >= 10 means >= 1M
bins, >= 4 MB int32 per profile) this module
shards the PROFILE axis instead: each device holds a contiguous bin range
of S, computes the masked partial lookup g_part[i] = S_local[K[i] - lo]
for its range, and one ``psum`` over the ``data`` axis reassembles
g = S[K].  The scan's only profile-indexed quantities (g and ||S||^2) both
reduce over bins, so this primitive is the complete TP story for the
distance pass - ``TPScanEngine`` runs the full production pipeline (pruned
bitmap pass + batched exact region recompute + host replay) with the table
sharded, bit-identical to the exact int64 host engine
(tests/test_parallel.py k=10 golden).

Note the int32-headroom guard usually binds before table size does (huge
reference sets overflow scaled integers first and route to the exact int64
host engine, ops/scan_host.py); this engine covers the middle ground -
big k, moderate R (ref GenomeMiner.jl:26 converts to an SVector{4^k},
i.e. the reference simply holds the whole table in RAM per thread).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.scan import (
    PreparedCodes,
    ScanEngine,
    _depth_loop,
    _pair_ab,
    _span_bucket,
    _with_retry,
    rolling_kmer_codes_jnp,
)


@partial(jax.jit, static_argnames=("mesh",))
def tp_profile_lookup(kcodes, s_profile, *, mesh: Mesh):
    """g[i] = S[K[i]] with S sharded over the mesh's ``data`` axis.

    ``kcodes`` is replicated (int32[n]); ``s_profile`` int32[4^k] is sharded
    on axis 0.  Returns the replicated int32[n] lookup.
    """
    n_dev = mesh.shape["data"]
    nbins = s_profile.shape[0]
    local = nbins // n_dev

    def per_shard(kc, s_local):
        lo = jax.lax.axis_index("data").astype(jnp.int32) * jnp.int32(local)
        idx = kc - lo
        in_range = (idx >= 0) & (idx < local)
        part = jnp.where(in_range, jnp.take(s_local, jnp.clip(idx, 0, local - 1)), 0)
        return jax.lax.psum(part, "data")

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=P(),
        check_vma=False,  # psum output is value-replicated
    )(kcodes, s_profile)


def shard_profile(s_profile: np.ndarray, mesh: Mesh):
    """Place an int32 profile sharded over the mesh's ``data`` axis
    (pads the bin count up to a multiple of the axis size)."""
    n_dev = mesh.shape["data"]
    nbins = s_profile.shape[0]
    pad = -(-nbins // n_dev) * n_dev - nbins
    s = np.concatenate([s_profile.astype(np.int32), np.zeros(pad, np.int32)])
    return jax.device_put(s, NamedSharding(mesh, P("data")))


def _tp_g(kc, s_local, local_bins: int):
    """In-shard partial lookup + psum reassembly (the per_shard body of
    tp_profile_lookup, reused inside larger shard_map pipelines)."""
    lo = jax.lax.axis_index("data").astype(jnp.int32) * jnp.int32(local_bins)
    idx = kc - lo
    in_range = (idx >= 0) & (idx < local_bins)
    part = jnp.where(in_range, jnp.take(s_local, jnp.clip(idx, 0, local_bins - 1)), 0)
    return jax.lax.psum(part, "data")


def _tp_span_bounds(kc, g, s2, *, k, ws, r, span, depth):
    """Certified lower bounds of one span from (replicated) K codes and the
    psum-reassembled lookup - same integer pipeline as
    ops.scan.scan_window_lower_bounds, with the two table reductions (g and
    ||S||^2) already distributed.  depth = w - 1 makes it the EXACT
    distances (every in-window pair counted)."""
    w = ws - k + 1
    nt = span - 1
    k0 = kc[:w]
    idx = jnp.arange(w, dtype=jnp.int32)

    def pbody(d, acc):
        return acc + jnp.sum(((jnp.roll(k0, -d) == k0) & (idx < w - d)).astype(jnp.int32))

    p0 = _depth_loop(depth, pbody, jnp.int32(0))
    l0 = jnp.int32(r * r) * (jnp.int32(w) + 2 * p0) - jnp.int32(2 * r) * jnp.sum(g[:w]) + s2
    ab = _pair_ab(kc, w, nt, depth)
    delta = jnp.int32(2 * r * r) * ab + (2 * r) * (g[:nt] - g[w : w + nt])
    return jnp.concatenate([l0[None], l0 + jnp.cumsum(delta)])


@partial(jax.jit, static_argnames=("k", "ws", "r", "span", "block", "n_spans", "depth", "mesh"))
def _tp_record_bitmaps(codes_dev, n_valid, s_sharded, thr_int, *, k, ws, r, span, block, n_spans, depth, mesh):
    """Activity bitmaps of a whole record with the profile table SHARDED
    over the mesh's ``data`` axis (codes replicated; one psum per span
    reassembles the lookup).  Same contract as ops.scan._scan_record_bitmaps."""
    n_dev = mesh.shape["data"]
    local = s_sharded.shape[0] // n_dev

    def per_shard(codes, nv, s_local, thr):
        s2 = jax.lax.psum(jnp.sum(s_local * s_local), "data")

        def step(_, i):
            start = i * span
            c = jax.lax.dynamic_slice(codes, (start,), (span + ws - 1,))
            kc = rolling_kmer_codes_jnp(c, k)
            g = _tp_g(kc, s_local, local)
            bounds = _tp_span_bounds(kc, g, s2, k=k, ws=ws, r=r, span=span, depth=depth)
            below = (bounds < thr[0]) & (start + jnp.arange(span) < nv[0])
            return _, below.reshape(span // block, block).any(axis=1)

        _, bm = jax.lax.scan(step, 0, jnp.arange(n_spans))
        return bm

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), P(), P("data"), P()),
        out_specs=P(),
        check_vma=False,  # psum makes outputs value-replicated
    )(codes_dev, n_valid, s_sharded, thr_int)


@partial(jax.jit, static_argnames=("k", "ws", "r", "rspan", "n_regions", "mesh"))
def _tp_regions_dense(codes_dev, starts, s_sharded, *, k, ws, r, rspan, n_regions, mesh):
    """Batched exact region recompute with the table sharded (the TP variant
    of ops.scan._scan_regions_dense): depth = w - 1 makes the bound pipeline
    exact, and all table terms ride the psum-reassembled lookup."""
    n_dev = mesh.shape["data"]
    local = s_sharded.shape[0] // n_dev
    w = ws - k + 1

    def per_shard(codes, st, s_local):
        s2 = jax.lax.psum(jnp.sum(s_local * s_local), "data")

        def one(start):
            c = jax.lax.dynamic_slice(codes, (start,), (rspan + ws - 1,))
            kc = rolling_kmer_codes_jnp(c, k)
            g = _tp_g(kc, s_local, local)
            return _tp_span_bounds(kc, g, s2, k=k, ws=ws, r=r, span=rspan, depth=w - 1)

        return jax.lax.map(one, st)

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), P(), P("data")),
        out_specs=P(),
        check_vma=False,
    )(codes_dev, starts, s_sharded)


@jax.jit
def _summarize_rows(d, starts, meta):
    from ..ops.scan import _below_words_and_count

    return _below_words_and_count(d, starts, meta)


class TPScanEngine(ScanEngine):
    """ScanEngine with the 4^k profile axis sharded over the device mesh.

    The production path for k large enough that the table should not be
    replicated: the pruned bitmap pass and the
    exact region recompute run under shard_map with each device holding
    1/N of the table; everything downstream (region planning, stream
    assembly, minima replay) is the shared ScanEngine machinery -
    bit-identical streams to the exact int64 host engine
    (tests/test_parallel.py::test_tp_engine_matches_host_k10).
    """

    prefetch_h2d = False

    def __init__(self, s_profile: np.ndarray, k: int, ws: int, r: int, mesh: Mesh | None = None, chunk_windows: int | None = None, bound_depth: int | None = 16):
        from .mesh import make_mesh

        super().__init__(
            s_profile, k=k, ws=ws, r=r, chunk_windows=chunk_windows,
            bound_depth=bound_depth,
        )
        self.mesh = mesh if mesh is not None else make_mesh()
        self.s_sharded = shard_profile(s_profile, self.mesh)

    def record_stream(self, codes: np.ndarray, thr: float, collect_dists: bool = False, codes_dev=None, seg_tracker=None):
        # seg_tracker (mid-record segment resume) applies to the
        # single-device segmented pipeline only; this engine has no
        # segmented path, so checkpointing stays per-record here

        codes = np.asarray(codes, dtype=np.int8)
        n = codes.shape[0]
        nw = n - self.ws + 1
        assert nw >= 1
        if collect_dists:
            # debug path: exact distances (= depth w-1 bounds), chunked on
            # chunk-aligned starts so slices never clamp
            prep = codes_dev if codes_dev is not None else self.prepare_codes(codes)
            full = np.empty(nw, dtype=np.float64)
            thr_int = self._thr_int(thr)
            stream: list[tuple[int, float]] = []
            host_prev_below = False
            start = 0
            while start < nw:
                t = min(self.chunk, nw - start)
                d = np.asarray(
                    _tp_regions_dense(
                        prep.dev, jnp.asarray(np.asarray([start], dtype=np.int32)),
                        self.s_sharded, k=self.k, ws=self.ws, r=self.r,
                        rspan=self.chunk, n_regions=1, mesh=self.mesh,
                    )
                )[0, :t]
                full[start : start + t] = d / self.scale
                self._stream_from_full(d, start, host_prev_below, thr_int, stream)
                host_prev_below = bool(d[t - 1] < thr_int)
                start += t
            return float(full[0]), stream, full
        prep = codes_dev if codes_dev is not None else self.prepare_codes(codes)
        thr_int = self._thr_int(thr)
        depth = self.bound_depth if self.bound_depth is not None else self.ws - self.k
        if self._thr_cache is None or self._thr_cache[0] != float(thr_int):
            self._thr_cache = (float(thr_int), jnp.asarray(np.asarray([thr_int], dtype=np.int32)))
        bitmaps = _with_retry(
            lambda: np.asarray(
                _tp_record_bitmaps(
                    prep.dev, self._nv(nw), self.s_sharded, self._thr_cache[1],
                    k=self.k, ws=self.ws, r=self.r, span=self.chunk,
                    block=self.block, n_spans=prep.n_spans, depth=depth,
                    mesh=self.mesh,
                )
            )
        ).reshape(-1)
        dist0, stream = self._assemble_stream(prep, nw, thr, bitmaps)
        return dist0, stream, None

    def _dispatch_regions_dense(self, source, starts_pad, nw, rspan, n_regions):
        if not isinstance(source, PreparedCodes):
            raise TypeError("TPScanEngine assembles from prepared device codes")
        return _tp_regions_dense(
            source.dev, jnp.asarray(starts_pad), self.s_sharded,
            k=self.k, ws=self.ws, r=self.r, rspan=rspan,
            n_regions=n_regions, mesh=self.mesh,
        )

    def _dispatch_regions_summarized(self, source, starts_pad, rspan, n_regions, meta):
        """Reduced-assembly variant: the TP region recompute keeps its
        distances on device; the summary rides the shared below-words jit."""
        if not isinstance(source, PreparedCodes):
            raise TypeError("TPScanEngine assembles from prepared device codes")
        starts_dev = jnp.asarray(starts_pad)
        d = _tp_regions_dense(
            source.dev, starts_dev, self.s_sharded,
            k=self.k, ws=self.ws, r=self.r, rspan=rspan,
            n_regions=n_regions, mesh=self.mesh,
        )
        return d, _summarize_rows(d, starts_dev, meta)
