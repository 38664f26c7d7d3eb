"""Data-parallel sharded scan: SPMD over a device mesh via shard_map.

The replacement for the reference's (disabled) per-record thread
fan-out (ref KmerGMA.jl/src/MultiThread/GenomeMiner.jl:101-145) and the
distribution layer the reference lacks (SURVEY.md sections 2.2, 5.8).

PRODUCTION parity with the single-device ScanEngine: the sharded bitmap pass
uses the same certified lower-bound pruning (depth-limited pair counts) and
packed 4-bases/byte H2D - each device receives ONE
quarter-packed transfer of its contiguous genome region (its spans plus a
ws-1 halo), unpacks on device, and runs the pruned span scan locally:

  * the genome's window axis is cut into fixed spans; device d owns spans
    [d*spd, (d+1)*spd) - the sequence/context-parallel axis (overlapped
    tiling: each span's first-window spectrum is recomputed in-span);
  * the reference profile stack is replicated; per-device activity bitmaps
    are combined with ``all_gather`` over the ``data`` axis;
  * the rare active regions are recomputed exactly through the shared
    ScanEngine region machinery (explicit region rows - no device holds the
    whole record), and the host replays the sequential minima state machine
    over the merged sparse stream - bit-exact with the single-device path.

Cluster mode reuses the same pass with the m-profile group structure of
ops/scan_cluster (K codes + pair counts shared across clusters per span), so
multi-device cluster scans cost O(G*depth)/bp/device, not m*O(W)/bp.

``sharded_cluster_scan_step`` additionally demonstrates the two-axis
("clusters" x "data") expert-style sharding of profiles for runs where m
is large enough to shard.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.scan import (
    ScanEngine,
    _span_bucket,
    _unpack_bitmap_words,
    _unpack_codes,
    _with_retry,
    scan_window_distances,
)
from ..ops.scan_cluster import ClusterScanEngine, _span_bitmaps


def _pack_region_rows(codes: np.ndarray, n_dev: int, spd: int, span: int, max_ws: int) -> np.ndarray:
    """Quarter-pack each device's contiguous region (spd spans + halo).

    Returns uint8[n_dev, region_len // 4]; device d's row covers codes
    [d*spd*span, d*spd*span + region_len), zero-padded past the record end.
    """
    from ..utils.native import pack_quarters_native

    region_len = -(-(spd * span + max_ws - 1) // 4) * 4
    rows = np.empty((n_dev, region_len // 4), dtype=np.uint8)
    for d in range(n_dev):
        lo = d * spd * span
        seg = codes[lo : lo + region_len]
        packed = pack_quarters_native(seg, region_len)
        if packed is None:  # pure-numpy fallback (no g++ toolchain)
            padded = np.zeros(region_len, dtype=np.uint8)
            padded[: seg.shape[0]] = seg.view(np.uint8)
            q = padded.reshape(4, region_len // 4)
            packed = (q[0] | (q[1] << 2) | (q[2] << 4) | (q[3] << 6)).astype(np.uint8)
        rows[d] = packed
    return rows


@partial(jax.jit, static_argnames=("k", "span", "spd", "block", "groups", "mesh"))
def _sharded_record_bitmaps(packed_rows, n_valids, s_stack, thr_ints, *, k, span, spd, block, groups, mesh):
    """Activity bitmaps for all clusters, sharded over the mesh's ``data``
    axis.  Each device unpacks its packed region once, scans its spd local
    spans with the pruned (lower-bound) pass, and the per-device bitmaps are
    merged with one all_gather.  Returns bool[n_dev*spd, m, span // block].
    """
    max_ws = max(g[0] for g in groups)

    def per_shard(packed_local, n_v, s_st, thr_i):
        codes = _unpack_codes(packed_local[0])
        base = jax.lax.axis_index("data").astype(jnp.int32) * jnp.int32(spd * span)
        s2 = jnp.sum(s_st * s_st, axis=1)

        def step(_, i):
            start = i * span
            c = jax.lax.dynamic_slice(codes, (start,), (span + max_ws - 1,))
            pos = base + start + jnp.arange(span, dtype=jnp.int32)
            return _, _span_bitmaps(
                c, pos, s_st, thr_i, n_v, s2,
                k=k, block=block, groups=groups,
            )

        _, bm = jax.lax.scan(step, 0, jnp.arange(spd))  # (spd, m, blocks)
        return jax.lax.all_gather(bm, "data", axis=0, tiled=True)

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P("data", None), P(), P(), P()),
        out_specs=P(),
        check_vma=False,  # outputs are value-replicated after all_gather
    )(packed_rows, n_valids, s_stack, thr_ints)


class ShardedScanEngine(ScanEngine):
    """ScanEngine whose bitmap pass runs SPMD over a device mesh.

    Drop-in: produces the identical (dist0, stream) contract consumed by
    the host state-machine replay, bit-exact with the single-device engine
    (asserted by tests/test_parallel.py and __graft_entry__.dryrun_multichip
    against the golden hit sets).
    """

    prefetch_h2d = False  # transfers are per-shard inside record_stream

    def __init__(
        self,
        s_profile: np.ndarray,
        k: int,
        ws: int,
        r: int,
        mesh: Mesh | None = None,
        chunk_windows: int | None = None,
        bound_depth: int | None = 16,
    ):
        from .mesh import make_mesh

        super().__init__(
            s_profile, k=k, ws=ws, r=r, chunk_windows=chunk_windows,
            bound_depth=bound_depth,
        )
        self.mesh = mesh if mesh is not None else make_mesh()

    @property
    def _groups(self):
        depth = self.bound_depth if self.bound_depth is not None else self.ws - self.k
        return ((self.ws, depth, (0,), (self.r,)),)

    # spans per device per segment batch on the checkpointed mid-record
    # path: one batch = n_dev * _seg_spd * chunk windows, one SPMD dispatch
    _seg_spd = 4

    def record_stream(self, codes: np.ndarray, thr: float, collect_dists: bool = False, codes_dev=None, seg_tracker=None):
        if collect_dists:  # debug path stays single-device
            return super().record_stream(codes, thr, collect_dists=True, codes_dev=codes_dev)
        codes = np.asarray(codes, dtype=np.int8)
        n = codes.shape[0]
        nw = n - self.ws + 1
        assert nw >= 1
        n_dev = self.mesh.shape["data"]
        n_spans = -(-nw // self.chunk)
        spd = _span_bucket(max(1, -(-n_spans // n_dev)))
        thr_int = self._thr_int(thr)
        if self._thr_cache is None or self._thr_cache[0] != float(thr_int):
            self._thr_cache = (float(thr_int), jnp.asarray(np.asarray([thr_int], dtype=np.int32)))
        if seg_tracker is not None:
            flat = self._segmented_sharded_bitmaps(codes, nw, thr_int, seg_tracker)
            if flat is not None:
                dist0, stream = self._assemble_stream(codes, nw, thr, flat)
                return dist0, stream, None
        flat = _with_retry(lambda: self._sharded_pass(codes, nw, spd))
        dist0, stream = self._assemble_stream(codes, nw, thr, flat)
        return dist0, stream, None

    def _sharded_pass(self, codes: np.ndarray, nv: int, spd: int) -> np.ndarray:
        """ONE SPMD bitmap dispatch over the mesh: device d scans spans
        [d*spd, (d+1)*spd) of the window range starting at codes[0];
        ``nv`` = #valid windows in this pass.  Returns the flat bool
        per-block activity bitmap (n_dev * spd * chunk / block blocks)."""
        n_dev = self.mesh.shape["data"]
        rows = _pack_region_rows(codes, n_dev, spd, self.chunk, self.ws)
        rows_dev = jax.device_put(rows, NamedSharding(self.mesh, P("data", None)))
        bitmaps = np.asarray(
            _sharded_record_bitmaps(
                rows_dev,
                self._nv(nv),
                self.s_dev[None],
                self._thr_cache[1],
                k=self.k, span=self.chunk, spd=spd, block=self.block,
                groups=self._groups, mesh=self.mesh,
            )
        )
        return bitmaps[:, 0, :].reshape(-1).astype(bool)

    def _segmented_sharded_bitmaps(self, codes: np.ndarray, nw: int, thr_int, tracker):
        """Mid-record checkpointed sharded pass (SURVEY 5.4: "last completed
        tile index per shard").

        Splits the record's span axis into segment batches of
        n_dev * _seg_spd spans; each batch is one SPMD dispatch (every
        shard scans _seg_spd spans), and each completed batch's packed
        bitmap words are persisted through ``tracker`` (the same
        SegmentTracker format as the single-device segmented pipeline) -
        a killed scan of a multi-hundred-Mbp record resumes at the last
        batch every shard finished instead of from zero.  Returns None
        when the record fits a single batch (per-record checkpointing is
        already exact there).  Per-batch bitmaps are a conservative
        superset exactly like the unsegmented pass (each batch's carry
        is seeded locally, as each shard's already is), so the assembled
        stream is bit-identical (tests/test_fault_tolerance.py).
        """
        n_dev = self.mesh.shape["data"]
        n_spans = -(-nw // self.chunk)
        spd_full = _span_bucket(max(1, -(-n_spans // n_dev)))
        spd = self._seg_spd
        if spd_full <= spd:
            return None
        seg_windows = n_dev * spd * self.chunk
        n_segs = -(-nw // seg_windows)
        blocks_per_seg = seg_windows // self.block
        # every parameter that shapes the stored words or their offsets -
        # stale-parameter checkpoints are discarded, not misread
        fp = (
            f"sharded|{self.k}|{self.ws}|{self.r}|{self.chunk}|{self.block}|"
            f"{int(thr_int)}|{self.bound_depth}|{n_dev}|{spd}|{nw}"
        )
        start_seg, restored = tracker.resume(fp)
        out = [_unpack_bitmap_words(w, blocks_per_seg) for w in restored]
        pad = -(-blocks_per_seg // 32) * 32 - blocks_per_seg
        for si in range(start_seg, n_segs):
            off = si * seg_windows
            nv_seg = min(nw - off, seg_windows)
            flat = _with_retry(lambda: self._sharded_pass(codes[off:], nv_seg, spd))
            flat = flat[:blocks_per_seg]
            words = np.packbits(np.pad(flat, (0, pad)), bitorder="little").view(np.uint32)
            out.append(flat)
            tracker.done_segment(si, words, fp)
        return np.concatenate(out)


class ShardedClusterScanEngine(ClusterScanEngine):
    """ClusterScanEngine whose multi-profile bitmap pass runs SPMD
    over the mesh's ``data`` axis (profiles replicated; K codes and pair
    counts still shared across clusters per span)."""

    def __init__(
        self,
        profiles: list,
        k: int,
        mesh: Mesh | None = None,
        chunk_windows: int | None = None,
        bound_depth: int | None = 16,
    ):
        from .mesh import make_mesh

        super().__init__(profiles, k, chunk_windows=chunk_windows, bound_depth=bound_depth)
        self.mesh = mesh if mesh is not None else make_mesh()

    #: spans per device per segment batch on the checkpointed mid-record
    #: path (mirrors ShardedScanEngine._seg_spd)
    _seg_spd = 4

    def prepare_codes(self, codes: np.ndarray):
        return None  # regions are fetched from host codes; no shared device array

    def _cluster_pass(self, codes: np.ndarray, n_valids_pass: np.ndarray, thr_ints: np.ndarray, spd: int) -> np.ndarray:
        """One SPMD multi-cluster bitmap dispatch over the mesh: device d
        scans spans [d*spd, (d+1)*spd) of the window range starting at
        codes[0]; ``n_valids_pass`` = per-cluster valid windows in this
        pass.  Returns bool[m, n_dev*spd*chunk // block]."""
        n_dev = self.mesh.shape["data"]
        rows = _pack_region_rows(codes, n_dev, spd, self.chunk, self.max_ws)
        rows_dev = jax.device_put(rows, NamedSharding(self.mesh, P("data", None)))
        bitmaps = np.asarray(
            _sharded_record_bitmaps(
                rows_dev, jnp.asarray(n_valids_pass), self.s_stack, jnp.asarray(thr_ints),
                k=self.k, span=self.chunk, spd=spd, block=self.block,
                groups=self.groups, mesh=self.mesh,
            )
        )  # (n_dev*spd, m, span//block)
        return np.transpose(bitmaps, (1, 0, 2)).reshape(len(self.engines), -1).astype(bool)

    def _segmented_cluster_bitmaps(self, codes: np.ndarray, n_valids: np.ndarray, thr_ints: np.ndarray, tracker):
        """Mid-record checkpointed sharded CLUSTER pass (SURVEY 5.4 per-shard
        tile index, cluster variant): segment batches of n_dev * _seg_spd
        spans, each one SPMD dispatch whose m clusters' packed bitmap
        words persist through ``tracker``.  Returns None when the record
        fits one batch (per-record checkpointing is exact there)."""
        n_dev = self.mesh.shape["data"]
        m = len(self.engines)
        nw_max = int(n_valids.max())
        n_spans = -(-nw_max // self.chunk)
        spd_full = _span_bucket(max(1, -(-n_spans // n_dev)))
        spd = self._seg_spd
        if spd_full <= spd:
            return None
        seg_windows = n_dev * spd * self.chunk
        n_segs = -(-nw_max // seg_windows)
        blocks_per_seg = m * (seg_windows // self.block)
        fp = (
            f"shcluster|{self.k}|{tuple(e.ws for e in self.engines)}|"
            f"{tuple(e.r for e in self.engines)}|{self.chunk}|{self.block}|"
            f"{tuple(thr_ints.tolist())}|{self.groups[0][1]}|"
            f"{n_dev}|{spd}|{nw_max}"
        )
        from ..ops.scan import _unpack_bitmap_words

        start_seg, restored = tracker.resume(fp)
        out = [
            _unpack_bitmap_words(w, blocks_per_seg).reshape(m, -1) for w in restored
        ]
        pad = -(-blocks_per_seg // 32) * 32 - blocks_per_seg
        for si in range(start_seg, n_segs):
            off = si * seg_windows
            nv_seg = np.clip(n_valids.astype(np.int64) - off, 0, seg_windows).astype(np.int32)
            bc = _with_retry(
                lambda: self._cluster_pass(codes[off:], nv_seg, thr_ints, spd)
            )
            bc = bc[:, : seg_windows // self.block]
            words = np.packbits(
                np.pad(bc.reshape(-1), (0, pad)), bitorder="little"
            ).view(np.uint32)
            out.append(bc)
            tracker.done_segment(si, words, fp)
        return [
            np.concatenate([seg[ci] for seg in out]) for ci in range(m)
        ]

    def record_streams(self, codes: np.ndarray, thrs: list[float], codes_dev=None, seg_tracker=None):
        if len(thrs) != len(self.engines):
            raise ValueError(f"{len(self.engines)} clusters but {len(thrs)} thresholds")
        codes = np.asarray(codes, dtype=np.int8)
        n = codes.shape[0]
        n_valids = np.array([n - e.ws + 1 for e in self.engines], dtype=np.int32)
        if (n_valids < 1).any():
            raise ValueError("record shorter than a cluster windowsize")
        thr_ints = np.array(
            [e._thr_int(t) for e, t in zip(self.engines, thrs)], dtype=np.int32
        )
        by_cluster = None
        if seg_tracker is not None:
            by_cluster = self._segmented_cluster_bitmaps(
                codes, n_valids, thr_ints, seg_tracker
            )
        if by_cluster is None:
            n_dev = self.mesh.shape["data"]
            n_spans = -(-int(n_valids.max()) // self.chunk)
            spd = _span_bucket(max(1, -(-n_spans // n_dev)))
            bc = _with_retry(lambda: self._cluster_pass(codes, n_valids, thr_ints, spd))
            by_cluster = [bc[ci] for ci in range(len(self.engines))]
        # two-phase assembly: all clusters' region fetches in flight first;
        # streams bounded at the Omn loop's i <= imax (as the one-pass
        # cluster engine does - required for reduced-mode run minima)
        imax = n - self.max_ws - self.k + 2
        plans = [
            eng._assemble_plan(
                codes, int(n_valids[ci]), thr, by_cluster[ci], max_index=imax
            )
            for ci, (eng, thr) in enumerate(zip(self.engines, thrs))
        ]
        return [eng._assemble_finish(p) for eng, p in zip(self.engines, plans)]


# ---------------------------------------------------------------------------
# Two-axis expert-style step (profiles sharded over "clusters"), a
# demonstration used by dryrun_multichip and tests/test_parallel.py.
# ---------------------------------------------------------------------------


def _tile_kernel(codes_tile, s_profile, thr_int, k: int, ws: int, r: int, cap: int):
    """Candidates of one tile: (d_first, count, idx, vals, below_edges)."""
    d = scan_window_distances(codes_tile, s_profile, k, ws, r)
    below = d < thr_int
    prevb = jnp.concatenate([jnp.zeros(1, dtype=bool), below[:-1]])
    mask = below | prevb
    t = d.shape[0]
    score = jnp.where(mask, t - jnp.arange(t, dtype=jnp.int32), 0)
    top, _ = jax.lax.top_k(score, min(cap, t))
    if cap > t:
        top = jnp.pad(top, (0, cap - t))
    idx = jnp.where(top > 0, t - top, 0)
    vals = d[idx]
    count = mask.sum()
    return d[0], count, idx.astype(jnp.int32), vals, below[0], below[-1]


@partial(jax.jit, static_argnames=("k", "ws", "r", "cap", "mesh"))
def sharded_cluster_scan_step(codes_tiles, s_profiles, thr_ints, *, k, ws, r, cap, mesh):
    """Full multi-axis SPMD scan step: profiles sharded over ``clusters``
    ("one expert per reference cluster"), genome tiles sharded over ``data``,
    per-shard candidate buffers combined with all_gather over both axes.
    """

    def per_shard(local_tiles, local_profiles, local_thrs):
        def one_profile(s_prof, thr):
            f = jax.vmap(lambda t: _tile_kernel(t, s_prof, thr, k, ws, r, cap))
            return f(local_tiles)

        outs = jax.vmap(one_profile)(local_profiles, local_thrs)
        outs = tuple(jax.lax.all_gather(o, "data", axis=1, tiled=True) for o in outs)
        outs = tuple(jax.lax.all_gather(o, "clusters", axis=0, tiled=True) for o in outs)
        return outs

    shard_fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P("data", None), P("clusters", None), P("clusters")),
        out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False,  # outputs are value-replicated after all_gather
    )
    return shard_fn(codes_tiles, s_profiles, thr_ints)


def make_tiles(codes: np.ndarray, tile_windows: int, ws: int, n_tiles_round: int) -> tuple[np.ndarray, int]:
    """Cut one record into overlapped tiles of ``tile_windows`` windows each
    (halo ws-1), padded up to ``n_tiles_round`` tiles for even sharding.

    Returns (tiles array (n_tiles_round, tile_windows + ws - 1), n_real_windows).
    """
    n = codes.shape[0]
    nw = n - ws + 1
    n_tiles = -(-nw // tile_windows)
    n_pad_tiles = -(-n_tiles // n_tiles_round) * n_tiles_round
    tile_len = tile_windows + ws - 1
    tiles = np.zeros((n_pad_tiles, tile_len), dtype=np.int8)
    for t in range(n_tiles):
        lo = t * tile_windows
        chunk = codes[lo : min(lo + tile_len, n)]
        tiles[t, : chunk.shape[0]] = chunk
    return tiles, nw
