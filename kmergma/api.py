"""User-facing API mirroring the reference surface
(ref KmerGMA.jl/src/API.jl): ``find_genes``, ``find_genes_cluster_mode``,
``write_results``.

Kwarg names, defaults, validation, warning texts and output ordering follow
the reference (API.jl:60-104, 161-226): the return value is a list whose
first element is the hit-record list, with hit-loci / alignments / distances
appended in that priority order when requested.
"""

from __future__ import annotations

import logging
import warnings
from typing import Iterable

import numpy as np

from .models.miner import mine_genome
from .ops.reference import cluster_ref_api, eliminate_null_params, gen_ref_ws_cons
from .ops.thresholds import estimate_optimal_threshold, estimate_optimal_thresholds
from .utils.fasta import FastaRecord, write_fasta

logger = logging.getLogger("kmergma")


def _warn_helper(k: int, do_return_dists: bool) -> None:
    # ref API.jl:8-11
    if k < 5:
        warnings.warn(f"Such a low k value of {k} likely won't yield the most accurate results")
    if do_return_dists:
        warnings.warn("Setting do_return_dists to true may be very memory intensive")


def find_genes(
    genome_path: str,
    ref_path: str,
    k: int = 6,
    kmer_dist_thr: float = 0,
    buffer: int = 50,
    do_align: bool = True,
    gap_open_score: int = -69,
    gap_extend_score: int = -1,
    do_return_dists: bool = False,
    do_return_hit_loci: bool = False,
    do_return_align: bool = False,
    verbose: bool = True,
    kmer_dist_threshold_buffer: float = 8.0,
    devices: int | None = None,
    checkpoint_path: str | None = None,
) -> list:
    """Single-profile homology search (ref API.jl:60-104).

    Returns ``[hits]`` plus, in priority order when requested, hit loci,
    alignments and per-window distances.

    Beyond the reference surface: ``devices`` runs the scan SPMD over the
    first N devices of the default backend (parallel/sharded_scan.py), and
    ``checkpoint_path`` enables per-record checkpoint/resume
    (utils/checkpoint.py).
    """
    if verbose:
        logger.info("pre-processing references and parameters...")
    _warn_helper(k, do_return_dists)

    profile = gen_ref_ws_cons(ref_path, k)
    if k >= profile.windowsize:
        raise ValueError(
            f"the average reference sequence length {profile.windowsize} exceeds/is equal to "
            f"the chosen kmer length {k}. please reduce k. "
        )

    estimated = estimate_optimal_threshold(
        profile.mean_kfv, profile.windowsize, buffer=kmer_dist_threshold_buffer
    )
    if kmer_dist_thr == 0:
        kmer_dist_thr = estimated
    elif kmer_dist_thr < estimated:
        warnings.warn(
            f"The kmer distance threshold {kmer_dist_thr} for k = {k} is likely too high, "
            "and can result in many false positives"
        )

    if verbose:
        logger.info("initializing iteration...")
    engine = None
    if devices is not None:
        from .parallel.mesh import make_mesh
        from .parallel.sharded_scan import ShardedScanEngine

        engine = ShardedScanEngine(
            profile.sum_kfv, k=k, ws=profile.windowsize, r=profile.n_records,
            mesh=make_mesh(devices),
        )
    res = mine_genome(
        genome_path,
        profile,
        thr=kmer_dist_thr,
        buff=buffer,
        do_align=do_align,
        gap_open=gap_open_score,
        gap_extend=gap_extend_score,
        do_return_dists=do_return_dists,
        do_return_align=do_return_align,
        get_hit_loci=do_return_hit_loci,
        engine=engine,
        checkpoint_path=checkpoint_path,
    )

    out: list = [res.hits]
    if do_return_hit_loci:
        out.append(res.hit_loci)
    if do_return_align:
        out.append(res.alignments)
    if do_return_dists:
        out.append(res.dists)
    if verbose:
        _log_stats(res)
        logger.info("genome mining completed successfully")
    return out


def _log_stats(res) -> None:
    """Observability: one structured line per mine run (SURVEY.md 5.5)."""
    s = res.stats
    if s is None:
        return
    import dataclasses
    import json as _json

    payload = dataclasses.asdict(s)
    payload["mbp_per_second"] = round(s.mbp_per_second, 2)
    logger.info("scan stats: %s", _json.dumps(payload))


def find_genes_cluster_mode(
    genome_path: str,
    ref_path: str,
    cluster_cutoffs: list | None = None,
    k: int = 6,
    kmer_dist_thrs: "list | np.ndarray | None" = None,
    buffer: int = 100,
    do_align: bool = True,
    gap_open_score: int = -200,
    gap_extend_score: int = -1,
    do_return_dists: bool = False,
    do_return_hit_loci: bool = False,
    do_return_align: bool = False,
    verbose: bool = True,
    kmer_dist_threshold_buffer: float = 7.0,
    devices: int | None = None,
    checkpoint_path: str | None = None,
) -> list:
    """Cluster-mode (multi-profile) homology search (ref API.jl:161-226).

    Beyond the reference surface: ``devices`` runs the fused multi-profile
    scan SPMD over the first N devices (parallel/sharded_scan.py);
    ``checkpoint_path`` enables per-record checkpoint/resume."""
    from .models.omn_miner import mine_genome_clusters

    if cluster_cutoffs is None:
        cluster_cutoffs = [7, 12, 20, 25]
    if verbose:
        logger.info("pre-processing references and parameters...")
    _warn_helper(k, do_return_dists)

    clusters = eliminate_null_params(cluster_ref_api(ref_path, k, cutoffs=cluster_cutoffs))
    if k >= min(clusters.windowsizes):
        raise ValueError(
            "some/all of the average reference sequence lengths exceeds/is equal to "
            f"the chosen kmer length {k}. please reduce k. "
        )

    estimated = estimate_optimal_thresholds(
        clusters.kfvs, clusters.windowsizes, buffer=kmer_dist_threshold_buffer
    )
    if kmer_dist_thrs is None or (len(kmer_dist_thrs) and kmer_dist_thrs[0] == 0):
        kmer_dist_thrs = estimated
    else:
        too_high = [
            (i + 1, num) for i, num in enumerate(kmer_dist_thrs) if num > estimated[i]
        ]
        if too_high:
            inds = ", ".join(str(i) for i, _ in too_high)
            warnings.warn(
                f"The kmer distance thresholds {list(kmer_dist_thrs)} at index/indicies {inds} "
                f"for k = {k} is potentially too high, and may result in more false positives."
            )

    if verbose:
        logger.info("initializing iteration...")
    engine = None
    if devices is not None:
        from .parallel.mesh import make_mesh
        from .parallel.sharded_scan import ShardedClusterScanEngine

        engine = ShardedClusterScanEngine(clusters.profiles, k=k, mesh=make_mesh(devices))
    res = mine_genome_clusters(
        genome_path,
        clusters.profiles,
        engine=engine,
        checkpoint_path=checkpoint_path,
        thr_vec=list(map(float, kmer_dist_thrs)),
        buff=buffer,
        do_align=do_align,
        gap_open=gap_open_score,
        gap_extend=gap_extend_score,
        do_return_dists=do_return_dists,
        do_return_align=do_return_align,
        get_hit_loci=do_return_hit_loci,
    )

    out: list = [res.hits]
    if do_return_hit_loci:
        out.append(res.hit_loci)
    if do_return_align:
        out.append(res.alignments)
    if do_return_dists:
        out.append(res.dists)
    if verbose:
        _log_stats(res)
        logger.info("genome mining completed successfully")
    return out


def strobemer_find_genes(
    genome_path: str,
    ref_path: str,
    s: int = 2,
    w_min: int = 3,
    w_max: int = 5,
    q: int = 5,
    kmer_dist_thr: float = 30,
    buffer: int = 50,
    do_align: bool = True,
    align_score_thr: int = 0,
    do_return_dists: bool = False,
    do_return_hit_loci: bool = False,
    do_return_align: bool = False,
    verbose: bool = True,
    checkpoint_path: str | None = None,
) -> list:
    """Experimental randstrobe-based search
    (ref StrobemerGMA/StrobeGenomeMiner.jl:119-158).  No threshold
    auto-estimation, mirroring the reference."""
    from .models.strobe_miner import gen_strobe_ref_ws_cons, strobe_mine_genome

    profile = gen_strobe_ref_ws_cons(ref_path, s=s, w_min=w_min, w_max=w_max, q=q)
    if verbose:
        logger.info("initializing iteration...")
    res = strobe_mine_genome(
        genome_path,
        profile,
        thr=kmer_dist_thr,
        buff=buffer,
        do_align=do_align,
        score_threshold=align_score_thr,
        do_return_dists=do_return_dists,
        do_return_align=do_return_align,
        get_hit_loci=do_return_hit_loci,
        checkpoint_path=checkpoint_path,
    )
    out: list = [res.hits]
    if do_return_hit_loci:
        out.append(res.hit_loci)
    if do_return_align:
        out.append(res.alignments)
    if do_return_dists:
        out.append(res.dists)
    if verbose:
        logger.info("genome mining completed successfully")
    return out


def write_results(hits: Iterable[FastaRecord], file_path: str, width: int = 95) -> None:
    """Append hit records to a fasta file (ref API.jl:234-241)."""
    write_fasta(hits, file_path, width=width, append=True)
    logger.info("writing complete")
