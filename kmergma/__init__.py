"""kmergma: an exact k-mer homology-scanning framework in JAX, with the
capabilities of KmerGMA.jl.

Public API mirrors the reference surface (ref KmerGMA.jl/src/API.jl):
``find_genes``, ``find_genes_cluster_mode``, ``write_results``,
``exact_match``, plus the strobemer scan and counting utilities.
"""

__version__ = "0.1.0"

from .consts import NT_BITS, encode_seq, decode_seq, get_k  # noqa: F401
from .ops.kmers import kmer_count, kmer_dist, as_kmer, as_uint  # noqa: F401
from .ops.consensus import Profile  # noqa: F401
from .ops.reference import (  # noqa: F401
    gen_ref_ws_cons,
    cluster_ref_api,
    eliminate_null_params,
    get_cluster_index,
)
from .ops.thresholds import (  # noqa: F401
    estimate_optimal_threshold,
    estimate_optimal_thresholds,
)


def __getattr__(name):
    # Heavier API surface is imported lazily to keep `import kmergma` light.
    if name in ("find_genes", "find_genes_cluster_mode", "write_results", "strobemer_find_genes"):
        from . import api

        return getattr(api, name)
    if name == "record_kmergma":
        from .models.miner import record_kmergma

        return record_kmergma
    if name in ("exact_match", "first_match"):
        from .ops import exact_match as _em

        return getattr(_em, name)
    if name in ("kmer_pair_count", "as_index", "initialize_kmers"):
        from .ops import paired_kmers as _pk

        return getattr(_pk, name)
    if name in ("get_strobe_2_mer", "randstrobe_score", "ungapped_strobe_2_mer_count"):
        from .ops import strobemers as _st

        return getattr(_st, name)
    if name in ("HUMAN_RSSV", "HUMAN_RSSD", "align_rss", "rss_dist", "is_rss"):
        from .ops import rss as _rss

        return getattr(_rss, name)
    if name == "fasta_id_to_cumulative_len_dict":
        from .utils.fasta import fasta_id_to_cumulative_len_dict

        return fasta_id_to_cumulative_len_dict
    if name in ("substitution_distance_sweep", "strobemer_distance_sweep", "mutate_seq"):
        from .ops import thresholds as _th

        return getattr(_th, name)
    if name == "mutation_plot":
        from .utils.plots import mutation_plot

        return mutation_plot
    raise AttributeError(name)
