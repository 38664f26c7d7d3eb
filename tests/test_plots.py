"""Diagnostic plotting helper (the reference's Plots.jl scatter,
ref DistanceTesting.jl:87-92) renders and saves a figure headlessly."""

import matplotlib

matplotlib.use("Agg")

import numpy as np


def test_mutation_plot_saves_figure(tmp_path):
    from kmergma.ops.thresholds import substitution_distance_sweep
    from kmergma.utils.plots import mutation_plot

    rng = np.random.default_rng(0)
    from kmergma.ops.kmers import kmer_count

    base = rng.integers(0, 4, 150, dtype=np.int8)
    mean_kfv = kmer_count(base, 4).astype(np.float64)
    sweep = substitution_distance_sweep(mean_kfv, base, num_seeds=3, stepsize=0.25)
    out = tmp_path / "sweep.png"
    fig = mutation_plot(sweep, 0.25, save_path=str(out))
    assert out.exists() and out.stat().st_size > 1000
    assert fig.axes[0].get_xlabel() == "mutation rate"
