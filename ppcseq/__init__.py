"""ppcseq — posterior-predictive-check outlier detection for RNA-seq, in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
R/Stan package ppcseq (posterior predictive checks for bulk RNA-seq
differential expression): a hierarchical negative-binomial GLM fit with
meanfield ADVI or vectorized multi-chain NUTS, on-device posterior-predictive
credible intervals, and a two-pass truncation-refit procedure that calls
deleterious outlier observations per transcript.
"""

from ppcseq.data.datasets import load_counts
from ppcseq.pipeline.identify import identify_outliers
from ppcseq.viz.plots import plot_credible_intervals

__version__ = "0.1.0"

__all__ = [
    "identify_outliers",
    "plot_credible_intervals",
    "load_counts",
]


def __getattr__(name):
    # Lazy secondary API: samplers, variational fits, diagnostics.
    if name in ("run_hmc",):
        from ppcseq.infer.hmc import run_hmc

        return run_hmc
    if name in ("run_nuts",):
        from ppcseq.infer.nuts import run_nuts

        return run_nuts
    if name in ("fit_advi", "vb_iterative"):
        from ppcseq.infer import advi

        return getattr(advi, name)
    if name in ("split_rhat", "ess"):
        from ppcseq.infer import diagnostics

        return getattr(diagnostics, name)
    raise AttributeError(f"module 'ppcseq' has no attribute {name!r}")
