"""End-to-end MCMC pipeline parity tests.

The reference's own integration bar (tests/testthat/test-ppcSeq.R:26-30) is
`tot_deleterious_outliers == (0, 1, 0)` on (SLC16A12, CYP1A1, ART3). The
reference only exercises VB there; these tests run the SAME config through
`identify_outliers(approximate_posterior_inference=False)` so the entire
MCMC branch of do_inference — ADVI warm start, the divergence-retry ladder,
the diagnostics `sel` arithmetic, and both samplers — is executed through
the public API.
"""

import numpy as np
import pandas as pd
import pytest

from ppcseq import identify_outliers, load_counts


@pytest.fixture(scope="module")
def sig_counts():
    counts = load_counts()
    return counts.assign(
        is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"])
    )


_COMMON = dict(
    formula="~ Label",
    sample="sample",
    transcript="symbol",
    abundance="value",
    significance="PValue",
    do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=50,
    approximate_posterior_inference=False,
    approximate_posterior_analysis=True,
    seed=42,
)


def test_mcmc_hmc_pipeline(sig_counts):
    """Full two-pass pipeline with the flagship jittered-HMC sampler."""
    res = identify_outliers(sig_counts, mcmc_sampler="hmc", pass_fit=True, **_COMMON)
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    # the MCMC branch surfaces convergence diagnostics in the fit info
    for fit_key in ("fit 1", "fit 2"):
        fit = res.attrs[fit_key]
        # pass_fit=True stores the sampler result object for introspection
        assert fit.draws.ndim == 3


def test_mcmc_nuts_pipeline(sig_counts):
    """Full two-pass pipeline with the dynamic-tree NUTS sampler."""
    res = identify_outliers(sig_counts, mcmc_sampler="nuts", **_COMMON)
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}


def test_mcmc_generated_quantities(sig_counts):
    """save_generated_quantities is MCMC-only (VB forbidden) and requires the
    exact CI path; the draws land in the nested result."""
    cfg = dict(_COMMON)
    cfg["approximate_posterior_analysis"] = False
    res = identify_outliers(
        sig_counts, mcmc_sampler="hmc", save_generated_quantities=True, **cfg
    )
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    swd = res.sample_wise_data.iloc[0]
    assert "generated quantities" in swd.columns
    gq = swd["generated quantities"].iloc[0]
    assert isinstance(gq, pd.DataFrame)
    assert {".draw", ".value"} <= set(gq.columns)
    assert (gq[".value"] >= 0).all()
