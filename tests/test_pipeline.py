"""End-to-end pipeline parity tests (reference tests/testthat/test-ppcSeq.R).

The reference asserts tot_deleterious_outliers == (0, 1, 0) for
(SLC16A12, CYP1A1, ART3) with VB inference and 50 negative controls, for
both the approximated and the full CI-analysis paths.
"""

import numpy as np
import pandas as pd
import pytest

from ppcseq import identify_outliers, load_counts


@pytest.fixture(scope="module")
def sig_counts():
    counts = load_counts()
    counts = counts.assign(
        is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"])
    )
    return counts


_COMMON = dict(
    formula="~ Label",
    sample="sample",
    transcript="symbol",
    abundance="value",
    significance="PValue",
    do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=50,
    seed=42,
)


def test_vb_approximated_analysis(sig_counts):
    """Reference test 'VB post approx no correction' (test-ppcSeq.R:7-32)."""
    res = identify_outliers(
        sig_counts,
        approximate_posterior_inference=True,
        approximate_posterior_analysis=True,
        **_COMMON,
    )
    assert list(res.columns[:2]) == ["symbol", "sample_wise_data"]
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    # nested per-sample tables have 21 rows and the documented columns
    swd = res.sample_wise_data.iloc[0]
    assert len(swd) == 21
    for col in [
        "S", "G", "value", "sample", "Label",
        "slope_before_outlier_filtering", "slope_after_outlier_filtering",
        ".lower", ".upper", "posterior_predictive_check_succeded",
        "deleterious_outliers", "exposure_rate", "multiplier",
    ]:
        assert col in swd.columns, col
    # attrs carry provenance (reference R/methods.R:352-365)
    assert res.attrs["transcript_column"] == "symbol"
    assert res.attrs["formula"] == "~ Label"
    assert res.attrs["total_draws"] > 0


def test_vb_full_analysis(sig_counts):
    """Reference test 'VB post full' (test-ppcSeq.R:34-57)."""
    res = identify_outliers(
        sig_counts,
        approximate_posterior_inference=True,
        approximate_posterior_analysis=False,
        **_COMMON,
    )
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}


def test_empty_do_check_warns(sig_counts):
    empty = sig_counts.assign(is_significant=False)
    with pytest.warns(UserWarning, match="no transcripts"):
        res = identify_outliers(empty, **_COMMON)
    assert len(res) == 0


def test_error_paths(sig_counts):
    with pytest.raises(ValueError, match="Variational Bayes"):
        identify_outliers(
            sig_counts, save_generated_quantities=True,
            approximate_posterior_inference=True, **_COMMON,
        )
    with pytest.raises(ValueError, match="percent_false_positive_genes"):
        bad = dict(_COMMON)
        bad["percent_false_positive_genes"] = 150
        identify_outliers(sig_counts, **bad)
    with pytest.raises(TypeError, match="integer"):
        identify_outliers(
            sig_counts.assign(value=sig_counts.value.astype(float)), **_COMMON
        )


def test_just_discovery(sig_counts):
    res = identify_outliers(sig_counts, just_discovery=True, **_COMMON)
    assert {"S", "G", ".lower", ".upper", "ppc", "slope"} <= set(res.columns)
    assert res.G.max() == 2  # only checked genes
    assert len(res) == 3 * 21
