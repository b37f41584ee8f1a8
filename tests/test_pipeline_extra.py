"""Pipeline coverage beyond the core parity tests: multi-covariate designs,
custom scaling factors, auto-switch heuristics, plotting."""

import numpy as np
import pandas as pd
import pytest

from ppcseq import identify_outliers, load_counts, plot_credible_intervals


@pytest.fixture(scope="module")
def small_counts():
    """3 check genes + enough controls, with a synthetic batch covariate."""
    counts = load_counts()
    counts = counts.assign(
        is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"])
    )
    samples = sorted(counts["sample"].unique())
    batch = {s: ("b1" if i % 2 == 0 else "b2") for i, s in enumerate(samples)}
    return counts.assign(batch=counts["sample"].map(batch))


_BASE = dict(
    sample="sample",
    transcript="symbol",
    abundance="value",
    significance="PValue",
    do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=30,
    seed=11,
)


def test_multi_covariate_formula(small_counts):
    """~ Label + batch exercises the alpha_2 coefficient block (C=3)."""
    res = identify_outliers(small_counts, formula="~ Label + batch", **_BASE)
    assert len(res) == 3
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls["CYP1A1"] >= 1  # the known outlier survives extra covariates
    swd = res.sample_wise_data.iloc[0]
    assert "Label" in swd.columns and "batch" in swd.columns


def test_interaction_formula(small_counts):
    """~ Label * batch (C=4, incl. the interaction column) runs end-to-end.

    Exercises the full `model.matrix` interaction semantics (reference gets
    these free from R, R/utilities.R:887-900) through the pipeline.
    """
    res = identify_outliers(small_counts, formula="~ Label * batch", **_BASE)
    assert len(res) == 3
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls["CYP1A1"] >= 1
    assert res.attrs["formula"] == "~ Label * batch"


def test_intercept_only_formula(small_counts):
    """~ 1: no covariates -> no deleterious classification, only ppc."""
    res = identify_outliers(small_counts, formula="~ 1", **_BASE)
    assert "tot_deleterious_outliers" not in res.columns
    assert "ppc_samples_failed" in res.columns


def test_custom_scaling_factor(small_counts):
    df = small_counts.copy()
    tot = df.groupby("sample")["value"].transform("sum")
    df["my_scaling"] = tot.max() / tot
    res = identify_outliers(
        df, formula="~ Label", scaling_factor="my_scaling", **_BASE
    )
    swd = res.sample_wise_data.iloc[0]
    # exposure_rate must reflect the provided multiplier exactly
    np.testing.assert_allclose(
        swd["exposure_rate"], -np.log(swd["multiplier"]), rtol=1e-10
    )


def test_seed_reproducibility(small_counts):
    r1 = identify_outliers(small_counts, formula="~ Label", **_BASE)
    r2 = identify_outliers(small_counts, formula="~ Label", **_BASE)
    pd.testing.assert_frame_equal(
        r1.sample_wise_data.iloc[1], r2.sample_wise_data.iloc[1]
    )


def test_approx_analysis_auto_switch(small_counts):
    """approximate_posterior_analysis=None flips on above 20k draws
    (reference R/methods.R:169-175)."""
    res = identify_outliers(
        small_counts, formula="~ Label",
        approximate_posterior_analysis=None,
        adj_prob_theshold_2=1e-4,  # needs 100k draws -> auto-approx
        **_BASE,
    )
    assert len(res) == 3


def test_exact_ci_memory_switch_reads_the_draws_device(monkeypatch):
    """The exact-CI feasibility switch reads the accelerator's allocator
    limit on the device that holds the draws (the mesh's first device when
    a mesh is given) and host RAM only on the CPU backend."""
    import os
    from types import SimpleNamespace

    from ppcseq.pipeline import identify

    host_ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert identify._available_memory_bytes() == host_ram

    def gpu(limit):
        return SimpleNamespace(platform="gpu", memory_stats=lambda: {"bytes_limit": limit})

    monkeypatch.setattr(identify.jax, "devices", lambda *a: [gpu(60e9)])
    assert identify._available_memory_bytes() == 60e9
    mesh = SimpleNamespace(devices=np.array([gpu(40e9), gpu(40e9)]))
    assert identify._available_memory_bytes(mesh) == 40e9


def test_plot_credible_intervals(small_counts):
    res = identify_outliers(small_counts, formula="~ Label", **_BASE)
    out = plot_credible_intervals(res)
    assert "plot" in out.columns
    fig = out["plot"].iloc[0]
    assert fig.axes[0].get_title() == out.symbol.iloc[0]
    import matplotlib.pyplot as plt

    plt.close("all")


def test_hmc_adapt_trajectory_in_product():
    """Opt-in SNAPER trajectory adaptation reaches the product path
    (round-4 finding: adapt_trajectory was regression-tested at sampler
    level but unreachable from identify_outliers). The adapted trajectory
    length must surface in fit_info, and a genes-mesh combination raises."""
    import numpy as np

    import jax
    import pytest
    from jax.sharding import Mesh

    from ppcseq.pipeline.identify import identify_outliers
    from ppcseq.utils.synthetic import synthetic_tidy

    df = synthetic_tidy(n_genes=48, n_samples=8, n_check=3, outlier_frac=0.15, seed=0)
    res = identify_outliers(
        df, formula="~ Label", how_many_negative_controls=30,
        approximate_posterior_inference=False, mcmc_sampler="hmc",
        hmc_adapt_trajectory=True, seed=11, pass_fit=True,
    )
    assert len(res) == 3
    fit2 = res.attrs["fit 2"]
    assert fit2.trajectory_length is not None and fit2.trajectory_length > 0

    mesh = Mesh(np.array(jax.devices()), ("genes",))
    with pytest.raises(ValueError, match="adapt_trajectory"):
        identify_outliers(
            df, formula="~ Label", how_many_negative_controls=30,
            approximate_posterior_inference=False, mcmc_sampler="hmc",
            hmc_adapt_trajectory=True, seed=11, mesh=mesh,
        )
