"""Data layer: RData fixture, ingest, gene selection, indexing."""

import numpy as np
import pandas as pd
import pytest

from ppcseq.data.ingest import (
    build_model_data,
    check_columns_exist,
    check_if_any_na,
    check_integer_counts,
    check_rectangular,
    format_input,
    select_to_check_and_house_keeping,
)


def test_counts_fixture_shape(counts_df):
    # Reference README.md:32-45: 394,821 rows, 9 columns, 21 samples, 18,801 transcripts
    assert counts_df.shape == (394821, 9)
    assert counts_df["sample"].nunique() == 21
    assert counts_df["symbol"].nunique() == 18801
    assert set(counts_df["Label"].unique()) == {"High", "Neoadjuvant"}
    assert pd.api.types.is_integer_dtype(counts_df["value"])
    # 15 genes at FDR < 0.01 (reference README.md:58)
    assert counts_df.loc[counts_df.FDR < 0.01, "symbol"].nunique() == 15


def test_validation_helpers(counts_df):
    check_columns_exist(counts_df, ["sample", "symbol", "value"])
    with pytest.raises(ValueError, match="not present"):
        check_columns_exist(counts_df, ["nope"])
    check_if_any_na(counts_df, ["sample", "symbol", "value"])
    df_na = counts_df.head(10).copy()
    df_na.loc[3, "value"] = pd.NA
    with pytest.raises(ValueError, match="NA values"):
        check_if_any_na(df_na, ["value"])
    check_integer_counts(counts_df, "value")
    with pytest.raises(TypeError, match="integer"):
        check_integer_counts(counts_df.assign(value=counts_df.value.astype(float)), "value")


def test_rectangular_check(counts_df):
    check_rectangular(counts_df, "sample", "symbol")
    broken = counts_df[~((counts_df["symbol"] == "CYP1A1") & (counts_df["sample"] == "10922PP"))]
    with pytest.raises(ValueError, match="rectangular"):
        check_rectangular(broken, "sample", "symbol")


def test_select_to_check_and_house_keeping(counts_df):
    df = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    sel = select_to_check_and_house_keeping(df, "is_significant", "PValue", "symbol", 50)
    sig = sel[sel.is_significant]
    assert set(sig.symbol.unique()) == {"SLC16A12", "CYP1A1", "ART3"}
    controls = sel[~sel.is_significant].symbol.unique()
    assert len(controls) == 50
    # Controls are the least-significant transcripts
    max_sig_p = df[df.symbol.isin(controls)].PValue.min()
    frac_bigger = (df.groupby("symbol").PValue.first() <= max_sig_p).mean()
    assert frac_bigger > 0.99


def test_format_input_indices(counts_df):
    df = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    my_df = format_input(df, "~ Label", "sample", "symbol", "value", "is_significant", "PValue", 50)
    # Check genes occupy the first G indices (reference R/utilities.R:949-952)
    check_gs = my_df.loc[my_df.is_significant, "G"].unique()
    assert set(check_gs) == {0, 1, 2}
    assert my_df.G.max() == 52  # 3 check + 50 controls
    assert my_df.S.max() == 20
    # S follows first appearance (== sorted for the bundled data)
    order = my_df.drop_duplicates("sample")
    assert list(order.S) == sorted(order.S)
    # one row per (S, G)
    assert len(my_df) == 53 * 21


def test_build_model_data(counts_df):
    df = counts_df.assign(is_significant=counts_df.symbol.isin(["SLC16A12", "CYP1A1", "ART3"]))
    my_df = format_input(df, "~ Label", "sample", "symbol", "value", "is_significant", "PValue", 50)
    from ppcseq.formula.design import create_design_matrix

    X, names, rows = create_design_matrix(my_df, "~ Label", "sample")
    exposure = {s: 0.1 for s in my_df["sample"].unique()}
    md = build_model_data(
        my_df, "sample", "symbol", "value", "is_significant",
        X, list(rows["sample"]), exposure,
    )
    assert md.counts.shape == (21, 53)
    assert md.n_check == 3
    assert md.X.shape == (21, 2)
    # spot-check one cell against the raw table
    row = counts_df[(counts_df["sample"] == "10922PP") & (counts_df.symbol == "SLC16A12")]
    s = md.sample_names.index("10922PP")
    g = md.gene_names.index("SLC16A12")
    assert md.counts[s, g] == row.value.iloc[0]
    # exclusion mask path
    excl = pd.DataFrame({"S": [0, 2], "G": [1, 0]})
    md2 = build_model_data(
        my_df, "sample", "symbol", "value", "is_significant",
        X, list(rows["sample"]), exposure, exclude=excl,
    )
    assert md2.exclude_mask.sum() == 2
    assert md2.exclude_mask[0, 1] and md2.exclude_mask[2, 0]


def test_format_input_deduplicates_pairs(counts_df):
    """Duplicated input rows (e.g. from upstream joins) must collapse to
    their first occurrence, exactly like the reference's distinct()
    (R/utilities.R:940) — the round-5 numpy dedup path."""
    df = counts_df.assign(is_significant=counts_df.symbol.isin(["CYP1A1"]))
    dup = pd.concat([df, df.head(5000)], ignore_index=True)
    out = format_input(dup, "~ Label", "sample", "symbol", "value",
                       "is_significant", "PValue", 30)
    ref = format_input(df, "~ Label", "sample", "symbol", "value",
                       "is_significant", "PValue", 30)
    pd.testing.assert_frame_equal(out, ref)
