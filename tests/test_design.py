"""Formula parsing and model.matrix semantics (reference R/utilities.R:220-225, 887-900)."""

import numpy as np
import pandas as pd
import pytest

from ppcseq.formula.design import (
    create_design_matrix,
    model_matrix,
    parse_formula,
    parse_terms,
)


def test_parse_formula():
    assert parse_formula("~ Label") == ["Label"]
    assert parse_formula("~Label + batch") == ["Label", "batch"]
    assert parse_formula("~ 1") == []
    assert parse_formula("~1") == []
    assert parse_formula("~ a * b") == ["a", "b"]
    assert parse_formula("~ a:b + c") == ["a", "b", "c"]
    with pytest.raises(ValueError, match="~ covariates"):
        parse_formula("y ~ x")
    with pytest.raises(ValueError, match="not supported"):
        parse_formula("~ a - 1")
    with pytest.raises(ValueError, match="not supported"):
        parse_formula("~ a^2")
    with pytest.raises(ValueError, match="not supported"):
        parse_formula("~ I(a + b)")


def test_parse_terms_expansion_and_ordering():
    """`terms()` semantics: `*` expansion, dedup, order-sorted, appearance-ordered labels."""
    # a*b == a + b + a:b
    assert parse_terms("~ a * b")[1] == [("a",), ("b",), ("a", "b")]
    # three-way crossing, R label order: a b c a:b a:c b:c a:b:c
    assert parse_terms("~ a * b * c")[1] == [
        ("a",), ("b",), ("c",),
        ("a", "b"), ("a", "c"), ("b", "c"),
        ("a", "b", "c"),
    ]
    # terms are reordered by interaction order (keep.order=FALSE default)
    assert parse_terms("~ a:b + c")[1] == [("c",), ("a", "b")]
    # duplicates collapse; interaction variables listed by first appearance
    assert parse_terms("~ b + a + a:b + b:a")[1] == [("b",), ("a",), ("b", "a")]
    # a:a collapses to a, then dedups against the main effect
    assert parse_terms("~ a + a:a")[1] == [("a",)]
    # `:` binds tighter than `*`
    assert parse_terms("~ a * b:c")[1] == [("a",), ("b", "c"), ("a", "b", "c")]


def test_model_matrix_treatment_contrasts():
    df = pd.DataFrame({"Label": ["Neoadjuvant", "High", "High", "Neoadjuvant"]})
    X, names = model_matrix(df, ["Label"])
    # R factor levels sorted: High baseline, Neoadjuvant indicator
    assert names == ["(Intercept)", "LabelNeoadjuvant"]
    np.testing.assert_array_equal(X[:, 0], 1.0)
    np.testing.assert_array_equal(X[:, 1], [1.0, 0.0, 0.0, 1.0])


def test_model_matrix_multilevel_and_numeric():
    df = pd.DataFrame({"grp": ["c", "a", "b", "c"], "age": [1.5, 2.0, 3.0, 4.0]})
    X, names = model_matrix(df, ["grp", "age"])
    assert names == ["(Intercept)", "grpb", "grpc", "age"]
    np.testing.assert_array_equal(X[:, 1], [0, 0, 1, 0])
    np.testing.assert_array_equal(X[:, 2], [1, 0, 0, 1])
    np.testing.assert_array_equal(X[:, 3], df.age)


def test_model_matrix_factor_by_factor_interaction():
    """Golden: R `model.matrix(~ Label * batch)` on a 2x2 design.

    Hand-derived from treatment contrasts (Statistical Models in S, p.38):
    both main effects precede the interaction, so the interaction is coded
    contrast x contrast — one column, the product of the two indicators.
    """
    df = pd.DataFrame(
        {
            "Label": ["High", "High", "Neo", "Neo"],
            "batch": ["a", "b", "a", "b"],
        }
    )
    X, names = model_matrix(df, parse_terms("~ Label * batch")[1])
    assert names == ["(Intercept)", "LabelNeo", "batchb", "LabelNeo:batchb"]
    np.testing.assert_array_equal(X[:, 1], [0, 0, 1, 1])
    np.testing.assert_array_equal(X[:, 2], [0, 1, 0, 1])
    np.testing.assert_array_equal(X[:, 3], [0, 0, 0, 1])


def test_model_matrix_three_level_interaction_column_order():
    """Golden: R `model.matrix(~ g * b)`, g 3-level, b 2-level.

    R orders interaction columns with the FIRST factor varying fastest:
    gy:bv, gz:bv.
    """
    df = pd.DataFrame(
        {
            "g": ["x", "y", "z", "x", "y", "z"],
            "b": ["u", "u", "u", "v", "v", "v"],
        }
    )
    X, names = model_matrix(df, parse_terms("~ g * b")[1])
    assert names == ["(Intercept)", "gy", "gz", "bv", "gy:bv", "gz:bv"]
    np.testing.assert_array_equal(X[:, 4], [0, 0, 0, 0, 1, 0])
    np.testing.assert_array_equal(X[:, 5], [0, 0, 0, 0, 0, 1])


def test_model_matrix_factor_numeric_interaction():
    """Golden: R `model.matrix(~ g * age)` — contrast-coded g times age."""
    df = pd.DataFrame({"g": ["a", "b", "a", "b"], "age": [1.0, 2.0, 3.0, 4.0]})
    X, names = model_matrix(df, parse_terms("~ g * age")[1])
    assert names == ["(Intercept)", "gb", "age", "gb:age"]
    np.testing.assert_array_equal(X[:, 3], [0.0, 2.0, 0.0, 4.0])


def test_model_matrix_nonhierarchical_dummy_coding():
    """Golden: R codes a factor by FULL dummies when the term minus that
    factor is not an earlier term (model.c TermCode / S p.38).

    `~ g:age` without the g main effect → one slope per level of g.
    `~ a:b` without main effects → all four level combinations (R reproduces
    this over-parameterization; so do we).
    """
    df = pd.DataFrame({"g": ["a", "b", "a", "b"], "age": [1.0, 2.0, 3.0, 4.0]})
    X, names = model_matrix(df, parse_terms("~ g:age")[1])
    assert names == ["(Intercept)", "ga:age", "gb:age"]
    np.testing.assert_array_equal(X[:, 1], [1.0, 0.0, 3.0, 0.0])
    np.testing.assert_array_equal(X[:, 2], [0.0, 2.0, 0.0, 4.0])

    df2 = pd.DataFrame(
        {"a": ["x", "y", "x", "y"], "b": ["u", "u", "v", "v"]}
    )
    X2, names2 = model_matrix(df2, parse_terms("~ a:b")[1])
    assert names2 == ["(Intercept)", "ax:bu", "ay:bu", "ax:bv", "ay:bv"]
    np.testing.assert_array_equal(X2[:, 1:].sum(axis=1), 1.0)


def test_create_design_matrix_interaction_pipeline_shape():
    """`~ Label * batch` through create_design_matrix keeps sample ordering."""
    df = pd.DataFrame(
        {
            "sample": ["s1", "s2", "s3", "s4"],
            "Label": ["A", "A", "B", "B"],
            "batch": ["p", "q", "p", "q"],
        }
    )
    X, names, rows = create_design_matrix(df, "~ Label * batch", "sample")
    assert X.shape == (4, 4)
    assert names[-1] == "LabelB:batchq"
    assert list(rows["sample"]) == ["s1", "s2", "s3", "s4"]


def test_create_design_matrix_orders_by_sample():
    df = pd.DataFrame(
        {
            "sample": ["s2", "s1", "s3", "s2", "s1", "s3"],
            "Label": ["B", "A", "B", "B", "A", "B"],
        }
    )
    X, names, rows = create_design_matrix(df, "~ Label", "sample")
    assert list(rows["sample"]) == ["s1", "s2", "s3"]
    np.testing.assert_array_equal(X[:, 1], [0.0, 1.0, 1.0])


def test_create_design_matrix_intercept_only(counts_df):
    sub = counts_df.head(1000)
    X, names, rows = create_design_matrix(sub, "~ 1", "sample")
    assert X.shape[1] == 1
    assert names == ["(Intercept)"]


def test_inconsistent_covariate_errors():
    df = pd.DataFrame({"sample": ["s1", "s1"], "Label": ["A", "B"]})
    with pytest.raises(ValueError, match="more than one covariate"):
        create_design_matrix(df, "~ Label", "sample")
