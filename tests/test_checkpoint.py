"""Pass-level checkpoint/resume (utils/checkpoint.py + pipeline wiring)."""

import json
import os
import time

import numpy as np
import pandas as pd
import pytest

from ppcseq import identify_outliers, load_counts


@pytest.fixture(scope="module")
def tiny_counts():
    counts = load_counts()
    return counts.assign(
        is_significant=counts.symbol.isin(["SLC16A12", "CYP1A1", "ART3"])
    )


_ARGS = dict(
    formula="~ Label",
    sample="sample", transcript="symbol", abundance="value",
    significance="PValue", do_check="is_significant",
    percent_false_positive_genes=1,
    how_many_negative_controls=20,
    seed=19,
)


def test_checkpoint_resume_identical(tiny_counts, tmp_path):
    ckpt = str(tmp_path / "ck")
    t0 = time.time()
    res1 = identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    t_cold = time.time() - t0
    assert os.path.exists(os.path.join(ckpt, "pass1.parquet"))
    assert os.path.exists(os.path.join(ckpt, "pass2.parquet"))

    t0 = time.time()
    res2 = identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    t_warm = time.time() - t0
    assert t_warm < t_cold / 3  # both fits skipped
    assert list(res1.tot_deleterious_outliers) == list(res2.tot_deleterious_outliers)
    pd.testing.assert_frame_equal(
        res1.sample_wise_data.iloc[1], res2.sample_wise_data.iloc[1]
    )


def test_checkpoint_invalidated_by_config_change(tiny_counts, tmp_path):
    ckpt = str(tmp_path / "ck2")
    identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    with open(os.path.join(ckpt, "meta.json")) as f:
        fp_before = json.load(f)["pass1"]["fingerprint"]
    args = dict(_ARGS)
    args["seed"] = 23  # different config -> both passes rerun + re-saved
    identify_outliers(tiny_counts, checkpoint_dir=ckpt, **args)
    with open(os.path.join(ckpt, "meta.json")) as f:
        fp_after = json.load(f)["pass1"]["fingerprint"]
    assert fp_before != fp_after


def test_checkpoint_invalidated_by_mesh_and_dtype(tiny_counts, tmp_path):
    """mesh and dtype change the computation (gene padding, sharded
    executables, f32 vs f64 densities) — a rerun with either changed must
    NOT resume the cached tables (round-4 review finding)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    ckpt = str(tmp_path / "ck3")
    identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    with open(os.path.join(ckpt, "meta.json")) as f:
        fp_plain = json.load(f)["pass1"]["fingerprint"]

    mesh = Mesh(np.array(jax.devices()), ("genes",))
    identify_outliers(tiny_counts, checkpoint_dir=ckpt, mesh=mesh, **_ARGS)
    with open(os.path.join(ckpt, "meta.json")) as f:
        fp_mesh = json.load(f)["pass1"]["fingerprint"]
    assert fp_mesh != fp_plain

    identify_outliers(tiny_counts, checkpoint_dir=ckpt, dtype=jnp.float64, **_ARGS)
    with open(os.path.join(ckpt, "meta.json")) as f:
        fp_f64 = json.load(f)["pass1"]["fingerprint"]
    assert fp_f64 not in (fp_plain, fp_mesh)


def test_checkpoint_pass_fit_refits_instead_of_silent_none(tiny_counts, tmp_path):
    """With `pass_fit=True` a checkpoint hit must NOT resume either pass:
    the stored table has no fit object, so resuming would silently hand
    back `fit 1 = None` / `fit 2 = None` (round-4 finding: pass 2 had the
    guard, pass 1 didn't)."""
    ckpt = str(tmp_path / "ck4")
    identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    assert os.path.exists(os.path.join(ckpt, "pass1.parquet"))

    res = identify_outliers(tiny_counts, checkpoint_dir=ckpt, pass_fit=True, **_ARGS)
    assert res.attrs["fit 1"] is not None
    assert res.attrs["fit 2"] is not None
    assert res.attrs["total_draws"] > 0


def test_checkpoint_resume_restores_total_draws(tiny_counts, tmp_path):
    """A resumed run must carry the original run's total_draws provenance
    (both passes persist it in meta.json), not silently report 0."""
    ckpt = str(tmp_path / "ck5")
    res_cold = identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    res_warm = identify_outliers(tiny_counts, checkpoint_dir=ckpt, **_ARGS)
    assert res_warm.attrs["total_draws"] == res_cold.attrs["total_draws"] > 0
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    assert meta["pass1"]["total_draws"] > 0
    assert meta["pass2"]["total_draws"] > 0
