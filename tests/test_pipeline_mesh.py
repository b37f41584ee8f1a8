"""Multi-device pipeline parity: `identify_outliers(mesh=...)`.

The reference runs its parallelism INSIDE every fit — map_rect fans the
likelihood across threads/MPI ranks (stan:226-240, R/utilities.R:1479) and
chains fork processes (R/utilities.R:1497-1502). These tests run the actual
product (`identify_outliers`, not a sampler harness) on the 8-virtual-device
CPU mesh and assert the reference's own integration bar
(tests/testthat/test-ppcSeq.R:26-30): `tot_deleterious_outliers == (0,1,0)`
on (SLC16A12, CYP1A1, ART3).
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

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
    seed=42,
)


def test_gene_sharded_vb_pipeline(sig_counts):
    """VB (the reference's default inference) with the model data and
    per-gene parameters sharded over an 8-way `genes` mesh — the map_rect
    analog running inside the product. Gene count is padded 53 -> 56."""
    mesh = Mesh(np.array(jax.devices()), ("genes",))
    res = identify_outliers(
        sig_counts, approximate_posterior_inference=True, mesh=mesh, **_COMMON
    )
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}


def test_chain_sharded_hmc_pipeline(sig_counts):
    """Flagship jittered-HMC with the 128-chain batch sharded over an 8-way
    `chains` mesh (the chain-process analog), fit info surfaced."""
    mesh = Mesh(np.array(jax.devices()), ("chains",))
    res = identify_outliers(
        sig_counts, approximate_posterior_inference=False, mcmc_sampler="hmc",
        mesh=mesh, pass_fit=True, **_COMMON,
    )
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
    assert res.attrs["fit 2"].draws.ndim == 3


def test_mesh_unknown_axis_rejected(sig_counts):
    mesh = Mesh(np.array(jax.devices()), ("replicas",))
    with pytest.raises(ValueError, match="genes.*chains|chains.*genes"):
        identify_outliers(sig_counts, mesh=mesh, **_COMMON)


def test_gene_sharded_hmc_pipeline_synthetic():
    """Gene+chain 2-D mesh through the MCMC branch on a small synthetic
    cohort: the full tree-state path (ADVI warm start -> run_hmc_tree ->
    sharded extraction/PPC) end to end."""
    from ppcseq.utils.synthetic import synthetic_tidy

    df = synthetic_tidy(n_genes=64, n_samples=8, n_check=3, seed=0)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("chains", "genes"))
    res = identify_outliers(
        df, formula="~ Label", how_many_negative_controls=40,
        approximate_posterior_inference=False, mcmc_sampler="hmc",
        seed=42, mesh=mesh, pass_fit=True,
    )
    assert len(res) == 3
    assert (res.tot_deleterious_outliers >= 0).all()
    # draws really are a gene-sharded pytree
    draws = res.attrs["fit 2"].draws
    assert "genes" in str(draws["intercept"].sharding.spec)


def test_chains_mesh_with_vb_warns(sig_counts):
    """A chains-only mesh cannot shard the variational fit — the pipeline
    must say so instead of silently running single-device (round-4 review
    finding; the tutorial's mesh example uses VB defaults)."""
    mesh = Mesh(np.array(jax.devices()), ("chains",))
    with pytest.warns(UserWarning, match="chains.*variational|variational.*chains"):
        res = identify_outliers(
            sig_counts, approximate_posterior_inference=True, mesh=mesh, **_COMMON
        )
    calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
    assert calls == {"SLC16A12": 0, "CYP1A1": 1, "ART3": 0}
