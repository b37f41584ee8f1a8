"""Regression guards on the sharded programs' COST, not just their output.

The two failure modes this environment CAN measure without real pods are
(1) GSPMD partition/compile time blowing up (the round-3 gene-sharded-NUTS
pathology: minutes to partition the tree build at G=4096) and (2) XLA
silently inserting extra large-array collectives into the hot loop. A
regression in either should fail CI here instead of surfacing as a mystery
at pod scale (SURVEY.md §5 comm-backend contract: gene-sharded log-density =
elementwise local math + ONE scalar psum).
"""

import re
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ppcseq.model import nb_model
from ppcseq.parallel.sharding import gene_mesh, shard_data, shard_params


@pytest.fixture(scope="module")
def sharded_setup():
    rng = np.random.default_rng(0)
    S, G, n_check = 8, 512, 8
    counts = rng.poisson(40.0, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
    mesh = gene_mesh(8)
    data_sh = shard_data(data, mesh)
    init = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float32),
        shard_params(nb_model.smart_init(data, dims, as_tree=True), mesh, dims),
    )
    return mesh, data_sh, dims, init


def _collective_counts(hlo_text: str) -> dict:
    return {
        "all_reduce": len(re.findall(r"all-reduce\(|all-reduce-start\(", hlo_text)),
        "all_gather": len(re.findall(r"all-gather\(|all-gather-start\(", hlo_text)),
        "permute": len(re.findall(r"collective-permute", hlo_text)),
    }


def test_gene_sharded_grad_collectives_and_compile_time(sharded_setup):
    """The integrator's hot op (log-density + gradient) over the genes mesh
    must lower to exactly ONE all-reduce (the scalar log-density psum — XLA
    merges every scalar reduction into it) and ZERO all-gathers; the only
    other collectives allowed are the tiny [n_check]-sized permutes from the
    checked-gene coefficient scatter. Compile must stay seconds, not
    minutes (measured 2.1s on the 8-device CPU mesh)."""
    mesh, data_sh, dims, init = sharded_setup
    logp = nb_model.tree_logp(dims, likelihood="plain")
    f = jax.jit(jax.value_and_grad(lambda t: logp(t, data_sh)))

    t0 = time.time()
    compiled = f.lower(init).compile()
    elapsed = time.time() - t0
    assert elapsed < 60.0, f"GSPMD partition+compile took {elapsed:.1f}s"

    counts = _collective_counts(compiled.as_text())
    assert counts["all_reduce"] == 1, counts
    assert counts["all_gather"] == 0, counts
    # K-sized scatter permutes: bounded, not perf-relevant (n_check elements)
    assert counts["permute"] <= 30, counts

    v, _ = f(init)
    assert np.isfinite(float(v))


def test_gene_sharded_hmc_runner_compiles_fast(sharded_setup):
    """The full tree-state HMC runner (warmup + sampling scans) at G=512 on
    the 8-device mesh must GSPMD-partition in seconds — the guard against
    reintroducing while_loop-style partitioning blowups into the at-scale
    gene-sharded path."""
    from ppcseq.infer.hmc import run_hmc_tree
    from ppcseq.model.params import zeros_tree

    mesh, data_sh, dims, init = sharded_setup
    logp = nb_model.tree_logp(dims, likelihood="plain")
    t0 = time.time()
    res = run_hmc_tree(
        logp, zeros_tree(dims), jax.random.PRNGKey(0), data=data_sh,
        num_chains=4, num_warmup=3, num_draws=2, num_leapfrog=4,
        init_theta=init, mesh=mesh, dims=dims,
    )
    elapsed = time.time() - t0
    assert elapsed < 120.0, f"tree-HMC compile+run took {elapsed:.1f}s"
    assert np.isfinite(np.asarray(res.draws["alpha_sub_1"])).all()


def test_gene_sharded_fast_likelihood_collectives_and_value(sharded_setup):
    """The fused production likelihood ('fast', ops/nb_fast) under the genes
    mesh: same single-all-reduce contract as 'plain', and identical value +
    gradient (the sharded program must not change the math). Pinned here
    because CPU tests resolve 'auto' to 'plain' — without this case the
    fast+sharded combination would first meet GSPMD on real multi-chip."""
    mesh, data_sh, dims, init = sharded_setup
    logp_fast = nb_model.tree_logp(dims, likelihood="fast")
    logp_plain = nb_model.tree_logp(dims, likelihood="plain")
    f = jax.jit(jax.value_and_grad(lambda t: logp_fast(t, data_sh)))

    t0 = time.time()
    compiled = f.lower(init).compile()
    elapsed = time.time() - t0
    assert elapsed < 60.0, f"GSPMD partition+compile took {elapsed:.1f}s"

    counts = _collective_counts(compiled.as_text())
    assert counts["all_reduce"] == 1, counts
    assert counts["all_gather"] == 0, counts
    assert counts["permute"] <= 30, counts

    v_f, g_f = f(init)
    v_p, g_p = jax.jit(jax.value_and_grad(lambda t: logp_plain(t, data_sh)))(init)
    np.testing.assert_allclose(float(v_f), float(v_p), rtol=2e-5)
    for k in g_p:
        np.testing.assert_allclose(
            np.asarray(g_f[k]), np.asarray(g_p[k]), rtol=2e-3, atol=2e-3,
            err_msg=k,
        )
