"""Gene-axis sharding on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ppcseq.model import nb_model
from ppcseq.model.params import zeros_tree
from ppcseq.parallel.sharding import (
    gene_mesh,
    pad_genes,
    shard_data,
    shard_params,
)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
    S, G, C, n_check = 6, 48, 2, 4
    counts = rng.poisson(40.0, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    return counts, X, exposure, n_check


def test_mesh_and_padding():
    mesh = gene_mesh(8)
    assert mesh.shape["genes"] == 8
    assert pad_genes(515, mesh) == 520  # 65 genes on each of 8 shards
    assert pad_genes(512, mesh) == 512


def test_sharded_log_joint_matches_unsharded(tiny):
    counts, X, exposure, n_check = tiny
    mesh = gene_mesh(8)
    # pad G to a multiple of the mesh (48 -> 48 works since 48 % 8 == 0)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float64)
    theta = nb_model.smart_init(data, dims, as_tree=True)
    ld = nb_model.make_log_density(data, dims, tree=True)
    lp_plain = float(jax.jit(ld)(theta))

    data_sh = shard_data(data, mesh)
    theta_sh = shard_params(theta, mesh, dims)
    ld_sh = nb_model.make_log_density(data_sh, dims, tree=True)
    lp_sh = float(jax.jit(ld_sh)(theta_sh))
    np.testing.assert_allclose(lp_sh, lp_plain, rtol=1e-12)

    # gradients agree too
    g_plain = jax.jit(jax.grad(ld))(theta)
    g_sh = jax.jit(jax.grad(ld_sh))(theta_sh)
    for k in g_plain:
        np.testing.assert_allclose(
            np.asarray(g_sh[k]), np.asarray(g_plain[k]), rtol=1e-9, atol=1e-9
        )


def test_sharded_nuts_runs(tiny):
    from ppcseq.infer.nuts import run_nuts

    counts, X, exposure, n_check = tiny
    mesh = gene_mesh(8)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float64)
    data_sh = shard_data(data, mesh)
    ld = nb_model.make_log_density(data_sh, dims, tree=True)
    init = nb_model.smart_init(data, dims, as_tree=True)
    init_sh = shard_params(init, mesh, dims)
    res = run_nuts(
        ld, zeros_tree(dims, jnp.float64), jax.random.PRNGKey(0),
        num_chains=2, num_warmup=25, num_draws=8, max_depth=6,
        init_theta=init_sh, dtype=jnp.float64,
    )
    a1 = np.asarray(res.draws["alpha_sub_1"])
    assert a1.shape == (2, 8, n_check)
    assert np.isfinite(a1).all()


def test_gene_sharded_tree_hmc(tiny):
    """Gene-sharded tree-state jittered HMC on the 8-device mesh: the
    measurable-at-scale map_rect analog (fixed-shape scans, fast GSPMD
    partitioning — unlike the while_loop-heavy NUTS tree build)."""
    from ppcseq.infer.hmc import run_hmc_tree

    counts, X, exposure, n_check = tiny
    mesh = gene_mesh(8)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
    logp = nb_model.tree_logp(dims, likelihood="plain")
    init = nb_model.smart_init(data, dims, as_tree=True)
    res = run_hmc_tree(
        logp, zeros_tree(dims), jax.random.PRNGKey(0), data=data,
        num_chains=8, num_warmup=30, num_draws=10, num_leapfrog=8,
        init_theta=init, mesh=mesh, dims=dims,
    )
    a1 = np.asarray(res.draws["alpha_sub_1"])
    assert a1.shape == (8, 10, n_check)
    assert np.isfinite(a1).all()
    assert 0.2 < res.accept_prob.mean() <= 1.0
    ic = res.draws["intercept"]
    # per-gene draws really carry the genes sharding (leaf [chains, draws, G])
    spec = ic.sharding.spec
    assert "genes" in str(spec), spec


def test_tree_hmc_matches_flat_hmc_moments(tiny):
    """The tree-state runner is the same algorithm as the flat runner: with
    identical configs their posterior moments agree within MC error."""
    from ppcseq.infer.hmc import run_hmc, run_hmc_tree

    counts, X, exposure, n_check = tiny
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
    flat = nb_model.flat_logp(dims)
    tree = nb_model.tree_logp(dims, likelihood="plain")
    init_f = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)
    init_t = nb_model.smart_init(data, dims, as_tree=True)
    kw = dict(num_chains=16, num_warmup=60, num_draws=60, num_leapfrog=12)
    rf = run_hmc(flat, dims.dim, jax.random.PRNGKey(3), data=data, init_theta=init_f, **kw)
    rt = run_hmc_tree(tree, zeros_tree(dims), jax.random.PRNGKey(4), data=data,
                      init_theta=init_t, **kw)
    a_flat = rf.draws[:, :, 6 + 2 * dims.G : 6 + 2 * dims.G + n_check]
    a_tree = np.asarray(rt.draws["alpha_sub_1"])
    m_f, m_t = a_flat.mean(axis=(0, 1)), a_tree.mean(axis=(0, 1))
    s = a_flat.std() + 1e-3
    np.testing.assert_allclose(m_t, m_f, atol=4 * s / np.sqrt(16 * 60) * 10)


def test_chain_sharded_hmc(tiny):
    """Flagship HMC with the chain batch sharded over an 8-device mesh."""
    from jax.sharding import Mesh

    from ppcseq.infer.hmc import run_hmc

    counts, X, exposure, n_check = tiny
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
    logp = nb_model.flat_logp(dims)
    init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:8]), ("chains",))
    res = run_hmc(
        logp, dims.dim, jax.random.PRNGKey(0), data=data,
        num_chains=16, num_warmup=30, num_draws=10, num_leapfrog=8,
        init_theta=init, mesh=mesh,
    )
    assert res.draws.shape == (16, 10, dims.dim)
    assert np.isfinite(res.draws).all()
    assert 0.2 < res.accept_prob.mean() <= 1.0


def test_graft_entry_dryrun():
    """entry() in-process; dryrun_multichip(8) in a FRESH subprocess.

    The dryrun runs the full GSPMD-partitioned pipeline on the 8-virtual-
    device mesh; executed in-process after ~115 other tests, the XLA CPU
    runtime intermittently aborts natively (observed twice at the same
    block_until_ready, never when fresh). The driver invokes the dryrun in
    its own process anyway, so a subprocess mirrors the real contract AND
    removes the suite-state dependence.
    """
    import os
    import subprocess
    import sys

    import __graft_entry__ as ge

    fn, args = ge.entry()
    lp, grad = jax.jit(fn)(*args)
    assert np.isfinite(float(lp))

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8",
    )
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import jax; jax.config.update('jax_platforms', 'cpu');"
            "import __graft_entry__ as ge; ge.dryrun_multichip(8)",
        ],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, f"dryrun failed:\n{proc.stdout}\n{proc.stderr}"
    assert "dryrun_multichip OK" in proc.stdout


def test_gene_sharded_nuts_2d_mesh_shards_chains(tiny):
    """run_nuts(mesh=, dims=) on a ('chains', 'genes') 2-D mesh: per-gene
    draws carry the genes sharding and the chain batch is device-sharded
    (round-4 finding: the pipeline rounded the chain count up to the chain
    axis but called run_nuts without the mesh, so nothing sharded)."""
    from jax.sharding import Mesh

    from ppcseq.infer.nuts import run_nuts

    counts, X, exposure, n_check = tiny
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("chains", "genes"))
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
    logp = nb_model.tree_logp(dims, likelihood="plain")
    init = nb_model.smart_init(data, dims, as_tree=True)
    res = run_nuts(
        logp, zeros_tree(dims), jax.random.PRNGKey(0), data=data,
        num_chains=4, num_warmup=10, num_draws=4, max_depth=5,
        init_theta=init, mesh=mesh, dims=dims,
    )
    a1 = np.asarray(res.draws["alpha_sub_1"])
    assert a1.shape == (4, 4, n_check)
    assert np.isfinite(a1).all()
    ic = res.draws["intercept"]  # [chains, draws, G]
    spec = str(ic.sharding.spec)
    assert "genes" in spec, spec
    assert "chains" in spec, spec
