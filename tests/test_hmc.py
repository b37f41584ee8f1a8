"""Jittered-trajectory HMC sampler (infer/hmc.py) statistical correctness."""

import jax
import jax.numpy as jnp
import numpy as np

from ppcseq.infer.hmc import run_hmc


def test_hmc_correlated_gaussian_moments():
    D = 8
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D))
    cov = A @ A.T / D + np.eye(D) * 0.5
    prec = jnp.asarray(np.linalg.inv(cov))
    mu = rng.normal(size=D)
    muj = jnp.asarray(mu)

    def logp(x):
        d = x - muj
        return -0.5 * d @ prec @ d

    res = run_hmc(
        logp, D, jax.random.PRNGKey(0),
        num_chains=64, num_warmup=200, num_draws=500, num_leapfrog=16,
        inv_mass=jnp.asarray(np.diag(cov)),
    )
    assert res.divergences.sum() == 0
    assert 0.6 < res.accept_prob.mean() < 0.99
    draws = res.draws.reshape(-1, D)
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=0.08)
    np.testing.assert_allclose(
        np.cov(draws.T), cov, atol=0.1 * np.abs(cov).max()
    )


def test_chees_adaptive_trajectory_gaussian():
    """adapt_trajectory=True finds a good T on a correlated Gaussian."""
    D = 8
    rng = np.random.default_rng(5)
    A = rng.normal(size=(D, D))
    cov = A @ A.T / D + np.eye(D) * 0.5
    prec = jnp.asarray(np.linalg.inv(cov))
    mu = rng.normal(size=D)
    muj = jnp.asarray(mu)

    def logp(x):
        d = x - muj
        return -0.5 * d @ prec @ d

    res = run_hmc(
        logp, D, jax.random.PRNGKey(1),
        num_chains=64, num_warmup=300, num_draws=400, num_leapfrog=64,
        adapt_trajectory=True, inv_mass=jnp.asarray(np.diag(cov)),
    )
    assert res.trajectory_length is not None and res.trajectory_length > 0
    assert res.divergences.sum() == 0
    draws = res.draws.reshape(-1, D)
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=0.1)
    from ppcseq.infer.diagnostics import summarize

    s = summarize(res.draws)
    assert s["rhat_max"] < 1.05


def test_snaper_targets_slow_directions():
    """The round-1 ChEES failure mode: many fast coordinates + a few slow
    ones. The full-norm criterion was dominated by the fast block and
    settled ~3x short; the SNAPER projection criterion must adapt T to the
    SLOW scale (regression for infer/hmc.py trajectory adaptation)."""
    D_fast, D_slow, slow_sd = 195, 5, 10.0
    var = np.ones(D_fast + D_slow)
    var[D_fast:] = slow_sd**2
    prec = jnp.asarray(1.0 / var)

    def logp(x):
        return -0.5 * jnp.sum(x * x * prec)

    res = run_hmc(
        logp, D_fast + D_slow, jax.random.PRNGKey(3),
        num_chains=64, num_warmup=300, num_draws=300, num_leapfrog=64,
        adapt_trajectory=True,  # unit mass matrix: the slow block is 10x wider
    )
    # optimal T for the slow block ~ slow_sd * pi/2 ~ 15.7; the fast block
    # alone would prefer T ~ 1.6. Require T to be well past the fast scale.
    assert res.trajectory_length > 5.0, res.trajectory_length
    from ppcseq.infer.diagnostics import summarize

    s = summarize(res.draws[:, :, D_fast:])  # the slow block must mix
    assert s["rhat_max"] < 1.1, s
    slow_draws = res.draws.reshape(-1, D_fast + D_slow)[:, D_fast:]
    np.testing.assert_allclose(slow_draws.std(axis=0), slow_sd, rtol=0.25)


def test_hmc_nb_model_agrees_with_advi():
    """On a small NB model, HMC posterior means match the ADVI means."""
    from ppcseq.infer.advi import fit_advi
    from ppcseq.model import nb_model

    rng = np.random.default_rng(1)
    S, G, n_check = 8, 24, 4
    counts = rng.poisson(np.exp(rng.normal(4.0, 1.0, size=(1, G))), size=(S, G))
    X = np.column_stack([np.ones(S), (np.arange(S) >= S // 2).astype(float)])
    exposure = rng.normal(0.0, 0.1, size=S)
    data, dims = nb_model.prepare_data(counts, X, exposure, n_check)
    logp = nb_model.make_log_density(data, dims)
    init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)

    warm = fit_advi(logp, dims.dim, jax.random.PRNGKey(2), init_mean=init,
                    tol_rel_obj=0.01, learning_rate=0.2)
    inv_mass = np.exp(2.0 * warm.log_sd)
    res = run_hmc(
        logp, dims.dim, jax.random.PRNGKey(3),
        num_chains=32, num_warmup=150, num_draws=200, num_leapfrog=24,
        init_theta=warm.mean, inv_mass=inv_mass, target_accept=0.95,
    )
    # weak-data hierarchy is funnel-ish; bound the divergence rate
    assert res.divergences.sum() <= 0.01 * res.draws.shape[0] * res.draws.shape[1]
    hmc_mean = res.draws.reshape(-1, dims.dim).mean(axis=0)
    # intercept block should agree closely (both target the same posterior)
    o = nb_model._offsets(dims)
    lo, hi = o["intercept"]
    np.testing.assert_allclose(
        hmc_mean[lo:hi], np.asarray(warm.mean)[lo:hi], atol=0.25
    )
