"""Inference engines: ADVI and NUTS on analytically known targets."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ppcseq.infer.advi import advi_sample, fit_advi, vb_iterative
from ppcseq.infer.chains import (
    chains_for_run,
    find_optimal_number_of_chains,
    mcmc_iterations,
)
from ppcseq.infer.nuts import build_warmup_schedule, run_nuts


def _gaussian_logp(mu, sd):
    mu = jnp.asarray(mu)
    sd = jnp.asarray(sd)

    def logp(theta):
        z = (theta - mu) / sd
        return -0.5 * jnp.sum(z * z) - jnp.sum(jnp.log(sd))

    return logp


def test_chain_heuristic_matches_reference_formula():
    # argmin over 2..100 of draws/chains + 150*chains (R/utilities.R:291-303)
    assert find_optimal_number_of_chains(1000) == 3  # 1000/3+450=783 vs 1000/2+300=800
    assert find_optimal_number_of_chains(100) == 2
    assert chains_for_run(1000, cores=2) == 3  # max(3, min(heuristic, cores))
    assert chains_for_run(100000, cores=8) == 8
    assert mcmc_iterations(1000, 3) == 334


def test_warmup_schedule_stan_150():
    # 150 warmup: init 75, one 25-wide window absorbing to 100, term 50
    ends, init_buf, term_buf = build_warmup_schedule(150)
    assert ends == [100] and init_buf == 75 and term_buf == 50
    # 1000 warmup: windows 25,50,100,...
    sched, _, _ = build_warmup_schedule(1000)
    assert sched[0] == 100 and sched[-1] == 950


def test_advi_recovers_gaussian():
    mu = np.array([1.5, -2.0, 0.5])
    sd = np.array([0.3, 2.0, 1.0])
    logp = _gaussian_logp(mu, sd)
    res = fit_advi(logp, 3, jax.random.PRNGKey(0), learning_rate=0.05, dtype=jnp.float64)
    np.testing.assert_allclose(res.mean, mu, atol=0.15)
    np.testing.assert_allclose(np.exp(res.log_sd), sd, rtol=0.3)
    draws = np.asarray(advi_sample(res, jax.random.PRNGKey(1), 4000, dtype=jnp.float64))
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=0.2)


def test_vb_iterative_retries_then_raises():
    calls = []

    def bad_logp(theta):
        return jnp.nan * jnp.sum(theta)

    with pytest.raises(RuntimeError, match="failed"):
        vb_iterative(bad_logp, 2, jax.random.PRNGKey(0), max_attempts=2, max_iter=200)


def test_nuts_recovers_correlated_gaussian():
    # 5-D Gaussian with varying scales: check mean/var of draws
    rng = np.random.default_rng(0)
    mu = rng.normal(size=5)
    sd = np.array([0.5, 1.0, 2.0, 0.2, 3.0])
    logp = _gaussian_logp(mu, sd)
    res = run_nuts(
        logp, 5, jax.random.PRNGKey(2),
        num_chains=4, num_warmup=300, num_draws=500, dtype=jnp.float64,
    )
    draws = res.draws.reshape(-1, 5)
    assert res.divergences.sum() == 0
    np.testing.assert_allclose(draws.mean(axis=0), mu, atol=float(4 * sd.max() / np.sqrt(2000) + 0.05))
    np.testing.assert_allclose(draws.std(axis=0), sd, rtol=0.15)
    # adapted metric should roughly match the marginal variances
    ratio = res.inv_mass.mean(axis=0) / sd**2
    assert (ratio > 0.2).all() and (ratio < 5.0).all()


def test_nuts_on_banana_no_nans():
    # Rosenbrock-like curved target: stress-test tree building
    def logp(theta):
        x, y = theta[0], theta[1]
        return -0.5 * (x**2) - 0.5 * ((y - x**2) ** 2) / 0.25

    res = run_nuts(
        logp, 2, jax.random.PRNGKey(3),
        num_chains=2, num_warmup=300, num_draws=300, dtype=jnp.float64,
    )
    assert np.isfinite(res.draws).all()
    # E[x] = 0 for this target
    assert abs(res.draws[:, :, 0].mean()) < 0.3
