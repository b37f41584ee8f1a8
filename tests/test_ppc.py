"""Posterior-predictive simulation and credible-interval extraction."""

import numpy as np

import jax
import jax.numpy as jnp

from ppcseq.ppc.rng import approximated_ci, counts_rng_draws, exact_ci, summarize_draws


def test_quantile_type7_matches_r():
    # R: quantile(1:10, c(.1,.9), type=7) == (1.9, 9.1)
    draws = jnp.arange(1.0, 11.0)[:, None, None]
    out = summarize_draws(draws, 0.1)
    assert np.isclose(out["lower"][0, 0], 1.9)
    assert np.isclose(out["upper"][0, 0], 9.1)


def test_counts_rng_moments_and_truncation_compensation():
    key = jax.random.PRNGKey(0)
    n, S, K = 60000, 2, 1
    lam = jnp.full((n, S, K), 3.0)
    sig = jnp.zeros((n, K))  # sigma_raw=0 -> phi=1
    exposure = jnp.array([0.0, 1.0])
    draws = counts_rng_draws(key, lam, sig, exposure, truncation_compensation=1.0)
    mu0, mu1 = np.exp(3.0), np.exp(4.0)
    assert abs(float(draws[:, 0, 0].mean()) - mu0) / mu0 < 0.03
    assert abs(float(draws[:, 1, 0].mean()) - mu1) / mu1 < 0.03
    # trunc_comp < 1 shrinks phi -> inflates variance, keeps mean
    draws_tc = counts_rng_draws(key, lam, sig, exposure, truncation_compensation=0.7352941)
    v = np.asarray(draws[:, 0, 0], dtype=np.float64).var()
    v_tc = np.asarray(draws_tc[:, 0, 0], dtype=np.float64).var()
    expected = mu0 + mu0**2  # phi=1
    expected_tc = mu0 + mu0**2 / 0.7352941
    assert abs(v - expected) / expected < 0.1
    assert abs(v_tc - expected_tc) / expected_tc < 0.1


def test_exact_vs_approximated_ci_agree():
    # With many actual draws, the bootstrap-supersampled CI should agree with
    # the exact-path CI on a stable quantile level.
    key = jax.random.PRNGKey(1)
    n, S, K = 4000, 3, 2
    rng = np.random.default_rng(2)
    lam = jnp.asarray(rng.normal(2.0, 0.05, size=(n, S, K)))
    sig = jnp.asarray(rng.normal(-1.0, 0.05, size=(n, K)))
    exposure = jnp.asarray(rng.normal(0, 0.1, size=S))
    ci_exact, _ = exact_ci(key, lam, sig, exposure, 0.05)
    ci_approx = approximated_ci(jax.random.PRNGKey(3), lam, sig, exposure, 0.05, 20000)
    np.testing.assert_allclose(ci_exact["mean"], ci_approx["mean"], rtol=0.05)
    np.testing.assert_allclose(ci_exact["lower"], ci_approx["lower"], rtol=0.12, atol=1.0)
    np.testing.assert_allclose(ci_exact["upper"], ci_approx["upper"], rtol=0.12, atol=1.0)


def test_approximated_ci_gene_chunking_consistent():
    # Results concatenate correctly across gene blocks
    key = jax.random.PRNGKey(4)
    n, S, K = 500, 2, 5
    lam = jnp.full((n, S, K), 1.0)
    sig = jnp.zeros((n, K))
    exposure = jnp.zeros(S)
    out = approximated_ci(key, lam, sig, exposure, 0.1, 1000)
    assert out["lower"].shape == (S, K)
    assert np.isfinite(out["mean"]).all()


def test_ci_unit_resolution_at_large_counts():
    """float32 spacing at 1e8 counts is 8 units; the quantile/mean summaries
    must still be exact to the unit (round-4 finding: summarize_draws cast
    counts to f32 before jnp.quantile — a silent precision cliff for
    deep-coverage cohorts)."""
    base = 100_000_000
    draws = jnp.asarray(base + np.arange(10), jnp.int32)[:, None, None]
    out = summarize_draws(draws, 0.1)
    # R type-7 on base+(0..9): lower = base+0.9, upper = base+8.1
    assert abs(out["lower"][0, 0] - (base + 0.9)) < 1e-4
    assert abs(out["upper"][0, 0] - (base + 8.1)) < 1e-4
    assert abs(out["mean"][0, 0] - (base + 4.5)) < 1e-4
    assert abs(out["sd"][0, 0] - np.std(np.arange(10), ddof=1)) < 1e-4


def test_exact_ci_large_counts_end_to_end():
    """exact_ci at mu ~ 1e8: bounds must be finite, ordered, and resolved
    beyond the f32 quantum (not collapsed onto 8-unit grid lines)."""
    key = jax.random.PRNGKey(7)
    n, S, K = 400, 2, 1
    lam = jnp.full((n, S, K), np.log(1e8), jnp.float32)
    sig = jnp.full((n, K), -4.0, jnp.float32)  # phi = e^4 ~ 55
    exposure = jnp.zeros(S, jnp.float32)
    ci, _ = exact_ci(key, lam, sig, exposure, 0.05, return_draws=False)
    mu, phi = 1e8, np.exp(4.0)
    sd = np.sqrt(mu + mu**2 / phi)
    assert np.all(ci["lower"] < ci["mean"]) and np.all(ci["mean"] < ci["upper"])
    assert np.all(np.abs(ci["mean"] - mu) < 4 * sd / np.sqrt(n))
    # f64 output dtype carries unit resolution at this scale
    assert ci["lower"].dtype == np.float64 and ci["upper"].dtype == np.float64


def test_topk_quantile_path_matches_numpy_type7():
    """With tail thresholds and many draws, _summarize_split takes the
    two-sided top_k path (no full sort); its quantiles must equal NumPy's
    type-7 ('linear') exactly (both are exact order statistics)."""
    rng = np.random.default_rng(5)
    n, S, K = 4096, 3, 2
    draws = jnp.asarray(rng.integers(0, 1_000_000, size=(n, S, K)), jnp.int32)
    thr = 0.001  # i0 = 4 -> top_k branch (k_lo + k_hi = 12 << n/4)
    out = summarize_draws(draws, thr)
    d64 = np.asarray(draws, np.float64)
    lo = np.quantile(d64, thr, axis=0, method="linear")
    hi = np.quantile(d64, 1 - thr, axis=0, method="linear")
    np.testing.assert_allclose(out["lower"], lo, rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["upper"], hi, rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["mean"], d64.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(out["sd"], d64.std(axis=0, ddof=1), rtol=1e-4)
