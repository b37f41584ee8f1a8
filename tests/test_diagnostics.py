"""split-R-hat / ESS diagnostics (infer/diagnostics.py)."""

import numpy as np

from ppcseq.infer.diagnostics import ess, split_rhat, summarize


def test_rhat_iid_near_one():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 1000))
    assert abs(split_rhat(x) - 1.0) < 0.02


def test_rhat_detects_unconverged_chains():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 500))
    x[0] += 5.0  # one chain stuck elsewhere
    assert split_rhat(x) > 1.5


def test_ess_iid_close_to_n():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 2000))
    total = 4 * 2000
    assert 0.5 * total < ess(x) < 1.5 * total


def test_ess_autocorrelated_much_smaller():
    rng = np.random.default_rng(3)
    # AR(1) with phi = 0.95 -> ESS ~ N * (1-phi)/(1+phi) ~ N/39
    phi = 0.95
    n = 4000
    x = np.zeros((4, n))
    eps = rng.normal(size=(4, n))
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    total = 4 * n
    e = ess(x)
    assert e < total / 10
    assert e > total / 200


def test_vector_and_summary():
    rng = np.random.default_rng(4)
    draws = rng.normal(size=(4, 500, 3))
    s = summarize(draws, names=["a", "b", "c"])
    assert s["rhat"].shape == (3,)
    assert s["ess"].shape == (3,)
    assert s["rhat_max"] < 1.05
    assert s["worst_rhat_name"] in {"a", "b", "c"}


def test_hmc_draws_pass_diagnostics():
    """The flagship sampler's output on a Gaussian is well-mixed."""
    import jax
    import jax.numpy as jnp

    from ppcseq.infer.hmc import run_hmc

    D = 4
    def logp(x):
        return -0.5 * jnp.sum(x * x)

    res = run_hmc(
        logp, D, jax.random.PRNGKey(0),
        num_chains=8, num_warmup=100, num_draws=300, num_leapfrog=12,
    )
    s = summarize(res.draws)
    assert s["rhat_max"] < 1.05
    assert s["ess_min"] > 8 * 300 / 10
