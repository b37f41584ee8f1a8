"""Simulation-based calibration (SBC) of the flagship inference path.

Talts et al. 2018: draw parameters from the model's own prior, simulate
counts from the likelihood, fit the posterior with the pipeline's flagship
sampler (ADVI warm start -> jittered HMC, as pipeline/identify.py's
do_inference configures it), and take the rank of each true quantity among
near-independent posterior draws (the final draw of each chain). If the
joint density (model/nb_model.py, mirroring
inst/stan/negBinomial_MPI.stan:180-258) and the sampler are both correct,
ranks are uniform on {0..L}; a ∪-shaped histogram means the posterior is
too narrow (the failure mode that would manufacture spurious outlier
calls), ∩-shaped too wide. The reference has no calibration test at all.

Design notes, earned the hard way (this suite caught a real density bug —
the delta-form likelihood's increment cancellation exploding at the prior's
extreme-precision corner, now fixed in nb_model.delta_likelihood):

- Counts are simulated via the exact Gamma-Poisson mixture: numpy's
  negative_binomial computes p = phi/(phi+mu), which rounds to 1.0 once the
  prior-drawn precision exceeds ~1e16*mu and silently returns all-zero
  counts — data inconsistent with the simulated truth.
- The fit uses the non-centered parametrization. Prior-drawn datasets are
  routinely sigma_raw-unidentified (the steep overdispersion trend puts
  genes in the Poisson limit, where the likelihood is flat in sigma_raw),
  and centered HMC cannot descend the resulting hierarchical funnel — the
  pipeline's centered default is a deliberate choice for the data-informed
  regime (identify.py:101-104), not for prior-drawn data.
- Raw sigma_raw ranks are NOT asserted: below the Poisson ceiling the
  posterior places that coordinate by prior alone, and the predictive
  distribution is invariant to it — the identified content of the
  dispersion is covered by the held-out predictive ranks instead.
- Predictive calibration uses HELD-OUT cells, excluded from the likelihood
  through the same exclusion mask machinery as the pipeline's pass-2
  truncation (prepare_data(exclude_mask=...), stan:105-115 analog). Ranks
  of in-sample cells would be conservative (data used twice); held-out
  counts are exactly exchangeable with predictive draws, so this also
  exercises the truncation path end-to-end.

Deterministic: fixed seed set (scanned so prior-predictive counts stay
within int32), one compile shared by all replications.
"""

import numpy as np
import pytest
import scipy.stats

import jax
import jax.numpy as jnp

from ppcseq.model import nb_model
from ppcseq.model.nb_model import LAMBDA_MU_MU
from ppcseq.infer.advi import fit_advi
from ppcseq.infer.hmc import run_hmc
from ppcseq.ops.nb import nb2_log_rng

S, G, N_CHECK = 10, 14, 5
N_REP = 20
SEED_BASE = 18_000  # scanned: max prior-predictive count 8.1e7 << int32
N_CHAINS = 64  # L = 64 -> ranks in {0..64}
N_BINS = 5  # 65 rank values / 5 bins = 13 per bin
HOLD_S = (1, 6)  # sample rows held out of the likelihood per checked gene


def _prior_sim(rng, X, exposure):
    """One draw from the model's exact prior + likelihood (stan:210-258)."""
    lam_mu = rng.normal(LAMBDA_MU_MU, 2.0)
    lam_sig = abs(rng.normal(0.0, 2.0))  # exp-transformed ~ half-N(0,2)
    lam_skew = rng.normal(0.0, 1.0)
    sig_slope = -abs(rng.normal(0.0, 2.0))  # constrained negative
    sig_int = rng.normal(0.0, 2.0)
    sig_sig = abs(rng.normal(0.0, 2.0))
    # skew_normal(xi, omega, alpha) via the delta representation
    delta = lam_skew / np.sqrt(1.0 + lam_skew**2)
    u0, v = np.abs(rng.normal(size=G)), rng.normal(size=G)
    z = delta * u0 + np.sqrt(1.0 - delta**2) * v
    # double lambda_mu_mu shift, exactly as the joint density (stan:219)
    intercept = (lam_mu + LAMBDA_MU_MU) + lam_sig * z
    sigma_raw = rng.normal(sig_slope * intercept + sig_int, sig_sig)
    alpha1 = rng.laplace(0.0, 1.0, size=N_CHECK)
    alpha = np.zeros((2, G))
    alpha[0] = intercept
    alpha[1, :N_CHECK] = alpha1
    mu = np.exp(exposure[:, None] + X @ alpha)
    phi = np.broadcast_to(np.exp(-sigma_raw), mu.shape)
    counts = rng.poisson(rng.gamma(phi, mu / phi))
    truth = {"intercept": intercept, "alpha_sub_1": alpha1}
    return counts, truth


@pytest.fixture(scope="module")
def sbc_ranks():
    rng0 = np.random.default_rng(0)
    group = (np.arange(S) >= S // 2).astype(float)
    X = np.column_stack([np.ones(S), group])
    exposure = rng0.normal(0.0, 0.2, size=S)
    exclude = np.zeros((S, G), dtype=bool)
    for s in HOLD_S:
        exclude[s, :N_CHECK] = True
    tie_rng = np.random.default_rng(777)

    ranks = {"alpha_sub_1": [], "intercept": [], "predictive": []}
    for rep in range(N_REP):
        rng = np.random.default_rng(SEED_BASE + rep)
        counts, truth = _prior_sim(rng, X, exposure)
        assert counts.max() < np.iinfo(np.int32).max
        data, dims = nb_model.prepare_data(
            counts, X, exposure, N_CHECK,
            exclude_mask=exclude, non_centered=True, dtype=jnp.float64,
        )
        data = nb_model.with_baseline(data, dims)
        logp = nb_model.flat_logp(dims)
        init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float64)
        key = jax.random.PRNGKey(rep)
        warm = fit_advi(
            logp, dims.dim, jax.random.fold_in(key, 99), data=data,
            init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
            eval_every=50, grad_samples=4, dtype=jnp.float64,
        )
        res = run_hmc(
            logp, dims.dim, key, data=data,
            num_chains=N_CHAINS, num_warmup=600, num_draws=40,
            num_leapfrog=32, init_theta=warm.mean,
            inv_mass=np.exp(2.0 * np.asarray(warm.log_sd)),
            dtype=jnp.float64,
        )
        # final draw of each chain: L near-independent posterior samples
        thetas = jnp.asarray(res.draws[:, -1, :])
        con = jax.vmap(lambda th: nb_model.unpack(th, dims)[0])(thetas)
        for name in ("alpha_sub_1", "intercept"):
            d = np.asarray(con[name])[:, :N_CHECK]
            t = truth[name][:N_CHECK]
            ranks[name].append((d < t[None, :]).sum(axis=0))
        # held-out predictive ranks (the counts_rng machinery, stan:259-266)
        al = jax.vmap(lambda p: nb_model.make_alpha(p, dims))(con)
        eta = jnp.einsum("sc,lcg->lsg", data.X, al) + data.exposure_rate[None, :, None]
        phi_d = jnp.exp(-con["sigma_raw"])
        keys = jax.random.split(jax.random.fold_in(key, 5), N_CHAINS)
        yrep = jax.vmap(lambda k, e, p: nb2_log_rng(k, e, p[None, :]))(keys, eta, phi_d)
        yrep = np.asarray(yrep)[:, :, :N_CHECK]  # [L, S, K]
        for s in HOLD_S:
            y = counts[s, :N_CHECK]
            less = (yrep[:, s, :] < y[None, :]).sum(axis=0)
            eq = (yrep[:, s, :] == y[None, :]).sum(axis=0)
            # discrete ties broken uniformly (standard SBC practice)
            ranks["predictive"].append(
                less + (tie_rng.random(N_CHECK) * (eq + 1)).astype(int)
            )
    return {k: np.concatenate(v) for k, v in ranks.items()}


def _chi2(r):
    edges = np.linspace(0, N_CHAINS + 1, N_BINS + 1)
    obs, _ = np.histogram(r, bins=edges)
    exp = len(r) / N_BINS
    return float(((obs - exp) ** 2 / exp).sum()), obs


@pytest.mark.parametrize("name", ["alpha_sub_1", "intercept", "predictive"])
def test_sbc_rank_uniformity(sbc_ranks, name):
    """Chi-square on binned SBC ranks. The bar is generous (p ~ 1e-4 at
    nominal df, and ranks pooled within one replication are positively
    correlated through the shared fit, inflating the statistic further) so
    only systematic miscalibration fails, not MCMC noise — the bug this
    suite caught scored chi2 = 127 on a bar of 22."""
    r = sbc_ranks[name]
    chi2, obs = _chi2(r)
    bar = scipy.stats.chi2.isf(1e-4, df=N_BINS - 1) * 2.0  # correlation slack
    assert chi2 < bar, (name, chi2, bar, obs.tolist())


def test_sbc_posterior_not_too_narrow(sbc_ranks):
    """The ∪-shape check on held-out predictive ranks: extreme ranks (truth
    outside all draws) must not dominate. Under uniformity each extreme
    value {0, L} has mass 2/(L+1) ≈ 3.1%; a too-narrow predictive — the
    failure mode that would manufacture spurious outlier calls — piles mass
    there."""
    for name in ("predictive", "alpha_sub_1"):
        r = sbc_ranks[name]
        extreme = float(np.mean((r == 0) | (r == N_CHAINS)))
        assert extreme < 0.15, (name, extreme)
