"""Analytic NB2 gradients (ops/nb_grad) vs float64 autodiff ground truth.

The analytic custom-VJP likelihood (nb_model.analytic_likelihood) replaces
autodiff through the stable-lpmf branch machinery in the sampler hot loop;
these tests pin its math to autodiff of the plain lpmf (the semantic
reference, itself scipy-verified in test_model.py).
"""

import numpy as np

import jax
import jax.numpy as jnp

from ppcseq.model import nb_model
from ppcseq.ops.nb import nb2_log_lpmf
from ppcseq.ops.nb_grad import nb2_grads, likelihood_grads


def _stress_grid():
    ys = np.array([0, 1, 3, 7, 8, 9, 50, 1000, 250000], dtype=np.int64)
    etas = np.array([-20.0, -5.0, -1.3, 0.0, 1.0, 5.0, 12.0])
    log_phis = np.array([-6.0, -2.0, 0.0, 1.0, 2.1, 5.0, 10.0, 30.0, 60.0, 79.0])
    Y, E, L = np.meshgrid(ys, etas, log_phis, indexing="ij")
    return Y.ravel(), E.ravel(), L.ravel()


def test_nb2_grads_match_mpmath():
    # Ground truth is 50-digit mpmath, NOT float64 autodiff: autodiff of the
    # plain lpmf computes digamma(y+phi) - digamma(phi) by catastrophic
    # cancellation at large phi (error ~0.03 at phi = e^30, where the true
    # gradient is ~1e-9); the contracted analytic form is exact there.
    import mpmath as mp

    mp.mp.dps = 50
    y, eta, log_phi = _stress_grid()
    want_e = np.empty(len(y))
    want_l = np.empty(len(y))
    for i in range(len(y)):
        phi = mp.e ** mp.mpf(log_phi[i])
        mu = mp.e ** mp.mpf(eta[i])
        q = phi / (mu + phi)
        want_e[i] = float(y[i] - (y[i] + phi) * mu / (mu + phi))
        want_l[i] = float(
            phi * (mp.digamma(y[i] + phi) - mp.digamma(phi))
            + phi * (1 + mp.mpf(log_phi[i]) - mp.log(mu + phi))
            - (y[i] + phi) * q
        )

    a_eta, a_lp = nb2_grads(
        jnp.asarray(y), jnp.asarray(eta, jnp.float64), jnp.asarray(log_phi, jnp.float64)
    )
    scale_e = 1.0 + np.abs(want_e)
    scale_l = 1.0 + np.abs(want_l)
    np.testing.assert_array_less(np.abs(np.asarray(a_eta) - want_e) / scale_e, 1e-9)
    # dlogphi tolerance is set by the digamma asymptotic series at its
    # smallest argument (x = 8): ~1e-8 absolute after contraction with phi
    np.testing.assert_array_less(np.abs(np.asarray(a_lp) - want_l) / scale_l, 5e-7)


def test_nb2_grads_phi_cap_and_float32_moderation():
    # beyond the forward's phi cap (log_phi = 80) the log_phi gradient is 0
    _, g_lp = nb2_grads(jnp.asarray([17]), jnp.asarray([2.0]), jnp.asarray([81.0]))
    assert float(g_lp[0]) == 0.0

    # float32 evaluation stays absolutely accurate relative to the count size
    y, eta, log_phi = _stress_grid()
    a64_eta, a64_lp = nb2_grads(
        jnp.asarray(y), jnp.asarray(eta, jnp.float64), jnp.asarray(log_phi, jnp.float64)
    )
    a32_eta, a32_lp = nb2_grads(
        jnp.asarray(y, jnp.int32),
        jnp.asarray(eta, jnp.float32),
        jnp.asarray(log_phi, jnp.float32),
    )
    # error budget: f32-relative in the gradient's own magnitude plus
    # count-amplified rounding of the contracted terms
    tol_e = 1e-5 * (1.0 + y) + 3e-6 * np.abs(np.asarray(a64_eta)) + 1e-3
    tol_l = 1e-5 * (1.0 + y) + 3e-6 * np.abs(np.asarray(a64_lp)) + 1e-3
    assert (np.abs(np.asarray(a32_eta, np.float64) - np.asarray(a64_eta)) < tol_e).all()
    assert (np.abs(np.asarray(a32_lp, np.float64) - np.asarray(a64_lp)) < tol_l).all()


def _toy(S=5, G=9, C=2, n_check=3, seed=3, exclude=False):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4000, size=(S, G)).astype(np.int32)
    X = np.column_stack([np.ones(S), rng.integers(0, 2, S).astype(float)])
    exposure = rng.normal(0.0, 0.3, S)
    excl = None
    if exclude:
        excl = np.zeros((S, G), dtype=bool)
        excl[1, 0] = excl[3, 2] = True
    return nb_model.prepare_data(
        counts, X, exposure, n_check, exclude_mask=excl, dtype=jnp.float64
    )


def test_likelihood_grads_match_autodiff_masked():
    data, dims = _toy(exclude=True)
    rng = np.random.default_rng(7)
    alpha = jnp.asarray(rng.normal(2.0, 1.0, (dims.C, dims.G)))
    log_phi = jnp.asarray(rng.normal(0.0, 1.5, dims.G))

    want = jax.grad(
        lambda a, l: nb_model.masked_likelihood(data, a, l), argnums=(0, 1)
    )(alpha, log_phi)
    got = likelihood_grads(
        data.X, data.exposure_rate, data.counts, data.like_mask, alpha, log_phi
    )
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-6, atol=1e-6)


def test_analytic_log_joint_grad_matches_plain():
    # through the full joint, both plain-stable and delta-form forwards
    for with_base in (False, True):
        data, dims = _toy(seed=11)
        if with_base:
            data = nb_model.with_baseline(data, dims)
        theta = jnp.asarray(
            np.random.default_rng(5).normal(0.0, 0.4, dims.dim), jnp.float64
        )
        g_plain = jax.grad(nb_model.log_joint)(theta, data, dims)
        g_analytic = jax.grad(
            lambda th: nb_model.log_joint(
                th, data, dims, likelihood_fn=nb_model.analytic_likelihood
            )
        )(theta)
        np.testing.assert_allclose(
            np.asarray(g_analytic), np.asarray(g_plain), rtol=1e-6, atol=1e-6
        )
        # identical forward by construction
        lp_p = nb_model.log_joint(theta, data, dims)
        lp_a = nb_model.log_joint(
            theta, data, dims, likelihood_fn=nb_model.analytic_likelihood
        )
        assert float(lp_p) == float(lp_a)
