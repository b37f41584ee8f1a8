"""Model math: NB2 lpmf vs scipy, densities vs closed forms, log-joint structure."""

import numpy as np
import pytest
import scipy.stats as st

import jax
import jax.numpy as jnp

from ppcseq.model.nb_model import (
    ModelDims,
    log_joint,
    make_alpha,
    prepare_data,
    unpack,
)
from ppcseq.ops.nb import (
    double_exponential_lpdf,
    nb2_log_lpmf,
    nb2_log_rng,
    normal_lpdf,
    skew_normal_lpdf,
)
from ppcseq.utils.constants import LAMBDA_MU_MU


def test_nb2_lpmf_matches_scipy():
    # Stan NB2(mu, phi) == scipy.nbinom(n=phi, p=phi/(phi+mu))
    rng = np.random.default_rng(0)
    y = rng.integers(0, 500, size=200)
    eta = rng.normal(2.0, 2.0, size=200)
    log_phi = rng.normal(0.0, 1.0, size=200)
    mu, phi = np.exp(eta), np.exp(log_phi)
    expected = st.nbinom.logpmf(y, phi, phi / (phi + mu))
    got = nb2_log_lpmf(jnp.asarray(y), jnp.asarray(eta, jnp.float64), jnp.asarray(log_phi, jnp.float64))
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-5, atol=1e-5)


def test_nb2_lpmf_stable_decomposition_matches_scipy():
    from ppcseq.ops.nb import nb2_log_lpmf_stable

    rng = np.random.default_rng(11)
    y = np.concatenate([rng.integers(0, 8, 500), rng.integers(8, 30000, 500)])
    eta = rng.normal(3.0, 3.0, 1000)
    log_phi = rng.normal(0.0, 3.0, 1000)
    mu, phi = np.exp(eta), np.exp(log_phi)
    want = st.nbinom.logpmf(y, phi, phi / (phi + mu))
    got = np.asarray(
        nb2_log_lpmf_stable(jnp.asarray(y), jnp.asarray(eta), jnp.asarray(log_phi))
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # float32 absolute error must stay small enough for NUTS energy diffs
    got32 = np.asarray(
        nb2_log_lpmf_stable(
            jnp.asarray(y), jnp.asarray(eta, jnp.float32), jnp.asarray(log_phi, jnp.float32)
        ),
        dtype=np.float64,
    )
    assert np.abs(got32 - want).max() < 0.05
    assert abs(got32.sum() - want.sum()) < 0.25


def test_nb2_lpmf_extreme_values_stable():
    y = jnp.array([0, 100000], dtype=jnp.int32)
    eta = jnp.array([-30.0, 30.0])
    log_phi = jnp.array([10.0, -10.0])
    out = nb2_log_lpmf(y, eta, log_phi)
    assert np.isfinite(np.asarray(out)).all()


def test_normal_and_laplace_lpdf():
    x = np.linspace(-3, 3, 7)
    np.testing.assert_allclose(
        np.asarray(normal_lpdf(jnp.asarray(x), 0.5, 2.0)),
        st.norm.logpdf(x, 0.5, 2.0),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(double_exponential_lpdf(jnp.asarray(x), 0.5, 2.0)),
        st.laplace.logpdf(x, 0.5, 2.0),
        rtol=1e-6,
    )


def test_skew_normal_lpdf_matches_scipy():
    x = np.linspace(-3, 5, 9)
    got = np.asarray(skew_normal_lpdf(jnp.asarray(x), 1.0, 2.0, 3.0))
    expected = st.skewnorm.logpdf(x, 3.0, loc=1.0, scale=2.0)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_nb2_rng_moments():
    key = jax.random.PRNGKey(0)
    eta, phi = 3.0, 2.0
    draws = nb2_log_rng(key, jnp.full((200000,), eta), jnp.full((200000,), phi))
    mu = np.exp(eta)
    var = mu + mu**2 / phi
    m, v = float(draws.mean()), float(np.asarray(draws, dtype=np.float64).var())
    assert abs(m - mu) / mu < 0.02
    assert abs(v - var) / var < 0.05


def _toy_data(S=4, G=6, C=2, n_check=2, pad_to=None, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 200, size=(S, G))
    X = np.column_stack(
        [np.ones(S)] + [rng.integers(0, 2, size=S).astype(float) for _ in range(C - 1)]
    )
    exposure = rng.normal(0, 0.2, size=S)
    return prepare_data(counts, X, exposure, n_check, pad_genes_to=pad_to, dtype=jnp.float64)


def test_unpack_roundtrip_transforms():
    _, dims = _toy_data()
    theta = np.random.default_rng(1).normal(size=dims.dim)
    params, log_jac = unpack(jnp.asarray(theta), dims)
    assert float(params["lambda_sigma"]) > 0
    assert float(params["sigma_sigma"]) > 0
    assert float(params["sigma_slope"]) < 0
    assert float(params["lambda_mu"]) == pytest.approx(theta[0] + LAMBDA_MU_MU)
    # Jacobian = sum of the three log-scale coords
    assert float(log_jac) == pytest.approx(theta[1] + theta[3] + theta[5])


def test_make_alpha_zero_padding():
    _, dims = _toy_data(C=3)
    theta = jnp.asarray(np.random.default_rng(2).normal(size=dims.dim))
    params, _ = unpack(theta, dims)
    alpha = make_alpha(params, dims)
    assert alpha.shape == (3, dims.G)
    # Control genes get zero slope/extra coefficients (stan:122-139)
    np.testing.assert_array_equal(np.asarray(alpha[1, dims.n_check :]), 0.0)
    np.testing.assert_array_equal(np.asarray(alpha[2, dims.n_check :]), 0.0)


def test_log_joint_finite_and_differentiable():
    data, dims = _toy_data()
    theta = jnp.asarray(np.random.default_rng(3).normal(size=dims.dim) * 0.1)
    lp = log_joint(theta, data, dims)
    assert np.isfinite(float(lp))
    g = jax.grad(log_joint)(theta, data, dims)
    assert np.isfinite(np.asarray(g)).all()


def test_log_joint_padding_invariance():
    """Padding genes must not change the joint density (up to the pseudo-prior)."""
    data, dims = _toy_data(pad_to=None)
    data_p, dims_p = _toy_data(pad_to=10)
    rng = np.random.default_rng(4)
    theta = rng.normal(size=dims.dim) * 0.1

    # Embed theta into the padded layout with zeros for padded coords
    theta_p = np.zeros(dims_p.dim)
    # scalars
    theta_p[:6] = theta[:6]
    # intercept
    theta_p[6 : 6 + dims.G] = theta[6 : 6 + dims.G]
    # sigma_raw
    theta_p[6 + dims_p.G : 6 + dims_p.G + dims.G] = theta[6 + dims.G : 6 + 2 * dims.G]
    # alpha_sub_1
    theta_p[6 + 2 * dims_p.G :] = theta[6 + 2 * dims.G :]

    lp = float(log_joint(jnp.asarray(theta), data, dims))
    lp_p = float(log_joint(jnp.asarray(theta_p), data_p, dims_p))
    # padded coords are 0 -> pseudo-prior contributes (G_pad - G) * logN(0|0,1)
    n_pad = dims_p.G - dims.G
    pseudo = 2 * n_pad * float(normal_lpdf(jnp.asarray(0.0), 0.0, 1.0))
    np.testing.assert_allclose(lp_p - pseudo, lp, rtol=1e-10)


def test_non_centered_is_change_of_variables():
    """NC density == centered density at the mapped point + log|Jacobian|.

    intercept = loc + lambda_sigma * t_i and sigma_raw = trend +
    sigma_sigma * t_s per real gene, so the densities differ by exactly
    G_real * (log lambda_sigma + log sigma_sigma).
    """
    rng = np.random.default_rng(7)
    S, G, n_check = 5, 8, 3
    counts = rng.integers(0, 300, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    data_c, dims_c = prepare_data(counts, X, exposure, n_check, dtype=jnp.float64)
    data_nc, dims_nc = prepare_data(
        counts, X, exposure, n_check, non_centered=True, dtype=jnp.float64
    )

    from ppcseq.model.nb_model import log_joint_tree, theta_to_tree, unpack_tree

    theta_nc = theta_to_tree(jnp.asarray(rng.normal(size=dims_nc.dim) * 0.3), dims_nc)
    params, _ = unpack_tree(theta_nc, non_centered=True)
    theta_c = dict(theta_nc)
    theta_c["intercept"] = params["intercept"]
    theta_c["sigma_raw"] = params["sigma_raw"]

    lp_nc = float(log_joint_tree(theta_nc, data_nc, dims_nc))
    lp_c = float(log_joint_tree(theta_c, data_c, dims_c))
    jac = G * (np.log(float(params["lambda_sigma"])) + np.log(float(params["sigma_sigma"])))
    # padded genes: none here (G == G_unpadded), so the identity is exact
    np.testing.assert_allclose(lp_nc - lp_c, jac, rtol=1e-9)


def test_log_joint_exclusion_mask_subtracts_lpmf():
    """Masking a point == Stan's subtract-the-lpmf truncation (stan:105-115)."""
    S, G = 4, 6
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 100, size=(S, G))
    X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
    exposure = rng.normal(0, 0.2, size=S)
    excl = np.zeros((S, G), dtype=bool)
    excl[1, 0] = True
    data0, dims = prepare_data(counts, X, exposure, 2, dtype=jnp.float64)
    data1, _ = prepare_data(counts, X, exposure, 2, exclude_mask=excl, dtype=jnp.float64)
    theta = jnp.asarray(rng.normal(size=dims.dim) * 0.1)

    lp0 = float(log_joint(theta, data0, dims))
    lp1 = float(log_joint(theta, data1, dims))

    from ppcseq.model.nb_model import lambda_log

    params, _ = unpack(theta, dims)
    eta = np.asarray(data0.exposure_rate)[:, None] + np.asarray(lambda_log(params, data0, dims))
    lpmf_point = float(
        nb2_log_lpmf(
            jnp.asarray(counts[1, 0]), jnp.asarray(eta[1, 0]), -params["sigma_raw"][0]
        )
    )
    np.testing.assert_allclose(lp0 - lp1, lpmf_point, rtol=1e-8)
