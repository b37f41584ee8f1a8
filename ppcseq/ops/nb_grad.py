"""Analytic gradients of the masked NB2-log GLM likelihood.

The sampler hot loop differentiates the likelihood of the reference Stan
model (inst/stan/negBinomial_MPI.stan:97-115) thousands of times per fit.
Autodiffing through the float32-stable branch machinery of
ops.nb.nb2_log_lpmf_stable / nb_model.delta_likelihood is correct but
expensive: XLA has to differentiate every polynomial/branch of the forward.
The analytic derivative of the NB2-log lpmf is tiny by comparison:

    d lpmf / d eta      = y - (y + phi) * sigmoid(d),          d = eta - log_phi
    d lpmf / d log_phi  = phi*(digamma(y+phi) - digamma(phi))
                          - phi*(softplus(d) - sigmoid(d)) - y*sigmoid(-d)

(the second line is the stable regrouping of Stan's
 phi*(digamma(y+phi) - digamma(phi) + 1 + log_phi - logaddexp(eta, log_phi))
 - (y+phi)*phi/(mu+phi): every term is O(y)-moderate, so the float32
 contraction keeps absolute accuracy — the raw grouping holds two O(phi)
 terms whose cancellation error would explode at large phi).

Float32-moderate building blocks:
- phi*D(y, phi), D = digamma(y+phi) - digamma(phi): exact partial-fraction
  sum for y <= 7; asymptotic digamma difference for y >= 8 (contracted
  against phi so no large-minus-large ever forms when phi >= 8; recurrence
  shift for phi < 8).
- phi*A(d), A = softplus(d) - sigmoid(d) >= 0: log-space odd series in
  u = e^d for u <= 1/4 (A ~ u^2/2, so the direct difference would be pure
  cancellation), direct evaluation elsewhere.
- phi*sigmoid(d) = exp(log_phi - softplus(-d)): never forms (y+phi)*p, so
  the eta-gradient stays exact at the phi cap.

The phi cap matches the forward (ops.nb.nb2_log_lpmf_stable caps log_phi at
80): gradients wrt log_phi vanish beyond the cap.

These feed the custom-VJP wrapper nb_model.analytic_likelihood; ground truth
for the unit tests is float64 autodiff of the plain lpmf
(tests/test_nb_grad.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ppcseq.ops.nb import _softplus, log1p_precise

LOG_PHI_CAP = 80.0


def _psi_asym(x):
    """digamma(x) for x >= 8: asymptotic series, relative error < 1e-9."""
    inv = 1.0 / x
    inv2 = inv * inv
    return (
        jnp.log(x)
        - 0.5 * inv
        - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    )


def phi_digamma_diff(yf, phi, log_phi):
    """phi * (digamma(y + phi) - digamma(phi)), float32-moderate.

    Output is O(y) for all phi (-> y as phi -> inf), never formed as a
    difference of O(phi*log(phi)) quantities.
    """
    # branch A: y <= 7 — exact: phi * sum_{k<y} 1/(phi+k)
    partA = jnp.zeros_like(phi)
    for k in range(7):
        partA = partA + jnp.where(yf > k, phi / (phi + k), 0.0)

    ys = jnp.maximum(yf, 8.0)  # keep unselected branches finite

    # branch B: y >= 8, phi >= 8 — asymptotic difference contracted with phi:
    # phi*D = phi*log1p(y/phi) + y/(2(y+phi)) + (1/12)(1/phi - phi/(y+phi)^2)
    #         - (1/120)(1/phi^3 - phi/(y+phi)^4)
    phis = jnp.maximum(phi, 8.0)
    a = ys + phis
    partB = (
        phis * log1p_precise(ys / phis)
        + 0.5 * ys / a
        + (1.0 / 12.0) * (1.0 / phis - phis / (a * a))
        - (1.0 / 120.0) * (1.0 / phis**3 - phis / (a**2) ** 2)
    )

    # branch C: y >= 8, phi < 8 — shift digamma(phi) up by 8:
    # D = psi(y+phi) - psi(phi+8) + sum_{k<8} 1/(phi+k); result is O(1)-large
    # so the plain psi difference costs no accuracy.
    phic = jnp.minimum(phi, 8.0)
    shift = jnp.zeros_like(phi)
    for k in range(8):
        shift = shift + phic / (phic + k)
    partC = phic * (_psi_asym(ys + phic) - _psi_asym(phic + 8.0)) + shift

    return jnp.where(yf <= 7.0, partA, jnp.where(phi >= 8.0, partB, partC))


def phi_softplus_minus_sigmoid(d, log_phi):
    """phi * A(d), A = softplus(d) - sigmoid(d) >= 0, accurate for all d.

    A(d) ~ u^2/2 as u = e^d -> 0, so the direct difference is pure
    cancellation there; the odd series A = u^2*(1/2 - 2u/3 + 3u^2/4 - ...)
    is evaluated in log space (phi*u^2 = exp(log_phi + 2d) never
    under/overflows spuriously).
    """
    dn = jnp.minimum(d, 0.0)
    u = jnp.exp(dn)  # e^d for d <= 0 (the only range the series is used in)
    # A/u^2 = sum_{k>=2} (-1)^k (k-1)/k u^(k-2); terms through u^6 leave
    # truncation ~(8/9)u^7 — relative error < 2e-7 at the u = 1/4 cutoff
    series = 0.5 - u * (
        2.0 / 3.0
        - u * (0.75 - u * (0.8 - u * (5.0 / 6.0 - u * (6.0 / 7.0 - u * 0.875))))
    )
    small = jnp.exp(log_phi + 2.0 * dn) * series
    em = jnp.exp(-jnp.abs(d))
    sig = jnp.where(d > 0, 1.0 / (1.0 + em), em / (1.0 + em))
    direct = jnp.exp(log_phi) * (_softplus(d) - sig)
    return jnp.where(d <= -1.386, small, direct)


def nb2_grads(y, eta, log_phi):
    """(d lpmf/d eta, d lpmf/d log_phi) of the NB2-log lpmf, elementwise.

    Matches float64 autodiff of ops.nb.nb2_log_lpmf to ~1e-12 (float64) and
    stays absolutely accurate in float32 across the prior's range
    (tests/test_nb_grad.py). log_phi is capped at LOG_PHI_CAP like the
    forward; the log_phi-gradient is 0 beyond the cap.
    """
    dtype = eta.dtype
    yf = y.astype(dtype) if jnp.issubdtype(y.dtype, jnp.integer) else y
    log_phi_c = jnp.minimum(log_phi, LOG_PHI_CAP)
    phi = jnp.exp(log_phi_c)
    d = eta - log_phi_c
    em = jnp.exp(-jnp.abs(d))
    q = jnp.where(d > 0, em / (1.0 + em), 1.0 / (1.0 + em))  # sigmoid(-d)
    # phi * sigmoid(d) in log space: exact even where sigmoid(d) underflows
    phi_p = jnp.exp(log_phi_c - _softplus(-d))
    deta = yf * q - phi_p
    dlogphi = jnp.where(
        log_phi < LOG_PHI_CAP,
        phi_digamma_diff(yf, phi, log_phi_c)
        - phi_softplus_minus_sigmoid(d, log_phi_c)
        - yf * q,
        0.0,
    )
    return deta, dlogphi


def likelihood_grads(X, exposure, counts, mask, alpha, log_phi):
    """(dalpha[C, G], dlog_phi[G]) of the masked GLM likelihood.

    eta is recomputed (one tiny matmul); the elementwise derivatives are
    contracted immediately, so no [S, G] cotangent survives the fusion.
    """
    eta = exposure[:, None] + jnp.dot(
        X, alpha, preferred_element_type=X.dtype, precision="highest"
    )
    deta, dlogphi = nb2_grads(counts, eta, jnp.broadcast_to(log_phi[None, :], eta.shape))
    deta = mask * deta
    dalpha = jnp.dot(X.T, deta, preferred_element_type=X.dtype, precision="highest")
    return dalpha, jnp.sum(mask * dlogphi, axis=0)
