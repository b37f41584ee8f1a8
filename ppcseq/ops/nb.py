"""Negative-binomial (NB2) log-pmf and related densities, plain-JAX reference.

These are the mathematical primitives of the reference's Stan model
(inst/stan/negBinomial_MPI.stan:97-115, 210-223), written as pure JAX
functions. `ppcseq.ops.nb_fast` and `ppcseq.ops.nb_grad` provide the
fused value+gradient forms of the hot likelihood reduction; this module is
the semantic reference.

Stan's NB2 parametrization: mean mu = exp(eta), precision phi;
Var = mu + mu^2 / phi.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

LOG2 = 0.6931471805599453
LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def nb2_log_lpmf(y, eta, log_phi):
    """log NegBinomial2(y | mu=exp(eta), phi=exp(log_phi)), elementwise.

    Matches Stan neg_binomial_2_log_lpmf (stan:98-103):
      lgamma(y+phi) - lgamma(phi) - lgamma(y+1)
      + phi*log_phi + y*eta - (y+phi)*logaddexp(eta, log_phi)
    """
    phi = jnp.exp(log_phi)
    yf = y.astype(eta.dtype) if jnp.issubdtype(y.dtype, jnp.integer) else y
    log_mu_phi = jnp.logaddexp(eta, log_phi)
    return (
        gammaln(yf + phi)
        - gammaln(phi)
        - gammaln(yf + 1.0)
        + phi * log_phi
        + yf * eta
        - (yf + phi) * log_mu_phi
    )


def nb2_log_lpmf_stable(y, eta, log_phi):
    """NB2-log lpmf decomposed into float32-moderate terms.

    Mathematically identical to nb2_log_lpmf, but every intermediate stays
    O(|lpmf|)-moderate so a float32 sum over millions of points keeps
    absolute accuracy ~1e-1 instead of ~1e1 — NUTS energy differences need
    this (the naive form's partials reach 1e7 and f32 resolution there is
    ~1, which silently destroys U-turn/acceptance statistics).

        lpmf = part1 + phi*(log_phi - L) + y*(eta - L),  L = logaddexp(eta, log_phi)
        part1 = lgamma(y+phi) - lgamma(y+1) - lgamma(phi)   [log binomial coeff]

    part1 branches:
      y <= 7:          sum_{k<y} [log(phi+k) - log(k+1)]           (exact)
      y >= 8, phi >= 8: fully-cancelled Stirling difference:
        (a2-.5)*log1p(d/a2) + (phi-1)*log1p(y/phi) - .5*log(phi)
        + 1 - .5*log(2*pi) + series corrections, a2=y+1, d=phi-1
      y >= 8, phi < 8:  Stirling difference for the y-pair minus lgamma(phi)

    Uses only exp/log/log1p.
    """
    dtype = eta.dtype
    yf = y.astype(dtype) if jnp.issubdtype(y.dtype, jnp.integer) else y
    # evaluate as NB with phi capped at e^80: keeps phi finite in float32 at
    # extreme precisions (the NB is within O(y^2*e^-80) of its Poisson limit
    # there, far below either float's resolution)
    log_phi = jnp.minimum(log_phi, 80.0)
    phi = jnp.exp(log_phi)
    # Never form L = logaddexp(eta, log_phi) at its own magnitude: the small
    # quantities (eta - L) and (log_phi - L) are computed directly via
    # softplus so their float32 error stays relative to their OWN size —
    # multiplying by counts up to ~1e5 would otherwise amplify the ~1e-6
    # cancellation error of (eta - L) into O(0.1) log-density roughness,
    # which wrecks NUTS step-size adaptation in float32.
    d = eta - log_phi
    part23 = -phi * _softplus(d) - yf * _softplus(-d)
    return nb2_part1(yf, phi, log_phi) + part23


def nb2_part1(yf, phi, log_phi):
    """lgamma(y+phi) - lgamma(y+1) - lgamma(phi), float32-moderate branches.

    See nb2_log_lpmf_stable for the branch derivations.
    """
    # --- branch A: y <= 7 (exact product form) -------------------------
    partA = jnp.zeros_like(phi)
    for k in range(7):
        partA = partA + jnp.where(
            yf > k, jnp.log(phi + k) - LOG_KP1[k], 0.0
        )

    # --- Stirling difference for lgamma(y+phi) - lgamma(y+1), y >= 8 ---
    d = phi - 1.0
    ys = jnp.maximum(yf, 8.0)  # keep the unused branch finite
    a1s = ys + phi
    a2s = ys + 1.0
    corr12 = (1.0 / 12.0) * (1.0 / a1s - 1.0 / a2s)
    corr360 = (-1.0 / 360.0) * (1.0 / a1s**3 - 1.0 / a2s**3)
    pair = (a2s - 0.5) * log1p_precise(d / a2s) + corr12 + corr360

    # --- branch B: y >= 8, phi >= 8 (fully cancelled) ------------------
    phis = jnp.maximum(phi, 8.0)
    partB = (
        pair
        + (phis - 1.0) * log1p_precise(ys / phis)
        - 0.5 * jnp.log(phis)
        + 1.0
        - 0.5 * jnp.log(2.0 * jnp.pi)
        - 1.0 / (12.0 * phis)
        + 1.0 / (360.0 * phis**3)
    )

    # --- branch C: y >= 8, phi < 8 -------------------------------------
    partC = pair + d * jnp.log(a1s) - d - _lgamma_pos_small(jnp.minimum(phi, 8.0))

    return jnp.where(yf <= 7.0, partA, jnp.where(phi >= 8.0, partB, partC))


# log(k+1) for k = 0..6
LOG_KP1 = [0.0] + [math.log(k + 1) for k in range(1, 7)]


def log1p_precise(u):
    """log(1+u) with float32-relative accuracy on every backend.

    A backend's native log1p may be a coarse approximation (~2.6e-4
    relative error was seen on an earlier accelerator, vs ~1e-7 on CPU) —
    fatal when the result is multiplied by counts ~1e4. For
    -1/3 < u < 1/2 use log1p(u) = 2*atanh(u/(2+u)) with an odd polynomial
    (exact to f32 for |z| <= 0.2; the asymmetric u-bounds map to |z| <= 0.2
    on BOTH sides — a symmetric |u| < 0.5 cut would let z reach -1/3 where
    the truncated series is only ~6e-7 accurate); outside, plain log(1+u)
    has its argument far from 1 where a plain log is accurate.
    """
    z = u / (2.0 + u)
    z2 = z * z
    small = 2.0 * z * (1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0 + z2 / 9.0))))
    return jnp.where((u > -1.0 / 3.0) & (u < 0.5), small, jnp.log(1.0 + u))


def expm1_precise(x):
    """exp(x)-1 with float32-relative accuracy on every backend.

    A native expm1 may have ~9e-5 relative error; for |x| < 0.35 use the
    Taylor polynomial (error < 1e-7 relative), else exp(x)-1 (no
    cancellation there).
    """
    p = x * (1.0 + x * (0.5 + x * (1.0 / 6.0 + x * (1.0 / 24.0 + x * (1.0 / 120.0 + x * (1.0 / 720.0 + x / 5040.0))))))
    return jnp.where(jnp.abs(x) < 0.35, p, jnp.exp(x) - 1.0)


def _softplus(x):
    """log(1 + exp(x)), stable for both signs, with log1p_precise."""
    return jnp.where(x > 0, x, 0.0) + log1p_precise(jnp.exp(-jnp.abs(x)))


def _lgamma_pos_small(x):
    """lgamma for 0 < x <= 8 via shift-by-8 Stirling (moderate output)."""
    xs = x + 8.0
    inv = 1.0 / xs
    inv2 = inv * inv
    stirling = (
        (xs - 0.5) * jnp.log(xs)
        - xs
        + 0.5 * jnp.log(2.0 * jnp.pi)
        + inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)))
    )
    shift = jnp.zeros_like(x)
    for k in range(8):
        shift = shift + jnp.log(x + k)
    return stirling - shift


def normal_lpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - jnp.log(sigma) - LOG_SQRT_2PI


def skew_normal_lpdf(x, xi, omega, alpha):
    """Stan skew_normal_lpdf: log(2) + normal_lpdf(x|xi,omega) + log Phi(alpha*z)."""
    z = (x - xi) / omega
    return LOG2 + normal_lpdf(x, xi, omega) + jax.scipy.special.log_ndtr(alpha * z)


def double_exponential_lpdf(x, mu, sigma):
    return -jnp.abs(x - mu) / sigma - jnp.log(2.0 * sigma)


def nb2_log_rng(key, eta, phi):
    """Sample NegBinomial2(mu=exp(eta), phi) via Gamma-Poisson mixture.

    Matches Stan neg_binomial_2_log_rng semantics (stan:259-265): draw
    rate ~ Gamma(shape=phi, rate=phi/mu), then Poisson(rate). Implemented as
    rate = mu/phi * Gamma(shape=phi, rate=1).
    """
    k_gamma, k_pois = jax.random.split(key)
    g = jax.random.gamma(k_gamma, phi, shape=jnp.broadcast_shapes(jnp.shape(eta), jnp.shape(phi)))
    rate = jnp.exp(eta) / phi * g
    return jax.random.poisson(k_pois, rate)
