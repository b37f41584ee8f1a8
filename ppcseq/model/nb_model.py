"""The hierarchical negative-binomial GLM, as a pure JAX log-joint.

Reproduces the statistical model of the reference Stan program
(inst/stan/negBinomial_MPI.stan; see SURVEY.md §2.2) with a dense [S, G]
layout instead of Stan's ragged map_rect shards:

Parameters (stan:180-199) and their unconstrained transforms:
  lambda_mu        real, offset = lambda_mu_mu          (stan:183)
  lambda_sigma     > 0 (exp transform)                  (stan:184)
  lambda_skew      real                                 (stan:185)
  intercept[G]     real                                 (stan:188)
  alpha_sub_1[K]   real, K = n_check                    (stan:189)
  alpha_2[C-2, K]  real (only when C > 2)               (stan:190)
  sigma_raw[G]     real                                 (stan:191)
  sigma_slope      < 0 (negative-exp transform)         (stan:195)
  sigma_intercept  real                                 (stan:196)
  sigma_sigma      > 0 (exp transform)                  (stan:197)

Transformed (stan:200-206): sigma = 1/exp(sigma_raw); alpha[C,G] merges
intercept with zero-padded slope/extra coefficients (control genes get 0);
lambda_log_param = X @ alpha.

Priors (stan:210-223), including the double lambda_mu_mu shift of the
skew-normal intercept prior and the mean-overdispersion trend
sigma_raw ~ N(sigma_slope*intercept + sigma_intercept, sigma_sigma).

Likelihood (stan:97-115): counts ~ NB2_log(exposure + lambda_log_param,
sigma) with excluded (outlier) points masked out — the dense-mask equivalent
of Stan's subtract-the-lpmf-again truncation (stan:105-115).

Gene padding: G may be padded (for sharding / tile alignment); padded genes
carry a standard-normal pseudo-prior on their unconstrained coordinates so
samplers stay well-conditioned, and contribute nothing to the likelihood or
the hierarchical priors.
"""

from __future__ import annotations

from dataclasses import dataclass
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ppcseq.ops.nb import (
    double_exponential_lpdf,
    nb2_log_lpmf,
    nb2_log_lpmf_stable,
    normal_lpdf,
    skew_normal_lpdf,
)
from ppcseq.utils.constants import LAMBDA_MU_MU


@dataclass(frozen=True)
class ModelDims:
    """Static dimensions (and parametrization) of one fit."""

    S: int  # samples
    G: int  # genes incl. negative controls (possibly padded)
    C: int  # design-matrix columns
    n_check: int  # genes under test; G indices [0, n_check)
    G_unpadded: int  # real genes; [G_unpadded, G) are padding
    # Non-centered parametrization of the gene-level hierarchy: the tree's
    # intercept/sigma_raw leaves hold standardized residuals (tildes) and the
    # centered values are reconstructed inside unpack. Pure reparametrization
    # (identical posterior over constrained quantities) that removes the
    # hierarchical funnel — NUTS trajectories shorten by orders of magnitude.
    non_centered: bool = False

    @property
    def n_alpha2(self) -> int:
        return max(0, self.C - 2) * self.n_check

    @property
    def dim(self) -> int:
        """Unconstrained parameter dimension."""
        return 6 + 2 * self.G + self.n_check + self.n_alpha2


# Offsets into the flat unconstrained vector
def _offsets(d: ModelDims):
    o = {}
    pos = 0
    for name, size in [
        ("lambda_mu", 1),
        ("lambda_sigma", 1),
        ("lambda_skew", 1),
        ("sigma_slope", 1),
        ("sigma_intercept", 1),
        ("sigma_sigma", 1),
        ("intercept", d.G),
        ("sigma_raw", d.G),
        ("alpha_sub_1", d.n_check),
        ("alpha_2", d.n_alpha2),
    ]:
        o[name] = (pos, pos + size)
        pos += size
    return o


def theta_to_tree(theta: jnp.ndarray, dims: ModelDims) -> dict:
    """Flat unconstrained vector -> unconstrained pytree (model/params.py layout)."""
    o = _offsets(dims)

    def seg(name):
        lo, hi = o[name]
        return theta[lo:hi]

    tree = {
        "lambda_mu": seg("lambda_mu")[0],
        "lambda_sigma": seg("lambda_sigma")[0],
        "lambda_skew": seg("lambda_skew")[0],
        "sigma_slope": seg("sigma_slope")[0],
        "sigma_intercept": seg("sigma_intercept")[0],
        "sigma_sigma": seg("sigma_sigma")[0],
        "intercept": seg("intercept"),
        "sigma_raw": seg("sigma_raw"),
        "alpha_sub_1": seg("alpha_sub_1"),
    }
    if dims.C > 2:
        tree["alpha_2"] = seg("alpha_2").reshape(dims.C - 2, dims.n_check)
    return tree


def tree_to_theta(tree: dict, dims: ModelDims) -> jnp.ndarray:
    parts = [
        jnp.reshape(tree[n], (1,))
        for n in ("lambda_mu", "lambda_sigma", "lambda_skew", "sigma_slope",
                  "sigma_intercept", "sigma_sigma")
    ]
    parts += [tree["intercept"], tree["sigma_raw"], tree["alpha_sub_1"]]
    if dims.C > 2:
        parts.append(tree["alpha_2"].reshape(-1))
    return jnp.concatenate(parts)


def unpack_tree(tree: dict, non_centered: bool = False) -> tuple[dict, jnp.ndarray]:
    """Unconstrained pytree -> constrained parameters + log-Jacobian.

    With non_centered=True, the intercept/sigma_raw leaves are standardized
    residuals: intercept = (lambda_mu + lambda_mu_mu) + lambda_sigma * t_i,
    sigma_raw = sigma_slope*intercept + sigma_intercept + sigma_sigma * t_s.
    """
    u_lambda_sigma = tree["lambda_sigma"]
    u_sigma_slope = tree["sigma_slope"]
    u_sigma_sigma = tree["sigma_sigma"]
    lambda_mu = tree["lambda_mu"] + LAMBDA_MU_MU
    lambda_sigma = jnp.exp(u_lambda_sigma)
    sigma_slope = -jnp.exp(u_sigma_slope)
    sigma_sigma = jnp.exp(u_sigma_sigma)
    if non_centered:
        intercept = (lambda_mu + LAMBDA_MU_MU) + lambda_sigma * tree["intercept"]
        sigma_raw = (
            sigma_slope * intercept + tree["sigma_intercept"] + sigma_sigma * tree["sigma_raw"]
        )
    else:
        intercept = tree["intercept"]
        sigma_raw = tree["sigma_raw"]
    params = {
        "lambda_mu": lambda_mu,
        "lambda_sigma": lambda_sigma,
        "lambda_skew": tree["lambda_skew"],
        "sigma_slope": sigma_slope,
        "sigma_intercept": tree["sigma_intercept"],
        "sigma_sigma": sigma_sigma,
        "intercept": intercept,
        "sigma_raw": sigma_raw,
        "alpha_sub_1": tree["alpha_sub_1"],
        "alpha_2": tree.get("alpha_2", jnp.zeros((0, tree["alpha_sub_1"].shape[0]))),
    }
    log_jac = u_lambda_sigma + u_sigma_slope + u_sigma_sigma
    return params, log_jac


def unpack(theta: jnp.ndarray, dims: ModelDims) -> tuple[dict, jnp.ndarray]:
    """Flat-vector variant of unpack_tree (CPU/small-scale convenience)."""
    return unpack_tree(theta_to_tree(theta, dims), dims.non_centered)


def make_alpha(params: dict, dims: ModelDims) -> jnp.ndarray:
    """alpha[C, G]: merge_coefficients with zero-padding (stan:122-139)."""
    G, C, K = dims.G, dims.C, dims.n_check
    rows = [params["intercept"][None, :]]
    if C >= 2:
        slope_row = jnp.zeros((1, G), params["intercept"].dtype)
        slope_row = slope_row.at[0, :K].set(params["alpha_sub_1"])
        rows.append(slope_row)
    if C >= 3:
        extra = jnp.zeros((C - 2, G), params["intercept"].dtype)
        extra = extra.at[:, :K].set(params["alpha_2"])
        rows.append(extra)
    return jnp.concatenate(rows, axis=0)


@dataclass(frozen=True)
class ModelData:
    """Device-side model inputs (all static-shaped).

    Registered as a JAX pytree (below), so a ModelData can ride through jit
    as an operand — samplers compile ONCE per shape and are reused across
    the two passes / repeated fits with different data.

    The optional baseline fields hold the delta-form likelihood expansion
    point (see with_baseline / delta_likelihood): evaluating the
    count-amplified softplus terms as exact increments from a fixed baseline
    keeps the float32 log-density smooth to ~1e-3 — absolute-granularity
    roughness of eta (~1e-6 * counts up to 1e5) otherwise forces NUTS step
    sizes into collapse in float32.
    """

    counts: jnp.ndarray  # [S, G] int32
    X: jnp.ndarray  # [S, C]
    exposure_rate: jnp.ndarray  # [S]
    like_mask: jnp.ndarray  # [S, G] 1.0 = in likelihood (gene real AND not excluded)
    gene_mask: jnp.ndarray  # [G] 1.0 = real gene
    # baseline (None = plain stable evaluation)
    alpha0: jnp.ndarray | None = None  # [C, G]
    sigma_raw0: jnp.ndarray | None = None  # [G]
    d0: jnp.ndarray | None = None  # [S, G] = eta0 - log_phi0
    sp_d0: jnp.ndarray | None = None  # [S, G] = softplus(d0)
    sig_neg_d0: jnp.ndarray | None = None  # [S, G] = sigmoid(-d0)
    y_sp0: jnp.ndarray | None = None  # [S, G] = y * softplus(-d0) (per-point const)


jax.tree_util.register_pytree_node(
    ModelData,
    lambda d: (
        (d.counts, d.X, d.exposure_rate, d.like_mask, d.gene_mask,
         d.alpha0, d.sigma_raw0, d.d0, d.sp_d0, d.sig_neg_d0, d.y_sp0),
        None,
    ),
    lambda aux, ch: ModelData(*ch),
)


def prepare_data(
    counts: np.ndarray,
    X: np.ndarray,
    exposure_rate: np.ndarray,
    n_check: int,
    exclude_mask: np.ndarray | None = None,
    pad_genes_to: int | None = None,
    non_centered: bool = False,
    dtype=jnp.float32,
) -> tuple[ModelData, ModelDims]:
    """Pad + upload model arrays; returns (data, dims)."""
    S, G_real = counts.shape
    G = int(pad_genes_to) if pad_genes_to else G_real
    if G < G_real:
        raise ValueError("pad_genes_to smaller than gene count")
    counts_p = np.zeros((S, G), dtype=np.int32)
    counts_p[:, :G_real] = counts
    gene_mask = np.zeros(G, dtype=np.float64)
    gene_mask[:G_real] = 1.0
    like = np.tile(gene_mask[None, :], (S, 1))
    if exclude_mask is not None:
        like[:, :G_real] *= ~np.asarray(exclude_mask, dtype=bool)
    dims = ModelDims(
        S=S, G=G, C=X.shape[1], n_check=n_check, G_unpadded=G_real,
        non_centered=non_centered,
    )
    data = ModelData(
        counts=jnp.asarray(counts_p, dtype=jnp.int32),
        X=jnp.asarray(X, dtype=dtype),
        exposure_rate=jnp.asarray(exposure_rate, dtype=dtype),
        like_mask=jnp.asarray(like, dtype=dtype),
        gene_mask=jnp.asarray(gene_mask, dtype=dtype),
    )
    return data, dims


def lambda_log(params: dict, data: ModelData, dims: ModelDims) -> jnp.ndarray:
    """lambda_log_param[S, G] = X @ alpha (stan:205)."""
    alpha = make_alpha(params, dims)
    return jnp.dot(data.X, alpha, preferred_element_type=data.X.dtype, precision="highest")


def log_joint_tree(tree: dict, data: ModelData, dims: ModelDims, *, likelihood_fn=None):
    """Unnormalized log posterior density in unconstrained space (pytree input).

    `likelihood_fn(data, alpha, log_phi) -> scalar` lets callers swap in one
    of the custom-VJP likelihoods below (analytic, fused, fast); defaults to
    the plain-JAX stable reduction with an autodiff backward.
    """
    params, log_jac = unpack_tree(tree, dims.non_centered)
    gm = data.gene_mask

    lp = log_jac
    # Hyperpriors (stan:210-216)
    lp += normal_lpdf(params["lambda_mu"], LAMBDA_MU_MU, 2.0)
    lp += normal_lpdf(params["lambda_sigma"], 0.0, 2.0)
    lp += normal_lpdf(params["lambda_skew"], 0.0, 1.0)
    lp += normal_lpdf(params["sigma_intercept"], 0.0, 2.0)
    lp += normal_lpdf(params["sigma_slope"], 0.0, 2.0)
    lp += normal_lpdf(params["sigma_sigma"], 0.0, 2.0)

    if dims.non_centered:
        # Standardized-residual priors; the centered values are rebuilt in
        # unpack_tree. Same posterior as the centered form (stan:219, 223).
        lp += jnp.sum(
            gm * skew_normal_lpdf(tree["intercept"], 0.0, 1.0, params["lambda_skew"])
        )
        lp += jnp.sum(gm * normal_lpdf(tree["sigma_raw"], 0.0, 1.0))
    else:
        # Gene-wise priors. Note the double lambda_mu_mu shift (stan:219) —
        # lambda_mu already carries the offset, and the prior adds it again.
        lp += jnp.sum(
            gm
            * skew_normal_lpdf(
                params["intercept"],
                params["lambda_mu"] + LAMBDA_MU_MU,
                params["lambda_sigma"],
                params["lambda_skew"],
            )
        )
        # Mean-overdispersion trend (stan:223) — couples all (real) genes
        lp += jnp.sum(
            gm
            * normal_lpdf(
                params["sigma_raw"],
                params["sigma_slope"] * params["intercept"] + params["sigma_intercept"],
                params["sigma_sigma"],
            )
        )
    if dims.C >= 2:
        lp += jnp.sum(double_exponential_lpdf(params["alpha_sub_1"], 0.0, 1.0))
    if dims.C >= 3:
        lp += jnp.sum(normal_lpdf(params["alpha_2"], 0.0, 2.5))

    # Pseudo-prior keeping padded-gene coordinates well-conditioned
    pad = 1.0 - gm
    lp += jnp.sum(pad * normal_lpdf(tree["intercept"], 0.0, 1.0))
    lp += jnp.sum(pad * normal_lpdf(tree["sigma_raw"], 0.0, 1.0))

    # Likelihood (stan:97-115): NB2-log with exclusion mask
    log_phi_vec = -params["sigma_raw"]  # log sigma = -sigma_raw (stan:203)
    if likelihood_fn is None:
        lp += masked_likelihood(data, make_alpha(params, dims), log_phi_vec)
    else:
        lp += likelihood_fn(data, make_alpha(params, dims), log_phi_vec)
    return lp


def masked_likelihood(data: ModelData, alpha: jnp.ndarray, log_phi: jnp.ndarray):
    """Masked NB2-log likelihood via the float32-stable decomposition.

    Every per-point term is O(|lpmf|)-moderate (ops.nb.nb2_log_lpmf_stable),
    so the float32 reduction keeps the absolute accuracy NUTS energy
    differences need. When baseline constants are attached (with_baseline)
    the count-amplified softplus terms evaluate in delta form — smooth and
    relative-accurate in the parameters.
    """
    if data.d0 is not None:
        return delta_likelihood(data, alpha, log_phi)
    eta = data.exposure_rate[:, None] + jnp.dot(
        data.X, alpha, preferred_element_type=data.X.dtype, precision="highest"
    )
    pts = nb2_log_lpmf_stable(
        data.counts, eta, jnp.broadcast_to(log_phi[None, :], eta.shape)
    )
    return jnp.sum(data.like_mask * pts)


def with_baseline(data: ModelData, dims: ModelDims) -> ModelData:
    """Attach delta-form baseline constants computed from moment estimates.

    The baseline is the smart-init point (per-gene least squares +
    method-of-moments overdispersion); all constants are computed in float64
    on host and stored float32.
    """
    from dataclasses import replace

    theta0 = smart_init(data, dims)
    tree0 = theta_to_tree(jnp.asarray(theta0), dims)
    params0, _ = unpack_tree(tree0, dims.non_centered)
    alpha0 = np.asarray(make_alpha(params0, dims), dtype=np.float64)
    sigma_raw0 = np.asarray(params0["sigma_raw"], dtype=np.float64)
    X = np.asarray(data.X, dtype=np.float64)
    exposure = np.asarray(data.exposure_rate, dtype=np.float64)
    eta0 = exposure[:, None] + X @ alpha0
    d0 = eta0 + sigma_raw0[None, :]  # eta0 - log_phi0, log_phi0 = -sigma_raw0
    sp_d0 = np.logaddexp(0.0, d0)  # softplus
    sig_neg_d0 = 1.0 / (1.0 + np.exp(d0))
    y = np.asarray(data.counts, dtype=np.float64)
    f32 = data.X.dtype
    return replace(
        data,
        alpha0=jnp.asarray(alpha0, f32),
        sigma_raw0=jnp.asarray(sigma_raw0, f32),
        d0=jnp.asarray(d0, f32),
        sp_d0=jnp.asarray(sp_d0, f32),
        sig_neg_d0=jnp.asarray(sig_neg_d0, f32),
        y_sp0=jnp.asarray(y * np.logaddexp(0.0, -d0), f32),
    )


def delta_likelihood(data: ModelData, alpha: jnp.ndarray, log_phi: jnp.ndarray):
    """Delta-form masked NB2-log likelihood (float32-smooth).

    Exact identity: softplus(d0 + dlo) = softplus(d0)
                                        + log1p(sigmoid(d0) * expm1(dlo)).
    The y-amplified baseline term y*softplus(-d0) is a precomputed PER-POINT
    constant subtracted before the reduction (keeping every per-point value
    O(|lpmf|) so the f32 sum stays fine-grained); every parameter-dependent
    term is relative-accurate in float32 and varies smoothly, so NUTS energy
    differences stay clean even with counts ~1e5. part1 (the log-binomial
    part of ops.nb.nb2_log_lpmf_stable) is already smooth and reused as-is.

    The increment identity reconstructs softplus(d) by cancellation against
    the baseline, so its relative error is amplified by softplus(d0)/softplus(d)
    <= e^{-dlo}: it is only accurate for dlo >= -2 (positive dlo is safe —
    the increment only grows the baseline). Farther excursions switch
    per-element to the direct stable evaluation, and below d = -18 the
    Poisson-limit log-space form exp(log_phi + d) = mu (relative error
    < e^-18/2), which stays accurate even when phi alone would overflow.
    Without the hybrid, phi*sp_d (phi reaches e^70 in the steep
    overdispersion-trend corner of the prior) explodes into a spurious
    -1e20 wall that repels samplers from the high-precision region — caught
    by the SBC calibration suite (tests/test_calibration.py). Smoothness
    only matters near the posterior mode (= the baseline), so the hybrid
    keeps the f32 fine-granularity exactly where NUTS needs it.
    """
    from ppcseq.ops.nb import _softplus, expm1_precise, log1p_precise, nb2_part1

    delta_alpha = alpha - data.alpha0
    delta_eta = jnp.dot(
        data.X, delta_alpha, preferred_element_type=data.X.dtype, precision="highest"
    )
    # evaluate as NB with phi capped at e^80 — keeps phi finite in float32
    # at the prior's extreme-precision corner; the lpmf difference from the
    # cap is O(y^2*e^-80), far below either precision. The cap must be
    # consistent across every phi-dependent term (part1 is ~y*log_phi-sized
    # and d enters exp(log_phi + d), so any mixed capped/uncapped use skews
    # the density).
    log_phi_c = jnp.minimum(log_phi, 80.0)
    # d = d0 + dlo;  dlo = delta_eta - delta_log_phi
    delta_log_phi = log_phi_c + data.sigma_raw0  # log_phi - log_phi0
    dlo = delta_eta - delta_log_phi[None, :]
    d_full = data.d0 + dlo

    y = data.counts.astype(dlo.dtype)
    phi = jnp.exp(log_phi_c)[None, :]
    log_phi_b = jnp.broadcast_to(log_phi_c[None, :], dlo.shape)
    sig_d0 = 1.0 - data.sig_neg_d0

    # --- near-baseline branch (delta increments; clip keeps the unselected
    # branch finite so jnp.where gradients stay clean) ---------------------
    dlo_m = jnp.clip(dlo, -2.0, 8.0)
    sp_d_mid = data.sp_d0 + log1p_precise(sig_d0 * expm1_precise(dlo_m))
    inc_neg_mid = log1p_precise(data.sig_neg_d0 * expm1_precise(-dlo_m))
    phi_sp_mid = phi * sp_d_mid

    # --- far branch (direct stable evaluation; _softplus is finite for any
    # argument, so d itself needs no clipping) -----------------------------
    spn0 = data.sp_d0 - data.d0  # softplus(-d0), from stored constants
    phi_sp_far = jnp.where(
        d_full < -25.0,
        # Poisson limit: phi*softplus(d) -> exp(log_phi + d) = mu, relative
        # error < e^-25/2; log-space stays accurate past phi's f32 range
        jnp.exp(jnp.clip(log_phi_b + d_full, -60.0, 60.0)),
        phi * _softplus(d_full),
    )
    inc_neg_far = _softplus(-d_full) - spn0

    mid = (dlo > -2.0) & (dlo < 8.0)
    phi_sp = jnp.where(mid, phi_sp_mid, phi_sp_far)
    inc_neg = jnp.where(mid, inc_neg_mid, inc_neg_far)

    part1 = nb2_part1(y, jnp.broadcast_to(phi, dlo.shape), log_phi_b)
    pts = part1 - phi_sp - y * inc_neg - data.y_sp0
    return jnp.sum(data.like_mask * pts)


# ---------------------------------------------------------------------------
# Analytic-VJP likelihood: forward = the same masked likelihood (delta-form
# when baseline constants are attached, stable decomposition otherwise);
# backward = the closed-form NB2 gradients of ops.nb_grad instead of autodiff
# through the forward's branch machinery. Same math; gradients match float64
# autodiff to ~1e-12 (tests/test_nb_grad.py). Exact MCMC is preserved regardless of
# gradient rounding: leapfrog with ANY deterministic force field is
# reversible and volume-preserving, and the MH accept uses the forward only.


def _analytic_bwd_common(residuals, g):
    from ppcseq.ops.nb_grad import likelihood_grads

    X, exposure, counts, mask, alpha, log_phi = residuals
    dalpha, dlogphi = likelihood_grads(X, exposure, counts, mask, alpha, log_phi)
    return g * dalpha, g * dlogphi


@jax.custom_vjp
def _analytic_plain(X, exposure, counts, mask, alpha, log_phi):
    eta = exposure[:, None] + jnp.dot(
        X, alpha, preferred_element_type=X.dtype, precision="highest"
    )
    pts = nb2_log_lpmf_stable(counts, eta, jnp.broadcast_to(log_phi[None, :], eta.shape))
    return jnp.sum(mask * pts)


def _analytic_plain_fwd(X, exposure, counts, mask, alpha, log_phi):
    out = _analytic_plain(X, exposure, counts, mask, alpha, log_phi)
    return out, (X, exposure, counts, mask, alpha, log_phi)


def _analytic_plain_bwd(residuals, g):
    dalpha, dlogphi = _analytic_bwd_common(residuals, g)
    return (None, None, None, None, dalpha, dlogphi)


_analytic_plain.defvjp(_analytic_plain_fwd, _analytic_plain_bwd)


@jax.custom_vjp
def _analytic_delta(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    # gene_mask is unused by delta_likelihood; mask[0] only fills the slot
    data = ModelData(
        counts=counts, X=X, exposure_rate=exposure, like_mask=mask,
        gene_mask=mask[0], alpha0=alpha0, sigma_raw0=sigma_raw0, d0=d0,
        sp_d0=sp_d0, sig_neg_d0=sig_neg_d0, y_sp0=y_sp0,
    )
    return delta_likelihood(data, alpha, log_phi)


def _analytic_delta_fwd(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    out = _analytic_delta(
        X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0,
        y_sp0, alpha, log_phi,
    )
    return out, (X, exposure, counts, mask, alpha, log_phi)


def _analytic_delta_bwd(residuals, g):
    dalpha, dlogphi = _analytic_bwd_common(residuals, g)
    return (None, None, None, None, None, None, None, None, None, None, dalpha, dlogphi)


_analytic_delta.defvjp(_analytic_delta_fwd, _analytic_delta_bwd)


def analytic_likelihood(data: ModelData, alpha: jnp.ndarray, log_phi: jnp.ndarray):
    """masked_likelihood with closed-form gradients (custom VJP).

    Drop-in `likelihood_fn` for log_joint / log_joint_tree: identical forward
    values (it IS the same forward), analytic backward. Not differentiable
    twice — the samplers and ADVI only take first derivatives.
    """
    if data.d0 is not None:
        return _analytic_delta(
            data.X, data.exposure_rate, data.counts, data.like_mask,
            data.alpha0, data.sigma_raw0, data.d0, data.sp_d0,
            data.sig_neg_d0, data.y_sp0, alpha, log_phi,
        )
    return _analytic_plain(
        data.X, data.exposure_rate, data.counts, data.like_mask, alpha, log_phi
    )


# ---------------------------------------------------------------------------
# Fused value+gradient likelihood: the custom-VJP *forward* computes the
# closed-form gradients (ops.nb_grad) TOGETHER with the value, so XLA fuses
# both elementwise passes over the [S, G] operands into one — counts/mask
# (and baseline constants) stream from HBM once per leapfrog instead of once
# for the forward and again for the backward. The backward is then a trivial
# cotangent scale of the stashed [C, G]/[G] gradients. Value math is
# identical to masked_likelihood (delta-form when baseline attached); like
# the analytic path it is first-order only.
#
# When the function is NOT being differentiated (ADVI ELBO eval, MH accept
# re-evaluation), jax.custom_vjp calls the primal below, which computes the
# value alone — no wasted gradient work.


def _plain_value(X, exposure, counts, mask, alpha, log_phi):
    eta = exposure[:, None] + jnp.dot(
        X, alpha, preferred_element_type=X.dtype, precision="highest"
    )
    pts = nb2_log_lpmf_stable(counts, eta, jnp.broadcast_to(log_phi[None, :], eta.shape))
    return jnp.sum(mask * pts)


def _delta_value(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    data = ModelData(
        counts=counts, X=X, exposure_rate=exposure, like_mask=mask,
        gene_mask=mask[0], alpha0=alpha0, sigma_raw0=sigma_raw0, d0=d0,
        sp_d0=sp_d0, sig_neg_d0=sig_neg_d0, y_sp0=y_sp0,
    )
    return delta_likelihood(data, alpha, log_phi)


@jax.custom_vjp
def _fused_plain(X, exposure, counts, mask, alpha, log_phi):
    return _plain_value(X, exposure, counts, mask, alpha, log_phi)


def _fused_plain_fwd(X, exposure, counts, mask, alpha, log_phi):
    from ppcseq.ops.nb_grad import likelihood_grads

    out = _plain_value(X, exposure, counts, mask, alpha, log_phi)
    dalpha, dlogphi = likelihood_grads(X, exposure, counts, mask, alpha, log_phi)
    return out, (dalpha, dlogphi)


def _fused_plain_bwd(residuals, g):
    dalpha, dlogphi = residuals
    return (None, None, None, None, g * dalpha, g * dlogphi)


_fused_plain.defvjp(_fused_plain_fwd, _fused_plain_bwd)


@jax.custom_vjp
def _fused_delta(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    return _delta_value(
        X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0,
        y_sp0, alpha, log_phi,
    )


def _fused_delta_fwd(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    from ppcseq.ops.nb_grad import likelihood_grads

    out = _delta_value(
        X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0,
        y_sp0, alpha, log_phi,
    )
    dalpha, dlogphi = likelihood_grads(X, exposure, counts, mask, alpha, log_phi)
    return out, (dalpha, dlogphi)


def _fused_delta_bwd(residuals, g):
    dalpha, dlogphi = residuals
    return (None,) * 10 + (g * dalpha, g * dlogphi)


_fused_delta.defvjp(_fused_delta_fwd, _fused_delta_bwd)


def fused_likelihood(data: ModelData, alpha: jnp.ndarray, log_phi: jnp.ndarray):
    """masked_likelihood with gradients computed IN the forward (one fused
    pass over the data). Drop-in `likelihood_fn`; first-order only."""
    if data.d0 is not None:
        return _fused_delta(
            data.X, data.exposure_rate, data.counts, data.like_mask,
            data.alpha0, data.sigma_raw0, data.d0, data.sp_d0,
            data.sig_neg_d0, data.y_sp0, alpha, log_phi,
        )
    return _fused_plain(
        data.X, data.exposure_rate, data.counts, data.like_mask, alpha, log_phi
    )


# ---------------------------------------------------------------------------
# Roofline-optimized likelihood (ops/nb_fast): same math as the stable/delta
# forms with per-gene/per-data hoisting and subexpression sharing — the
# custom-VJP forward computes value + closed-form gradients in ONE fused
# elementwise pass (~3 exp + 1 log per point instead of ~35 transcendentals);
# the primal (undifferentiated calls) computes the value alone.


@jax.custom_vjp
def _fast_plain(X, exposure, counts, mask, alpha, log_phi):
    from ppcseq.ops.nb_fast import glm_plain

    return glm_plain(X, exposure, counts, mask, alpha, log_phi, want_grads=False)


def _fast_plain_fwd(X, exposure, counts, mask, alpha, log_phi):
    from ppcseq.ops.nb_fast import glm_plain

    out, dalpha, dlogphi = glm_plain(
        X, exposure, counts, mask, alpha, log_phi, want_grads=True
    )
    return out, (dalpha, dlogphi)


def _fast_plain_bwd(residuals, g):
    dalpha, dlogphi = residuals
    return (None, None, None, None, g * dalpha, g * dlogphi)


_fast_plain.defvjp(_fast_plain_fwd, _fast_plain_bwd)


@jax.custom_vjp
def _fast_delta(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    from ppcseq.ops.nb_fast import glm_delta

    return glm_delta(
        X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0,
        y_sp0, alpha, log_phi, want_grads=False,
    )


def _fast_delta_fwd(
    X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi,
):
    from ppcseq.ops.nb_fast import glm_delta

    out, dalpha, dlogphi = glm_delta(
        X, exposure, counts, mask, alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0,
        y_sp0, alpha, log_phi, want_grads=True,
    )
    return out, (dalpha, dlogphi)


def _fast_delta_bwd(residuals, g):
    dalpha, dlogphi = residuals
    return (None,) * 10 + (g * dalpha, g * dlogphi)


_fast_delta.defvjp(_fast_delta_fwd, _fast_delta_bwd)


def fast_likelihood(data: ModelData, alpha: jnp.ndarray, log_phi: jnp.ndarray):
    """Hoisted fused value+gradient likelihood (ops/nb_fast). Drop-in
    `likelihood_fn`; delta-form when baseline constants are attached.
    First-order only, like the analytic/fused paths."""
    if data.d0 is not None:
        return _fast_delta(
            data.X, data.exposure_rate, data.counts, data.like_mask,
            data.alpha0, data.sigma_raw0, data.d0, data.sp_d0,
            data.sig_neg_d0, data.y_sp0, alpha, log_phi,
        )
    return _fast_plain(
        data.X, data.exposure_rate, data.counts, data.like_mask, alpha, log_phi
    )


def log_joint(theta: jnp.ndarray, data: ModelData, dims: ModelDims, *, likelihood_fn=None):
    """Flat-vector variant of log_joint_tree."""
    return log_joint_tree(theta_to_tree(theta, dims), data, dims, likelihood_fn=likelihood_fn)


def make_log_density(data: ModelData, dims: ModelDims, likelihood_fn=None, tree: bool = False):
    """Bind data: returns theta (or pytree) -> scalar log density."""
    fn = log_joint_tree if tree else log_joint
    return partial(fn, data=data, dims=dims, likelihood_fn=likelihood_fn)


def _resolve_likelihood_fn(likelihood: str):
    if likelihood == "analytic":
        return analytic_likelihood
    if likelihood == "fused":
        return fused_likelihood
    if likelihood == "fast":
        return fast_likelihood
    return None


def _resolve_auto(likelihood: str) -> str:
    """'auto' -> the fastest measured choice for the backend.

    GPU: the hoisted fused value+gradient likelihood (ops/nb_fast). Measured
    by `python chip_smoke.py` (phase 2: float32 with the delta baseline, one
    NVIDIA H100 80GB HBM3 at a 700 W limit), per batched value+grad:
    G=515, S=21, 128 chains: fast 90 us, analytic 132, fused 132, plain 207;
    G=50,000, S=100, batch 1: fast 226 us, fused 312, analytic 328, plain
    570. Both widths pick `fast`, so the choice does not depend on the
    shape. CPU: plain autodiff (tests run there in float64, where autodiff
    exactness is the baseline).
    """
    if likelihood != "auto":
        return likelihood
    return "fast" if jax.default_backend() == "gpu" else "plain"


@functools.lru_cache(maxsize=64)
def _flat_logp_cached(dims: ModelDims, likelihood: str):
    lfn = _resolve_likelihood_fn(likelihood)

    def f(theta, data):
        return log_joint(theta, data, dims, likelihood_fn=lfn)

    return f


def flat_logp(dims: ModelDims, likelihood: str = "auto"):
    """Data-parametrized flat log density with STABLE function identity.

    Returns `f(theta, data) -> scalar` cached per (dims, likelihood), so
    samplers that key their compiled executables on the log-density function
    reuse one compile across repeated fits with different data of the same
    shape (e.g. the two passes of identify_outliers — pass 2 differs only in
    like_mask and baseline constants).

    likelihood: "plain" (XLA-fused stable lpmf, autodiff backward; honors
    the delta-form baseline when attached), "analytic" (same forward,
    closed-form custom-VJP backward — ops/nb_grad), "fused" (value and
    closed-form gradients in one forward), "fast" (the hoisted fused form,
    ops/nb_fast), or "auto" (see _resolve_auto).
    """
    return _flat_logp_cached(dims, _resolve_auto(likelihood))


@functools.lru_cache(maxsize=64)
def _tree_logp_cached(dims: ModelDims, likelihood: str):
    lfn = _resolve_likelihood_fn(likelihood)

    def f(tree, data):
        return log_joint_tree(tree, data, dims, likelihood_fn=lfn)

    return f


def tree_logp(dims: ModelDims, likelihood: str = "auto"):
    """Pytree-state counterpart of flat_logp: `f(tree, data) -> scalar` with
    stable function identity per (dims, likelihood), so tree-state samplers
    (run_hmc_tree, run_nuts over pytrees) reuse compiled runners across fits.
    """
    return _tree_logp_cached(dims, _resolve_auto(likelihood))


@functools.lru_cache(maxsize=64)
def _extract_flat_jit(dims: ModelDims):
    def one(th, data):
        params, _ = unpack(th, dims)
        ll = lambda_log(params, data, dims)
        return ll[:, : dims.n_check], params["sigma_raw"][: dims.n_check]

    return jax.jit(jax.vmap(one, in_axes=(0, None)))


def extract_lambda_sigma_draws(thetas, data: ModelData, dims: ModelDims):
    """Posterior arrays the PPC needs, from draws.

    `thetas` is either a flat [n, D] array or a stacked pytree (leaves with a
    leading draw axis). Returns (lambda_log_param[n, S, n_check],
    sigma_raw[n, n_check]) — the reference always saves these two
    (R/utilities.R:1373). The flat path compiles once per dims (data is an
    operand).
    """
    if isinstance(thetas, dict):
        def one_tree(tree):
            params, _ = unpack_tree(tree, dims.non_centered)
            ll = lambda_log(params, data, dims)
            return ll[:, : dims.n_check], params["sigma_raw"][: dims.n_check]

        return jax.vmap(one_tree)(thetas)
    return _extract_flat_jit(dims)(thetas, data)


def extract_alpha_sub_1_draws(thetas, dims: ModelDims):
    if isinstance(thetas, dict):
        return thetas["alpha_sub_1"]
    o = _offsets(dims)
    lo, hi = o["alpha_sub_1"]
    return thetas[:, lo:hi]


def smart_init(data: ModelData, dims: ModelDims, as_tree: bool = False):
    """Data-driven initialization point in unconstrained space.

    Per-gene least squares of log depth-adjusted counts on the design gives
    intercept/slope; method-of-moments gives overdispersion; hyperparameters
    are set to the empirical moments of those estimates. This replaces the
    reference's (dead) discovery-based `inits_fx` (R/utilities.R:369-388) and
    dramatically shortens ADVI/NUTS warmup — the reference pays for random
    inits with long adaptive runs instead.
    """
    counts = np.asarray(data.counts, dtype=np.float64)
    X = np.asarray(data.X, dtype=np.float64)
    exposure = np.asarray(data.exposure_rate, dtype=np.float64)
    mask = np.asarray(data.like_mask, dtype=bool)

    adj = counts / np.exp(exposure)[:, None]  # depth-adjusted counts [S, G]
    y = np.log(adj + 0.5)
    # exclude masked points from the regression by imputing the column mean
    col_mean = np.where(
        mask.sum(0) > 0, (y * mask).sum(0) / np.maximum(mask.sum(0), 1), 0.0
    )
    y = np.where(mask, y, col_mean[None, :])
    # normal equations: C is tiny (2-3 columns) so this is exact and ~free,
    # where gelsd-based lstsq cost ~4 s at 50k genes; fall back on rank
    # deficiency
    try:
        beta = np.linalg.solve(X.T @ X, X.T @ y)  # [C, G]
    except np.linalg.LinAlgError:
        beta, *_ = np.linalg.lstsq(X, y, rcond=None)

    intercept = beta[0]
    mu_hat = np.exp(X @ beta)  # [S, G]
    resid_var = ((adj - mu_hat) ** 2 * mask).sum(0) / np.maximum(mask.sum(0) - X.shape[1], 1)
    mu_bar = np.maximum((mu_hat * mask).sum(0) / np.maximum(mask.sum(0), 1), 1e-3)
    phi = mu_bar**2 / np.maximum(resid_var - mu_bar, mu_bar * 1e-2)
    phi = np.clip(phi, 1e-3, 1e4)
    sigma_raw = -np.log(phi)

    real = np.asarray(data.gene_mask, dtype=bool)
    ic_real = intercept[real]
    sr_real = sigma_raw[real]
    lam_mu = float(ic_real.mean())
    lam_sd = float(max(ic_real.std(), 0.1))
    # sigma_raw ~ a + b * intercept trend
    A = np.column_stack([np.ones(real.sum()), ic_real])
    (s_int, s_slope), *_ = np.linalg.lstsq(A, sr_real, rcond=None)
    s_slope = min(s_slope, -1e-3)  # constrained negative in the model
    trend_resid = sr_real - (s_int + s_slope * ic_real)
    s_sigma = float(max(trend_resid.std(), 0.1))

    theta = np.zeros(dims.dim)
    o = _offsets(dims)
    theta[o["lambda_mu"][0]] = lam_mu - 2 * LAMBDA_MU_MU
    theta[o["lambda_sigma"][0]] = np.log(lam_sd)
    theta[o["lambda_skew"][0]] = 0.0
    theta[o["sigma_slope"][0]] = np.log(-s_slope)
    theta[o["sigma_intercept"][0]] = s_int
    theta[o["sigma_sigma"][0]] = np.log(s_sigma)
    theta[o["intercept"][0] : o["intercept"][1]] = np.where(real, intercept, 0.0)
    theta[o["sigma_raw"][0] : o["sigma_raw"][1]] = np.where(real, sigma_raw, 0.0)
    if dims.C >= 2:
        lo, hi = o["alpha_sub_1"]
        theta[lo:hi] = beta[1, : dims.n_check]
    if dims.C >= 3:
        lo, hi = o["alpha_2"]
        theta[lo:hi] = beta[2:, : dims.n_check].reshape(-1)

    if dims.non_centered:
        # convert centered estimates to standardized residuals
        ic = theta[o["intercept"][0] : o["intercept"][1]]
        sr = theta[o["sigma_raw"][0] : o["sigma_raw"][1]]
        t_i = (ic - lam_mu) / lam_sd
        t_s = (sr - (s_int + s_slope * ic)) / s_sigma
        theta[o["intercept"][0] : o["intercept"][1]] = np.where(real, t_i, 0.0)
        theta[o["sigma_raw"][0] : o["sigma_raw"][1]] = np.where(real, t_s, 0.0)

    if as_tree:
        return theta_to_tree(jnp.asarray(theta), dims)
    return theta
