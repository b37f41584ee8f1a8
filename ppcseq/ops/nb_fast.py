"""Roofline-optimized NB2-log GLM likelihood: value + analytic gradients in
one pass with per-gene/per-data hoisting.

The sampler hot loop (reference map_rect likelihood,
inst/stan/negBinomial_MPI.stan:97-115) evaluates the masked NB2-log lpmf and
its gradients over the full [chains, S, G] point grid every leapfrog. The
straightforward compositions (ops.nb.nb2_log_lpmf_stable forward +
ops.nb_grad backward) are float32-exact but spend ~35 transcendental ops per
point, most of which depend only on phi (per chain x gene — an S-fold
smaller grid) or only on the counts (fixed data). This module evaluates the
SAME math (identical branch structure and float32-moderation guarantees)
restructured so the per-point work is ~3 exp + 1 log + a few short
polynomials:

- per-gene tables ([G] per chain): phi, running sums of log(phi+k) and
  phi/(phi+k) for the exact small-y branch, the shifted-Stirling
  lgamma(phi<8), psi(phi+8), and the phi-only Stirling constants. Cost is
  amortized S-fold.
- per-data constants ([S, G], no chain batch dim): log(y+1), 1/(y+1),
  lgamma(y+1) for y<=7, branch masks. Under vmap these stay unbatched
  (chains-fold amortized) and XLA's loop-invariant code motion hoists them
  out of the leapfrog scan entirely.
- per-point ([chains, S, G]) only: one exp(-|d|) shared by both softplus
  terms, the sigmoid pair, and the gradient; one log1p for the Stirling
  ratio log1p((phi-1)/(y+1)) — REUSED to rebuild log(y+phi) = log(y+1) +
  log1p((phi-1)/(y+1)) so branches B/C and the digamma difference need no
  further logs; short polynomials for log1p on [0,1] (pure odd atanh
  series — no log fallback needed) and the softplus-minus-sigmoid series.

Cancellation guards preserved from the reference implementations:
- branch B's (phi-1)*log1p(y/phi) is NOT computed as (phi-1)*(log(y+phi) -
  log(phi)) in the small-y/phi regime (pure cancellation at huge phi); the
  atanh polynomial covers u = y/phi < 1/2 and the log-difference form is
  only used for u >= 1/2 where the difference is >= log(3/2).
- y*softplus(-d) keeps its product-of-moderate-factors form (regrouping into
  -(phi+y)*softplus(d) + y*d would amplify f32 rounding ~300x at y ~ 1e5).
- phi*sigmoid(d) stays in log space exp(log_phi - softplus(-d)).

Values match ops.nb.nb2_log_lpmf_stable and gradients match float64
autodiff to the tolerances pinned in tests/test_nb_fast.py.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

LOG_PHI_CAP = 80.0
HALF_LOG_2PI = 0.9189385332046727
LOG8 = math.log(8.0)
# lgamma(y+1) for y = 0..7 (branch-A data constant)
LGAMMA_1P = [0.0, 0.0] + [math.lgamma(k + 1) for k in range(2, 8)]


def _log1p01(u):
    """log(1+u) for u in [0, 1]: pure odd atanh series, f32-relative exact.

    z = u/(2+u) <= 1/3; the series through z^13 truncates at < 4e-8 relative
    — no transcendental log needed (ops.nb.log1p_precise must keep its log
    fallback because its argument range is unbounded).
    """
    z = u / (2.0 + u)
    z2 = z * z
    return 2.0 * z * (
        1.0
        + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0
            + z2 * (1.0 / 9.0 + z2 * (1.0 / 11.0 + z2 / 13.0)))))
    )


def _log1p_wide(u, log_fallback):
    """log(1+u) for u > -1, with the |u| >= 1/3..1/2 fallback supplied by the
    caller as an already-available logarithm (avoids a fresh transcendental).

    Caller contract: `log_fallback` equals log(1+u) wherever the polynomial
    window does not apply (the atanh series is f32-exact for
    -1/3 < u < 1/2, mapping to |z| <= 0.2 — see ops.nb.log1p_precise).
    """
    z = u / (2.0 + u)
    z2 = z * z
    small = 2.0 * z * (1.0 + z2 * (1.0 / 3.0 + z2 * (1.0 / 5.0 + z2 * (1.0 / 7.0 + z2 / 9.0))))
    return jnp.where((u > -1.0 / 3.0) & (u < 0.5), small, log_fallback)


def _gene_tables(log_phi, dtype):
    """Per-gene ([G]; [chains, G] under vmap) tables. ~12 transcendentals per
    gene, amortized over S samples."""
    log_phi_c = jnp.minimum(log_phi.astype(dtype), LOG_PHI_CAP)
    phi = jnp.exp(log_phi_c)
    # branch A running sums: cum_log[k] = sum_{j<=k} log(phi+j),
    # cum_frac[k] = sum_{j<=k} phi/(phi+j), k = 0..6
    cum_log, cum_frac = [], []
    acc_l = jnp.log(phi)
    acc_f = jnp.ones_like(phi)
    cum_log.append(acc_l)
    cum_frac.append(acc_f)
    for k in range(1, 7):
        acc_l = acc_l + jnp.log(phi + k)
        acc_f = acc_f + phi / (phi + k)
        cum_log.append(acc_l)
        cum_frac.append(acc_f)
    lg7 = jnp.log(phi + 7.0)
    frac7 = phi / (phi + 7.0)

    # lgamma(min(phi,8)) via shift-by-8 Stirling (ops.nb._lgamma_pos_small).
    # The shift sum reuses cum_log[6] + lg7 (== sum log(phi+k), k<8, exact on
    # the active phi < 8 lanes; finite elsewhere).
    xs = jnp.minimum(phi, 8.0) + 8.0
    inv = 1.0 / xs
    inv2 = inv * inv
    stirl = (
        (xs - 0.5) * jnp.log(xs) - xs + HALF_LOG_2PI
        + inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)))
    )
    lgam_small = stirl - (cum_log[6] + lg7)

    # psi(min(phi,8)+8), asymptotic (ops.nb_grad._psi_asym)
    invp = 1.0 / xs
    invp2 = invp * invp
    psi8 = (
        jnp.log(xs) - 0.5 * invp
        - invp2 * (1.0 / 12.0 - invp2 * (1.0 / 120.0 - invp2 / 252.0))
    )
    # digamma shift sum_{k<8} phic/(phic+k) (active lanes phi < 8 reuse the
    # raw-phi fractions exactly)
    shift_c = cum_frac[6] + frac7

    # branch-B phi-only constants, clamped like the reference's phis =
    # max(phi, 8) so inactive lanes stay inf/NaN-free
    log_phi_b = jnp.maximum(log_phi_c, LOG8)
    phi_b = jnp.maximum(phi, 8.0)
    inv_phi_b = 1.0 / phi_b
    b_const = (
        -0.5 * log_phi_b + 1.0 - HALF_LOG_2PI
        - (1.0 / 12.0) * inv_phi_b + (1.0 / 360.0) * inv_phi_b**3
    )
    return {
        "log_phi_c": log_phi_c,
        "phi": phi,
        "cum_log": cum_log,
        "cum_frac": cum_frac,
        "lgam_small": lgam_small,
        "psi8": psi8,
        "shift_c": shift_c,
        "log_phi_b": log_phi_b,
        "phi_b": phi_b,
        "inv_phi_b": inv_phi_b,
        "b_const": b_const,
        "d_b": phi - 1.0,
    }


def _data_tables(counts, dtype):
    """Per-data ([S, G], unbatched under vmap) constants."""
    yf = counts.astype(dtype)
    y1 = yf + 1.0
    inv_y1 = 1.0 / y1
    log_y1 = jnp.log(y1)
    # lgamma(y+1) for the y <= 7 branch, via table select (exact)
    lg_y1_small = jnp.zeros_like(yf)
    for k in range(2, 8):
        lg_y1_small = jnp.where(yf >= k, LGAMMA_1P[k], lg_y1_small)
    return {
        "yf": yf,
        "inv_y1": inv_y1,
        "inv_y1_3": inv_y1 * inv_y1 * inv_y1,
        "log_y1": log_y1,
        "lg_y1_small": lg_y1_small,
        "y_le7": yf <= 7.0,
        "y_ge8_f": jnp.maximum(yf, 8.0),
    }


def _select_by_y(yf, cums):
    """sum_{k < y} table-term for y in 0..7: nested select over 7 cumsums."""
    out = jnp.zeros_like(yf * cums[0])
    for k in range(7):  # ascending: the largest applicable k wins
        out = jnp.where(yf > k, jnp.broadcast_to(cums[k], out.shape), out)
    return out


def _part1_and_digamma(gt, dt, want_grads):
    """part1 = lgamma(y+phi) - lgamma(y+1) - lgamma(phi) (value) and
    phi*(digamma(y+phi) - digamma(phi)) (gradient), sharing one log1p.

    Math identical branch-for-branch to ops.nb.nb2_part1 +
    ops.nb_grad.phi_digamma_diff; log(y+phi) is rebuilt as
    log(y+1) + log1p((phi-1)/(y+1)) instead of fresh logs.
    """
    yf, inv_y1, log_y1 = dt["yf"], dt["inv_y1"], dt["log_y1"]
    phi, d_b = gt["phi"], gt["d_b"]

    # the one per-point log1p: r = (phi-1)/(y+1) in (-1, inf)
    u = d_b * inv_y1
    l1p = _log1p_wide(u, jnp.log(1.0 + u))
    log_a1 = log_y1 + l1p  # log(y + phi), exact in both branches

    # Stirling pair for lgamma(y+phi) - lgamma(y+1), y >= 8 (ops.nb:96-103).
    # inv_a1 keeps the ys = max(y,8) clamp so inactive small-y lanes cannot
    # overflow into inf - inf = NaN.
    inv_a1 = 1.0 / (dt["y_ge8_f"] + phi)
    inv_a1_2 = inv_a1 * inv_a1
    corr = (1.0 / 12.0) * (inv_a1 - inv_y1) - (1.0 / 360.0) * (
        inv_a1 * inv_a1_2 - dt["inv_y1_3"]
    )
    pair = (yf + 0.5) * l1p + corr

    # branch B (y >= 8, phi >= 8): (phi-1)*log1p(y/phi) without cancellation:
    # atanh poly for y/phi < 1/2, log(y+phi) - log(phi) difference otherwise
    # (difference >= log(3/2) there — no cancellation)
    ub = yf * gt["inv_phi_b"]
    l1p_b = jnp.where(ub < 0.5, _log1p01(jnp.minimum(ub, 1.0)), log_a1 - gt["log_phi_b"])
    part_b = pair + (gt["phi_b"] - 1.0) * l1p_b + gt["b_const"]

    # branch C (y >= 8, phi < 8)
    part_c = pair + d_b * log_a1 - d_b - gt["lgam_small"]

    # branch A (y <= 7): exact running sums minus lgamma(y+1)
    part_a = _select_by_y(yf, gt["cum_log"]) - dt["lg_y1_small"]

    part1 = jnp.where(dt["y_le7"], part_a, jnp.where(phi >= 8.0, part_b, part_c))
    if not want_grads:
        return part1, None

    # --- phi * (digamma(y+phi) - digamma(phi)) (ops.nb_grad:59-93) --------
    # branch B: phi*log1p(y/phi) + y/(2(y+phi)) + (1/12)(1/phi - phi/(y+phi)^2)
    #           - (1/120)(1/phi^3 - phi/(y+phi)^4)
    g_b = (
        gt["phi_b"] * l1p_b
        + 0.5 * yf * inv_a1
        + (1.0 / 12.0) * (gt["inv_phi_b"] - gt["phi_b"] * inv_a1_2)
        - (1.0 / 120.0) * (gt["inv_phi_b"] ** 3 - gt["phi_b"] * inv_a1_2 * inv_a1_2)
    )
    # branch C: phic*(psi(y+phic) - psi(phic+8)) + shift. psi(y+phi) for the
    # active phi < 8 lanes reuses log_a1 and inv_a1 (exact there).
    psi_yphi = (
        log_a1 - 0.5 * inv_a1
        - inv_a1_2 * (1.0 / 12.0 - inv_a1_2 * (1.0 / 120.0 - inv_a1_2 / 252.0))
    )
    phic = jnp.minimum(phi, 8.0)
    g_c = phic * (psi_yphi - gt["psi8"]) + gt["shift_c"]
    g_a = _select_by_y(yf, gt["cum_frac"])
    phi_d = jnp.where(dt["y_le7"], g_a, jnp.where(phi >= 8.0, g_b, g_c))
    return part1, phi_d


def _softplus_pair(d):
    """(softplus(d), softplus(-d), exp(-|d|)) sharing one exp + one poly."""
    em = jnp.exp(-jnp.abs(d))
    l1pem = _log1p01(em)
    sp_d = jnp.maximum(d, 0.0) + l1pem
    sp_nd = jnp.maximum(-d, 0.0) + l1pem
    return sp_d, sp_nd, em


def _grads_from_d(gt, dt, d, sp_d, sp_nd, em, phi_d, log_phi_raw):
    """(deta, dlogphi) per point, sharing d/em/softplus with the value
    (ops.nb_grad.nb2_grads restructured)."""
    yf = dt["yf"]
    r = 1.0 / (1.0 + em)
    q = jnp.where(d > 0, em * r, r)  # sigmoid(-d)
    phi_p = jnp.exp(gt["log_phi_c"] - sp_nd)  # phi*sigmoid(d), log space
    deta = yf * q - phi_p

    # phi*(softplus(d) - sigmoid(d)) (ops.nb_grad:96-116): log-space odd
    # series for d <= -1.386 (em = e^d there), direct elsewhere
    dn = jnp.minimum(d, 0.0)
    useries = em  # == e^d on the lanes the series is selected on
    series = 0.5 - useries * (
        2.0 / 3.0
        - useries * (0.75 - useries * (0.8 - useries * (5.0 / 6.0
            - useries * (6.0 / 7.0 - useries * 0.875))))
    )
    small = jnp.exp(gt["log_phi_c"] + 2.0 * dn) * series
    sig = 1.0 - q
    direct = gt["phi"] * (sp_d - sig)
    phi_a = jnp.where(d <= -1.386, small, direct)

    dlogphi = jnp.where(log_phi_raw < LOG_PHI_CAP, phi_d - phi_a - yf * q, 0.0)
    return deta, dlogphi


def _eta_small(X, exposure, alpha):
    """eta = exposure[:,None] + X @ alpha as explicit broadcast-sum.

    For the GLM's tiny C (design columns), a vmapped jnp.dot can lower to a
    degenerate size-G convolution (pad=G-1, rhs_reversal) that dominates
    the whole leapfrog; C fused multiply-adds cost ~nothing and fuse into
    the elementwise likelihood kernel.
    """
    C = X.shape[1]
    eta = jnp.broadcast_to(exposure[:, None], (X.shape[0], alpha.shape[1]))
    for c in range(C):
        eta = eta + X[:, c, None] * alpha[c][None, :]
    return eta


def _dalpha_small(X, deta):
    """dalpha[C, G] = X.T @ deta as C masked reductions over S (fusable)."""
    return jnp.stack([jnp.sum(X[:, c, None] * deta, axis=0) for c in range(X.shape[1])])


def glm_plain(X, exposure, counts, mask, alpha, log_phi, want_grads):
    """Masked NB2-log GLM likelihood (stable plain form), optionally with
    (dalpha[C,G], dlogphi[G]) computed in the same fused pass.

    Value math == nb_model.masked_likelihood without baseline; gradient math
    == ops.nb_grad.likelihood_grads.
    """
    dtype = X.dtype
    gt = _gene_tables(log_phi, dtype)
    dt = _data_tables(counts, dtype)

    eta = _eta_small(X, exposure, alpha)
    d = eta - gt["log_phi_c"][None, :]
    sp_d, sp_nd, em = _softplus_pair(d)
    part1, phi_d = _part1_and_digamma(gt, dt, want_grads)
    # part23 = -phi*softplus(d) - y*softplus(-d), products of moderate factors
    pts = part1 - gt["phi"][None, :] * sp_d - dt["yf"] * sp_nd
    # reduce over S first: the [G] partial has the same iteration space as
    # the gradient reductions, so XLA sibling-fuses ALL of them (value,
    # dlogphi, C dalpha rows) with the elementwise producer into ONE kernel
    value = jnp.sum(jnp.sum(mask * pts, axis=0))
    if not want_grads:
        return value

    deta, dlogphi = _grads_from_d(
        gt, dt, d, sp_d, sp_nd, em, phi_d, log_phi[None, :].astype(dtype)
    )
    deta = mask * deta
    dalpha = _dalpha_small(X, deta)
    return value, dalpha, jnp.sum(mask * dlogphi, axis=0)


def delta_increment_terms(gt, dlo, d, sp_d, sp_nd, d0, sp_d0, sig_neg_d0):
    """Hybrid delta-form softplus increments -> (phi_sp, inc_neg).

    phi_sp = phi*softplus(d) and inc_neg = softplus(-d) - softplus(-d0),
    evaluated as exact increments from the baseline near it (float32-smooth)
    and by the direct stable forms far from it (nb_model.delta_likelihood
    semantics, incl. the Poisson-limit log-space branch below d = -25).
    Kept as one function so the branch thresholds live in ONE place.
    """
    sig_d0 = 1.0 - sig_neg_d0
    dlo_m = jnp.clip(dlo, -2.0, 8.0)
    e1 = jnp.where(
        jnp.abs(dlo_m) < 0.35,
        dlo_m * (1.0 + dlo_m * (0.5 + dlo_m * (1.0 / 6.0 + dlo_m * (1.0 / 24.0
            + dlo_m * (1.0 / 120.0 + dlo_m * (1.0 / 720.0 + dlo_m / 5040.0)))))),
        jnp.exp(dlo_m) - 1.0,
    )
    e1_neg = -e1 / (1.0 + e1)  # expm1(-dlo_m), exact identity
    arg_p = sig_d0 * e1
    arg_n = sig_neg_d0 * e1_neg
    sp_d_mid = sp_d0 + _log1p_wide(arg_p, jnp.log(1.0 + arg_p))
    inc_neg_mid = _log1p_wide(arg_n, jnp.log(1.0 + arg_n))
    phi_sp_far = jnp.where(
        d < -25.0,
        jnp.exp(jnp.clip(gt["log_phi_c"] + d, -60.0, 60.0)),
        gt["phi"] * sp_d,
    )
    spn0 = sp_d0 - d0  # softplus(-d0)
    mid = (dlo > -2.0) & (dlo < 8.0)
    phi_sp = jnp.where(mid, gt["phi"] * sp_d_mid, phi_sp_far)
    inc_neg = jnp.where(mid, inc_neg_mid, sp_nd - spn0)
    return phi_sp, inc_neg


def glm_delta(
    X, exposure, counts, mask,
    alpha0, sigma_raw0, d0, sp_d0, sig_neg_d0, y_sp0,
    alpha, log_phi, want_grads,
):
    """Delta-form masked likelihood (nb_model.delta_likelihood math) with the
    same hoisting, optionally emitting the analytic gradients in-pass.

    The delta machinery only changes the value's part23; part1 and the
    gradients are the plain forms on the full d = d0 + dlo.
    """
    dtype = X.dtype
    gt = _gene_tables(log_phi, dtype)
    dt = _data_tables(counts, dtype)

    delta_eta = _eta_small(X, jnp.zeros_like(exposure), alpha - alpha0)
    delta_log_phi = gt["log_phi_c"] + sigma_raw0  # log_phi - log_phi0
    dlo = delta_eta - delta_log_phi[None, :]
    d = d0 + dlo
    sp_d, sp_nd, em = _softplus_pair(d)
    gt_b = dict(gt, log_phi_c=gt["log_phi_c"][None, :], phi=gt["phi"][None, :])
    phi_sp, inc_neg = delta_increment_terms(
        gt_b, dlo, d, sp_d, sp_nd, d0, sp_d0, sig_neg_d0
    )

    part1, phi_d = _part1_and_digamma(gt, dt, want_grads)
    pts = part1 - phi_sp - dt["yf"] * inc_neg - y_sp0
    value = jnp.sum(jnp.sum(mask * pts, axis=0))  # S-first: see glm_plain
    if not want_grads:
        return value

    deta, dlogphi = _grads_from_d(
        gt, dt, d, sp_d, sp_nd, em, phi_d, log_phi[None, :].astype(dtype)
    )
    deta = mask * deta
    dalpha = _dalpha_small(X, deta)
    return value, dalpha, jnp.sum(mask * dlogphi, axis=0)
