"""Posterior-predictive simulation and credible intervals, on device.

Replaces the reference's Stan generated-quantities block plus R-side CI
extraction:

- `counts_rng_draws`: the generated-quantities simulation
  (stan:259-266) — one NB2 draw per posterior draw per (sample, checked
  gene), with `sigma * truncation_compensation` inflating overdispersion.
- `exact_ci`: quantile/mean/sd summary over those draws
  (`fit_to_counts_rng`, reference R/utilities.R:685-703).
- `approximated_ci`: the memory-scalable path
  (`fit_to_counts_rng_approximated`, reference R/utilities.R:733-784) —
  bootstrap-resample the posterior draws of (lambda, sigma_raw) up to
  `how_many_posterior_draws` and simulate NB draws from them, avoiding a
  draws x S x G materialization of counts_rng in device memory beyond one
  tile.

Quantiles are R type-7 (stats::quantile default), which is exactly
jnp.quantile's "linear" method.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def counts_rng_draws(
    key,
    lambda_log: jnp.ndarray,  # [n_draws, S, K] posterior draws of lambda_log_param
    sigma_raw: jnp.ndarray,  # [n_draws, K]
    exposure_rate: jnp.ndarray,  # [S]
    truncation_compensation: float = 1.0,
) -> jnp.ndarray:
    """Simulate counts_rng[n_draws, S, K] (stan:259-266) via Gamma-Poisson."""
    n, S, K = lambda_log.shape
    eta = lambda_log + exposure_rate[None, :, None]
    phi = jnp.exp(-sigma_raw)[:, None, :] * truncation_compensation
    k_gamma, k_pois = jax.random.split(key)
    g = jax.random.gamma(k_gamma, phi, shape=(n, S, K))
    rate = jnp.exp(eta) / phi * g
    return jax.random.poisson(k_pois, rate)


def _summarize_split(draws: jnp.ndarray, adj_prob_threshold: float):
    """Scale-safe [S, K] summaries: exact bases + small float corrections.

    A float32 quantile of counts loses unit resolution above 2^24 (~1.7e7)
    — a silent precision cliff for deep-coverage cohorts. Instead the two
    order statistics of the R type-7 quantile are gathered in the draws'
    own (integer) dtype — exact — and only the interpolation term and the
    residuals around a per-cell integer center pass through float32;
    `finalize_summary` recombines in float64 on host, so CI bounds are
    exact to the unit at any count scale (counts must fit the int dtype,
    i.e. < 2^31 in int32).
    """
    n = draws.shape[0]
    thr = float(adj_prob_threshold)
    i_lo = int(np.floor(thr * (n - 1)))
    i_hi = int(np.floor((1.0 - thr) * (n - 1)))
    # CI thresholds are tail probabilities (pipeline: 2e-4..0.05), so the
    # four order statistics live within ~a dozen elements of each end — two
    # top_k calls are exact and far cheaper than a full n-element sort (at
    # the 50k-supersample budget the sort dominated the whole PPC stage).
    k_lo = min(i_lo + 2, n)
    k_hi = min(n - i_hi, n)
    if k_lo + k_hi <= max(n // 4, 2):
        xt = jnp.moveaxis(draws, 0, -1)  # [S, K, n]; top_k works on last axis
        lo_vals = -jax.lax.top_k(-xt, k_lo)[0]  # k_lo smallest, ascending
        hi_vals = jax.lax.top_k(xt, k_hi)[0]  # k_hi largest, descending

        def get(i):  # global sorted index -> [S, K]
            return lo_vals[..., i] if i < k_lo else hi_vals[..., n - 1 - i]

    else:
        s = jnp.sort(draws, axis=0)

        def get(i):
            return s[i]

    def order_stat(i0, h):
        # R type-7: x[i0] + frac * (x[i0+1] - x[i0]), h = p*(n-1)
        base = get(i0)
        delta = (get(min(i0 + 1, n - 1)) - base).astype(jnp.float32)
        return base, jnp.float32(h - i0) * delta

    lo_base, lo_corr = order_stat(i_lo, thr * (n - 1))
    hi_base, hi_corr = order_stat(i_hi, (1.0 - thr) * (n - 1))
    center = get(i_lo)  # any integer anchor works for the residual trick
    resid = (draws - center[None]).astype(jnp.float32)
    return {
        "lower_base": lo_base, "lower_corr": lo_corr,
        "upper_base": hi_base, "upper_corr": hi_corr,
        "mean_base": center, "mean_corr": jnp.mean(resid, axis=0),
        "sd": jnp.std(resid, axis=0, ddof=1),  # shift-invariant
    }


def finalize_summary(split) -> dict:
    """Recombine `_summarize_split` output into f64 host arrays."""
    out = {
        k: np.asarray(split[f"{k}_base"], np.float64)
        + np.asarray(split[f"{k}_corr"], np.float64)
        for k in ("lower", "upper", "mean")
    }
    out["sd"] = np.asarray(split["sd"], np.float64)
    return out


def summarize_draws(draws: jnp.ndarray, adj_prob_threshold: float):
    """CI (R type-7 quantiles at thr, 1-thr), mean, sd over axis 0.

    Returns dict of [S, K] float64 numpy arrays: lower, upper, mean, sd —
    exact to the unit at any count scale (see `_summarize_split`).
    """
    return finalize_summary(_summarize_split(draws, adj_prob_threshold))


@functools.lru_cache(maxsize=128)
def _exact_ci_jit(adj_prob_threshold: float, truncation_compensation: float):
    @jax.jit
    def run(key, lambda_log, sigma_raw, exposure_rate):
        draws = counts_rng_draws(
            key, lambda_log, sigma_raw, exposure_rate, truncation_compensation
        )
        return _summarize_split(draws, adj_prob_threshold), draws

    return run


def exact_ci(
    key,
    lambda_log: jnp.ndarray,
    sigma_raw: jnp.ndarray,
    exposure_rate: jnp.ndarray,
    adj_prob_threshold: float,
    truncation_compensation: float = 1.0,
    max_tile_elems: int = 64_000_000,
    return_draws: bool = True,
):
    """counts_rng summary over the actual posterior draws (reference exact path).

    Compiled once per (threshold, compensation) — draw arrays are operands.
    Genes are chunked so at most `max_tile_elems` simulated counts live in
    device memory at a time (the same tiling as the approximated path). With
    `return_draws`, the full [n_draws, S, K] counts_rng lands in HOST
    memory (needed for save_generated_quantities; the pipeline's RAM
    regression guards its feasibility, reference R/methods.R:169-195);
    without it only the [S, K] summaries are kept, so the exact path runs
    at 50k-gene scale in O(tile) device and O(S*K) host memory.
    """
    run = _exact_ci_jit(float(adj_prob_threshold), float(truncation_compensation))
    n, S, K = lambda_log.shape
    kb_max = max(1, int(max_tile_elems / max(n * S, 1)))
    if K <= kb_max:
        # single block: one call, no key split — the RNG stream (and hence
        # the simulated counts_rng) is identical whether or not the draws
        # are copied to host
        out, draws = run(key, lambda_log, sigma_raw, exposure_rate)
        return finalize_summary(out), (np.asarray(draws) if return_draws else None)
    outs = []
    blocks = []
    for start in range(0, K, kb_max):
        key, sub = jax.random.split(key)
        out, draws = run(
            sub,
            lambda_log[:, :, start : start + kb_max],
            sigma_raw[:, start : start + kb_max],
            exposure_rate,
        )
        outs.append(finalize_summary(out))
        if return_draws:
            blocks.append(np.asarray(draws))
        del draws
    summary = {k: np.concatenate([o[k] for o in outs], axis=-1) for k in outs[0]}
    return summary, (np.concatenate(blocks, axis=-1) if return_draws else None)


@functools.lru_cache(maxsize=128)
def _approx_block_jit(n_super: int, adj_prob_threshold: float, truncation_compensation: float):
    """One gene-block of the bootstrap-supersampled CI, compiled once per
    (n_super, threshold, compensation); array shapes/data are operands."""

    @jax.jit
    def block(key, lam_blk, sig_blk, exposure_rate):
        return _approx_block_body(
            key, lam_blk, sig_blk, exposure_rate,
            n_super, adj_prob_threshold, truncation_compensation,
        )

    return block


def _approx_block_body(key, lam_blk, sig_blk, exposure_rate,
                       n_super, adj_prob_threshold, truncation_compensation):
    """Supersample one gene block and summarize.

    Bootstrap indices are drawn per SUPERSAMPLE and shared across the
    block's cells (whole posterior-draw rows resampled with replacement):
    each cell's marginal bootstrap distribution is exactly the reference's
    per-cell `sample(1:n, replace=TRUE)` (R/utilities.R:753-781) — a
    uniform index is uniform per cell either way, and every downstream
    consumer (CI bounds, PPC flags) is a per-cell marginal. Only the
    cross-cell covariance of the resampling noise differs. The row gather
    is contiguous; the per-cell [n_super, S, kb] index gather it replaces
    dominated the whole PPC stage at the 50k-product shape.
    """
    n_actual, S, kb = lam_blk.shape
    k_idx, k_gamma, k_pois = jax.random.split(key, 3)
    idx = jax.random.randint(k_idx, (n_super,), 0, n_actual)
    lam = lam_blk[idx]  # [n_super, S, kb] contiguous row take
    sig = sig_blk[idx][:, None, :]  # [n_super, 1, kb]
    eta = lam + exposure_rate[None, :, None]
    phi = jnp.exp(-sig) * truncation_compensation
    g = jax.random.gamma(k_gamma, phi, shape=(n_super, S, kb))
    rate = jnp.exp(eta) / phi * g
    draws = jax.random.poisson(k_pois, rate)
    return _summarize_split(draws, adj_prob_threshold)


@functools.lru_cache(maxsize=128)
def _approx_scan_jit(n_super: int, adj_prob_threshold: float,
                     truncation_compensation: float, kb: int, n_blocks: int):
    """All gene blocks of the supersampled CI in ONE compiled program.

    `lax.scan` runs the blocks sequentially on device (one [n_super, S, kb]
    tile live at a time, same memory bound as the host-side chunk loop it
    replaces) with a single dispatch and a single host transfer of the
    stacked summaries, instead of one host round trip per block.
    """

    @jax.jit
    def run(key, lam_pad, sig_pad, exposure_rate):
        n_actual, S, K_pad = lam_pad.shape
        lam_b = jnp.moveaxis(lam_pad.reshape(n_actual, S, n_blocks, kb), 2, 0)
        sig_b = jnp.moveaxis(sig_pad.reshape(n_actual, n_blocks, kb), 1, 0)
        keys = jax.random.split(key, n_blocks)

        def body(_, xs):
            k, lam_blk, sig_blk = xs
            return 0, _approx_block_body(
                k, lam_blk, sig_blk, exposure_rate,
                n_super, adj_prob_threshold, truncation_compensation,
            )

        _, outs = jax.lax.scan(body, 0, (keys, lam_b, sig_b))
        return outs  # dict of [n_blocks, S, kb]

    return run


def approximated_ci(
    key,
    lambda_log: jnp.ndarray,  # [n_actual, S, K]
    sigma_raw: jnp.ndarray,  # [n_actual, K]
    exposure_rate: jnp.ndarray,
    adj_prob_threshold: float,
    how_many_posterior_draws: int,
    truncation_compensation: float = 1.0,
):
    """Bootstrap-supersample the posterior, simulate NB, summarize.

    Mirrors reference R/utilities.R:753-781: per (S, G) cell, draw
    `how_many_posterior_draws` indices with replacement from the actual
    draws, simulate rnbinom(mu=exp(lambda+exposure),
    size=1/exp(sigma_raw)*trunc_comp), then type-7 quantiles + mean + sd.
    The reference resamples per-cell; we resample draw indices per cell too
    (vectorized), preserving its statistics.
    """
    n_actual, S, K = lambda_log.shape
    n_super = int(how_many_posterior_draws)

    # chunk genes so the supersampled [n_super, S, kb] tile stays < ~64M
    # elems; all chunks run inside ONE compiled scan (see _approx_scan_jit)
    kb = max(1, min(int(64e6 / (n_super * S)), K))
    n_blocks = -(-K // kb)
    if n_blocks == 1:
        # single tile: one direct block call (no scan)
        block = _approx_block_jit(
            n_super, float(adj_prob_threshold), float(truncation_compensation)
        )
        return finalize_summary(block(key, lambda_log, sigma_raw, exposure_rate))
    K_pad = n_blocks * kb
    if K_pad != K:
        lambda_log = jnp.pad(lambda_log, ((0, 0), (0, 0), (0, K_pad - K)))
        sigma_raw = jnp.pad(sigma_raw, ((0, 0), (0, K_pad - K)))
    run = _approx_scan_jit(
        n_super, float(adj_prob_threshold), float(truncation_compensation),
        kb, n_blocks,
    )
    out = run(key, lambda_log, sigma_raw, exposure_rate)
    # [n_blocks, S, kb] -> [S, K_pad] -> [S, K]
    flat = {
        k: np.moveaxis(np.asarray(v), 0, 1).reshape(S, K_pad)[:, :K]
        for k, v in out.items()
    }
    return finalize_summary(flat)
